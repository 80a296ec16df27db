"""Regridding of irregular time axes: the Lanczos / banded-Wiener filter.

Port of ``draco_tpu.ops.regrid``.  The Lanczos, rebinning and Taylor
matrices are host numpy, copied from the JAX package; the Wiener solve runs
on the device of its inputs, with the banded covariance from
:func:`draco_tpu_torch.ops.cuda_kernels.banded_covariance_batched` (the CUDA
kernel on the card, its plain version on the CPU).  :func:`grad_1d_rows` is
:func:`grad_1d` for a batch of rows on their device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import banded
from .cuda_kernels import banded_covariance_batched

__all__ = [
    "band_wiener", "lanczos_kernel", "lanczos_forward_matrix", "lanczos_inverse_matrix", "rebin_matrix", "grad_1d",
    "grad_1d_rows", "taylor_coeff",
]


def band_wiener(R: torch.Tensor, Ni: torch.Tensor, Si: torch.Tensor, y: torch.Tensor, bw: int):
    """Banded Wiener filter: solve ``(R N^-1 R^T + S^-1) x = R N^-1 y``.

    Semantics of reference ``regrid.band_wiener``: the returned noise
    weight is ``diag(R N^-1 R^T)`` without the signal term.  Batched over
    the leading axis of ``Ni``/``y``.

    R [m, n] real; Ni [k, n] real; Si [m]; y [k, n] real or complex.
    Returns ``(xh [k, m], nw [k, m])``; ``xh`` has the dtype of ``y``.
    """
    if R.is_complex():
        raise TypeError(
            "band_wiener requires a real transfer matrix R (the covariance "
            "is built without conjugation)."
        )
    Ni = torch.atleast_2d(Ni)
    y = torch.atleast_2d(y)
    # a complex y against the real R: the real and imaginary parts are
    # contracted and solved as two real right-hand sides of one factor,
    # one part's weighted copy at a time
    parts = (y.real, y.imag) if y.is_complex() else (y,)
    dirty = torch.empty((len(parts), y.shape[0], R.shape[0]), dtype=Ni.dtype, device=y.device)  # [2 or 1, k, m]
    for k, part in enumerate(parts):
        torch.matmul(part * Ni, R.T, out=dirty[k])

    ab = banded_covariance_batched(R.contiguous(), Ni.contiguous(), bw)  # [k, bw+1, m]
    nw = ab[:, 0].clone()
    ab[:, 0] += Si
    xh = banded.solveh_banded_lower(ab, dirty, bw)
    if y.is_complex():
        xh = torch.complex(xh[0], xh[1])
    else:
        xh = xh[0]
    return xh, nw


def lanczos_kernel(x, a: int):
    """Lanczos kernel (regrid.py:91)."""
    x = np.asarray(x)
    inside = np.abs(x) < a
    return np.where(inside, np.sinc(x) * np.sinc(x / a), 0.0)


def lanczos_forward_matrix(x, y, a: int = 5, periodic: bool = False):
    """Lanczos interpolation matrix from grid ``x`` onto points ``y``.

    (regrid.py:108) — returns [len(y), len(x)].
    """
    x = np.asarray(x)
    y = np.asarray(y)
    step = x[1] - x[0]
    offsets = np.subtract.outer(-y, -x) / step
    if periodic:
        n = len(x)
        far = np.abs(offsets) > n // 2
        offsets = np.where(far, n - np.abs(offsets), offsets)
    return lanczos_kernel(offsets, a)


def lanczos_inverse_matrix(x, y, a: int = 5, cond: float = 1e-1):
    """Pseudo-inverse Lanczos regridding matrix (regrid.py:138)."""
    lz = lanczos_forward_matrix(x, y, a)
    return np.linalg.pinv(lz, rcond=cond)


def rebin_matrix(tra: np.ndarray, ra: np.ndarray, width_t: float = 0.0) -> np.ndarray:
    """Linear rebinning matrix [nra, ntime] from time samples onto RA bins.

    (regrid.py:161) — fractional overlap of each time sample with the two
    neighbouring RA bins.
    """
    tra = np.asarray(tra)
    ra = np.asarray(ra)
    width_t = width_t or 1e-10
    half_t = width_t / 2.0
    half_ra = np.median(np.abs(np.diff(ra))) / 2.0

    # fractional overlap of each time sample with the bin at/after it and
    # the bin before it
    above = np.searchsorted(ra, tra)
    below = above - 1
    out = np.zeros((ra.shape[0], tra.shape[0]))

    cols = np.arange(tra.shape[0])
    up_ok = (above < len(ra)) & (tra + half_t > ra[0] - half_ra)
    frac_up = np.clip((tra + half_t - (ra[above % len(ra)] - half_ra)) / width_t, 0.0, 1.0)
    out[above[up_ok], cols[up_ok]] = frac_up[up_ok]

    dn_ok = (below >= 0) & (tra - half_t < ra[-1] + half_ra)
    frac_dn = np.clip(((ra[below] + half_ra) - (tra - half_t)) / width_t, 0.0, 1.0)
    out[below[dn_ok], cols[dn_ok]] = frac_dn[dn_ok]
    return out


def grad_1d(x, si, mask, period: float | None = None):
    """Gradient of masked samples; masked/edge points return zero.

    Periodic inputs are handled by wrapping one sample from each end
    before differencing.  The returned mask additionally covers every
    point adjacent to a masked one (their central differences are
    contaminated).  Semantics of reference regrid.py:214-270.
    """
    x = np.asarray(x)
    si = np.asarray(si)
    bad = np.asarray(mask).astype(bool)
    view = slice(None)
    if period is not None:
        wrap = np.ceil(si[-1] / period) * period
        x = np.concatenate(([x[-1]], x, [x[0]]))
        si = np.concatenate(([si[-1] - wrap], si, [si[0] + wrap]))
        bad = np.concatenate(([bad[-1]], bad, [bad[0]]))
        view = slice(1, -1)

    # a masked neighbour poisons the central difference on either side
    left = np.zeros_like(bad)
    left[1:] = bad[:-1]
    right = np.zeros_like(bad)
    right[:-1] = bad[1:]
    bad = bad | left | right

    with np.errstate(divide="ignore", invalid="ignore"):
        slope = np.gradient(x, si)
    bad |= ~np.isfinite(slope)
    slope = np.where(bad, 0.0, slope)
    return slope[view], bad[view]


def grad_1d_rows(x: torch.Tensor, si: torch.Tensor, mask: torch.Tensor, period: float | None = None):
    """:func:`grad_1d` of every row of ``x`` [N, n] at once, on its device.

    ``si`` is [n] or [N, n] (each row its own sample locations), ``mask``
    [N, n] bool.  The gradient is ``np.gradient``'s: second-order central
    differences on the interior for uneven spacing, one-sided first-order
    differences at the two ends.  Returns ``(slope [N, n], bad [N, n])``.
    """
    si = si.to(x.real.dtype).expand(x.shape[0], -1)
    bad = mask.to(torch.bool)
    if period is not None:
        wrap = torch.ceil(si[:, -1:] / period) * period
        x = torch.cat([x[:, -1:], x, x[:, :1]], dim=1)
        si = torch.cat([si[:, -1:] - wrap, si, si[:, :1] + wrap], dim=1)
        bad = torch.cat([bad[:, -1:], bad, bad[:, :1]], dim=1)
    left = torch.zeros_like(bad)
    left[:, 1:] = bad[:, :-1]
    right = torch.zeros_like(bad)
    right[:, :-1] = bad[:, 1:]
    bad = bad | left | right

    dx = si[:, 1:] - si[:, :-1]
    slope = torch.empty_like(x)
    slope[:, 0] = (x[:, 1] - x[:, 0]) / dx[:, 0]
    slope[:, -1] = (x[:, -1] - x[:, -2]) / dx[:, -1]
    dx1, dx2 = dx[:, :-1], dx[:, 1:]
    a = -(dx2) / (dx1 * (dx1 + dx2))
    b = (dx2 - dx1) / (dx1 * dx2)
    c = dx1 / (dx2 * (dx1 + dx2))
    slope[:, 1:-1] = a * x[:, :-2] + b * x[:, 1:-1] + c * x[:, 2:]
    finite = torch.isfinite(torch.view_as_real(slope)).all(dim=-1) if slope.is_complex() else torch.isfinite(slope)
    bad = bad | ~finite
    slope = torch.where(bad, torch.zeros_like(slope), slope)
    if period is not None:
        slope, bad = slope[:, 1:-1], bad[:, 1:-1]
    return slope, bad


def taylor_coeff(
    x: np.ndarray,
    N: int,
    M: int,
    Ni: np.ndarray,
    Si: float,
    period: float | None = None,
    xc: np.ndarray | None = None,
):
    """Sparse local Taylor-expansion estimator matrices (host numpy).

    For every location, a regularised weighted least-squares fit of an
    order-``M`` Taylor expansion to the ``2N+1`` nearest samples; the
    returned list holds one sparse CSR operator per expansion
    coefficient.  Role of reference regrid.py:273-350, with the JAX
    package's two deliberate fixes: periodic offsets wrap into
    [-period/2, period/2) before the Vandermonde fit, and the non-periodic
    branch honours ``xc``.

    Parameters
    ----------
    x : sample locations [nx]
    N : half-width of the fit stencil
    M : number of expansion coefficients
    Ni : per-sample inverse noise [nx]
    Si : ridge regularisation added to the normal matrix diagonal
    period : optional wrap period for circular axes
    xc : optional expansion centres (defaults to the samples)
    """
    import scipy.sparse as ss

    x = np.asarray(x)
    weights = np.asarray(Ni)
    nx = x.shape[0]
    centres = x if xc is None else np.asarray(xc)

    stencil = np.arange(-N, N + 1)
    neighbour = np.arange(nx)[:, None] + stencil[None, :]

    if period is not None:
        neighbour %= nx
        offsets = x[neighbour] - centres[:, None]
        offsets = (offsets + period / 2) % period - period / 2
        w = weights[neighbour]
    else:
        oob = (neighbour < 0) | (neighbour >= nx)
        neighbour = np.clip(neighbour, 0, nx - 1)
        offsets = x[neighbour] - centres[:, None]
        w = np.where(oob, 0.0, weights[neighbour])

    # weighted normal equations per location, solved batched
    V = offsets[..., None] ** np.arange(M)  # [nx, 2N+1, M] Vandermonde
    VtW = np.swapaxes(V * w[..., None], 1, 2)  # [nx, M, 2N+1]
    normal = VtW @ V + Si * np.eye(M)
    coeff_w = np.linalg.solve(normal, VtW)  # [nx, M, 2N+1]

    row_starts = (2 * N + 1) * np.arange(nx + 1)
    return [
        ss.csr_array((coeff_w[:, m].ravel(), neighbour.ravel(), row_starts), shape=(nx, nx))
        for m in range(M)
    ]
