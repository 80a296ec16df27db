"""Regridding of irregular time axes: the Lanczos / banded-Wiener filter.

Port of ``draco_tpu.ops.regrid`` (``band_wiener``, ``lanczos_kernel``,
``lanczos_forward_matrix``).  The Lanczos matrices are host numpy; the
Wiener solve runs on the device of its inputs, with the banded
covariance from :func:`draco_tpu_torch.ops.cuda_kernels.banded_covariance_batched`
(the CUDA kernel on the card, its plain version on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from . import banded
from .cuda_kernels import banded_covariance_batched

__all__ = ["band_wiener", "lanczos_kernel", "lanczos_forward_matrix"]


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
    # contracted and solved as two real right-hand sides of one factor
    parts = torch.stack([y.real, y.imag]) if y.is_complex() else y[None]
    dirty = (parts * Ni) @ R.T  # [2 or 1, k, m]

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
