"""DAYENU filter construction (arXiv:2004.11397).

Port of ``draco_tpu.ops.dayenu`` (reference ``draco/analysis/dayenu.py``:
delay_filter:1125, highpass_delay_filter:1205, bandpass_mmode_filter:1235,
lowpass_mmode_filter:1296, highpass_mmode_filter:1349, instantaneous_m:1399).

A DAYENU filter is the pseudo-inverse of a covariance ``I + sum_k
sinc-window_k / eps_k`` restricted to the unmasked samples.  The
covariances span about twelve decades, so the pseudo-inverse is always
factorised in float64 (complex128 for a complex stop band): a float32
``eigh`` would lose the pass band.  The JAX package takes that ``eigh`` to
host numpy whenever its x64 mode is off; here it runs as
``torch.linalg.eigh`` in float64 on the device, in chunks of the batch.
The unique flag patterns are found on the host; the filters come back as
float64 or complex128 tensors on the device, and a caller casts them to
the data's type only for the apply.

Deliberate difference: eigenvalues at or below ``1e-15 max|w|`` are
dropped, the cutoff of ``numpy.linalg.pinv`` that the reference's DAYENU
filters use.  The JAX package drops those at or below ``max|w| n
eps_f64``; with 1024 channels and ``eps`` 1e-12 that is ~1.5, above the
pass band's eigenvalues of 1, and its filter returns almost nothing (a
1e-4 fraction of the input's power beyond the cut).  With 64-256 channels
both cutoffs keep the pass band.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor, resolve
from .tools import invert_no_zero

__all__ = [
    "hermitian_pinv_batched",
    "batched_masked_pinv",
    "delay_filter",
    "highpass_delay_filter",
    "bandpass_mmode_filter",
    "lowpass_mmode_filter",
    "highpass_mmode_filter",
    "instantaneous_m",
    "apply_filter_freq",
]

# bytes of float64 covariances handed to one eigh call (its workspace and
# eigenvectors take about as much again)
EIGH_CHUNK_BYTES = 1 << 30
# eigenvalues at or below this fraction of the largest are dropped (numpy.linalg.pinv's rcond)
PINV_RCOND = 1e-15


def _wide(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype.is_complex else torch.float64


def hermitian_pinv_batched(ucov, device=None, chunk_bytes: int = EIGH_CHUNK_BYTES) -> torch.Tensor:
    """Batched Hermitian pseudo-inverse with ``numpy.linalg.pinv``'s eigenvalue cutoff.

    ``ucov`` [..., n, n] is taken in float64 (complex128) before anything
    else; the eigendecomposition runs in that type on its device (host data
    goes to :func:`resolve` ``(device)``), a chunk of the batch at a time.
    Eigenvalues at or below ``PINV_RCOND max|w|`` are dropped, as
    ``numpy.linalg.pinv(hermitian=True)`` does by default; an exact zero is
    never inverted.  A chunk whose ``eigh`` fails raises
    ``torch.linalg.LinAlgError``.
    """
    ucov = as_tensor(ucov, device)
    ucov = ucov.to(_wide(ucov.dtype))
    shape = ucov.shape
    n = shape[-1]
    flat = ucov.reshape(-1, n, n)
    out = torch.empty_like(flat)
    step = max(1, int(chunk_bytes) // max(1, n * n * flat.element_size()))
    for i0 in range(0, flat.shape[0], step):
        w, v = torch.linalg.eigh(flat[i0 : i0 + step])
        cut = w.abs().amax(dim=-1, keepdim=True) * PINV_RCOND
        iw = torch.where(w.abs() > cut, 1.0 / torch.where(w == 0, torch.ones_like(w), w), torch.zeros_like(w))
        out[i0 : i0 + step] = (v * iw[..., None, :].to(v.dtype)) @ v.conj().transpose(-1, -2)
        del w, v
    return out.reshape(shape)


def batched_masked_pinv(cov, uflag, device=None) -> torch.Tensor:
    """Pseudo-invert ``uflag * cov`` for each flag pattern.

    Parameters
    ----------
    cov : [n, n] array or tensor
        Shared covariance, taken in float64 (complex128).
    uflag : [nuniq, n] bool
        Unique flag patterns (True = valid sample).

    Returns
    -------
    pinv : tensor [nuniq, n, n]
        ``pinv(outer-mask * cov) * outer-mask`` for each pattern, float64
        or complex128 on ``cov``'s device (host data: :func:`resolve`).
    """
    cov = as_tensor(cov, device)
    cov = cov.to(_wide(cov.dtype))
    uflag = as_tensor(np.asarray(uflag, dtype=bool) if not isinstance(uflag, torch.Tensor) else uflag, cov.device)
    n = cov.shape[-1]
    out = torch.empty((uflag.shape[0], n, n), dtype=cov.dtype, device=cov.device)
    step = max(1, EIGH_CHUNK_BYTES // max(1, n * n * cov.element_size()))
    for i0 in range(0, uflag.shape[0], step):
        m = uflag[i0 : i0 + step]
        mask2 = (m[:, None, :] & m[:, :, None]).to(cov.dtype)
        out[i0 : i0 + step] = hermitian_pinv_batched(mask2 * cov[None]) * mask2
        del mask2
    return out


def _ensure(param, n):
    p = np.atleast_1d(param)
    if p.size == 1:
        return np.full(n, p[0])
    assert p.size == n
    return p


def delay_covariance(freq, tau_width, tau_centre=0.0, epsilon=1e-12) -> np.ndarray:
    """The DAYENU delay covariance ``I + sum_k sinc-window_k / eps_k`` on the host in float64 (complex128 when a
    stop band is off centre)."""
    args = [tau_width, tau_centre, epsilon]
    nstopband = max(np.atleast_1d(p).size for p in args)
    tw, tc, eps = (_ensure(p, nstopband) for p in args)

    dtype = np.complex128 if np.any(np.abs(tc) > 0.0) else np.float64
    freq = np.asarray(freq, dtype=np.float64)
    dfreq = freq[:, np.newaxis] - freq[np.newaxis, :]
    cov = np.eye(freq.size, dtype=dtype)
    for w, c, e in zip(tw, tc, eps):
        term = np.sinc(2.0 * w * dfreq) / e
        if np.abs(c) > 0.0:
            term = term * np.exp(-2.0j * np.pi * c * dfreq)
        cov += term
    return cov


def delay_filter(freq, flag, tau_width, tau_centre=0.0, epsilon=1e-12, device=None):
    """Construct a (possibly multi-stopband) delay filter.

    Attenuates delays within ``[tau_centre - tau_width, tau_centre +
    tau_width]`` for each stopband (reference dayenu.py:1125-1202).

    Parameters
    ----------
    freq : [nfreq] in MHz.
    flag : [nfreq, ntime] bool — valid frequencies per time.
    tau_width, tau_centre, epsilon : scalars or [nstopband] arrays
        Stop-band half-width / centre (microseconds) and rejection.

    Returns
    -------
    pinv : tensor [ntime_uniq, nfreq, nfreq] on ``device`` (a tensor flag's
        device when ``device`` is None)
    index : list of arrays mapping pinv[i] to the time samples it covers.
    """
    if device is None and isinstance(flag, torch.Tensor):
        device = flag.device
    flag = flag.detach().cpu().numpy() if isinstance(flag, torch.Tensor) else np.asarray(flag)
    flag = flag.astype(bool)
    assert flag.shape[0] == np.asarray(freq).size and flag.ndim == 2

    cov = delay_covariance(freq, tau_width, tau_centre, epsilon)
    uflag, uindex = np.unique(flag.T, return_inverse=True, axis=0)
    uindex = uindex.reshape(-1)
    pinv = batched_masked_pinv(cov, uflag, device=device)
    index = [np.flatnonzero(uindex == uu) for uu in range(pinv.shape[0])]
    return pinv, index


def highpass_delay_filter(freq, tau_cut, flag, epsilon=1e-12, device=None):
    """High-pass delay filter with stop band [-tau_cut, tau_cut] (reference dayenu.py:1205-1232)."""
    return delay_filter(freq, flag, tau_cut, 0.0, epsilon, device=device)


def _mmode_filter(ra, cov, flag, device):
    """Shared unique-flag + batched-pinv logic for the m-mode filters."""
    if device is None and isinstance(flag, torch.Tensor):
        device = flag.device
    flag = flag.detach().cpu().numpy() if isinstance(flag, torch.Tensor) else np.asarray(flag)
    ishp = flag.shape
    nra = ra.size
    assert ishp[-1] == nra

    uflag, uindex = np.unique(flag.astype(bool).reshape(-1, nra), return_inverse=True, axis=0)
    uindex = uindex.reshape(-1)
    pinv = batched_masked_pinv(cov(resolve(device)), uflag)
    index = [np.unravel_index(np.flatnonzero(uindex == uu), ishp[:-1]) for uu in range(pinv.shape[0])]
    return pinv, index


def _dra(ra, device):
    r = torch.as_tensor(ra, dtype=torch.float64, device=device)
    return r[:, None] - r[None, :]


def bandpass_mmode_filter(ra, m_center, m_cut, flag, epsilon=1e-10, device=None):
    """Bandpass m filter, pass band [m_center - m_cut, m_center + m_cut] (reference dayenu.py:1235-1293).

    The [nra, nra] covariance is built in float64 on the device.
    """
    ra = np.asarray(ra, dtype=np.float64)
    a = np.median(np.abs(np.diff(ra))) * m_cut / np.pi
    aeps = a * epsilon

    def cov(dev):
        dra = _dra(ra, dev)
        return torch.eye(ra.size, dtype=torch.float64, device=dev) / aeps + (
            2 * a * (1.0 - 1.0 / aeps) * torch.sinc(m_cut * dra / np.pi) * torch.cos(m_center * dra)
        )

    return _mmode_filter(ra, cov, flag, device)


def lowpass_mmode_filter(ra, m_cut, flag, epsilon=1e-10, device=None):
    """Low-pass m filter, pass band [-m_cut, m_cut] (reference dayenu.py:1296)."""
    ra = np.asarray(ra, dtype=np.float64)
    a = np.median(np.abs(np.diff(ra))) * m_cut / np.pi
    aeps = a * epsilon

    def cov(dev):
        dra = _dra(ra, dev)
        return torch.eye(ra.size, dtype=torch.float64, device=dev) / aeps + (
            a * (1.0 - 1.0 / aeps) * torch.sinc(m_cut * dra / np.pi)
        )

    return _mmode_filter(ra, cov, flag, device)


def highpass_mmode_filter(ra, m_cut, flag, epsilon=1e-10, device=None):
    """High-pass m filter, stop band [-m_cut, m_cut] (reference dayenu.py:1349)."""
    ra = np.asarray(ra, dtype=np.float64)

    def cov(dev):
        dra = _dra(ra, dev)
        return torch.eye(ra.size, dtype=torch.float64, device=dev) + torch.sinc(m_cut * dra / np.pi) / epsilon

    return _mmode_filter(ra, cov, flag, device)


def instantaneous_m(ha, lat, dec, u, v, w=0.0):
    """Instantaneous fringe-rate m for a baseline (reference dayenu.py:1399).

    All angles in radians; (u, v, w) in wavelengths.
    """
    deriv = u * (-1 * np.cos(dec) * np.cos(ha))
    deriv += v * (np.sin(lat) * np.cos(dec) * np.sin(ha))
    deriv += w * (-1 * np.cos(lat) * np.cos(dec) * np.sin(ha))
    return 2.0 * np.pi * deriv


def apply_filter_freq(NF, vis, var):
    """Apply an [nfreq, nfreq] filter over a leading freq axis of ``vis``.

    The filter is cast to the data's type for the product (complex data
    stays complex64 when it is complex64); the propagated inverse variance
    ``1 / (|NF|^2 @ var)`` is formed in float64 and returned in ``var``'s
    type.  Runs on ``vis``'s device.  Returns (filtered_vis, filtered_weight).
    """
    vis = as_tensor(vis)
    var = as_tensor(var, vis.device)
    NF = as_tensor(NF, vis.device)
    fdt = vis.dtype if (vis.is_complex() or not NF.is_complex()) else torch.complex64
    shape = vis.shape
    fvis = (NF.to(fdt) @ vis.reshape(shape[0], -1).to(fdt)).reshape(shape)
    vshape = var.shape
    fw = invert_no_zero(NF.abs().to(torch.float64) ** 2 @ var.reshape(vshape[0], -1).to(torch.float64))
    return fvis, fw.reshape(vshape).to(var.dtype)
