"""Weighted convolution, moving-median and Fourier null-space filters.

Port of ``draco_tpu.ops.filters`` (reference ``draco/util/filters.py``:
lowpass/highpass weighted convolution :22/68, medfilt :99, null_filter
:133).

* The weighted convolution filters run as zero-padded FFT convolutions on
  the data's device, with the FIR prototype built on the host as a
  flattop-windowed sinc.
* The null filter builds the masked, optionally windowed Fourier design
  [nsample, num_modes] on the device, takes its SVD in float64 there and
  returns the complex128 projector.  The JAX package reads the projector
  back as two real planes for the TPU's transfer layer; the port returns
  the tensor.
* ``medfilt`` is host numpy (the moving weighted median of
  :mod:`.median`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.signal import windows as _windows

from ..device import as_tensor
from . import median
from .tools import invert_no_zero, svd, window_generalised

__all__ = [
    "lowpass_weighted_convolution_filter",
    "highpass_weighted_convolution_filter",
    "medfilt",
    "null_filter",
]


def _flattop_lowpass_fir(cutoff: float, fs: float) -> np.ndarray:
    """Flattop-windowed-sinc low-pass FIR with unit DC gain.

    The prototype matches ``scipy.signal.firwin(order, cutoff,
    window="flattop", fs=fs)`` with the order chosen to span one cutoff
    period (rounded up to odd), which is the reference's kernel choice.
    """
    order = int(np.ceil(fs / cutoff) // 2 * 2 + 1)
    t = np.arange(order, dtype=np.float64) - (order - 1) / 2
    ideal = (2.0 * cutoff / fs) * np.sinc(2.0 * cutoff / fs * t)
    taps = ideal * _windows.flattop(order, sym=True)
    return taps / taps.sum()


def _fft_convolve_same(x: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    """Centred ("same") linear convolution of ``x`` with ``taps`` along ``axis``."""
    x = torch.movedim(x, axis, -1)
    n, klen = x.shape[-1], taps.shape[0]
    nfull = n + klen - 1
    if x.is_complex():
        full = torch.fft.ifft(torch.fft.fft(x, n=nfull) * torch.fft.fft(taps, n=nfull).to(x.dtype), n=nfull)
    else:
        full = torch.fft.irfft(torch.fft.rfft(x, n=nfull) * torch.fft.rfft(taps, n=nfull), n=nfull)
    start = (klen - 1) // 2
    return torch.movedim(full[..., start : start + n], -1, axis)


def lowpass_weighted_convolution_filter(data, weight, samples, cutoff, axis=-1, device=None):
    """Weight-aware low-pass filter along ``axis``, on the data's device.

    Convolves ``data * weight`` and ``weight`` with a flattop-windowed
    sinc whose length spans one cutoff period, then renormalises, so
    missing (zero-weight) samples do not bias the smooth estimate.
    Semantics of reference ``draco/util/filters.py:22-65``.

    Parameters
    ----------
    data, weight : tensors (or host arrays, placed on ``device``) broadcastable against each other
    samples : 1-D sample positions (only their median spacing matters)
    cutoff : filter cutoff in inverse sample units
    axis : axis to filter along
    """
    d = as_tensor(data, device)
    fs = 1.0 / np.median(np.abs(np.diff(np.asarray(samples))))
    taps = _flattop_lowpass_fir(float(cutoff), float(fs))
    w = torch.broadcast_to(as_tensor(weight, d.device), d.shape).to(d.real.dtype)
    rdt = torch.promote_types(d.real.dtype, torch.float32)
    k = torch.as_tensor(taps, dtype=rdt, device=d.device)
    ax = axis % d.ndim
    num = _fft_convolve_same(d * w, k, ax)
    den = _fft_convolve_same(w.to(rdt), k, ax)
    return num * invert_no_zero(den)


def highpass_weighted_convolution_filter(data, weight, samples, cutoff, axis=-1, device=None):
    """Complement of the low-pass filter (reference filters.py:68-96)."""
    d = as_tensor(data, device)
    return d - lowpass_weighted_convolution_filter(d, weight, samples, cutoff, axis)


def medfilt(x, mask, size, method: str = "split"):
    """Moving median of masked data (reference filters.py:99-130).

    Masked samples carry zero weight in the moving weighted median.
    ``method`` selects the tie convention; only the "split" convention
    (average of the two straddling values) is provided.
    """
    if method != "split":
        raise ValueError(f"medfilt: unsupported tie method {method!r}; only 'split' is available.")
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return medfilt(x.real, mask, size, method=method) + 1.0j * medfilt(x.imag, mask, size, method=method)
    xc = np.ascontiguousarray(x.astype(np.float64))
    wc = np.ascontiguousarray((~np.asarray(mask, dtype=bool)).astype(np.float64))
    return median.moving_weighted_median(xc, wc, size)


def null_filter(
    samples,
    cutoff,
    mask,
    num_modes: int = 200,
    tol: float = 1e-8,
    window=True,
    type_: str = "high",
    lapack_driver: str = "gesvd",
    device=None,
) -> torch.Tensor:
    """Projector that nulls (or keeps) Fourier modes within ``cutoff``.

    Spans ``num_modes`` modes over [-cutoff, cutoff] evaluated at the
    (possibly irregular) ``samples``, masks and optionally apodises them,
    and keeps the singular directions above ``tol`` of the largest;
    "high" returns the orthogonal complement.  Semantics of reference
    ``draco/util/filters.py:133-212``.  The SVD is float64 on ``device``
    (the mask's device when it is a tensor), cuSOLVER's ``gesvd`` on a card
    (:func:`.tools.svd`); ``lapack_driver`` is accepted for API parity.

    Returns the complex128 projector [nsample, nsample] on that device.
    """
    if type_ not in {"high", "low"}:
        raise ValueError(f"type_ must be 'high' or 'low'; got {type_!r}")
    if device is None and isinstance(mask, torch.Tensor):
        device = mask.device
    x = as_tensor(np.asarray(samples, dtype=np.float64), device)
    m = as_tensor(mask, x.device).to(torch.float64)
    fmodes = torch.linspace(-float(cutoff), float(cutoff), int(num_modes), dtype=torch.float64, device=x.device)
    phase = 2.0 * math.pi * x[:, None] * fmodes[None, :]
    F = m[:, None] * torch.polar(torch.ones_like(phase), phase)

    w = None
    if window:
        w = window_generalised((x - x.min()) / (x.max() - x.min()), window="nuttall" if window is True else window)
        F = F * w[:, None]

    u, sig, _ = svd(F)
    basis = u * (sig > tol * sig.max()).to(u.dtype)[None, :]
    proj = basis @ basis.conj().T
    if type_ == "high":
        proj = torch.eye(x.shape[0], dtype=proj.dtype, device=x.device) - proj
    proj = proj * m[None, :]
    if w is not None:
        proj = proj * w[None, :]
    return proj
