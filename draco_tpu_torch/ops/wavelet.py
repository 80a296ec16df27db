"""Continuous wavelet transform via batched FFTs.

Port of ``draco_tpu.ops.wavelet``, which replaces the reference's
pywt-based CWT (reference draco/analysis/wavelet.py:127 uses
``pywt.cwt(..., method="fft")``).  The transform is computed in the
Fourier domain on the data's device: one batched FFT, a broadcast multiply
against the scale bank, one batched inverse FFT.

Convention (Torrence & Compo 1998): for data x(t) sampled at dt,

    W(s, t) = ifft( fft(x) * sqrt(2 pi s / dt) * psihat(s w)* )
    psihat(w) = pi^-1/4 exp(-(w - w0)^2 / 2) * (w > 0)   [analytic Morlet]

and the scale corresponding to Fourier frequency f is
``s = (w0 + sqrt(2 + w0^2)) / (4 pi f)``.  The bank is built in float64
and cast to the transform's complex type.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import as_tensor

__all__ = [
    "morlet_fourier",
    "wavelet_fourier",
    "central_frequency",
    "frequency2scale",
    "cwt",
    "cwt_morlet",
    "cwt_var",
]

W0_DEFAULT = 5.0


def morlet_fourier(w, w0: float = W0_DEFAULT):
    """Fourier transform of the analytic Morlet wavelet (positive side)."""
    w = as_tensor(w)
    return (np.pi**-0.25) * torch.exp(-0.5 * (w - w0) ** 2) * (w > 0)


def _parse_wavelet(name: str):
    """Parse a pywt-style wavelet name into (kind, params)."""
    name = str(name).lower()
    if name in ("morl", "morlet"):
        return "morl", (W0_DEFAULT,)
    if name.startswith("cmor"):
        # complex Morlet "cmorB-C" (bandwidth, centre frequency)
        rest = name[4:]
        if rest:
            b_s, c_s = rest.split("-")
            B, C = float(b_s), float(c_s)
        else:
            B, C = 1.0, 1.0
        return "cmor", (B, C)
    if name in ("mexh", "mexican_hat"):
        return "mexh", ()
    if name.startswith("gaus"):
        return "gaus", (int(name[4:] or 1),)
    raise ValueError(f"Unsupported wavelet {name!r} (morl/cmorB-C/mexh/gausN).")


def wavelet_fourier(w, wavelet: str = "morl"):
    """Fourier transform psihat(w) of a named wavelet.

    The analytic Morlet ("morl", default), the complex Morlet ("cmorB-C"),
    the Mexican hat ("mexh") and Gaussian derivatives ("gausN") as
    closed-form Fourier multipliers, each of unit energy (int |psihat|^2 dw
    = 1), so that CWT amplitudes compare across the zoo.
    """
    kind, p = _parse_wavelet(wavelet)
    w = as_tensor(w)
    if kind == "morl":
        return morlet_fourier(w, p[0])
    if kind == "cmor":
        B, C = p
        # psi(t) = (pi B)^-1/2 exp(2i pi C t) exp(-t^2/B)
        f = w / (2.0 * np.pi)
        return torch.exp(-(np.pi**2) * B * (f - C) ** 2) * (w > 0)
    if kind == "mexh":
        # psi(t) ~ (1 - t^2) exp(-t^2/2), unit energy in this convention
        return np.sqrt(8.0 / 3.0) * (np.pi**0.25) / np.sqrt(2.0 * np.pi) * (w**2) * torch.exp(-0.5 * w**2)
    # gausN: N-th derivative of a Gaussian, |psihat| ~ |w|^N exp(-w^2/2)
    n = p[0]
    norm = 1.0 / np.sqrt(float(math.factorial(2 * n)) / (2.0**n) * np.sqrt(np.pi))
    norm *= np.sqrt(2.0**n * float(math.factorial(n)))
    return norm * (1j * w) ** n * torch.exp(-0.5 * w**2)


def central_frequency(wavelet: str = "morl", dt: float = 1.0):
    """Analytic centre frequency (cycles/sample) of a named wavelet at scale 1.

    Role of ``pywt.central_frequency``; derived from the peak of psihat.
    """
    kind, p = _parse_wavelet(wavelet)
    if kind == "morl":
        w0 = p[0]
        return (w0 + np.sqrt(2.0 + w0**2)) / (4 * np.pi * dt)
    if kind == "cmor":
        return p[1] / dt
    if kind == "mexh":
        return np.sqrt(2.0) / (2 * np.pi * dt)
    return np.sqrt(float(p[0])) / (2 * np.pi * dt)


def frequency2scale(freq, w0: float = W0_DEFAULT, dt: float = 1.0, wavelet=None):
    """Scale whose Fourier-equivalent frequency is ``freq`` (host numpy).

    Equivalent role to ``pywt.frequency2scale`` (reference wavelet.py:69):
    ``scale = central_frequency(wavelet) / freq``.  With no ``wavelet``
    given, uses the analytic-Morlet relation at centre frequency ``w0``.
    """
    freq = np.asarray(freq, dtype=np.float64)
    if wavelet is None:
        return (w0 + np.sqrt(2.0 + w0**2)) / (4 * np.pi * freq * dt)
    return central_frequency(wavelet, dt=dt) / freq


def _transform(x, scales, bank_fn, axis: int):
    x = as_tensor(x)
    dev = x.device
    scales = torch.as_tensor(np.asarray(scales, dtype=np.float64), device=dev)
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]

    xf = torch.fft.fft(x, dim=-1)
    w = 2.0 * np.pi * torch.fft.fftfreq(n, d=1.0, dtype=torch.float64, device=dev)
    bank = torch.sqrt(2.0 * np.pi * scales)[:, None] * bank_fn(scales[:, None] * w[None, :])
    Wf = xf[None] * bank.to(xf.dtype).reshape((scales.shape[0],) + (1,) * (x.ndim - 1) + (n,))
    W = torch.fft.ifft(Wf, dim=-1)
    # The prepended scale axis shifts positive positions by one.
    return torch.movedim(W, -1, axis + 1 if axis >= 0 else W.ndim + axis)


def cwt(x, scales, wavelet: str = "morl", axis: int = -1):
    """Continuous wavelet transform along ``axis`` with a named wavelet.

    The on-device equivalent of ``pywt.cwt(..., method="fft")`` (reference
    wavelet.py:127).  Returns the complex transform with the scale axis
    prepended, in the complex type of ``fft(x)``.
    """
    return _transform(x, scales, lambda sw: torch.conj(wavelet_fourier(sw, wavelet)), axis)


def cwt_morlet(x, scales, w0: float = W0_DEFAULT, axis: int = -1):
    """Continuous Morlet wavelet transform along ``axis``.

    Parameters
    ----------
    x : [..., n] real or complex data
    scales : [nscale] wavelet scales in samples
    w0 : Morlet centre frequency

    Returns
    -------
    W : complex tensor [nscale, ...x.shape] — the scale axis is prepended.
    """
    return _transform(x, scales, lambda sw: morlet_fourier(sw, w0), axis)


def cwt_var(W, axis: int = 1):
    """Variance of the transform over ``axis``: the mean, then the mean of ``|W - mu|^2``
    (replaces the reference's Cython ``_fast_var``, _fast_tools.pyx:307)."""
    W = as_tensor(W)
    mu = W.mean(dim=axis, keepdim=True)
    return ((W - mu).abs() ** 2).mean(dim=axis)
