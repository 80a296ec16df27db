"""Spherical-harmonic tables on a compact pixel support (port of
``draco_tpu.ops.sht_window``).

Beam(-product) maps of real instruments are compactly supported, so the
round trip restricts its work to a per-ring azimuth window derived from a
support mask.  :class:`WindowedSHT` holds that window in two layouts:

* the rectangular box ``[Rb, W]`` (every band ring at the widest ring's
  width), which the windowed analysis and the beam-transfer generator
  contract against ``Ec``/``Es`` [Rb, W, M+1] in one einsum;
* the flat (ragged) layout, each band ring's own window concatenated into
  one ``[Kf]`` pixel axis, with the per-pixel DFT factors the fused round
  trip and the streaming projections consume.

Table builders put their tables on ``device``, the first CUDA card when
none is named (:func:`draco_tpu_torch.device.resolve`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from .sht import SHT

__all__ = ["WindowedSHT", "support_fraction"]


def support_fraction(support, tau: float = 1e-9) -> float:
    """Fraction of pixels with |support| above ``tau * max``."""
    a = np.abs(np.asarray(support))
    mx = a.max()
    if mx == 0:
        return 0.0
    return float((a > tau * mx).mean())


class WindowedSHT:
    """The compact-support window of an :class:`SHT` in the flat layout.

    Parameters
    ----------
    s
        The full operator (geometry, band limits, Legendre recurrence).
    support
        [npix] array whose pixels above ``tau * max`` define the support;
        the window is each ring's cyclic azimuthal bounding interval.
    tau
        Relative support threshold.
    margin
        Extra pixels on each side of every ring window.
    """

    def __init__(self, s: SHT, support, tau: float = 1e-9, margin: int = 2):
        s._require_analysis_band_limit()
        self.sht = s
        info = s.info
        a = np.abs(np.asarray(support, dtype=np.float64))
        if a.shape != (s.npix,):
            raise ValueError(f"support must be [npix={s.npix}], got {a.shape}")
        thresh = tau * a.max()

        band, starts, widths = [], [], []
        for r in range(info.nring):
            o, n = int(info.offset[r]), int(info.nphi[r])
            good = np.nonzero(a[o : o + n] > thresh)[0]
            if len(good) == 0:
                continue
            if len(good) == n:
                p0, width = 0, n
            else:
                # the window is the complement of the largest cyclic gap
                gaps = np.diff(np.concatenate([good, [good[0] + n]]))
                k = int(np.argmax(gaps))
                p0 = int(good[(k + 1) % len(good)])
                width = n - int(gaps.max()) + 1
            band.append(r)
            starts.append(p0 - margin)
            widths.append(width + 2 * margin)
        if not band:
            raise ValueError("support mask is empty")
        self.band = np.asarray(band)
        self.Rb = len(band)
        self.W = int(max(widths))

        # box layout: rings shorter than W would count pixels twice through
        # the modular wrap, so slots past one full cycle get zero weight
        idx = np.zeros((self.Rb, self.W), np.int64)
        phi = np.zeros((self.Rb, self.W))
        valid = np.zeros((self.Rb, self.W))
        for k, r in enumerate(self.band):
            o, n = int(info.offset[r]), int(info.nphi[r])
            p = (starts[k] + np.arange(self.W)) % n
            idx[k] = o + p
            phi[k] = info.phi0[r] + 2 * np.pi * p / n
            valid[k] = np.arange(self.W) < n
        self.window_index = idx  # [Rb, W] pixel indices
        self._phi_rw = phi
        self._w_rw = info.weight[self.band][:, None] * valid
        self._rect: dict = {}

        # flat layout: ring k's min(width, nphi) window pixels back to back,
        # padded to a multiple of 128 with zero-weight slots
        fidx, fring, fphi = [], [], []
        for k, r in enumerate(self.band):
            o, n = int(info.offset[r]), int(info.nphi[r])
            w_r = min(widths[k], n)
            p = (starts[k] + np.arange(w_r)) % n
            fidx.append(o + p)
            fring.append(np.full(w_r, k))
            fphi.append(info.phi0[r] + 2 * np.pi * p / n)
        fidx = np.concatenate(fidx)
        fring = np.concatenate(fring)
        fphi = np.concatenate(fphi)
        kf = len(fidx)
        kf_pad = (kf + 127) // 128 * 128
        self.Kf = kf_pad
        self.flat_index = np.concatenate([fidx, np.zeros(kf_pad - kf, np.int64)])
        self.flat_ring = np.concatenate([fring, np.zeros(kf_pad - kf)]).astype(np.int64)
        self._w_k = np.concatenate([info.weight[self.band][fring], np.zeros(kf_pad - kf)])
        self._phi_k = np.concatenate([fphi, np.zeros(kf_pad - kf)])
        self._kf = kf

    @property
    def coverage(self) -> float:
        """Fraction of sphere pixels inside the rectangular window."""
        return self.Rb * self.W / self.sht.npix

    @staticmethod
    def _trig(phi_rows, m, w_rows, out_dtype):
        """Weighted cos/sin(phi x m) [rows, M+1], evaluated in float64 on the host.

        phi*m reaches ~5e3 rad, where a float32 argument would lose ~3e-4
        rad; the float64 trig is staged in row chunks.
        """
        shape = phi_rows.shape + (m.shape[0],)
        C = np.empty(shape, out_dtype)
        S = np.empty(shape, out_dtype)
        phi_flat, w_flat = phi_rows.reshape(-1), w_rows.reshape(-1)
        Cf, Sf = C.reshape(-1, shape[-1]), S.reshape(-1, shape[-1])
        step = max(1, (1 << 22) // max(1, shape[-1]))
        for i in range(0, phi_flat.shape[0], step):
            arg = phi_flat[i : i + step, None] * m
            w = w_flat[i : i + step, None]
            Cf[i : i + step] = np.cos(arg) * w
            Sf[i : i + step] = np.sin(arg) * w
        return C, S

    def flat_tables(self, rdt=torch.float32, device=None):
        """(Ecf, Esf, flat_ring, ring_onehot) on ``device``.

        Ecf/Esf [Kf, M+1]: quadrature-weighted per-pixel DFT factors.
        flat_ring [Kf]: band-ring position of each pixel.  ring_onehot
        [Rb, Kf]: ring membership, for the pixel -> ring reduction as a
        product (deterministic, unlike an atomic scatter).
        """
        device = resolve(device)
        np_dt = np.float64 if rdt == torch.float64 else np.float32
        m = np.arange(self.sht.mmax + 1)
        C, S = self._trig(self._phi_k, m, self._w_k, np_dt)
        onehot = np.zeros((self.Rb, self.Kf), np_dt)
        onehot[self.flat_ring[: self._kf], np.arange(self._kf)] = 1.0
        return (
            torch.as_tensor(C, device=device),
            torch.as_tensor(S, device=device),
            torch.as_tensor(self.flat_ring, device=device),
            torch.as_tensor(onehot, device=device),
        )

    def lam_band(self, rdt=torch.float32, device=None):
        """Band-ring Legendre tensor [L+1, M+1, Rb] in ``rdt``."""
        return self.sht.legendre(self.band, rdt, device)

    def lam_band_2f(self, device=None):
        """Two-float (hi float32, lo bfloat16) band Legendre tensors [L+1, M+1, Rb]."""
        return self.sht.legendre(self.band, device=device, two_float=True)

    def rect_tables(self, rdt=torch.float32, device=None):
        """(Ec, Es [Rb, W, M+1], lam_band [L+1, M+1, Rb]) of the box layout.

        Ec/Es carry the quadrature weight and the wrap mask.  Cached per
        (device, dtype): the windowed analysis reuses them call after call.
        """
        key = (resolve(device), rdt)
        if key not in self._rect:
            np_dt = np.float64 if rdt == torch.float64 else np.float32
            C, S = self._trig(self._phi_rw, np.arange(self.sht.mmax + 1), self._w_rw, np_dt)
            self._rect[key] = (
                torch.as_tensor(C, device=key[0]),
                torch.as_tensor(S, device=key[0]),
                self.lam_band(rdt, key[0]),
            )
        return self._rect[key]

    def gather(self, maps: torch.Tensor) -> torch.Tensor:
        """Window view [..., Rb, W] of full maps [..., npix]."""
        return maps[..., torch.as_tensor(self.window_index, device=maps.device)]

    def analysis(self, maps_win: torch.Tensor) -> torch.Tensor:
        """alm[..., L+1, M+1] of windowed maps [..., Rb, W].

        Real input gives the real-field alm (m >= 0); complex input the
        transform of the complex map, from one stacked pass over [re, im].
        """
        if maps_win.is_complex():
            ri = self._analysis_real(torch.stack([maps_win.real, maps_win.imag]))
            return ri[0] + 1j * ri[1]
        return self._analysis_real(maps_win)

    def analysis_pair(self, re_win: torch.Tensor, im_win: torch.Tensor):
        """(alm(B), alm(conj B)) for B = re + i im from one stacked pass."""
        ri = self._analysis_real(torch.stack([re_win, im_win]))
        return ri[0] + 1j * ri[1], ri[0] - 1j * ri[1]

    def _analysis_real(self, x: torch.Tensor) -> torch.Tensor:
        """F = sum_w x (cos - i sin) per band ring, alm = sum_r Lambda F."""
        Ec, Es, lam = self.rect_tables(x.dtype, x.device)
        Fc = torch.einsum("...rw,rwm->...rm", x, Ec)
        Fs = torch.einsum("...rw,rwm->...rm", x, Es)
        return torch.complex(
            torch.einsum("lmr,...rm->...lm", lam, Fc),
            -torch.einsum("lmr,...rm->...lm", lam, Fs),
        )
