"""Spherical-harmonic transforms on HEALPix rings, in plain PyTorch.

Fully normalised harmonics with the Condon-Shortley phase, real fields
kept as their m >= 0 coefficients alm[..., l, m], the equal-area
quadrature 4 pi / npix:

    analysis   alm[l, m] = 4 pi / npix  sum_pix f(pix) Lambda[m, l, ring] e^{-i m phi}
    synthesis  f(pix)    = Re sum_m c_m e^{i m phi} sum_l Lambda[m, l, ring] alm[l, m],  c_0 = 1, c_m>0 = 2

Lambda comes from the upward recurrence in l, seeded at l = m from its
logarithm (a seed below the dtype's range is a zero), in the dtype asked
for.  Each ring's azimuthal sums are one FFT of the ring's pixels; an m at
or above a ring's pixel count reads the FFT's bin m mod nphi, which is the
sum itself, not an approximation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import geometry


def legendre(nside: int, lmax: int, mmax: int, dtype, device) -> torch.Tensor:
    """Lambda[m, l, ring] [mmax+1, lmax+1, nring] in ``dtype``."""
    theta = geometry.rings(nside)[0]
    x = torch.as_tensor(np.cos(theta), dtype=dtype, device=device)
    m = np.arange(mmax + 1)
    log_c = 0.5 * (np.concatenate([[0.0], np.cumsum(np.log((2 * m[1:] + 1) / (2 * m[1:])))]) - np.log(4 * np.pi))
    ln_seed = log_c[:, None] + m[:, None] * np.log(np.sin(theta))[None, :]
    seed = torch.as_tensor(np.where(m % 2 == 0, 1.0, -1.0)[:, None] * np.exp(ln_seed), dtype=dtype, device=device)
    out = torch.zeros(mmax + 1, lmax + 1, len(theta), dtype=dtype, device=device)
    p1 = torch.zeros(mmax + 1, len(theta), dtype=dtype, device=device)
    p2 = torch.zeros_like(p1)
    for l in range(lmax + 1):
        with np.errstate(divide="ignore", invalid="ignore"):
            a = np.sqrt((4.0 * l * l - 1) / (l * l - m * m))
            b = -np.sqrt((2.0 * l + 1) * (l - 1 + m) * (l - 1 - m) / ((2.0 * l - 3) * (l * l - m * m)))
        below = m < l
        a = torch.as_tensor(np.where(below & np.isfinite(a), a, 0.0), dtype=dtype, device=device)[:, None]
        b = torch.as_tensor(np.where(below & np.isfinite(b), b, 0.0), dtype=dtype, device=device)[:, None]
        new = a * x * p1 + b * p2
        if l <= mmax:
            new[l] = seed[l]
        out[:, l] = new
        p2, p1 = p1, new
    return out


class Rings:
    """The ring sums and their inverse on one nside, for m = 0 .. mmax."""

    def __init__(self, nside: int, mmax: int, dtype, device):
        theta, nphi, phi0, offset = geometry.rings(nside)
        self.nring, self.npix, self.mmax = len(theta), 12 * nside * nside, mmax
        self.weight = 4 * math.pi / self.npix
        cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
        self.cdt, self.device = cdt, device
        m = np.arange(mmax + 1)
        # rings of one pixel count form one group: the belt, and each north cap ring with its southern mirror
        self.groups = []
        for n in np.unique(nphi):
            ids = np.nonzero(nphi == n)[0]
            pix = offset[ids][:, None] + np.arange(n)[None, :]
            ph = np.exp(1j * m[None, :] * phi0[ids][:, None])  # e^{i m phi0} [g, M+1]
            self.groups.append((
                int(n),
                torch.as_tensor(ids, device=device),
                torch.as_tensor(pix, device=device),
                torch.as_tensor(m % n, device=device),
                torch.as_tensor((-m) % n, device=device),
                torch.as_tensor(ph, dtype=cdt, device=device),
            ))

    def sums(self, f: torch.Tensor):
        """(sum_j f e^{-i m phi_j}, sum_j f e^{+i m phi_j}) of every ring, each [..., nring, mmax+1]."""
        f = f.to(self.cdt)
        lead = f.shape[:-1]
        minus = torch.empty(*lead, self.nring, self.mmax + 1, dtype=self.cdt, device=f.device)
        plus = torch.empty_like(minus)
        for n, ids, pix, k_minus, k_plus, ph in self.groups:
            y = torch.fft.fft(f[..., pix], dim=-1)  # [..., g, n]
            minus[..., ids, :] = y[..., k_minus] * ph.conj()
            plus[..., ids, :] = y[..., k_plus] * ph
        return minus, plus

    def inverse(self, G: torch.Tensor) -> torch.Tensor:
        """Real f(pix) = Re sum_m G[..., ring, m] e^{i m phi_j}, [..., npix]."""
        lead = G.shape[:-2]
        out = torch.empty(*lead, self.npix, dtype=G.real.dtype, device=G.device)
        for n, ids, pix, k_minus, _, ph in self.groups:
            H = torch.zeros(*lead, len(ids), n, dtype=G.dtype, device=G.device)
            H.index_add_(-1, k_minus, G[..., ids, :] * ph)
            out[..., pix] = (torch.fft.ifft(H, dim=-1) * n).real
        return out


class SHT:
    """Analysis and synthesis of real maps [..., npix] on one grid."""

    def __init__(self, nside: int, lmax: int, mmax: int, dtype=torch.float64, device="cpu"):
        self.lam = legendre(nside, lmax, mmax, dtype, device)
        self.rings = Rings(nside, mmax, dtype, device)
        self.cm = torch.full((mmax + 1,), 2.0, dtype=dtype, device=device)
        self.cm[0] = 1.0

    def ring_to_alm(self, F: torch.Tensor) -> torch.Tensor:
        """alm[..., l, m] = sum_ring Lambda[m, l, ring] F[..., ring, m]."""
        return torch.complex(*(torch.einsum("mlr,...rm->...lm", self.lam, part) for part in (F.real, F.imag)))

    def alm_to_ring(self, alm: torch.Tensor) -> torch.Tensor:
        """G[..., ring, m] = sum_l Lambda[m, l, ring] alm[..., l, m]."""
        return torch.complex(*(torch.einsum("mlr,...lm->...rm", self.lam, part) for part in (alm.real, alm.imag)))

    def analysis(self, maps: torch.Tensor) -> torch.Tensor:
        return self.ring_to_alm(self.rings.sums(maps)[0]) * self.rings.weight

    def synthesis(self, alm: torch.Tensor) -> torch.Tensor:
        return self.rings.inverse(self.alm_to_ring(alm) * self.cm)
