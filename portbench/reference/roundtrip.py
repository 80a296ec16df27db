"""The simulate -> dirty-map round trip, the plain way.

For baseline b of channel f and sky polarisation p the beam-fringe map is
B(pix) = beamproduct(pix) exp(2 pi i b . n_pix / lambda).  Its m-th
sidereal harmonics are (Shaw et al., arXiv:1302.0327)

    V+_m = 4 pi / npix  sum_p sum_pix B(pix)       e^{+i m phi} S_p[ring, m]
    V-_m = 4 pi / npix  sum_p sum_pix conj(B(pix)) e^{+i m phi} S_p[ring, m]     (none at m = 0)

with S_p[ring, m] = sum_l Lambda[m, l, ring] alm_p[l, m] the sky's band-limited
harmonics on each ring.  The m-modes are weighted, and the dirty alm are
the adjoint of the same operator,

    a_p[l, m] = 4 pi / npix  sum_ring Lambda[m, l, ring] sum_b sum_pix e^{-i m phi}
                (conj(B(pix)) w+ V+_m + B(pix) w- V-_m),

synthesised to a map.  Every baseline's beam-fringe map is made over the
whole sphere and summed ring by ring: no window, no cut in m, no shared
geometry.  Nothing here is taken from the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import Telescope, pixel_vectors
from .sht import SHT


class RoundTrip:
    """The round trip of one telescope, in ``dtype`` on ``device``."""

    def __init__(self, tel: Telescope, dtype=torch.float64, device="cpu", chunk: int = 64):
        self.tel, self.dtype, self.device, self.chunk = tel, dtype, device, chunk
        self.sht = SHT(tel.nside, tel.lmax, tel.mmax, dtype, device)
        self.cdt = self.sht.rings.cdt
        self.vec = torch.as_tensor(pixel_vectors(tel.nside), dtype=dtype, device=device)
        self.b3 = torch.as_tensor(tel.baselines_3d(), dtype=dtype, device=device)

    def _products(self, fi: int) -> dict:
        """The beam products of channel ``fi`` on the device, made once."""
        cache = self.__dict__.setdefault("_product_cache", {})
        if fi not in cache:
            cache[fi] = {k: torch.as_tensor(v, dtype=self.cdt, device=self.device)
                         for k, v in self.tel.beam_products(fi).items()}
        return cache[fi]

    def _beam_fringe(self, products: dict, fi: int, b0: int, b1: int) -> torch.Tensor:
        """B [C, npol, npix] of baselines b0..b1 at channel ``fi``."""
        turns = (self.b3[b0:b1] @ self.vec.T) / float(self.tel.wavelengths[fi])
        fringe = torch.polar(torch.ones_like(turns), 2 * np.pi * torch.remainder(turns, 1.0)).to(self.cdt)
        cls = self.tel.classes[b0:b1]
        out = torch.empty(b1 - b0, self.tel.num_pol_sky, fringe.shape[-1], dtype=self.cdt, device=self.device)
        for key, prod in products.items():
            rows = torch.as_tensor(np.nonzero((cls[:, 0] == key[0]) & (cls[:, 1] == key[1]))[0], device=self.device)
            out[rows] = prod[None] * fringe[rows, None, :]
        return out

    def _adjoint(self, nfreq: int, npol: int, modes) -> torch.Tensor:
        """Dirty maps [nfreq, npol, npix] of the weighted m-modes that
        ``modes(fi, b0, b1, minus, plus)`` gives as (w+ V+, w- V-), each [C, mmax+1],
        from the ring sums of baselines b0..b1's beam-fringe maps at channel fi."""
        sht, tel = self.sht, self.tel
        T = torch.zeros(nfreq, npol, sht.rings.nring, tel.mmax + 1, dtype=self.cdt, device=self.device)
        for fi in range(nfreq):
            products = self._products(fi)
            for b0 in range(0, tel.nbase, self.chunk):
                b1 = min(b0 + self.chunk, tel.nbase)
                minus, plus = sht.rings.sums(self._beam_fringe(products, fi, b0, b1))  # [C, p, ring, M+1]
                vp, vm = modes(fi, b0, b1, minus, plus)
                vm = vm * (torch.arange(tel.mmax + 1, device=self.device) > 0)  # no negative mode at m = 0
                T[fi] += torch.einsum("cprm,cm->prm", plus.conj(), vp) + torch.einsum("cprm,cm->prm", minus, vm)
                del minus, plus
        return sht.synthesis(sht.ring_to_alm(T) * sht.rings.weight)

    @torch.no_grad()
    def __call__(self, sky: torch.Tensor, weight: torch.Tensor | None = None) -> torch.Tensor:
        """Dirty maps [nfreq, npol, npix] of ``sky`` [nfreq, npol, npix]; ``weight``
        [mmax+1, 2, nfreq, nbase] weights the m-modes (unit weights when None)."""
        sht = self.sht
        sky = sky.to(device=self.device, dtype=self.dtype)
        S = sht.alm_to_ring(sht.analysis(sky))  # [f, p, ring, M+1]

        def modes(fi, b0, b1, minus, plus):
            vp = torch.einsum("cprm,prm->cm", plus, S[fi]) * self.sht.rings.weight
            vm = torch.einsum("cprm,prm->cm", minus.conj(), S[fi]) * self.sht.rings.weight
            if weight is None:
                return vp, vm
            w = weight[:, :, fi, b0:b1].to(device=self.device, dtype=self.dtype)
            return vp * w[:, 0].T, vm * w[:, 1].T

        return self._adjoint(sky.shape[0], sky.shape[1], modes)
