"""Beam products and the windowed-SHT state of the m-mode operator.

The subset of ``draco_tpu.telescope.beamtransfer.BeamTransfer`` that the
fused round trip consumes: per-frequency beam products deduplicated by
beamclass pair (host numpy), the compact-support window, and the SHT
tables.  For baseline b the beam-fringe pattern is

    B_b(n) = beamprod_b(n) * exp(2 pi i b . n / lambda)

(Shaw et al., arXiv:1302.0327).  Dense beam-transfer generation, the
per-m projections and the SVD products are not ported yet.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..ops import healpix, sht
from ..ops.sht_window import WindowedSHT, support_fraction
from .core import TransitTelescope

# relative beam-product threshold of the compact-support window
WINDOW_TAU = 1e-6


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class BeamTransfer:
    """Beam products, support window and SHT tables of one telescope.

    Parameters
    ----------
    telescope
        The telescope model.
    nside
        HEALPix resolution of beam evaluation (default: the smallest power
        of two with 2*nside >= lmax+1).
    """

    # per-frequency beam products are [nuniq, npol, npix] complex128; two
    # entries cover the same-frequency reuse between build phases
    _BEAM_PRODUCTS_LRU = 2

    def __init__(self, telescope: TransitTelescope, nside: int | None = None):
        self.telescope = telescope
        self._nside = nside
        self._beam_products_cache: OrderedDict = OrderedDict()
        self._win_cache = None
        self._win_done = False
        self._fused_fns: dict = {}

    @property
    def beam_nside(self) -> int:
        if self._nside is not None:
            return self._nside
        return max(4, _next_pow2(int(np.ceil((self.telescope.lmax + 1) / 2))))

    def _beam_fringe_maps(self, fi: int, pair_sel=None, device=None) -> torch.Tensor:
        """Beam-fringe maps per unique pair: complex64 [nbase, npol_sky, npix].

        The pixel solid angle is folded in.  ``pair_sel`` optionally slices
        the unique-pair axis.
        """
        tel = self.telescope
        nside = self.beam_nside
        vec = healpix.pix2vec(nside)
        if pair_sel is None:
            pair_sel = slice(None)
        bl3 = tel.baseline_vectors_3d()[pair_sel]
        fringe = np.exp(2j * np.pi * (bl3 @ vec.T) / tel.wavelengths[fi])
        u_idx, bprod = self._beam_products(fi)
        bmaps = bprod[u_idx[pair_sel]] * fringe[:, None, :]
        return torch.as_tensor(bmaps.astype(np.complex64), device=device)

    def _beam_products(self, fi: int):
        cache = self._beam_products_cache
        if fi in cache:
            cache.move_to_end(fi)
        else:
            cache[fi] = self._beam_products_impl(fi)
            while len(cache) > self._BEAM_PRODUCTS_LRU:
                cache.popitem(last=False)
        return cache[fi]

    def _beam_products_impl(self, fi: int):
        """Deduped beam-product maps per beamclass pair (host arrays).

        Returns ``(u_idx, bprod)``: ``bprod[u]`` is the [npol, npix] complex
        beam product (pixel solid angle folded in) of unique beamclass pair
        ``u``, and ``u_idx[b]`` maps each baseline to its product.
        """
        tel = self.telescope
        nside = self.beam_nside
        bc = tel.beamclass
        keys = [(int(bc[i]), int(bc[j])) for i, j in tel.uniquepairs]
        uniq = sorted(set(keys))
        kmap = {k: u for u, k in enumerate(uniq)}
        u_idx = np.array([kmap[k] for k in keys], dtype=np.int64)

        class_feeds = {int(c): int(np.where(bc == c)[0][0]) for c in np.unique(bc)}
        beams = {c: np.asarray(tel.beam(f, fi, nside)) for c, f in class_feeds.items()}
        npol = tel.num_pol_sky
        first = next(iter(beams.values()))
        out = []
        for ci, cj in uniq:
            if first.ndim == 1:
                bp = (beams[ci] * np.conj(beams[cj]))[None, :]
                if npol == 4:
                    z = np.zeros_like(bp)
                    bp = np.concatenate([bp, z, z, z], axis=0)
            else:
                Et_i, Ep_i = beams[ci][:, 0], beams[ci][:, 1]
                Et_j, Ep_j = beams[cj][:, 0], beams[cj][:, 1]
                tt = Et_i * np.conj(Et_j)
                pp = Ep_i * np.conj(Ep_j)
                tp = Et_i * np.conj(Ep_j)
                pt = Ep_i * np.conj(Et_j)
                B = [0.5 * (tt + pp), 0.5 * (tt - pp), 0.5 * (tp + pt), 0.5j * (tp - pt)]
                bp = np.stack(B[:npol], axis=0)
            out.append(bp)
        omega_pix = 4 * np.pi / healpix.npix_of(nside)
        return u_idx, np.stack(out) * omega_pix

    def _support_mask(self) -> np.ndarray:
        """Union of |beam product| over frequencies and beamclass pairs."""
        support = np.zeros(healpix.npix_of(self.beam_nside))
        for fi in range(self.telescope.nfreq):
            _, bprod = self._beam_products(fi)
            support = np.maximum(support, np.abs(bprod).max(axis=(0, 1)))
        return support

    def _beam_window(self) -> WindowedSHT | None:
        """The compact-support window of the beam products, or None if wide.

        Compact means at most a quarter of the sphere above
        ``WINDOW_TAU`` of the peak and a rectangular window under half of it.
        """
        if not self._win_done:
            support = self._support_mask()
            win = None
            if support_fraction(support, tau=WINDOW_TAU) <= 0.25:
                s = sht.get_sht(self.beam_nside, self.telescope.lmax, self.telescope.mmax)
                cand = WindowedSHT(s, support, tau=WINDOW_TAU, margin=4)
                if cand.coverage <= 0.5:
                    win = cand
            self._win_cache = win
            self._win_done = True
        return self._win_cache

    def _streaming_ops2(self, device, rdt=torch.float32):
        """(sht, lam_hi, lam_lo, plan) on ``device``.

        float32 tables are two-float (``lam_lo`` the bfloat16 residual);
        float64 tables are exact and ``lam_lo`` is None.
        """
        s = sht.get_sht(self.beam_nside, self.telescope.lmax, self.telescope.mmax)
        lam, lam_lo, plan = s.tables(device, rdt)
        return s, lam, lam_lo, plan
