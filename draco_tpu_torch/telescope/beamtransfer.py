"""Beam transfer matrices: the m-mode measurement operator.

Port of ``draco_tpu.telescope.beamtransfer.BeamTransfer``.  For unique
baseline b the beam-fringe pattern is

    B_b(n) = beamprod_b(n) * exp(2 pi i b . n / lambda)

(Shaw et al., arXiv:1302.0327), and the m-th sidereal harmonic of its
visibility is

    V_m     = sum_l Bp[l, m] a_lm,      Bp = conj(SHT(conj(B)))
    V*_{-m} = sum_l Bm[l, m] a_lm,      Bm = conj(SHT(B))

The packed telescope vector of each m >= 0 is [V_m (all baselines);
V*_{-m} (all baselines)], ``ntel = 2 * npairs``, with the [m = 0, msign =
1] block empty.

Two ways to apply the operator:

* :meth:`BeamTransfer.generate` materialises Bp/Bm [nfreq, nbase, npol,
  L+1, M+1] (windowed box-layout analysis for compact beams, the dense
  full-sphere analysis otherwise); the batched projections and the per-m
  SVD products run on them;
* the streaming projections never materialise B: per baseline chunk they
  build the fringe x beam maps on the device from the deduplicated beam
  products and contract them against per-frequency sky sections.

Entry points that build tensors from host data take ``device=``; none
means the first CUDA card (:func:`draco_tpu_torch.device.resolve`).
Everything else follows the device of the tensors it is given or holds.
"""

from __future__ import annotations

import os
import pickle
from collections import OrderedDict

import numpy as np
import torch

from ..device import as_tensor, resolve
from ..ops import healpix, sht
from ..ops.sht_window import WindowedSHT, support_fraction
from ..ops.tools import phase_frac, sincos_turns, svd, twofloat_split
from .core import TransitTelescope

# relative beam-product threshold of the compact-support window
WINDOW_TAU = 1e-6

# modules of a pickled draco_tpu telescope and the port's copies of them
_PICKLE_MODULES = {
    "draco_tpu.telescope.core": "draco_tpu_torch.telescope.core",
    "draco_tpu.core.config": "draco_tpu_torch.core.config",
}


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class _TelescopeUnpickler(pickle.Unpickler):
    """Reads a telescope pickled by either package without importing
    ``draco_tpu``: its classes resolve to the port's copies."""

    def find_class(self, module, name):
        if module == "draco_tpu" or module.startswith("draco_tpu."):
            if module not in _PICKLE_MODULES:
                raise pickle.UnpicklingError(f"{module}.{name} has no counterpart in draco_tpu_torch")
            module = _PICKLE_MODULES[module]
        return super().find_class(module, name)


class BeamTransfer:
    """Generate, store and apply the beam transfer matrices of a telescope.

    Parameters
    ----------
    telescope
        The telescope model (required unless ``directory`` is loaded).
    nside
        HEALPix resolution of beam evaluation (default: the smallest power
        of two with 2*nside >= lmax+1).
    svcut
        Relative singular-value cut of the per-m SVD basis.
    directory
        Product directory to load from (when no telescope is given) or to
        save to.
    device
        Where a loaded directory's beam tensors go.
    """

    # per-frequency beam products are [nuniq, npol, npix] complex128; two
    # entries cover the same-frequency reuse between build phases
    _BEAM_PRODUCTS_LRU = 2
    # m values factored together by the SVD, on their common non-zero columns
    _SVD_M_BLOCK = 16

    def __init__(
        self,
        telescope: TransitTelescope | None = None,
        nside: int | None = None,
        svcut: float = 1e-6,
        directory: str | None = None,
        device=None,
    ):
        self.telescope = telescope
        self._nside = nside
        self.svcut = svcut
        self.directory = directory
        self._bp = None  # [nfreq, nbase, npol, L+1, M+1] complex64
        self._bm = None
        self._reset_caches()
        if directory is not None and telescope is None:
            self.load(directory, device=device)

    def _reset_caches(self):
        """Forget everything derived from the telescope and the beam tensors."""
        self._beam_products_cache: OrderedDict = OrderedDict()
        self._win_cache = None
        self._win_done = False
        self._fused_fns: dict = {}
        self._fused_tiles: dict = {}
        self._stream_consts: dict = {}
        self._svd = None

    # -- basic properties --------------------------------------------------
    @property
    def nfreq(self) -> int:
        return self.telescope.nfreq

    @property
    def ntel(self) -> int:
        return 2 * self.telescope.npairs

    @property
    def nsky(self) -> int:
        return self.telescope.num_pol_sky * (self.telescope.lmax + 1)

    @property
    def ndofmax(self) -> int:
        self._ensure_svd()
        return int(self._svd["nmode"].max())

    @property
    def beam_nside(self) -> int:
        if self._nside is not None:
            return self._nside
        return max(4, _next_pow2(int(np.ceil((self.telescope.lmax + 1) / 2))))

    # -- beam products and the support window ------------------------------
    def _beam_fringe_maps(self, fi: int, pair_sel=None, device=None) -> torch.Tensor:
        """Beam-fringe maps per unique pair: complex64 [nbase, npol_sky, npix].

        The pixel solid angle is folded in.  ``pair_sel`` optionally slices
        the unique-pair axis.
        """
        device = resolve(device)
        tel = self.telescope
        vec = healpix.pix2vec(self.beam_nside)
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

    def _streaming_ops2(self, device=None, rdt=torch.float32):
        """(sht, lam_hi, lam_lo, plan) on ``device``.

        float32 tables are two-float (``lam_lo`` the bfloat16 residual);
        float64 tables are exact and ``lam_lo`` is None.
        """
        s = sht.get_sht(self.beam_nside, self.telescope.lmax, self.telescope.mmax)
        lam, lam_lo, plan = s.tables(device, rdt)
        return s, lam, lam_lo, plan

    # -- generation ----------------------------------------------------------
    def generate(self, regen: bool = False, device=None) -> "BeamTransfer":
        """Compute Bp/Bm for every frequency on ``device``.

        Compact beams go through the windowed box-layout analysis (the
        fringe x beam maps only where the beam product is non-negligible);
        wide beams through the dense full-sphere SHT.  Both transform the
        [Re, Im] pair of each map in one stacked real analysis: alm(B) =
        A(re) + i A(im), alm(conj B) = A(re) - i A(im).
        """
        if self._bp is not None and not regen:
            return self
        device = resolve(device)
        tel = self.telescope
        # the beam maps carry the pixel solid angle: undo the quadrature weight
        scale = 1.0 / (4 * np.pi / healpix.npix_of(self.beam_nside))
        win = self._beam_window()
        bp_f, bm_f = [], []
        if win is not None:
            vec = np.asarray(healpix.pix2vec(self.beam_nside), np.float64)
            vw_hi, vw_lo = (
                torch.as_tensor(a, device=device) for a in twofloat_split(vec[win.window_index].reshape(-1, 3))
            )
            for fi in range(tel.nfreq):
                u_idx, bprod = self._beam_products(fi)
                bw = bprod[..., win.window_index]  # [U, p, Rb, W]
                br_u = torch.as_tensor(bw.real.astype(np.float32), device=device)
                bi_u = torch.as_tensor(bw.imag.astype(np.float32), device=device)
                bl3 = tel.baseline_vectors_3d() / tel.wavelengths[fi]
                bps, bms = [], []
                for b0, b1 in self._stream_chunks(2048):
                    bl_h, bl_l = (torch.as_tensor(a, device=device) for a in twofloat_split(bl3[b0:b1]))
                    turns = phase_frac(bl_h, bl_l, vw_hi, vw_lo).reshape(b1 - b0, win.Rb, win.W)
                    c, sn = sincos_turns(turns)
                    c, sn = c[:, None], sn[:, None]
                    idx = torch.as_tensor(u_idx[b0:b1], device=device)
                    br, bi = br_u[idx], bi_u[idx]
                    A = win._analysis_real(torch.stack([br * c - bi * sn, br * sn + bi * c]))
                    bps.append((A[0] - 1j * A[1]).conj() * scale)
                    bms.append((A[0] + 1j * A[1]).conj() * scale)
                bp_f.append(torch.cat(bps))
                bm_f.append(torch.cat(bms))
        else:
            s, lam, lam_lo, plan = self._streaming_ops2(device)
            vec = self._stream_geometry(device)
            for fi in range(tel.nfreq):
                # the fringe x beam maps [C, npol, npix] are built on the device
                # from two-float phases, as the streaming projections build
                # them (on the host they took 13 s a frequency at nside 256)
                u_re, u_im, u_idx = self._stream_beam(fi, device)
                bps, bms = [], []
                for b0, b1 in self._stream_chunks(None):
                    re, im = self._stream_bmaps(vec, self._stream_baselines(fi, b0, b1, device), u_re, u_im, u_idx[b0:b1])
                    ri = s._analysis_impl(torch.stack([re, im]), lam, plan, lam_lo)
                    bps.append((ri[0] - 1j * ri[1]).conj() * scale)
                    bms.append((ri[0] + 1j * ri[1]).conj() * scale)
                bp_f.append(torch.cat(bps))
                bm_f.append(torch.cat(bms))
        self._bp = torch.stack(bp_f).to(torch.complex64)
        self._bm = torch.stack(bm_f).to(torch.complex64)
        # the m = 0 negative block duplicates conj(V_0): the m-mode
        # containers leave [m = 0, msign = 1] empty
        self._bm[..., 0] = 0.0
        self._svd = None
        return self

    # -- batched projections -------------------------------------------------
    def beam_m(self, m: int, fi: int | None = None) -> torch.Tensor:
        """Beam transfer matrix of one m: [(nfreq,) ntel, npol, lmax+1]."""
        self.generate()
        sel = slice(None) if fi is None else fi
        return torch.cat([self._bp[sel, ..., m], self._bm[sel, ..., m]], dim=-3)

    def project_vector_sky_to_telescope(self, m: int, alm) -> torch.Tensor:
        """Sky alm [(nfreq,) npol, lmax+1] of one m -> [nfreq, ntel]."""
        self.generate()
        bm_full = self.beam_m(m)  # [nfreq, ntel, npol, L+1]
        alm = as_tensor(alm, bm_full.device).to(bm_full.dtype)
        if alm.ndim == 2:
            return torch.einsum("ftpl,pl->ft", bm_full, alm)
        return torch.einsum("ftpl,fpl->ft", bm_full, alm)

    def project_sky_to_telescope(self, alm) -> torch.Tensor:
        """Sky alm [nfreq, npol, lmax+1, mmax+1] -> m-mode visibilities
        [mmax+1, 2, nfreq, nbase] (msign 0 = V_m, 1 = conj(V_{-m}))."""
        self.generate()
        alm = as_tensor(alm, self._bp.device).to(self._bp.dtype)
        vp = torch.einsum("fbplm,fplm->mfb", self._bp, alm)
        vm = torch.einsum("fbplm,fplm->mfb", self._bm, alm)
        return torch.stack([vp, vm], dim=1)

    def project_telescope_to_sky_dirty(self, vis, weight) -> torch.Tensor:
        """Adjoint (dirty-map) projection: sum_tel conj(B) w v over every m.

        vis, weight [mmax+1, 2, nfreq, nbase] -> alm [nfreq, npol, L+1, M+1].
        """
        self.generate()
        dev, cdt = self._bp.device, self._bp.dtype
        wv = (as_tensor(vis, dev) * as_tensor(weight, dev)).to(cdt)
        a_p = torch.einsum("fbplm,mfb->fplm", self._bp.conj(), wv[:, 0])
        a_m = torch.einsum("fbplm,mfb->fplm", self._bm.conj(), wv[:, 1])
        return a_p + a_m

    # -- streaming (factorised) projections ----------------------------------
    #
    # With B = sum_r conj(F)[b, p, r, m] Lambda[l, m, r] / omega (F the ring
    # coefficients of the fringe x beam maps) the projection factorises:
    #
    #   vis_p[m, b] = sum_{p, r} conj(F_cb) S[p, r, m] / omega,
    #   S = sum_l Lambda alm  (once per frequency),
    #
    # and the adjoint accumulates T[p, r, m] = sum_b F (w v) over baseline
    # chunks, with Lambda applied once at the end.  Compact beams run the
    # windowed form: with a1 + i a2 = (Ec + i Es) S per (pol, pixel), the
    # chunk visibilities are four [C, p*Kf] x [p*Kf, M+1] products and the
    # adjoint accumulates Y[(p k), m], with (Ec - i Es) and Lambda applied
    # after the loop.

    def _stream_chunks(self, chunk):
        nbase = len(self.telescope.uniquepairs)
        if chunk is None:
            chunk = max(1, min(nbase, 256))
        for b0 in range(0, nbase, chunk):
            yield b0, min(b0 + chunk, nbase)

    def _stream_geometry(self, device):
        """Two-float (hi, lo) pixel vectors [npix, 3] on ``device``."""
        key = ("vec", device)
        if key not in self._stream_consts:
            vec = np.asarray(healpix.pix2vec(self.beam_nside), np.float64)
            self._stream_consts[key] = tuple(torch.as_tensor(a, device=device) for a in twofloat_split(vec))
        return self._stream_consts[key]

    @staticmethod
    def _stream_bmaps(vec, bl_w, u_re, u_im, uidx):
        """Fringe x beam-product maps ([C, p, K] re, im).

        ``vec`` and ``bl_w`` are (hi, lo) two-float pairs: exact fringe
        phases whatever the baseline length.
        """
        c, sn = sincos_turns(phase_frac(bl_w[0], bl_w[1], vec[0], vec[1]))
        c, sn = c[:, None, :], sn[:, None, :]
        br, bi = u_re[uidx], u_im[uidx]
        return br * c - bi * sn, br * sn + bi * c

    def _stream_beam(self, fi: int, device, gather=None):
        """(u_re, u_im [U, p, K] float32, u_idx [nbase]) of frequency ``fi``."""
        u_idx, bprod = self._beam_products(fi)
        if gather is not None:
            bprod = bprod[..., gather]
        return (
            torch.as_tensor(bprod.real.astype(np.float32), device=device),
            torch.as_tensor(bprod.imag.astype(np.float32), device=device),
            torch.as_tensor(u_idx, device=device),
        )

    def _stream_baselines(self, fi: int, b0: int, b1: int, device):
        """Two-float baseline vectors in wavelengths of chunk [b0, b1)."""
        bl3 = self.telescope.baseline_vectors_3d().astype(np.float64)[b0:b1] / self.telescope.wavelengths[fi]
        return tuple(torch.as_tensor(a, device=device) for a in twofloat_split(bl3))

    def _windowed_stream_fns(self, win, device):
        """Constants of the windowed streaming projections on ``device``:
        (Ecf, Esf, (lam_hi, lam_lo), (vw_hi, vw_lo), flat_ring, ring_onehot).

        The band Legendre tables are two-float (hi float32, lo bfloat16 from
        a float64 recurrence), as in the fused program: the single-float
        table of the JAX package's streaming projections put the task chain
        1.24e-5 of the peak from the float64 map at nside 256.
        """
        key = ("win", device)
        if key not in self._stream_consts:
            Ecf, Esf, flat_ring, ring_onehot = win.flat_tables(torch.float32, device)
            vec = np.asarray(healpix.pix2vec(self.beam_nside), np.float64)[win.flat_index]
            vw = tuple(torch.as_tensor(a, device=device) for a in twofloat_split(vec))
            self._stream_consts[key] = (Ecf, Esf, win.lam_band_2f(device), vw, flat_ring, ring_onehot)
        return self._stream_consts[key]

    @staticmethod
    def _band_contract(eq: str, x: torch.Tensor, lam) -> torch.Tensor:
        """``einsum(eq, x, Lambda)`` against the two-float band table, hi + lo
        contracted in float32."""
        hi, lo = lam
        return torch.einsum(eq, x, hi) + torch.einsum(eq, x, lo.to(hi.dtype))

    def _fringe_win(self, vw, bl_w, u_re, u_im, uidx):
        """Windowed fringe x beam planes ([C, p*Kf] re, im)."""
        re, im = self._stream_bmaps(vw, bl_w, u_re, u_im, uidx)
        return re.reshape(re.shape[0], -1), im.reshape(im.shape[0], -1)

    def _project_sky_streaming_windowed(self, alm, win, chunk):
        tel = self.telescope
        dev = alm.device
        mmax = win.sht.mmax
        scale = 1.0 / (4 * np.pi / healpix.npix_of(self.beam_nside))
        Ecf, Esf, lam_band, vw, flat_ring, _ = self._windowed_stream_fns(win, dev)
        vis = torch.zeros(mmax + 1, 2, tel.nfreq, len(tel.uniquepairs), dtype=torch.complex64, device=dev)
        for fi in range(tel.nfreq):
            a = alm[fi].to(torch.complex64)
            Sr = self._band_contract("plm,lmr->prm", a.real, lam_band).index_select(1, flat_ring)
            Si = self._band_contract("plm,lmr->prm", a.imag, lam_band).index_select(1, flat_ring)
            a1 = (Ecf * Sr - Esf * Si).reshape(-1, mmax + 1)
            a2 = (Ecf * Si + Esf * Sr).reshape(-1, mmax + 1)
            u_re, u_im, u_idx = self._stream_beam(fi, dev, win.flat_index)
            for b0, b1 in self._stream_chunks(chunk):
                re, im = self._fringe_win(vw, self._stream_baselines(fi, b0, b1, dev), u_re, u_im, u_idx[b0:b1])
                G1, G2, G3, G4 = re @ a1, im @ a2, re @ a2, im @ a1
                vis[:, 0, fi, b0:b1] = torch.complex(G1 - G2, G3 + G4).T * scale
                vis[:, 1, fi, b0:b1] = torch.complex(G1 + G2, G3 - G4).T * scale
        vis[0, 1] = 0.0
        return vis

    def _project_dirty_streaming_windowed(self, wv, win, chunk):
        tel = self.telescope
        dev = wv.device
        mmax = win.sht.mmax
        npol = tel.num_pol_sky
        scale = 1.0 / (4 * np.pi / healpix.npix_of(self.beam_nside))
        Ecf, Esf, lam_band, vw, _, ring_onehot = self._windowed_stream_fns(win, dev)
        alm_out = []
        for fi in range(tel.nfreq):
            u_re, u_im, u_idx = self._stream_beam(fi, dev, win.flat_index)
            Yr = torch.zeros(npol * win.Kf, mmax + 1, device=dev)
            Yi = torch.zeros(npol * win.Kf, mmax + 1, device=dev)
            for b0, b1 in self._stream_chunks(chunk):
                v0, v1 = wv[:, 0, fi, b0:b1], wv[:, 1, fi, b0:b1]
                vs, vd = (v0 + v1).T, (v1 - v0).T  # [C, M+1]
                re, im = self._fringe_win(vw, self._stream_baselines(fi, b0, b1, dev), u_re, u_im, u_idx[b0:b1])
                Yr += re.T @ vs.real - im.T @ vd.imag
                Yi += re.T @ vs.imag + im.T @ vd.real
            # conjugate per-pixel DFT factors, then the pixel -> ring reduction
            Yr = Yr.reshape(npol, win.Kf, mmax + 1)
            Yi = Yi.reshape(npol, win.Kf, mmax + 1)
            Tr = torch.einsum("rk,pkm->prm", ring_onehot, Ecf * Yr + Esf * Yi)
            Ti = torch.einsum("rk,pkm->prm", ring_onehot, Ecf * Yi - Esf * Yr)
            alm_out.append(
                torch.complex(
                    self._band_contract("prm,lmr->plm", Tr, lam_band), self._band_contract("prm,lmr->plm", Ti, lam_band)
                ) * scale
            )
        return torch.stack(alm_out)

    def project_sky_to_telescope_streaming(self, alm, chunk=None, device=None) -> torch.Tensor:
        """Streaming equivalent of :meth:`project_sky_to_telescope`.

        Never materialises B: per (frequency, baseline chunk) the fringe x
        beam maps are built on the device from the deduplicated beam
        products.  Runs on ``alm``'s device (a host array goes to
        ``device``) in float32; returns complex64 [mmax+1, 2, nfreq, nbase].
        """
        alm = as_tensor(alm, device)
        win = self._beam_window()
        if win is not None:
            return self._project_sky_streaming_windowed(alm, win, chunk)
        tel = self.telescope
        dev = alm.device
        s, lam, lam_lo, plan = self._streaming_ops2(dev)
        mmax = s.mmax
        scale = 1.0 / (4 * np.pi / healpix.npix_of(self.beam_nside))
        vec = self._stream_geometry(dev)
        vis = torch.zeros(mmax + 1, 2, tel.nfreq, len(tel.uniquepairs), dtype=torch.complex64, device=dev)
        for fi in range(tel.nfreq):
            G_belt, G_caps = s._legendre_sections(alm[fi].to(torch.complex64), lam, lam_lo)
            # conj(F) S summed over (p, r) = conj(F conj(S)): conjugate the small side
            S_conj = [G.conj() for G in (G_belt, *G_caps)]
            u_re, u_im, u_idx = self._stream_beam(fi, dev)
            for b0, b1 in self._stream_chunks(chunk):
                re, im = self._stream_bmaps(vec, self._stream_baselines(fi, b0, b1, dev), u_re, u_im, u_idx[b0:b1])
                F_belt, group_F = s._ring_analysis_parts(torch.stack([re, im]), plan)  # [2, C, p, r, M+1]
                UV = sum(torch.einsum("xcprm,prm->xmc", F2, Sc) for F2, Sc in zip((F_belt, *group_F), S_conj))
                U, V = UV.conj()
                vis[:, 0, fi, b0:b1] = (U + 1j * V) * scale
                vis[:, 1, fi, b0:b1] = (U - 1j * V) * scale
        # m-mode container convention: [m = 0, msign = 1] is empty
        vis[0, 1] = 0.0
        return vis

    def project_telescope_to_sky_dirty_streaming(self, vis, weight, chunk=None, device=None) -> torch.Tensor:
        """Streaming equivalent of :meth:`project_telescope_to_sky_dirty`:
        complex64 alm [nfreq, npol, L+1, M+1] on ``vis``'s device."""
        vis = as_tensor(vis, device)
        wv = (vis * as_tensor(weight, vis.device)).to(torch.complex64)
        # the materialised operator zeroes Bm at m = 0: match it exactly
        wv[0, 1] = 0.0
        win = self._beam_window()
        if win is not None:
            return self._project_dirty_streaming_windowed(wv, win, chunk)
        tel = self.telescope
        dev = wv.device
        s, lam, lam_lo, plan = self._streaming_ops2(dev)
        scale = 1.0 / (4 * np.pi / healpix.npix_of(self.beam_nside))
        vec = self._stream_geometry(dev)
        out = []
        for fi in range(tel.nfreq):
            u_re, u_im, u_idx = self._stream_beam(fi, dev)
            T_secs = None
            for b0, b1 in self._stream_chunks(chunk):
                v_sum = wv[:, 0, fi, b0:b1] + wv[:, 1, fi, b0:b1]
                v_dif = 1j * (wv[:, 1, fi, b0:b1] - wv[:, 0, fi, b0:b1])
                vst = torch.stack([v_sum, v_dif])  # [2, M+1, C]
                re, im = self._stream_bmaps(vec, self._stream_baselines(fi, b0, b1, dev), u_re, u_im, u_idx[b0:b1])
                F_belt, group_F = s._ring_analysis_parts(torch.stack([re, im]), plan)
                # conj(bp) = F_cb Lambda scale, conj(bm) = F_b Lambda scale
                dT = [torch.einsum("xcprm,xmc->prm", F2, vst) for F2 in (F_belt, *group_F)]
                T_secs = dT if T_secs is None else [T + d for T, d in zip(T_secs, dT)]
            out.append(s._contract_alm(T_secs[0], T_secs[1:], lam, lam_lo) * scale)
        return torch.stack(out)

    # -- SVD products ------------------------------------------------------------
    def _ensure_svd(self):
        """Batched per-(freq, m) economy SVD of the beam matrix [ntel, nsky].

        U [f, M+1, ntel, k], singular values [f, M+1, k], the retained-mode
        mask ``keep`` (s > svcut * max s) and per-m mode counts; ragged
        ranks are carried as masked columns of a common k.
        """
        if self._svd is not None:
            return
        self.generate()
        f, _, npol, L1, M1 = self._bp.shape
        ntel, k = self.ntel, min(self.ntel, self.nsky)
        dev = self._bp.device
        U = torch.zeros((f, M1, ntel, k), dtype=torch.complex64, device=dev)
        s = torch.zeros((f, M1, k), dtype=torch.float32, device=dev)
        Vh = torch.zeros((f, M1, k, npol, L1), dtype=torch.complex64, device=dev)
        # B is zero for l < m: each block of m is factored on its columns l >= m0
        # alone, which is the same decomposition for less work (and leaves the
        # solver no block of exact zeros).  Where fewer than k columns are left
        # the full U completes the basis, so that U stays orthonormal.
        for m0 in range(0, M1, self._SVD_M_BLOCK):
            m1 = min(m0 + self._SVD_M_BLOCK, M1)
            B = torch.cat([self._bp[..., m0:, m0:m1], self._bm[..., m0:, m0:m1]], dim=1)  # [f, ntel, p, L1 - m0, mb]
            B = B.movedim(-1, 1).reshape(f, m1 - m0, ntel, npol * (L1 - m0))
            u, sv, vh = svd(B, full_matrices=B.shape[-1] < k)
            kk = sv.shape[-1]
            U[:, m0:m1, :, : min(u.shape[-1], k)] = u[..., :k]
            s[:, m0:m1, :kk] = sv
            Vh[:, m0:m1, :kk, :, m0:] = vh[..., :kk, :].reshape(f, m1 - m0, kk, npol, L1 - m0)
        Vh = Vh.reshape(f, M1, k, self.nsky)
        del B, u, sv, vh
        smax = s.max(dim=-1, keepdim=True).values
        keep = s > self.svcut * smax.clamp(min=1e-30)
        self._svd = {"U": U, "s": s, "Vh": Vh, "keep": keep, "nmode": keep.sum(dim=-1)}

    def svd_len(self, m: int | None = None) -> int:
        """Retained SVD modes at ``m``, or the padded count of every m."""
        self._ensure_svd()
        if m is not None:
            return int(self._svd["nmode"][:, m].max())
        return int(self._svd["s"].shape[-1])

    def svd_spectrum(self) -> torch.Tensor:
        """Singular values [nfreq, M+1, k]."""
        self._ensure_svd()
        return self._svd["s"]

    def nmodes(self) -> torch.Tensor:
        """Retained modes [nfreq, M+1]."""
        self._ensure_svd()
        return self._svd["nmode"]

    def project_vector_telescope_to_svd(self, m: int, tm) -> torch.Tensor:
        """Telescope vector(s) [nfreq, ntel] of one m -> SVD basis [nfreq, k]."""
        self._ensure_svd()
        U, keep = self._svd["U"][:, m], self._svd["keep"][:, m]
        tm = as_tensor(tm, U.device).to(U.dtype).reshape(-1, self.ntel)
        return torch.einsum("ftk,ft->fk", U.conj(), tm) * keep

    def project_vector_svd_to_telescope(self, m: int, svdm) -> torch.Tensor:
        """SVD vector(s) [nfreq, k] of one m -> telescope basis [nfreq, ntel]."""
        self._ensure_svd()
        U, keep = self._svd["U"][:, m], self._svd["keep"][:, m]
        svdm = as_tensor(svdm, U.device).to(U.dtype).reshape(-1, self.svd_len())
        return torch.einsum("ftk,fk->ft", U, svdm * keep)

    def project_telescope_to_svd(self, vis) -> torch.Tensor:
        """m-mode visibilities [M+1, 2, nfreq, nbase] -> SVD basis [M+1, nfreq, k]."""
        self._ensure_svd()
        U, keep = self._svd["U"], self._svd["keep"]
        vis = as_tensor(vis, U.device).to(U.dtype)
        tm = vis.movedim(2, 1).reshape(vis.shape[0], vis.shape[2], -1)  # [M+1, f, ntel]
        return torch.einsum("fmtk,mft->mfk", U.conj(), tm) * keep.movedim(0, 1)

    def project_svd_to_telescope(self, svdm) -> torch.Tensor:
        """SVD basis [M+1, nfreq, k] -> telescope vectors [M+1, nfreq, ntel]
        (the adjoint of :meth:`project_telescope_to_svd`)."""
        self._ensure_svd()
        U, keep = self._svd["U"], self._svd["keep"]
        svdm = as_tensor(svdm, U.device).to(U.dtype) * keep.movedim(0, 1)
        return torch.einsum("fmtk,mfk->mft", U, svdm)

    # -- persistence -----------------------------------------------------------
    def save(self, directory: str | None = None):
        """Write ``beam_p.npy``, ``beam_m.npy`` and ``telescope.pkl``, the
        layout ``draco_tpu``'s ``save`` writes."""
        directory = directory or self.directory
        os.makedirs(directory, exist_ok=True)
        self.generate()
        np.save(os.path.join(directory, "beam_p.npy"), self._bp.cpu().numpy())
        np.save(os.path.join(directory, "beam_m.npy"), self._bm.cpu().numpy())
        with open(os.path.join(directory, "telescope.pkl"), "wb") as f:
            pickle.dump(self.telescope, f)

    def load(self, directory: str, device=None) -> "BeamTransfer":
        """Read a directory written by :meth:`save` or by ``draco_tpu``'s.

        Everything derived from the previous telescope or beam tensors is
        dropped, the SVD basis included.
        """
        with open(os.path.join(directory, "telescope.pkl"), "rb") as f:
            telescope = _TelescopeUnpickler(f).load()
        bp_path = os.path.join(directory, "beam_p.npy")
        bp = bm = None
        if os.path.exists(bp_path):
            device = resolve(device)
            bp = torch.as_tensor(np.load(bp_path), device=device)
            bm = torch.as_tensor(np.load(os.path.join(directory, "beam_m.npy")), device=device)
        self.telescope = telescope
        self._bp, self._bm = bp, bm
        self._reset_caches()
        return self
