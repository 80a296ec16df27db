"""Spherical-harmonic transforms on HEALPix grids (port of ``draco_tpu.ops.sht``).

Conventions match healpy: fully normalised spherical harmonics with the
Condon-Shortley phase; real fields store only m >= 0 coefficients as a
dense ``alm[..., l, m]`` array of shape [lmax+1, mmax+1].

The transform runs from precomputed tables, built once per (device,
dtype) by :meth:`SHT.tables`:

* the Legendre tensor Lambda[l, m, ring], split into the equatorial belt
  and the width-split polar-cap row groups, from an upward l-recurrence
  with power-of-two rescaling (libsharp style).  The float32 tables are
  two-float: the recurrence runs in float64 and each value is stored as a
  float32 ``hi`` plus a bfloat16 ``lo`` residual;
* the ring-DFT factors, whose phases are reduced exactly in integers
  (every HEALPix azimuth is pi(2j+s)/n) before any floating-point trig.

Both keep the round trip inside the 1e-5 map-error contract in float32.
The float64 tables (exact trig, single float64 Legendre) are the
reference runs.  Only real maps are transformed directly; complex maps go
through :meth:`SHT.analysis_complex`.  The table builders put their
tables on ``device``, the first CUDA card when none is named
(:func:`draco_tpu_torch.device.resolve`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import as_tensor, resolve
from . import healpix
from .tools import sincos_turns

__all__ = ["SHT", "get_sht", "alm2map", "map2alm", "sphtrans_sky", "sphtrans_inv_sky"]

# Power-of-two block for the dynamic rescaling of the Legendre recurrence.
_SCALE_BITS = 60
_LN2 = float(np.log(2.0))
# width-split buckets of the polar-cap rows (see SHT._build_groups)
_CAP_WSPLIT = 16


def _seed_log_coeff(mmax: int) -> np.ndarray:
    """ln of the m-dependent part of Lambda_mm (host, float64).

    Lambda_mm(theta) = (-1)^m * sqrt((2m+1)!!/(4 pi (2m)!!)) * sin^m(theta);
    this returns C_m = 0.5*ln((2m+1)!!/(4 pi (2m)!!)).
    """
    m = np.arange(1, mmax + 1)
    terms = np.log((2 * m + 1) / (2 * m))
    return 0.5 * (np.concatenate([[0.0], np.cumsum(terms)]) - np.log(4 * np.pi))


def _recurrence_tables(lmax: int, mmax: int):
    """Upward l-recurrence coefficients a[l,m], b[l,m] (host, float64).

    Lambda_{l,m} = a_{l,m} * cos(theta) * Lambda_{l-1,m} + b_{l,m} * Lambda_{l-2,m}
    valid for l > m (with Lambda_{m-1,m} := 0).
    """
    l = np.arange(lmax + 1)[:, None].astype(np.float64)
    m = np.arange(mmax + 1)[None, :].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.sqrt((4 * l**2 - 1) / (l**2 - m**2))
        b = -np.sqrt(
            ((2 * l + 1) * (l - 1 + m) * (l - 1 - m)) / ((2 * l - 3) * (l**2 - m**2))
        )
    bad = (l.astype(int) <= m.astype(int)) | ~np.isfinite(a)
    a = np.where(bad, 0.0, a)
    b = np.where(bad | ~np.isfinite(b), 0.0, b)
    return a, b


def _legendre_block_core(x, lnsin, cm_c, a_tab, b_tab, mv, two_float=False):
    """Lambda[l, c, r] by upward recurrence over l (one step per l).

    x [R] cos(theta); lnsin [R]; cm_c [C] seed log coefficients; a_tab,
    b_tab [L+1, C]; mv [C] the m values.  The working dtype follows
    ``a_tab``.  With ``two_float`` (float64 working dtype) the result is
    the pair (hi float32, lo bfloat16), written as the recurrence runs so
    the float64 tensor is never materialised.
    """
    dtype = a_tab.dtype
    dev = a_tab.device
    lmax1 = a_tab.shape[0]
    C, R = mv.shape[0], x.shape[0]
    # seed: ln |Lambda_mm| = C_m + m ln sin(theta)
    ln_seed = cm_c[:, None] + mv[:, None].to(lnsin.dtype) * lnsin[None, :]
    sign = torch.where(mv % 2 == 0, 1.0, -1.0).to(dtype)[:, None]
    e0 = torch.floor(ln_seed / (_SCALE_BITS * _LN2)).to(torch.int32)
    p_seed = torch.exp(ln_seed - e0.to(ln_seed.dtype) * (_SCALE_BITS * _LN2)).to(dtype) * sign

    two_B = 2.0**_SCALE_BITS
    inv_two_B = 2.0**-_SCALE_BITS
    if two_float:
        hi = torch.empty(lmax1, C, R, dtype=torch.float32, device=dev)
        lo = torch.empty(lmax1, C, R, dtype=torch.bfloat16, device=dev)
    else:
        out = torch.empty(lmax1, C, R, dtype=dtype, device=dev)
    zeros = torch.zeros(C, R, dtype=dtype, device=dev)
    p_prev, p_curr = zeros, zeros
    e = torch.zeros(C, R, dtype=torch.int32, device=dev)
    for l in range(lmax1):
        is_seed = (mv == l)[:, None]
        a_l = a_tab[l][:, None]
        b_l = b_tab[l][:, None]
        p_new = torch.where(is_seed, p_seed, a_l * x[None, :] * p_curr + b_l * p_prev)
        e_new = torch.where(is_seed, e0, e)
        p_base = torch.where(is_seed, zeros, p_curr)
        # rescale when the mantissa grows past 2^B
        big = torch.abs(p_new) > two_B
        scale = torch.where(big, inv_two_B, 1.0).to(dtype)
        p_new = p_new * scale
        p_base = p_base * scale
        e_new = e_new + big.to(torch.int32)
        # the true value mantissa * 2^(e*B); exp2 underflows to zero in
        # the deep-polar regime where Lambda is below the float floor
        lam = p_new * torch.exp2(e_new.to(dtype) * _SCALE_BITS)
        lam = torch.where(l >= mv[:, None], lam, zeros)
        if two_float:
            h = lam.to(torch.float32)
            hi[l] = h
            lo[l] = (lam - h.to(lam.dtype)).to(torch.bfloat16)
        else:
            out[l] = lam
        p_prev, p_curr, e = p_base, p_new, e_new
    return (hi, lo) if two_float else out


def _complex_dtype(rdt: torch.dtype) -> torch.dtype:
    return torch.complex128 if rdt == torch.float64 else torch.complex64


class SHT:
    """Spherical harmonic transform operator for one (nside, lmax, mmax).

    Host geometry is built here; device tables come from :meth:`tables`
    (cached on the instance per device and dtype).
    """

    def __init__(self, nside: int, lmax: int | None = None, mmax: int | None = None):
        self.nside = nside
        self.lmax = int(lmax) if lmax is not None else 3 * nside - 1
        self.mmax = int(mmax) if mmax is not None else self.lmax
        if self.mmax > self.lmax:
            raise ValueError("mmax cannot exceed lmax")
        # analysis needs mmax < 4*nside (the belt's azimuthal sampling);
        # synthesis is exact point sampling at any mmax
        self._analysis_band_limited = self.mmax < 4 * nside
        self.npix = healpix.npix_of(nside)
        self.info = healpix.ring_info(nside)

        info = self.info
        self._x = np.cos(info.theta)
        self._lnsin = np.log(np.sin(info.theta))
        self._w = info.weight  # per-ring quadrature weight (4 pi / npix)
        self._cm = _seed_log_coeff(self.mmax)
        self._a_tab, self._b_tab = _recurrence_tables(self.lmax, self.mmax)
        self._m = np.arange(self.mmax + 1)
        self._build_groups()
        self._tables: dict = {}

    # ------------------------------------------------------------------
    def _build_groups(self):
        """Cap/belt decomposition (host).

        The pixel layout is [north cap | equatorial belt | south cap].  The
        belt's 2*nside+1 rings share nphi = 4*nside; the ragged cap rings
        are bucketed by width so no DFT work is spent on zero padding.
        Each bucket lists its north rows then their mirrored south rows.
        """
        info = self.info
        nside = self.nside
        ncap = nside - 1
        self._belt_rings = list(range(ncap, 3 * nside))
        self._belt_off = int(info.offset[ncap]) if ncap < info.nring else 0
        self._belt_nphi = 4 * nside
        self._belt_len = len(self._belt_rings) * self._belt_nphi
        self._cap_rings = list(range(ncap)) + list(range(info.nring - ncap, info.nring))
        self._ncap = len(self._cap_rings)
        self._cap_wgroups = []
        if not self._ncap:
            return
        width = int(max(info.nphi[r] for r in self._cap_rings))
        idx = np.zeros((self._ncap, width), dtype=np.int64)
        mask = np.zeros((self._ncap, width), dtype=np.float64)
        # integer phase tables: phi_rj = pi (2j + s) / n with s in {0, 1}
        two_ps = np.zeros((self._ncap, width), dtype=np.int64)
        n_row = np.zeros(self._ncap, dtype=np.int64)
        for k, r in enumerate(self._cap_rings):
            n = int(info.nphi[r])
            idx[k, :n] = info.offset[r] + np.arange(n)
            mask[k, :n] = 1.0
            s = int(round(info.phi0[r] * n / np.pi))
            two_ps[k, :n] = 2 * np.arange(n) + s
            n_row[k] = n
        self._cap_idx = idx
        self._cap_mask = mask
        self._cap_2ps = two_ps
        self._cap_n = n_row
        nphi_rows = info.nphi[np.asarray(self._cap_rings)]
        bounds = sorted({width * i // _CAP_WSPLIT for i in range(1, _CAP_WSPLIT + 1)} - {0})
        lo = 0
        for w in bounds:
            rows_arr = np.nonzero((nphi_rows > lo) & (nphi_rows <= w))[0]
            if len(rows_arr):
                north = rows_arr[rows_arr < ncap]
                rows_arr = np.concatenate([north, self._ncap - 1 - north])
                self._cap_wgroups.append((rows_arr, int(w)))
            lo = w
        # gather index of every cap pixel (north then south, RING order)
        # into the concatenation of the flattened group outputs
        pos = {}
        off = 0
        for rows_arr, w in self._cap_wgroups:
            for i, r in enumerate(rows_arr):
                pos[int(r)] = off + i * w
            off += len(rows_arr) * w
        cap_src = [pos[k] + np.arange(int(n_row[k])) for k in range(self._ncap)]
        ncap_n = nside - 1
        self._cap_src_north = np.concatenate(cap_src[:ncap_n]) if ncap_n else np.zeros(0, np.int64)
        self._cap_src_south = np.concatenate(cap_src[ncap_n:]) if ncap_n else np.zeros(0, np.int64)

    def _require_analysis_band_limit(self):
        if not self._analysis_band_limited:
            raise ValueError(
                f"analysis requires mmax < 4*nside = {4 * self.nside} "
                f"(got mmax={self.mmax}): the grid cannot separate "
                f"aliased azimuthal modes. Synthesis-only use is fine."
            )

    # ------------------------------------------------------------------
    # exact-turns DFT factors
    # ------------------------------------------------------------------
    @staticmethod
    def _phase_turns(num: torch.Tensor, den: torch.Tensor, rdt: torch.dtype):
        """(cos, sin) of 2 pi num/den; int64 ``num`` is reduced mod ``den`` first."""
        t = (num % den).to(rdt) / den.to(rdt)
        if rdt == torch.float64:
            ph = 2 * math.pi * t
            return torch.cos(ph), torch.sin(ph)
        return sincos_turns(t)

    def _ring_phase(self, ring_sel, rdt, device, conj: bool = False):
        """(re, im) of exp(-+i m phi0_r) for the selected rings: [rows, M+1]."""
        info = self.info
        n = info.nphi[ring_sel].astype(np.int64)
        s = np.rint(info.phi0[ring_sel] * n / np.pi).astype(np.int64)
        s_d = torch.as_tensor(s, device=device)
        m_d = torch.as_tensor(self._m, device=device)
        den = torch.as_tensor(2 * n, device=device)[:, None]
        c, sn = self._phase_turns(s_d[:, None] * m_d[None, :], den, rdt)
        return c, sn if conj else -sn

    def _belt_dft(self, rdt, device, conj: bool = False):
        """(re, im) of W[j, m] = exp(-+2 pi i j m / nphi) for the belt rings."""
        j = torch.arange(self._belt_nphi, device=device)
        m_d = torch.as_tensor(self._m, device=device)
        den = torch.tensor(self._belt_nphi, device=device)
        c, sn = self._phase_turns(j[:, None] * m_d[None, :], den, rdt)
        return c, sn if conj else -sn

    def _cap_dft(self, group, rdt, device):
        """(re, im) of P[r, j, m] = mask * exp(-i m phi_rj) for one cap row group."""
        rows_arr, w = group
        two_ps = torch.as_tensor(self._cap_2ps[rows_arr][:, :w], device=device)
        den = torch.as_tensor(2 * self._cap_n[rows_arr], device=device)[:, None, None]
        mask = torch.as_tensor(self._cap_mask[rows_arr][:, :w], dtype=rdt, device=device)[..., None]
        m_d = torch.as_tensor(self._m, device=device)
        c, sn = self._phase_turns(two_ps[:, :, None] * m_d[None, None, :], den, rdt)
        return c * mask, -sn * mask

    def belt_phase_weight(self, rdt=torch.float32, device=None):
        """(re, im) of exp(-i m phi0_r) * w_r for the belt rings: [nbelt, M+1]."""
        device = resolve(device)
        w_belt = torch.as_tensor(self._w[self._belt_rings], dtype=rdt, device=device)[:, None]
        c, s = self._ring_phase(self._belt_rings, rdt, device)
        return c * w_belt, s * w_belt

    def precompute_ring_plan(self, rdt=torch.float32, device=None):
        """Ring-DFT factors: {"W": (re, im) [nphi, M+1], "P": [(re, im) [rows, w, M+1]]}.

        The cap factors carry the quadrature weight.
        """
        device = resolve(device)
        ring_ids = np.asarray(self._cap_rings)
        P = []
        for grp in self._cap_wgroups:
            rows_arr, _ = grp
            w_rows = torch.as_tensor(self._w[ring_ids[rows_arr]], dtype=rdt, device=device)[:, None, None]
            pr, pi = self._cap_dft(grp, rdt, device)
            P.append((pr * w_rows, pi * w_rows))
        return {"W": self._belt_dft(rdt, device), "P": P}

    # ------------------------------------------------------------------
    # Legendre tables
    # ------------------------------------------------------------------
    def _section_rings(self) -> np.ndarray:
        """Ring indices in section order: belt, then each cap row group."""
        ring_ids = np.asarray(self._cap_rings, dtype=np.int64)
        parts = [np.asarray(self._belt_rings, dtype=np.int64)]
        parts += [ring_ids[rows_arr] for rows_arr, _ in self._cap_wgroups]
        return np.concatenate(parts)

    def _split_sections(self, lam):
        """Slice a [L+1, M+1, R] tensor in section order into the belt/caps dict."""
        nb = len(self._belt_rings)
        out = {"belt": lam[:, :, :nb].contiguous(), "caps": []}
        off = nb
        for rows_arr, _ in self._cap_wgroups:
            out["caps"].append(lam[:, :, off : off + len(rows_arr)].contiguous())
            off += len(rows_arr)
        return out

    def legendre(self, rings, rdt=torch.float32, device=None, two_float=False):
        """Lambda[l, m, r] over the given rings for all m <= mmax.

        ``two_float`` returns the (hi float32, lo bfloat16) pair from a
        float64 recurrence; otherwise the recurrence runs in ``rdt``.
        """
        device = resolve(device)
        wdt = torch.float64 if two_float else rdt
        sdt = torch.float64 if wdt == torch.float64 else torch.float32
        rings = np.asarray(rings)
        m_all = np.arange(self.mmax + 1)
        return _legendre_block_core(
            torch.as_tensor(self._x[rings], dtype=wdt, device=device),
            torch.as_tensor(self._lnsin[rings], dtype=sdt, device=device),
            torch.as_tensor(self._cm[m_all], dtype=sdt, device=device),
            torch.as_tensor(self._a_tab, dtype=wdt, device=device),
            torch.as_tensor(self._b_tab, dtype=wdt, device=device),
            torch.as_tensor(m_all, device=device),
            two_float=two_float,
        )

    def precompute_legendre_split(self, rdt=torch.float32, device=None):
        """Per-section Legendre tensors {"belt": [L+1, M+1, nbelt], "caps": [...]}."""
        return self._split_sections(self.legendre(self._section_rings(), rdt, device))

    def precompute_legendre_split_2f(self, device=None):
        """Two-float (hi float32, lo bfloat16) per-section Legendre tensors."""
        hi, lo = self.legendre(self._section_rings(), device=device, two_float=True)
        return self._split_sections(hi), self._split_sections(lo)

    def tables(self, device=None, rdt=torch.float32):
        """(lam, lam_lo, plan) on ``device``: two-float for float32, exact for float64."""
        key = (resolve(device), rdt)
        if key not in self._tables:
            if rdt == torch.float64:
                lam, lam_lo = self.precompute_legendre_split(rdt, key[0]), None
            else:
                lam, lam_lo = self.precompute_legendre_split_2f(key[0])
            self._tables[key] = (lam, lam_lo, self.precompute_ring_plan(rdt, key[0]))
        return self._tables[key]

    # ------------------------------------------------------------------
    # ring Fourier steps
    # ------------------------------------------------------------------
    def _ring_analysis_parts(self, maps, plan, raw_belt: bool = False):
        """Quadrature-weighted per-section ring coefficients of real maps.

        Returns (F_belt [..., nbelt, M+1], [F_group [..., rows, M+1], ...])
        as complex tensors, in the layout of :meth:`precompute_legendre_split`.
        """
        belt = maps[..., self._belt_off : self._belt_off + self._belt_len].reshape(
            *maps.shape[:-1], len(self._belt_rings), self._belt_nphi
        )
        caps = [
            maps[..., torch.as_tensor(self._cap_idx[rows_arr][:, :w], device=maps.device)]
            for rows_arr, w in self._cap_wgroups
        ]
        return self._analysis_sections(belt, caps, plan, raw_belt)

    def padded_layout(self) -> np.ndarray:
        """HEALPix pixel of each slot of the padded layout
        ``[belt | cap group 0 | cap group 1 | ...]`` (-1 = padding).

        Maps generated directly in this layout (fringe x beam) skip the
        ragged cap gather of :meth:`_ring_analysis_parts`.
        """
        idxs = [np.arange(self._belt_off, self._belt_off + self._belt_len)]
        for rows_arr, w in self._cap_wgroups:
            idx = self._cap_idx[rows_arr][:, :w].copy()
            idx[self._cap_mask[rows_arr][:, :w] <= 0] = -1
            idxs.append(idx.ravel())
        return np.concatenate(idxs).astype(np.int64)

    def analysis_padded(self, maps_pad, lam, plan, lam_lo=None):
        """alm of real maps given in the :meth:`padded_layout` order.

        Padding slots may hold anything: the cap DFT factors are masked.
        """
        F_belt, group_F = self._ring_analysis_parts_padded(maps_pad, plan)
        return self._contract_alm(F_belt, group_F, lam, lam_lo)

    def _ring_analysis_parts_padded(self, maps_pad, plan, raw_belt: bool = False, mcut: int | None = None):
        """Per-section ring coefficients of real :meth:`padded_layout` maps.

        ``raw_belt`` skips the belt phase weight (:meth:`belt_phase_weight`;
        the caller folds it in elsewhere).  ``mcut`` keeps only the
        coefficients m < mcut (the caller guarantees no higher azimuthal
        content).
        """
        lead = maps_pad.shape[:-1]
        belt = maps_pad[..., : self._belt_len].reshape(*lead, len(self._belt_rings), self._belt_nphi)
        caps = []
        off = self._belt_len
        for rows_arr, w in self._cap_wgroups:
            size = len(rows_arr) * w
            caps.append(maps_pad[..., off : off + size].reshape(*lead, len(rows_arr), w))
            off += size
        return self._analysis_sections(belt, caps, plan, raw_belt, mcut)

    def _analysis_sections(self, belt, caps, plan, raw_belt=False, mcut=None):
        """Ring DFTs of the belt [..., nbelt, nphi] and the cap groups
        [..., rows, w]: dense GEMMs against the plan's factors."""
        self._require_analysis_band_limit()
        ms = slice(None, mcut)
        Wr, Wi = (w[:, ms] for w in plan["W"])
        Fr = belt @ Wr
        Fi = belt @ Wi
        if raw_belt:
            F_belt = torch.complex(Fr, Fi)
        else:
            pr, pi = (p[:, ms] for p in self.belt_phase_weight(belt.dtype, belt.device))
            F_belt = torch.complex(Fr * pr - Fi * pi, Fr * pi + Fi * pr)
        group_F = []
        for cap, (Pr, Pi) in zip(caps, plan["P"]):
            group_F.append(
                torch.complex(
                    torch.einsum("...rj,rjm->...rm", cap, Pr[..., ms]),
                    torch.einsum("...rj,rjm->...rm", cap, Pi[..., ms]),
                )
            )
        return F_belt, group_F

    def _contract_alm(self, F_belt, group_F, lam, lam_lo=None):
        """Sum of the per-section Legendre contractions -> alm [..., L+1, M+1].

        ``lam_lo`` (bfloat16) is upcast and contracted in full float32.
        """
        rdt = F_belt.real.dtype

        def contract(F, lam_s):
            lam_r = lam_s.to(rdt)
            return torch.complex(
                torch.einsum("...rm,lmr->...lm", F.real, lam_r),
                torch.einsum("...rm,lmr->...lm", F.imag, lam_r),
            )

        alm = contract(F_belt, lam["belt"])
        for F_g, lam_g in zip(group_F, lam["caps"]):
            alm = alm + contract(F_g, lam_g)
        if lam_lo is not None:
            alm = alm + contract(F_belt, lam_lo["belt"])
            for F_g, lam_g in zip(group_F, lam_lo["caps"]):
                alm = alm + contract(F_g, lam_g)
        return alm

    def _ring_synthesis_parts(self, G_belt, G_caps, plan):
        """Real maps [..., npix] from per-section ring coefficients.

        f(r, j) = Re sum_m c_m G_m(r) e^{i m phi_rj} with c_0 = 1, c_m>0 = 2
        (real-field Hermitian doubling), as dense inverse DFTs.  The plan's
        cap factors carry the analysis quadrature weight, divided back out
        through the per-row coefficient.
        """
        rdt = G_belt.real.dtype
        dev = G_belt.device
        cm = torch.full((self.mmax + 1,), 2.0, dtype=rdt, device=dev)
        cm[0] = 1.0
        pr, pi = self._ring_phase(self._belt_rings, rdt, dev, conj=True)
        g_belt = G_belt * torch.complex(pr, pi)
        gd = g_belt * cm
        Wcr, Wci = self._belt_dft(rdt, dev, conj=True)
        f_belt = gd.real @ Wcr.T - gd.imag @ Wci.T
        f_belt = f_belt.reshape(*f_belt.shape[:-2], self._belt_len)
        if not self._ncap:
            return f_belt

        ring_ids = np.asarray(self._cap_rings)
        f_groups = []
        for (rows_arr, _), g_cap, (Pr, Pi) in zip(self._cap_wgroups, G_caps, plan["P"]):
            inv_w = torch.as_tensor(1.0 / self._w[ring_ids[rows_arr]], dtype=rdt, device=dev)
            gc = g_cap * (cm[None, :] * inv_w[:, None])
            # Re(gc * conj(P)) = Re(gc) Re(P) + Im(gc) Im(P)
            f = torch.einsum("...rm,rjm->...rj", gc.real, Pr) + torch.einsum(
                "...rm,rjm->...rj", gc.imag, Pi
            )
            f_groups.append(f.reshape(*f.shape[:-2], -1))
        flat = torch.cat(f_groups, dim=-1)
        north = flat[..., torch.as_tensor(self._cap_src_north, device=dev)]
        south = flat[..., torch.as_tensor(self._cap_src_south, device=dev)]
        return torch.cat([north, f_belt, south], dim=-1)

    # ------------------------------------------------------------------
    # transforms
    # ------------------------------------------------------------------
    def _analysis_impl(self, maps, lam, plan, lam_lo=None):
        """alm[..., lmax+1, mmax+1] (complex) of real maps [..., npix]."""
        F_belt, group_F = self._ring_analysis_parts(maps, plan)
        return self._contract_alm(F_belt, group_F, lam, lam_lo)

    @staticmethod
    def _legendre_sections(alm, lam, lam_lo=None):
        """Per-section ring coefficients sum_l Lambda[l, m, r] alm[..., l, m]:
        (G_belt [..., nbelt, M+1], [G_group [..., rows, M+1], ...])."""
        rdt = alm.real.dtype

        def contract(lam_s):
            lam_r = lam_s.to(rdt)
            return torch.complex(
                torch.einsum("...lm,lmr->...rm", alm.real, lam_r),
                torch.einsum("...lm,lmr->...rm", alm.imag, lam_r),
            )

        G_belt = contract(lam["belt"])
        G_caps = [contract(c) for c in lam["caps"]]
        if lam_lo is not None:
            G_belt = G_belt + contract(lam_lo["belt"])
            G_caps = [g + contract(c) for g, c in zip(G_caps, lam_lo["caps"])]
        return G_belt, G_caps

    def _synthesis_impl(self, alm, lam, plan, lam_lo=None):
        """Real maps [..., npix] from alm[..., lmax+1, mmax+1]."""
        G_belt, G_caps = self._legendre_sections(alm, lam, lam_lo)
        return self._ring_synthesis_parts(G_belt, G_caps, plan)

    def analysis(self, maps: torch.Tensor, iter: int = 0) -> torch.Tensor:
        """map2alm of real maps with optional Jacobi iterations (healpy-style)."""
        lam, lam_lo, plan = self.tables(maps.device, maps.dtype)
        alm = self._analysis_impl(maps, lam, plan, lam_lo)
        for _ in range(iter):
            resid = maps - self._synthesis_impl(alm, lam, plan, lam_lo)
            alm = alm + self._analysis_impl(resid, lam, plan, lam_lo)
        return alm

    def synthesis(self, alm: torch.Tensor) -> torch.Tensor:
        """alm2map for a real field (m >= 0 coefficients)."""
        lam, lam_lo, plan = self.tables(alm.device, alm.real.dtype)
        return self._synthesis_impl(alm, lam, plan, lam_lo)

    def analysis_complex(self, maps: torch.Tensor):
        """Full SHT of complex maps: (alm_pos, alm_neg).

        alm_pos[..., l, m] = f_{l m} for m >= 0 and alm_neg[..., l, m] =
        f_{l, -m} = (-1)^m conj((f*)_{l m}).  Both come from one stacked
        real transform of [Re, Im]: alm(f) = A(re) + i A(im) and
        alm(conj f) = A(re) - i A(im).
        """
        if maps.is_complex():
            ri = self.analysis(torch.stack([maps.real, maps.imag]))
            a_re, a_im = ri[0], ri[1]
        else:
            a_re = self.analysis(maps)
            a_im = torch.zeros_like(a_re)
        alm_pos = a_re + 1j * a_im
        alm_conj = a_re - 1j * a_im
        msign = torch.as_tensor((-1.0) ** self._m, dtype=alm_pos.real.dtype, device=maps.device)
        return alm_pos, msign * alm_conj.conj()


_sht_cache: dict = {}


def get_sht(nside: int, lmax: int | None = None, mmax: int | None = None) -> SHT:
    """Shared :class:`SHT` per (nside, lmax, mmax); its tables are cached on it."""
    if lmax is None:
        lmax = 3 * nside - 1
    if mmax is None:
        mmax = lmax
    key = (nside, lmax, mmax)
    if key not in _sht_cache:
        _sht_cache[key] = SHT(nside, lmax, mmax)
    return _sht_cache[key]


def map2alm(maps: torch.Tensor, lmax: int | None = None, iter: int = 3) -> torch.Tensor:
    """healpy-compatible scalar map2alm (dense [l, m] output)."""
    nside = healpix.nside_of(maps.shape[-1])
    return get_sht(nside, lmax).analysis(maps, iter=iter)


def alm2map(alm: torch.Tensor, nside: int) -> torch.Tensor:
    """healpy-compatible scalar alm2map from dense [l, m] coefficients."""
    return get_sht(nside, alm.shape[-2] - 1, alm.shape[-1] - 1).synthesis(alm)


def sphtrans_sky(sky_map, lmax: int | None = None, device=None) -> torch.Tensor:
    """SHT of every (freq, pol) map: [freq, pol, npix] -> [freq, pol, l, m].

    A host array goes to ``device`` (:func:`draco_tpu_torch.device.resolve`).
    """
    sky_map = as_tensor(sky_map, device)
    return get_sht(healpix.nside_of(sky_map.shape[-1]), lmax).analysis(sky_map)


def sphtrans_inv_sky(alm, nside: int, device=None) -> torch.Tensor:
    """Inverse of :func:`sphtrans_sky`: [freq, pol, l, m] -> [freq, pol, npix]."""
    alm = as_tensor(alm, device)
    return get_sht(nside, alm.shape[-2] - 1, alm.shape[-1] - 1).synthesis(alm)
