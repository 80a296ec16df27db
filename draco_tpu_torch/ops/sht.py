"""Spherical-harmonic transforms on HEALPix grids (port of ``draco_tpu.ops.sht``).

Conventions match healpy: fully normalised spherical harmonics with the
Condon-Shortley phase; real fields store only m >= 0 coefficients as a
dense ``alm[..., l, m]`` array of shape [lmax+1, mmax+1].

The Legendre tensor Lambda[l, m, ring] comes from an upward l-recurrence
with power-of-two rescaling (libsharp style): on the card one launch of
the hand-written kernel ``csrc/legendre.cu``
(:func:`draco_tpu_torch.ops.cuda_kernels.legendre_block`), on the CPU its
plain version :func:`_legendre_block_core`.  The float32 tensors are
two-float: the recurrence runs in float64 and each value is kept as a
float32 ``hi`` plus a bfloat16 ``lo`` residual.  The ring-DFT factors
reduce their phases exactly in integers (every HEALPix azimuth is
pi(2j+s)/n) before any floating-point trig.  Both keep the round trip
inside the 1e-5 map-error contract in float32; float64 (exact trig,
single float64 Legendre) is the reference.

:meth:`SHT.analysis` and :meth:`SHT.synthesis` take one of two routes:

* ``"tables"``: the whole Legendre tensor, split into the equatorial belt
  and the width-split polar-cap row groups, and the ring-DFT plan, built
  once per (device, dtype) by :meth:`SHT.tables` and cached on the
  instance;
* ``"chunked"``: nothing cached; the Legendre rows of ``chunk_m`` m at a
  time (and the cap DFT factors of those m) are made on the fly and
  contracted at once, as the JAX package's public transforms always do.

The tables are taken when their bytes (:meth:`SHT.table_bytes`) fit
:data:`TABLE_BUDGET_BYTES`: every transform up to nside 256 at full lmax,
where they are at most a few GB; at nside 512 and full lmax they are
~42 GB, and at nside 1024 hundreds.  The round trips and the beam-transfer
generator call :meth:`SHT.tables` themselves.  Complex maps are analysed
directly (as the sum of their real and imaginary parts' transforms);
:meth:`SHT.analysis_complex` gives both the m >= 0 and the m < 0
coefficients.  Table builders put their tables on ``device``, the first
CUDA card when none is named (:func:`draco_tpu_torch.device.resolve`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import as_tensor, resolve
from . import cuda_kernels, healpix
from .tools import sincos_turns

__all__ = [
    "SHT", "TABLE_BUDGET_BYTES", "get_sht", "alm2map", "map2alm", "sphtrans_sky", "sphtrans_inv_sky",
]

# Power-of-two block for the dynamic rescaling of the Legendre recurrence.
_SCALE_BITS = 60
_LN2 = float(np.log(2.0))
# width-split buckets of the polar-cap rows (see SHT._build_groups)
_CAP_WSPLIT = 16
# Most bytes of cached tables (Legendre tensor and ring plan, see
# SHT.table_bytes) that SHT.analysis/synthesis build and keep on a device:
# nside 256 at lmax = mmax = 767 needs 5.3 GB in float32 and 8.2 GB in
# float64; nside 512 at lmax 1535 needs 43 GB in float32 and goes chunk by
# chunk, as does nside 1024 (341 GB at lmax 3071, 113 GB at lmax 1535).
TABLE_BUDGET_BYTES = 16 * 2**30


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


def _legendre_block_core(x, lnsin, cm_c, a_tab, b_tab, mv, two_float=False, l0=0):
    """Lambda[l - l0, c, r] for l = l0..L by upward recurrence over l (one
    step per l): the plain version of ``csrc/legendre.cu``.

    x [R] cos(theta); lnsin [R]; cm_c [C] seed log coefficients; a_tab,
    b_tab [L+1, C]; mv [C] the m values, none below ``l0`` (the rows l < l0
    are then all zeros and are left out).  The working dtype follows
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
    nl = lmax1 - l0
    if two_float:
        hi = torch.empty(nl, C, R, dtype=torch.float32, device=dev)
        lo = torch.empty(nl, C, R, dtype=torch.bfloat16, device=dev)
    else:
        out = torch.empty(nl, C, R, dtype=dtype, device=dev)
    zeros = torch.zeros(C, R, dtype=dtype, device=dev)
    p_prev, p_curr = zeros, zeros
    e = torch.zeros(C, R, dtype=torch.int32, device=dev)
    for l in range(l0, lmax1):
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
            hi[l - l0] = h
            lo[l - l0] = (lam - h.to(lam.dtype)).to(torch.bfloat16)
        else:
            out[l - l0] = lam
        p_prev, p_curr, e = p_base, p_new, e_new
    return (hi, lo) if two_float else out


def _each_channel(fn, x: torch.Tensor, split: bool) -> torch.Tensor:
    """``fn(x)``, or with ``split`` ``fn`` of each channel (leading index) of
    ``x`` alone, concatenated.

    A GEMM folds its batch into its rows, and its kernel (and so a row's
    bits) depends on how many rows there are.  Contracted alone, a channel
    has the same bits whichever channels share the call: a rank's frequency
    slab under a mesh, or the whole band.  Only the contractions go channel
    by channel; the factors they contract against (the Legendre rows of a
    chunk, the ring DFTs) are made once for all channels.
    """
    if not split:
        return fn(x)
    return torch.cat([fn(x[i : i + 1]) for i in range(x.shape[0])])


def _stack_parts(z: torch.Tensor) -> torch.Tensor:
    """[2, ...]: the real and imaginary parts of ``z`` as one batch, so that a
    channel's contraction reads the Legendre rows once for both."""
    return torch.stack([z.real, z.imag])


def _complex_of(parts: torch.Tensor) -> torch.Tensor:
    return torch.complex(parts[0], parts[1])


def _complex_dtype(rdt: torch.dtype) -> torch.dtype:
    return torch.complex128 if rdt == torch.float64 else torch.complex64


class SHT:
    """Spherical harmonic transform operator for one (nside, lmax, mmax).

    Host geometry is built here; device tables come from :meth:`tables`
    (cached on the instance per device and dtype).  ``chunk_m`` is the
    number of m values whose Legendre rows the chunked route makes and
    contracts at a time.  ``last_route`` names the route the last
    :meth:`analysis` or :meth:`synthesis` took (``"tables"`` or
    ``"chunked"``; None before the first).
    """

    def __init__(self, nside: int, lmax: int | None = None, mmax: int | None = None, chunk_m: int = 64):
        self.nside = nside
        self.lmax = int(lmax) if lmax is not None else 3 * nside - 1
        self.mmax = int(mmax) if mmax is not None else self.lmax
        if self.mmax > self.lmax:
            raise ValueError("mmax cannot exceed lmax")
        if chunk_m < 1:
            raise ValueError(f"chunk_m must be at least 1, got {chunk_m}")
        self.chunk_m = int(min(chunk_m, self.mmax + 1))
        self.last_route = None
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

    def _cap_dft_chunks(self, group, rdt, device, row_scale=None):
        """(m0, m1, Pr, Pi) for each chunk of m of one cap row group: the
        factors P[r, j, m] = mask * row_scale[r] * exp(-i m phi_rj), m0 <= m < m1.

        Every phase of row r is a multiple of 2 pi / (2 n_r), so its 2 n_r
        values are tabulated once (by :meth:`_phase_turns`, as :meth:`_cap_dft`
        makes them, times row_scale[r]) and a chunk gathers them by the exact
        integer phase; padding gathers a zero.  The same bits as the whole
        plan, without the trig of every (r, j, m).
        """
        rows_arr, w = group
        nrow = len(rows_arr)
        two_ps_h = self._cap_2ps[rows_arr][:, :w]
        # the phase numerators fit int32 (as in the JAX package) unless nside is huge
        idt = torch.int32 if int(two_ps_h.max(initial=0)) * max(self.mmax, 1) < 2**31 else torch.int64
        two_ps = torch.as_tensor(two_ps_h, dtype=idt, device=device)[..., None]
        den = torch.as_tensor(2 * self._cap_n[rows_arr], dtype=idt, device=device)[:, None]
        q = torch.arange(2 * w, dtype=idt, device=device).expand(nrow, -1)
        tc, ts = self._phase_turns(q, den, rdt)  # [rows, 2w]: row r's values at q < 2 n_r
        if row_scale is not None:
            tc, ts = tc * row_scale[:, None], ts * row_scale[:, None]
        zero = torch.zeros(1, dtype=rdt, device=device)
        tc, ts = torch.cat([tc.reshape(-1), zero]), torch.cat([-ts.reshape(-1), zero])
        mask = torch.as_tensor(self._cap_mask[rows_arr][:, :w] > 0, device=device)
        # where each pixel's row starts in the flat tables; padding reads the zero at the end
        base = torch.where(mask, torch.arange(nrow, dtype=idt, device=device)[:, None] * (2 * w), nrow * 2 * w)[..., None]
        for m_vals in self._m_chunks():
            idx = (two_ps * torch.as_tensor(m_vals, dtype=idt, device=device)) % den[..., None] + base
            yield int(m_vals[0]), int(m_vals[-1]) + 1, tc[idx], ts[idx]

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
        views = self._section_views(lam)
        return {"belt": views["belt"].contiguous(), "caps": [c.contiguous() for c in views["caps"]]}

    def _legendre_run(self, rings, m_vals, rdt, device, two_float, l0=0):
        """Lambda[l - l0, c, r] over ``rings`` for the m of ``m_vals``: one
        call of :func:`~draco_tpu_torch.ops.cuda_kernels.legendre_block`
        (the kernel on the card, the plain loop on the CPU)."""
        mode = "2f" if two_float else ("f64" if rdt == torch.float64 else "f32")
        wdt = cuda_kernels.LEGENDRE_MODES[mode]
        rings = np.asarray(rings)
        m_vals = np.asarray(m_vals)
        if l0 > int(m_vals.min(initial=l0)):
            raise ValueError(f"l0 = {l0} lies above the smallest m of the block")

        def t(a):
            return torch.as_tensor(a, dtype=wdt, device=device)

        return cuda_kernels.legendre_block(
            t(self._x[rings]), t(self._lnsin[rings]), t(self._cm[m_vals]), t(self._a_tab[:, m_vals]),
            t(self._b_tab[:, m_vals]), torch.as_tensor(m_vals, device=device), mode, l0=l0,
        )

    def legendre(self, rings, rdt=torch.float32, device=None, two_float=False):
        """Lambda[l, m, r] over the given rings for all m <= mmax, in one
        kernel launch on the card; contiguous.

        ``two_float`` returns the (hi float32, lo bfloat16) pair from a
        float64 recurrence; otherwise the recurrence runs in ``rdt``.
        """
        lam = self._legendre_run(rings, self._m, rdt, resolve(device), two_float)
        return tuple(t.contiguous() for t in lam) if two_float else lam.contiguous()

    def _m_chunks(self):
        for m0 in range(0, self.mmax + 1, self.chunk_m):
            yield np.arange(m0, min(m0 + self.chunk_m, self.mmax + 1))

    def _legendre_block(self, m_vals, rdt=torch.float32, device=None, two_float=False, l0=0):
        """Lambda[l - l0, c, r] for the m of this chunk over every ring in
        ring order (l0 at most the chunk's smallest m: the rows l < m are
        zeros)."""
        return self._legendre_run(np.arange(self.info.nring), m_vals, rdt, resolve(device), two_float, l0)

    def precompute_legendre(self, rdt=torch.float32, device=None):
        """The whole Legendre tensor Lambda[L+1, M+1, R] in ring order, for
        ``lam=`` of :meth:`_analysis_impl`/:meth:`_synthesis_impl`; the
        recurrence runs in ``rdt``."""
        return self.legendre(np.arange(self.info.nring), rdt, device)

    def table_bytes(self, rdt=torch.float32) -> int:
        """Device bytes of :meth:`tables` for ``rdt``: the Legendre tensor
        (two-float, 6 bytes a value, for float32; 8 for float64) and the
        ring plan (complex factors of every belt column and cap pixel)."""
        esize = 4 if rdt == torch.float32 else 8
        nlam = (self.lmax + 1) * (self.mmax + 1) * self.info.nring
        npix_plan = self._belt_nphi + sum(len(rows_arr) * w for rows_arr, w in self._cap_wgroups)
        return nlam * (esize + 2 if rdt == torch.float32 else esize) + npix_plan * (self.mmax + 1) * 2 * esize

    def route(self, rdt=torch.float32) -> str:
        """``"tables"`` when :meth:`table_bytes` fit :data:`TABLE_BUDGET_BYTES`,
        else ``"chunked"``.  It depends on the sizes alone, never on what is
        cached: two routes round differently, and a transform must give the
        same bits whatever ran before it."""
        return "tables" if self.table_bytes(rdt) <= TABLE_BUDGET_BYTES else "chunked"

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
    def _ring_analysis_parts(self, maps, plan, raw_belt: bool = False, split: bool = False):
        """Quadrature-weighted per-section ring coefficients of real maps.

        Returns (F_belt [..., nbelt, M+1], [F_group [..., rows, M+1], ...])
        as complex tensors, in the layout of :meth:`precompute_legendre_split`.
        ``split``: the DFTs channel by channel (:func:`_each_channel`).
        """
        belt = maps[..., self._belt_off : self._belt_off + self._belt_len].reshape(
            *maps.shape[:-1], len(self._belt_rings), self._belt_nphi
        )
        caps = [
            maps[..., torch.as_tensor(self._cap_idx[rows_arr][:, :w], device=maps.device)]
            for rows_arr, w in self._cap_wgroups
        ]
        return self._analysis_sections(belt, caps, plan, raw_belt, split=split)

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

    def _analysis_sections(self, belt, caps, plan, raw_belt=False, mcut=None, split=False):
        """Ring DFTs of the belt [..., nbelt, nphi] and the cap groups
        [..., rows, w]: dense GEMMs against the plan's factors, or, with
        ``plan`` None, against factors made on the fly (the cap factors
        ``chunk_m`` m at a time); with ``split`` channel by channel."""
        self._require_analysis_band_limit()
        rdt, dev = belt.dtype, belt.device
        ms = slice(None, mcut)
        Wr, Wi = (w[:, ms] for w in (plan["W"] if plan is not None else self._belt_dft(rdt, dev)))
        Fr = _each_channel(lambda b: b @ Wr, belt, split)
        Fi = _each_channel(lambda b: b @ Wi, belt, split)
        if raw_belt:
            F_belt = torch.complex(Fr, Fi)
        else:
            pr, pi = (p[:, ms] for p in self.belt_phase_weight(rdt, dev))
            F_belt = torch.complex(Fr * pr - Fi * pi, Fr * pi + Fi * pr)

        def dft(cap, Pr, Pi):
            def one(c):
                return torch.complex(torch.einsum("...rj,rjm->...rm", c, Pr), torch.einsum("...rj,rjm->...rm", c, Pi))

            return _each_channel(one, cap, split)

        group_F = []
        ring_ids = np.asarray(self._cap_rings)
        for gi, (cap, grp) in enumerate(zip(caps, self._cap_wgroups)):
            if plan is not None:
                Pr, Pi = plan["P"][gi]
                group_F.append(dft(cap, Pr[..., ms], Pi[..., ms]))
                continue
            w_rows = torch.as_tensor(self._w[ring_ids[grp[0]]], dtype=rdt, device=dev)
            parts = [dft(cap, Pr, Pi) for _, _, Pr, Pi in self._cap_dft_chunks(grp, rdt, dev, w_rows)]
            group_F.append(torch.cat(parts, dim=-1)[..., ms])
        return F_belt, group_F

    def _contract_alm(self, F_belt, group_F, lam, lam_lo=None, split=False):
        """Sum of the per-section Legendre contractions -> alm [..., L+1, M+1].

        ``lam_lo`` (bfloat16) is upcast and contracted in full float32;
        ``split``: channel by channel.
        """
        rdt = F_belt.real.dtype

        def contract(F, lam_s):
            lam_r = lam_s.to(rdt)
            if split:
                return _each_channel(lambda f: _complex_of(torch.einsum("...rm,lmr->...lm", _stack_parts(f), lam_r)),
                                     F, True)
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

    def _ring_synthesis_parts(self, G_belt, G_caps, plan=None, split=False):
        """Real maps [..., npix] from per-section ring coefficients.

        f(r, j) = Re sum_m c_m G_m(r) e^{i m phi_rj} with c_0 = 1, c_m>0 = 2
        (real-field Hermitian doubling), as dense inverse DFTs, exact at any
        mmax (also mmax >= 4 nside, where the belt's azimuths alias).  The
        plan's cap factors carry the analysis quadrature weight, divided back
        out through the per-row coefficient; with ``plan`` None the cap
        factors are made ``chunk_m`` m at a time and summed.  ``split``: the
        inverse DFTs channel by channel.
        """
        rdt = G_belt.real.dtype
        dev = G_belt.device
        cm = torch.full((self.mmax + 1,), 2.0, dtype=rdt, device=dev)
        cm[0] = 1.0
        pr, pi = self._ring_phase(self._belt_rings, rdt, dev, conj=True)
        g_belt = G_belt * torch.complex(pr, pi)
        gd = g_belt * cm
        Wcr, Wci = self._belt_dft(rdt, dev, conj=True)
        f_belt = _each_channel(lambda g: g.real @ Wcr.T - g.imag @ Wci.T, gd, split)
        f_belt = f_belt.reshape(*f_belt.shape[:-2], self._belt_len)
        if not self._ncap:
            return f_belt

        def idft(gc, Pr, Pi):
            # Re(gc * conj(P)) = Re(gc) Re(P) + Im(gc) Im(P)
            return _each_channel(
                lambda g: torch.einsum("...rm,rjm->...rj", g.real, Pr) + torch.einsum("...rm,rjm->...rj", g.imag, Pi),
                gc, split)

        ring_ids = np.asarray(self._cap_rings)
        f_groups = []
        for gi, (grp, g_cap) in enumerate(zip(self._cap_wgroups, G_caps)):
            if plan is not None:
                inv_w = torch.as_tensor(1.0 / self._w[ring_ids[grp[0]]], dtype=rdt, device=dev)
                f = idft(g_cap * (cm[None, :] * inv_w[:, None]), *plan["P"][gi])
            else:
                gc = g_cap * cm
                f = sum(idft(gc[..., m0:m1], Pr, Pi) for m0, m1, Pr, Pi in self._cap_dft_chunks(grp, rdt, dev))
            f_groups.append(f.reshape(*f.shape[:-2], -1))
        flat = torch.cat(f_groups, dim=-1)
        north = flat[..., torch.as_tensor(self._cap_src_north, device=dev)]
        south = flat[..., torch.as_tensor(self._cap_src_south, device=dev)]
        return torch.cat([north, f_belt, south], dim=-1)

    # ------------------------------------------------------------------
    # transforms
    # ------------------------------------------------------------------
    def _chunk_legendre(self, m_vals, rdt, device):
        """(Lambda, Lambda_lo) [L+1-m0, C, R] of one chunk of m over the rings
        in section order (:meth:`_section_rings`), from row m0 = its smallest
        m: two-float for float32, float64 with lo None."""
        rings = self._section_rings()
        m0 = int(m_vals[0])
        if rdt == torch.float64:
            return self._legendre_run(rings, m_vals, rdt, device, False, m0), None
        return self._legendre_run(rings, m_vals, rdt, device, True, m0)

    def _section_slices(self):
        """(start, stop) of each section (belt, then the cap groups) in
        :meth:`_section_rings` order."""
        bounds = np.cumsum([0, len(self._belt_rings)] + [len(rows_arr) for rows_arr, _ in self._cap_wgroups])
        return list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))

    def _dense_sections(self, lam):
        """A whole Legendre tensor [L+1, M+1, R] in ring order, or None, as the
        per-section dict of :meth:`precompute_legendre_split`."""
        if lam is None or isinstance(lam, dict):
            return lam
        return self._section_views(lam[:, :, torch.as_tensor(self._section_rings(), device=lam.device)])

    def _section_views(self, lam):
        """Views of a [.., .., R] tensor in :meth:`_section_rings` order as the
        per-section dict of :meth:`precompute_legendre_split` (None stays None)."""
        if lam is None:
            return None
        secs = [lam[:, :, r0:r1] for r0, r1 in self._section_slices()]
        return {"belt": secs[0], "caps": secs[1:]}

    def _contract_alm_chunked(self, F_belt, group_F, split=False):
        """:meth:`_contract_alm` with the Legendre rows made ``chunk_m`` m at a
        time: each chunk contracted as the tables are, section by section
        (with ``split``, channel by channel against the chunk made once)."""
        alm = torch.zeros(*F_belt.shape[:-2], self.lmax + 1, self.mmax + 1, dtype=F_belt.dtype, device=F_belt.device)
        for m_vals in self._m_chunks():
            m0, m1 = int(m_vals[0]), int(m_vals[-1]) + 1
            lam_c, lo_c = (self._section_views(p) for p in self._chunk_legendre(m_vals, F_belt.real.dtype, F_belt.device))
            alm[..., m0:, m0:m1] = self._contract_alm(F_belt[..., m0:m1], [F[..., m0:m1] for F in group_F], lam_c, lo_c,
                                                      split)
            del lam_c, lo_c
        return alm

    def _legendre_sections_chunked(self, alm, split=False):
        """:meth:`_legendre_sections` with the Legendre rows made ``chunk_m`` m
        at a time (with ``split``, channel by channel against each chunk)."""
        lead = alm.shape[:-2]
        G = [
            torch.zeros(*lead, r1 - r0, self.mmax + 1, dtype=alm.dtype, device=alm.device)
            for r0, r1 in self._section_slices()
        ]
        for m_vals in self._m_chunks():
            m0, m1 = int(m_vals[0]), int(m_vals[-1]) + 1
            lam_c, lo_c = (self._section_views(p) for p in self._chunk_legendre(m_vals, alm.real.dtype, alm.device))
            G_belt, G_caps = self._legendre_sections(alm[..., m0:, m0:m1], lam_c, lo_c, split)
            for G_s, g in zip(G, [G_belt, *G_caps]):
                G_s[..., m0:m1] = g
            del lam_c, lo_c
        return G[0], G[1:]

    def _analysis_impl(self, maps, lam=None, plan=None, lam_lo=None, split=False):
        """alm[..., lmax+1, mmax+1] (complex) of real or complex maps [..., npix].

        ``lam``: the split tables of :meth:`tables` (with their ``plan`` and,
        for float32, ``lam_lo``); a whole Legendre tensor [L+1, M+1, R] of
        :meth:`precompute_legendre` (optionally with a whole ``lam_lo``); or
        None, for the chunked route: the Legendre rows of ``chunk_m`` m at a
        time, from row min(m) of the chunk (the rows above are zeros),
        contracted against the ring coefficients as they are made.  Without
        a ``plan`` the ring-DFT factors are made on the fly, the cap ones a
        chunk of m at a time.  A complex map's alm are those of its real
        part plus i those of its imaginary part.  ``split``: every
        contraction channel by channel (:func:`_each_channel`).
        """
        if maps.is_complex():
            dim = int(split)  # the real and imaginary parts inside each channel
            ri = self._analysis_impl(torch.stack([maps.real, maps.imag], dim), lam, plan, lam_lo, split)
            return ri.select(dim, 0) + 1j * ri.select(dim, 1)
        F_belt, group_F = self._ring_analysis_parts(maps, plan, split=split)
        if lam is None:
            return self._contract_alm_chunked(F_belt, group_F, split)
        return self._contract_alm(F_belt, group_F, self._dense_sections(lam), self._dense_sections(lam_lo), split)

    @staticmethod
    def _legendre_sections(alm, lam, lam_lo=None, split=False):
        """Per-section ring coefficients sum_l Lambda[l, m, r] alm[..., l, m]:
        (G_belt [..., nbelt, M+1], [G_group [..., rows, M+1], ...]); with
        ``split`` channel by channel."""
        rdt = alm.real.dtype

        def contract(lam_s):
            lam_r = lam_s.to(rdt)
            if split:
                return _each_channel(lambda a: _complex_of(torch.einsum("...lm,lmr->...rm", _stack_parts(a), lam_r)),
                                     alm, True)
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

    def _synthesis_impl(self, alm, lam=None, plan=None, lam_lo=None, split=False):
        """Real maps [..., npix] from alm[..., lmax+1, mmax+1].

        ``lam``, ``plan`` and ``split`` as for :meth:`_analysis_impl`: the
        split tables, a whole Legendre tensor, or None for the chunked route.
        """
        if lam is None:
            G_belt, G_caps = self._legendre_sections_chunked(alm, split)
        else:
            G_belt, G_caps = self._legendre_sections(alm, self._dense_sections(lam), self._dense_sections(lam_lo),
                                                     split)
        return self._ring_synthesis_parts(G_belt, G_caps, plan, split)

    def _route_tables(self, device, rdt):
        """(lam, lam_lo, plan) of the route :meth:`route` picks: the cached
        tables, or Nones for the chunked route; records it in ``last_route``."""
        self.last_route = self.route(rdt)
        if self.last_route == "tables":
            return self.tables(device, rdt)
        return None, None, None

    def analysis(self, maps: torch.Tensor, iter: int = 0, per_channel: bool = False) -> torch.Tensor:
        """map2alm of real or complex maps with optional Jacobi iterations
        (healpy-style).

        Complex maps iterate on their real and imaginary parts, stacked into
        one batch (the real-field synthesis of the residual assumes a
        Hermitian spectrum); with ``iter=0`` they are analysed directly.
        ``per_channel``: each channel (leading index) gets the bits it gets
        alone (:func:`_each_channel`); the Legendre rows are made once.
        """
        if iter > 0 and maps.is_complex():
            dim = int(per_channel)
            ri = self.analysis(torch.stack([maps.real, maps.imag], dim), iter=iter, per_channel=per_channel)
            return ri.select(dim, 0) + 1j * ri.select(dim, 1)
        lam, lam_lo, plan = self._route_tables(maps.device, maps.real.dtype)
        alm = self._analysis_impl(maps, lam, plan, lam_lo, per_channel)
        for _ in range(iter):
            resid = maps - self._synthesis_impl(alm, lam, plan, lam_lo, per_channel)
            alm = alm + self._analysis_impl(resid, lam, plan, lam_lo, per_channel)
        return alm

    def synthesis(self, alm: torch.Tensor, per_channel: bool = False) -> torch.Tensor:
        """alm2map for a real field (m >= 0 coefficients); ``per_channel`` as
        for :meth:`analysis`."""
        lam, lam_lo, plan = self._route_tables(alm.device, alm.real.dtype)
        return self._synthesis_impl(alm, lam, plan, lam_lo, per_channel)

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


def sphtrans_sky(sky_map, lmax: int | None = None, device=None, per_channel: bool = False) -> torch.Tensor:
    """SHT of every (freq, pol) map: [freq, pol, npix] -> [freq, pol, l, m].

    A host array goes to ``device`` (:func:`draco_tpu_torch.device.resolve`);
    ``per_channel`` gives each frequency the bits it gets alone
    (:meth:`SHT.analysis`).
    """
    sky_map = as_tensor(sky_map, device)
    return get_sht(healpix.nside_of(sky_map.shape[-1]), lmax).analysis(sky_map, per_channel=per_channel)


def sphtrans_inv_sky(alm, nside: int, device=None, per_channel: bool = False) -> torch.Tensor:
    """Inverse of :func:`sphtrans_sky`: [freq, pol, l, m] -> [freq, pol, npix]."""
    alm = as_tensor(alm, device)
    return get_sht(nside, alm.shape[-2] - 1, alm.shape[-1] - 1).synthesis(alm, per_channel=per_channel)
