"""Fused simulate -> map round trip.

Port of ``draco_tpu.telescope.roundtrip``'s two fused programs:

  sky map --SHT--> alm --windowed beam projection--> V_m --(weights)-->
  --adjoint--> dirty alm --inverse SHT--> map

The task chain this fuses (``SimulateSidereal -> MModeTransform ->
DirtyMapMaker``) also materialises the sidereal stream between simulation
and mapping; that iFFT -> FFT pair is the identity on the m-modes, so the
program skips it and runs forward projection and weighted adjoint in one
pass over baseline chunks.  Each chunk's fringe x beam planes are built
once and consumed by both sets of products.

Compact (dish) beams run the windowed form: baselines are sorted by
their m-support bound and chunks grouped by the rounded support ``Mb``,
so a chunk of short baselines contracts only its first ``Mb``
m-columns.  Without an explicit ``chunk`` the plan comes from that
profile: the budget's chunks balanced so that none is padding, then split
while that cuts the planned GEMM work (:func:`_windowed_chunk`).  Wide
(cylinder) beams run the full-sphere form: the sky is contracted against
the split Legendre sections once, each chunk ring-analyses its [Re, Im]
fringe x beam maps on the SHT's padded layout, and the adjoint
accumulates per-section T tensors with the Legendre applied once after
the loop.

The prepared state (:func:`prepare_state`, or :func:`state_from_numpy`
from the JAX package's own constants) is a dict of tensors on one device
in one real dtype: float32 with two-float Legendre tables and three-float
fringe phases, or float64 with exact tables for reference runs.  Its
``form`` says which program it holds.  Entry points that build a state
take ``device=``; none means the first CUDA card
(:func:`draco_tpu_torch.device.resolve`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config
from ..core.task import ContainerTask
from ..device import as_tensor, resolve
from ..ops import cuda_kernels, healpix
from ..ops.sht import SHT
from ..ops.tools import threefloat_split
from ..parallel import mesh as pmesh
from ..util.trace import span

__all__ = [
    "prepare_state",
    "state_from_numpy",
    "fused_roundtrip",
    "fused_roundtrip_fn",
    "fused_simulate_to_map",
    "fused_simulate_to_map_tiled",
    "SimulateAndMap",
    "reset_windowed_gemm_work",
]

# HBM budget that sizes the baseline chunk when none is given
CHUNK_BUDGET_BYTES = 4 * 2**30
# Fewest rows a chunk of the windowed form's automatic plan.  The
# projection GEMMs [nfreq, chunk, Kf] @ [Kf, Mb] and the adjoint ones run at
# 42-50 TFLOP/s float32 from 512 rows a chunk up and at 33-35 at 256
# (22-25 at 128), at 1 and at 8 channels alike (dish64, Kf 16768, H100 80GB
# HBM3 at 700 W, chip_smoke.py phase 2d): below 512 rows the rate falls by
# more than a halving of the chunk saves work.
MIN_PLAN_ROWS = 512
# planned GEMM work of the windowed calls since the last
# reset_windowed_gemm_work(): each call adds its plan's sum over chunks of
# chunk x Mb (its GEMMs' operations are 16 nfreq npol Kf times that)
windowed_gemm_work = 0


def reset_windowed_gemm_work() -> None:
    global windowed_gemm_work
    windowed_gemm_work = 0


def _pad_to(n: int, chunk: int) -> int:
    return (n + chunk - 1) // chunk * chunk


def _uniform_grid(inv_wl: np.ndarray) -> bool:
    """Whether 1/lambda is an arithmetic progression (within fit tolerance)."""
    nfreq = len(inv_wl)
    if nfreq == 1:
        return True
    step = (inv_wl[-1] - inv_wl[0]) / (nfreq - 1)
    fit = inv_wl[0] + step * np.arange(nfreq)
    return bool(np.abs(inv_wl - fit).max() <= 1e-12 * np.abs(inv_wl).max())


def _phase_coeff(tel, nfreq: int, vec3: np.ndarray):
    """Phase coefficients of baseline vectors [N, 3], in turns per unit
    direction: ``(coeff [G, N, 3] float64, uniform)``.

    On a uniform frequency grid G = 2: ``b nu_0 / c`` and ``b dnu / c``,
    the base phase and the per-step increment.  Otherwise G = nfreq with
    ``b / lambda_f``.
    """
    inv_wl = 1.0 / np.asarray(tel.wavelengths, dtype=np.float64)
    uniform = _uniform_grid(inv_wl)
    if uniform:
        step = 0.0 if nfreq == 1 else (inv_wl[-1] - inv_wl[0]) / (nfreq - 1)
        return np.stack([vec3 * inv_wl[0], vec3 * step]), True
    return vec3[None] * inv_wl[:, None, None], False


def _baseline_prep(tel, nfreq: int, nbase: int, chunk: int, order=None):
    """Chunk-padded baseline phase coefficients (:func:`_phase_coeff`).

    Returns ``(npad, nchunk, coeff [G, npad, 3] float64, uniform)``.
    """
    npad = _pad_to(nbase, chunk)
    nchunk = npad // chunk
    bl3 = tel.baseline_vectors_3d().astype(np.float64)
    if order is not None:
        bl3 = bl3[order]
    blp = np.zeros((npad, 3), np.float64)
    blp[:nbase] = bl3
    coeff, uniform = _phase_coeff(tel, nfreq, blp)
    return npad, nchunk, coeff, uniform


def _geom_prep(tel, nfreq: int, nbase: int, chunk: int):
    """Geometric-baseline dedup of the fringe trig (full-sphere form).

    Redundancy-stacked dual-pol products share their baseline geometry
    four ways (XX/XY/YX/YY of one feed separation).  Products are sorted
    by geometry and each chunk evaluates the trig only for its distinct
    geometries ([Gc, K] instead of [chunk, K]); products pick their rows
    back up with a row gather.  Phases are those of the per-product path
    (the same three-float operands).

    Returns None when dedup would not pay (more than 0.75 nbase distinct
    geometries), else ``(order, coeff [G, ngeom + Gc, 3] float64, g0s
    [nchunk], lidx [npad], Gc, uniform)``: chunk c reads geometry rows
    ``g0s[c] + lidx`` of its products.
    """
    bl3 = tel.baseline_vectors_3d().astype(np.float64)
    # identical-position pol pairs are bit-equal; the nano-unit round
    # only merges separations a fringe cannot resolve
    _, first_idx, inv = np.unique(np.round(bl3, 9), axis=0, return_index=True, return_inverse=True)
    inv = inv.reshape(-1)
    ngeom = len(first_idx)
    if ngeom > 0.75 * nbase:
        return None
    order = np.argsort(inv, kind="stable")
    gsorted = inv[order]
    npad = _pad_to(nbase, chunk)
    nchunk = npad // chunk
    gs_pad = np.concatenate([gsorted, np.full(npad - nbase, gsorted[-1], gsorted.dtype)])
    seg = gs_pad.reshape(nchunk, chunk)
    g0s = seg.min(axis=1)
    Gc = _pad_to(max(1, int((seg.max(axis=1) - g0s).max()) + 1), 8)
    lidx = gs_pad - np.repeat(g0s, chunk)
    # each geometry's first member's exact vector, padded so that every
    # [g0, g0 + Gc) slice stays in range
    gvec = np.zeros((ngeom + Gc, 3), np.float64)
    gvec[:ngeom] = bl3[first_idx]
    coeff, uniform = _phase_coeff(tel, nfreq, gvec)
    return order, coeff, g0s.astype(np.int64), lidx.astype(np.int64), Gc, uniform


def _split3(a64: np.ndarray, rdt, device):
    """Three-part operands of the exact phase: the float32 split, or
    (a64, 0, 0) for float64 reference runs."""
    if rdt == torch.float64:
        a = torch.as_tensor(np.asarray(a64, np.float64), device=device)
        z = torch.zeros_like(a)
        return a, z, z.clone()
    return tuple(torch.as_tensor(p, device=device) for p in threefloat_split(a64))


def _beam_prep(bt, nfreq: int, npad: int, nbase: int, gather, order=None):
    """Per-frequency deduped beam products ``gather``-ed to the window.

    Returns (u_re, u_im [nfreq, nuniq, npol, Kf] float64, uidx_pad [npad],
    uniform_real): ``uniform_real`` when every baseline shares one real
    product (identical dishes).
    """
    u_res, u_ims, uidx = [], [], None
    for fi in range(nfreq):
        u_idx, bprod = bt._beam_products(fi)
        bw = gather(bprod)
        u_res.append(bw.real)
        u_ims.append(bw.imag)
        uidx = u_idx
    uidx_pad = np.zeros(npad, np.int64)
    uidx_pad[:nbase] = uidx if order is None else np.asarray(uidx)[order]
    u_re = np.stack(u_res)
    u_im = np.stack(u_ims)
    uniform_real = u_re.shape[1] == 1 and not u_im.any()
    return u_re, u_im, uidx_pad, uniform_real


def _auto_chunk(nbase: int, nfreq: int, npol: int, per_pixel: int) -> int:
    """Baselines per chunk: the fewest chunks of the rows that
    ``CHUNK_BUDGET_BYTES`` of fringe planes allows (at least 64, rounded up
    to 8), with the baselines balanced over them and rounded up to 8, so
    that no chunk is wholly padding.  A balanced chunk may hold fewer than
    64 rows: fewer than 64 baselines take one chunk of their own count
    rounded up to 8."""
    c = int(CHUNK_BUDGET_BYTES // max(1, 4 * 4 * nfreq * npol * per_pixel))
    c = _pad_to(max(64, min(c, nbase)), 8)
    nchunk = -(-nbase // c)
    return _pad_to(-(-nbase // nchunk), 8)


def _plan_work(m_cut_sorted: np.ndarray, chunk: int, mmax: int) -> int:
    """The windowed GEMMs' planned work, sum over chunks of chunk x Mb."""
    nchunk = -(-len(m_cut_sorted) // chunk)
    return sum((c1 - c0) * chunk * mb for c0, c1, mb in _chunk_groups(m_cut_sorted, nchunk, chunk, mmax))


def _windowed_chunk(m_cut_sorted: np.ndarray, chunk: int, mmax: int) -> int:
    """The windowed form's automatic chunk: ``chunk`` (:func:`_auto_chunk`'s)
    or a balanced split of its chunks into 2, 4, 8, ... parts, whichever
    plans the least GEMM work (:func:`_plan_work`; ties to fewer chunks).
    Finer chunks narrow each chunk's m-columns to its own rows' support.
    No chunk has fewer than ``MIN_PLAN_ROWS`` rows."""
    nbase = len(m_cut_sorted)
    n = -(-nbase // chunk)
    best, best_work = chunk, _plan_work(m_cut_sorted, chunk, mmax)
    while n < nbase:
        n *= 2
        c = _pad_to(-(-nbase // n), 8)
        if c < MIN_PLAN_ROWS:
            break
        work = _plan_work(m_cut_sorted, c, mmax)
        if work < best_work:
            best, best_work = c, work
    return best


def _beam_m_support(bt, info, tau: float) -> int:
    """Measured azimuthal band width of the deduped beam products.

    Largest ``|m|`` at which any product's per-ring azimuthal Fourier
    coefficient stays above ``tau`` of the global peak coefficient, over
    a sample of frequencies spanning the band (both edges included).
    """
    nfreq = bt.telescope.nfreq
    fis = sorted(set(np.linspace(0, nfreq - 1, min(nfreq, 8)).astype(int)))
    ring_specs = None
    gmax = 0.0
    for fi in fis:
        _, bprod = bt._beam_products(fi)
        flat = np.asarray(bprod).reshape(-1, bprod.shape[-1])
        off = 0
        specs = []
        for r in range(info.nring):
            n = int(info.nphi[r])
            F = np.abs(np.fft.fft(flat[:, off : off + n], axis=-1)) / n
            off += n
            specs.append(F.max(axis=0))
            gmax = max(gmax, float(F.max()))
        if ring_specs is None:
            ring_specs = specs
        else:
            ring_specs = [np.maximum(a, b) for a, b in zip(ring_specs, specs)]
    m_sup = 0
    for spec in ring_specs:
        n = spec.shape[0]
        above = spec > tau * gmax
        if above.any():
            m_abs = np.minimum(np.arange(n), n - np.arange(n))
            m_sup = max(m_sup, int(m_abs[above].max()))
    return m_sup


def _m_cut(bt, win) -> np.ndarray:
    """Each baseline's inclusive m-support bound: the fringe's Jacobi-Anger
    band edge 2 pi |u_perp| sin(theta)_max, a Bessel-tail margin, and the
    beam product's measured azimuthal band width, at most mmax + 1."""
    tel, s = bt.telescope, win.sht
    bl3 = tel.baseline_vectors_3d()
    u_perp = np.hypot(bl3[:, 0], bl3[:, 1]) / tel.wavelengths.min()
    s_max = float(np.sin(s.info.theta[win.band]).max())
    x = 2 * np.pi * u_perp * s_max
    m_margin = _beam_m_support(bt, s.info, 1e-6) + np.ceil(4.0 * np.cbrt(np.maximum(x, 1.0))).astype(int)
    return np.minimum(np.ceil(x).astype(int) + m_margin, s.mmax + 1)


def _chunk_groups(m_cut_sorted: np.ndarray, nchunk: int, chunk: int, mmax: int):
    """(chunk_start, chunk_end, Mb) runs of chunks sharing their 128-rounded
    m-support; ``m_cut`` is an inclusive max-m bound, so mb + 1 columns
    are needed before rounding."""
    groups = []
    for ci in range(nchunk):
        in_chunk = m_cut_sorted[ci * chunk : (ci + 1) * chunk]
        mb = int(in_chunk.max()) if len(in_chunk) else 1
        mb = min(mmax + 1, (mb + 1 + 127) // 128 * 128)
        if groups and groups[-1][2] == mb:
            groups[-1][1] = ci + 1
        else:
            groups.append([ci, ci + 1, mb])
    return tuple(tuple(g) for g in groups)


def prepare_state(bt, chunk: int | None = None, dtype=torch.float32, device=None) -> dict:
    """Build the round trip's prepared state for ``bt`` on ``device``.

    Compact beams get the windowed form, wide beams the full-sphere one.
    ``dtype`` float32 is the production mode; float64 builds exact tables
    for reference runs.
    """
    device = resolve(device)
    win = bt._beam_window()
    if win is None:
        return _prepare_fullsphere(bt, chunk, dtype, device)
    tel = bt.telescope
    s = win.sht
    mmax = s.mmax
    npol = tel.num_pol_sky
    nfreq = tel.nfreq
    nbase = len(tel.uniquepairs)
    m_cut = _m_cut(bt, win)
    order = np.argsort(m_cut, kind="stable")
    if chunk is None:
        chunk = _windowed_chunk(m_cut[order], _auto_chunk(nbase, nfreq, npol, win.Kf), mmax)

    _, lam, lam_lo, plan = bt._streaming_ops2(device, dtype)
    if lam_lo is not None:
        lam_band, band_lo = win.lam_band_2f(device)
    else:
        lam_band, band_lo = win.lam_band(dtype, device), None
    Ecf, Esf, flat_ring, ring_onehot = win.flat_tables(dtype, device)
    vec = np.asarray(healpix.pix2vec(bt.beam_nside), np.float64)[win.flat_index]
    va, vb, vc = _split3(vec, dtype, device)
    npad, nchunk, coeff, uniform_freq = _baseline_prep(tel, nfreq, nbase, chunk, order)
    bla, blb, blc = _split3(coeff, dtype, device)
    u_re, u_im, uidx_pad, uniform_real = _beam_prep(
        bt, nfreq, npad, nbase, lambda bprod: bprod[..., win.flat_index], order=order
    )
    groups = _chunk_groups(m_cut[order], nchunk, chunk, mmax)
    return {
        "form": "windowed",
        "sht": s,
        "lam": lam,
        "lam_lo": lam_lo,
        "plan": plan,
        "lam_band": lam_band,
        "band_lo": band_lo,
        "Ecf": Ecf,
        "Esf": Esf,
        "flat_ring": flat_ring,
        "ring_onehot": ring_onehot,
        "va": va,
        "vb": vb,
        "vc": vc,
        "u_re": torch.as_tensor(u_re, dtype=dtype, device=device),
        "u_im": torch.as_tensor(u_im, dtype=dtype, device=device),
        "uidx": torch.as_tensor(uidx_pad, device=device),
        "bla": bla,
        "blb": blb,
        "blc": blc,
        "dims": (nfreq, npol, chunk, nchunk, nbase, win.Kf, mmax, groups),
        "order": torch.as_tensor(order, device=device),
        "uniform_real": bool(uniform_real),
        "uniform_freq": bool(uniform_freq),
    }


def _prepare_fullsphere(bt, chunk, dtype, device) -> dict:
    """The full-sphere form's state: padded-layout pixel vectors and beam
    products, the belt phase weight, and the geometry dedup when it pays."""
    tel = bt.telescope
    s, lam, lam_lo, plan = bt._streaming_ops2(device, dtype)
    npol = tel.num_pol_sky
    nfreq = tel.nfreq
    nbase = len(tel.uniquepairs)
    layout = s.padded_layout()
    if chunk is None:
        # the ring-analysed fringe sections cost a few padded spheres
        chunk = _auto_chunk(nbase, nfreq, npol, 3 * len(layout))
    lclip = np.clip(layout, 0, None)
    vec = np.asarray(healpix.pix2vec(bt.beam_nside), np.float64)[lclip]
    va, vb, vc = _split3(np.where(layout[:, None] >= 0, vec, 0.0), dtype, device)

    geom = _geom_prep(tel, nfreq, nbase, chunk)
    order = None if geom is None else geom[0]
    npad, nchunk, coeff, uniform_freq = _baseline_prep(tel, nfreq, nbase, chunk, order)
    bla, blb, blc = _split3(coeff, dtype, device)
    u_re, u_im, uidx_pad, uniform_real = _beam_prep(
        bt, nfreq, npad, nbase, lambda bprod: np.where(layout >= 0, bprod[..., lclip], 0.0), order=order
    )
    # the fringe kernel reads the beam products row-major
    u_re, u_im = np.ascontiguousarray(u_re), np.ascontiguousarray(u_im)
    ga = gb = gc = lidx = None
    g0s, Gc = (), 0
    if geom is not None:
        _, gcoeff, g0, lidx_h, Gc, _ = geom
        ga, gb, gc = _split3(gcoeff, dtype, device)
        g0s = tuple(int(g) for g in g0)
        lidx = torch.as_tensor(lidx_h, device=device)
    return {
        "form": "fullsphere",
        "sht": s,
        "lam": lam,
        "lam_lo": lam_lo,
        "plan": plan,
        "pw": s.belt_phase_weight(dtype, device),
        "va": va,
        "vb": vb,
        "vc": vc,
        "u_re": torch.as_tensor(u_re, dtype=dtype, device=device),
        "u_im": torch.as_tensor(u_im, dtype=dtype, device=device),
        "uidx": torch.as_tensor(uidx_pad, device=device),
        "bla": bla,
        "blb": blb,
        "blc": blc,
        "ga": ga,
        "gb": gb,
        "gc": gc,
        "g0s": g0s,
        "lidx": lidx,
        "dims": (nfreq, npol, chunk, nchunk, nbase, s.mmax, Gc),
        "order": None if order is None else torch.as_tensor(order, device=device),
        "uniform_real": bool(uniform_real),
        "uniform_freq": bool(uniform_freq),
    }


def state_from_numpy(consts: dict, device=None) -> dict:
    """The port's state from the JAX program's prepared constants.

    ``consts`` holds, as numpy (nested dicts/lists for ``lam``, ``lam_lo``
    and ``plan``; ``lam_lo``/``band_lo`` may be None), the leaves of the
    ``consts`` tuple that ``draco_tpu.telescope.roundtrip.fused_roundtrip_fn``
    hands its program, plus ``dims``, ``order`` (or None),
    ``uniform_freq``, and the SHT's ``nside`` and ``lmax``.  The windowed
    program's leaves are ``lam, lam_lo, plan, lam_band, band_lo, Ecf, Esf,
    flat_ring, ring_onehot, va, vb, vc, u_re, u_im, uidx_pad, bla, blb,
    blc``; the full-sphere program's (recognised by ``pw``) are ``lam,
    lam_lo, plan, pw, va, vb, vc, u_re, u_im, uidx_pad, bla, blb, blc, ga,
    gb, gc, g0s, lidx``.  A one-hot ``uidx_pad`` [npad, U] or ``lidx``
    [npad, Gc] becomes the index it encodes.
    """
    device = resolve(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    def bf16(a):
        return t(a, np.float32).to(torch.bfloat16)

    def sections(d, conv):
        return {"belt": conv(d["belt"]), "caps": [conv(c) for c in d["caps"]]}

    def reim(a):
        a = np.asarray(a)
        return t(a.real), t(a.imag)

    def index(a):
        a = np.asarray(a)
        return t(a.argmax(axis=-1) if a.ndim == 2 else a, np.int64)

    dims = tuple(consts["dims"])
    u_re = t(np.ascontiguousarray(consts["u_re"]))
    u_im = t(np.ascontiguousarray(consts["u_im"]))
    order = consts.get("order")
    state = {
        "lam": sections(consts["lam"], t),
        "lam_lo": None if consts["lam_lo"] is None else sections(consts["lam_lo"], bf16),
        "plan": {"P": [reim(p) for p in consts["plan"]["P"]]},
        "va": t(consts["va"]),
        "vb": t(consts["vb"]),
        "vc": t(consts["vc"]),
        "u_re": u_re,
        "u_im": u_im,
        "uidx": index(consts["uidx_pad"]),
        "bla": t(consts["bla"]),
        "blb": t(consts["blb"]),
        "blc": t(consts["blc"]),
        "dims": dims,
        "order": None if order is None else t(order, np.int64),
        "uniform_real": bool(u_re.shape[1] == 1 and not bool(u_im.any())),
        "uniform_freq": bool(consts["uniform_freq"]),
    }
    if "pw" in consts:
        mmax, Gc = dims[5], dims[6]
        geom = Gc > 0
        state.update(
            form="fullsphere",
            sht=SHT(int(consts["nside"]), int(consts["lmax"]), mmax),
            pw=reim(consts["pw"]),
            ga=t(consts["ga"]) if geom else None,
            gb=t(consts["gb"]) if geom else None,
            gc=t(consts["gc"]) if geom else None,
            g0s=tuple(int(g) for g in np.asarray(consts["g0s"])) if geom else (),
            lidx=index(consts["lidx"]) if geom else None,
        )
        return state
    state.update(
        form="windowed",
        sht=SHT(int(consts["nside"]), int(consts["lmax"]), dims[6]),
        lam_band=t(consts["lam_band"]),
        band_lo=None if consts["band_lo"] is None else bf16(consts["band_lo"]),
        Ecf=t(consts["Ecf"]),
        Esf=t(consts["Esf"]),
        flat_ring=t(consts["flat_ring"], np.int64),
        ring_onehot=t(consts["ring_onehot"]),
    )
    return state


def _fringe_planes_of(state):
    """The function that makes ``state``'s fringe x beam planes: the
    kernel's wrapper, or for a float64 reference state its plain version,
    called by name."""
    if state["u_re"].dtype == torch.float64:
        return cuda_kernels.fringe_planes_plain
    return cuda_kernels.fringe_planes


def _fringe_sections(state, c: int):
    """Ring-section coefficients (F_belt, [F_group, ...]) of chunk ``c``'s
    [Re, Im] fringe x beam maps, each [2, f, C, p, rows, M+1]; the belt
    raw (its phase weight is folded in by the caller)."""
    chunk, Gc = state["dims"][2], state["dims"][6]
    rows = slice(c * chunk, (c + 1) * chunk)
    with span("fullsphere.fringe_build"):
        if Gc:
            # the chunk's distinct geometries, and each product's row among them
            coeff, row0, lidx = (state["ga"], state["gb"], state["gc"]), state["g0s"][c], state["lidx"][rows]
        else:
            coeff, row0, lidx = (state["bla"], state["blb"], state["blc"]), c * chunk, None
        X = _fringe_planes_of(state)(
            *coeff, *(state[k] for k in ("va", "vb", "vc", "u_re", "u_im")), state["uidx"][rows], row0,
            state["uniform_freq"], state["uniform_real"], lidx=lidx, geom_rows=Gc, stacked=True,
        )  # [2, f, C, p, K]
    with span("fullsphere.ring_analysis"):
        return state["sht"]._ring_analysis_parts_padded(X, state["plan"], raw_belt=True)


def _padded_weight(state, weight, npad: int, M1: int, rdt, dev):
    """User weights [M+1, 2, nfreq, nbase] (original baseline order) in the
    state's baseline order, zero-padded to [M+1, 2, nfreq, npad]."""
    nfreq, npairs = state["dims"][0], state["dims"][4]
    w = torch.as_tensor(weight).to(device=dev, dtype=rdt)
    if state["order"] is not None:
        w = w[..., state["order"]]
    w_pad = torch.zeros(M1, 2, nfreq, npad, dtype=rdt, device=dev)
    w_pad[..., :npairs] = w
    return w_pad


def fused_roundtrip(state: dict, sky: torch.Tensor, weight: torch.Tensor | None = None) -> torch.Tensor:
    """Dirty-map round trip of ``sky`` [nfreq, npol, npix] through ``state``.

    ``weight`` [mmax+1, 2, nfreq, nbase] (original baseline order) weights
    the m-modes before the adjoint; unit weights when None.  Runs on the
    state's device in its dtype; returns [nfreq, npol, npix].

    Under ``torch.profiler`` the call is the span ``roundtrip.call``
    (:func:`draco_tpu_torch.util.trace.span`: a flag check when no profiler
    records).  The windowed form's stages are five spans inside it, which
    hold the whole call between them:

    - ``windowed.sky_transform``: the SHT analysis, the band projection and
      the per-pixel DFT factors, with the padded weights and the zeroed
      accumulators;
    - ``windowed.fringe_build``: a chunk's fringe x beam planes;
    - ``windowed.project``: a chunk's projection GEMMs, validity masks and
      weights;
    - ``windowed.accumulate``: a chunk's adjoint GEMMs into the accumulators;
    - ``windowed.map_transform``: the conjugate DFT factors, the ring
      reduction, the band adjoint and the SHT synthesis.

    The full-sphere form's spans are listed at
    :func:`_fused_roundtrip_fullsphere`.
    """
    with span("roundtrip.call"):
        if state["form"] == "fullsphere":
            return _fused_roundtrip_fullsphere(state, sky, weight)
        return _fused_roundtrip_windowed(state, sky, weight)


def _fused_roundtrip_windowed(state: dict, sky: torch.Tensor, weight) -> torch.Tensor:
    """The windowed form of :func:`fused_roundtrip` (compact beams); adds
    its plan's work to :data:`windowed_gemm_work`."""
    global windowed_gemm_work
    s = state["sht"]
    nfreq, npol, chunk, nchunk, npairs, Kf, mmax, groups = state["dims"]
    windowed_gemm_work += sum((c1 - c0) * chunk * Mb for c0, c1, Mb in groups)
    K = npol * Kf
    Ecf, Esf = state["Ecf"], state["Esf"]
    rdt, dev = Ecf.dtype, Ecf.device
    scale = 1.0 / (4 * np.pi / s.npix)
    lam, lam_lo, plan = state["lam"], state["lam_lo"], state["plan"]
    lam_band, band_lo = state["lam_band"], state["band_lo"]

    with span("windowed.sky_transform"):
        sky = sky.to(device=dev, dtype=rdt)
        # forward: sky -> alm -> windowed phase tensors
        alm = s._analysis_impl(sky, lam, plan, lam_lo)  # [f, p, L+1, M+1]
        Sr = torch.einsum("fplm,lmr->fprm", alm.real, lam_band)
        Si = torch.einsum("fplm,lmr->fprm", alm.imag, lam_band)
        if band_lo is not None:
            blo = band_lo.to(rdt)
            Sr = Sr + torch.einsum("fplm,lmr->fprm", alm.real, blo)
            Si = Si + torch.einsum("fplm,lmr->fprm", alm.imag, blo)
        # ring -> pixel gather, then the per-pixel DFT factors
        Srk = Sr.index_select(2, state["flat_ring"])  # [f, p, Kf, M+1]
        Sik = Si.index_select(2, state["flat_ring"])
        a1 = (Ecf * Srk - Esf * Sik).reshape(nfreq, K, mmax + 1)
        a2 = (Ecf * Sik + Esf * Srk).reshape(nfreq, K, mmax + 1)

        if weight is not None:
            weight_t = _padded_weight(state, weight, chunk * nchunk, mmax + 1, rdt, dev).permute(1, 2, 3, 0)

        # one pass over the baseline chunks: project, weight, and accumulate
        # the adjoint while the chunk's fringe planes are live
        Yr = torch.zeros(nfreq, K, mmax + 1, dtype=rdt, device=dev)
        Yi = torch.zeros(nfreq, K, mmax + 1, dtype=rdt, device=dev)
        bidx = torch.arange(chunk, device=dev)
        mpos_all = (torch.arange(mmax + 1, device=dev) > 0).to(rdt)
        fringe_operands = [state[k] for k in ("bla", "blb", "blc", "va", "vb", "vc", "u_re", "u_im")]
    for c0, c1, Mb in groups:
        a1b = a1[:, :, :Mb]
        a2b = a2[:, :, :Mb]
        mpos = mpos_all[:Mb]
        for c in range(c0, c1):
            with span("windowed.fringe_build"):
                re, im = _fringe_planes_of(state)(
                    *fringe_operands, state["uidx"][c * chunk : (c + 1) * chunk], c * chunk, state["uniform_freq"],
                    state["uniform_real"],
                )
            with span("windowed.project"):
                G1 = re @ a1b
                G2 = im @ a2b
                G3 = re @ a2b
                G4 = im @ a1b
                vp_r = (G1 - G2) * scale
                vp_i = (G3 + G4) * scale
                vm_r = (G1 + G2) * scale
                vm_i = (G3 - G4) * scale
                # padded baselines carry no data; m = 0 has no negative mode
                valid = (c * chunk + bidx < npairs).to(rdt)[None, :, None]
                vp_r, vp_i = vp_r * valid, vp_i * valid
                vm_r, vm_i = vm_r * valid * mpos, vm_i * valid * mpos
                if weight is not None:
                    wc = weight_t[:, :, c * chunk : (c + 1) * chunk, :Mb]
                    vp_r, vp_i = vp_r * wc[0], vp_i * wc[0]
                    vm_r, vm_i = vm_r * wc[1], vm_i * wc[1]
                vs_r, vs_i = vp_r + vm_r, vp_i + vm_i
                vd_r, vd_i = vm_r - vp_r, vm_i - vp_i
            with span("windowed.accumulate"):
                reT = re.transpose(1, 2)
                imT = im.transpose(1, 2)
                Yr[:, :, :Mb] += reT @ vs_r - imT @ vd_i
                Yi[:, :, :Mb] += reT @ vs_i + imT @ vd_r

    with span("windowed.map_transform"):
        # per-pixel conjugate DFT factors, then the pixel -> ring reduction
        Yr = Yr.reshape(nfreq, npol, Kf, mmax + 1)
        Yi = Yi.reshape(nfreq, npol, Kf, mmax + 1)
        Tr = Ecf * Yr + Esf * Yi
        Ti = Ecf * Yi - Esf * Yr
        Tr = torch.einsum("rk,fpkm->fprm", state["ring_onehot"], Tr)
        Ti = torch.einsum("rk,fpkm->fprm", state["ring_onehot"], Ti)
        ar = torch.einsum("lmr,fprm->fplm", lam_band, Tr)
        ai = torch.einsum("lmr,fprm->fplm", lam_band, Ti)
        if band_lo is not None:
            ar = ar + torch.einsum("lmr,fprm->fplm", blo, Tr)
            ai = ai + torch.einsum("lmr,fprm->fplm", blo, Ti)
        a_dirty = torch.complex(ar, ai) * scale
        return s._synthesis_impl(a_dirty, lam, plan, lam_lo)


def _fused_roundtrip_fullsphere(state: dict, sky: torch.Tensor, weight) -> torch.Tensor:
    """The full-sphere form of :func:`fused_roundtrip` (wide beams).

    Per section, the chunk's coefficients F [2, f, C, p, r, M+1] are seen
    as Fm [f, M+1, 2C, p*r]: the U/V contraction ``xfcprm,fprm->xfmc`` and
    the T accumulation ``xfcprm,xmfc->fprm`` are then two batched products
    over (f, m) on the same tensor.  The belt phase weight pw is folded in
    twice: conj(pw) into the belt sky section before the loop, pw into the
    belt T after it.

    Under ``torch.profiler`` the stages are spans inside ``roundtrip.call``
    (:func:`draco_tpu_torch.util.trace.span`), which hold the whole call
    between them: ``fullsphere.sky_sections`` (the SHT analysis and the
    sky's Legendre sections, with the padded weights and the zeroed T),
    then for each chunk ``fullsphere.fringe_build``,
    ``fullsphere.ring_analysis``, ``fullsphere.uv_contraction`` and
    ``fullsphere.t_accumulate``, and last ``fullsphere.adjoint_synthesis``.
    The benchmark's per-layer metrics ``fullsphere.<stage>_ms``
    (``portbench/layers/``) read the device time of the kernels each
    launches.
    """
    s = state["sht"]
    nfreq, npol, chunk, nchunk, npairs, mmax, _ = state["dims"]
    M1 = mmax + 1
    pr, pi = state["pw"]
    rdt, dev = pr.dtype, pr.device
    scale = 1.0 / (4 * np.pi / s.npix)
    lam, lam_lo, plan = state["lam"], state["lam_lo"], state["plan"]

    with span("fullsphere.sky_sections"):
        sky = sky.to(device=dev, dtype=rdt)
        pw = torch.complex(pr, pi)  # [nbelt, M+1]
        alm = s._analysis_impl(sky, lam, plan, lam_lo)  # [f, p, L+1, M+1]
        G_belt, G_caps = s._legendre_sections(alm, lam, lam_lo)  # [f, p, r, M+1]
        sec_rings = [G_belt.shape[2]] + [G.shape[2] for G in G_caps]
        # conj(F) S summed over (p, r) is conj(F conj(S)): conjugate the small side
        S_conj = [
            (S.conj() if i else S.conj() * pw).permute(0, 3, 1, 2).reshape(nfreq, M1, -1, 1)
            for i, S in enumerate((G_belt, *G_caps))
        ]
        del alm, G_belt, G_caps

        if weight is not None:
            weight_t = _padded_weight(state, weight, chunk * nchunk, M1, rdt, dev).permute(1, 2, 0, 3)
        bidx = torch.arange(chunk, device=dev)
        mpos = (torch.arange(M1, device=dev) > 0).to(rdt)[:, None]
        T = [torch.zeros(nfreq, M1, 1, npol * r, dtype=pw.dtype, device=dev) for r in sec_rings]
    for c in range(nchunk):
        F_belt, group_F = _fringe_sections(state, c)
        with span("fullsphere.uv_contraction"):
            # the belt's is a view when nfreq is 1 ((x, c) and (p, r) adjacent in memory); the cap
            # groups' DFT einsums leave their row axis outermost, so theirs are copies
            Fm = [F.permute(1, 5, 0, 2, 3, 4).reshape(nfreq, M1, 2 * chunk, -1) for F in (F_belt, *group_F)]
            del F_belt, group_F
            UV = sum(Fs @ Sc for Fs, Sc in zip(Fm, S_conj)).conj().reshape(nfreq, M1, 2, chunk)
            # padded baselines carry no data; m = 0 has no negative mode
            valid = (c * chunk + bidx < npairs).to(rdt) * scale
            vp = (UV[:, :, 0] + 1j * UV[:, :, 1]) * valid
            vm = (UV[:, :, 0] - 1j * UV[:, :, 1]) * (valid * mpos)
            if weight is not None:
                wc = weight_t[:, :, :, c * chunk : (c + 1) * chunk]
                vp = vp * wc[0]
                vm = vm * wc[1]
        with span("fullsphere.t_accumulate"):
            # T += F[0] (vp + vm) + i F[1] (vm - vp)
            vst = torch.cat([vp + vm, 1j * (vm - vp)], dim=-1)[:, :, None, :]  # [f, M+1, 1, 2C]
            for Tsec, Fs in zip(T, Fm):
                Tsec += vst @ Fs
            del Fm
    with span("fullsphere.adjoint_synthesis"):
        T = [Tsec.reshape(nfreq, M1, npol, r).permute(0, 2, 3, 1) for Tsec, r in zip(T, sec_rings)]
        T[0] = T[0] * pw
        a_dirty = s._contract_alm(T[0], T[1:], lam, lam_lo) * scale
        return s._synthesis_impl(a_dirty, lam, plan, lam_lo)


def fused_roundtrip_fn(bt, chunk: int | None = None, dtype=torch.float32, device=None):
    """A reusable ``run(sky, weight=None)`` over a state prepared once on
    ``device`` (none: the first CUDA card)."""
    state = prepare_state(bt, chunk=chunk, dtype=dtype, device=device)

    def run(sky, weight=None):
        return fused_roundtrip(state, sky, weight)

    run.state = state
    return run


def _as_sky(sky, device) -> torch.Tensor:
    """A tensor sky stays as it is (moved to ``device`` if one is named); a
    host sky keeps float64 and becomes float32 otherwise, on ``device``."""
    if not isinstance(sky, torch.Tensor):
        sky = np.asarray(sky)
        if sky.dtype != np.float64:
            sky = sky.astype(np.float32)
    return as_tensor(sky, device)


def fused_simulate_to_map(bt, sky, chunk: int | None = None, weight=None, device=None) -> torch.Tensor:
    """Simulate -> dirty-map round trip of ``sky`` [nfreq, npol_sky, npix].

    Runs on the sky's device in its dtype (float32, or float64 for
    reference runs); a host (numpy) sky goes to ``device`` (none: the first
    CUDA card) as float64 if it is float64 and as float32 otherwise.
    ``weight`` [mmax+1, 2, nfreq, nbase] weights the m-modes (unit weights
    when omitted).  The prepared state is cached on ``bt`` per (chunk,
    device, dtype).

    A sky placed over a mesh (``parallel.shard_array_named(sky, ("freq",
    "pol", "pix"))``) runs each rank's frequency slab through the window of
    the telescope's channels it holds, and the maps come back placed alike.
    """
    if pmesh.is_placed(sky):
        return _simulate_to_map_slabs(bt, sky, chunk, weight)
    sky = _as_sky(sky, device)
    key = (chunk, sky.device, sky.dtype)
    if key not in bt._fused_fns:
        bt._fused_fns[key] = fused_roundtrip_fn(bt, chunk=chunk, dtype=sky.dtype, device=sky.device)
    return bt._fused_fns[key](sky, weight=weight)


def _simulate_to_map_slabs(bt, sky, chunk, weight) -> torch.Tensor:
    """:func:`fused_simulate_to_map` of this rank's block of a placed sky."""
    mesh, placements, block = sky.device_mesh, list(sky.placements), sky.to_local()
    split = [k for k, p in enumerate(placements) if p.is_shard()]
    if any(placements[k].dim != 0 for k in split) or len(split) > 1:
        raise ValueError(f"a placed sky may be split over its frequency axis only, not {placements}")
    nloc = block.shape[0]
    f0 = mesh.get_local_rank(split[0]) * nloc if split else 0
    weight = pmesh.unshard(weight)
    w = None if weight is None else weight[:, :, f0 : f0 + nloc]
    key = (f0, nloc, chunk, block.device, block.dtype)
    if key not in bt._fused_tiles:
        bt._fused_tiles[key] = fused_roundtrip_fn(
            _FreqTileBT(bt, f0, f0 + nloc), chunk=chunk, dtype=block.dtype, device=block.device
        )
    out = bt._fused_tiles[key](block, weight=w)
    return pmesh.from_block(out, mesh, placements, (sky.shape[0],) + tuple(out.shape[1:]))


class _TelescopeTile:
    """A telescope seen through the frequency window ``[f0, f1)``."""

    def __init__(self, tel, f0: int, f1: int):
        self._tel, self._f0, self._f1 = tel, f0, f1

    def __getattr__(self, name):
        return getattr(self._tel, name)

    @property
    def nfreq(self) -> int:
        return self._f1 - self._f0

    @property
    def wavelengths(self) -> np.ndarray:
        return self._tel.wavelengths[self._f0 : self._f1]

    @property
    def frequencies(self) -> np.ndarray:
        return self._tel.frequencies[self._f0 : self._f1]


class _FreqTileBT:
    """A frequency-window view of a BeamTransfer for tiled execution.

    Shares everything frequency-independent with the parent (geometry,
    beam window, SHT tables, beam nside) and maps the per-frequency beam
    products onto the ``[f0, f1)`` window.
    """

    def __init__(self, bt, f0: int, f1: int):
        self._bt = bt
        self._f0 = f0
        self.telescope = _TelescopeTile(bt.telescope, f0, f1)

    @property
    def beam_nside(self) -> int:
        return self._bt.beam_nside

    def _beam_window(self):
        return self._bt._beam_window()

    def _streaming_ops2(self, device=None, rdt=torch.float32):
        return self._bt._streaming_ops2(device, rdt)

    def _beam_products(self, fi: int):
        return self._bt._beam_products(self._f0 + fi)


def fused_simulate_to_map_tiled(
    bt, sky, freq_tile: int, chunk: int | None = None, weight=None, device=None
) -> torch.Tensor:
    """The round trip over frequency windows of ``freq_tile`` frequencies.

    A frequency batch's per-chunk intermediates scale with nfreq; this
    runs one window at a time, each on its own prepared state, and
    concatenates the maps.  ``nfreq`` must divide into whole tiles.  The
    sky goes where :func:`fused_simulate_to_map` puts it.
    """
    nfreq = bt.telescope.nfreq
    if nfreq % freq_tile:
        raise ValueError(f"freq_tile={freq_tile} does not divide nfreq={nfreq}")
    sky = _as_sky(sky, device)
    outs = []
    for f0 in range(0, nfreq, freq_tile):
        key = (f0, freq_tile, chunk, sky.device, sky.dtype)
        if key not in bt._fused_tiles:
            bt._fused_tiles[key] = fused_roundtrip_fn(
                _FreqTileBT(bt, f0, f0 + freq_tile), chunk=chunk, dtype=sky.dtype, device=sky.device
            )
        w = None if weight is None else weight[:, :, f0 : f0 + freq_tile]
        outs.append(bt._fused_tiles[key](sky[f0 : f0 + freq_tile], weight=w))
    return torch.cat(outs)


class SimulateAndMap(ContainerTask):
    """Pipeline task: Map in, dirty-map round trip out, fused.

    The one-pass equivalent of the chain ``SimulateSidereal ->
    MModeTransform -> DirtyMapMaker`` (reference roundtrip.py:1193-1233):
    :func:`fused_simulate_to_map` on the map's device, in float32 (the JAX
    package's device precision).  With unit sidereal weights the chain's
    m-mode weights are ``nra`` for every m, so its map is ``nra`` times
    this one.

    Attributes
    ----------
    baseline_chunk : int
        Baselines per chunk of the fused loop (0: sized automatically).
    """

    baseline_chunk = config.int_prop(0)

    def setup(self, bt):
        """Keep the beam-transfer manager."""
        from ..core import io

        self.beamtransfer = io.get_beamtransfer(bt)
        self.telescope = io.get_telescope(bt)

    def process(self, map_):
        """Round-trip ``map_`` and return the dirty Map."""
        from ..core import containers

        sky = map_.map[:].to(torch.float32)
        maps = fused_simulate_to_map(self.beamtransfer, sky, chunk=self.baseline_chunk or None)
        out = containers.Map(
            nside=healpix.nside_of(sky.shape[-1]),
            polarisation=sky.shape[1] == 4,
            freq=map_.index_map["freq"][:],
            attrs_from=map_,
            device=map_.device,
        )
        out.map[:] = maps
        return out
