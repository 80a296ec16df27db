"""SHT tables and transforms: draco_tpu_torch against draco_tpu.

Tolerances: float32 against float32, max|diff| / max|ref| <= 2e-5; the
two-float Legendre sum hi + lo against the float64 recurrence, 1e-9 of
the table's scale; ``threefloat_split`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.ops import sht as jsht
from draco_tpu.ops import tools as jtools
from draco_tpu_torch.ops import healpix, sht, tools

TOL32 = 2e-5


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def pair():
    return sht.SHT(16, 47, 47), jsht.get_sht(16, 47, 47)


def test_geometry_is_the_reference(pair):
    s, js = pair
    assert s._belt_rings == js._belt_rings and s._cap_rings == js._cap_rings
    assert len(s._cap_wgroups) == len(js._cap_wgroups)
    for (ra, wa), (rb, wb) in zip(s._cap_wgroups, js._cap_wgroups):
        assert wa == wb and np.array_equal(ra, rb)
    info, jinfo = healpix.ring_info(16), jsht.healpix.ring_info(16)
    assert np.array_equal(info.theta, jinfo.theta) and np.array_equal(info.phi0, jinfo.phi0)


def test_two_float_legendre_matches_jax(pair):
    s, js = pair
    hi, lo = s.precompute_legendre_split_2f("cpu")
    jhi, jlo = js.precompute_legendre_split_2f_streamed()
    with jax.enable_x64(True):
        ref = np.asarray(js._legendre_block(np.arange(48), jnp.float64))
    ring_ids = np.asarray(js._cap_rings)
    sections = [("belt", None)] + [("caps", i) for i in range(len(js._cap_wgroups))]
    for name, i in sections:
        h = hi[name] if i is None else hi[name][i]
        l = lo[name] if i is None else lo[name][i]
        jh = jhi[name] if i is None else jhi[name][i]
        if i is None:
            r = ref[:, :, js._belt_rings[0] : js._belt_rings[-1] + 1]
        else:
            r = ref[:, :, ring_ids[js._cap_wgroups[i][0]]]
        assert h.dtype == torch.float32 and l.dtype == torch.bfloat16
        assert _rel(h.numpy(), jh) <= TOL32
        two = h.double().numpy() + l.double().numpy()
        assert np.abs(two - r).max() <= 1e-9 * np.abs(ref).max()


def test_float32_legendre_is_stable(pair):
    s, _ = pair
    lam32 = s.legendre(np.arange(s.info.nring), torch.float32, "cpu")
    lam64 = s.legendre(np.arange(s.info.nring), torch.float64, "cpu")
    assert torch.isfinite(lam32).all()
    assert _rel(lam32.double().numpy(), lam64.numpy()) <= TOL32


def test_exact_turns_dft_factors(pair):
    s, js = pair
    plan = s.precompute_ring_plan(torch.float32, "cpu")
    jplan = js.precompute_ring_plan_streamed()
    Wr, Wi = s._belt_dft(torch.float32, "cpu")  # the belt's factors, built where the synthesis reads them
    W = Wr.numpy() + 1j * Wi.numpy()
    assert _rel(W, jplan["W"]) <= TOL32
    j = np.arange(s._belt_nphi, dtype=np.float64)[:, None]
    m = np.arange(s.mmax + 1, dtype=np.float64)[None, :]
    assert np.abs(W - np.exp(-2j * np.pi * j * m / s._belt_nphi)).max() < 5e-7
    w = 4 * np.pi / s.npix
    for (Pr, Pi), jP, (rows_arr, wd) in zip(plan["P"], jplan["P"], js._cap_wgroups):
        P = Pr.numpy() + 1j * Pi.numpy()
        assert _rel(P, jP) <= TOL32
        phi = js._cap_phi[rows_arr][:, :wd]
        mask = js._cap_mask[rows_arr][:, :wd]
        exact = np.exp(-1j * phi[:, :, None] * m[None]) * mask[:, :, None] * w
        assert np.abs(P - exact).max() < 5e-7 * w
    pr, pi = s._ring_phase(s._belt_rings, torch.float32, "cpu")
    phi0 = s.info.phi0[s._belt_rings]
    exact = np.exp(-1j * phi0[:, None] * np.arange(s.mmax + 1)[None, :])
    assert np.abs(pr.numpy() + 1j * pi.numpy() - exact).max() < 5e-7


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("nside", [8, 64])
def test_cap_factors_are_the_exact_phasors(nside, dtype):
    """The plan's cap factors P[r, j, m] against mask * w_r * exp(-i m
    phi_rj) in float64, phi_rj = phi0_r + 2 pi j / n_r of each cap ring's
    pixels: within float32 rounding (5e-7 of w_r; the phases are reduced in
    exact integer turns, so the error does not grow with m) or float64
    rounding (1e-12; the float64 reference's m phi alone rounds at ~1e-13);
    padding slots exactly zero."""
    s = sht.SHT(nside)
    plan = s.precompute_ring_plan(dtype, "cpu")
    tol = 5e-7 if dtype == torch.float32 else 1e-12
    m = np.arange(s.mmax + 1)
    ring_ids = np.asarray(s._cap_rings)
    assert len(plan) == 1 and len(plan["P"]) == len(s._cap_wgroups)
    for (Pr, Pi), (rows_arr, wd) in zip(plan["P"], s._cap_wgroups):
        rings = ring_ids[rows_arr]
        assert Pr.shape == Pi.shape == (len(rings), wd, s.mmax + 1) and Pr.dtype == Pi.dtype == dtype
        n = s.info.nphi[rings][:, None]
        j = np.arange(wd)[None, :]
        phi = s.info.phi0[rings][:, None] + 2 * np.pi * j / n
        mask = (j < n)[..., None]
        w = s.info.weight[rings][:, None, None]
        exact = mask * w * np.exp(-1j * phi[..., None] * m)
        P = Pr.numpy() + 1j * Pi.numpy()
        assert np.abs(P - exact).max() <= tol * w.max()
        assert not P[~np.broadcast_to(mask, P.shape)].any()


def test_map2alm_alm2map_match_jax():
    rng = np.random.Generator(np.random.SFC64(3))
    maps = rng.standard_normal((2, healpix.npix_of(16))).astype(np.float32)
    alm = sht.map2alm(torch.from_numpy(maps), lmax=47, iter=3)
    jalm = np.asarray(jsht.map2alm(maps, lmax=47, iter=3))
    assert alm.shape == jalm.shape and alm.dtype == torch.complex64
    assert _rel(alm.numpy(), jalm) <= TOL32
    back = sht.alm2map(alm, 16)
    jback = np.asarray(jsht.alm2map(jalm.astype(np.complex64), 16))
    assert back.dtype == torch.float32
    assert _rel(back.numpy(), jback) <= TOL32


def test_float64_transforms_match_jax():
    rng = np.random.Generator(np.random.SFC64(6))
    maps = rng.standard_normal((healpix.npix_of(16),))
    alm = sht.map2alm(torch.from_numpy(maps), lmax=31, iter=2)
    jalm = np.asarray(jsht.map2alm(maps, lmax=31, iter=2))
    assert alm.dtype == torch.complex128
    assert _rel(alm.numpy(), jalm) <= 1e-10
    back = sht.alm2map(alm, 16)
    assert _rel(back.numpy(), np.asarray(jsht.alm2map(jalm, 16))) <= 1e-10


def test_analysis_rejects_aliased_mmax():
    s = sht.SHT(4, 20, 20)
    with pytest.raises(ValueError, match="analysis requires mmax"):
        s.analysis(torch.zeros(healpix.npix_of(4)))


def test_threefloat_split_is_exact():
    rng = np.random.Generator(np.random.SFC64(1))
    a64 = rng.standard_normal((50, 3)) * 10.0 ** rng.integers(-3, 4, (50, 3))
    parts = tools.threefloat_split(a64)
    for got, ref in zip(parts, jtools.threefloat_split(a64)):
        assert got.dtype == np.float32 and np.array_equal(got, ref)
    a, b, c = (p.astype(np.float64) for p in parts)
    assert np.abs(a + b + c - a64).max() <= 1e-14 * np.abs(a64).max()


def test_phase_frac3_and_sincos_turns_match_jax():
    rng = np.random.Generator(np.random.SFC64(2))
    b64 = rng.uniform(-300, 300, (20, 3))
    v64 = rng.standard_normal((64, 3))
    v64 /= np.linalg.norm(v64, axis=1, keepdims=True)
    b3, v3 = tools.threefloat_split(b64), tools.threefloat_split(v64)
    t = tools.phase_frac3(*(torch.from_numpy(p) for p in b3), *(torch.from_numpy(p) for p in v3))
    jt = np.asarray(jtools.phase_frac3(*b3, *v3))
    assert np.abs(t.numpy() - jt).max() <= 1e-6
    exact = b64 @ v64.T
    err = (t.numpy() - exact) - np.round(t.numpy() - exact)
    assert np.abs(err).max() < 1e-6
    c, s_ = tools.sincos_turns(t)
    jc, js_ = jtools.sincos_turns(jnp.asarray(jt))
    assert np.abs(c.numpy() - np.asarray(jc)).max() <= 1e-6
    assert np.abs(s_.numpy() - np.asarray(js_)).max() <= 1e-6
    assert np.abs(c.numpy() - np.cos(2 * np.pi * exact)).max() < 2e-6
    c64, s64 = tools.sincos_turns(t.double())
    # float64 takes the library trig (last-ulp differences between libms)
    assert np.abs(c64.numpy() - np.cos(2 * np.pi * t.double().numpy())).max() <= 1e-15
    assert np.abs(s64.numpy() - np.sin(2 * np.pi * t.double().numpy())).max() <= 1e-15


def test_invert_no_zero():
    x = torch.tensor([0.0, 1e-45, 2.0, -4.0], dtype=torch.float32)
    assert torch.equal(tools.invert_no_zero(x), torch.tensor([0.0, 0.0, 0.5, -0.25]))


def test_twofloat_phase_frac_matches_jax():
    rng = np.random.Generator(np.random.SFC64(12))
    b64 = rng.uniform(-500, 500, (16, 3))
    v64 = rng.standard_normal((40, 3))
    v64 /= np.linalg.norm(v64, axis=1, keepdims=True)
    b2, v2 = tools.twofloat_split(b64), tools.twofloat_split(v64)
    for got, ref in zip(b2, jtools.twofloat_split(b64)):
        assert got.dtype == np.float32 and np.array_equal(got, ref)
    t = tools.phase_frac(*(torch.from_numpy(p) for p in b2), *(torch.from_numpy(p) for p in v2))
    assert np.abs(t.numpy() - np.asarray(jtools.phase_frac(*b2, *v2))).max() <= 1e-6
    err = t.numpy() - b64 @ v64.T
    assert np.abs(err - np.round(err)).max() < 1e-6


def test_padded_layout_is_the_reference(pair):
    s, js = pair
    layout = s.padded_layout()
    assert layout.dtype == np.int64 and np.array_equal(layout, js.padded_layout())
    # every pixel exactly once, padding marked -1
    assert np.array_equal(np.sort(layout[layout >= 0]), np.arange(s.npix))


@pytest.mark.parametrize("raw_belt", [False, True])
@pytest.mark.parametrize("mcut", [None, 20])
def test_ring_analysis_parts_padded_matches_jax(pair, raw_belt, mcut):
    s, js = pair
    layout = s.padded_layout()
    rng = np.random.Generator(np.random.SFC64(7))
    maps = rng.standard_normal((2, 3, s.npix)).astype(np.float32)
    pad = np.where(layout >= 0, maps[..., np.clip(layout, 0, None)], 0.0).astype(np.float32)
    _, _, plan = s.tables("cpu", torch.float32)
    F_belt, group_F = s._ring_analysis_parts_padded(torch.from_numpy(pad), plan, raw_belt=raw_belt, mcut=mcut)
    # the reference truncates a phased belt's coefficients but not its phase
    # weight, and raises; the port truncates both, which the comparison
    # with its own gathered, untruncated coefficients below holds
    if raw_belt or mcut is None:
        jF_belt, jgroup_F = js._ring_analysis_parts_padded(
            pad, raw_belt=raw_belt, plan=js.precompute_ring_plan_streamed(), mcut=mcut
        )
        assert len(group_F) == len(jgroup_F)
        for got, want in zip((F_belt, *group_F), (jF_belt, *jgroup_F)):
            want = np.asarray(want)
            assert got.shape == want.shape and got.dtype == torch.complex64
            assert _rel(got.numpy(), want) <= TOL32
    # the padded layout gives the gathered layout's coefficients
    ref = s._ring_analysis_parts(torch.from_numpy(maps), plan, raw_belt=raw_belt)
    for got, want in zip((F_belt, *group_F), (ref[0], *ref[1])):
        assert got.shape[-1] == (mcut or s.mmax + 1)
        assert _rel(got.numpy(), want[..., : got.shape[-1]].numpy()) <= 1e-6


@pytest.fixture(scope="module")
def shts():
    return {nside: sht.SHT(nside) for nside in (8, 16, 32)}


def _dense_belt(s, belt, raw_belt, ncol):
    """The belt's coefficients by the dense DFT factors (:meth:`SHT._belt_dft`)
    in the belt's precision, times the phase weight unless ``raw_belt``."""
    Wr, Wi = (w[:, :ncol] for w in s._belt_dft(belt.dtype, "cpu"))
    F = torch.complex(belt @ Wr, belt @ Wi)
    if raw_belt:
        return F
    pr, pi = (p[:, :ncol] for p in s.belt_phase_weight(belt.dtype, "cpu"))
    return F * torch.complex(pr, pi)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layout", ["gathered", "padded"])
@pytest.mark.parametrize("raw_belt", [False, True])
@pytest.mark.parametrize("mcut", [None, 20, "mmax"])
@pytest.mark.parametrize("nside", [8, 16, 32])
def test_belt_fft_matches_the_dense_belt_dft(shts, nside, mcut, raw_belt, layout, dtype):
    """The belt's coefficients by one real FFT against the dense DFT factors,
    the columns above nphi/2 (mirrored from the half spectrum) included:
    float64 within 1e-12, float32 within TOL32.  The maps' leading batch is
    not contiguous; gathered from HEALPix order or in the padded layout, the
    coefficients come out as one contiguous [..., nbelt, ncol] tensor of the
    maps' precision, in one FFT."""
    s = shts[nside]
    mcut = s.mmax if mcut == "mmax" else mcut
    ncol = len(range(s.mmax + 1)[:mcut])
    half = s._belt_nphi // 2
    # columns above nphi/2 at every mcut but 20 at nside 16 and 32
    assert (ncol > half + 1) == (mcut != 20 or nside == 8)
    rng = np.random.Generator(np.random.SFC64(nside))
    maps = torch.from_numpy(rng.standard_normal((3, 2, s.npix))).to(dtype).transpose(0, 1)
    belt = maps[..., s._belt_off : s._belt_off + s._belt_len].reshape(2, 3, len(s._belt_rings), s._belt_nphi)
    sht.reset_belt_ffts()
    if layout == "gathered":
        F = s._belt_coefficients(belt, raw_belt, mcut)
    else:
        lay = s.padded_layout()
        pad = torch.where(torch.from_numpy(lay >= 0), maps[..., np.clip(lay, 0, None)], 0.0)
        pad = pad.transpose(0, 1).contiguous().transpose(0, 1)
        assert not pad.is_contiguous()
        F = s._ring_analysis_parts_padded(pad, s.precompute_ring_plan(dtype, "cpu"), raw_belt, mcut)[0]
    assert sht.belt_ffts == 1
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    assert F.shape == (2, 3, len(s._belt_rings), ncol) and F.dtype == cdt and F.is_contiguous()
    want = _dense_belt(s, belt.contiguous(), raw_belt, ncol)
    tol = 1e-12 if dtype == torch.float64 else TOL32
    assert _rel(F.numpy(), want.numpy()) <= tol
    if ncol > half + 1:
        assert _rel(F[..., half + 1 :].numpy(), want[..., half + 1 :].numpy()) <= tol


def test_analysis_padded_and_complex_analysis_match_jax(pair):
    s, js = pair
    rng = np.random.Generator(np.random.SFC64(9))
    maps = (rng.standard_normal((2, s.npix)) + 1j * rng.standard_normal((2, s.npix))).astype(np.complex64)
    pos, neg = s.analysis_complex(torch.from_numpy(maps))
    jpos, jneg = js.analysis_complex(maps)
    assert pos.dtype == torch.complex64
    assert _rel(pos.numpy(), np.asarray(jpos)) <= TOL32
    assert _rel(neg.numpy(), np.asarray(jneg)) <= TOL32
    rpos, rneg = s.analysis_complex(torch.from_numpy(maps.real.copy()))
    jrpos, jrneg = js.analysis_complex(maps.real)
    assert _rel(rpos.numpy(), np.asarray(jrpos)) <= TOL32 and _rel(rneg.numpy(), np.asarray(jrneg)) <= TOL32

    layout = s.padded_layout()
    pad = np.where(layout >= 0, maps.real[..., np.clip(layout, 0, None)], 0.0).astype(np.float32)
    lam, lam_lo, plan = s.tables("cpu", torch.float32)
    got = s.analysis_padded(torch.from_numpy(pad), lam, plan, lam_lo)
    jlam = js.precompute_legendre_split(jnp.float32)
    want = np.asarray(js.analysis_padded(pad, jlam, plan=js.precompute_ring_plan_streamed()))
    assert _rel(got.numpy(), want) <= TOL32


def test_sphtrans_sky_and_inverse_match_jax():
    rng = np.random.Generator(np.random.SFC64(10))
    sky = rng.standard_normal((2, 1, healpix.npix_of(16))).astype(np.float32)
    alm = sht.sphtrans_sky(sky, lmax=47, device="cpu")
    jalm = np.asarray(jsht.sphtrans_sky(sky, lmax=47))
    assert alm.shape == jalm.shape and _rel(alm.numpy(), jalm) <= TOL32
    back = sht.sphtrans_inv_sky(alm, 16)
    assert _rel(back.numpy(), np.asarray(jsht.sphtrans_inv_sky(jalm.astype(np.complex64), 16))) <= TOL32


@pytest.fixture(scope="module")
def window_pair(pair):
    from draco_tpu.ops.sht_window import WindowedSHT as JWindowedSHT
    from draco_tpu_torch.ops.sht_window import WindowedSHT

    s, js = pair
    vec = healpix.pix2vec(16)
    centre = np.array([0.5, 0.0, np.sqrt(0.75)])
    support = np.exp(-((vec - centre) ** 2).sum(axis=1) / (2 * 0.15**2))
    return WindowedSHT(s, support, tau=1e-6, margin=4), JWindowedSHT(js, support, tau=1e-6, margin=4)


def test_window_box_layout_is_the_reference(window_pair):
    win, jwin = window_pair
    assert np.array_equal(win.window_index, jwin.window_index)
    Ec, Es, lam = win.rect_tables(torch.float32, "cpu")
    assert _rel(Ec.numpy(), np.asarray(jwin._Ec)) <= TOL32 and _rel(Es.numpy(), np.asarray(jwin._Es)) <= TOL32
    assert _rel(lam.numpy(), np.asarray(jwin._ensure_lam())) <= TOL32


def test_windowed_analysis_matches_jax(window_pair):
    win, jwin = window_pair
    rng = np.random.Generator(np.random.SFC64(13))
    full = rng.standard_normal((2, 3, healpix.npix_of(16))).astype(np.float32)
    x = win.gather(torch.from_numpy(full))
    assert np.array_equal(x.numpy(), np.asarray(jwin.gather(full)))
    assert _rel(win.analysis(x).numpy(), np.asarray(jwin.analysis(x.numpy()))) <= TOL32
    z = torch.complex(x[0], x[1])
    assert _rel(win.analysis(z).numpy(), np.asarray(jwin.analysis(z.numpy()))) <= TOL32
    a, b = win.analysis_pair(x[0], x[1])
    ja, jb = jwin.analysis_pair(x[0].numpy(), x[1].numpy())
    assert _rel(a.numpy(), np.asarray(ja)) <= TOL32 and _rel(b.numpy(), np.asarray(jb)) <= TOL32
