"""Fused simulate -> map round trip: draco_tpu_torch against draco_tpu.

The port's program runs both on its own prepared state and, through
``state_from_numpy``, on the JAX program's own constants, which tells
"the constants differ" apart from "the program differs".

Tolerances: float32 against float32, max|diff| / max|ref| <= 2e-5; the
port's float32 run against its float64 run, 1e-5 (the accuracy contract).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import draco_tpu.telescope.roundtrip as jrt
from draco_tpu.telescope import BeamTransfer as JBeamTransfer
from draco_tpu.telescope import UnpolarisedDishArray as JDishArray
from draco_tpu_torch.ops import sht
from draco_tpu_torch.telescope import BeamTransfer, UnpolarisedDishArray
from draco_tpu_torch.telescope import roundtrip

TOL32 = 2e-5
NSIDE = 16
CHUNK = 4
CONFIG = dict(
    grid_ew=2, grid_ns=2, spacing_ew=4.0, spacing_ns=4.0, latitude=30.0,
    freq_lower=400.0, freq_upper=500.0, num_freq=2, dish_width=8.0,
    auto_correlations=True, force_lmax=3 * NSIDE - 1, force_mmax=3 * NSIDE - 1,
)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _tree_numpy(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _tree_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree_numpy(v) for v in x]
    return np.asarray(x)


_CONST_NAMES = (
    "lam", "lam_lo", "plan", "lam_band", "band_lo", "Ecf", "Esf", "flat_ring",
    "ring_onehot", "va", "vb", "vc", "u_re", "u_im", "uidx_pad", "bla", "blb", "blc",
)


def jax_consts(jbt, chunk):
    """The JAX fused program's prepared constants, as numpy, plus its run."""
    seen = {}
    make_run = jrt._make_run

    def spy(program, consts, dims, s, *args, **kwargs):
        seen.update(consts=consts, dims=dims, s=s, kwargs=kwargs)
        return make_run(program, consts, dims, s, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrt, "_make_run", spy)
        run = jrt.fused_roundtrip_fn(jbt, chunk=chunk)
    out = dict(zip(_CONST_NAMES, (_tree_numpy(c) for c in seen["consts"])))
    out.update(
        dims=seen["dims"],
        order=seen["kwargs"].get("order"),
        uniform_freq=seen["kwargs"]["uniform_freq"],
        nside=seen["s"].nside,
        lmax=seen["s"].lmax,
    )
    return out, run


@pytest.fixture(scope="module")
def setup():
    jtel = JDishArray(**CONFIG)
    jbt = JBeamTransfer(telescope=jtel, nside=NSIDE)
    bt = BeamTransfer(UnpolarisedDishArray(**CONFIG), nside=NSIDE)
    assert bt._beam_window() is not None and jbt._beam_window() is not None
    rng = np.random.Generator(np.random.SFC64(11))
    sky = rng.standard_normal((jtel.nfreq, 1, 12 * NSIDE**2)).astype(np.float32)
    nbase = len(jtel.uniquepairs)
    w = rng.uniform(0.2, 2.0, (jtel.mmax + 1, 2, jtel.nfreq, nbase)).astype(np.float32)
    consts, run = jax_consts(jbt, CHUNK)
    want = np.asarray(run(sky))
    want_w = np.asarray(run(sky, weight=w))
    return dict(bt=bt, sky=sky, w=w, consts=consts, want=want, want_w=want_w)


@pytest.mark.parametrize("weighted", [False, True])
def test_fused_matches_jax(setup, weighted):
    w = setup["w"] if weighted else None
    got = roundtrip.fused_simulate_to_map(
        setup["bt"], torch.from_numpy(setup["sky"]), chunk=CHUNK,
        weight=None if w is None else torch.from_numpy(w),
    )
    want = setup["want_w"] if weighted else setup["want"]
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL32


@pytest.mark.parametrize("weighted", [False, True])
def test_port_program_on_jax_constants(setup, weighted):
    state = roundtrip.state_from_numpy(setup["consts"], device="cpu")
    w = torch.from_numpy(setup["w"]) if weighted else None
    got = roundtrip.fused_roundtrip(state, torch.from_numpy(setup["sky"]), w)
    want = setup["want_w"] if weighted else setup["want"]
    assert _rel(got.numpy(), want) <= TOL32


def test_prepared_state_matches_jax_constants(setup):
    c = setup["consts"]
    st = roundtrip.prepare_state(setup["bt"], chunk=CHUNK, device="cpu")
    assert st["form"] == "windowed" and st["va"].device == torch.device("cpu")
    assert st["dims"] == tuple(c["dims"])
    assert np.array_equal(st["order"].numpy(), c["order"])
    assert st["uniform_freq"] == c["uniform_freq"]
    for name in ("Ecf", "Esf", "ring_onehot", "va", "vb", "vc", "bla", "blb", "blc", "u_re", "u_im"):
        assert np.array_equal(st[name].numpy(), c[name].astype(np.float32)), name
    assert np.array_equal(st["flat_ring"].numpy(), c["flat_ring"])
    assert _rel(st["lam_band"].numpy(), c["lam_band"]) <= TOL32
    assert _rel(st["band_lo"].float().numpy(), c["band_lo"].astype(np.float32)) <= TOL32


def test_chunk_invariance_and_weight_scaling(setup):
    bt, sky = setup["bt"], torch.from_numpy(setup["sky"])
    a = roundtrip.fused_simulate_to_map(bt, sky, chunk=3)
    b = roundtrip.fused_simulate_to_map(bt, sky, chunk=10)
    assert _rel(a.numpy(), b.numpy()) <= 1e-5
    half = torch.full_like(torch.from_numpy(setup["w"]), 0.5)
    c = roundtrip.fused_simulate_to_map(bt, sky, chunk=3, weight=half)
    assert _rel(c.numpy(), 0.5 * a.numpy()) <= 1e-6


def test_float32_within_contract_of_float64(setup):
    bt, sky = setup["bt"], torch.from_numpy(setup["sky"])
    m32 = roundtrip.fused_simulate_to_map(bt, sky, chunk=CHUNK)
    m64 = roundtrip.fused_simulate_to_map(bt, sky.double(), chunk=CHUNK)
    assert m64.dtype == torch.float64
    assert _rel(m32.double().numpy(), m64.numpy()) <= 1e-5


def test_windowed_round_trip_takes_one_belt_fft_for_the_sky():
    """The windowed form analyses only the sky (its chunks contract per-pixel
    factors): one belt FFT a call, whatever the number of chunks."""
    st = roundtrip.prepare_state(BeamTransfer(UnpolarisedDishArray(**CONFIG), nside=NSIDE), chunk=CHUNK, device="cpu")
    assert st["form"] == "windowed" and st["dims"][3] > 1
    sky = torch.from_numpy(np.random.Generator(np.random.SFC64(3)).standard_normal((2, 1, 12 * NSIDE**2))).float()
    sht.reset_belt_ffts()
    roundtrip.fused_roundtrip(st, sky)
    assert sht.belt_ffts == 1


def test_beam_fringe_maps_match_jax():
    jbt = JBeamTransfer(telescope=JDishArray(**CONFIG), nside=NSIDE)
    bt = BeamTransfer(UnpolarisedDishArray(**CONFIG), nside=NSIDE)
    for fi in range(2):
        got = bt._beam_fringe_maps(fi, pair_sel=slice(1, 7), device="cpu")
        want = np.asarray(jbt._beam_fringe_maps(fi, pair_sel=slice(1, 7)))
        assert got.dtype == torch.complex64 and got.shape == want.shape
        assert _rel(got.numpy(), want) <= TOL32


def _pol_dishes(base):
    """Four dual-pol dishes (X feeds then Y feeds): ``tests/test_roundtrip.py``'s
    ``polarised_setup``, npol_sky = 4 with four beamclass-pair products."""

    class PolDishes(base):
        @property
        def feedpositions(self):
            xy = np.array([[0.0, 0.0], [5.0, 1.0], [1.0, 6.0], [6.0, 5.5]])
            return np.concatenate([xy, xy], axis=0)

        @property
        def beamclass(self):
            return np.array([0, 0, 0, 0, 1, 1, 1, 1])

    return PolDishes(
        latitude=30.0, freq_lower=400.0, freq_upper=500.0, num_freq=2, dish_width=8.0,
        auto_correlations=True, force_lmax=3 * NSIDE - 1, force_mmax=3 * NSIDE - 1,
    )


@pytest.mark.parametrize("weighted", [False, True])
def test_windowed_polarised_dishes_match_jax(weighted):
    from draco_tpu.telescope import SimplePolarisedTelescope as JPolarised
    from draco_tpu_torch.telescope import SimplePolarisedTelescope

    jtel = _pol_dishes(JPolarised)
    jbt = JBeamTransfer(telescope=jtel, nside=NSIDE)
    bt = BeamTransfer(_pol_dishes(SimplePolarisedTelescope), nside=NSIDE)
    assert bt._beam_window() is not None and jtel.num_pol_sky == 4
    rng = np.random.Generator(np.random.SFC64(31))
    sky = rng.standard_normal((jtel.nfreq, 4, 12 * NSIDE**2)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (jtel.mmax + 1, 2, jtel.nfreq, len(jtel.uniquepairs))).astype(np.float32)
    w = w if weighted else None
    want = np.asarray(jrt.fused_simulate_to_map(jbt, sky, chunk=7, weight=w))
    got = roundtrip.fused_simulate_to_map(bt, sky, chunk=7, weight=w, device="cpu")
    assert not roundtrip.prepare_state(bt, chunk=7, device="cpu")["uniform_real"]
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL32


# -- the windowed form's automatic baseline-chunk plan ----------------------


def _dish64_m_cut():
    """dish64's sorted m-support profile (2017 baselines, nside 256, the
    benchmark's 8 channels; the telescope built from the cell's
    configuration file as the benchmark builds it): ``prepare_state``'s own
    ``m_cut``."""
    from portbench.drivers.fused import program_telescope

    _, bt = program_telescope(json.loads((Path(__file__).parents[1] / "portbench/configs/dish64.json").read_text()))
    return np.sort(roundtrip._m_cut(bt, bt._beam_window()))


def _plan_profile(case):
    """(m_cut sorted, mmax, budget rows) of a plan case."""
    rng = np.random.Generator(np.random.SFC64(5))
    if case == "dish64":
        return _dish64_m_cut(), 767, 2001
    nbase, rows, shape = case
    mmax = 767
    u = np.sort(rng.uniform(0, 1, nbase))
    m = {"ramp": 20 + 700 * u, "sqrt": 40 + 720 * np.sqrt(u), "flat": np.full(nbase, mmax + 1.0),
         "steps": np.where(u < 0.9, 100, 600) + 10 * u}[shape]
    return np.minimum(m.astype(int), mmax + 1), mmax, rows


PLAN_CASES = [
    "dish64", (1000, 300, "ramp"), (5000, 700, "sqrt"), (2017, 2001, "flat"), (7155, 27, "ramp"),
    (130, 64, "steps"), (40, 100, "sqrt"), (3000, 3000, "steps"),
]


def _old_chunk(nbase, rows):
    """The automatic chunk before the plan: the budget's rows, at least 64,
    rounded up to 8, with the last chunk padded out."""
    return (max(64, min(rows, nbase)) + 7) // 8 * 8


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_windowed_plan_invariants(case, monkeypatch):
    m, mmax, rows = _plan_profile(case)
    nbase = len(m)
    monkeypatch.setattr(roundtrip, "CHUNK_BUDGET_BYTES", 16 * rows)
    first = roundtrip._auto_chunk(nbase, 1, 1, 1)
    chunk = roundtrip._windowed_chunk(m, first, mmax)
    nchunk = -(-nbase // chunk)
    # no chunk is wholly padding, and fewer than 8 rows a chunk are
    assert (nchunk - 1) * chunk < nbase and nchunk * chunk - nbase < 8 * nchunk
    # every chunk's columns hold its rows' m-support
    for c0, c1, mb in roundtrip._chunk_groups(m, nchunk, chunk, mmax):
        assert mb >= min(int(m[: min(c1 * chunk, nbase)].max()) + 1, mmax + 1)
    work = roundtrip._plan_work(m, chunk, mmax)
    assert work <= roundtrip._plan_work(m, _old_chunk(nbase, rows), mmax)
    assert chunk <= _old_chunk(nbase, rows) and -(-nbase // first) == -(-nbase // _old_chunk(nbase, rows))
    # the least work among the balanced splits 1, 2, 4, ... of the first
    # plan's chunks down to the floor; ties go to fewer chunks
    n, cands = -(-nbase // first), [first]
    while n < nbase and (c := (-(-nbase // (n := 2 * n)) + 7) // 8 * 8) >= roundtrip.MIN_PLAN_ROWS:
        cands.append(c)
    works = [roundtrip._plan_work(m, c, mmax) for c in cands]
    assert work == min(works) and chunk == cands[works.index(work)]


def test_dish64_plan():
    """dish64 at 8 channels: the budget's 2001 rows balanced into 2 x 1016
    (the plan before padded 2017 rows to 2 x 2008), then split into 4 x 512,
    the least work down to the floor of 512 rows."""
    m = _dish64_m_cut()
    Kf = 16768
    assert len(m) == 2017 and roundtrip._auto_chunk(2017, 8, 1, Kf) == 1016
    assert roundtrip._plan_work(m, 2008, 767) == 2_827_264
    assert roundtrip._chunk_groups(m, 2, 1016, 767) == ((0, 1, 384), (1, 2, 768))
    assert roundtrip._plan_work(m, 1016, 767) == 1_170_432
    assert roundtrip._windowed_chunk(m, 1016, 767) == 512
    assert roundtrip._chunk_groups(m, 4, 512, 767) == ((0, 1, 256), (1, 2, 384), (2, 3, 512), (3, 4, 768))
    assert roundtrip._plan_work(m, 512, 767) == 983_040
    # one channel: one chunk of 2024 rows (1,554,432), split alike
    assert roundtrip._windowed_chunk(m, roundtrip._auto_chunk(2017, 1, 1, Kf), 767) == 512


@pytest.mark.parametrize(
    "shape, want",
    [((7155, 1, 4, 3 * 802434), (64, 112)), ((2017, 8, 1, 16768), (1016, 2)), ((2017, 1, 1, 16768), (2024, 1)),
     ((10, 2, 1, 128), (16, 1))],
    ids=["chime2048", "dish64-8ch", "dish64-1ch", "small"],
)
def test_auto_chunk_balances_the_budget(shape, want):
    """CHIME's full-sphere chunk stays 64 rows in 112 chunks, as before the
    plan; the dish's budget rows are balanced over the same chunk count."""
    chunk = roundtrip._auto_chunk(*shape)
    assert (chunk, -(-shape[0] // chunk)) == want


def _jittered_dishes(nside, telescope=UnpolarisedDishArray, beamtransfer=BeamTransfer):
    """A 3 x 3 jittered dish array whose short baselines need fewer m-columns
    than mmax + 1 at nside 64, so the m-support groups truncate; the port's,
    or the JAX package's with its classes."""
    return beamtransfer(
        telescope=telescope(
            grid_ew=3, grid_ns=3, spacing_ew=6.0, spacing_ns=6.0, jitter=1.0, jitter_seed=1, latitude=30.0,
            freq_lower=400.0, freq_upper=500.0, num_freq=2, dish_width=4.0, auto_correlations=True,
            force_lmax=3 * nside - 1, force_mmax=3 * nside - 1,
        ),
        nside=nside,
    )


@pytest.fixture(scope="module")
def plans64():
    """float64 maps of the 3 x 3 array at nside 64 under the automatic plan,
    two explicit chunks, a finer automatic plan (the floor lowered to 8
    rows) and the untruncated plan, unweighted and weighted."""
    bt = _jittered_dishes(64)
    rng = np.random.Generator(np.random.SFC64(23))
    nbase = len(bt.telescope.uniquepairs)
    sky = torch.from_numpy(rng.standard_normal((2, 1, 12 * 64**2)))
    w = torch.from_numpy(rng.uniform(0.2, 2.0, (192, 2, 2, nbase)))
    states = {c: roundtrip.prepare_state(bt, chunk=c, dtype=torch.float64, device="cpu") for c in (None, 4, 8)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(roundtrip, "MIN_PLAN_ROWS", 8)
        states["finer"] = roundtrip.prepare_state(bt, dtype=torch.float64, device="cpu")
    full = dict(states[4])
    full["dims"] = full["dims"][:-1] + (((0, full["dims"][3], 192),),)
    states["untruncated"] = full
    maps = {(k, wt): roundtrip.fused_roundtrip(st, sky, w if wt else None).numpy()
            for k, st in states.items() for wt in (False, True)}
    return states, maps, sky, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("plan", [None, 4, 8, "finer"])
def test_m_support_plans_match_the_untruncated_map(plans64, plan, weighted):
    states, maps, _, _ = plans64
    assert any(mb < 192 for _, _, mb in states[4]["dims"][-1])
    assert _rel(maps[(plan, weighted)], maps[("untruncated", weighted)]) <= 1e-12


def test_finer_automatic_plan_truncates(plans64):
    """With the floor lowered, the 3 x 3 array's automatic plan splits its one
    chunk where that cuts the planned work, and narrows the first chunk."""
    states, _, _, _ = plans64
    auto, finer = states[None]["dims"], states["finer"]["dims"]
    assert (auto[2], auto[3], auto[-1]) == (40, 1, ((0, 1, 192),))
    assert finer[3] > 1 and finer[-1][0][2] < 192
    bt = _jittered_dishes(64)
    m = np.sort(roundtrip._m_cut(bt, bt._beam_window()))
    assert roundtrip._plan_work(m, finer[2], 191) < roundtrip._plan_work(m, auto[2], 191)


@pytest.mark.parametrize("weighted", [False, True])
def test_finer_automatic_plan_matches_jax(plans64, weighted):
    """The finer automatic plan (several chunks, the first narrower than
    mmax + 1) is JAX's layout at the same explicit chunk, and its map is the
    JAX package's at that chunk on the same float32 inputs."""
    states, maps, sky, w = plans64
    finer = states["finer"]["dims"]
    jbt = _jittered_dishes(64, JDishArray, JBeamTransfer)
    consts, run = jax_consts(jbt, finer[2])
    assert tuple(consts["dims"]) == finer and finer[3] > 1 and finer[-1][0][2] < 192
    want = np.asarray(run(sky.float().numpy(), weight=w.float().numpy() if weighted else None))
    assert _rel(maps[("finer", weighted)], want) <= TOL32


def test_windowed_gemm_work_counts_the_plan_once_a_call():
    st = roundtrip.prepare_state(BeamTransfer(UnpolarisedDishArray(**CONFIG), nside=NSIDE), chunk=CHUNK, device="cpu")
    chunk, groups = st["dims"][2], st["dims"][-1]
    sky = torch.from_numpy(np.random.Generator(np.random.SFC64(4)).standard_normal((2, 1, 12 * NSIDE**2))).float()
    roundtrip.reset_windowed_gemm_work()
    roundtrip.fused_roundtrip(st, sky)
    roundtrip.fused_roundtrip(st, sky)
    assert roundtrip.windowed_gemm_work == 2 * sum((c1 - c0) * chunk * mb for c0, c1, mb in groups) == 2 * 8 * 48
