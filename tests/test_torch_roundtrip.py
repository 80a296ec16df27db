"""Fused simulate -> map round trip: draco_tpu_torch against draco_tpu.

The port's program runs both on its own prepared state and, through
``state_from_numpy``, on the JAX program's own constants, which tells
"the constants differ" apart from "the program differs".

Tolerances: float32 against float32, max|diff| / max|ref| <= 2e-5; the
port's float32 run against its float64 run, 1e-5 (the accuracy contract).
"""

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
