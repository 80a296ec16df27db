"""Full-sphere (cylinder) fused round trip: draco_tpu_torch against draco_tpu.

Three telescopes whose beams are too wide for the compact window: the
unpolarised cylinder of ``tests/test_roundtrip.py``, a dual-pol cylinder
whose stacked products share their geometry (so both packages take the
geometry dedup), and an unpolarised cylinder on a non-uniform frequency
grid.  The port's program runs on its own prepared state and, through
``state_from_numpy``, on the JAX program's own constants.

Tolerances, max|diff| / max|ref|: float32 against float32 2e-5; chunk
invariance and float32 against float64, 1e-5 (the accuracy contract).
"""

import numpy as np
import pytest
import torch

import draco_tpu.telescope.roundtrip as jrt
from draco_tpu.telescope import BeamTransfer as JBeamTransfer
from draco_tpu.telescope import PolarisedCylinderTelescope as JPolCylinder
from draco_tpu.telescope import UnpolarisedCylinderTelescope as JCylinder
from draco_tpu_torch import device as tdevice
from draco_tpu_torch.ops import sht
from draco_tpu_torch.telescope import BeamTransfer, PolarisedCylinderTelescope, UnpolarisedCylinderTelescope
from draco_tpu_torch.telescope import roundtrip

TOL32 = 2e-5
NSIDE = 16
CHUNK = 4
CPU = torch.device("cpu")
LMAX = dict(force_lmax=3 * NSIDE - 1, force_mmax=3 * NSIDE - 1)
F0 = 299.792458 / 0.6
CONFIGS = {
    "cylinder": (
        JCylinder, UnpolarisedCylinderTelescope,
        dict(num_cylinders=2, cylinder_width=10.0, cylinder_spacing=12.0, num_feeds=3, feed_spacing=2.0,
             latitude=45.0, freq_lower=400.0, freq_upper=500.0, num_freq=2, auto_correlations=True, **LMAX),
    ),
    "dualpol": (
        JPolCylinder, PolarisedCylinderTelescope,
        dict(num_cylinders=2, cylinder_width=20.0, cylinder_spacing=22.0, num_feeds=3, feed_spacing=0.5,
             latitude=49.0, freq_lower=F0, freq_upper=F0, num_freq=1, auto_correlations=True, **LMAX),
    ),
    "nonuniform": (
        JCylinder, UnpolarisedCylinderTelescope,
        dict(num_cylinders=2, cylinder_width=10.0, cylinder_spacing=12.0, num_feeds=2, feed_spacing=3.0,
             latitude=45.0, freq_lower=400.0, freq_upper=487.0, num_freq=3, auto_correlations=True, **LMAX),
    ),
}
IRREGULAR = np.array([400.0, 431.0, 487.0])

_CONST_NAMES = (
    "lam", "lam_lo", "plan", "pw", "va", "vb", "vc", "u_re", "u_im", "uidx_pad",
    "bla", "blb", "blc", "ga", "gb", "gc", "g0s", "lidx",
)


def _irregular(cls):
    class Irregular(cls):
        @property
        def frequencies(self):
            return IRREGULAR

    return Irregular


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


def telescopes(name):
    jcls, tcls, cfg = CONFIGS[name]
    if name == "nonuniform":
        jcls, tcls = _irregular(jcls), _irregular(tcls)
    return jcls(**cfg), tcls(**cfg)


def jax_run(jbt, chunk):
    """The JAX full-sphere program's run and its prepared constants, as numpy."""
    seen = {}
    make_run = jrt._make_run

    def spy(program, consts, dims, s, *args, **kwargs):
        seen.update(program=program, consts=consts, dims=dims, s=s, kwargs=kwargs)
        return make_run(program, consts, dims, s, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrt, "_make_run", spy)
        run = jrt.fused_roundtrip_fn(jbt, chunk=chunk)
    assert seen["program"] is jrt._fused_roundtrip_fullsphere
    consts = dict(zip(_CONST_NAMES, (_tree_numpy(c) for c in seen["consts"])))
    consts.update(
        dims=seen["dims"], order=seen["kwargs"].get("order"), uniform_freq=seen["kwargs"]["uniform_freq"],
        nside=seen["s"].nside, lmax=seen["s"].lmax,
    )
    return run, consts


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    name = request.param
    jtel, tel = telescopes(name)
    jbt = JBeamTransfer(telescope=jtel, nside=NSIDE)
    bt = BeamTransfer(tel, nside=NSIDE)
    assert jbt._beam_window() is None and bt._beam_window() is None
    rng = np.random.Generator(np.random.SFC64(21))
    sky = rng.standard_normal((jtel.nfreq, jtel.num_pol_sky, 12 * NSIDE**2)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (jtel.mmax + 1, 2, jtel.nfreq, len(jtel.uniquepairs))).astype(np.float32)
    run, consts = jax_run(jbt, CHUNK)
    return dict(
        name=name, jtel=jtel, bt=bt, sky=sky, w=w, consts=consts,
        want=np.asarray(run(sky)), want_w=np.asarray(run(sky, weight=w)),
    )


def test_cases_take_the_paths_they_name(case):
    st = roundtrip.prepare_state(case["bt"], chunk=CHUNK, device=CPU)
    assert st["form"] == "fullsphere"
    Gc = st["dims"][-1]
    assert Gc == case["consts"]["dims"][-1]
    assert (Gc > 0) == (case["name"] == "dualpol")
    assert st["uniform_freq"] == (case["name"] != "nonuniform") == case["consts"]["uniform_freq"]


@pytest.mark.parametrize("weighted", [False, True])
def test_fullsphere_matches_jax(case, weighted):
    w = case["w"] if weighted else None
    got = roundtrip.fused_simulate_to_map(
        case["bt"], torch.from_numpy(case["sky"]), chunk=CHUNK, weight=None if w is None else torch.from_numpy(w)
    )
    want = case["want_w"] if weighted else case["want"]
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL32


def test_port_program_on_jax_fullsphere_constants(case):
    state = roundtrip.state_from_numpy(case["consts"], device=CPU)
    assert state["form"] == "fullsphere"
    sky, w = torch.from_numpy(case["sky"]), torch.from_numpy(case["w"])
    assert _rel(roundtrip.fused_roundtrip(state, sky).numpy(), case["want"]) <= TOL32
    assert _rel(roundtrip.fused_roundtrip(state, sky, w).numpy(), case["want_w"]) <= TOL32


def test_prepared_fullsphere_state_matches_jax_constants(case):
    c = case["consts"]
    st = roundtrip.prepare_state(case["bt"], chunk=CHUNK, device=CPU)
    assert st["dims"] == tuple(c["dims"])
    if c["order"] is None:
        assert st["order"] is None
    else:
        assert np.array_equal(st["order"].numpy(), c["order"])
    for name in ("va", "vb", "vc", "bla", "blb", "blc", "u_re", "u_im"):
        assert np.array_equal(st[name].numpy(), c[name].astype(np.float32)), name
    pw = st["pw"][0].numpy() + 1j * st["pw"][1].numpy()
    assert _rel(pw, c["pw"]) <= TOL32
    if st["dims"][-1]:
        for name in ("ga", "gb", "gc"):
            assert np.array_equal(st[name].numpy(), c[name]), name
        assert st["g0s"] == tuple(int(g) for g in c["g0s"])
        assert np.array_equal(st["lidx"].numpy(), c["lidx"].argmax(axis=-1))


def test_fullsphere_chunk_invariance(case):
    bt, sky = case["bt"], torch.from_numpy(case["sky"])
    a = roundtrip.fused_simulate_to_map(bt, sky, chunk=3)
    b = roundtrip.fused_simulate_to_map(bt, sky, chunk=10)
    assert _rel(a.numpy(), b.numpy()) <= 1e-5


def test_fullsphere_float32_within_contract_of_float64(case):
    bt, sky, w = case["bt"], torch.from_numpy(case["sky"]), torch.from_numpy(case["w"])
    m32 = roundtrip.fused_simulate_to_map(bt, sky, chunk=CHUNK, weight=w)
    m64 = roundtrip.fused_simulate_to_map(bt, sky.double(), chunk=CHUNK, weight=w.double())
    assert m64.dtype == torch.float64
    assert _rel(m32.double().numpy(), m64.numpy()) <= 1e-5


def test_one_channel_belt_reaches_the_contraction_as_a_view():
    """On one channel a chunk's belt coefficients, seen as the U/V
    contraction's [f, M+1, 2C, p*r] (the reshape of
    ``_fused_roundtrip_fullsphere``), share their storage: a copy would move
    them once more a chunk."""
    _, tel = telescopes("dualpol")
    state = roundtrip.prepare_state(BeamTransfer(tel, nside=NSIDE), chunk=CHUNK, device=CPU)
    nfreq, _, chunk, _, _, mmax, _ = state["dims"]
    assert nfreq == 1
    F_belt, _ = roundtrip._fringe_sections(state, 0)
    Fm = F_belt.permute(1, 5, 0, 2, 3, 4).reshape(nfreq, mmax + 1, 2 * chunk, -1)
    assert F_belt.is_contiguous() and Fm._base is F_belt and Fm.data_ptr() == F_belt.data_ptr()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_round_trip_takes_one_belt_fft_a_chunk_and_one_for_the_sky(name):
    _, tel = telescopes(name)
    state = roundtrip.prepare_state(BeamTransfer(tel, nside=NSIDE), chunk=CHUNK, device=CPU)
    sky = torch.from_numpy(
        np.random.Generator(np.random.SFC64(4)).standard_normal((tel.nfreq, tel.num_pol_sky, 12 * NSIDE**2))
    ).float()
    sht.reset_belt_ffts()
    roundtrip.fused_roundtrip(state, sky)
    assert sht.belt_ffts == state["dims"][3] + 1


def test_tiled_matches_full_batch():
    jtel, tel = telescopes("nonuniform")
    bt = BeamTransfer(tel, nside=NSIDE)
    rng = np.random.Generator(np.random.SFC64(5))
    sky = rng.standard_normal((3, 1, 12 * NSIDE**2)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (jtel.mmax + 1, 2, 3, len(jtel.uniquepairs))).astype(np.float32)
    full = roundtrip.fused_simulate_to_map(bt, sky, chunk=CHUNK, weight=w, device=CPU)
    tiled = roundtrip.fused_simulate_to_map_tiled(bt, sky, freq_tile=1, chunk=CHUNK, weight=w, device=CPU)
    assert tiled.shape == full.shape and tiled.device == CPU
    assert _rel(tiled.numpy(), full.numpy()) <= 1e-6
    with pytest.raises(ValueError, match="does not divide"):
        roundtrip.fused_simulate_to_map_tiled(bt, sky, freq_tile=2, chunk=CHUNK, device=CPU)


def test_numpy_sky_gives_the_tensor_sky_map():
    _, tel = telescopes("cylinder")
    bt = BeamTransfer(tel, nside=NSIDE)
    sky = np.random.Generator(np.random.SFC64(8)).standard_normal((2, 1, 12 * NSIDE**2))
    from_tensor = roundtrip.fused_simulate_to_map(bt, torch.from_numpy(sky.astype(np.float32)), chunk=CHUNK)
    from_numpy = roundtrip.fused_simulate_to_map(bt, sky.astype(np.float32), chunk=CHUNK, device="cpu")
    assert from_numpy.dtype == torch.float32 and from_numpy.device == CPU
    assert torch.equal(from_numpy, from_tensor)
    # float64 stays float64; any other type runs in float32
    assert roundtrip.fused_simulate_to_map(bt, sky, chunk=CHUNK, device="cpu").dtype == torch.float64
    half = roundtrip.fused_simulate_to_map(bt, sky.astype(np.float16), chunk=CHUNK, device="cpu")
    assert half.dtype == torch.float32


def test_entry_points_without_a_device_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tel = telescopes("cylinder")
    bt = BeamTransfer(tel, nside=NSIDE)
    sky = np.zeros((2, 1, 12 * NSIDE**2), np.float32)
    for call in (
        lambda: tdevice.resolve(),
        lambda: roundtrip.prepare_state(bt, chunk=CHUNK),
        lambda: roundtrip.fused_roundtrip_fn(bt, chunk=CHUNK),
        lambda: roundtrip.fused_simulate_to_map(bt, sky, chunk=CHUNK),
        lambda: bt._beam_fringe_maps(0),
        lambda: bt._streaming_ops2(),
        lambda: bt.generate(),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert tdevice.resolve("cpu") == CPU
    assert tdevice.resolve("cuda:1") == torch.device("cuda", 1)
