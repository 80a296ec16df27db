"""The main path's tasks: draco_tpu_torch against draco_tpu on the same inputs.

Each task of the slice runs in both packages on the same seeded numpy
inputs, at the size of ``tests/test_endtoend.py`` (2 x 2 dishes, lmax 23,
2 frequencies), the port on the CPU.  Then the whole chain, sky ->
simulated day -> time stream -> sidereal regrid -> m-modes -> dirty map,
runs through both packages' pipeline Managers from one config.

Tolerances, max|diff| / max|ref| unless stated: 2e-5 (float32 against
the JAX package, which runs these tests with 64-bit types on); exact for
the product expansion; the ML map re-projected through the beam transfer
within 1e-4.
"""

import pickle

import numpy as np
import pytest
import torch

from draco_tpu.analysis import mapmaker as jmapmaker
from draco_tpu.analysis import sidereal as jsidereal
from draco_tpu.analysis import transform as jtransform
from draco_tpu.core import config as jconfig
from draco_tpu.core import containers as jcontainers
from draco_tpu.core import task as jtask
from draco_tpu.core.pipeline import Manager as JManager
from draco_tpu.synthesis import stream as jstream
from draco_tpu.telescope import BeamTransfer as JBeamTransfer
from draco_tpu.telescope import UnpolarisedDishArray as JDishArray
from draco_tpu.telescope import roundtrip as jroundtrip
from draco_tpu_torch.analysis import mapmaker, sidereal, transform
from draco_tpu_torch.core import config, containers, task
from draco_tpu_torch.core.pipeline import Manager
from draco_tpu_torch.device import default_device
from draco_tpu_torch.synthesis import stream
from draco_tpu_torch.telescope import BeamTransfer, UnpolarisedDishArray, roundtrip

TOL = 2e-5
TOL_ML = 1e-4
CONFIG = dict(
    grid_ew=2, grid_ns=2, spacing_ew=5.0, spacing_ns=5.0, latitude=40.0, freq_lower=400.0,
    freq_upper=420.0, num_freq=2, dish_width=5.0, auto_correlations=True, force_lmax=23, force_mmax=23,
)
LSD = 8000  # the simulated sidereal day
SKY_SEED = 99


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _run(task_obj, params, setup=(), *inputs):
    task_obj.read_config(params)
    if setup is not None:
        task_obj.setup(*setup)
    return task_obj.process(*inputs)


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def setup(on_cpu):
    jtel = JDishArray(**CONFIG)
    jbt = JBeamTransfer(telescope=jtel).generate()
    tel = UnpolarisedDishArray(**CONFIG)
    bt = BeamTransfer(tel).generate(device="cpu")
    nside = jbt.beam_nside
    sky = _sky(SKY_SEED, nside, len(jtel.frequencies))
    jmap = jcontainers.Map(nside=nside, polarisation=False, freq=jtel.frequencies)
    jmap.map[:] = sky
    tmap = containers.Map(nside=nside, polarisation=False, freq=tel.frequencies)
    tmap.map[:] = sky
    return dict(jtel=jtel, jbt=jbt, tel=tel, bt=bt, jmap=jmap, tmap=tmap, nside=nside)


def _sky(seed, nside, nfreq):
    rng = np.random.Generator(np.random.SFC64(seed))
    return rng.standard_normal((nfreq, 1, 12 * nside**2))


@pytest.fixture(scope="module")
def streams(setup):
    """The simulated sidereal stream of both packages (batched projection)."""
    s = setup
    js = _run(jstream.SimulateSidereal(), {}, (s["jbt"],), s["jmap"])
    ts = _run(stream.SimulateSidereal(), {}, (s["bt"],), s["tmap"])
    return js, ts


@pytest.mark.parametrize(
    "params", [{}, {"streaming": True, "baseline_chunk": 3}, {"fast_ra": True}], ids=["batched", "streaming", "fast_ra"]
)
def test_simulate_sidereal_matches_jax(setup, streams, params):
    s = setup
    if params:
        js = _run(jstream.SimulateSidereal(), params, (s["jbt"],), s["jmap"])
        ts = _run(stream.SimulateSidereal(), params, (s["bt"],), s["tmap"])
    else:
        js, ts = streams
    assert isinstance(ts, containers.SiderealStream) and ts.vis.dtype == torch.complex64
    assert ts.vis.shape == js.vis.shape
    assert _rel(ts.vis[:], np.asarray(js.vis[:])) <= TOL
    assert torch.equal(ts.weight[:], torch.ones(ts.weight.shape))
    for name in ("prod", "stack", "input", "freq", "ra"):
        assert np.array_equal(ts.index_map[name], js.index_map[name]), name


@pytest.mark.parametrize("remove_window", [False, True])
def test_mmode_transform_matches_jax(setup, streams, remove_window):
    s = setup
    js, ts = streams
    params = {"remove_integration_window": remove_window}
    jm = _run(jtransform.MModeTransform(), params, (s["jtel"],), js)
    tm = _run(transform.MModeTransform(), params, (s["tel"],), ts)
    assert isinstance(tm, containers.MModes) and tm.mmax == jm.mmax and tm.oddra == jm.oddra
    assert _rel(tm.vis[:], np.asarray(jm.vis[:])) <= TOL
    assert _rel(tm.weight[:], np.asarray(jm.weight[:])) <= TOL


def test_mmode_inverse_transform_matches_jax(setup, streams):
    js, ts = streams
    jm = _run(jtransform.MModeTransform(), {}, (), js)
    tm = _run(transform.MModeTransform(), {}, (), ts)
    params = {"apply_integration_window": True}
    jback = _run(jtransform.MModeInverseTransform(), params, None, jm)
    tback = _run(transform.MModeInverseTransform(), params, None, tm)
    assert _rel(tback.vis[:], np.asarray(jback.vis[:])) <= TOL
    assert _rel(tback.weight[:], np.asarray(jback.weight[:])) <= TOL
    # and without the window the inverse gives back the simulated stream
    tplain = _run(transform.MModeInverseTransform(), {}, None, tm)
    assert _rel(tplain.vis[:], np.asarray(js.vis[:])) <= TOL


def test_expand_products_matches_jax_exactly(setup, streams):
    s = setup
    js, ts = streams
    # the same input values in both packages, so the gather must agree bit for bit
    ts.vis[:] = np.asarray(js.vis[:])
    jfull = _run(jstream.ExpandProducts(), {}, (s["jtel"],), js)
    tfull = _run(stream.ExpandProducts(), {}, (s["tel"],), ts)
    assert np.array_equal(tfull.vis[:].numpy(), np.asarray(jfull.vis[:]))
    assert np.array_equal(tfull.weight[:].numpy(), np.asarray(jfull.weight[:]))
    assert np.array_equal(tfull.index_map["prod"], jfull.index_map["prod"])


@pytest.mark.parametrize(
    "name,params",
    [
        ("FrequencyRebin", {"channel_bin": 2}),
        ("SelectFreq", {"channel_index": [1]}),
        ("ShiftRA", {"delta": 100.0, "periodic": True}),
        ("SiderealMModeResample", {"nra": 64}),
    ],
)
def test_stream_reshaping_tasks_match_jax(setup, streams, name, params):
    js, ts = streams
    # ShiftRA works in place: give each package its own copy
    jout = _run(getattr(jtransform, name)(), params, (), js.copy())
    tout = _run(getattr(transform, name)(), params, (), ts.copy())
    assert type(tout).__name__ == type(jout).__name__
    for axis in ("freq", "ra"):
        assert np.allclose(tout.index_map[axis].tolist(), jout.index_map[axis].tolist()), axis
    assert _rel(tout.vis[:], np.asarray(jout.vis[:])) <= TOL
    assert _rel(tout.weight[:], np.asarray(jout.weight[:])) <= TOL


def test_sidereal_grouper_matches_jax(setup):
    """Files spanning two sidereal days are grouped and joined per day."""
    s = setup
    out = {}
    for name, package, grouper, tel in (
        ("jax", jcontainers, jsidereal.SiderealGrouper, s["jtel"]),
        ("torch", containers, sidereal.SiderealGrouper, s["tel"]),
    ):
        task_obj = grouper()
        task_obj.read_config({"min_day_length": 0.2})
        task_obj.setup(tel)
        days = []
        for k in range(6):  # 0.4 of a day per file, from LSD 7999.9
            lsd = LSD - 0.1 + 0.4 * k + np.linspace(0.0, 0.4, 20, endpoint=False)
            ts = package.TimeStream(freq=np.array([400.0]), input=2, time=tel.lsd_to_unix(lsd))
            ts.vis[:] = (np.arange(60, dtype=np.float32).reshape(1, 3, 20) + 100 * k).astype(np.complex64)
            days.append(task_obj.process(ts))
        days.append(task_obj.process_finish())
        out[name] = [d for d in days if d is not None]
    assert [d.attrs["lsd"] for d in out["torch"]] == [d.attrs["lsd"] for d in out["jax"]]
    for td, jd in zip(out["torch"], out["jax"]):
        assert np.array_equal(td.time, jd.time)
        assert np.array_equal(td.vis[:].numpy(), np.asarray(jd.vis[:]))


def _time_stream_target(package, tel, ss):
    times = tel.lsd_to_unix(LSD + np.linspace(0.05, 0.95, 37))
    return package.TimeStream(axes_from=ss, time=times)


def test_make_time_stream_matches_jax(setup, streams):
    s = setup
    js, ts = streams
    jts = _run(jstream.MakeTimeStream(), {"lanczos_width": 5}, (s["jtel"],), js, _time_stream_target(jcontainers, s["jtel"], js))
    tts = _run(stream.MakeTimeStream(), {"lanczos_width": 5}, (s["tel"],), ts, _time_stream_target(containers, s["tel"], ts))
    assert isinstance(tts, containers.TimeStream)
    assert np.array_equal(tts.time, jts.time)
    assert _rel(tts.vis[:], np.asarray(jts.vis[:])) <= TOL
    assert _rel(tts.weight[:], np.asarray(jts.weight[:])) <= TOL


def _hybrid(package, seed):
    rng = np.random.Generator(np.random.SFC64(seed))
    hv = package.HybridVisStream(
        freq=np.array([400.0, 410.0]), pol=np.array(["XX"]), ew=np.arange(2), el=np.arange(3), ra=32
    )
    shape = hv.vis.shape
    hv.vis[:] = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    hv.weight[:] = rng.uniform(0.5, 2.0, hv.weight.shape).astype(np.float32)
    hv.attrs["lsd"] = LSD
    return hv


def test_make_time_stream_on_a_hybrid_stream(setup):
    """The hybrid path works in the port; the reference raises TypeError
    there (it always passes ``time=`` to a container with no time axis)."""
    s = setup
    target_ra = np.linspace(3.0, 350.0, 20)
    hv = _hybrid(containers, 5)
    target = containers.SiderealStream(freq=2, input=2, ra=target_ra)
    target.attrs["lsd"] = LSD
    out = _run(stream.MakeTimeStream(), {}, (s["tel"],), hv, target)
    assert isinstance(out, containers.HybridVisStream)
    assert np.allclose(out.ra, target_ra)
    assert out.vis.shape == (1, 2, 2, 3, 20) and out.weight.shape == (1, 2, 2, 20)
    # the interpolation is the same Lanczos matrix the sidereal path uses:
    # a constant stream stays constant
    const = _hybrid(containers, 5)
    const.vis[:] = 2.0 - 1.0j
    flat = _run(stream.MakeTimeStream(), {}, (s["tel"],), const, target)
    assert np.allclose(flat.vis[:].numpy(), 2.0 - 1.0j, atol=2e-2)

    jtarget = jcontainers.SiderealStream(freq=2, input=2, ra=target_ra)
    jtarget.attrs["lsd"] = LSD
    with pytest.raises(TypeError):
        _run(jstream.MakeTimeStream(), {}, (s["jtel"],), _hybrid(jcontainers, 5), jtarget)


def _day_stream(package, tel, nsamp, seed):
    """A time stream over one sidereal day (plus 0.02 day each side) with
    zero-weight gaps: irregular samples of a smooth sidereal signal."""
    rng = np.random.Generator(np.random.SFC64(seed))
    lsd = LSD + np.sort(rng.uniform(-0.02, 1.02, nsamp))
    lsd[0], lsd[-1] = LSD - 0.02, LSD + 1.02
    # the telescope's unique baselines, as a simulated stream labels them
    ts = package.TimeStream(
        freq=tel.frequencies, input=tel.nfeed, prod=np.asarray(tel.uniquepairs), time=tel.lsd_to_unix(lsd)
    )
    nstack = ts.vis.shape[1]
    phase = 2 * np.pi * np.arange(1, nstack + 1)[None, :, None] * lsd[None, None, :]
    vis = np.exp(1j * phase) * np.array([1.0, 0.5])[:, None, None] + 0.01 * rng.standard_normal((2, nstack, nsamp))
    ts.vis[:] = vis.astype(np.complex64)
    weight = rng.uniform(0.5, 2.0, (2, nstack, nsamp)).astype(np.float32)
    weight[:, :, nsamp // 3 : nsamp // 3 + 5] = 0.0
    weight[:, 1] = 0.0  # a stack entry with no data at all
    ts.weight[:] = weight
    ts.attrs["lsd"] = LSD
    return ts


@pytest.mark.parametrize(
    "params",
    [{}, {"mask_zero_weight": True}, {"down_mix": True}],
    ids=["plain", "mask_zero_weight", "down_mix"],
)
def test_sidereal_regridder_matches_jax(setup, params):
    s = setup
    jts = _day_stream(jcontainers, s["jtel"], 300, 7)
    tts = _day_stream(containers, s["tel"], 300, 7)
    cfg = {"samples": 64, **params}
    jout = _run(jsidereal.SiderealRegridder(), cfg, (s["jtel"],), jts)
    tout = _run(sidereal.SiderealRegridder(), cfg, (s["tel"],), tts)
    assert isinstance(tout, containers.SiderealStream)
    assert np.allclose(tout.ra, jout.ra) and tout.attrs["lsd"] == jout.attrs["lsd"] == LSD
    assert _rel(tout.vis[:], np.asarray(jout.vis[:])) <= TOL
    assert _rel(tout.weight[:], np.asarray(jout.weight[:])) <= TOL
    if params.get("mask_zero_weight"):
        assert (tout.weight[:, 1] == 0).all()


def test_lanczos_regridder_matches_jax(setup):
    s = setup
    jts = _day_stream(jcontainers, s["jtel"], 200, 8)
    tts = _day_stream(containers, s["tel"], 200, 8)
    t0, t1 = s["tel"].lsd_to_unix(LSD), s["tel"].lsd_to_unix(LSD + 1)
    cfg = {"samples": 48, "start": float(t0), "end": float(t1), "mask_zero_weight": True}
    jout = _run(jtransform.LanczosRegridder(), cfg, (s["jtel"],), jts)
    tout = _run(transform.LanczosRegridder(), cfg, (s["tel"],), tts)
    assert isinstance(tout, containers.TimeStream)
    assert np.allclose(tout.time, jout.time)
    assert _rel(tout.vis[:], np.asarray(jout.vis[:])) <= TOL
    assert _rel(tout.weight[:], np.asarray(jout.weight[:])) <= TOL


@pytest.fixture(scope="module")
def mmodes(setup, streams):
    s = setup
    js, ts = streams
    jm = _run(jtransform.MModeTransform(), {}, (s["jtel"],), js)
    tm = _run(transform.MModeTransform(), {}, (s["tel"],), ts)
    return jm, tm


@pytest.mark.parametrize(
    "maker,params",
    [("DirtyMapMaker", {}), ("DirtyMapMaker", {"streaming": True, "baseline_chunk": 3}),
     ("WienerMapMaker", {"prior_amp": 10.0})],
    ids=["dirty", "dirty_streaming", "wiener"],
)
def test_map_makers_match_jax(setup, mmodes, maker, params):
    s = setup
    jm, tm = mmodes
    cfg = {"nside": s["nside"], **params}
    jmap = _run(getattr(jmapmaker, maker)(), cfg, (s["jbt"],), jm)
    tmap = _run(getattr(mapmaker, maker)(), cfg, (s["bt"],), tm)
    assert isinstance(tmap, containers.Map) and tmap.map.shape == jmap.map.shape
    assert torch.isfinite(tmap.map[:]).all()
    assert _rel(tmap.map[:], np.asarray(jmap.map[:])) <= TOL


def test_ml_map_maker_reprojects_like_jax(setup, mmodes):
    """The ML solution re-projected through the beam transfer gives back
    the data, and agrees with the JAX package's: the map itself is not
    compared, as the pseudo-inverse is ill-conditioned."""
    s = setup
    jm, tm = mmodes
    # a cut that keeps the modes float32 resolves: the re-projection then
    # gives back the noiseless data
    cfg = {"nside": s["nside"], "rcond": 3e-5, "acond": 1e-9}
    out = _run(mapmaker.MaximumLikelihoodMapMaker(), cfg, (s["bt"],), tm)
    assert isinstance(out, containers.Map) and torch.isfinite(out.map[:]).all()
    jmm = jmapmaker.MaximumLikelihoodMapMaker()
    jmm.read_config(cfg)
    jmm.setup(s["jbt"])
    tmm = mapmaker.MaximumLikelihoodMapMaker()
    tmm.read_config(cfg)
    tmm.setup(s["bt"])
    tel = s["tel"]
    shape = (tel.mmax + 1, 2, tel.nfreq, tel.npairs)
    vis = np.asarray(jm.vis[:]).reshape(shape)
    weight = np.asarray(jm.weight[:]).reshape(shape)
    freqs = list(range(tel.nfreq))
    ja = np.asarray(jmm._solve_all_m(vis, weight, freqs, tel.mmax))
    ta = tmm._solve_all_m(torch.from_numpy(vis), torch.from_numpy(weight), freqs, tel.mmax)
    jv = np.asarray(s["jbt"].project_sky_to_telescope(ja))
    tv = s["bt"].project_sky_to_telescope(ta)
    assert _rel(tv, vis) <= TOL_ML
    assert _rel(tv, jv) <= TOL_ML


def test_simulate_and_map_matches_jax(setup):
    s = setup
    cfg = {"baseline_chunk": 3}
    jout = _run(jroundtrip.SimulateAndMap(), cfg, (s["jbt"],), s["jmap"])
    tout = _run(roundtrip.SimulateAndMap(), cfg, (s["bt"],), s["tmap"])
    assert isinstance(tout, containers.Map)
    assert _rel(tout.map[:], np.asarray(jout.map[:])) <= TOL


# -- the whole chain through both pipeline Managers -------------------------


class EmitSkyTorch(task.ContainerTask):
    """Source task: one seeded Map for the port's pipeline."""

    seed = config.int_prop(0)
    nside = config.int_prop(8)
    freq = config.list_prop([])

    def process(self):
        if self._count:
            raise task.PipelineStopIteration()
        m = containers.Map(nside=self.nside, polarisation=False, freq=np.array(self.freq))
        m.map[:] = _sky(self.seed, self.nside, len(self.freq))
        m.attrs["tag"] = "sky"
        return m


class EmitSkyJax(jtask.ContainerTask):
    """Source task: the same seeded Map for the JAX package's pipeline."""

    seed = jconfig.int_prop(0)
    nside = jconfig.int_prop(8)
    freq = jconfig.list_prop([])

    def process(self):
        if self._count:
            raise jtask.PipelineStopIteration()
        m = jcontainers.Map(nside=self.nside, polarisation=False, freq=np.array(self.freq))
        m.map[:] = _sky(self.seed, self.nside, len(self.freq))
        m.attrs["tag"] = "sky"
        return m


def chain_config(product_dir, tel, nside, source, samples_per_day=512, regrid_samples=128, pad_s=600.0):
    """Chain A (sky -> simulated day -> time stream -> regrid -> m-modes
    -> dirty map) and chain B (sky -> simulated stream -> m-modes -> dirty
    map) from one sky, as a config mapping."""
    day_s = float(tel.lsd_to_unix(LSD + 1) - tel.lsd_to_unix(LSD))
    stream_params = {"streaming": True, "baseline_chunk": 3}
    map_params = {"nside": nside, "streaming": True, "baseline_chunk": 3}
    return {
        "pipeline": {
            "tasks": [
                {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "bt"],
                 "params": {"product_directory": str(product_dir)}},
                {"type": source, "out": "sky",
                 "params": {"seed": SKY_SEED, "nside": nside, "freq": [float(f) for f in tel.frequencies]}},
                {"type": "draco.synthesis.stream.SimulateSidereal", "requires": "bt", "in": "sky",
                 "out": "sstream", "params": stream_params},
                {"type": "draco.synthesis.stream.MakeSiderealDayStream", "requires": ["bt", "sstream"],
                 "out": "sday", "params": {"start_time": float(tel.lsd_to_unix(LSD - 0.5)),
                                           "end_time": float(tel.lsd_to_unix(LSD + 0.5))}},
                {"type": "draco.synthesis.stream.MakeMultipleTimeStreams", "requires": ["tel", "sday"],
                 "out": "tstream", "params": {
                     "start_time": float(tel.lsd_to_unix(LSD)) - pad_s,
                     "end_time": float(tel.lsd_to_unix(LSD + 1)) + pad_s,
                     "integration_time": day_s / samples_per_day, "samples_per_file": 4 * samples_per_day}},
                {"type": "draco.analysis.sidereal.SiderealRegridder", "requires": "tel", "in": "tstream",
                 "out": "sregrid", "params": {"samples": regrid_samples}},
                {"type": "draco.analysis.transform.MModeTransform", "requires": "tel", "in": "sregrid",
                 "out": "mmodes_a"},
                {"type": "draco.analysis.mapmaker.DirtyMapMaker", "requires": "bt", "in": "mmodes_a",
                 "out": "map_a", "params": map_params},
                {"type": "draco.analysis.transform.MModeTransform", "requires": "tel", "in": "sstream",
                 "out": "mmodes_b"},
                {"type": "draco.analysis.mapmaker.DirtyMapMaker", "requires": "bt", "in": "mmodes_b",
                 "out": "map_b", "params": map_params},
            ]
        }
    }


@pytest.fixture(scope="module")
def chains(setup, tmp_path_factory):
    s = setup
    product_dir = tmp_path_factory.mktemp("streaming_products")
    # a streaming product: the telescope alone
    with open(product_dir / "telescope.pkl", "wb") as f:
        pickle.dump(s["jtel"], f)
    jprod = JManager(chain_config(product_dir, s["jtel"], s["nside"], "tests.test_torch_tasks.EmitSkyJax")).run()
    tprod = Manager(chain_config(product_dir, s["tel"], s["nside"], "tests.test_torch_tasks.EmitSkyTorch")).run()
    return jprod, tprod


def test_chain_runs_through_the_manager(chains):
    _, tprod = chains
    ts = tprod["tstream"][0]
    assert isinstance(ts, containers.TimeStream) and ts.attrs["lsd"] == LSD
    assert ts.vis.shape[-1] == 512 + 2 * int(np.ceil(600.0 / (86164.0905 / 512)))
    sreg = tprod["sregrid"][0]
    assert isinstance(sreg, containers.SiderealStream) and sreg.vis.shape[-1] == 128
    for label in ("mmodes_a", "mmodes_b"):
        assert isinstance(tprod[label][0], containers.MModes) and tprod[label][0].mmax == 23
    for label in ("map_a", "map_b"):
        assert isinstance(tprod[label][0], containers.Map) and torch.isfinite(tprod[label][0].map[:]).all()


@pytest.mark.parametrize("label", ["sstream", "tstream", "sregrid", "mmodes_a", "mmodes_b", "map_a", "map_b"])
def test_chain_matches_jax(chains, label):
    jprod, tprod = chains
    jc, tc = jprod[label][0], tprod[label][0]
    name = "map" if label.startswith("map") else "vis"
    assert _rel(tc[name][:], np.asarray(jc[name][:])) <= TOL
    if name == "vis":
        assert _rel(tc.weight[:], np.asarray(jc.weight[:])) <= TOL


def test_chain_closed_loop(chains):
    """Chain A's m-modes against chain B's: the Lanczos sample-and-regrid
    error, printed; both maps agree once the m-mode weights are divided out."""
    _, tprod = chains
    ma, mb = tprod["mmodes_a"][0], tprod["mmodes_b"][0]
    va, vb = ma.vis[:], mb.vis[:]
    err = ((va - vb).abs().max() / vb.abs().max()).item()
    print(f"closed loop: chain A m-modes vs chain B max|diff|/max|ref| {err:.3e}")
    assert err < 0.05
    wa, wb = ma.weight[:], mb.weight[:]
    assert torch.all(wb == 47.0)  # unit weights over nra = 2 mmax + 1 = 47 samples
    ratio = (wa[wa > 0] / 47.0).mean().item()
    map_a, map_b = tprod["map_a"][0].map[:], tprod["map_b"][0].map[:]
    rescaled = (map_a / ratio - map_b).abs().max() / map_b.abs().max()
    print(f"closed loop: weight ratio {ratio:.2f}, rescaled maps max|diff|/max|ref| {rescaled.item():.3e}")
    assert rescaled < 0.1


# -- the weighted reductions (transform.py's Reduce* family) -------------------------------


def _reduce_stream(package, seed=21):
    """A seeded 3-feed stream (6 products, each its own stack), 3 frequencies,
    12 RA samples, with zero weights and per-input flags that vary in time."""
    rng = np.random.Generator(np.random.SFC64(seed))
    prod = np.array([[a, b] for a in range(3) for b in range(a, 3)])
    ss = package.SiderealStream(freq=np.array([400.0, 410.0, 420.0]), input=3, ra=12, prod=prod)
    shape = ss.vis.shape
    ss.vis[:] = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    weight = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    weight[1, 2, :4] = 0.0
    weight[:, 4, 7] = 0.0
    ss.weight[:] = weight
    flags = np.ones(ss.input_flags.shape, dtype=np.float32)
    flags[1, ::3] = 0.0
    ss.input_flags[:] = flags
    return ss


@pytest.mark.parametrize(
    "name,params",
    [
        ("ReduceVar", {"axes": ["ra"], "dataset": "vis", "weighting": "none"}),
        ("ReduceVar", {"axes": ["ra"], "dataset": "vis", "weighting": "masked"}),
        ("ReduceVar", {"axes": ["freq", "ra"], "dataset": "vis", "weighting": "weighted"}),
        ("ReduceChisq", {"axes": ["ra"], "dataset": "vis"}),
        ("ReduceChisq", {"axes": ["freq"], "dataset": "vis"}),
        ("ReduceChisqInverseRedundancy", {"axes": ["ra"], "dataset": "vis"}),
    ],
    ids=["var_none", "var_masked", "var_weighted", "chisq_ra", "chisq_freq", "chisq_inverse_redundancy"],
)
def test_reductions_match_jax(name, params):
    """float32 data in both packages: 2e-6 of the largest value."""
    jout = _run(getattr(jtransform, name)(), params, None, _reduce_stream(jcontainers))
    tout = _run(getattr(transform, name)(), params, None, _reduce_stream(containers))
    assert type(tout).__name__ == type(jout).__name__
    for ax in params["axes"]:
        assert len(tout.index_map[ax]) == 1 and np.array_equal(tout.index_map[ax], jout.index_map[ax])
    for key in ("reduced", "reduced_dataset", "reduction_op"):
        assert tout.attrs[key] == jout.attrs[key]
    assert list(tout.attrs["reduction_axes"]) == params["axes"]
    assert tout.vis.shape == jout.vis.shape
    assert _rel(tout.vis[:], np.asarray(jout.vis[:])) <= 2e-6
    assert _rel(tout.weight[:], np.asarray(jout.weight[:])) <= 2e-6
