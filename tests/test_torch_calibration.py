"""Gains on data and the product collation: draco_tpu_torch against draco_tpu.

``ApplyGain`` with every option, ``CollateProducts`` with every weighting,
the expand -> collate round trip, and the composite chain of
``tests/test_endtoend.py::test_composite_pipeline_yaml`` (sky -> sidereal
stream -> full triangle -> receiver temperature -> gains -> ApplyGain ->
CollateProducts -> m-modes -> dirty map) through both packages' pipeline
Managers, with the gains set to one and without SampleNoise (whose draws
cannot match the JAX package's; ``test_torch_synthesis.py`` holds it to its
statistics).  A dual-pol cylinder of 2 x 4 feeds (16 inputs, 136
products) at nside 16, the port on the CPU.

Tolerances, max|diff| / max|ref|: 1e-6 where both packages form the same
products in complex64/complex128 (gains, collation: the port accumulates
in float64, the JAX package in complex64); exact for the gain draws; 2e-5
for the chain's float32 projections (as ``test_torch_tasks.py``); the
round trip within 1e-6 of the stacked stream.
"""

import pickle

import numpy as np
import pytest
import torch

import draco_tpu.telescope as J
from draco_tpu.analysis import calibration as jcalibration
from draco_tpu.analysis import transform as jtransform
from draco_tpu.core import config as jconfig
from draco_tpu.core import containers as jcontainers
from draco_tpu.core import task as jtask
from draco_tpu.core.pipeline import Manager as JManager
from draco_tpu.synthesis import stream as jstream
from draco_tpu_torch import telescope as T
from draco_tpu_torch.analysis import calibration, transform
from draco_tpu_torch.core import config, containers, task
from draco_tpu_torch.core.pipeline import Manager
from draco_tpu_torch.device import default_device
from draco_tpu_torch.synthesis import stream

TOL = 1e-6
TOL_CHAIN = 2e-5
NSIDE = 16
TEL = dict(
    num_cylinders=2, num_feeds=4, cylinder_width=10.0, cylinder_spacing=12.0, feed_spacing=1.0, latitude=45.0,
    freq_lower=400.0, freq_upper=420.0, num_freq=2, auto_correlations=True,
    force_lmax=3 * NSIDE - 1, force_mmax=3 * NSIDE - 1,
)


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def tels():
    return J.PolarisedCylinderTelescope(**TEL), T.PolarisedCylinderTelescope(**TEL)


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


def _fill(cont, seed, zero_weights=True):
    rng = np.random.Generator(np.random.SFC64(seed))
    shape = cont.vis.shape
    cont.vis[:] = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    w = rng.uniform(0.5, 2.0, cont.weight.shape).astype(np.float32)
    if zero_weights:
        w[..., ::5, 1] = 0.0
    cont.weight[:] = w
    return cont


# -- ApplyGain ---------------------------------------------------------------------


def _gain_case(name, package, seed=21):
    """(stream, gain container) of one ApplyGain case."""
    rng = np.random.Generator(np.random.SFC64(seed))
    freq = np.array([800.0, 790.0])
    nt = 24

    def cgain(shape):
        return 1.0 + 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))

    if name.startswith("sidereal"):
        ss = _fill(package.SiderealStream(freq=freq, input=4, ra=nt), seed)
        g = package.SiderealGainData(freq=freq, input=4, ra=nt)
        g.gain[:] = cgain((2, 4, nt))
        return ss, g
    if name.startswith("time") or name == "static":
        ts = _fill(package.TimeStream(freq=freq, input=4, time=1e9 + 10.0 * np.arange(nt)), seed)
        if name == "static":
            g = package.StaticGainData(freq=freq, input=4)
            g.gain[:] = cgain((2, 4))
            g.add_dataset("weight")
            g.weight[:] = (rng.uniform(size=(2, 4)) > 0.2).astype(np.float64)
            return ts, g
        g = package.GainData(freq=freq, input=4, time=ts.time)
        gains = cgain((2, 4, nt))
        gains[0, 1, 5] = np.nan  # a flagged sample: nan_to_num'd
        g.gain[:] = gains
        g.add_dataset("weight")
        wt = rng.uniform(0.5, 1.5, (2, 4, nt))
        wt[:, 2, 10:14] = 0.0
        g.weight[:] = wt
        return ts, g
    # common-mode gains on a stacked stream (4 stacks of 10 products)
    prod = np.zeros(10, dtype=[("input_a", "<u2"), ("input_b", "<u2")])
    prod["input_a"], prod["input_b"] = np.triu_indices(4)
    stack = np.zeros(4, dtype=[("prod", "<u4"), ("conjugate", "u1")])
    stack["prod"] = [0, 1, 4, 7]
    rev = np.zeros(10, dtype=[("stack", "<u4"), ("conjugate", "u1")])
    rev["stack"] = [0, 1, 2, 3, 0, 1, 2, 0, 1, 0]
    ss = _fill(package.SiderealStream(freq=freq, input=4, ra=nt, prod=prod, stack=stack, reverse_map_stack=rev), seed)
    g = package.CommonModeSiderealGainData(freq=freq, ra=nt)
    g.gain[:] = cgain((2, nt))
    return ss, g


@pytest.mark.parametrize(
    "name,params",
    [
        ("sidereal", {"inverse": False}),
        ("sidereal_inverse", {"inverse": True, "update_weight": True}),
        ("time_smoothed", {"inverse": True, "update_weight": True, "smoothing_length": 45.0}),
        ("time_weighted", {"inverse": False, "update_weight": False}),
        ("static", {"inverse": True, "update_weight": True}),
        ("common_mode", {"inverse": False, "update_weight": True}),
    ],
)
def test_apply_gain_matches_jax(name, params):
    jss, jg = _gain_case(name, jcontainers)
    tss, tg = _gain_case(name, containers)
    jout = _run(jcalibration.ApplyGain(), params, None, jss, jg)
    tout = _run(calibration.ApplyGain(), params, None, tss, tg)
    assert tout is tss  # in place
    assert _rel(tout.vis[:], np.asarray(jout.vis[:])) <= TOL
    assert _rel(tout.weight[:], np.asarray(jout.weight[:])) <= TOL


def test_apply_gain_rejects_per_input_gains_on_stacked_data():
    ss, _ = _gain_case("common_mode", containers)
    _, g = _gain_case("sidereal", containers)
    with pytest.raises(ValueError, match="stacked"):
        _run(calibration.ApplyGain(), {}, None, ss, g)


# -- CollateProducts and the round trip -----------------------------------------------


def _triangle(package, tel, seed=22):
    """A full-triangle stream on the telescope's inputs, random data, some zero weights."""
    ss = package.SiderealStream(freq=tel.frequencies, input=tel.input_index, ra=6)
    return _fill(ss, seed)


@pytest.mark.parametrize("weight", ["natural", "uniform", "inverse_variance"])
def test_collate_products_matches_jax(tels, weight):
    jtel, tel = tels
    jout = _run(jtransform.CollateProducts(), {"weight": weight}, (jtel,), _triangle(jcontainers, jtel))
    tout = _run(transform.CollateProducts(), {"weight": weight}, (tel,), _triangle(containers, tel))
    assert type(tout) is containers.SiderealStream and tout.vis.shape == (2, tel.npairs, 6)
    assert _rel(tout.vis[:], np.asarray(jout.vis[:])) <= TOL
    assert _rel(tout.weight[:], np.asarray(jout.weight[:])) <= TOL
    for name in ("prod", "stack", "input", "freq"):
        assert np.array_equal(tout.index_map[name], jout.index_map[name]), name
    assert np.array_equal(tout.reverse_map["stack"], jout.reverse_map["stack"])


def _stacked(package, tel, seed=23):
    """A stacked stream as SimulateSidereal labels it, random data."""
    ss = package.SiderealStream(
        freq=tel.frequencies, ra=6, input=tel.input_index, prod=tel.index_map_prod,
        stack=tel.index_map_stack, reverse_map_stack=tel.reverse_map_stack,
    )
    _fill(ss, seed, zero_weights=False)
    ss.weight[:] = 1.0
    return ss


def test_expand_collate_round_trip(tels, monkeypatch):
    """ExpandProducts then CollateProducts gives back the stacked stream
    (within 1e-6), with the redundancy as its weight; blocks of a few
    products or samples give the same answer."""
    _, tel = tels
    ss = _stacked(containers, tel)
    full = _run(stream.ExpandProducts(), {}, (tel,), ss)
    back = _run(transform.CollateProducts(), {}, (tel,), full)
    assert _rel(back.vis[:], ss.vis[:].numpy()) <= TOL
    assert np.array_equal(back.weight[:].numpy(), np.broadcast_to(tel.redundancy[None, :, None], back.weight.shape))
    from draco_tpu_torch.ops import tools

    monkeypatch.setattr(tools, "BLOCK_ELEMENTS", 200)
    full_b = _run(stream.ExpandProducts(), {}, (tel,), ss)
    assert torch.equal(full_b.vis[:], full.vis[:]) and torch.equal(full_b.weight[:], full.weight[:])
    back_b = _run(transform.CollateProducts(), {}, (tel,), full_b)
    assert _rel(back_b.vis[:], back.vis[:].numpy()) <= 1e-7


# -- the composite chain through both Managers -------------------------------------------


class EmitPolSkyTorch(task.ContainerTask):
    """Source task: one seeded full-Stokes Map for the port's pipeline."""

    freq = config.list_prop([])

    def process(self):
        if self._count:
            raise task.PipelineStopIteration()
        m = containers.Map(nside=NSIDE, polarisation=True, freq=np.array(self.freq))
        m.map[:] = np.random.Generator(np.random.SFC64(24)).standard_normal(m.map.shape)
        m.attrs["tag"] = "sky"
        return m


class EmitPolSkyJax(jtask.ContainerTask):
    """Source task: the same Map for the JAX package's pipeline."""

    freq = jconfig.list_prop([])

    def process(self):
        if self._count:
            raise jtask.PipelineStopIteration()
        m = jcontainers.Map(nside=NSIDE, polarisation=True, freq=np.array(self.freq))
        m.map[:] = np.random.Generator(np.random.SFC64(24)).standard_normal(m.map.shape)
        m.attrs["tag"] = "sky"
        return m


def composite_config(product_dir, tel, source):
    stream_params = {"streaming": True, "baseline_chunk": 40}
    return {"pipeline": {"tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "bt"],
         "params": {"product_directory": str(product_dir)}},
        {"type": source, "out": "sky", "params": {"freq": [float(f) for f in tel.frequencies]}},
        {"type": "draco.synthesis.stream.SimulateSidereal", "requires": "bt", "in": "sky", "out": "sstream",
         "params": stream_params},
        {"type": "draco.synthesis.stream.ExpandProducts", "requires": "tel", "in": "sstream", "out": "sstream_full"},
        {"type": "draco.synthesis.noise.ReceiverTemperature", "in": "sstream_full", "out": "sstream_rt",
         "params": {"recv_temp": 5.0}},
        {"type": "draco.synthesis.gain.RandomSiderealGains", "requires": ["tel", "sstream_rt"], "out": "gain_fluc",
         "params": {"seed": 7, "start_time": "2015-10-05 12:15:00", "end_time": "2015-10-06 12:15:00",
                    "amp": False, "phase": False}},
        {"type": "draco.analysis.calibration.ApplyGain", "in": ["sstream_rt", "gain_fluc"], "out": "sstream_gain",
         "params": {"inverse": False}},
        {"type": "draco.analysis.transform.CollateProducts", "requires": "bt", "in": "sstream_gain",
         "out": "sstream_coll"},
        {"type": "draco.analysis.transform.MModeTransform", "requires": "tel", "in": "sstream_coll", "out": "mmodes"},
        {"type": "draco.analysis.mapmaker.DirtyMapMaker", "requires": "bt", "in": "mmodes", "out": "dmap",
         "params": {"nside": NSIDE, **stream_params}},
    ]}}


@pytest.fixture(scope="module")
def chains(tels, tmp_path_factory):
    jtel, tel = tels
    product_dir = tmp_path_factory.mktemp("composite_products")
    with open(product_dir / "telescope.pkl", "wb") as f:
        pickle.dump(jtel, f)
    jprod = JManager(composite_config(product_dir, jtel, "tests.test_torch_calibration.EmitPolSkyJax")).run()
    tprod = Manager(composite_config(product_dir, tel, "tests.test_torch_calibration.EmitPolSkyTorch")).run()
    return jprod, tprod


@pytest.mark.parametrize(
    "label,name", [("sstream", "vis"), ("sstream_gain", "vis"), ("gain_fluc", "gain"), ("sstream_coll", "vis"),
                   ("mmodes", "vis"), ("dmap", "map")],
)
def test_composite_chain_matches_jax(chains, label, name):
    jprod, tprod = chains
    jc, tc = jprod[label][0], tprod[label][0]
    assert type(tc).__name__ == type(jc).__name__ and tc[name][:].shape == np.asarray(jc[name][:]).shape
    assert torch.isfinite(torch.view_as_real(tc[name][:]) if tc[name][:].is_complex() else tc[name][:]).all()
    if label == "gain_fluc":
        assert torch.equal(tc.gain[:], torch.ones_like(tc.gain[:]))
        return
    assert _rel(tc[name][:], np.asarray(jc[name][:])) <= TOL_CHAIN
    if name == "vis":
        assert _rel(tc.weight[:], np.asarray(jc.weight[:])) <= TOL_CHAIN


def test_composite_chain_full_triangle_is_one_container(chains):
    """ReceiverTemperature and ApplyGain work in place: the labels share one
    full-triangle stream, as a 2048-feed run needs."""
    _, tprod = chains
    full = tprod["sstream_full"][0]
    assert tprod["sstream_rt"][0] is full and tprod["sstream_gain"][0] is full
    assert full.vis.shape[1] == 16 * 17 // 2
