"""System sensitivity: draco_tpu_torch against draco_tpu on the same inputs.

``ComputeSystemSensitivity`` runs in both packages on the same seeded time
streams, the port on the CPU: the unstacked triangle of a small dual-pol
cylinder (the JAX package's own test, with its hand-checked values), and
the stacked stream that ``CollateProducts`` labels (the redundancy
patterns of flagged inputs, per-frequency gain flags and the
intracylinder exclusion).

Tolerance: 1e-5 relative (max |diff| / max |ref|) on ``measured``,
``radiometer`` and ``weight``; ``frac_lost`` exactly.  Both packages sum
in float32, in different orders.
"""

import numpy as np
import pytest
import torch

from draco_tpu.analysis import sensitivity as jsens
from draco_tpu.analysis import transform as jtransform
from draco_tpu.core import containers as jcontainers
from draco_tpu.telescope import PolarisedCylinderTelescope as JPolCylinder
from draco_tpu_torch.analysis import sensitivity, transform
from draco_tpu_torch.core import containers
from draco_tpu_torch.device import default_device
from draco_tpu_torch.telescope import PolarisedCylinderTelescope

TOL = 1e-5
SMALL = dict(num_cylinders=1, num_feeds=2, feed_spacing=6.0, latitude=45.0, freq_lower=400.0, freq_upper=420.0,
             num_freq=2, auto_correlations=True)
CYL = dict(num_cylinders=3, num_feeds=4, feed_spacing=0.5, cylinder_spacing=22.0, cylinder_width=20.0,
           latitude=49.0, freq_lower=600.0, freq_upper=601.5625, num_freq=4, auto_correlations=True)


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    """max |diff| / max |ref| (max |diff| where the reference is all zero)."""
    diff = np.abs(_np(got) - np.asarray(want)).max()
    scale = np.abs(np.asarray(want)).max()
    return diff / scale if scale > 0 else diff


def _run(task_cls, tel, stream, params=None):
    t = task_cls()
    t.read_config(params or {})
    t.setup(tel)
    return t.process(stream)


def _unstacked(mod, tel, ntime=4):
    triu = np.triu_indices(tel.nfeed)
    nprod = len(triu[0])
    prod = np.zeros(nprod, dtype=[("input_a", int), ("input_b", int)])
    prod["input_a"], prod["input_b"] = triu
    stack = np.zeros(nprod, dtype=[("prod", int), ("conjugate", bool)])
    stack["prod"] = np.arange(nprod)
    ts = mod.TimeStream(freq=tel.frequencies, input=tel.input_index, prod=prod, stack=stack,
                        time=1e9 + 10.0 * np.arange(ntime))
    rev = np.zeros(nprod, dtype=[("stack", int), ("conjugate", bool)])
    rev["stack"] = np.arange(nprod)
    ts.create_reverse_map("stack", rev)
    return ts, prod


def test_compute_system_sensitivity_matches_jax_and_hand_values():
    """The JAX package's test (tests/test_sensitivity.py:45) in both packages."""
    jtel, tel = JPolCylinder(**SMALL), PolarisedCylinderTelescope(**SMALL)
    A, w0 = 50.0, 4.0
    pair = []
    for mod, t in ((jcontainers, jtel), (containers, tel)):
        ts, prod = _unstacked(mod, t)
        vis = np.zeros(ts.vis.shape, dtype=np.complex64)
        vis[:, prod["input_a"] == prod["input_b"], :] = A
        ts.vis[:] = vis
        ts.weight[:] = np.full(ts.weight.shape, w0, dtype=np.float32)
        ts.input_flags[:] = np.ones(ts.input_flags.shape, dtype=np.float32)
        pair.append(ts)
    want = _run(jsens.ComputeSystemSensitivity, jtel, pair[0])
    got = _run(sensitivity.ComputeSystemSensitivity, tel, pair[1])
    assert isinstance(got, containers.SystemSensitivity) and list(got.pol) == ["XX", "XY", "YY"]
    for name in ("measured", "radiometer", "weight"):
        assert _rel(got.datasets[name][:], want.datasets[name][:]) <= TOL, name
    nint = np.median(pair[1].index_map["freq"]["width"]) * 1e6 * 10.0
    radi, meas = _np(got.radiometer[:]), _np(got.measured[:])
    assert np.allclose(radi[:, 0], np.sqrt(2 * 4 * A**2 / (nint * 16)), rtol=1e-5)
    # measured XX: the scale-weighted (1 an auto, 2 a cross) mean of 1 / w0
    prod = _unstacked(containers, tel)[1]
    pol = np.asarray(tel.polarisation)
    xx = (pol[prod["input_a"]] == "X") & (pol[prod["input_b"]] == "X")
    counter = np.sum(np.where(prod["input_a"][xx] == prod["input_b"][xx], 1.0, 2.0))
    assert np.allclose(meas[:, 0], np.sqrt(2 / (w0 * counter)), rtol=1e-5)


def _stacked(mod, tel, seed, ntime=24, gain=False):
    maps = (jtransform if mod is jcontainers else transform).TelescopeStreamMixIn()
    maps.setup(tel)
    ts = mod.TimeStream(freq=tel.frequencies, input=tel.input_index, prod=maps.bt_prod, stack=maps.bt_stack,
                        reverse_map_stack=maps.bt_rev, time=1.6e9 + 10.0 * np.arange(ntime))
    rng = np.random.Generator(np.random.SFC64(seed))
    shape = ts.vis.shape
    vis = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ps = ts.prodstack
    autos = ps["input_a"] == ps["input_b"]
    vis[:, autos] = rng.uniform(40.0, 60.0, (shape[0], autos.sum(), shape[2]))
    weight = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    weight[1, 3] = 0.0
    weight[:, :, 5] = 0.0
    flags = np.ones(ts.input_flags.shape, dtype=np.float32)
    flags[2, 3:9] = 0.0
    flags[5, 10:12] = 0.0
    ts.vis[:] = vis
    ts.weight[:] = weight
    ts.input_flags[:] = flags
    if gain:
        ts.add_dataset("gain")
        g = np.full(ts.datasets["gain"].shape, 1.5 + 0.1j, dtype=np.complex64)
        g[2, 7] = 1.0  # an absent input at one frequency
        g[1, 1, 4:9] = 1.0
        ts.datasets["gain"][:] = g
    return ts


@pytest.mark.parametrize(
    "case", [{}, {"gain": True}, {"exclude_intracyl": True}], ids=["plain", "gain", "intracyl"]
)
def test_stacked_stream_matches_jax(case):
    jtel, tel = JPolCylinder(**CYL), PolarisedCylinderTelescope(**CYL)
    params = {"exclude_intracyl": case.pop("exclude_intracyl", False)}
    js = _stacked(jcontainers, jtel, 3, **case)
    ts = _stacked(containers, tel, 3, **case)
    want = _run(jsens.ComputeSystemSensitivity, jtel, js, params)
    got = _run(sensitivity.ComputeSystemSensitivity, tel, ts, params)
    assert list(got.pol) == list(want.pol)
    for name in ("measured", "radiometer", "weight"):
        assert _rel(got.datasets[name][:], want.datasets[name][:]) <= TOL, name
        assert got.datasets[name][:].dtype == torch.float32
    assert np.array_equal(_np(got.frac_lost[:]), np.asarray(want.frac_lost[:]))
    assert np.isfinite(_np(got.measured[:])).all() and np.isfinite(_np(got.radiometer[:])).all()


def test_intracylinder_exclusion_on_the_unstacked_triangle():
    """Per-feed autos: the intracylinder pairs drop out of both estimates."""
    jtel, tel = JPolCylinder(**SMALL), PolarisedCylinderTelescope(**SMALL)
    rng = np.random.Generator(np.random.SFC64(5))
    pair = []
    for mod in (jcontainers, containers):
        ts, prod = _unstacked(mod, tel)
        pair.append(ts)
    vis = (rng.standard_normal(pair[0].vis.shape) + 40.0).astype(np.complex64)
    weight = rng.uniform(0.5, 2.0, pair[0].weight.shape).astype(np.float32)
    for ts in pair:
        ts.vis[:] = vis
        ts.weight[:] = weight
        ts.input_flags[:] = np.ones(ts.input_flags.shape, dtype=np.float32)
    params = {"exclude_intracyl": True}
    want = _run(jsens.ComputeSystemSensitivity, jtel, pair[0], params)
    got = _run(sensitivity.ComputeSystemSensitivity, tel, pair[1], params)
    assert tuple(got.measured.shape) == (2, 3, 4)
    for name in ("measured", "radiometer", "weight"):
        assert _rel(got.datasets[name][:], want.datasets[name][:]) <= TOL, name
