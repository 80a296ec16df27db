"""Fringe-stop mixing: draco_tpu_torch against draco_tpu on the same inputs.

``DownMix`` and ``UpMix`` run in both packages on the same seeded streams,
the port on the CPU: a stacked sidereal stream (the ``ra`` branch), a
stacked time stream (the ``time`` branch through ``unix_to_lsa``, with the
telescope's product mask), and a hybrid beamformed stream (the ``el``
branch).

Tolerance: 1e-6 relative (max |diff| / max |ref|).  The JAX package rotates
in float64 (its tests run under x64) and rounds once to complex64; the
port reduces the float64 angle to [-pi, pi), rotates in complex64, and so
rounds the phasor and the product: ~1e-7.  The masked weights are exactly
equal.
"""

import numpy as np
import pytest
import torch

from draco_tpu.analysis import fringestop as jfringe
from draco_tpu.core import containers as jcontainers
from draco_tpu.telescope import PolarisedCylinderTelescope as JPolCylinder
from draco_tpu_torch.analysis import fringestop
from draco_tpu_torch.core import containers
from draco_tpu_torch.device import default_device
from draco_tpu_torch.telescope import PolarisedCylinderTelescope

TOL = 1e-6
PTEL = dict(num_cylinders=2, num_feeds=3, feed_spacing=6.0, cylinder_spacing=20.0, latitude=45.0,
            freq_lower=400.0, freq_upper=420.0, num_freq=3, auto_correlations=True)


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def tels():
    return JPolCylinder(**PTEL), PolarisedCylinderTelescope(**PTEL)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    return np.abs(_np(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


def _stacked(tel, kind, nsamp=40, seed=1):
    nstack = tel.npairs
    prod = np.zeros(nstack, dtype=[("input_a", int), ("input_b", int)])
    prod["input_a"], prod["input_b"] = tel.uniquepairs[:, 0], tel.uniquepairs[:, 1]
    stack = np.zeros(nstack, dtype=[("prod", int), ("conjugate", bool)])
    stack["prod"] = np.arange(nstack)
    rng = np.random.Generator(np.random.SFC64(seed))
    out = []
    for mod in (jcontainers, containers):
        if kind == "ra":
            ss = mod.SiderealStream(freq=tel.frequencies, stack=stack, input=tel.nfeed, prod=prod, ra=nsamp)
        else:
            ss = mod.TimeStream(freq=tel.frequencies, stack=stack, input=tel.nfeed, prod=prod,
                                time=1.6e9 + 600.0 * np.arange(nsamp))
        out.append(ss)
    shape = out[0].vis.shape
    vis = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    weight = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    for ss in out:
        ss.vis[:] = vis
        ss.weight[:] = weight
    return out, vis, weight


def _hybrid(tel, nra=32, nel=5, seed=2):
    rng = np.random.Generator(np.random.SFC64(seed))
    out = [
        mod.HybridVisStream(freq=tel.frequencies, pol=np.array(["XX", "YY"]), ew=np.array([0.0, 20.0, 40.0]),
                            el=np.linspace(-0.6, 0.6, nel), ra=nra)
        for mod in (jcontainers, containers)
    ]
    shape = out[0].vis.shape
    vis = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    weight = rng.uniform(0.5, 2.0, out[0].weight.shape).astype(np.float32)
    for hv in out:
        hv.vis[:] = vis
        hv.weight[:] = weight
    return out, vis, weight


def _mix(task_cls, tel, stream):
    t = task_cls()
    t.read_config({})
    t.setup(tel)
    return t.process(stream)


@pytest.mark.parametrize("task", ["DownMix", "UpMix"])
@pytest.mark.parametrize("kind", ["ra", "time", "hybrid"])
def test_mix_matches_jax_in_place(tels, kind, task):
    jtel, ttel = tels
    (js, ts), vis, weight = _hybrid(ttel) if kind == "hybrid" else _stacked(ttel, kind)
    storage = ts.vis[:].data_ptr()
    jout = _mix(getattr(jfringe, task), jtel, js)
    tout = _mix(getattr(fringestop, task), ttel, ts)
    assert tout is ts and ts.vis[:].data_ptr() == storage and ts.vis[:].dtype == torch.complex64
    assert _rel(tout.vis[:], jout.vis[:]) <= TOL
    assert np.array_equal(_np(tout.weight[:]), np.asarray(jout.weight[:]))
    assert tout.attrs["fringestopped"] == (task == "DownMix") == jout.attrs["fringestopped"]


@pytest.mark.parametrize("kind", ["ra", "time", "hybrid"])
def test_downmix_then_upmix_is_the_identity(tels, kind):
    _, ttel = tels
    (_, ts), vis, _ = _hybrid(ttel, seed=3) if kind == "hybrid" else _stacked(ttel, kind, seed=3)
    keep = np.ones(vis.shape[1], bool) if kind == "hybrid" else ttel.feedmask[
        (ts.prodstack["input_a"], ts.prodstack["input_b"])]
    ref = vis * (keep[:, None] if kind != "hybrid" else 1)
    mixed = _mix(fringestop.DownMix, ttel, ts)
    down = _np(mixed.vis[:]).copy()
    _mix(fringestop.UpMix, ttel, mixed)
    back = _np(mixed.vis[:])
    assert np.sqrt(np.mean(np.abs(back - ref) ** 2) / np.mean(np.abs(ref) ** 2)) <= TOL
    if kind == "ra":
        # the EW baselines, and only they, were rotated
        pairs = ts.prodstack
        ew = ttel.feedpositions[pairs["input_a"], 0] - ttel.feedpositions[pairs["input_b"], 0]
        changed = ~np.isclose(down, ref, atol=1e-6).all(axis=(0, 2))
        assert np.array_equal(changed, np.abs(ew) > 1e-8)


def test_downmix_removes_a_field_centre_fringe(tels):
    """A source at the field centre fringes at omega; down-mixing makes it constant."""
    _, ttel = tels
    (_, ts), _, _ = _stacked(ttel, "ra", nsamp=64)
    task = fringestop.DownMix()
    task.read_config({})
    task.setup(ttel)
    omega = task.omega(ts)  # [freq, stack]
    phi = np.radians(ts.ra)
    ts.vis[:] = np.exp(-1j * omega[:, :, None] * phi).astype(np.complex64)
    out = task.process(ts)
    v = _np(out.vis[:])
    keep = ttel.feedmask[(ts.prodstack["input_a"], ts.prodstack["input_b"])]
    assert np.abs(v[:, keep] - 1.0).max() < 1e-5
