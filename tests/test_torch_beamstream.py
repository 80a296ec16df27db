"""Beam streams: draco_tpu_torch against draco_tpu on the same inputs.

``CreateBeamStreamFromTelescope`` (the telescope's ``beam_at`` on the
stream's (dec, ha) grid) and ``CreateBeamStream`` (a given celestial
``GridBeam``) run in both packages, the port on the CPU.

Tolerance: 1e-5 relative (max |diff| / max |ref|) on the beam stream and
its weights.  The difference from the JAX formula: the port reduces the
projected distance to the nearest turn in float64, ``d - round(d)``,
before taking ``exp(2 pi i d)`` in the beam's complex64, where the JAX
package (under x64 here) takes it of the unreduced ``d`` in float64.  The
float64 reduction is exact to ~1e-13 turns; the complex64 phasor and
product round to ~1e-7, well inside the tolerance (at CHIME's |d| ~ 300
turns an unreduced float32 phasor would be ~1e-4 rad off).
"""

import numpy as np
import pytest
import torch

from draco_tpu.analysis import beam as jbeam
from draco_tpu.core import containers as jcontainers
from draco_tpu.telescope import PolarisedCylinderTelescope as JPolCylinder
from draco_tpu_torch.analysis import beam
from draco_tpu_torch.core import containers
from draco_tpu_torch.device import default_device
from draco_tpu_torch.telescope import PolarisedCylinderTelescope

TOL = 1e-5
PTEL = dict(num_cylinders=2, num_feeds=2, feed_spacing=6.0, cylinder_spacing=20.0, latitude=45.0,
            freq_lower=400.0, freq_upper=420.0, num_freq=2, auto_correlations=True)


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


def _hybrid(mod, tel, nra=16, el=np.linspace(-0.3, 0.3, 5), ew=(0.0, 20.0, 300.0)):
    hv = mod.HybridVisStream(freq=tel.frequencies, pol=np.array(["XX", "XY", "YX", "YY"]), ew=np.array(ew), el=el,
                             ra=nra)
    hv.weight[:] = np.ones(hv.weight.shape, dtype=np.float32)
    return hv


def _run(task_cls, tel, *args):
    t = task_cls()
    t.read_config({})
    t.setup(tel)
    return t.process(*args)


@pytest.mark.parametrize("nra", [16, 45])
def test_beam_stream_from_telescope_matches_jax(tels, nra):
    jtel, ttel = tels
    jout = _run(jbeam.CreateBeamStreamFromTelescope, jtel, _hybrid(jcontainers, jtel, nra))
    tout = _run(beam.CreateBeamStreamFromTelescope, ttel, _hybrid(containers, ttel, nra))
    assert isinstance(tout, containers.HybridVisStream) and tuple(tout.vis.shape) == jout.vis.shape
    assert tout.vis[:].dtype == torch.complex64
    assert _rel(tout.vis[:], jout.vis[:]) <= TOL
    assert _rel(tout.weight[:], jout.weight[:]) <= TOL
    v = _np(tout.vis[:])
    # the EW=0 baseline has no fringe: the stream is the (real, non-negative) beam power
    v0 = v[[0, 3], :, 0]
    assert np.abs(v0.imag).max() < 1e-5 * np.abs(v0).max() and v0.real.min() > -1e-6
    # the nonzero EW baselines pick up a fringe: the phase varies across RA
    for e in (1, 2):
        ve = v[:, :, e]
        assert (np.abs(ve.imag)[np.abs(ve) > 1e-8] > 0).any()


def test_beam_stream_from_a_grid_beam_matches_jax(tels):
    """A GridBeam with non-trivial weights (zeros on part of the grid) and an
    out-of-band channel, through ``CreateBeamStream``."""
    jtel, ttel = tels
    jmaker = jbeam.CreateBeamStreamFromTelescope()
    jmaker.read_config({})
    jmaker.setup(jtel)
    jgrid = jmaker._evaluate_beam(_hybrid(jcontainers, jtel))
    rng = np.random.Generator(np.random.SFC64(3))
    w = rng.uniform(0.5, 2.0, jgrid.weight.shape).astype(np.float32)
    w[..., 1, :] = 0.0
    w[1] = 0.0
    jgrid.weight[:] = w
    tgrid = containers.GridBeam(theta=np.asarray(jgrid.theta), phi=np.asarray(jgrid.phi), input=np.array(["cm"]),
                                axes_from=_hybrid(containers, ttel))
    tgrid.beam[:] = np.asarray(jgrid.beam[:])
    tgrid.weight[:] = w
    jout = _run(jbeam.CreateBeamStream, jtel, _hybrid(jcontainers, jtel), jgrid)
    tout = _run(beam.CreateBeamStream, ttel, _hybrid(containers, ttel), tgrid)
    assert _rel(tout.vis[:], jout.vis[:]) <= TOL
    assert _rel(tout.weight[:], jout.weight[:]) <= TOL
    assert not _np(tout.weight[:])[:, 1].any()


def test_beam_stream_checks(tels):
    _, ttel = tels
    maker = beam.CreateBeamStreamFromTelescope()
    maker.read_config({})
    maker.setup(ttel)
    grid = maker._evaluate_beam(_hybrid(containers, ttel))
    task = beam.CreateBeamStream()
    task.read_config({})
    task.setup(ttel)
    with pytest.raises(RuntimeError, match="do not line up"):
        task.process(_hybrid(containers, ttel, el=np.linspace(-0.5, 0.5, 5)), grid)
    with pytest.raises(ValueError, match="does not divide 360 deg"):
        beam.CreateBeamStream._ra_placement(np.array([0.0, 7.0, 14.0]))
    idx, nra = beam.CreateBeamStream._ra_placement(np.array([-22.5, 0.0, 22.5]))
    assert nra == 16 and idx.tolist() == [15, 0, 1]
    grid.attrs["coords"] = "telescope"
    with pytest.raises(RuntimeError, match="celestial"):
        task.process(_hybrid(containers, ttel), grid)
