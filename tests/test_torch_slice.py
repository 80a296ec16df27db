"""The whole slice, time-ordered data -> regrid -> m-mode weights ->
weighted fused round trip -> dirty map: draco_tpu_torch against draco_tpu.

Tolerances: float32 against float32 (and the float32 weights against the
JAX regridder's float64 weights), max|diff| / max|ref| <= 2e-5; the
float64 regrid against the JAX regridder, 1e-10.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import draco_tpu.telescope.roundtrip as jrt
from draco_tpu.analysis.transform import LanczosRegridder
from draco_tpu.ops import mmode as jmmode
from draco_tpu.ops.tools import invert_no_zero as j_invert_no_zero
from draco_tpu.telescope import BeamTransfer as JBeamTransfer
from draco_tpu.telescope import UnpolarisedDishArray as JDishArray
from draco_tpu_torch.analysis.transform import mmode_weights, regrid_sidereal
from draco_tpu_torch.ops import mmode
from draco_tpu_torch.telescope import BeamTransfer, UnpolarisedDishArray
from draco_tpu_torch.telescope.roundtrip import fused_simulate_to_map

TOL32 = 2e-5
NSIDE = 16
CHUNK = 5
NTIME = 300
SAMPLES = 96  # >= 2 * mmax + 1 RA bins
CONFIG = dict(
    grid_ew=3, grid_ns=2, spacing_ew=4.0, spacing_ns=4.0, latitude=45.0,
    freq_lower=450.0, freq_upper=450.0, num_freq=1, dish_width=8.0,
    auto_correlations=True, force_lmax=3 * NSIDE - 1, force_mmax=3 * NSIDE - 1,
)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def time_stream(nfreq, nbase, ntime, seed):
    """Irregular samples of one sidereal day [0, 1), with zero-weight gaps."""
    rng = np.random.Generator(np.random.SFC64(seed))
    times = (np.arange(ntime) + rng.uniform(-0.3, 0.3, ntime)) / ntime
    times[0], times[-1] = 0.0, (ntime - 1) / ntime
    shape = (nfreq, nbase, ntime)
    vis = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    weight = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    weight[..., ntime // 4 : ntime // 4 + 6] = 0.0
    weight[:, 0, ::17] = 0.0
    return times, vis, weight


@pytest.fixture(scope="module")
def slice_run():
    jtel = JDishArray(**CONFIG)
    jbt = JBeamTransfer(telescope=jtel, nside=NSIDE)
    bt = BeamTransfer(UnpolarisedDishArray(**CONFIG), nside=NSIDE)
    nfreq, nbase, mmax = jtel.nfreq, len(jtel.uniquepairs), jtel.mmax
    times, vis, weight = time_stream(nfreq, nbase, NTIME, seed=21)
    end = float(times[-1])
    rng = np.random.Generator(np.random.SFC64(1))
    sky = rng.standard_normal((nfreq, 1, 12 * NSIDE**2)).astype(np.float32)

    # draco_tpu: LanczosRegridder -> MModeTransform weights -> fused round trip
    task = LanczosRegridder()
    task.samples, task.start, task.end = SAMPLES, 0.0, end
    task.kernel_width, task.epsilon = 5, 1e-3
    _, jvis, jni = task._regrid(vis, weight, times)
    jm = np.asarray(jmmode.make_marray(jvis, mmax=mmax))
    var_sum = np.asarray(j_invert_no_zero(jni)).sum(axis=-1)
    jw = np.broadcast_to(SAMPLES**2 * np.asarray(j_invert_no_zero(var_sum)), (mmax + 1, 2, nfreq, nbase))
    jmap = np.asarray(jrt.fused_simulate_to_map(jbt, sky, chunk=CHUNK, weight=np.ascontiguousarray(jw)))

    # draco_tpu_torch, float32
    _, v, ni = regrid_sidereal(
        torch.from_numpy(vis), torch.from_numpy(weight), times, SAMPLES, 0.0, end, 5, 1e-3
    )
    m = mmode.make_marray(v, mmax=mmax)
    w = mmode_weights(ni, mmax)
    tmap = fused_simulate_to_map(bt, torch.from_numpy(sky), chunk=CHUNK, weight=w)
    return dict(
        times=times, vis=vis, weight=weight, end=end, jm=jm, jw=jw,
        jmap=jmap, v=v, m=m, w=w, tmap=tmap, nbase=nbase,
    )


def test_slice_weights_match_jax(slice_run):
    r = slice_run
    assert r["w"].dtype == torch.float32 and r["w"].shape == r["jw"].shape
    assert _rel(r["w"].numpy(), r["jw"]) <= TOL32


def test_slice_map_matches_jax(slice_run):
    r = slice_run
    assert r["tmap"].shape == r["jmap"].shape
    assert torch.isfinite(r["tmap"]).all()
    assert _rel(r["tmap"].numpy(), r["jmap"]) <= TOL32


def test_slice_mmodes_match_jax_in_float64(slice_run):
    r = slice_run
    vis, weight = r["vis"].astype(np.complex128), r["weight"].astype(np.float64)
    task = LanczosRegridder()
    task.samples, task.start, task.end = SAMPLES, 0.0, r["end"]
    task.kernel_width, task.epsilon = 5, 1e-3
    _, jvis, _ = task._regrid(vis, weight, r["times"])
    _, v, _ = regrid_sidereal(
        torch.from_numpy(vis), torch.from_numpy(weight), r["times"], SAMPLES, 0.0, r["end"], 5, 1e-3
    )
    assert _rel(v.numpy(), jvis) <= 1e-10
    mmax = r["jm"].shape[0] - 1
    m = mmode.make_marray(v, mmax=mmax)
    assert _rel(m.numpy(), np.asarray(jmmode.make_marray(jvis, mmax=mmax))) <= 1e-10
    assert torch.isfinite(r["m"]).all() and r["m"].shape == r["jm"].shape


def test_port_imports_no_jax():
    # every module of the package (the CLI's __main__ included), found by
    # walking it, and the smoke script
    code = (
        "import importlib, pkgutil, sys\n"
        "import draco_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(draco_tpu_torch.__path__, 'draco_tpu_torch.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 54 and 'draco_tpu_torch.__main__' in names, names\n"
        "new = ['analysis.flagging', 'analysis.svdfilter', 'analysis.fgfilter', 'analysis.powerspectrum',\n"
        "       'ops.filters', 'telescope.kltransform', 'telescope.psestimation',\n"
        "       'analysis.delay', 'analysis.delayopt', 'ops.delay', 'ops.kernels',\n"
        "       'analysis.ringmapmaker', 'analysis.powerspec']\n"
        "assert all('draco_tpu_torch.' + n in names for n in new), names\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'draco_tpu') or m.startswith(('jax.', 'draco_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
