"""BeamTransfer: generation, projections, SVD and persistence, draco_tpu_torch
against draco_tpu.

Two telescopes: a 2 x 2 dish array (compact beams: the windowed generator
and streaming projections) and a two-cylinder array (wide beams: the dense
full-sphere generator and streaming projections), at nside 16.

Tolerances, max|diff| / max|ref|: float32 against float32 2e-5; the SVD's
singular spectrum and its projector onto the kept modes, 1e-4.  The port's
windowed streaming projections contract against two-float band Legendre
tables where the JAX package's use a single-float one, so they are held to
the float64 round trip of the same sky instead (1e-6 of the map's peak).  The SVD
cut is 1e-4 here: at the default 1e-6 the smallest kept modes sit in
float32's noise (singular values ~1e-6 of the maximum, while the spectra
of the two packages differ by ~1e-8 of it), so their singular vectors,
and the projector, are not determined to 1e-4 in either package.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import draco_tpu.telescope as J
from draco_tpu.ops import sht as jsht
from draco_tpu_torch import telescope as T
from draco_tpu_torch.ops import sht
from draco_tpu_torch.telescope.roundtrip import fused_simulate_to_map

TOL32 = 2e-5
TOL_F64 = 1e-6
TOL_SVD = 1e-4
SVCUT = 1e-4
NSIDE = 16
CPU = torch.device("cpu")
LMAX = dict(force_lmax=3 * NSIDE - 1, force_mmax=3 * NSIDE - 1)
CONFIGS = {
    "dish": (
        "UnpolarisedDishArray",
        dict(grid_ew=2, grid_ns=2, spacing_ew=4.0, spacing_ns=4.0, latitude=30.0, freq_lower=400.0,
             freq_upper=500.0, num_freq=2, dish_width=8.0, auto_correlations=True, **LMAX),
    ),
    "cylinder": (
        "UnpolarisedCylinderTelescope",
        dict(num_cylinders=2, cylinder_width=10.0, cylinder_spacing=12.0, num_feeds=2, feed_spacing=3.0,
             latitude=45.0, freq_lower=400.0, freq_upper=500.0, num_freq=2, auto_correlations=True, **LMAX),
    ),
}


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _pair(name):
    cls, cfg = CONFIGS[name]
    jbt = J.BeamTransfer(telescope=getattr(J, cls)(**cfg), nside=NSIDE, svcut=SVCUT)
    bt = T.BeamTransfer(getattr(T, cls)(**cfg), nside=NSIDE, svcut=SVCUT)
    return jbt, bt


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    jbt, bt = _pair(request.param)
    windowed = request.param == "dish"
    assert (jbt._beam_window() is not None) == windowed and (bt._beam_window() is not None) == windowed
    jbt.generate()
    bt.generate(device=CPU)
    tel = jbt.telescope
    rng = np.random.Generator(np.random.SFC64(3))
    sky = rng.standard_normal((tel.nfreq, 1, 12 * NSIDE**2)).astype(np.float32)
    alm = np.asarray(jsht.sphtrans_sky(sky, lmax=tel.lmax))[..., : tel.mmax + 1].astype(np.complex64)
    shape = (tel.mmax + 1, 2, tel.nfreq, len(tel.uniquepairs))
    vis = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    w = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    return dict(name=request.param, jbt=jbt, bt=bt, alm=alm, vis=vis, w=w, sky=sky)


def test_generate_matches_jax(case):
    jbt, bt = case["jbt"], case["bt"]
    for got, want in ((bt._bp, jbt._bp), (bt._bm, jbt._bm)):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.complex64 and got.device == CPU
        assert _rel(got.numpy(), want) <= TOL32
    assert (bt._bm[..., 0] == 0).all()


def test_properties_and_beam_m_match_jax(case):
    jbt, bt = case["jbt"], case["bt"]
    assert (bt.nfreq, bt.ntel, bt.nsky) == (jbt.nfreq, jbt.ntel, jbt.nsky)
    for fi in (None, 1):
        got, want = bt.beam_m(5, fi=fi), np.asarray(jbt.beam_m(5, fi=fi))
        assert got.shape == want.shape and _rel(got.numpy(), want) <= TOL32
    got = bt.project_vector_sky_to_telescope(5, case["alm"][..., 5])
    assert _rel(got.numpy(), jbt.project_vector_sky_to_telescope(5, case["alm"][..., 5])) <= TOL32


def test_batched_projections_match_jax(case):
    jbt, bt = case["jbt"], case["bt"]
    fwd = bt.project_sky_to_telescope(case["alm"])
    want = np.asarray(jbt.project_sky_to_telescope(case["alm"]))
    assert fwd.shape == want.shape and _rel(fwd.numpy(), want) <= TOL32
    adj = bt.project_telescope_to_sky_dirty(case["vis"], case["w"])
    want = np.asarray(jbt.project_telescope_to_sky_dirty(case["vis"], case["w"]))
    assert adj.shape == want.shape and _rel(adj.numpy(), want) <= TOL32


def _composed_vs_float64(bt, sky, w, nside, project, adjoint):
    """The streaming forward then adjoint projection of ``sky``'s float64
    alm, synthesised in float64, against the float64 fused round trip:
    max|diff| / max|map|."""
    sky64, w64 = torch.from_numpy(np.asarray(sky, np.float64)), torch.from_numpy(np.asarray(w, np.float64))
    tel = bt.telescope
    truth = fused_simulate_to_map(bt, sky64, chunk=64, weight=w64, device="cpu")
    alm = sht.sphtrans_sky(sky64, lmax=tel.lmax, device="cpu")[..., : tel.mmax + 1].to(torch.complex64)
    dirty = torch.as_tensor(np.asarray(adjoint(np.asarray(project(alm)), w64.float().numpy())))
    composed = sht.sphtrans_inv_sky(dirty.to(torch.complex128), nside)
    return ((composed - truth).abs().max() / truth.abs().max()).item()


def test_streaming_projections_match_jax(case):
    jbt, bt = case["jbt"], case["bt"]
    fwd = bt.project_sky_to_telescope_streaming(case["alm"], chunk=3, device="cpu")
    assert fwd.shape == (bt.telescope.mmax + 1, 2, bt.nfreq, len(bt.telescope.uniquepairs))
    assert fwd.dtype == torch.complex64
    adj = bt.project_telescope_to_sky_dirty_streaming(case["vis"], case["w"], chunk=3, device="cpu")
    if case["name"] == "dish":
        # windowed: two-float tables, held to the float64 round trip
        rel = _composed_vs_float64(
            bt, case["sky"], case["w"], NSIDE,
            lambda a: bt.project_sky_to_telescope_streaming(a, chunk=3),
            lambda v, w: bt.project_telescope_to_sky_dirty_streaming(v, w, chunk=3, device="cpu"),
        )
        assert rel <= TOL_F64, rel
    else:
        want = np.asarray(jbt.project_sky_to_telescope_streaming(case["alm"], chunk=3))
        assert fwd.shape == want.shape and _rel(fwd.numpy(), want) <= TOL32
        want = np.asarray(jbt.project_telescope_to_sky_dirty_streaming(case["vis"], case["w"], chunk=3))
        assert adj.shape == want.shape and _rel(adj.numpy(), want) <= TOL32
    # and the streaming operator is the materialised one
    assert _rel(fwd.numpy(), bt.project_sky_to_telescope(case["alm"]).numpy()) <= TOL32
    assert _rel(adj.numpy(), bt.project_telescope_to_sky_dirty(case["vis"], case["w"]).numpy()) <= TOL32


def test_windowed_streaming_projections_closer_to_float64_than_single_float_tables():
    """At nside 32 (2 x 2 dishes, lmax 95), the composed float32 windowed
    streaming projections sit 1.7e-07 of the peak from the float64 round
    trip; the JAX package's, which contract against a single-float band
    Legendre table as the port's did before, sit 2.1e-06 from it.  Limits:
    the port within 5e-7, and at least 4 times closer than the JAX
    package's."""
    nside = 32
    cfg = dict(CONFIGS["dish"][1], force_lmax=3 * nside - 1, force_mmax=3 * nside - 1)
    jbt = J.BeamTransfer(telescope=J.UnpolarisedDishArray(**cfg), nside=nside)
    bt = T.BeamTransfer(T.UnpolarisedDishArray(**cfg), nside=nside)
    tel = bt.telescope
    rng = np.random.Generator(np.random.SFC64(3))
    sky = rng.standard_normal((tel.nfreq, 1, 12 * nside**2))
    w = rng.uniform(0.5, 2.0, (tel.mmax + 1, 2, tel.nfreq, len(tel.uniquepairs)))
    port = _composed_vs_float64(
        bt, sky, w, nside,
        lambda a: bt.project_sky_to_telescope_streaming(a, chunk=3),
        lambda v, w32: bt.project_telescope_to_sky_dirty_streaming(v, w32, chunk=3, device="cpu"),
    )
    single = _composed_vs_float64(
        bt, sky, w, nside,
        lambda a: jbt.project_sky_to_telescope_streaming(a.numpy(), chunk=3),
        lambda v, w32: jbt.project_telescope_to_sky_dirty_streaming(v, w32, chunk=3),
    )
    print(f"windowed streaming vs float64 round trip: two-float {port:.3e}, single-float {single:.3e}")
    assert port <= 5e-7 and single >= 4 * port, (port, single)


def test_svd_spectrum_and_projector_match_jax(case):
    jbt, bt = case["jbt"], case["bt"]
    s, js = bt.svd_spectrum(), np.asarray(jbt.svd_spectrum())
    assert s.shape == js.shape
    assert np.abs(s.numpy() - js).max() <= TOL_SVD * js.max()
    assert bt.svd_len() == jbt.svd_len() and bt.ndofmax == jbt.ndofmax
    assert np.array_equal(bt.nmodes().numpy(), np.asarray(jbt.nmodes()))
    # the projector onto the kept modes (U's phases are arbitrary)
    got = bt.project_svd_to_telescope(bt.project_telescope_to_svd(case["vis"]))
    want = np.asarray(jbt.project_svd_to_telescope(jbt.project_telescope_to_svd(case["vis"])))
    assert got.shape == want.shape and _rel(got.numpy(), want) <= TOL_SVD
    # idempotent: a projected vector projects onto itself
    M1, f, ntel = got.shape
    again = bt.project_svd_to_telescope(bt.project_telescope_to_svd(got.reshape(M1, f, 2, -1).movedim(2, 1)))
    assert _rel(again.numpy(), got.numpy()) <= TOL_SVD
    # the per-m vector forms are the batched ones at one m
    tm = case["vis"][7].transpose(1, 0, 2).reshape(f, ntel)
    one = bt.project_vector_svd_to_telescope(7, bt.project_vector_telescope_to_svd(7, tm))
    assert _rel(one.numpy(), got[7].numpy()) <= 1e-5


def test_save_load_round_trip(tmp_path):
    _, bt = _pair("dish")
    bt.generate(device=CPU)
    bt.save(str(tmp_path))
    back = T.BeamTransfer(directory=str(tmp_path), device="cpu", nside=NSIDE)
    assert type(back.telescope) is T.UnpolarisedDishArray
    assert back.telescope.uniquepairs.tolist() == bt.telescope.uniquepairs.tolist()
    assert torch.equal(back._bp, bt._bp) and torch.equal(back._bm, bt._bm)
    alm = torch.ones(2, 1, 48, 48, dtype=torch.complex64)
    assert torch.equal(back.project_sky_to_telescope(alm), bt.project_sky_to_telescope(alm))


def test_load_of_a_jax_directory_imports_no_jax(tmp_path):
    jbt, _ = _pair("cylinder")
    jbt.save(str(tmp_path))
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from draco_tpu_torch.telescope import BeamTransfer, UnpolarisedCylinderTelescope\n"
        f"bt = BeamTransfer(nside={NSIDE}).load({str(tmp_path)!r}, device='cpu')\n"
        "assert type(bt.telescope) is UnpolarisedCylinderTelescope, type(bt.telescope)\n"
        f"bp = np.load({str(tmp_path / 'beam_p.npy')!r})\n"
        "assert np.array_equal(bt._bp.numpy(), bp) and bt._bm.shape == bp.shape\n"
        "assert bt.svd_spectrum().shape[:2] == (bt.nfreq, bt.telescope.mmax + 1)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'draco_tpu') or m.startswith(('jax.', 'draco_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, env=dict(os.environ, PYTHONPATH=root),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_svd_built_before_load_is_rebuilt(tmp_path):
    jcyl, cyl = _pair("cylinder")
    jcyl.save(str(tmp_path))
    _, bt = _pair("dish")
    bt.generate(device=CPU)
    stale = bt.svd_spectrum().clone()
    bt.load(str(tmp_path), device="cpu")
    fresh = bt.svd_spectrum()
    cyl.generate(device=CPU)
    assert fresh.shape == cyl.svd_spectrum().shape
    assert torch.allclose(fresh, cyl.svd_spectrum(), rtol=0, atol=TOL_SVD * float(fresh.max()))
    assert not (fresh.shape == stale.shape and torch.equal(fresh, stale))
    assert bt._beam_window() is None  # the window of the loaded telescope, not the dishes'


def test_sphtrans_sky_feeds_the_projections(case):
    """The port's own SHT in front of the batched projection gives JAX's chain."""
    tel = case["jbt"].telescope
    sky = np.random.Generator(np.random.SFC64(4)).standard_normal((tel.nfreq, 1, 12 * NSIDE**2))
    alm = sht.sphtrans_sky(sky.astype(np.float32), lmax=tel.lmax, device="cpu")[..., : tel.mmax + 1]
    want = np.asarray(case["jbt"].project_sky_to_telescope(
        np.asarray(jsht.sphtrans_sky(sky.astype(np.float32), lmax=tel.lmax))[..., : tel.mmax + 1]
    ))
    assert _rel(case["bt"].project_sky_to_telescope(alm).numpy(), want) <= TOL32
