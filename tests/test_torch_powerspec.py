"""The power-spectrum path: draco_tpu_torch against draco_tpu on the same inputs.

Sizes of ``tests/test_powerspec.py`` (32 channels of 1 MHz, 8 RA, 5
elevations, a 2 x 2 dish array), numpy inputs from a seed; the JAX
package on the CPU with 64-bit types, the port on the CPU.  Tolerances,
max|diff| / max|ref|:

- the cosmology conversions, masks, bin edges and Fourier modes: 1e-15
  (host numpy copies);
- the Jy/beam -> K factor applied to a map: 1e-15;
- the Wiener operator: 1e-6 (both invert in complex128 and store
  complex64);
- the applied transform: 1e-6 (complex64 einsums in both, the same
  operator);
- the spatial transform: 1e-12 (complex128 FFTs);
- the 3D spectra 1e-12; the 2D and 1D binnings 1e-12: torch's ``bincount``
  sums float64 weights in its own order, numpy's in input order, so the
  sums of the few hundred terms of a bin agree to a few ulps, not bit for
  bit.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from draco_tpu.analysis import powerspec as jps
from draco_tpu.core import containers as jcontainers
from draco_tpu.telescope import UnpolarisedDishArray as JDishArray
from draco_tpu_torch.analysis import powerspec as ps
from draco_tpu_torch.core import containers
from draco_tpu_torch.device import default_device
from draco_tpu_torch.telescope import UnpolarisedDishArray

NFREQ = 32
FREQ = np.linspace(500.0, 532.0, NFREQ, endpoint=False)  # df = 1 MHz
TAU0 = 5.0 / 32.0  # microseconds: exactly bin 5 of a 32-point FFT
NRA, NEL = 8, 5
TEL = dict(
    grid_ew=2, grid_ns=2, spacing_ew=20.0, spacing_ns=6.0, latitude=45.0, freq_lower=500.0, freq_upper=532.0,
    num_freq=2, auto_correlations=True,
)


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    ok = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), ok)
    return np.abs(got[ok] - ref[ok]).max() / max(np.abs(ref[ok]).max(), 1e-300)


def _run(task, params, setup, *inputs):
    task.read_config(params)
    if setup is not None:
        task.setup(*setup)
    return task.process(*inputs)


@pytest.fixture(scope="module")
def tels():
    return JDishArray(**TEL), UnpolarisedDishArray(**TEL)


def _ringmap(package, seed=3, masked=False, clean=False):
    """Two polarisations: a delay tone whose amplitude is separable in (ra,
    el), noise, random weights, a non-identity spectral filter, an SPD
    freq-freq covariance and a varying dirty-beam power; ``clean``: the
    tone alone, unit weights, identity filter and covariance, unit beam."""
    rng = np.random.Generator(np.random.SFC64(seed))
    rm = package.RingMap(freq=FREQ, beam=np.arange(1), pol=np.array(["XX", "YY"]), ra=NRA,
                         el=np.linspace(-0.05, 0.05, NEL))
    amp = (1.0 + np.arange(NRA))[:, None] * (1.0 + 10 * np.arange(NEL))[None, :]
    tone = np.cos(2 * np.pi * TAU0 * FREQ)
    m = tone[None, :, None, None] * amp + (0 if clean else 0.1) * rng.standard_normal((2, NFREQ, NRA, NEL))
    rm.map[:] = m[None]
    w = np.ones(rm.datasets["weight"].shape) if clean else rng.uniform(0.5, 2.0, rm.datasets["weight"].shape)
    if masked:
        w[:, 10:12] = 0.0
        w[1, 20, 3] = 0.0
    rm.datasets["weight"][:] = w
    eye = np.broadcast_to(np.eye(NFREQ)[None, :, :, None], (2, NFREQ, NFREQ, NRA))
    a = rng.standard_normal((2, NRA, NFREQ, NFREQ))
    cov = np.moveaxis(np.einsum("prij,prkj->prik", a, a) / NFREQ + np.eye(NFREQ), 1, 3)
    rm.add_dataset("filter")
    rm.datasets["filter"][:] = eye if clean else eye + 0.01 * rng.standard_normal(eye.shape)
    rm.add_dataset("freq_cov")
    rm.datasets["freq_cov"][:] = eye if clean else cov
    rm.add_dataset("dirty_beam_power")
    dbp = rm.datasets["dirty_beam_power"]
    dbp[:] = np.ones(dbp.shape) if clean else rng.uniform(0.5, 1.5, dbp.shape)
    return rm


def test_cosmology_helpers_match_jax():
    z = np.array([0.8, 1.0, 1.5])
    for name in ("f2z", "z2f"):
        assert _rel(getattr(ps, name)(FREQ), getattr(jps, name)(FREQ)) <= 1e-15
    for name in ("dRperp_dtheta", "dRpara_df"):
        assert _rel(getattr(ps, name)(z), getattr(jps, name)(z)) <= 1e-15
    for name, x in (("delays_to_kpara", 1e-6), ("kpara_to_delay", 0.3), ("u_to_kperp", 50.0), ("kperp_to_u", 0.02)):
        assert _rel(getattr(ps, name)(x, z), getattr(jps, name)(x, z)) <= 1e-15
    assert _rel(ps.jy_per_beam_to_kelvin(FREQ, 60.0), jps.jy_per_beam_to_kelvin(FREQ, 60.0)) <= 1e-15
    for window in ("uniform", "hann", "tukey-0.5", "blackman_harris"):
        assert abs(ps.noise_equivalent_bandwidth(64, window) - jps.noise_equivalent_bandwidth(64, window)) <= 1e-15
    ra, dec = np.linspace(0.0, 10.0, NRA), np.linspace(40.0, 50.0, NEL)
    for a, b in zip(ps.get_fourier_modes(ra, dec, np.arange(4) * 1e-7, 1.0), jps.get_fourier_modes(ra, dec,
                                                                                                np.arange(4) * 1e-7, 1.0)):
        assert _rel(a, b) <= 1e-15
    assert ps.vol_normalization(ra, dec, FREQ, 1.0) == pytest.approx(jps.vol_normalization(ra, dec, FREQ, 1.0), rel=1e-15)
    kx, ky = np.linspace(-0.5, 0.5, 9), np.linspace(-0.3, 0.3, 7)
    args = (10.0, 60.0, 20.0, 0.5, 0.6, 1.0)
    assert np.array_equal(ps.spatial_mask(kx, ky, *args), jps.spatial_mask(kx, ky, *args))
    for a, b in zip(ps.reshape_data_cube(np.arange(63.0).reshape(9, 7), kx, ky, 0.1, 0.4),
                    jps.reshape_data_cube(np.arange(63.0).reshape(9, 7), kx, ky, 0.1, 0.4)):
        assert np.array_equal(a, b)
    for log in (True, False):
        assert np.array_equal(ps._k_edges(0.01, 1.0, 6, log), jps._k_edges(0.01, 1.0, 6, log))


def test_bin_select_is_numpy_digitize():
    edges = np.array([0.1, 0.2, 0.5, 1.0])
    values = np.array([0.05, 0.1, 0.15, 0.2, 0.49, 0.5, 0.99, 1.0, 1.5])
    inside, b = ps._bin_select(torch.as_tensor(values), edges)
    jinside, jb = jps._bin_select(values, edges)
    assert np.array_equal(inside.numpy(), jinside) and np.array_equal(b.numpy(), jb)


@pytest.mark.parametrize("in_place", [True, False])
def test_jy_per_beam_to_kelvin_matches_jax(tels, in_place):
    outs = []
    for package, module, tel in ((jcontainers, jps, tels[0]), (containers, ps, tels[1])):
        rm = _ringmap(package)
        task = module.TransformJyPerBeamToKelvin()
        out = _run(task, {"in_place": in_place, "ncyl": 3}, (tel,), rm)
        assert (out is rm) == in_place
        outs.append((task, rm, out))
    (jt, _, jout), (t, rm, out) = outs
    assert t.bl_max == jt.bl_max
    assert _rel(out.map[:], np.asarray(jout.map[:])) <= 1e-15
    assert _rel(out.weight[:], np.asarray(jout.weight[:])) <= 1e-15
    if not in_place:
        # and back: the input is untouched, the factor divides out
        factor = torch.as_tensor(ps.jy_per_beam_to_kelvin(FREQ, t.bl_max))
        assert _rel(out.map[:] / factor[None, None, :, None, None], rm.map[:]) <= 1e-15


WIENER_CASES = {
    "uniform": ({"prior_amp": 100.0, "window": "uniform"}, False),
    "masked": ({"prior_amp": 100.0}, True),
    "hann_band": ({"prior_amp": 10.0, "prior_scale": 0.5, "window": "hann", "window_lower_freq": 502.0,
                   "window_upper_freq": 528.0}, True),
}


@pytest.fixture(scope="module")
def operators():
    out = {}
    for case, (params, masked) in WIENER_CASES.items():
        jrm, rm = _ringmap(jcontainers, masked=masked), _ringmap(containers, masked=masked)
        jop = _run(jps.ConstructWienerDelayTransform(), params, None, jrm)
        op = _run(ps.ConstructWienerDelayTransform(), params, None, rm)
        out[case] = (jrm, rm, jop, op)
    return out


@pytest.mark.parametrize("case", list(WIENER_CASES))
def test_wiener_operator_matches_jax(operators, case):
    jrm, rm, jop, op = operators[case]
    assert isinstance(op, containers.DelayTransformOperator)
    assert np.array_equal(op.index_map["delay"], jop.index_map["delay"])
    for key in ("window", "window_lower_freq", "window_upper_freq"):
        assert op.attrs[key] == jop.attrs[key]
    assert _rel(op.filter[:], np.asarray(jop.filter[:])) <= 1e-6
    if WIENER_CASES[case][1]:
        f = op.filter[:].numpy()
        assert np.all(f[..., 10:12] == 0)  # the masked channels are not used


@pytest.mark.parametrize("case", list(WIENER_CASES))
def test_apply_wiener_matches_jax(operators, case):
    jrm, rm, jop, op = operators[case]
    jds = _run(jps.ApplyWienerDelayTransform(), {}, None, jrm, jop)
    ds = _run(ps.ApplyWienerDelayTransform(), {}, None, rm, op)
    assert isinstance(ds, containers.DelayTransform) and ds.spectrum.shape == (2 * NEL, NRA, len(op.delay))
    assert list(ds.attrs["baseline_axes"]) == ["pol", "el"]
    for key in ("window_los", "window_los_lower_freq", "window_los_upper_freq"):
        assert ds.attrs[key] == jds.attrs[key]
    assert _rel(ds.spectrum[:], np.asarray(jds.spectrum[:])) <= 1e-6
    assert _rel(ds.weight[:], np.asarray(jds.weight[:])) <= 1e-6


def test_apply_wiener_recovers_the_tone_in_its_baseline_layout():
    """spectrum[b, r] is (pol = b // nel, el = b % nel, ra = r): the tone's
    amplitude at its delay bin follows the map's separable (ra, el) pattern."""
    rm = _ringmap(containers, clean=True)
    op = _run(ps.ConstructWienerDelayTransform(), {"prior_amp": 100.0}, None, rm)
    ds = _run(ps.ApplyWienerDelayTransform(), {}, None, rm, op)
    delay = np.asarray(ds.index_map["delay"])
    spec = ds.spectrum[:].numpy().reshape(2, NEL, NRA, -1)
    power = np.abs(spec).mean(axis=(0, 1, 2))
    ipeak = int(np.argmax(power))
    assert np.isclose(delay[ipeak], TAU0, atol=1.0 / 32)
    peak = np.abs(spec[:, :, :, ipeak])
    expect = (1.0 + 10 * np.arange(NEL))[:, None] * (1.0 + np.arange(NRA))[None, :]
    ratio = peak / expect[None]
    assert np.abs(ratio / ratio.mean() - 1).max() < 1e-3
    far = np.abs(delay - TAU0) > 3.0 / 32
    assert power[ipeak] > 10 * power[far].max()


@pytest.fixture(scope="module")
def cubes(operators, tels):
    jrm, rm, jop, op = operators["uniform"]
    jds = _run(jps.ApplyWienerDelayTransform(), {}, None, jrm, jop)
    ds = _run(ps.ApplyWienerDelayTransform(), {}, None, rm, op)
    ds.spectrum[:] = np.asarray(jds.spectrum[:])  # one input for both
    ds.weight[:] = np.asarray(jds.weight[:])
    params = {"ew_min": 0.0, "ew_max": 10.0, "ns_bl": 10.0}
    out = {}
    for window in (True, False):
        p = {**params, "apply_spatial_window": window}
        out[window] = (_run(jps.SpatialTransformDelayMap(), p, (tels[0],), jds),
                       _run(ps.SpatialTransformDelayMap(), p, (tels[1],), ds))
    return out


@pytest.mark.parametrize("window", [True, False])
def test_spatial_transform_matches_jax(cubes, window):
    jcube, cube = cubes[window]
    assert isinstance(cube, containers.SpatialDelayCube)
    for ax in ("u", "v", "delay", "pol"):
        assert np.array_equal(cube.index_map[ax], jcube.index_map[ax]), ax
    for name in ("kx", "ky", "kpara"):
        assert _rel(cube.datasets[name][:], np.asarray(jcube.datasets[name][:])) <= 1e-15
    assert np.array_equal(cube.uv_mask[:], np.asarray(jcube.uv_mask[:]))
    assert _rel(cube.vis[:], np.asarray(jcube.vis[:])) <= 1e-12
    for key in ("freq_center", "redshift", "volume", "window_spatial", "effective_ra", "effective_dec"):
        assert cube.attrs[key] == pytest.approx(jcube.attrs[key], rel=1e-15) if key != "window_spatial" else (
            cube.attrs[key] == jcube.attrs[key])


@pytest.fixture(scope="module")
def spectra3d(cubes):
    jcube, cube = cubes[True]
    return _run(jps.AutoPowerSpectrum3D(), {}, None, jcube), _run(ps.AutoPowerSpectrum3D(), {}, None, cube)


def test_3d_spectra_match_jax(cubes, spectra3d):
    jp, p = spectra3d
    assert isinstance(p, containers.PowerSpectrum3D)
    assert list(p.index_map["pol"]) == list(jp.index_map["pol"]) == ["XX-XX", "XX-YY", "YY-XX", "YY-YY"]
    assert p.attrs["ps_norm"] == pytest.approx(jp.attrs["ps_norm"], rel=1e-15)
    assert _rel(p.spectrum[:], np.asarray(jp.spectrum[:])) <= 1e-12
    assert (p.spectrum[:].real[[0, 3]] >= 0).all()  # the autos are non-negative
    (jc1, c1), (jc2, c2) = cubes[True], cubes[False]
    c2.attrs["tag"] = jc2.attrs["tag"] = "other"
    jx = _run(jps.CrossPowerSpectrum3D(), {}, None, jc1, jc2)
    x = _run(ps.CrossPowerSpectrum3D(), {}, None, c1, c2)
    assert x.attrs["tag"] == jx.attrs["tag"]
    assert _rel(x.spectrum[:], np.asarray(jx.spectrum[:])) <= 1e-12


CYL_CASES = {
    # every kperp bin holds cells (an empty one is NaN, and NaN bins make every 1D bin NaN)
    "linear": {"bl_min": 0.001, "bl_max": 10.0, "Nbins_2D": 4, "delay_cut": 0.0},
    "log_cut": {"bl_min": 0.5, "bl_max": 10.0, "Nbins_2D": 3, "logbins_2D": True, "delay_cut": 1.0e-7},
}


@pytest.mark.parametrize("case", list(CYL_CASES))
def test_cylindrical_and_spherical_spectra_match_jax(spectra3d, case):
    jp, p = spectra3d
    params = CYL_CASES[case]
    j2 = _run(jps.CylindricalPowerSpectrum2D(), params, (), jp)
    t2 = _run(ps.CylindricalPowerSpectrum2D(), params, (), p)
    assert isinstance(t2, containers.PowerSpectrum2D)
    assert np.array_equal(t2.index_map["uv_dist"], j2.index_map["uv_dist"])
    for name in ("spectrum", "weight", "neff", "kperp", "kpara"):
        assert _rel(t2.datasets[name][:], np.asarray(j2.datasets[name][:])) <= 1e-12, name
    assert np.array_equal(t2.mask[:], np.asarray(j2.mask[:]))

    for params1 in ({"Nbins_3D": 5, "logbins_3D": False}, {"bin_edges": [0.01, 0.1, 1.0, 10.0]}):
        j1 = _run(jps.SphericalPowerSpectrum2Dto1D(), params1, None, j2)
        t1 = _run(ps.SphericalPowerSpectrum2Dto1D(), params1, None, t2)
        assert isinstance(t1, containers.PowerSpectrum1D)
        for name in ("k1D", "spectrum", "samp_var", "var", "neff"):
            assert _rel(t1.datasets[name][:], np.asarray(j1.datasets[name][:])) <= 1e-12, name

    params3 = {k: v for k, v in params.items() if k != "Nbins_2D" and k != "logbins_2D"}
    params3.update(Nbins_3D=5, logbins_3D=False)
    j3 = _run(jps.SphericalPowerSpectrum3Dto1D(), params3, (), jp)
    t3 = _run(ps.SphericalPowerSpectrum3Dto1D(), params3, (), p)
    for name in ("k1D", "spectrum", "samp_var", "var", "neff"):
        assert _rel(t3.datasets[name][:], np.asarray(j3.datasets[name][:])) <= 1e-12, name


def test_get_1d_and_2d_ps_match_jax():
    rng = np.random.Generator(np.random.SFC64(9))
    kperp, kpara = np.linspace(0.01, 0.1, 10), np.linspace(0.01, 1.0, 20)
    ps2, w = rng.uniform(1.0, 2.0, (20, 10)), rng.uniform(0.5, 1.5, (20, 10))
    window = rng.uniform(size=(20, 10)) > 0.2
    for kw in ({}, {"signal_window": window, "logbins_3D": False}, {"kbins": np.array([0.01, 0.3, 1.2])}):
        got = ps.get_1d_ps(torch.as_tensor(ps2), kperp, kpara, torch.as_tensor(w), Nbins_3D=5, **kw)
        ref = jps.get_1d_ps(ps2, kperp, kpara, w, Nbins_3D=5, **kw)
        for a, b in zip(got, ref):
            assert _rel(a, b) <= 1e-12
    uu, vv = rng.uniform(-30, 30, 200), rng.uniform(-30, 30, 200)
    cube, wt = rng.standard_normal(200) + 1j * rng.standard_normal(200), rng.uniform(0.5, 1.5, 200)
    edges = np.linspace(0.0, 0.1, 6)
    for a, b in zip(ps.get_2d_ps(torch.as_tensor(cube), torch.as_tensor(wt), edges, uu, vv, 1.0),
                    jps.get_2d_ps(cube, wt, edges, uu, vv, 1.0)):
        assert _rel(a, b) <= 1e-12


def test_scale_delay_transform_and_excess_scatter_match_jax():
    rng = np.random.Generator(np.random.SFC64(12))
    outs = []
    for package, module in ((jcontainers, jps), (containers, ps)):
        ds = package.DelayTransform(baseline=4, sample=NRA, delay=6)
        ds.add_dataset("weight")
        ds.spectrum[:] = rng.standard_normal(ds.spectrum.shape) + 0j
        ds.weight[:] = np.ones(ds.weight.shape, np.float32)
        rm = package.RingMap(freq=np.array([500.0]), beam=np.arange(1), pol=np.array(["XX", "YY"]), ra=NRA,
                             el=np.linspace(-0.1, 0.1, 2))
        rm.map[:] = 1.0 + rng.uniform(size=rm.map.shape)
        outs.append(_run(module.ScaleDelayTransform(), {"in_place": False}, None, ds, rm))
        rng = np.random.Generator(np.random.SFC64(12))
    jout, out = outs
    assert _rel(out.spectrum[:], np.asarray(jout.spectrum[:])) <= 1e-15
    assert _rel(out.weight[:], np.asarray(jout.weight[:])) <= 1e-6

    outs = []
    for package, module in ((jcontainers, jps), (containers, ps)):
        rng = np.random.Generator(np.random.SFC64(13))
        rm = package.RingMap(freq=FREQ[:6], beam=np.arange(1), pol=np.array(["XX"]), ra=NRA, el=np.arange(3.0))
        rm.map[:] = rng.standard_normal(rm.map.shape)
        w = rng.uniform(0.5, 2.0, rm.weight.shape)
        w[0, 2] = 0.0
        rm.weight[:] = w
        outs.append(_run(module.ReduceExcessScatter(), {"axes": ["freq"], "dataset": "map", "weighting": "weighted"},
                         None, rm))
    jout, out = outs
    assert out.map.shape == (1, 1, 1, NRA, 3)
    assert _rel(out.map[:], np.asarray(jout.map[:])) <= 1e-12
    assert _rel(out.weight[:], np.asarray(jout.weight[:])) <= 1e-12
    assert out.attrs["reduction_op"] == jout.attrs["reduction_op"] == "chisq_per_dof"


# -- fixed-order binning --------------------------------------------------------------


def _tree_sum(vals: np.ndarray) -> float:
    """A bin's pairwise tree over its values in ascending order (the plan of
    ``ops/tools.py::segment_sum``)."""
    a = np.sort(vals).copy()
    step = 1
    while step < len(a):
        a[: len(a) - step : 2 * step] += a[step :: 2 * step][: len(a[: len(a) - step : 2 * step])]
        step *= 2
    return a[0] if len(a) else 0.0


def test_binned_sum_is_a_value_ordered_tree_in_any_item_order():
    from draco_tpu_torch.ops.tools import binned_sum

    rng = np.random.Generator(np.random.SFC64(12))
    x = rng.standard_normal((3, 1000)) * np.exp(rng.uniform(-8, 8, (3, 1000)))
    bins = rng.integers(0, 7, 1000)
    bins[bins == 5] = 6  # an empty bin sums to 0
    got = binned_sum(torch.as_tensor(x), torch.as_tensor(bins), 7)
    want = np.array([[_tree_sum(row[bins == b]) for b in range(7)] for row in x])
    assert np.array_equal(got.numpy(), want)
    perm = rng.permutation(1000)
    assert torch.equal(binned_sum(torch.as_tensor(x[:, perm]), torch.as_tensor(bins[perm]), 7), got)
    ref = np.stack([np.bincount(bins, weights=row, minlength=7) for row in x])
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(x).sum()


def _cells_shuffled(p, seed):
    """The 3D spectrum with its u cells in another order (every dataset with
    a u axis and the u index map permuted alike)."""
    perm = np.random.Generator(np.random.SFC64(seed)).permutation(len(p.index_map["u"]))
    q = p.copy()
    q.index_map["u"] = np.asarray(p.index_map["u"])[perm]
    for ds in q.datasets.values():
        if "u" in ds.axes:
            ax = ds.axes.index("u")
            data = ds[:]
            ds._data = (data.index_select(ax, torch.as_tensor(perm)) if isinstance(data, torch.Tensor)
                        else np.take(data, perm, axis=ax))
    return q


@pytest.mark.parametrize("case", list(CYL_CASES))
def test_binned_spectra_are_bit_identical_run_to_run_and_in_any_cell_order(spectra3d, case):
    """The 2D and 1D spectra sum their bins in a fixed order: two runs, and a
    run on the cells in another order, give the same bits."""
    _, p = spectra3d
    q = _cells_shuffled(p, 5)
    params = CYL_CASES[case]
    params3 = {k: v for k, v in params.items() if k not in ("Nbins_2D", "logbins_2D")}
    params3.update(Nbins_3D=5, logbins_3D=False)
    for cls, prm in ((ps.CylindricalPowerSpectrum2D, params), (ps.SphericalPowerSpectrum3Dto1D, params3)):
        a, b, c = (_run(cls(), prm, (), x) for x in (p, p, q))
        names = [n for n, ds in a.datasets.items() if isinstance(ds[:], torch.Tensor)]
        assert names
        for name in names:
            assert torch.equal(a.datasets[name][:], b.datasets[name][:]), (cls.__name__, name)
            assert torch.equal(a.datasets[name][:], c.datasets[name][:]), (cls.__name__, name)
        if cls is ps.CylindricalPowerSpectrum2D:
            one = [_run(ps.SphericalPowerSpectrum2Dto1D(), {"Nbins_3D": 5}, None, x) for x in (a, c)]
            assert all(torch.equal(one[0].datasets[n][:], one[1].datasets[n][:]) for n in ("spectrum", "var"))
