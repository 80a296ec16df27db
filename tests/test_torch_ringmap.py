"""The ring-map path: draco_tpu_torch against draco_tpu on the same inputs.

Small sizes (a 2 x 4-feed dual-pol cylinder with 2 frequencies and 16 RA
samples, as ``tests/test_ringmap.py``; hybrid m-modes with mmax 16, as
``tests/test_deconvolve.py``), numpy inputs from a seed; the JAX package
on the CPU with 64-bit types, the port on the CPU.  Tolerances,
max|diff| / max|ref|:

- the host helpers and ``MakeVisGrid``'s scatter: exact;
- ``BeamformNS``: 1e-6 for the complex64 hybrid stream (both compute in
  complex128 at precision 64 and round to complex64; 1e-5 at precision
  32), 1e-12 for its float32-stored weights' float64 sums before rounding
  (compared at 1e-6 after it);
- ``BeamformEW``: 1e-6 (the JAX package rotates the polarisations in
  complex64, the port in complex128; both transform in float64);
- the deconvolving makers: 1e-6 for the map, dirty beam, dirty-beam power
  and weight (both work in complex128, but the JAX package takes |beam|^2
  of the complex64 beam m-modes and inverts the float32 m-mode weights in
  float32: 2e-8 apart here); the analytical beam's m-modes 1e-6
  (complex128 FFTs rounded to complex64);
- ``RADependentWeights``: 1e-6 (the JAX package inverts the float32
  hybrid weights in float32, the port in float64: 9e-8 apart here);
- the noise reconstructions: the factors 1e-10 (float64), the
  float32-stored weights 1e-6.

Deliberate difference, held here: ``ReconstructVisFreqCov`` raises where
a Cholesky factorisation fails (the JAX package returns NaN factors).
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from draco_tpu.analysis import ringmapmaker as jrmm
from draco_tpu.analysis import transform as jtransform
from draco_tpu.core import containers as jcontainers
from draco_tpu.telescope import PolarisedCylinderTelescope as JPolCylinder
from draco_tpu_torch.analysis import ringmapmaker as rmm
from draco_tpu_torch.analysis import transform as ttransform
from draco_tpu_torch.core import containers
from draco_tpu_torch.device import default_device
from draco_tpu_torch.telescope import PolarisedCylinderTelescope

CYL = dict(
    num_cylinders=2, num_feeds=4, feed_spacing=1.0, cylinder_spacing=10.0, cylinder_width=10.0, latitude=45.0,
    num_freq=2, force_lmax=8, force_mmax=8, auto_correlations=True,
)
NRA = 16
MMAX = 16
FREQ = np.array([500.0, 510.0])
PTEL = dict(
    num_cylinders=2, num_feeds=3, feed_spacing=0.5, cylinder_spacing=20.0, latitude=45.0, freq_lower=500.0,
    freq_upper=520.0, num_freq=2, auto_correlations=True,
)


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch and the BLAS pools: these sizes gain nothing
    from threads, and beside other test workers spinning pools are slow."""
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
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _run(task, params, setup, *inputs):
    task.read_config(params)
    if setup is not None:
        task.setup(*setup)
    return task.process(*inputs)


@pytest.fixture(scope="module")
def cyl():
    return JPolCylinder(**CYL), PolarisedCylinderTelescope(**CYL)


def _stream(package, tel, seed=11, flagged=True, stacked=False):
    """A seeded dual-pol sidereal stream of the telescope's unique pairs:
    each its own stack, or (``stacked``) as ``CollateProducts`` labels them,
    every feed pair of the full triangle mapped onto its stack."""
    if stacked:
        maps = (jtransform if package is jcontainers else ttransform).TelescopeStreamMixIn()
        maps.setup(tel)
        ss = package.SiderealStream(
            freq=tel.frequencies, input=tel.nfeed, ra=NRA, prod=maps.bt_prod, stack=maps.bt_stack,
            reverse_map_stack=maps.bt_rev,
        )
    else:
        ss = package.SiderealStream(
            freq=tel.frequencies, input=tel.nfeed, ra=NRA, prod=np.array([[int(a), int(b)] for a, b in tel.uniquepairs])
        )
    rng = np.random.Generator(np.random.SFC64(seed))
    shape = ss.vis.shape
    ss.vis[:] = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    weight = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    if flagged:
        weight[1, 3] = 0.0  # one product flagged at one frequency
        weight[:, :, 5] = 0.0  # one RA sample flagged everywhere
    ss.weight[:] = weight
    flags = np.ones(ss.input_flags.shape, dtype=np.float32)
    if stacked:
        flags[2, 3:6] = 0.0  # one input out for three samples
    ss.input_flags[:] = flags
    return ss


@pytest.fixture(scope="module")
def streams(cyl):
    jtel, tel = cyl
    return _stream(jcontainers, jtel), _stream(containers, tel)


def _grids(cyl, streams, params=None):
    jtel, tel = cyl
    js, ts = streams
    params = params or {}
    return _run(jrmm.MakeVisGrid(), params, (jtel,), js), _run(rmm.MakeVisGrid(), params, (tel,), ts)


def test_host_helpers_match_jax(cyl):
    jtel, tel = cyl
    for bl in (np.array([[0.0, 0.0], [0.0, 2.0], [10.0, -2.0], [20.0, 4.0]]), tel.baselines):
        for a, b in zip(rmm.find_grid_indices(bl), jrmm.find_grid_indices(bl)):
            assert np.array_equal(a, b)
        for a, b in zip(rmm.find_basis(bl), jrmm.find_basis(bl)):
            assert np.array_equal(a, b)
    assert np.array_equal(rmm._ns_fft_axis(7, 0.5), jrmm._ns_fft_axis(7, 0.5))
    template = np.random.Generator(np.random.SFC64(3)).uniform(0.1, 1.0, (2, 3, 4, 5))
    for scheme in ("natural", "uniform", "inverse_variance"):
        w = rmm._ew_weighting(scheme, torch.as_tensor(template), (1,))
        jw = jrmm._ew_weighting(scheme, template, (1,))
        assert np.array_equal(_np(w), jw)
        assert _rel(rmm._sum_normalised(w), np.asarray(jrmm._sum_normalised(jw))) <= 1e-15


def test_scatter_plan_keeps_the_last_write_of_each_pass():
    """``index_put_`` with a repeated cell writes in no defined order on the
    card: each pass keeps its last source for a cell, as numpy's in-order
    assignment does, and the passes stay in order."""
    p = np.array([0, 1, 0, 0, 1])
    x = np.array([0, 0, 0, 1, 0])
    y = np.array([2, -1, 2, 0, -1])  # (0, 0, 2) and (1, 0, -1 -> 4) each named twice
    plan = rmm.scatter_plan([(p, x, y, np.arange(5), False), (p[:1], x[:1], y[:1], np.array([9]), True)], (2, 2, 5))
    first, second = plan
    assert first[3].tolist() == [2, 3, 4]  # sources kept, in their order
    assert list(zip(first[0], first[1], first[2])) == [(0, 0, 2), (0, 1, 0), (1, 0, 4)]
    assert second[3].tolist() == [9] and second[4]
    # and numpy's in-order assignment leaves the same grid
    grid = np.full((2, 2, 5), -1)
    for pp, xx, yy, src, _ in ([p, x, y, np.arange(5), False], [p[:1], x[:1], y[:1], np.array([9]), True]):
        grid[pp, xx, yy] = src
    planned = np.full((2, 2, 5), -1)
    for pp, xx, yy, src, _ in plan:
        planned[pp, xx, yy] = src
    assert np.array_equal(grid, planned)


@pytest.mark.parametrize("centered,stacked", [(False, False), (True, False), (False, True)])
def test_make_vis_grid_matches_jax(cyl, streams, centered, stacked):
    if stacked:
        streams = (_stream(jcontainers, cyl[0], stacked=True), _stream(containers, cyl[1], stacked=True))
        assert streams[1].is_stacked
    jgrid, grid = _grids(cyl, streams, {"centered": centered})
    assert isinstance(grid, containers.VisGridStream)
    for ax in ("pol", "ew", "ns", "ra"):
        assert np.array_equal(grid.index_map[ax], jgrid.index_map[ax]), ax
    assert grid.vis.shape == (4, 2, 2, 7, NRA)
    assert np.array_equal(_np(grid.vis[:]), np.asarray(jgrid.vis[:]))
    assert np.array_equal(_np(grid.weight[:]), np.asarray(jgrid.weight[:]))
    assert np.array_equal(_np(grid.redundancy[:]), np.asarray(jgrid.redundancy[:]))
    if stacked:
        assert grid.redundancy[:].max() > 1 and grid.redundancy[:, :, :, 4].sum() < grid.redundancy[:, :, :, 0].sum()


def test_make_vis_grid_measured_products_win_the_mirror_collision(cyl, streams):
    """At (ew 0, ns 0) the XX auto is its own mirror: the measured value
    stays, unconjugated; the YX cell there is the mirror of the measured XY."""
    jtel, tel = cyl
    _, ts = streams
    _, grid = _grids(cyl, streams)
    pol = list(grid.index_map["pol"])
    feedpol = tel.polarisation[tel.uniquepairs]
    label = np.char.add(feedpol[:, 0], feedpol[:, 1])
    xind, yind, _, _ = rmm.find_grid_indices(tel.baselines)
    vis = _np(ts.vis[:])
    auto = np.flatnonzero((label == "XX") & (xind == 0) & (yind == 0))[0]
    assert np.array_equal(_np(grid.vis[pol.index("XX"), :, 0, 0]), vis[:, auto])
    assert not np.array_equal(vis[:, auto], np.conj(vis[:, auto]))
    xy = np.flatnonzero((label == "XY") & (xind == 0) & (yind == 0))[0]
    assert np.array_equal(_np(grid.vis[pol.index("YX"), :, 0, 0]), np.conj(vis[:, xy]))


def test_make_vis_grid_reads_the_ra_of_a_time_stream_as_jax(cyl):
    """Without an ra axis or an lsd the RA is the local stellar angle of the samples."""
    jtel, tel = cyl
    times = tel.lsd_to_unix(100.0 + np.linspace(0.0, 0.5, 6))
    prod = np.array([[int(a), int(b)] for a, b in tel.uniquepairs])
    grids = []
    for package, task, t in ((containers, rmm, tel), (jcontainers, jrmm, jtel)):
        ts = package.TimeStream(freq=t.frequencies, input=t.nfeed, prod=prod, time=times)
        ts.input_flags[:] = np.ones(ts.input_flags.shape, dtype=np.float32)
        grids.append(_run(task.MakeVisGrid(), {}, (t,), ts))
    assert np.array_equal(grids[0].ra, grids[1].ra)
    assert np.allclose(grids[0].ra, tel.unix_to_lsa(times))


NS_CASES = {
    "natural": {},
    "natural_auto": {"include_auto": True},
    "inverse_variance": {"weight": "inverse_variance"},
    "hann": {"weight": "hann"},
    "hann_scaled": {"weight": "hann", "scaled": True},
    "dirty_beam": {"save_dirty_beam": True, "weight": "blackman"},
    "precision32": {"precision": 32},
}


@pytest.fixture(scope="module")
def grids(cyl, streams):
    return _grids(cyl, streams)


@pytest.mark.parametrize("case", list(NS_CASES))
def test_beamform_ns_matches_jax(grids, case):
    jgrid, grid = grids
    params = {"npix": 24, "span": 0.8, **NS_CASES[case]}
    jhv = _run(jrmm.BeamformNS(), params, None, jgrid)
    hv = _run(rmm.BeamformNS(), params, None, grid)
    assert isinstance(hv, containers.HybridVisStream) and hv.vis.dtype == torch.complex64
    assert np.array_equal(hv.index_map["el"], jhv.index_map["el"])
    tol = 1e-5 if case == "precision32" else 1e-6
    assert _rel(hv.vis[:], np.asarray(jhv.vis[:])) <= tol
    assert _rel(hv.weight[:], np.asarray(jhv.weight[:])) <= tol
    if params.get("save_dirty_beam"):
        assert _rel(hv.dirty_beam[:], np.asarray(jhv.dirty_beam[:])) <= tol
    for key in ("weight", "scaled", "include_auto", "freqmin", "nsmax"):
        assert hv.attrs[f"beamform_ns_{key}"] == jhv.attrs[f"beamform_ns_{key}"], key


@pytest.fixture(scope="module")
def hybrids(grids):
    jgrid, grid = grids
    params = {"npix": 24, "save_dirty_beam": True}
    jhv = _run(jrmm.BeamformNS(), params, None, jgrid)
    hv = _run(rmm.BeamformNS(), params, None, grid)
    # one input for both EW stages
    hv.vis[:] = np.asarray(jhv.vis[:])
    hv.weight[:] = np.asarray(jhv.weight[:])
    hv.dirty_beam[:] = np.asarray(jhv.dirty_beam[:])
    return jhv, hv


@pytest.mark.parametrize(
    "params",
    [{}, {"single_beam": True}, {"exclude_intracyl": True}, {"flag_ew": [True, False]}, {"weight_ew": "uniform"}],
    ids=["natural", "single_beam", "exclude_intracyl", "flag_ew", "uniform"],
)
def test_beamform_ew_matches_jax(hybrids, params):
    jhv, hv = hybrids
    jrm = _run(jrmm.BeamformEW(), params, None, jhv)
    rm = _run(rmm.BeamformEW(), params, None, hv)
    assert isinstance(rm, containers.RingMap)
    assert list(rm.index_map["pol"]) == list(jrm.index_map["pol"]) == ["XX", "reXY", "imXY", "YY"]
    assert rm.map.shape == jrm.map.shape == ((1 if params.get("single_beam") else 3), 4, 2, NRA, 24)
    for name in ("map", "weight", "rms", "dirty_beam"):
        assert _rel(rm.datasets[name][:], np.asarray(jrm.datasets[name][:])) <= 1e-6, name


@pytest.mark.parametrize("n", [5, 6])
def test_irfft_ignores_the_dc_and_nyquist_imaginary_parts_as_numpy_does(n):
    """torch's irfft and the JAX package's (numpy's) drop the imaginary part
    of the DC bin (and of the Nyquist bin at even n) alike."""
    import jax.numpy as jnp

    rng = np.random.Generator(np.random.SFC64(n))
    x = rng.standard_normal((3, n // 2 + 1)) + 1j * rng.standard_normal((3, n // 2 + 1))
    assert np.abs(x[:, 0].imag).min() > 0
    got = torch.fft.irfft(torch.as_tensor(x), n=n, dim=-1).numpy()
    assert np.abs(got - np.fft.irfft(x, n=n, axis=-1)).max() <= 1e-15
    assert np.abs(got - np.asarray(jnp.fft.irfft(jnp.asarray(x), n, axis=-1))).max() <= 1e-15
    real_edges = x.copy()
    real_edges[:, 0] = x[:, 0].real
    if n % 2 == 0:
        real_edges[:, -1] = x[:, -1].real
    assert np.abs(got - torch.fft.irfft(torch.as_tensor(real_edges), n=n, dim=-1).numpy()).max() <= 1e-15


def test_ring_map_maker_matches_jax(cyl, streams):
    jtel, tel = cyl
    js, ts = streams
    params = {"npix": 32, "weight": "natural"}
    jrm = _run(jrmm.RingMapMaker(), params, (jtel,), js)
    rm = _run(rmm.RingMapMaker(), params, (tel,), ts)
    assert isinstance(rm, containers.RingMap) and rm.map.shape == (3, 4, 2, NRA, 32)
    assert bool(torch.isfinite(rm.map[:]).all())
    for name in ("map", "weight", "rms"):
        assert _rel(rm.datasets[name][:], np.asarray(jrm.datasets[name][:])) <= 1e-6, name


# -- the deconvolving ring-map makers ------------------------------------------------------------


def _hybrid_mmodes(package, seed=5, source_idx=5):
    """(vis, beam) HybridVisMModes pair: a point source at an RA bin seen
    through a smooth EW-dependent beam transfer function, plus noise, with
    weights that vary over (m, pol, freq, ew) and a few that are zero."""
    kw = dict(mmax=MMAX, oddra=False, freq=FREQ, pol=np.array(["XX", "YY"]), ew=np.array([0.0, 20.0]),
              el=np.linspace(-0.2, 0.2, 4))
    hv, hb = package.HybridVisMModes(**kw), package.HybridVisMModes(**kw)
    rng = np.random.Generator(np.random.SFC64(seed))
    m = np.arange(MMAX + 1)
    bv = np.zeros(hb.vis.shape, dtype=np.complex64)
    taper = np.exp(-0.5 * (m / (MMAX / 1.5)) ** 2)
    for e in range(2):
        bv[:, 0, :, :, e, :] = ((1.0 + 0.5 * e) * taper * np.exp(1.0j * 0.1 * e * m))[:, None, None, None]
    bv[:, 1] = 0.3 * bv[:, 0]
    hb.vis[:] = bv
    s_m = np.exp(-2.0j * np.pi * m * source_idx / (2 * MMAX))
    noise = 0.01 * (rng.standard_normal(bv.shape) + 1j * rng.standard_normal(bv.shape))
    hv.vis[:] = (bv * s_m[:, None, None, None, None, None] + noise).astype(np.complex64)
    w = rng.uniform(0.5, 2.0, hv.weight.shape).astype(np.float32)
    w[3, 1, 0, 1, 0] = 0.0
    w[7, :, 1, 0, :] = 0.0
    hv.weight[:] = w
    hb.weight[:] = np.ones(hb.weight.shape, dtype=np.float32)
    return hv, hb


@pytest.fixture(scope="module")
def mmode_pair():
    return _hybrid_mmodes(jcontainers), _hybrid_mmodes(containers)


@pytest.fixture(scope="module")
def ptel():
    return JPolCylinder(**PTEL), PolarisedCylinderTelescope(**PTEL)


DECONV_CASES = {
    "tikhonov_uniform": ("TikhonovRingMapMaker", {"inv_SN": 1e-8, "weight_ew": "uniform", "save_dirty_beam": True}),
    "tikhonov_natural_exclude": ("TikhonovRingMapMaker", {"weight_ew": "natural", "exclude_cyl": [0]}),
    "tikhonov_inverse_variance": ("TikhonovRingMapMaker", {"weight_ew": "inverse_variance", "exclude_intracyl": True}),
    "wiener": ("WienerRingMapMaker", {"save_dirty_beam": True}),
    "wiener_exclude": ("WienerRingMapMaker", {"exclude_cyl": [1]}),
    "skip_reference_dec": ("TikhonovRingMapMaker", {"skip_deconvolution": True, "reference_declination": 50.0}),
    "skip_zenith": ("WienerRingMapMaker", {"skip_deconvolution": True}),
    "window_hann": ("TikhonovRingMapMaker", {"window_type": "hann", "window_size": 0.8}),
    "window_scaled": ("WienerRingMapMaker", {"window_type": "blackman", "window_scaled": True}),
}


@pytest.mark.parametrize("case", list(DECONV_CASES))
def test_deconvolving_makers_match_jax(mmode_pair, ptel, case):
    (jhv, jhb), (hv, hb) = mmode_pair
    name, params = DECONV_CASES[case]
    jrm = _run(getattr(jrmm, name)(), params, (ptel[0],), jhv, jhb)
    rm = _run(getattr(rmm, name)(), params, (ptel[1],), hv, hb)
    assert isinstance(rm, containers.RingMap) and rm.map.shape == (1, 2, 2, 2 * MMAX, 4)
    assert list(rm.attrs["exclude_cyl"]) == list(jrm.attrs["exclude_cyl"])
    assert rm.attrs["weight_ew"] == jrm.attrs["weight_ew"]
    names = ["map", "dirty_beam_power", "weight"] + (["dirty_beam"] if params.get("save_dirty_beam") else [])
    for dset in names:
        assert _rel(rm.datasets[dset][:], np.asarray(jrm.datasets[dset][:])) <= 1e-6, dset


def test_deconvolution_recovers_the_point_source(mmode_pair):
    """The map peaks at the source's RA bin at the amplitude that
    ``_deconvolve_core``'s normalisation states (the dirty beam is 1 at transit)."""
    _, (hv, hb) = mmode_pair
    rm = _run(rmm.TikhonovRingMapMaker(), {"inv_SN": 1e-8, "weight_ew": "uniform"}, (), hv, hb)
    prof = rm.map[0].numpy()  # [pol, freq, ra, el]
    assert (prof.argmax(axis=2) == 5).all()
    assert np.abs(prof[:, :, 5] - 1.0).max() <= 0.02


@pytest.mark.parametrize("maker", ["TikhonovRingMapMakerAnalytical", "WienerRingMapMakerAnalytical"])
def test_analytical_makers_match_jax(mmode_pair, ptel, maker):
    (jhv, _), (hv, _) = mmode_pair
    params = {"inv_SN": 1e-6, "weight_ew": "uniform"} if maker.startswith("Tikhonov") else {"exclude_cyl": [0]}
    jt, t = getattr(jrmm, maker)(), getattr(rmm, maker)()
    jrm = _run(jt, params, (ptel[0],), jhv)
    rm = _run(t, params, (ptel[1],), hv)
    assert _rel(t._get_beam_mmodes(hv).vis[:], np.asarray(jt._get_beam_mmodes(jhv).vis[:])) <= 1e-6
    assert bool(torch.isfinite(rm.map[:]).all())
    for dset in ("map", "dirty_beam_power", "weight"):
        assert _rel(rm.datasets[dset][:], np.asarray(jrm.datasets[dset][:])) <= 1e-6, dset


# -- RA-dependent weights and the noise reconstructions -------------------------------------------


def _hybrid_stream(package, tel, seed=8, nra=8, cov=True):
    hv = package.HybridVisStream(
        freq=tel.frequencies, pol=np.array(["XX", "YY"]), ew=np.array([0.0, 20.0]), el=np.linspace(-0.3, 0.3, 5),
        ra=nra,
    )
    rng = np.random.Generator(np.random.SFC64(seed))
    w = rng.uniform(0.5, 2.0, hv.weight.shape) * (1.0 + 0.5 * np.arange(nra) / nra)
    w[0, 1, 0, 3] = 0.0  # one masked channel at one (pol, ew, ra)
    hv.weight[:] = w.astype(np.float32)
    hv.attrs.update(beamform_ns_weight="natural", beamform_ns_include_auto=False, beamform_ns_scaled=False,
                    beamform_ns_freqmin=float(tel.frequencies.min()), beamform_ns_nsmax=1.0)
    if cov:
        nf = len(tel.frequencies)
        a = rng.standard_normal((2, 2, nra, nf, nf))
        spd = np.einsum("pxrij,pxrkj->pxrik", a, a) + nf * np.eye(nf)  # [pol, ew, ra, f, f]
        hv.add_dataset("freq_cov")
        hv.freq_cov[:] = np.moveaxis(spd, (3, 4), (1, 2))
        hv.add_dataset("filter")
        hv.filter[:] = np.moveaxis(np.eye(nf) + 0.1 * rng.standard_normal((2, 2, nra, nf, nf)), (3, 4), (1, 2))
    return hv


@pytest.mark.parametrize(
    "weight_ew,exclude", [("natural", []), ("uniform", [1]), ("inverse_variance", [])]
)
def test_ra_dependent_weights_match_jax(ptel, weight_ew, exclude):
    outs = []
    for package, task, tel in ((jcontainers, jrmm, ptel[0]), (containers, rmm, ptel[1])):
        hv = _hybrid_stream(package, tel)
        rm = package.RingMap(freq=tel.frequencies, beam=np.arange(1), pol=np.array(["XX", "YY"]), ra=8,
                             el=np.linspace(-0.3, 0.3, 5))
        rm.datasets["weight"][:] = np.linspace(1.0, 2.0, 5) * np.ones(rm.datasets["weight"].shape)
        rm.attrs.update(exclude_cyl=exclude, weight_ew=weight_ew)
        outs.append(_run(task.RADependentWeights(), {}, None, hv, rm))
    jout, out = outs
    assert _rel(out.weight[:], np.asarray(jout.weight[:])) <= 1e-6
    assert _rel(out.filter[:], np.asarray(jout.filter[:])) <= 1e-6
    assert ("freq_cov" in out.datasets) == ("freq_cov" in jout.datasets) == (weight_ew != "inverse_variance")
    if "freq_cov" in out.datasets:
        assert _rel(out.freq_cov[:], np.asarray(jout.freq_cov[:])) <= 1e-6


@pytest.mark.parametrize("ns_weight", ["natural", "hann"])
def test_reconstruct_vis_weight_matches_jax(ptel, ns_weight):
    outs = []
    for package, task, tel in ((jcontainers, jrmm, ptel[0]), (containers, rmm, ptel[1])):
        hv = _hybrid_stream(package, tel, cov=False)
        hv.attrs["beamform_ns_weight"] = ns_weight
        outs.append(_run(task.ReconstructVisWeight(), {}, (tel,), hv))
    jss, ss = outs
    assert isinstance(ss, containers.SiderealStream)
    assert np.array_equal(ss.index_map["stack"], jss.index_map["stack"])
    assert not bool(ss.vis[:].any())
    assert _rel(ss.weight[:], np.asarray(jss.weight[:])) <= 1e-6  # float32 storage
    assert (ss.weight[:] > 0).any()


def test_reconstruct_vis_freq_cov_matches_jax(ptel):
    outs = []
    for package, task, tel in ((jcontainers, jrmm, ptel[0]), (containers, rmm, ptel[1])):
        outs.append(_run(task.ReconstructVisFreqCov(), {}, (tel,), _hybrid_stream(package, tel)))
    jout, out = outs
    assert isinstance(out, containers.FreqNoiseModel)
    assert np.array_equal(_np(out.redundancy[:]), np.asarray(jout.redundancy[:]))
    assert _rel(out.freq_cov[:], np.asarray(jout.freq_cov[:])) <= 1e-10
    assert _rel(out.weight[:], np.asarray(jout.weight[:])) <= 1e-6  # float32 storage
    L = out.freq_cov[:].numpy()
    assert np.allclose(np.triu(L, 1), 0.0)


def test_reconstruct_vis_freq_cov_raises_where_a_factorisation_fails(ptel):
    hv = _hybrid_stream(containers, ptel[1])
    cov = hv.freq_cov[:]
    cov[0, 1, 1, 0, 2] = -5.0  # one (pol, ew, ra) covariance with a negative variance
    with pytest.raises(RuntimeError, match="Cholesky factorisation failed for 1 of"):
        _run(rmm.ReconstructVisFreqCov(), {}, (ptel[1],), hv)
