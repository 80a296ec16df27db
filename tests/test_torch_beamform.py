"""Source beamforming and source stacking: draco_tpu_torch against draco_tpu.

Small sizes (those of ``tests/test_beamform.py``, ``tests/test_beamform2.py``
and ``tests/test_sourcestack.py``: a 2 x 4-feed dual-pol cylinder, 2
frequencies, 64 RA samples, a handful of sources), numpy inputs from a seed;
the JAX package on the CPU with 64-bit types, the port on the CPU (the
beamforming kernel's plain version), on one thread.  Tolerances,
max|diff| / max|ref|:

- ``icrs_to_cirs`` (the JAX package's first-order precession, copied):
  exact;
- ``projected_distance``, ``fringestop_phase`` and the three beamformers
  on float64 inputs: 1e-12 (both in float64; the port reduces the phase to
  d - round(d) turns before the cosine and sine, exact in float64);
- the beamforming tasks: 1e-5 of the largest formed value and weight.  On
  the batched path both packages contract in complex64/float32; on the
  per-source path (``source_batch: 1``) the JAX package sums in float64 and
  the port in float32 (the kernel's type);
- ``RingMapBeamForm``, ``HealpixBeamForm`` without smoothing and
  ``HybridVisBeamForm``: 1e-12 (gathers, and complex128 phases in both);
  ``HealpixBeamForm`` with smoothing: 1e-5 (float32 SHTs in both);
- ``RingMapStack2D``: 1e-12 (float64 sums in another order);
- ``FitBeamFormed``: 1e-12 (the same float64 host solves);
- ``SourceStack``: 1e-12 (float64 segment sums; the port's is a one-hot
  product, the JAX package's a segment sum); ``RandomSubset`` and
  ``GroupSourceStacks``: exact.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from draco_tpu.analysis import beamform as jbeamform
from draco_tpu.analysis import sourcestack as jsourcestack
from draco_tpu.analysis import transform as jtransform
from draco_tpu.core import containers as jcontainers
from draco_tpu.core.task import PipelineStopIteration as JStop
from draco_tpu.ops import interferometry as jinter
from draco_tpu.telescope import PolarisedCylinderTelescope as JPolCylinder
from draco_tpu_torch.analysis import beamform, sourcestack
from draco_tpu_torch.analysis import transform as ttransform
from draco_tpu_torch.core import containers
from draco_tpu_torch.core.task import PipelineStopIteration
from draco_tpu_torch.device import default_device
from draco_tpu_torch.ops import cuda_kernels, interferometry
from draco_tpu_torch.telescope import PolarisedCylinderTelescope

CYL = dict(
    num_cylinders=2, num_feeds=4, feed_spacing=1.0, cylinder_spacing=10.0, cylinder_width=10.0, latitude=45.0,
    num_freq=2, freq_lower=400.0, freq_upper=420.0, auto_correlations=True,
)
NRA = 64
LSD = 1000
# source (ra, dec): one across the RA wrap, one at each side of the telescope
SOURCES = ((2.0, 45.0), (90.0, 44.0), (181.0, 47.0), (275.0, 46.0), (358.5, 43.0))
TRACK = {"timetrack": 6000.0}


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


@pytest.fixture(scope="module")
def tels():
    return JPolCylinder(**CYL), PolarisedCylinderTelescope(**CYL)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    return np.abs(got - ref).max() / (scale if scale > 0 else 1.0)


def assert_same(pc, jc, tol):
    assert set(pc.datasets) == set(jc.datasets), (set(pc.datasets), set(jc.datasets))
    for name, ds in jc.datasets.items():
        got, ref = _np(pc.datasets[name][:]), np.asarray(ds[:])
        if ref.dtype.kind not in "fc":
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            assert _rel(got, ref) <= tol, (name, _rel(got, ref))
    for ax, imap in jc.index_map.items():
        np.testing.assert_array_equal(np.asarray(pc.index_map[ax]), np.asarray(imap), err_msg=ax)


def _stream(package, tel, seed=3, timestream=False):
    """A seeded stacked stream of every unique pair, labelled as ``CollateProducts`` labels it."""
    maps = (jtransform if package is jcontainers else ttransform).TelescopeStreamMixIn()
    maps.setup(tel)
    common = dict(freq=tel.frequencies, input=tel.nfeed, prod=maps.bt_prod, stack=maps.bt_stack,
                  reverse_map_stack=maps.bt_rev)
    if timestream:
        # a third of a day from RA ~60 deg: some windows clip, some sources never transit
        t0 = tel.lsd_to_unix(LSD + 60.0 / 360.0)
        time = t0 + np.arange(NRA // 3 * 2) * (86164.0905 / NRA / 2)
        ss = package.TimeStream(time=time, **common)
    else:
        ss = package.SiderealStream(ra=NRA, **common)
        ss.attrs["lsd"] = LSD
    rng = np.random.Generator(np.random.SFC64(seed))
    shape = ss.vis.shape
    ss.vis[:] = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    w = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    w[0, 5] = 0.0
    w[1, :, 7] = 0.0
    ss.weight[:] = w
    flags = np.ones(ss.input_flags.shape, dtype=np.float32)
    flags[3, : shape[-1] // 2] = 0.0
    ss.input_flags[:] = flags
    ss.attrs["tag"] = "stream"
    return ss


def _catalog(package, redshift=False, cirs=True):
    n = len(SOURCES)
    cat = (package.SpectroscopicCatalog if redshift else package.SourceCatalog)(object_id=np.arange(n))
    pos = np.zeros(n, dtype=[("ra", np.float64), ("dec", np.float64)])
    pos["ra"], pos["dec"] = np.array(SOURCES).T
    cat["position"][:] = pos
    if redshift:
        z = np.zeros(n, dtype=[("z", np.float64), ("z_error", np.float64)])
        z["z"] = sourcestack.NU21 / np.array([401.0, 409.0, 415.0, 402.0, 412.0]) - 1.0
        cat["redshift"][:] = z
    if cirs:
        cat.attrs["coordinates"] = "CIRS"
    cat.attrs["tag"] = "cat"
    return cat


def test_icrs_to_cirs_matches_jax():
    ra = np.linspace(0, 359, 40)
    dec = np.linspace(-60, 80, 40)
    for epoch in (946728000.0, 1.7e9):
        for a, b in zip(beamform.icrs_to_cirs(ra, dec, epoch), jbeamform.icrs_to_cirs(ra, dec, epoch)):
            np.testing.assert_array_equal(a, b)


def test_fringestop_phase_matches_jax():
    rng = np.random.default_rng(1)
    ha = rng.uniform(-0.3, 0.3, (1, 7, 1))
    u, v = rng.uniform(-30, 30, (3, 1, 5)), rng.uniform(-30, 30, (3, 1, 5))
    lat, dec = np.radians(45.0), np.radians(30.0)
    ref_d = np.asarray(jinter.projected_distance(ha, lat, dec, u, v, 0.5))
    ref = np.asarray(jinter.fringestop_phase(ha, lat, dec, u, v))
    assert _rel(interferometry.projected_distance(ha, lat, dec, u, v, 0.5), ref_d) <= 1e-12
    t = [torch.as_tensor(x) for x in (ha, u, v)]
    assert _rel(interferometry.projected_distance(t[0], lat, dec, t[1], t[2], 0.5), ref_d) <= 1e-12
    assert _rel(interferometry.fringestop_phase(t[0], lat, dec, t[1], t[2]), ref) <= 1e-12
    assert _rel(interferometry.fringestop_phase(ha, lat, dec, u, v), ref) <= 1e-12


def _kernel_inputs(seed, nfreq=3, nra=40, nprod=37, S=4, nha=9, wrap=True):
    """Seeded beamformer inputs, float64: nprod not a multiple of 32, one
    window across the RA wrap, zero weights and the wrap's padding."""
    rng = np.random.default_rng(seed)
    vis = rng.standard_normal((nfreq, nra, nprod)) + 1j * rng.standard_normal((nfreq, nra, nprod))
    sw = rng.uniform(0.5, 2.0, (nfreq, nra, nprod))
    sw[0, 3] = 0.0
    sw[:, :, 5] = 0.0
    vw = rng.uniform(0.5, 2.0, (nfreq, nra, nprod))
    vw[1, nra // 2, :4] = 0.0
    start = rng.integers(0, max(1, nra - nha), S)
    if wrap:
        start[0] = nra - nha // 2
    ra_idx = ((start[:, None] + np.arange(nha)) % nra).astype(np.int32)
    ha = rng.uniform(-0.1, 0.1, (S, nha))
    dec = np.radians(rng.uniform(20, 70, S))
    u, v = rng.uniform(-80, 80, (nfreq, nprod)), rng.uniform(-80, 80, (nfreq, nprod))
    pb = rng.uniform(0.0, 1.0, (S, nfreq, nha))
    valid = np.ones((S, nha), np.float32)
    valid[-1, -3:] = 0.0
    pb[-1, :, -3:] = 0.0
    return vis, sw, vw, ra_idx, np.cos(ha), np.sin(ha), np.sin(dec), np.cos(dec), u, v, pb, valid


@pytest.mark.parametrize("inverse_variance", [False, True])
@pytest.mark.parametrize("S", [1, 4])
def test_batched_beamformers_match_jax(inverse_variance, S):
    vis, sw, vw, ra_idx, cha, sha, sd, cd, u, v, pb, valid = _kernel_inputs(5, S=S)
    lat = np.radians(49.0)
    common = (vis, sw, vw, ra_idx, cha, sha, sd, cd, lat, u, v)
    ref = jinter.beamform_sources_batched(*common, pb, inverse_variance)
    ref_ha = jinter.beamform_sources_batched_ha(*common, valid, inverse_variance)
    tcommon = (torch.as_tensor(vis), torch.as_tensor(sw), torch.as_tensor(vw), ra_idx, cha, sha, sd, cd, lat, u, v)
    got = interferometry.beamform_sources_batched(*tcommon, pb, inverse_variance)
    got_ha = interferometry.beamform_sources_batched_ha(*tcommon, valid, inverse_variance)
    for g, r in zip((*got, *got_ha), (*ref, *ref_ha)):
        assert _rel(g, np.asarray(r)) <= 1e-12


def test_beamform_kernel_matches_jax():
    vis, sw, _, _, cha, sha, _, _, u, v, *_ = _kernel_inputs(7, nra=9)
    lat, dec = np.radians(49.0), np.radians(35.0)
    ref = np.asarray(jinter.beamform_kernel(vis, sw, dec, lat, cha[0], sha[0], u, v))
    got = interferometry.beamform_kernel(torch.as_tensor(vis), torch.as_tensor(sw), dec, lat, cha[0], sha[0], u, v)
    assert _rel(got, ref) <= 1e-12


def test_beamform_wrapper_checks_on_the_cpu():
    vis, sw, vw, ra_idx, *_ = _kernel_inputs(9)
    t = torch.as_tensor
    a = b = t(np.zeros(ra_idx.shape))
    u = t(np.zeros((vis.shape[0], vis.shape[2])))
    with pytest.raises(ValueError):
        cuda_kernels.beamform_sums(t(vis), t(sw), None, t(ra_idx), a, b, u, u, natural=True)
    with pytest.raises(ValueError):
        cuda_kernels.beamform_sums(t(vis), t(sw)[:, :, :-1], None, t(ra_idx), a, b, u, u, natural=False)
    before = dict(cuda_kernels.launches)
    cuda_kernels.beamform_sums(t(vis), t(sw), t(vw), t(ra_idx), a, b, u, u, natural=True)
    assert cuda_kernels.launches == before  # the plain version launches nothing


CASES = [
    ("full-natural", {"polarization": "full", "weight": "natural"}),
    ("full-natural-per-source", {"polarization": "full", "weight": "natural", "source_batch": 1}),
    ("I-inverse-variance", {"polarization": "I", "weight": "inverse_variance", "source_batch": 2}),
    ("copol-uniform-ha", {"polarization": "copol", "weight": "uniform", "collapse_ha": False}),
    ("copol-uniform-ha-per-source", {"polarization": "copol", "weight": "uniform", "collapse_ha": False,
                                     "source_batch": 1}),
    ("full-natural-batch-4", {"polarization": "full", "weight": "natural", "source_batch": 4}),
    ("copol-uniform-ha-batch-4", {"polarization": "copol", "weight": "uniform", "collapse_ha": False,
                                  "source_batch": 4}),
    ("full-freqside", {"polarization": "full", "freqside": 0}),
    ("I-variable-track", {"polarization": "I", "variable_timetrack": True}),
    ("I-no-beam-icrs", {"polarization": "I", "no_beam_model": True}),
]


@pytest.mark.parametrize("name, params", CASES, ids=[c[0] for c in CASES])
def test_beamform_cat_matches_jax(tels, name, params):
    jtel, tel = tels
    params = {**TRACK, **params}
    redshift = "freqside" in params
    cirs = "icrs" not in name
    ref = jbeamform.BeamFormCat()
    ref.read_config(params)
    ref.setup(jtel, _stream(jcontainers, jtel))
    ref_fb = ref.process(_catalog(jcontainers, redshift, cirs))
    task = beamform.BeamFormCat()
    task.read_config(params)
    task.setup(tel, _stream(containers, tel))
    fb = task.process(_catalog(containers, redshift, cirs))
    assert type(fb).__name__ == type(ref_fb).__name__
    assert fb.attrs["tag"] == ref_fb.attrs["tag"] == "stream_cat"
    assert_same(fb, ref_fb, 1e-5)
    assert (_np(fb.weight[:]) > 0).any()


@pytest.mark.parametrize(
    "source_batch, collapse_ha",
    [pytest.param(1, True, id="1"), pytest.param(32, False, id="32"), pytest.param(4, True, id="4-collapsed"),
     pytest.param(4, False, id="4-ha"), pytest.param(32, True, id="32-collapsed")],
)
def test_beamform_on_a_time_stream_matches_jax(tels, source_batch, collapse_ha):
    """Source batches of 1 (the per-source path), 4 and the whole catalogue
    (32 > 5 sources), the tracks clipped at the stream's edges (padded at RA
    index 0)."""
    jtel, tel = tels
    params = {**TRACK, "polarization": "copol", "source_batch": source_batch, "collapse_ha": collapse_ha}
    ref = jbeamform.BeamForm()
    ref.read_config(params)
    ref.setup(jtel, _catalog(jcontainers))
    ref_fb = ref.process(_stream(jcontainers, jtel, timestream=True))
    task = beamform.BeamForm()
    task.read_config(params)
    task.setup(tel, _catalog(containers))
    fb = task.process(_stream(containers, tel, timestream=True))
    assert_same(fb, ref_fb, 1e-5)
    # some sources never transit the observation and stay empty
    assert (np.abs(_np(fb.weight[:])).reshape(len(SOURCES), -1).max(axis=1) == 0).any()


@pytest.mark.parametrize(
    "timestream, collapse_ha, variable", [(False, True, False), (False, False, False), (True, True, False),
                                          (True, False, False), (False, True, True), (True, True, True)],
)
def test_source_tracks_match_per_source_windows(tels, timestream, collapse_ha, variable):
    """The whole catalogue's tracks, built at once, hold each source's
    window of ``_ha_array`` (packed, or at its grid positions), zero
    elsewhere; the kept sources are those with a transit in the data."""
    _, tel = tels
    task = beamform.BeamFormCat()
    task.read_config({**TRACK, "collapse_ha": collapse_ha, "variable_timetrack": variable})
    task.setup(tel, _stream(containers, tel, timestream=timestream))
    task._process_catalog(_catalog(containers))
    tracks = task._source_tracks()
    decs = np.radians(task.sdec)
    kept = []
    for src in range(task.nsource):
        idx = task._transit_indices(task.sra[src : src + 1])[0]
        if idx < 0:
            continue
        kept.append(src)
        side = int(task.ha_side / np.cos(decs[src])) if variable else int(task.ha_side)
        ha, window, mask = task._ha_array(np.asarray(task.ra), idx, task.sra[src], side, task.is_sstream)
        k = len(kept) - 1
        sel = np.arange(len(ha)) if collapse_ha else np.flatnonzero(mask)
        np.testing.assert_array_equal(tracks.ra_idx[k, sel], window)
        np.testing.assert_array_equal(tracks.ha[k, sel], ha)
        np.testing.assert_array_equal(np.flatnonzero(tracks.valid[k]), sel)
        rest = ~tracks.valid[k]
        assert np.all(tracks.ra_idx[k, rest] == 0) and np.all(tracks.cosha[k, rest] == 0)
    np.testing.assert_array_equal(tracks.src_ids, kept)
    assert len(kept) < task.nsource if timestream else len(kept) == task.nsource


def _grid_beam(package, freq, pols=("XX", "YY")):
    """A celestial GridBeam: a Gaussian transit over a declination band."""
    dec_grid = np.linspace(35.0, 55.0, 21)
    ha_grid = np.linspace(-40, 40, 81)
    gb = package.GridBeam(coords="celestial", freq=freq, pol=np.array(pols), input=np.array(["common"]),
                          theta=dec_grid, phi=ha_grid)
    shape = np.exp(-0.5 * (ha_grid / 6.0) ** 2) * np.exp(-0.5 * ((dec_grid - 45.0) / 8.0) ** 2)[:, None]
    barr = np.zeros(gb.beam.shape, dtype=np.complex64)
    barr[:, 0, 0] = shape
    barr[:, 1, 0] = 0.9 * shape
    gb.beam[:] = barr
    w = np.ones(gb.weight.shape, dtype=np.float32)
    w[:, :, :, 0, :5] = 0.0
    gb.weight[:] = w
    return gb


@pytest.mark.parametrize("cls", ["BeamFormExternalCat", "BeamFormExternal"])
def test_beamform_external_matches_jax(tels, cls):
    """The external-beam variants: the catalogue (``BeamFormExternal``) or
    the data (``BeamFormExternalCat``) given at setup after the beam."""
    jtel, tel = tels
    params = {**TRACK, "polarization": "copol"}
    outs = []
    for package, mod, t in ((jcontainers, jbeamform, jtel), (containers, beamform, tel)):
        task = getattr(mod, cls)()
        task.read_config(params)
        fixed, given = (_stream(package, t), _catalog(package)) if cls.endswith("Cat") else (
            _catalog(package), _stream(package, t))
        task.setup(_grid_beam(package, t.frequencies), t, fixed)
        outs.append(task.process(given))
    assert_same(outs[1], outs[0], 1e-5)


def _ringmap(package, tel, npol=2):
    rm = package.RingMap(freq=tel.frequencies, beam=np.arange(1), pol=np.array(["XX", "YY"][:npol]), ra=NRA,
                         el=np.linspace(-0.5, 0.5, 21))
    rng = np.random.default_rng(12)
    rm.map[:] = rng.standard_normal(rm.map.shape)
    w = rng.uniform(0.5, 2.0, rm.datasets["weight"].shape)
    w[0, 1, 3] = 0.0
    rm.datasets["weight"][:] = w
    rm.attrs["lsd"] = LSD
    return rm


def test_ringmap_beamform_matches_jax(tels):
    jtel, tel = tels
    ref = jbeamform.RingMapBeamForm()
    ref.read_config({})
    ref.setup(jtel, _ringmap(jcontainers, jtel))
    got = beamform.RingMapBeamForm()
    got.read_config({})
    got.setup(tel, _ringmap(containers, tel))
    assert_same(got.process(_catalog(containers, redshift=True)), ref.process(_catalog(jcontainers, redshift=True)),
                1e-12)


@pytest.mark.parametrize("weight", ["input", "patch", "dec"])
def test_ringmap_stack_2d_matches_jax(tels, weight):
    jtel, tel = tels
    params = {"num_ra": 3, "num_dec": 2, "num_freq": 1, "weight": weight}
    ref = jbeamform.RingMapStack2D()
    ref.read_config(params)
    ref.setup(jtel, _ringmap(jcontainers, jtel))
    got = beamform.RingMapStack2D()
    got.read_config(params)
    got.setup(tel, _ringmap(containers, tel))
    assert_same(got.process(_catalog(containers, redshift=True)), ref.process(_catalog(jcontainers, redshift=True)),
                1e-12)


@pytest.mark.parametrize("fwhm", [0.0, 5.0])
def test_healpix_beamform_matches_jax(fwhm):
    outs = []
    for package, mod in ((jcontainers, jbeamform), (containers, beamform)):
        m = package.Map(nside=8, polarisation=False, freq=np.array([400.0, 410.0]))
        m.map[:] = np.random.default_rng(4).standard_normal(m.map.shape)
        task = mod.HealpixBeamForm()
        task.read_config({"fwhm": fwhm})
        task.setup(m)
        outs.append(task.process(_catalog(package, redshift=True)))
    ref, got = outs
    assert_same(got, ref, 1e-12 if fwhm == 0.0 else 1e-5)


@pytest.mark.parametrize("fringestopped", [False, True])
def test_hybrid_vis_beamform_matches_jax(tels, fringestopped):
    outs = []
    for package, mod, tel in ((jcontainers, jbeamform, tels[0]), (containers, beamform, tels[1])):
        hv = package.HybridVisStream(freq=tel.frequencies, pol=np.array(["XX", "YY"]), ew=np.array([0.0, 10.0]),
                                     el=np.linspace(-0.2, 0.2, 9), ra=NRA)
        rng = np.random.default_rng(6)
        hv.vis[:] = (rng.standard_normal(hv.vis.shape) + 1j * rng.standard_normal(hv.vis.shape)).astype(np.complex64)
        hv.weight[:] = rng.uniform(0.5, 2.0, hv.weight.shape).astype(np.float32)
        hv.attrs["lsd"] = LSD
        hv.attrs["fringestopped"] = fringestopped
        cat = _catalog(package, redshift=True)
        pos = np.asarray(cat["position"][:]).copy()
        pos["dec"] = np.degrees(np.arcsin(np.linspace(-0.2, 0.2, 9)[[1, 3, 4, 6, 8]]) + np.radians(45.0)) + 0.1
        cat["position"][:] = pos
        task = mod.HybridVisBeamForm()
        task.read_config({"window": 30.0})
        task.setup(tel, cat)
        outs.append(task.process(hv))
    ref, got = outs
    assert_same(got, ref, 1e-12)


@pytest.mark.parametrize("weight", ["uniform", "inverse_variance"])
def test_fit_beamformed_matches_jax(tels, weight):
    outs = []
    nha = 41
    ha = np.linspace(-20, 20, nha)
    for package, mod, tel in ((jcontainers, jbeamform, tels[0]), (containers, beamform, tels[1])):
        fb = package.FormedBeamHA(object_id=np.arange(3), freq=tel.frequencies, pol=np.array(["XX", "YY"]), ha=nha)
        rng = np.random.default_rng(8)
        template = np.exp(-0.5 * (ha / 6.0) ** 2)
        fb.beam[:] = 0.5 + 4.0 * template + 0.01 * rng.standard_normal(fb.beam.shape)
        w = rng.uniform(50.0, 150.0, fb.weight.shape)
        w[2] = 0.0
        fb.weight[:] = w
        fb.ha[:] = ha[None, :]
        pos = np.zeros(3, dtype=[("ra", np.float64), ("dec", np.float64)])
        pos["dec"] = [44.0, 47.0, 45.0]
        fb.position[:] = pos
        task = mod.FitBeamFormed()
        task.read_config({"weight": weight, "max_ha": 15.0})
        task.setup(_grid_beam(package, tel.frequencies))
        outs.append(task.process(fb))
    ref, got = outs
    assert_same(got, ref, 1e-12)


# -- source stacking ----------------------------------------------------------------------


def _formed_beam(package, npol=1, nsrc=20, nfreq=41, seed=3):
    rng = np.random.default_rng(seed)
    freq = np.linspace(600.0, 640.0, nfreq)
    pol = np.array(["I"] if npol == 1 else ["XX", "XY", "YX", "YY"][:npol])
    fb = package.FormedBeam(object_id=np.arange(nsrc), freq=freq, pol=pol)
    fb.add_dataset("redshift")
    chan = rng.integers(0, nfreq, nsrc)
    red = np.zeros(nsrc, dtype=[("z", np.float64), ("z_error", np.float64)])
    red["z"] = sourcestack.NU21 / (freq[chan] + rng.uniform(-0.4, 0.4, nsrc)) - 1.0
    fb["redshift"][:] = red
    fb.beam[:] = rng.standard_normal(fb.beam.shape)
    w = rng.uniform(0.5, 2.0, fb.weight.shape)
    w[0] = 0.0
    w[3, :, 5:9] = 0.0
    fb.weight[:] = w
    fb.attrs["tag"] = "fb"
    return fb


@pytest.mark.parametrize(
    "npol, params",
    [(1, {"freqside": 10}), (4, {"freqside": 10, "uniform_weight": True}), (2, {"freqside": 5,
                                                                                "single_source_bin_index": 20})],
)
def test_source_stack_matches_jax(npol, params):
    ref = jsourcestack.SourceStack()
    ref.read_config(params)
    got = sourcestack.SourceStack()
    got.read_config(params)
    out = got.process(_formed_beam(containers, npol))
    assert_same(out, ref.process(_formed_beam(jcontainers, npol)), 1e-12)


def test_random_subset_and_group_stacks_match_jax():
    outs = []
    for package, mod, stop in ((jcontainers, jsourcestack, JStop), (containers, sourcestack, PipelineStopIteration)):
        cat = _catalog(package, redshift=True)
        sub = mod.RandomSubset()
        sub.read_config({"number": 3, "size": 3, "seed": 17})
        sub.setup(cat)
        cats = [sub.process() for _ in range(3)]
        with pytest.raises(stop):
            sub.process()
        group = mod.GroupSourceStacks()
        group.read_config({"ngroup": 2})
        group.setup()
        stacker = mod.SourceStack()
        stacker.read_config({"freqside": 10})
        stacks = [stacker.process(_formed_beam(package, 2, seed=s)) for s in range(3)]
        for i, st in enumerate(stacks):
            st.attrs["tag"] = f"cat_mock_{i:05d}"
        grouped = [group.process(s) for s in stacks] + [group.process_finish()]
        outs.append((cats, [g for g in grouped if g is not None]))
    (jcats, jgroups), (cats, groups) = outs
    for a, b in zip(cats, jcats):
        assert a.attrs["tag"] == b.attrs["tag"]
        assert_same(a, b, 0.0)
    assert len(groups) == len(jgroups) == 2
    for a, b in zip(groups, jgroups):
        assert a.attrs["tag"] == b.attrs["tag"]
        assert_same(a, b, 1e-12)


def test_build_all_starts_one_compiler_a_source_and_reports_failures(tmp_path, monkeypatch):
    """``_build.build_all`` (the kernels' build, as ``chip_smoke.py`` phase 1
    runs it) with a stand-in compiler that copies its source: every
    unbuilt source is built, a built one is not built again, and a failing
    one raises naming its source."""
    import sys

    from draco_tpu_torch import _build

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("one", "two"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    script = "import shutil, sys; src = sys.argv[2]; sys.exit(3) if 'bad' in src else shutil.copy(src, sys.argv[1])"
    monkeypatch.setattr(_build, "_command", lambda name, out: [sys.executable, "-c", script, str(out),
                                                               str(csrc / f"{name}.cu")])
    assert _build.sources() == ["one", "two"]
    assert set(_build.build_all()) == {"one", "two"}
    assert all(_build.library_path(n).read_text() == f"// {n}\n" for n in ("one", "two"))
    assert _build.build_all() == {}
    (csrc / "bad.cu").write_text("// bad\n")
    with pytest.raises(RuntimeError, match="bad.cu"):
        _build.build_all()
    assert not _build.library_path("bad").exists()
