"""The flagging library: draco_tpu_torch against draco_tpu on the same inputs.

Every task of ``analysis/flagging.py`` and its helpers run in both
packages on the same seeded numpy inputs, the port on the CPU: the
RFI masks (``RFIMask``, ``RFISensitivityMask``, the visibility masks and
the chi-squared masks), the weight and baseline masks (group a), the mask
algebra (group c) and the mask regridders (group d).  A parametrised test
resolves every task class of the JAX package's ``flagging.py``,
``fringestop.py``, ``beam.py`` and ``sensitivity.py`` from its reference
path to a class of the port.

Tolerances: the MAD statistics are host float64 in both packages, so the
helpers and every mask are held to exact equality; the masked weights are
exactly 0 and the others bit-identical to the input.  Weights and data
that a task rescales (``DayMask``, ``RadiometerWeight``, ``BlendStack``,
the tapers) are held within 1e-6 relative: the port multiplies on the
device in the data's type where the JAX package's host arithmetic
promotes.  SIR ties: the masks that pass through the scale-invariant rank
at eta 0.2 (``RFISensitivityMask``'s combine mode, ``RFITransientVisMask``)
are built from data whose flagged runs leave no window at exactly 1 - eta
flagged, so the tie direction (which differs between torch's and XLA's
prefix sums) never decides a sample.  The one deliberate difference in
``ApplyTimeFreqMask``, the weight multiplied on the stream's device in
place of a host copy, is held by
``test_apply_time_freq_mask_matches_jax_and_edits_where_share_says``.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from draco_tpu.analysis import flagging as jflagging
from draco_tpu.core import containers as jcontainers
from draco_tpu.core.task import ContainerTask as JContainerTask
from draco_tpu.ops import filters as jfilters
from draco_tpu.telescope import PolarisedCylinderTelescope as JPolCylinder
from draco_tpu.telescope import UnpolarisedDishArray as JDishArray
from draco_tpu_torch import native
from draco_tpu_torch.analysis import flagging
from draco_tpu_torch.core import containers
from draco_tpu_torch.core.pipeline import _resolve_task_class
from draco_tpu_torch.device import default_device
from draco_tpu_torch.ops import filters
from draco_tpu_torch.telescope import PolarisedCylinderTelescope, UnpolarisedDishArray


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    """On the CPU, with one thread for torch and the BLAS and OpenMP pools
    (the native medians' pool among them: the library is loaded first)."""
    native.load()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with default_device("cpu"), threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _run(task_obj, params, *inputs):
    task_obj.read_config(params)
    task_obj.setup()
    return task_obj.process(*inputs)


def _plane(seed, shape=(24, 40), complex_=False):
    rng = np.random.Generator(np.random.SFC64(seed))
    x = rng.standard_normal(shape)
    if complex_:
        x = x + 1j * rng.standard_normal(shape)
    x[5, 7] += 50.0
    x[:, 20] += 30.0
    mask = rng.uniform(size=shape) < 0.1
    return x, mask


# -- helpers -----------------------------------------------------------------------


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("size", [(11, 3), (5, 5)])
def test_medfilt_matches_jax(complex_, size):
    x, mask = _plane(1, complex_=complex_)
    assert np.array_equal(filters.medfilt(x, mask, size), jfilters.medfilt(x, mask, size))


def test_medfilt_refuses_other_tie_methods():
    x, mask = _plane(1)
    with pytest.raises(ValueError, match="only 'split'"):
        filters.medfilt(x, mask, (3, 3), method="lower")


@pytest.mark.parametrize("kwargs", [{}, {"sigma": False}, {"base_size": (5, 3), "mad_size": (7, 9)}])
def test_mad_matches_jax(kwargs):
    x, mask = _plane(2, complex_=True)
    got = flagging.mad(x, mask, debug=True, **kwargs)
    want = jflagging.mad(x, mask, debug=True, **kwargs)
    for g, w in zip(got, want):
        assert np.array_equal(g, w, equal_nan=True)
    assert np.array_equal(flagging.mad(x, mask, **kwargs), want[0], equal_nan=True)
    assert got[0][5, 7] > 10


@pytest.mark.parametrize(
    "freq",
    [np.linspace(700.0, 669.0, 32), np.linspace(410.0, 380.0, 31), np.linspace(300.0, 290.0, 11), np.linspace(790.0, 810.0, 21)],
    ids=["inside", "across-398", "below", "across-800"],
)
def test_tv_channels_flag_matches_jax(freq):
    rng = np.random.Generator(np.random.SFC64(3))
    x = np.abs(rng.standard_normal((len(freq), 50)))
    x[:, 11] += 20.0  # one bad time in every channel
    got, got_frac = flagging.tv_channels_flag(x, freq, debug=True)
    want, want_frac = jflagging.tv_channels_flag(x, freq, debug=True)
    assert np.array_equal(got, want) and np.array_equal(got_frac, want_frac)
    assert np.array_equal(flagging.tv_channels_flag(x, freq, sigma=3, f=0.3), jflagging.tv_channels_flag(x, freq, sigma=3, f=0.3))
    inside = (freq >= 398.0) & (freq <= 800.0)
    # channels outside every TV band are masked in full, as in the reference
    assert got[~inside].all() and got[:, 11].all() and not got[inside][:, :11].any()


def test_probability_conversions_match_jax():
    sig = np.array([1.0, 3.0, 5.0])
    assert np.array_equal(flagging.sigma_to_p(sig), jflagging.sigma_to_p(sig))
    p = flagging.sigma_to_p(sig)
    assert np.array_equal(flagging.p_to_sigma(p), jflagging.p_to_sigma(p))
    assert np.allclose(flagging.p_to_sigma(p), sig, rtol=1e-12)
    assert flagging.inverse_binom_cdf_prob(3, 7, 0.9) == jflagging.inverse_binom_cdf_prob(3, 7, 0.9)
    assert np.array_equal(flagging._TV_BAND_EDGES, jflagging._TV_BAND_EDGES)
    assert flagging._pct(np.array([True, False, False, False])) == 25.0


# -- RFIMask -------------------------------------------------------------------------


def _streams(kind, nfreq=32, nfeed=3, nsamp=64, seed=0, f0=700.0):
    """The same seeded stream in both packages' containers."""
    freq = np.linspace(f0, f0 - nfreq + 1, nfreq)
    rng = np.random.Generator(np.random.SFC64(seed))
    out = []
    for mod in (jcontainers, containers):
        if kind == "sidereal":
            ss = mod.SiderealStream(freq=freq, input=nfeed, ra=nsamp)
        else:
            ss = mod.TimeStream(freq=freq, input=nfeed, time=1.6e9 + 10.0 * np.arange(nsamp))
        out.append(ss)
    shape = out[0].vis.shape
    vis = np.ones(shape, np.complex64) + 0.01 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    vis[:, 1, 10] += 100.0  # a bad time on stack 1
    vis[nfreq // 4, 1, nsamp // 2 : nsamp // 2 + 4] += 5.0
    weight = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    weight[:, 1, nsamp - 14] = 0.0  # an unestimable column
    for ss in out:
        ss.vis[:] = vis
        ss.weight[:] = weight
    return out


@pytest.mark.parametrize("kind,f0", [("sidereal", 700.0), ("time", 700.0), ("sidereal", 410.0)])
@pytest.mark.parametrize("params", [{"stack_ind": 1}, {"stack_ind": 1, "sigma": 3.0, "tv_fraction": 0.2}, {}])
def test_rfi_mask_matches_jax(kind, f0, params):
    js, ts = _streams(kind, f0=f0)
    jmask = _run(jflagging.RFIMask(), params, js)
    tmask = _run(flagging.RFIMask(), params, ts)
    want_cls = containers.SiderealRFIMask if kind == "sidereal" else containers.RFIMask
    assert type(tmask) is want_cls and tmask.mask[:].dtype == bool
    assert np.array_equal(tmask.mask[:], np.asarray(jmask.mask[:]))
    tax = "ra" if kind == "sidereal" else "time"
    assert np.array_equal(tmask.index_map[tax], ts.index_map[tax]) and np.array_equal(tmask.freq, ts.freq)
    if params.get("stack_ind") == 1:
        m = tmask.mask[:]
        assert m[:, 10].mean() > 0.5 and m[ts.freq >= 398.0].mean() < 0.5 and m[ts.freq < 395.0].all()


def test_rfi_mask_for_picks_the_container():
    _, tt = _streams("time")
    _, th = _hybrid_pair()
    assert type(flagging._rfi_mask_for(tt)) is containers.RFIMask
    by_pol = flagging._rfi_mask_for(th, by_pol=True)
    assert type(by_pol) is containers.SiderealRFIMaskByPol and by_pol.mask.shape == (2, 4, 12)


# -- ApplyTimeFreqMask ----------------------------------------------------------------


def _mask_pair(js, ts, seed=4, cls="SiderealRFIMask", **axes):
    rng = np.random.Generator(np.random.SFC64(seed))
    jm = getattr(jcontainers, cls)(axes_from=js, **axes)
    tm = getattr(containers, cls)(axes_from=ts, **axes)
    marr = rng.uniform(size=jm.mask.shape) < 0.3
    jm.mask[:] = marr
    tm.mask[:] = marr
    return jm, tm, marr


@pytest.mark.parametrize("kind", ["sidereal", "time"])
@pytest.mark.parametrize("share", ["all", "none", "vis"])
def test_apply_time_freq_mask_matches_jax_and_edits_where_share_says(kind, share):
    js, ts = _streams(kind, nfreq=6, nsamp=20)
    jm, tm, marr = _mask_pair(js, ts, cls="SiderealRFIMask" if kind == "sidereal" else "RFIMask")
    w0 = ts.weight[:].clone()
    vis_storage, weight_storage = ts.vis[:].data_ptr(), ts.weight[:].data_ptr()
    jout = _run(jflagging.ApplyTimeFreqMask(), {"share": share}, js, jm)
    tout = _run(flagging.ApplyRFIMask(), {"share": share}, ts, tm)
    w = tout.weight[:]
    assert np.array_equal(_np(w), np.asarray(jout.weight[:]))
    # masked weights are exactly 0, the others untouched
    bad = torch.from_numpy(marr)[:, None, :].expand(w.shape)
    assert bool((w[bad] == 0).all()) and torch.equal(w[~bad], w0[~bad])
    assert torch.equal(tout.vis[:], ts.vis[:])
    if share == "all":
        # in place, where the weights lie: no copy of the stream is made
        assert tout is ts and w.data_ptr() == weight_storage
    else:
        assert tout is not ts and torch.equal(ts.weight[:], w0) and w.data_ptr() != weight_storage
        assert (tout.vis[:].data_ptr() == vis_storage) == (share == "vis")


def test_apply_time_freq_mask_on_overlapping_axes():
    """``match_axes`` off: only the samples both axes hold are masked."""
    js, ts = _streams("time", nfreq=6, nsamp=20)
    t_mask = np.concatenate([ts.time[5:15], ts.time[-1:] + 10.0 * np.arange(1, 4)])
    jm, tm, marr = _mask_pair(js, ts, cls="RFIMask", time=t_mask)
    params = {"match_axes": False, "share": "none"}
    jout = _run(jflagging.ApplyTimeFreqMask(), params, js, jm)
    tout = _run(flagging.ApplyTimeFreqMask(), params, ts, tm)
    assert np.array_equal(_np(tout.weight[:]), np.asarray(jout.weight[:]))
    w, w0 = tout.weight[:], ts.weight[:]
    assert torch.equal(w[..., :5], w0[..., :5]) and torch.equal(w[..., 15:], w0[..., 15:])
    bad = torch.from_numpy(marr[:, :10])[:, None, :].expand(w[..., 5:15].shape)
    assert bool((w[..., 5:15][bad] == 0).all()) and torch.equal(w[..., 5:15][~bad], w0[..., 5:15][~bad])
    with pytest.raises(ValueError, match="disagree on the time-like axis"):
        _run(flagging.ApplyTimeFreqMask(), {}, ts, tm)
    _, far, _ = _mask_pair(js, ts, cls="RFIMask", time=ts.time + 1e6)
    with pytest.raises(ValueError, match="do not overlap"):
        _run(flagging.ApplyTimeFreqMask(), params, ts, far)


def _hybrid_pair(nfreq=4, nra=12, seed=6):
    rng = np.random.Generator(np.random.SFC64(seed))
    freq = np.linspace(700.0, 697.0, nfreq)
    out = [
        mod.HybridVisStream(freq=freq, ra=nra, pol=np.array(["XX", "YY"]), ew=3, el=np.linspace(-1, 1, 5))
        for mod in (jcontainers, containers)
    ]
    weight = rng.uniform(0.5, 2.0, out[0].weight.shape).astype(np.float32)
    for hv in out:
        hv.weight[:] = weight
    return out


@pytest.mark.parametrize("collapse_pol", [False, True])
def test_apply_time_freq_mask_by_pol(collapse_pol):
    jh, th = _hybrid_pair()
    jm, tm, marr = _mask_pair(jh, th, cls="SiderealRFIMaskByPol")
    params = {"collapse_pol": collapse_pol, "share": "none"}
    jout = _run(jflagging.ApplyTimeFreqMask(), params, jh, jm)
    tout = _run(flagging.ApplyTimeFreqMask(), params, th, tm)
    assert np.array_equal(_np(tout.weight[:]), np.asarray(jout.weight[:]))
    bad = np.broadcast_to(marr.any(axis=0), marr.shape) if collapse_pol else marr  # [pol, freq, ra]
    w = _np(tout.weight[:])  # [pol, freq, ew, ra]
    assert (w[np.broadcast_to(bad[:, :, None, :], w.shape)] == 0).all()
    assert np.array_equal(w[:, :, 1, :] == 0, bad)
    # a by-pol mask on a stream without a pol axis collapses over pol
    js, ts = _streams("sidereal", nfreq=4, nsamp=12, f0=700.0)
    jout = _run(jflagging.ApplyTimeFreqMask(), {"share": "none"}, js, jm)
    tout = _run(flagging.ApplyTimeFreqMask(), {"share": "none"}, ts, tm)
    assert np.array_equal(_np(tout.weight[:]), np.asarray(jout.weight[:]))
    assert np.array_equal(_np(tout.weight[:])[:, 0, :] == 0, marr.any(axis=0))


def test_apply_time_freq_mask_errors():
    js, ts = _streams("sidereal", nfreq=4, nsamp=12)
    jt, tt = _streams("time", nfreq=4, nsamp=12)
    jm, tm, _ = _mask_pair(js, ts)
    task = flagging.ApplyTimeFreqMask()
    task.read_config({})
    with pytest.raises(TypeError, match="must be an RFIMask or SiderealRFIMask"):
        task.process(ts, ts)
    with pytest.raises(TypeError, match="sidereal-like container is needed"):
        task.process(tt, tm)
    _, tm_t, _ = _mask_pair(jt, tt, cls="RFIMask")
    with pytest.raises(TypeError, match="time-like container is needed"):
        task.process(ts, tm_t)
    _, other_freq, _ = _mask_pair(js, ts, freq=ts.freq + 1.0)
    with pytest.raises(ValueError, match="disagree on the freq axis"):
        task.process(ts, other_freq)
    jh, th = _hybrid_pair(nra=12)
    _, other_pol, _ = _mask_pair(jh, th, cls="SiderealRFIMaskByPol", pol=np.array(["XX", "XY"]))
    with pytest.raises(ValueError, match="disagree on the pol axis"):
        task.process(th, other_pol)


def test_writable_copy_share_semantics():
    _, ts = _streams("sidereal", nfreq=4, nsamp=12)
    assert flagging._writable_copy(ts, "all") is ts
    none, vis = flagging._writable_copy(ts, "none"), flagging._writable_copy(ts, "vis")
    assert none.vis[:].data_ptr() != ts.vis[:].data_ptr() and none.weight[:].data_ptr() != ts.weight[:].data_ptr()
    assert vis.vis[:].data_ptr() == ts.vis[:].data_ptr() and vis.weight[:].data_ptr() != ts.weight[:].data_ptr()


# -- every task class resolves to the port -------------------------------------------


def _jax_tasks():
    out = []
    for name in ("flagging", "fringestop", "beam", "sensitivity"):
        mod = importlib.import_module(f"draco_tpu.analysis.{name}")
        out += [
            f"draco.analysis.{name}.{attr}"
            for attr, cls in sorted(vars(mod).items())
            if inspect.isclass(cls) and issubclass(cls, JContainerTask) and cls.__module__ == mod.__name__
        ]
    return out


@pytest.mark.parametrize("path", _jax_tasks())
def test_every_task_class_resolves_to_the_port(path):
    cls = _resolve_task_class(path)
    assert cls.__module__.startswith("draco_tpu_torch.analysis."), cls
    assert cls.__name__ == path.rsplit(".", 1)[1] or path.rsplit(".", 1)[1] in ("MaskData", "ApplyRFIMask",
                                                                                 "MaskBeamformedOutliers")


# -- group a: weights, baselines, day and m-mode masks ---------------------------------


def _np_rel(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    diff = np.abs(_np(got) - want).max()
    return diff / scale if scale > 0 else diff


def _sidereal_pair(nfreq=6, nfeed=3, nra=32, seed=10, lsd=None):
    freq = np.linspace(700.0, 700.0 - nfreq + 1, nfreq)
    rng = np.random.Generator(np.random.SFC64(seed))
    out = [mod.SiderealStream(freq=freq, input=nfeed, ra=nra) for mod in (jcontainers, containers)]
    shape = out[0].vis.shape
    vis = (1.0 + rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    weight = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    weight[:, 1, 4:8] = 0.0
    for ss in out:
        ss.vis[:] = vis
        ss.weight[:] = weight
        if lsd is not None:
            ss.attrs["lsd"] = lsd
    return out


@pytest.mark.parametrize(
    "params",
    [{}, {"remove_average": False}, {"zero_data": False, "start": 300.0, "end": 60.0, "width": 20.0}],
)
def test_day_mask_matches_jax(params):
    js, ts = _sidereal_pair()
    jout = _run(jflagging.DayMask(), params, js)
    tout = _run(flagging.DayMask(), params, ts)
    assert tout is ts
    assert _np_rel(tout.vis[:], jout.vis[:]) <= 1e-6
    assert _np_rel(tout.weight[:], jout.weight[:]) <= 1e-6
    ra = ts.ra
    if not params:
        assert np.allclose(_np(tout.weight[:])[..., (ra > 160) & (ra < 200)], 0.0)


@pytest.mark.parametrize("params", [{}, {"auto_correlations": True, "m_zero": True, "negative_m": False},
                                    {"positive_m": False, "mask_low_m": 2}])
def test_mask_mmode_data_matches_jax(params):
    pair = [mod.MModes(mmax=4, freq=np.array([400.0, 410.0]), input=3) for mod in (jcontainers, containers)]
    w = np.random.Generator(np.random.SFC64(11)).uniform(0.5, 2.0, pair[0].weight.shape)
    for mm in pair:
        mm.weight[:] = w
    jout = _run(jflagging.MaskMModeData(), params, pair[0])
    tout = _run(flagging.MaskData(), params, pair[1])
    assert np.array_equal(_np(tout.weight[:]), np.asarray(jout.weight[:]))


@pytest.fixture(scope="module")
def dishes():
    kw = dict(grid_ew=3, grid_ns=2, spacing_ew=10.0, spacing_ns=7.0, num_freq=3, force_lmax=8, force_mmax=8,
              auto_correlations=True)
    return JDishArray(**kw), UnpolarisedDishArray(**kw)


@pytest.fixture(scope="module")
def ptels():
    kw = dict(num_cylinders=2, num_feeds=2, feed_spacing=6.0, cylinder_spacing=20.0, latitude=45.0,
              freq_lower=400.0, freq_upper=420.0, num_freq=4, auto_correlations=True)
    return JPolCylinder(**kw), PolarisedCylinderTelescope(**kw)


def _baseline_pair(tel, seed=12, nra=8):
    prod = np.array([[int(a), int(b)] for a, b in tel.uniquepairs])
    rng = np.random.Generator(np.random.SFC64(seed))
    out = [mod.SiderealStream(freq=np.array([400.0, 450.0, 500.0]), input=tel.nfeed, ra=nra, prod=prod)
           for mod in (jcontainers, containers)]
    shape = out[0].vis.shape
    vis = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    weight = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    weight[:, 2, :6] = 0.0
    weight[:, 4] *= 0.01
    for ss in out:
        ss.vis[:] = vis
        ss.weight[:] = weight
    return out


@pytest.mark.parametrize(
    "params",
    [
        {"mask_short": 12.0},
        {"mask_long_ns": 5.0, "mask_short_ew": 1.0, "combine_method": "or"},
        {"mask_short_ns": 3.0, "mask_short": 25.0, "combine_method": "and", "zero_data": True},
        {"weight_threshold": 0.5, "share": "none"},
        {"missing_threshold": 0.3},
    ],
)
def test_mask_baselines_matches_jax(dishes, params):
    jtel, tel = dishes
    js, ts = _baseline_pair(tel)
    jt, tt = jflagging.MaskBaselines(), flagging.MaskBaselines()
    for t, tl in ((jt, jtel), (tt, tel)):
        t.read_config(params)
        t.setup(tl)
    jout, tout = jt.process(js), tt.process(ts)
    assert (tout is ts) == (params.get("share", "all") == "all")
    assert np.array_equal(_np(tout.weight[:]), np.asarray(jout.weight[:]))
    assert np.array_equal(_np(tout.vis[:]), np.asarray(jout.vis[:]))


def test_mask_baselines_by_pol_matches_jax(ptels):
    jtel, tel = ptels
    js, ts = _baseline_pair(tel, seed=13)
    outs = []
    for t, tl, s in ((jflagging.MaskBaselines(), jtel, js), (flagging.MaskBaselines(), tel, ts)):
        t.read_config({"mask_pol": ["XY", "YX"]})
        t.setup(tl)
        outs.append(t.process(s))
    assert np.array_equal(_np(outs[1].weight[:]), np.asarray(outs[0].weight[:]))
    assert (_np(outs[1].weight[:]) == 0).any()


@pytest.mark.parametrize("kind", ["FormedBeam", "FormedBeamHA"])
@pytest.mark.parametrize("window", [None, [3]])
def test_find_beamformed_outliers_matches_jax(kind, window):
    rng = np.random.Generator(np.random.SFC64(14))
    kw = dict(object_id=np.arange(6), freq=np.linspace(400, 410, 8), pol=np.array(["XX", "YY"]))
    if kind == "FormedBeamHA":
        kw["ha"] = np.linspace(-1, 1, 5)
    pair = [getattr(mod, kind)(**kw) for mod in (jcontainers, containers)]
    beam = rng.standard_normal(pair[0].beam.shape)
    beam.reshape(-1)[::29] += 8.0
    w = rng.uniform(0.5, 2.0, pair[0].weight.shape)
    for fb in pair:
        fb.beam[:] = beam
        fb.weight[:] = w
    params = {} if window is None else {"window": window}
    jout = _run(jflagging.FindBeamformedOutliers(), params, pair[0])
    tout = _run(flagging.FindBeamformedOutliers(), params, pair[1])
    assert type(tout).__name__ == type(jout).__name__ and tout.mask[:].dtype == bool
    assert np.array_equal(tout.mask[:], np.asarray(jout.mask[:])) and tout.mask[:].any()
    # ApplyGenericMask (MaskBeamformedOutliers) zeroes those weights
    jw = _run(jflagging.MaskBeamformedOutliers(), {}, pair[0], jout)
    tw = _run(flagging.ApplyGenericMask(), {}, pair[1], tout)
    assert np.array_equal(_np(tw.weight[:]), np.asarray(jw.weight[:]))


@pytest.mark.parametrize("replace", [True, False])
def test_radiometer_weight_matches_jax(replace):
    pair = _sidereal_pair(nfreq=3, nfeed=3, nra=10, seed=15)
    vis = np.asarray(pair[0].vis[:]).copy()
    rng = np.random.Generator(np.random.SFC64(15))
    for p in (0, 3, 5):  # the autos of a 3-feed triangle
        vis[:, p] = rng.uniform(2.0, 9.0, (3, 10))
    for ss in pair:
        ss.vis[:] = vis
    jout = _run(jflagging.RadiometerWeight(), {"replace": replace}, pair[0])
    tout = _run(flagging.RadiometerWeight(), {"replace": replace}, pair[1])
    assert _np_rel(tout.weight[:], jout.weight[:]) <= 1e-6


def test_sanitize_and_negative_autos_match_jax():
    js, ts = _sidereal_pair(nfreq=4, nfeed=3, nra=12, seed=16)
    w = np.asarray(js.weight[:]).copy()
    w[0, 0, :3] = 1e31
    w[1, 2, 5] = 1e-31
    vis = np.asarray(js.vis[:]).copy()
    vis[2, 3, 7] = -1.0
    for ss in (js, ts):
        ss.weight[:] = w
        ss.vis[:] = vis
    jout = _run(jflagging.SanitizeWeights(), {}, js)
    tout = _run(flagging.SanitizeWeights(), {}, ts)
    assert np.array_equal(_np(tout.weight[:]), np.asarray(jout.weight[:]))
    with pytest.raises(ValueError, match="threshold_min exceeds"):
        _run(flagging.SanitizeWeights(), {"min_thresh": 2.0, "max_thresh": 1.0}, ts)
    jm = _run(jflagging.NegativeAutosMask(), {}, js)
    tm = _run(flagging.NegativeAutosMask(), {}, ts)
    assert np.array_equal(tm.mask[:], np.asarray(jm.mask[:])) and tm.mask[2, 7]


@pytest.mark.parametrize("params", [{"kernel_size": 5}, {"kernel_size": 7, "mask_zeros": True}])
def test_smooth_vis_weight_matches_jax(params):
    js, ts = _sidereal_pair(nfreq=3, nra=40, seed=17)
    jout = _run(jflagging.SmoothVisWeight(), params, js)
    tout = _run(flagging.SmoothVisWeight(), params, ts)
    assert np.array_equal(_np(tout.weight[:]), np.asarray(jout.weight[:]))


@pytest.mark.parametrize("kind", ["sidereal", "time"])
def test_threshold_vis_weight_frequency_matches_jax(kind):
    js, ts = _streams(kind, nfreq=6, nsamp=20, seed=18)
    w = np.asarray(js.weight[:]).copy()
    w[2] = 1e-9
    w[4, :, 3] = 0.1
    for ss in (js, ts):
        ss.weight[:] = w
    jm = _run(jflagging.ThresholdVisWeightFrequency(), {}, js)
    tm = _run(flagging.ThresholdVisWeightFrequency(), {}, ts)
    assert type(tm).__name__ == type(jm).__name__
    assert np.array_equal(tm.mask[:], np.asarray(jm.mask[:])) and tm.mask[2].all() and tm.mask[4, 3]


@pytest.mark.parametrize("params", [{}, {"average_type": "mean", "relative_threshold": 0.2},
                                    {"relative_threshold": 0.1, "pols_to_flag": "copol",
                                     "ignore_absolute_threshold": 0.05}])
def test_threshold_vis_weight_baseline_and_collapse_match_jax(ptels, params):
    jtel, tel = ptels
    js, ts = _baseline_pair(tel, seed=19)
    for ss in (js, ts):
        ss.attrs.pop("lsd", None)
    outs = []
    for t, tl, s in ((jflagging.ThresholdVisWeightBaseline(), jtel, js),
                     (flagging.ThresholdVisWeightBaseline(), tel, ts)):
        t.read_config(params)
        t.setup(tl)
        outs.append(t.process(s))
    assert type(outs[1]).__name__ == "SiderealBaselineMask"
    assert np.array_equal(outs[1].mask[:], np.asarray(outs[0].mask[:]))
    jc = _run(jflagging.CollapseBaselineMask(), {}, outs[0])
    tc = _run(flagging.CollapseBaselineMask(), {}, outs[1])
    assert np.array_equal(tc.mask[:], np.asarray(jc.mask[:]))


def test_mask_bad_gains_and_beamformed_weights_match_jax():
    pair = [mod.TimeStream(freq=np.linspace(400, 410, 4), stack=2, input=3, prod=2, time=1e9 + np.arange(8))
            for mod in (jcontainers, containers)]
    g = np.full(pair[0].vis.shape[:1] + (3, 8), 2.0, dtype=np.complex64)
    g[1] = 1.0
    g[2, :, 5] = 0.5
    for ts in pair:
        ts.add_dataset("gain")
        ts.datasets["gain"][:] = g
    jm = _run(jflagging.MaskBadGains(), {}, pair[0])
    tm = _run(flagging.MaskBadGains(), {}, pair[1])
    assert np.array_equal(tm.mask[:], np.asarray(jm.mask[:])) and tm.mask[1].all() and tm.mask[2, 5]

    rng = np.random.Generator(np.random.SFC64(20))
    fbs = [mod.FormedBeam(object_id=np.arange(10), freq=np.linspace(400, 410, 8), pol=np.array(["XX", "YY"]))
           for mod in (jcontainers, containers)]
    w = rng.uniform(0.5, 2.0, fbs[0].weight.shape)
    w[3, 0, 2] = 1e6
    w[:4, 1] = 0.0
    for fb in fbs:
        fb.weight[:] = w
    jo = _run(jflagging.MaskBeamformedWeights(), {"nmed": 1.5}, fbs[0])
    to = _run(flagging.MaskBeamformedWeights(), {"nmed": 1.5}, fbs[1])
    assert np.array_equal(_np(to.weight[:]), np.asarray(jo.weight[:])) and _np(to.weight[:])[3, 0, 2] == 0


# -- group b: the RFI masks --------------------------------------------------------------


def _sensitivity_pair(seed=5, nfreq=64, ntime=96):
    rng = np.random.default_rng(seed)
    freq = np.linspace(500.0, 564.0, nfreq, endpoint=False)
    out = [mod.SystemSensitivity(freq=freq, pol=np.array(["XX", "YY"]), time=1e9 + 10.0 * np.arange(ntime))
           for mod in (jcontainers, containers)]
    radiometer = np.ones((nfreq, 2, ntime), dtype=np.float32)
    measured = radiometer * (1.0 + 0.01 * rng.standard_normal((nfreq, 2, ntime))).astype(np.float32)
    # 19 samples, where the JAX package's test has 20 (40:60): that block's
    # flagged run is 28 samples long, and a window of it and 7 unflagged
    # samples is exactly 80% flagged, the tie of the eta 0.2 widening (the
    # two packages then disagree on the 7th sample either side)
    measured[20:24, :, 40:59] *= 10.0
    measured[50] *= 4.0
    weight = np.ones((nfreq, 2, ntime), dtype=np.float32)
    weight[:, :, :2] = 0.0
    for sens in out:
        sens.radiometer[:] = radiometer
        sens.measured[:] = measured
        sens.weight[:] = weight
    return out


_SENS = {"niter": 3, "base_size": [9, 17], "mad_size": [13, 7], "win_f_1d": 15, "max_m": 8}


@pytest.mark.parametrize(
    "params",
    [
        {},
        {"mask_type": "mad", "niter": 2},
        {"mask_type": "sumthreshold", "niter": 2},
        {"sir": True, "eta": 0.23},
        {"sir": True, "eta": 0.37, "only_time": True, "include_pol": ["YY"]},
        {"sir": True},
        {"tv_fraction": 0.3, "quantile_1d": 0.3},
    ],
)
def test_rfi_sensitivity_mask_matches_jax(params):
    """The JAX package's test (tests/test_flagging2.py:323) in both packages."""
    js, ts = _sensitivity_pair()
    cfg = {**_SENS, **params}
    jm = _run(jflagging.RFISensitivityMask(), cfg, js)
    tm = _run(flagging.RFISensitivityMask(), cfg, ts)
    assert type(tm) is containers.RFIMask and tm.mask[:].shape == (64, 96)
    mask = tm.mask[:]
    assert np.array_equal(mask, np.asarray(jm.mask[:]))
    assert mask[21:23, 45:55].all() and mask[:, :2].all() and mask[30:48, 10:30].mean() < 0.1
    if not params:
        assert mask[20:24, 40:59].all() and mask[50].all()


def test_rfi_sensitivity_mask_sir_only_widens():
    _, ts = _sensitivity_pair()
    m_sir = _run(flagging.RFISensitivityMask(), {**_SENS, "niter": 2, "sir": True}, ts).mask[:]
    m_not = _run(flagging.RFISensitivityMask(), {**_SENS, "niter": 2, "sir": False}, ts).mask[:]
    assert (m_sir | m_not == m_sir).all()


def _cyl_timestream(tel, ntime=64, seed=21, mod=containers):
    nstack = tel.npairs
    ts = mod.TimeStream(freq=tel.frequencies, stack=nstack, input=tel.nfeed, prod=nstack,
                        time=1e9 + 10.0 * np.arange(ntime))
    rng = np.random.Generator(np.random.SFC64(seed))
    vis = 0.01 * (rng.standard_normal(ts.vis.shape) + 1j * rng.standard_normal(ts.vis.shape))
    vis[1, :, 30] += 200.0
    ts.vis[:] = vis.astype(np.complex64)
    ts.weight[:] = np.ones(ts.weight.shape, dtype=np.float32)
    return ts


@pytest.mark.parametrize("stokes_i", [False, True])
def test_rfi_transient_vis_mask_matches_jax(ptels, stokes_i):
    """The JAX package's test (tests/test_flagging2.py:96) in both packages."""
    jtel, tel = ptels
    params = {"stokes_i": stokes_i, "sigma_high": 6.0, "mad_base_size": [1, 31], "mad_dev_size": [1, 15]}
    outs = []
    for t, tl, mod in ((jflagging.RFITransientVisMask(), jtel, jcontainers),
                       (flagging.RFITransientVisMask(), tel, containers)):
        t.read_config(params)
        t.setup(tl)
        outs.append(t.process(_cyl_timestream(tl, mod=mod)))
    m = outs[1].mask[:]
    assert type(outs[1]) is containers.RFIMask
    assert np.array_equal(m, np.asarray(outs[0].mask[:]))
    assert m[1, 30] and m.mean() < 0.3


def _chisq_pair(seed=22, nfreq=64, ntime=32, nstack=3):
    rng = np.random.Generator(np.random.SFC64(seed))
    freq = np.linspace(400, 464, nfreq, endpoint=False)
    out = [mod.TimeStream(freq=freq, stack=nstack, input=3, prod=nstack, time=1e9 + 10.0 * np.arange(ntime))
           for mod in (jcontainers, containers)]
    chisq = 1.0 + 0.1 * rng.standard_normal((nfreq, nstack, ntime))
    chisq[20] = 30.0
    chisq[40, :, 10:13] = 3.0
    w = np.full((nfreq, nstack, ntime), 100.0, dtype=np.float32)
    w[5, :, 7] = 0.0
    for ts in out:
        ts.vis[:] = chisq.astype(np.complex64)
        ts.weight[:] = w
    return out


@pytest.mark.parametrize(
    "params",
    [
        {},
        {"estimate_var": True, "only_positive": True},
        {"mask_type": "sumthreshold", "niter": 2, "max_m": 4},
        {"mask_type": "sumthreshold", "niter": 2, "max_m": 4, "estimate_var": True, "win_f": 3},
        {"nsigma_1d": 0.0},
    ],
)
def test_rfi_mask_chisq_high_delay_matches_jax(params):
    """The JAX package's test (tests/test_flagging2.py:116) in both packages."""
    js, ts = _chisq_pair()
    cfg = {"win_t": 11, "win_f": 1, "nsigma_1d": 5.0, "nsigma_2d": 5.0, **params}
    jm = _run(jflagging.RFIMaskChisqHighDelay(), cfg, js)
    tm = _run(flagging.RFIMaskChisqHighDelay(), cfg, ts)
    m = tm.mask[:]
    assert type(tm) is containers.RFIMask and np.array_equal(m, np.asarray(jm.mask[:]))
    assert m.mean() < 0.5
    if cfg["nsigma_1d"] > 0:
        assert m[20].all()


def _static_pair(ptels, seed=23, ntime=48):
    from draco_tpu.analysis import transform as jtransform
    from draco_tpu_torch.analysis import transform as ttransform

    out = []
    for mod, tr, tel in ((jcontainers, jtransform, ptels[0]), (containers, ttransform, ptels[1])):
        maps = tr.TelescopeStreamMixIn()
        maps.setup(tel)
        out.append(mod.TimeStream(freq=tel.frequencies, input=tel.input_index, prod=maps.bt_prod,
                                  stack=maps.bt_stack, reverse_map_stack=maps.bt_rev,
                                  time=1e9 + 10.0 * np.arange(ntime)))
    rng = np.random.Generator(np.random.SFC64(seed))
    shape = out[0].vis.shape
    vis = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    vis[2] *= 30.0  # a channel of narrowband interference
    weight = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    for ts in out:
        ts.vis[:] = vis
        ts.weight[:] = weight
        ts.input_flags[:] = np.ones(ts.input_flags.shape, dtype=np.float32)
    return out


@pytest.mark.parametrize("params", [{"nsigma": 4.0, "winsize": (3, 5)}, {"nsigma": 6.0, "winsize": (3, 7),
                                                                          "mask_short": 5.0}])
def test_rfi_static_vis_mask_group_matches_jax(ptels, params):
    """MaskBaselines -> ReduceChisqInverseRedundancy -> the chi-squared
    frequency mask, as one grouped task, with ``stokes_i: false``.

    With ``stokes_i`` at its default (true) the mask forms Stokes I of the
    reduced stream, which has one stack: the JAX package's gather of the
    co-pol stacks runs out of bounds there and XLA clamps the index, so it
    reads the one stack many times over; the port raises."""
    jtel, tel = ptels
    js, ts = _static_pair(ptels)
    outs = []
    cfg = {"axes": ["stack"], "dataset": "vis", "weighting": "weighted", "stokes_i": False, **params}
    for cls, tl, s in ((jflagging.RFIStaticVisMask, jtel, js), (flagging.RFIStaticVisMask, tel, ts)):
        t = cls()
        t.read_config(cfg)
        t.setup(tl)
        outs.append(t.process(s))
    assert type(outs[1]) is containers.RFIMask
    assert np.array_equal(outs[1].mask[:], np.asarray(outs[0].mask[:])) and outs[1].mask[:][2].all()
    t = flagging.RFIStaticVisMask()
    t.read_config({**cfg, "stokes_i": True})
    t.setup(tel)
    with pytest.raises(RuntimeError, match="out of"):
        t.process(_static_pair(ptels)[1])


# -- group c: mask algebra ------------------------------------------------------------------


def _mask_pair_list(n, seed=24):
    js, ts = _sidereal_pair(nfreq=4, nra=12, seed=seed)
    rng = np.random.Generator(np.random.SFC64(seed))
    jl, tl = [], []
    for _ in range(n):
        arr = rng.uniform(size=(4, 12)) < 0.3
        jm, tm = jcontainers.SiderealRFIMask(axes_from=js), containers.SiderealRFIMask(axes_from=ts)
        jm.mask[:], tm.mask[:] = arr, arr
        jl.append(jm)
        tl.append(tm)
    return jl, tl


@pytest.mark.parametrize("expr", ["A", "A & ~B", "(A | B) ^ C", "~A | C & B"])
def test_general_combine_masks_matches_jax(expr):
    jl, tl = _mask_pair_list(3)
    jo = _run(jflagging.GeneralCombineMasks(), {"expression": expr}, jl)
    to = _run(flagging.GeneralCombineMasks(), {"expression": expr}, tl)
    assert np.array_equal(to.mask[:], np.asarray(jo.mask[:])) and to is not tl[0]
    jc = _run(jflagging.CombineMasks(), {}, jl)
    tc = _run(flagging.CombineMasks(), {}, tl)
    assert np.array_equal(tc.mask[:], np.asarray(jc.mask[:]))
    with pytest.raises(ValueError, match="Cannot parse"):
        _run(flagging.GeneralCombineMasks(), {"expression": "A + B"}, tl)


def _taper_pair(seed=25, nra=8, nel=3):
    rng = np.random.Generator(np.random.SFC64(seed))
    kw = dict(freq=np.linspace(400, 410, 2), pol=np.array(["XX", "YY"]), ra=nra, el=np.linspace(-0.1, 0.1, nel))
    out = [mod.RingMapTaper(**kw) for mod in (jcontainers, containers)]
    t = rng.uniform(0.0, 1.0, out[0].taper.shape)
    t[:, :, 2] = 0.0
    t[:, :, 5] = 1.0
    for tp in out:
        tp.taper[:] = t
    return out


@pytest.mark.parametrize("expr", ["A * B", "A + B - A / (B + 1)"])
def test_tapers_match_jax(expr):
    j1, t1 = _taper_pair(25)
    j2, t2 = _taper_pair(26)
    jo = _run(jflagging.GeneralCombineTapers(), {"expression": expr}, [j1, j2])
    to = _run(flagging.GeneralCombineTapers(), {"expression": expr}, [t1, t2])
    assert _np_rel(to.taper[:], jo.taper[:]) <= 1e-12
    jc = _run(jflagging.CombineTapers(), {}, [j1, j2])
    tc = _run(flagging.CombineTapers(), {}, [t1, t2])
    assert _np_rel(tc.taper[:], jc.taper[:]) <= 1e-12
    for outer in (False, True):
        jm = _run(jflagging.MaskFromTaper(), {"outer": outer}, j1)
        tm = _run(flagging.MaskFromTaper(), {"outer": outer}, t1)
        assert type(tm) is containers.RingMapMask and np.array_equal(tm.mask[:], np.asarray(jm.mask[:]))


@pytest.mark.parametrize("update_weight", [False, True])
def test_apply_taper_matches_jax(update_weight):
    jt, tt = _taper_pair(27)
    rng = np.random.Generator(np.random.SFC64(27))
    kw = dict(freq=np.linspace(400, 410, 2), beam=np.arange(1), pol=np.array(["XX", "YY"]), ra=8,
              el=np.linspace(-0.1, 0.1, 3))
    maps = [mod.RingMap(**kw) for mod in (jcontainers, containers)]
    m = rng.standard_normal(maps[0].map.shape)
    w = rng.uniform(0.5, 2.0, maps[0].weight.shape)
    for rm in maps:
        rm.map[:] = m
        rm.weight[:] = w
    jo = _run(jflagging.ApplyTaper(), {"update_weight": update_weight}, maps[0], jt)
    to = _run(flagging.ApplyTaper(), {"update_weight": update_weight}, maps[1], tt)
    assert _np_rel(to.map[:], jo.map[:]) <= 1e-6 and _np_rel(to.weight[:], jo.weight[:]) <= 1e-6


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("update_weight", [False, True])
def test_taper_delay_transform_matches_jax(use_mask, update_weight):
    jt, tt = _taper_pair(28, nra=6, nel=3)
    applies = (jt, tt)
    if use_mask:
        applies = tuple(_run(mod.MaskFromTaper(), {"outer": True}, t) for mod, t in ((jflagging, jt), (flagging, tt)))
    rng = np.random.Generator(np.random.SFC64(28))
    pair = []
    for mod in (jcontainers, containers):
        dt = mod.DelayTransform(baseline=6, sample=np.asarray(jt.ra), delay=np.arange(5))
        dt.create_index_map("pol", np.array(["XX", "YY"]))
        dt.create_index_map("el", np.asarray(jt.index_map["el"]))
        dt.attrs["baseline_axes"] = ["pol", "el"]
        dt.add_dataset("weight")
        pair.append(dt)
    spec = rng.standard_normal(pair[0].spectrum.shape) + 1j * rng.standard_normal(pair[0].spectrum.shape)
    w = rng.uniform(0.5, 2.0, pair[0].weight.shape).astype(np.float32)
    for dt in pair:
        dt.spectrum[:] = spec
        dt.weight[:] = w
    params = {"update_weight": update_weight}
    jo = _run(jflagging.TaperDelayTransform(), params, pair[0], applies[0])
    to = _run(flagging.TaperDelayTransform(), params, pair[1], applies[1])
    assert _np_rel(to.spectrum[:], jo.spectrum[:]) <= 1e-12 and _np_rel(to.weight[:], jo.weight[:]) <= 1e-6


@pytest.mark.parametrize("share", ["all", "none"])
def test_apply_baseline_mask_matches_jax(share):
    pair = [mod.TimeStream(freq=np.linspace(400, 410, 3), stack=4, input=4, prod=4, time=1e9 + np.arange(6))
            for mod in (jcontainers, containers)]
    rng = np.random.Generator(np.random.SFC64(29))
    w = rng.uniform(0.5, 2.0, pair[0].weight.shape).astype(np.float32)
    marr = rng.uniform(size=w.shape) < 0.3
    masks = []
    for ts, mod in zip(pair, (jcontainers, containers)):
        ts.weight[:] = w
        bm = mod.BaselineMask(axes_from=ts)
        bm.mask[:] = marr
        masks.append(bm)
    jo = _run(jflagging.ApplyBaselineMask(), {"share": share}, pair[0], masks[0])
    to = _run(flagging.ApplyBaselineMask(), {"share": share}, pair[1], masks[1])
    assert np.array_equal(_np(to.weight[:]), np.asarray(jo.weight[:])) and (to is pair[1]) == (share == "all")
    with pytest.raises(TypeError, match="BaselineMask or SiderealBaselineMask"):
        _run(flagging.ApplyBaselineMask(), {}, pair[1], pair[1])


@pytest.mark.parametrize(
    "params",
    [
        {"bad_freq_ind": [0, [4, 6]]},
        {"mask_missing_data": True, "freq_frac": 0.5},
        {"all_time": True},
        {"factorize": True},
    ],
)
def test_mask_freq_matches_jax(params):
    js, ts = _sidereal_pair(nfreq=6, nra=24, seed=30)
    w = np.asarray(js.weight[:]).copy()
    w[3] = 0.0
    w[:, :, 10:12] = 0.0
    w[1, :, 15:] = 0.0
    for ss in (js, ts):
        ss.weight[:] = w
    jm = _run(jflagging.MaskFreq(), params, js)
    tm = _run(flagging.MaskFreq(), params, ts)
    assert np.array_equal(tm.mask[:], np.asarray(jm.mask[:])) and tm.mask[3].all()


@pytest.mark.parametrize(
    "params",
    [{"frac": 1e-2, "match_median": False}, {}, {"subtract": True, "mask_freq": True}, {"mask_freq": True, "frac": 0.1}],
)
def test_blend_stack_matches_jax(params):
    jstack, tstack = _sidereal_pair(nfreq=3, nra=16, seed=31)
    jday, tday = _sidereal_pair(nfreq=3, nra=16, seed=32)
    w = np.asarray(jday.weight[:]).copy()
    w[..., 4:8] = 0.0
    w[2] = 0.0
    for d in (jday, tday):
        d.weight[:] = w
    jt, tt = jflagging.BlendStack(), flagging.BlendStack()
    for t, st in ((jt, jstack), (tt, tstack)):
        t.read_config(params)
        t.setup(st)
    jo, to = jt.process(jday), tt.process(tday)
    assert _np_rel(to.vis[:], jo.vis[:]) <= 1e-6 and _np_rel(to.weight[:], jo.weight[:]) <= 1e-6


# -- group d: mask regridding and the helpers ------------------------------------------


def test_mask_regridders_and_reduce_el_match_jax(ptels):
    """The JAX package's test (tests/test_flagging2.py:230) in both packages."""
    jtel, tel = ptels
    sid_day = 86164.0905
    times = tel.lsd_to_unix(1000.0) + np.linspace(-0.1, 1.15, 128) * sid_day
    rng = np.random.Generator(np.random.SFC64(33))
    arr = rng.uniform(size=(4, 128, 3)) < 0.05
    arr[2, 50:60] = True
    pair = []
    for mod in (jcontainers, containers):
        m = mod.LocalizedRFIMask(freq=tel.frequencies, el=np.linspace(-0.1, 0.1, 3), time=times)
        m.mask[:] = arr.transpose(0, 1, 2) if m.mask.shape == arr.shape else np.moveaxis(arr, 1, 2)
        pair.append(m)
    outs = []
    for cls, tl, m in ((jflagging.RFIMaskSiderealRegridderNearest, jtel, pair[0]),
                       (flagging.RFIMaskSiderealRegridderNearest, tel, pair[1])):
        t = cls()
        t.read_config({"npix": 256, "spread_factor": 1.0})
        t.setup(tl)
        outs.append(t.process(m))
    assert type(outs[1]) is containers.LocalizedSiderealRFIMask
    assert np.array_equal(outs[1].mask[:], np.asarray(outs[0].mask[:])) and outs[1].mask[2].any()
    jr = _run(jflagging.ReduceMaskEl(), {"el_threshold": 1}, outs[0])
    tr = _run(flagging.ReduceMaskEl(), {"el_threshold": 1}, outs[1])
    assert type(tr) is containers.SiderealRFIMask and np.array_equal(tr.mask[:], np.asarray(jr.mask[:]))
    jr = _run(jflagging.ReduceMaskEl(), {"el_threshold": 2}, pair[0])
    tr = _run(flagging.ReduceMaskEl(), {"el_threshold": 2}, pair[1])
    assert type(tr) is containers.RFIMask and np.array_equal(tr.mask[:], np.asarray(jr.mask[:]))

    # onto another stream's time axis, finer and coarser
    for target in (times[::2] + 5.0, np.linspace(times[0], times[-1], 300)):
        tgt = [mod.TimeStream(freq=tel.frequencies, input=2, time=target) for mod in (jcontainers, containers)]
        outs = []
        for cls, m, tg in ((jflagging.RFIMaskTimeRegridderNearest, pair[0], tgt[0]),
                           (flagging.RFIMaskTimeRegridderNearest, pair[1], tgt[1])):
            t = cls()
            t.read_config({"spread_factor": 1.0})
            t.setup(tg)
            outs.append(t.process(m))
        assert np.array_equal(outs[1].mask[:], np.asarray(outs[0].mask[:]))


def test_apply_localized_rfi_mask_matches_jax(ptels):
    """The JAX package's test (tests/test_flagging2.py:260) in both packages."""
    _, tel = ptels
    rng = np.random.Generator(np.random.SFC64(34))
    kw = dict(freq=tel.frequencies, beam=np.arange(1), pol=np.array(["XX", "YY"]), ra=16, el=np.linspace(-0.1, 0.1, 3))
    maps = [mod.RingMap(**kw) for mod in (jcontainers, containers)]
    w = rng.uniform(0.5, 2.0, maps[0].weight.shape)
    arr = rng.uniform(size=(4, 16, 3)) < 0.2
    masks = []
    for rm, mod in zip(maps, (jcontainers, containers)):
        rm.weight[:] = w
        lm = mod.LocalizedSiderealRFIMask(freq=tel.frequencies, ra=np.asarray(rm.ra)[2:14],
                                         el=np.asarray(rm.index_map["el"])[1:])
        lm.mask[:] = arr[:, 2:14, 1:]
        masks.append(lm)
    jo = _run(jflagging.ApplyLocalizedRFIMask(), {"share": "none"}, maps[0], masks[0])
    to = _run(flagging.ApplyLocalizedRFIMask(), {"share": "none"}, maps[1], masks[1])
    assert np.array_equal(_np(to.weight[:]), np.asarray(jo.weight[:]))
    assert np.array_equal(_np(maps[1].weight[:]), w)  # share none: a copy was edited


def test_helpers_match_jax(ptels):
    rng = np.random.Generator(np.random.SFC64(35))
    x = rng.standard_normal((16, 33)) + 1j * rng.standard_normal((16, 33)) + 5.0
    w = rng.uniform(size=x.shape) > 0.3
    w[3] = False
    assert np.array_equal(flagging.destripe(x, w, axis=1), jflagging.destripe(x, w, axis=1), equal_nan=True)
    got = flagging.destripe(torch.from_numpy(x), torch.from_numpy(w), axis=1)
    assert np.array_equal(_np(got), jflagging.destripe(x, w, axis=1), equal_nan=True)
    xn = np.where(w, x, np.nan + 1j * np.nan)
    for axis in (0, 1):
        want = jflagging.complex_med(xn, axis=axis)
        assert np.array_equal(flagging.complex_med(xn, axis=axis), want, equal_nan=True)
        assert np.array_equal(_np(flagging.complex_med(torch.from_numpy(xn), axis=axis)), want, equal_nan=True)
    a = rng.standard_normal((2, 3, 4))
    for src, dst in ((["a", "b", "c"], ["c", "x", "a", "b"]), (["b", "a", "c"], ["a", "b", "c"])):
        want = jflagging._align_to(a, src, dst)
        assert np.array_equal(flagging._align_to(a, src, dst), want)
        assert np.array_equal(_np(flagging._align_to(torch.from_numpy(a), src, dst)), want)
    jtel, tel = ptels
    js, ts = _sidereal_pair(nfreq=2, nra=8, lsd=[1000, 1001])
    jt, jmany = jflagging._sample_unix_times(js, jtel)
    tt, tmany = flagging._sample_unix_times(ts, tel)
    assert np.array_equal(tt, jt) and tmany == jmany is True
    with pytest.raises(RuntimeError, match="provide telescope"):
        flagging._sample_unix_times(ts)
