"""The RFI-mask tasks: draco_tpu_torch against draco_tpu on the same inputs.

``RFIMask``, ``ApplyTimeFreqMask`` and their helpers (``medfilt``, ``mad``,
``tv_channels_flag``, the binomial/Gaussian conversions) run in both
packages on the same seeded numpy inputs, the port on the CPU.

Tolerances: the MAD statistics are host float64 numpy in both packages,
so the helpers and the masks are held to exact equality; the masked
weights are exactly 0 and the others bit-identical to the input.  The one
deliberate difference, the weight multiplied on the stream's device in
place of a host copy, is held by
``test_apply_time_freq_mask_matches_jax_and_edits_where_share_says``.
"""

import numpy as np
import pytest
import torch

from draco_tpu.analysis import flagging as jflagging
from draco_tpu.core import containers as jcontainers
from draco_tpu.ops import filters as jfilters
from draco_tpu_torch.analysis import flagging
from draco_tpu_torch.core import containers
from draco_tpu_torch.device import default_device
from draco_tpu_torch.ops import filters


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


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
