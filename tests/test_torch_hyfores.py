"""HyFoReS and the stack-map helpers: draco_tpu_torch against draco_tpu on the same inputs.

``tests/test_hyfores.py``'s scene (32 channels, one pol, two EW columns, 5
elevations, 16 RA samples: smooth foregrounds with a 5% bandpass ripple at
0.3 us, a 0.1 us DAYENU filter), and variations with flagged samples, two
pols and a pixel mask.  The JAX package on the CPU with 64-bit types, the
port on the CPU.  Tolerances, max|diff| / max|ref|:

- the gains and window (complex128 sums in both packages, the filter
  applied to complex64 data): 1e-5;
- ``Clean``'s compensated gains and singular values: 1e-5; its filtered
  data 1e-4 (the filter cancels a foreground ~1e4 times the output; the
  port does that in complex64, the JAX package in complex128: 1.5e-5 to
  4.3e-5 measured); its weights and filtered
  covariance 1e-5 relative (they follow the compensated gains), the
  weights' zeros exact;
- ``polarization_map`` and ``baseline_vector``: exact (host copies).
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from draco_tpu.analysis import hyforesbandpass as jhf
from draco_tpu.core import containers as jcontainers
from draco_tpu.ops import dayenu as jdayenu_ops
from draco_tpu.ops import tools as jtools
from draco_tpu.telescope import PolarisedCylinderTelescope as JPolCyl
from draco_tpu_torch.analysis import hyforesbandpass as thf
from draco_tpu_torch.core import containers
from draco_tpu_torch.device import default_device
from draco_tpu_torch.ops import tools as ttools
from draco_tpu_torch.telescope import PolarisedCylinderTelescope

NFREQ = 32
FREQ = np.linspace(400.0, 432.0, NFREQ, endpoint=False)
TOL = 1e-5
TOL_CLEAN = 1e-4


@pytest.fixture(autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch and the BLAS pools (beside five other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ptel():
    kw = dict(num_cylinders=2, num_feeds=3, feed_spacing=0.5, cylinder_spacing=20.0, latitude=45.0,
              freq_lower=400.0, freq_upper=432.0, num_freq=2, auto_correlations=True)
    return JPolCyl(**kw), PolarisedCylinderTelescope(**kw)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref, scale=None):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max() if scale is None else scale), 1e-300)


def _scene(npol=1, flagged=False, seed=0):
    """``tests/test_hyfores.py``'s scene in both packages: (hv pair, source pair, g_true)."""
    rng = np.random.default_rng(seed)
    nel, nra, new = 5, 16, 2
    f = np.zeros((npol, NFREQ, nel, nra), dtype=np.complex128)
    for tau in (0.0, 0.02, 0.05):
        amp = rng.standard_normal((npol, nel, nra)) + 1j * rng.standard_normal((npol, nel, nra))
        f += 10.0 * amp[:, None] * np.exp(2j * np.pi * tau * FREQ)[None, :, None, None]
    g_true = 0.05 * np.cos(2 * np.pi * 0.3 * FREQ)
    vis = (1.0 + g_true)[None, :, None, None, None] * f[:, :, None]
    vis = np.concatenate([vis, vis], axis=2)[:, :, :new].astype(np.complex64)
    w = np.ones((npol, NFREQ, new, nra), np.float32)
    flag = np.ones((NFREQ, 1), bool)
    NF = jdayenu_ops.highpass_delay_filter(FREQ, 0.1, flag)[0][0]
    filt = np.broadcast_to(NF[None, :, :, None, None], (npol, NFREQ, NFREQ, new, nra)).copy()
    if flagged:
        w[:, 3, 0, 2:4] = 0.0  # a channel the filter assumes valid: those columns are dropped
        filt[:, 6, :, 1, 5] = 0.0  # a column whose filter drops a channel
        filt[:, :, 6, 1, 5] = 0.0
        w[:, 6, 1, 5] = 0.0
    pols = np.array(["XX", "YY"][:npol])
    kw = dict(freq=FREQ, pol=pols, ew=np.array([0.0, 20.0]), el=np.linspace(-0.2, 0.2, nel), ra=nra)
    hvs, srcs = [], []
    for mod, extra in ((jcontainers, {}), (containers, {"device": "cpu"})):
        hv = mod.HybridVisStream(**kw, **extra)
        hv.vis[:], hv.weight[:] = vis, w
        src = mod.HybridVisStream(**kw, **extra)
        src.vis[:] = np.zeros(vis.shape, np.complex64)
        src.weight[:] = w
        src.add_dataset("filter")
        src.filter[:] = filt
        hvs.append(hv)
        srcs.append(src)
    return hvs, srcs, g_true


def _run(task, params, *inputs, setup=()):
    task.read_config(params)
    task.setup(*setup)
    return task.process(*inputs)


@pytest.mark.parametrize("npol,flagged,atten", [(1, False, 0.0), (2, True, 0.0), (2, True, 0.9)])
def test_gains_window_and_clean_match_jax(ptel, npol, flagged, atten):
    (jh, th), (js, ts), g_true = _scene(npol, flagged)
    jbp = _run(jhf.DelayFilterHyFoReSBandpassHybridVis(), {"atten_threshold": atten}, jh, js, setup=(ptel[0],))
    tbp = _run(thf.DelayFilterHyFoReSBandpassHybridVis(), {"atten_threshold": atten}, th, ts, setup=(ptel[1],))
    assert _rel(tbp.bandpass[:], np.asarray(jbp.bandpass[:])) <= TOL
    assert _rel(tbp.window[:], np.asarray(jbp.window[:])) <= TOL

    params = {"cutoff": 1e-2, "calculate_cov": True, "atten_threshold": atten}
    jout, jcomp = _run(jhf.DelayFilterHyFoReSBandpassHybridVisClean(), params, jh, js, jbp)
    tout, tcomp = _run(thf.DelayFilterHyFoReSBandpassHybridVisClean(), params, th, ts, tbp)
    assert _rel(tcomp.comp_bandpass[:], np.asarray(jcomp.comp_bandpass[:])) <= TOL
    assert _rel(tcomp.sval[:], np.asarray(jcomp.sval[:])) <= TOL
    assert np.array_equal(tcomp.attrs["rank"], jcomp.attrs["rank"])
    assert _rel(tout.vis[:], np.asarray(jout.vis[:])) <= TOL_CLEAN
    wj, wt = np.asarray(jout.weight[:]), _np(tout.weight[:])
    assert np.array_equal(wj == 0, wt == 0) and _rel(wt, wj) <= TOL
    assert _rel(tout.freq_cov[:], np.asarray(jout.freq_cov[:])) <= TOL


def test_the_ripple_is_recovered(ptel):
    """``tests/test_hyfores.py``'s recovery on the port."""
    (_, th), (_, ts), g_true = _scene()
    bp = _run(thf.DelayFilterHyFoReSBandpassHybridVis(), {}, th, ts, setup=(ptel[1],))
    assert bool(torch.isfinite(bp.bandpass[:]).all()) and bool(torch.isfinite(bp.window[:]).all())
    out, comp = _run(thf.DelayFilterHyFoReSBandpassHybridVisClean(), {"cutoff": 1e-2}, th, ts, bp)
    g_est = _np(comp.comp_bandpass[:]).real
    for xx in range(2):
        resid = (g_est[0, xx] - g_true)[2:-2]
        assert np.median(np.abs(resid)) < 0.3 * np.abs(g_true).max()
        assert np.corrcoef(g_est[0, xx], g_true)[0, 1] > 0.8
    assert bool(torch.isfinite(out.vis[:]).all()) and bool((out.weight[:] > 0).all())


def test_clean_without_compensation_matches_jax(ptel):
    (jh, th), (js, ts), _ = _scene()
    jbp = _run(jhf.DelayFilterHyFoReSBandpassHybridVis(), {}, jh, js, setup=(ptel[0],))
    tbp = _run(thf.DelayFilterHyFoReSBandpassHybridVis(), {}, th, ts, setup=(ptel[1],))
    jout, jcomp = _run(jhf.DelayFilterHyFoReSBandpassHybridVisClean(), {"cutoff": 0.0}, jh, js, jbp)
    tout, tcomp = _run(thf.DelayFilterHyFoReSBandpassHybridVisClean(), {"cutoff": 0.0}, th, ts, tbp)
    assert _rel(tcomp.comp_bandpass[:], np.asarray(jcomp.comp_bandpass[:])) <= TOL
    assert _rel(tout.vis[:], np.asarray(jout.vis[:])) <= TOL_CLEAN


def _prefiltered(hv_pair, src_pair):
    """(pf_hv pair) holding the filtered data and the filter, as the DAYENU task leaves them."""
    out = []
    for mod, hv, src, extra in ((jcontainers, hv_pair[0], src_pair[0], {}),
                                (containers, hv_pair[1], src_pair[1], {"device": "cpu"})):
        filt, vis = _np(src.filter[:]), _np(hv.vis[:])
        pf = mod.HybridVisStream(axes_from=hv, **extra)
        pf.vis[:] = np.einsum("pfgxt,pgxet->pfxet", filt, vis).astype(np.complex64)
        pf.weight[:] = _np(hv.weight[:])
        pf.add_dataset("filter")
        pf.filter[:] = filt
        out.append(pf)
    return out


def _masks(hv_pair, pixels=()):
    out = []
    for mod, hv, extra in ((jcontainers, hv_pair[0], {}), (containers, hv_pair[1], {"device": "cpu"})):
        m = mod.RingMapMask(freq=FREQ, pol=np.asarray(hv.index_map["pol"]), ra=np.asarray(hv.ra),
                            el=np.asarray(hv.index_map["el"]), **extra)
        arr = np.zeros(m.mask.shape, bool)
        for p in pixels:
            arr[p] = True
        m.mask[:] = arr
        out.append(m)
    return out


@pytest.mark.parametrize("pixels", [(), ((slice(None), slice(None), 3, 2), (0, 5, slice(None), 1))])
def test_prefiltered_and_masked_variants_match_jax(ptel, pixels):
    (jh, th), srcs, _ = _scene(2)
    jpf, tpf = _prefiltered((jh, th), srcs)
    jm, tm = _masks((jh, th), pixels)
    jm2, tm2 = _masks((jh, th), pixels[:1])
    cases = [
        ("HyFoReSBandpassHybridVis", (jh, jpf), (th, tpf)),
        ("HyFoReSBandpassHybridVisMask", (jh, jpf, jm), (th, tpf, tm)),
        ("HyFoReSBandpassHybridVisMaskKeepSource", (jh, jpf, jm, jm2), (th, tpf, tm, tm2)),
        ("DelayFilterHyFoReSBandpassHybridVisMask", (jh, srcs[0], jm), (th, srcs[1], tm)),
    ]
    outs = {}
    for name, jin, tin in cases:
        jo = _run(getattr(jhf, name)(), {}, *jin, setup=(ptel[0],))
        to = _run(getattr(thf, name)(), {}, *tin, setup=(ptel[1],))
        assert _rel(to.bandpass[:], np.asarray(jo.bandpass[:])) <= TOL, name
        assert _rel(to.window[:], np.asarray(jo.window[:])) <= TOL, name
        outs[name] = to
    if not pixels:
        # empty masks: the three pre-filtered variants agree
        ref = outs["HyFoReSBandpassHybridVis"].bandpass[:]
        for name in ("HyFoReSBandpassHybridVisMask", "HyFoReSBandpassHybridVisMaskKeepSource"):
            assert torch.equal(outs[name].bandpass[:], ref)


def test_the_filter_is_read_from_either_input(ptel):
    """The filter may sit on the filtered stream (the DAYENU task's output) or the raw one."""
    (_, th), srcs, _ = _scene()
    _, tpf = _prefiltered(*_scene()[:2])
    a = _run(thf.HyFoReSBandpassHybridVis(), {}, th, tpf, setup=(ptel[1],))
    th.add_dataset("filter")
    th.filter[:] = tpf.filter[:]
    del tpf.datasets["filter"]
    b = _run(thf.HyFoReSBandpassHybridVis(), {}, th, tpf, setup=(ptel[1],))
    assert torch.equal(a.bandpass[:], b.bandpass[:])
    del th.datasets["filter"]
    with pytest.raises(KeyError, match="save_filter"):
        _run(thf.HyFoReSBandpassHybridVis(), {}, th, tpf, setup=(ptel[1],))


def test_mismatched_axes_raise(ptel):
    (_, th), (_, ts), _ = _scene()
    other = containers.HybridVisStream(freq=FREQ, pol=np.array(["XX"]), ew=np.array([0.0, 20.0]),
                                       el=np.linspace(-0.2, 0.2, 5), ra=15, device="cpu")
    with pytest.raises(ValueError, match="ra does not match"):
        _run(thf.DelayFilterHyFoReSBandpassHybridVis(), {}, other, ts, setup=(ptel[1],))


# -- stack-map helpers ---------------------------------------------------------------


def _index_map(tel, conj_some=True):
    nfeed = tel.nfeed
    pairs = np.array([(i, j) for i in range(nfeed) for j in range(i, nfeed)])
    prod = np.zeros(len(pairs), dtype=[("input_a", int), ("input_b", int)])
    prod["input_a"], prod["input_b"] = pairs.T
    sel = np.arange(0, len(pairs), 3)
    stack = np.zeros(len(sel), dtype=[("prod", int), ("conjugate", bool)])
    stack["prod"] = sel
    stack["conjugate"] = conj_some & (sel % 2 == 1)
    inp = np.zeros(nfeed, dtype=[("chan_id", int), ("correlator_input", "U16")])
    inp["chan_id"] = np.arange(nfeed)
    return {"input": inp, "prod": prod, "stack": stack}


@pytest.mark.parametrize("exclude_autos", [True, False])
def test_polarization_map_and_baseline_vector_match_jax(ptel, exclude_autos):
    im = _index_map(ptel[0])
    pj = jtools.polarization_map(im, ptel[0], exclude_autos=exclude_autos)
    pt = ttools.polarization_map(im, ptel[1], exclude_autos=exclude_autos)
    assert np.array_equal(pt, pj) and set(np.unique(pt)) <= {-1, 0, 1, 2, 3}
    bj = jtools.baseline_vector(im, ptel[0])
    bt = ttools.baseline_vector(im, ptel[1])
    assert bt.shape == (2, len(im["stack"])) and np.array_equal(bt, bj)
