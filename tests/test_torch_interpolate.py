"""DPSS inpainting: draco_tpu_torch against draco_tpu on the same inputs.

Small sizes (16-128 samples, 3-4 baselines), numpy inputs from a seed; the
JAX package on the CPU with 64-bit types, the port on the CPU.
Tolerances, max|diff| / max|ref| unless stated:

- ``make_covariance``: 1e-12 (torch's and numpy's sinc and exp);
- ``get_basis``: the same mode count, and the projector ``A A^H`` within
  1e-5 (an eigenvector's sign is the LAPACK's choice, and the kept modes
  reach down to the 1e-12 threshold, where the eigenvalues are known only
  to eps x the largest: the eigenvectors there rotate among themselves;
  measured 1.3e-6.  The solves depend only on the span);
- the batched solves, ``filter`` and ``inpaint`` in float64: 1e-10.  On
  float32/complex64 data with the float32 basis, the port's error against
  the JAX functions' float64 result is at most twice the JAX functions'
  own float32 error.  The reason: the Wiener system ``A^H N A + Si I`` has
  condition ~nsamp max(Ni) / Si ~ 1e5 here, so float32 rounding moves its
  solution by up to ~6e-3; the JAX functions' float32 results miss float64
  by 3.3e-4 (data) and 1.1e-2 (weights), the port's by 2.9e-4 and 9.9e-3
  (measured), so no fixed figure near 1e-5 holds either package;
- ``accumulate_variance`` (scipy's PCHIP against the port's batched one):
  1e-10 in float64; ``flag_above_cutoff``: exact;
- every task on complex64 data: 5e-4 of the data's peak, weights 5e-4
  relative with their zeros exact (the same float32 solve: 2.2e-5 on the
  delay scenes, 1.4e-4 on the m-mode scene, measured).

A weight row whose factorisation fails: the JAX package returns NaN, the
port zero data and zero weight, counted (held here on the port alone).
"""

import numpy as np
import pytest
import torch
from scipy.interpolate import PchipInterpolator
from threadpoolctl import threadpool_limits

from draco_tpu.analysis import interpolate as jinterp
from draco_tpu.core import containers as jcontainers
from draco_tpu.ops import dpss as jdpss
from draco_tpu.telescope import UnpolarisedCylinderTelescope as JUCyl
from draco_tpu.telescope import UnpolarisedDishArray as JDish
from draco_tpu_torch.analysis import interpolate as tinterp
from draco_tpu_torch.core import containers
from draco_tpu_torch.device import default_device
from draco_tpu_torch.ops import dpss as tdpss
from draco_tpu_torch.telescope import UnpolarisedCylinderTelescope, UnpolarisedDishArray

TOL64 = 1e-10
TOL_TASK = 5e-4
TOL_SPAN = 1e-5


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


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref, scale=None):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max() if scale is None else scale), 1e-300)


def _run(task, params, *inputs, setup=()):
    task.read_config(params)
    task.setup(*setup)
    return task.process(*inputs)


def _bandlimited(rng, n, halfwidth, nsrc=6):
    t = np.arange(n, dtype=np.float64)
    x = np.zeros(n)
    for _ in range(nsrc):
        f = rng.uniform(-0.8 * halfwidth, 0.8 * halfwidth)
        x += rng.standard_normal() * np.cos(2 * np.pi * f * t) + rng.standard_normal() * np.sin(2 * np.pi * f * t)
    return x


# -- basis ---------------------------------------------------------------


@pytest.mark.parametrize("hw,ct", [(0.1, 0.0), ([0.05, 0.02], [0.0, 0.2])])
def test_covariance_and_basis_match_jax(hw, ct):
    s = np.arange(48.0) * 0.7
    cj = jdpss.make_covariance(s, hw, ct)
    ctt = tdpss.make_covariance(s, hw, ct, device="cpu")
    assert ctt.is_complex() == np.iscomplexobj(cj)
    assert _rel(ctt, cj) <= 1e-12
    for dtype in (np.float64, np.float32):
        Aj = jdpss.get_basis(cj, dtype=dtype)
        At = tdpss.get_basis(ctt, dtype=dtype)
        assert At.shape == Aj.shape and _np(At).dtype == Aj.dtype
        assert _rel(At @ At.conj().T, Aj @ Aj.conj().T) <= TOL_SPAN


def test_make_covariance_rejects_unpaired_centres():
    with pytest.raises(ValueError):
        tdpss.make_covariance(np.arange(16.0), [0.1, 0.2], [0.0], device="cpu")


# -- solves ---------------------------------------------------------------


def _rows(rng, n, nrow, hw, cplx, patterns):
    x = np.stack([_bandlimited(rng, n, hw) + (1j * _bandlimited(rng, n, hw) if cplx else 0) for _ in range(nrow)])
    Ni = rng.uniform(0.5, 2.0, (nrow, n))
    W = np.ones((nrow, n), bool)
    for i in range(nrow):
        p = patterns[i % len(patterns)]
        W[i, p] = False
    Ni[~W] = 0.0
    return x, Ni, W


PATTERNS = [slice(50, 58), slice(0, 0), slice(10, 12), slice(100, 128)]


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solve_filter_inpaint_match_jax(cplx, dtype):
    """float64: against the JAX functions.  float32: the port's error
    against the JAX functions' float64 result no more than twice that of the
    JAX functions' own float32 result."""
    rng = np.random.default_rng(1)
    n, hw = 128, 0.04
    x, Ni, W = _rows(rng, n, 40, hw, cplx, PATTERNS)  # > SHARED_ROWS rows share two patterns
    Ni[3] = 0.0  # a row with no data
    A = jdpss.get_basis(jdpss.make_covariance(np.arange(n), hw * 1.5, 0.0), dtype=np.float64)
    single = dtype == np.float32
    if single:
        x32, N32, A32 = x.astype(np.complex64 if cplx else np.float32), Ni.astype(np.float32), A.astype(np.float32)
        xt, Nt, At = torch.as_tensor(x32), torch.as_tensor(N32), torch.as_tensor(A32)
    else:
        xt, Nt, At = torch.as_tensor(x), torch.as_tensor(Ni), torch.as_tensor(A)
    scale = np.abs(x).max()
    Wt = torch.as_tensor(W)
    for fn, extra in (("solve_batched", ()), ("filter_batched", (W,)), ("inpaint_batched", (W,))):
        jx, jw = getattr(jdpss, fn)(x, Ni, A, *extra)
        tx, tw = getattr(tdpss, fn)(xt, Nt, At, *((Wt,) if extra else ()))
        assert tx.dtype == xt.dtype and tw.dtype == At.dtype
        ex, ew = _rel(tx, np.asarray(jx), scale), _rel(tw, np.asarray(jw))
        if single:
            sx, sw = getattr(jdpss, fn)(x32, N32, A32, *extra)
            assert ex <= max(2 * _rel(sx, np.asarray(jx), scale), TOL64), fn
            assert ew <= max(2 * _rel(sw, np.asarray(jw)), TOL64), fn
        else:
            assert ex <= TOL64 and ew <= TOL64, fn
        if fn == "solve_batched":
            assert bool((tx[3] == 0).all()) and bool((tw[3] == 0).all())


def test_reference_layout_matches_jax():
    rng = np.random.default_rng(2)
    n, hw = 64, 0.05
    x, Ni, W = _rows(rng, n, 6, hw, True, [slice(20, 25), slice(3, 4)])
    A = jdpss.get_basis(jdpss.make_covariance(np.arange(n), hw * 1.5, 0.0), dtype=np.float64)
    xs, Ns, Ws = x.T, Ni.T, W.T  # samples first
    xp = np.asarray(jdpss.project(x, Ni, A)).T
    for fn, args in (("solve", (xp, Ns)), ("filter", (xs, Ns, A, Ws)), ("inpaint", (xs, Ns, A, Ws))):
        if fn == "solve":
            jo = jdpss.solve(xp, Ns, A)
            to = tdpss.solve(torch.as_tensor(xp), torch.as_tensor(Ns), torch.as_tensor(A))
        else:
            jo = getattr(jdpss, fn)(xs, Ns, A, Ws)
            to = getattr(tdpss, fn)(*(torch.as_tensor(a) for a in (xs, Ns, A, Ws)))
        assert _rel(to[0], np.asarray(jo[0]), np.abs(x).max()) <= TOL64, fn
        assert _rel(to[1], np.asarray(jo[1])) <= TOL64, fn
    assert _rel(tdpss.project(torch.as_tensor(x), torch.as_tensor(Ni), torch.as_tensor(A)),
                np.asarray(jdpss.project(x, Ni, A))) <= 1e-12
    with pytest.raises(ValueError, match="modes on axis 0"):
        tdpss.solve(torch.as_tensor(xp.T), torch.as_tensor(Ns), torch.as_tensor(A))


def test_a_failed_factorisation_gives_zero_data_and_weight():
    """``Si = 0`` and a row with two valid samples make ``A^H N A`` singular:
    the JAX package returns NaN there, the port zero data and weight."""
    rng = np.random.default_rng(3)
    n = 32
    A = tdpss.get_basis(tdpss.make_covariance(np.arange(n), 0.2, 0.0, device="cpu"), dtype=np.float64)
    x = torch.as_tensor(rng.standard_normal((3, n)))
    Ni = torch.ones((3, n), dtype=torch.float64)
    Ni[1, 2:] = 0.0
    xf, wf, nfail = tdpss.solve_batched(x, Ni, A, Si=0.0, return_failed=True)
    assert nfail == 1
    assert torch.all(xf[1] == 0) and torch.all(wf[1] == 0)
    assert bool(torch.isfinite(xf).all()) and bool((wf[0] > 0).all())


def test_solve_zero_row_stays_zero():
    n = 32
    A = tdpss.get_basis(tdpss.make_covariance(np.arange(n), 0.1, 0.0, device="cpu"))
    xf, wf = tdpss.solve_batched(torch.ones((2, n)), torch.zeros((2, n)), A)
    assert torch.all(xf == 0) and torch.all(wf == 0)


# -- weights ---------------------------------------------------------------


def test_pchip_rows_matches_scipy():
    rng = np.random.default_rng(5)
    n = 40
    y = rng.standard_normal((12, n)) ** 2
    W = rng.uniform(size=(12, n)) > 0.4
    W[0] = False
    W[0, [3, 30]] = True  # two knots: linear
    W[1] = False
    W[1, [5, 6, 20]] = True  # three knots
    W[2, :8] = False  # extrapolation below
    W[3, -8:] = False  # and above
    W[4] = False
    W[4, 7] = True  # one knot: NaN
    y[5, W[5]] = np.arange(W[5].sum())  # monotone data
    got = _np(tdpss.pchip_rows(torch.as_tensor(y), torch.as_tensor(W)))
    for i in range(12):
        if W[i].sum() < 2:
            assert np.isnan(got[i]).all()
            continue
        ref = PchipInterpolator(np.flatnonzero(W[i]), y[i, W[i]], extrapolate=True)(np.arange(n))
        assert _rel(got[i], ref) <= TOL64, i


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_accumulate_variance_matches_jax(dtype):
    rng = np.random.default_rng(6)
    wo = rng.uniform(1.0, 5.0, (7, 30)).astype(dtype)
    W = rng.uniform(size=(7, 30)) > 0.3
    W[0] = False
    W[0, 4] = True
    wo[~W] = 0.0
    wi = rng.uniform(5.0, 10.0, (7, 30)).astype(dtype)
    ref = jdpss.accumulate_variance(wo, wi, W)
    got = tdpss.accumulate_variance(torch.as_tensor(wo), torch.as_tensor(wi), torch.as_tensor(W))
    assert _np(got).dtype == ref.dtype
    assert _rel(got, ref) <= (TOL64 if dtype == np.float64 else 1e-6)


def test_flag_above_cutoff_matches_jax():
    rng = np.random.default_rng(7)
    W = rng.uniform(size=(20, 50)) > 0.3
    W[0, :5] = False
    W[1, -7:] = False
    W[2] = False
    for fc in (0.5, 2.0, 4.0, 100.0):
        assert np.array_equal(_np(tdpss.flag_above_cutoff(torch.as_tensor(W), fc)), jdpss.flag_above_cutoff(W, fc))
    assert tdpss.flag_above_cutoff(W, None) is W


# -- tasks ---------------------------------------------------------------


def _gap_streams(seed=0, nfreq=64, nstack=3, nra=4, hw=0.08, patterns=("gap",)):
    rng = np.random.default_rng(seed)
    freq = np.linspace(400.0, 464.0, nfreq, endpoint=False)
    vis = np.zeros((nfreq, nstack, nra), dtype=np.complex64)
    for i in range(nstack):
        for j in range(nra):
            vis[:, i, j] = _bandlimited(rng, nfreq, hw) + 1j * _bandlimited(rng, nfreq, hw)
    w = rng.uniform(0.5, 2.0, vis.shape).astype(np.float32)
    if "gap" in patterns:
        w[20:24] = 0.0
    if "cells" in patterns:
        w[30:33, 0, 1] = 0.0
        w[5, 2, :2] = 0.0
        w[:, 1, 3] = 0.0  # a dead row
        w[:3, 2, 2] = 0.0  # an edge gap
    prod = np.zeros(nstack, dtype=[("input_a", int), ("input_b", int)])
    prod["input_a"], prod["input_b"] = [0, 0, 1, 0][:nstack], [1, 2, 2, 3][:nstack]
    kw = dict(freq=freq, stack=nstack, input=4, prod=prod, ra=nra)
    js, ts = jcontainers.SiderealStream(**kw), containers.SiderealStream(**kw, device="cpu")
    js.vis[:], js.weight[:] = vis, w
    ts.vis[:], ts.weight[:] = vis, w
    return js, ts, vis


def _same(jo, to, scale):
    assert _rel(to.vis[:], np.asarray(jo.vis[:]), scale) <= TOL_TASK
    wj, wt = np.asarray(jo.weight[:]), _np(to.weight[:])
    assert np.array_equal(wj == 0, wt == 0)
    assert _rel(wt, wj) <= TOL_TASK


@pytest.mark.parametrize("patterns", [("gap",), ("gap", "cells")])
@pytest.mark.parametrize("params", [{}, {"inpaint": False}, {"cutoff_frac": 0.2}, {"copy": False}])
def test_dpss_filter_matches_jax(patterns, params):
    js, ts, vis = _gap_streams(patterns=patterns)
    params = {"axis": "freq", "centres": [0.0], "halfwidths": [0.12], **params}
    jo = _run(jinterp.DPSSFilter(), params, js)
    to = _run(tinterp.DPSSFilter(), params, ts)
    assert (to is ts) == (params.get("copy") is False)
    _same(jo, to, np.abs(vis).max())


def test_dpss_filter_over_ra_matches_jax():
    js, ts, vis = _gap_streams(nra=48, nfreq=4, patterns=())
    for s in (js, ts):
        w = np.asarray(s.weight[:]).copy()
        w[:, :, 20:23] = 0.0
        w[1, 0, 5] = 0.0
        s.weight[:] = w
    params = {"axis": "ra", "centres": [0.0], "halfwidths": [0.02], "iter_axes": ["freq"]}
    jo = _run(jinterp.DPSSFilter(), params, js)
    to = _run(tinterp.DPSSFilter(), params, ts)
    _same(jo, to, np.abs(vis).max())


def test_dpss_filter_with_a_mask_container_matches_jax():
    js, ts, vis = _gap_streams(patterns=("gap", "cells"))
    marr = np.zeros((64, 4), bool)
    marr[40:42] = True
    masks = []
    for mod, s, extra in ((jcontainers, js, {}), (containers, ts, {"device": "cpu"})):
        m = mod.SiderealRFIMask(axes_from=s, **extra)
        m.mask[:] = marr
        masks.append(m)
    params = {"axis": "freq", "centres": [0.0], "halfwidths": [0.12]}
    jo = _run(jinterp.DPSSFilter(), params, js, setup=(masks[0],))
    to = _run(tinterp.DPSSFilter(), params, ts, setup=(masks[1],))
    _same(jo, to, np.abs(vis).max())
    live = _np(to.weight[:]).any(axis=0)  # rows with data
    err = np.abs(_np(to.vis[:])[40:42] - vis[40:42])[:, live]
    assert err.max() < 0.15 * np.abs(vis).max()


@pytest.fixture(scope="module")
def dishes():
    kw = dict(grid_ew=2, grid_ns=2, spacing_ew=60.0, spacing_ns=30.0, latitude=45.0,
              freq_lower=400.0, freq_upper=464.0, num_freq=4)
    return JDish(**kw), UnpolarisedDishArray(**kw)


@pytest.mark.parametrize("orientation", ["NS", "EW", "none"])
def test_dpss_filter_delay_matches_jax(dishes, orientation):
    js, ts, vis = _gap_streams(patterns=("gap", "cells"))
    params = {"centres": [0.0], "halfwidths": [0.08], "telescope_orientation": orientation}
    jo = _run(jinterp.DPSSFilterDelay(), params, js, setup=(dishes[0],))
    to = _run(tinterp.DPSSFilterDelay(), params, ts, setup=(dishes[1],))
    _same(jo, to, np.abs(vis).max())


def _stokes_streams(js, ts):
    """Both streams relabelled as a StokesIVis output: the stack map holds baseline vectors."""
    bl = np.array([[0.0, 30.0], [60.0, 0.0], [60.0, 30.0]])
    out = []
    for mod, s, extra in ((jcontainers, js, {}), (containers, ts, {"device": "cpu"})):
        o = mod.SiderealStream(freq=np.asarray(s.freq), stack=bl, ra=np.asarray(s.ra), input=4, prod=3, **extra)
        o.vis[:], o.weight[:] = np.asarray(s.vis[:]), np.asarray(s.weight[:])
        out.append(o)
    return out


def test_dpss_filter_delay_stokes_i_matches_jax(dishes):
    js, ts, vis = _gap_streams(patterns=("gap", "cells"))
    js, ts = _stokes_streams(js, ts)
    params = {"centres": [0.0], "halfwidths": [0.08], "telescope_orientation": "none"}
    jo = _run(jinterp.DPSSFilterDelayStokesI(), params, js, setup=(dishes[0],))
    to = _run(tinterp.DPSSFilterDelayStokesI(), params, ts, setup=(dishes[1],))
    _same(jo, to, np.abs(vis).max())
    pm = _gap_streams()[1]
    stack = np.zeros(3, dtype=[("prod", int), ("conjugate", bool)])
    stack["prod"] = np.arange(3)
    pm.create_index_map("stack", stack)
    with pytest.raises(TypeError, match="baseline VECTORS"):
        _run(tinterp.DPSSFilterDelayStokesI(), params, pm, setup=(dishes[1],))


@pytest.fixture(scope="module")
def cylinders():
    kw = dict(num_cylinders=2, num_feeds=2, cylinder_spacing=20.0, feed_spacing=6.0, latitude=45.0,
              freq_lower=400.0, freq_upper=420.0, num_freq=2)
    return JUCyl(**kw), UnpolarisedCylinderTelescope(**kw)


@pytest.mark.parametrize("stokes", [False, True])
def test_dpss_filter_mmode_matches_jax(cylinders, stokes):
    jtel, ttel = cylinders
    rng = np.random.default_rng(8)
    nra, nstack = 96, jtel.nbase
    up = np.asarray(jtel.uniquepairs)
    prod = np.zeros(nstack, dtype=[("input_a", int), ("input_b", int)])
    prod["input_a"], prod["input_b"] = up[:, 0], up[:, 1]
    ra = np.linspace(0, 360, nra, endpoint=False)
    vis = np.stack([np.stack([_bandlimited(rng, nra, 0.02) + 1j * _bandlimited(rng, nra, 0.02)
                              for _ in range(nstack)]) for _ in range(2)]).astype(np.complex64)
    w = np.ones(vis.shape, np.float32)
    w[:, :, 40:44] = 0.0
    w[1, 0, 70] = 0.0
    outs = []
    for mod, extra in ((jcontainers, {}), (containers, {"device": "cpu"})):
        if stokes:
            s = mod.SiderealStream(freq=jtel.frequencies, stack=np.asarray(jtel.baselines), ra=ra, input=jtel.nfeed,
                                   prod=nstack, **extra)
        else:
            s = mod.SiderealStream(freq=jtel.frequencies, stack=nstack, input=jtel.nfeed, prod=prod, ra=ra, **extra)
        s.vis[:], s.weight[:] = vis, w
        outs.append(s)
    cls = "DPSSFilterMModeStokesI" if stokes else "DPSSFilterMMode"
    params = {"centres": [0.0], "halfwidths": [0.01], "telescope_orientation": "NS"}
    jo = _run(getattr(jinterp, cls)(), params, outs[0], setup=(jtel,))
    to = _run(getattr(tinterp, cls)(), params, outs[1], setup=(ttel,))
    _same(jo, to, np.abs(vis).max())
