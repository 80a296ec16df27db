"""The DAYENU filters and tasks: draco_tpu_torch against draco_tpu on the same inputs.

Small sizes (32-64 channels, 3-6 baselines, 6-16 samples), numpy inputs
from a seed; the JAX package on the CPU with 64-bit types, the port on the
CPU.  Tolerances, max|diff| / max|ref| unless stated:

- the filter constructors at epsilon 1e-3, float64: 1e-10;
- deliberate difference: the pseudo-inverse drops eigenvalues below
  ``numpy.linalg.pinv``'s 1e-15 of the largest, where the JAX package drops
  those below max|w| n eps_f64, which at 1024 channels and epsilon 1e-12
  removes the pass band (held at 1024 channels against numpy's pinv);
- the filter constructors at the default epsilon 1e-12: 1e-2.  The reason: the
  covariance ``I + S / eps`` has condition ~1e12, so rounding it once to
  float64 perturbs its pseudo-inverse by ~1e12 x 2.2e-16 of its norm in the
  transition band, and two LAPACKs (numpy's and torch's) differ there:
  1.4e-3 to 8.2e-3 on random data over 64-256 channels.  Both filters are
  also held to the stop-band rejection and pass band of ``tests/test_dayenu.py``;
- ``hermitian_pinv_batched`` on a covariance of condition 1e12 with
  log-spaced eigenvalues and two exact zeros: within 1e-4 of the exact
  pseudo-inverse (the backward error 2.2e-16 x 1e12 over the O(1) gap of
  the smallest kept eigenvalues), the zeros dropped;
- every task on complex64 data at epsilon 1e-6: 1e-5 of the input's peak
  (float32 data, the filter cast to complex64 for the product); the
  propagated weights 1e-5 relative, their zeros exact; the saved float64
  filters 1e-8 and the filtered covariances 1e-7 (at epsilon 1e-6 the two
  LAPACKs' pseudo-inverses differ by ~1e-8, and the covariance takes the
  filter twice); the covariance of a filter shared by both packages 1e-12;
- the ring-map filter (float64 maps) at epsilon 1e-3: 1e-10;
- the tasks at the default epsilon: the JAX tests' own assertions, for both
  packages.

The grouping of rows by (cut, mask) is exercised with several flag
patterns: a dead channel, channels flagged at some times only, a dead
sample, a dead baseline.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from draco_tpu.analysis import dayenu as jdayenu
from draco_tpu.core import containers as jcontainers
from draco_tpu.ops import dayenu as jops
from draco_tpu.telescope import UnpolarisedCylinderTelescope as JUCyl
from draco_tpu.telescope import UnpolarisedDishArray as JDish
from draco_tpu_torch.analysis import dayenu as tdayenu
from draco_tpu_torch.core import containers
from draco_tpu_torch.device import default_device
from draco_tpu_torch.ops import dayenu as tops
from draco_tpu_torch.telescope import UnpolarisedCylinderTelescope, UnpolarisedDishArray

TOL64 = 1e-10
TOL32 = 1e-5
TOL_EPS12 = 1e-2
TOL_COV = 1e-7
EPS_TASK = 1e-6
EPS64 = 1e-3

NFREQ = 64
FREQ = np.linspace(400.0, 464.0, NFREQ, endpoint=False)


@pytest.fixture(autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch and the BLAS pools: these sizes gain nothing
    from threads, and beside five other test workers the pools spin."""
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


def _tone(tau_us, freq=FREQ):
    return np.exp(2.0j * np.pi * tau_us * freq)


def _flags(nfreq, ntime):
    """Flag patterns over [nfreq, ntime]: all valid, a dead channel, a channel flagged at some times only."""
    f0 = np.ones((nfreq, ntime), bool)
    f1 = f0.copy()
    f1[10] = False
    f2 = f1.copy()
    f2[20:23, 1:3] = False
    return [f0, f1, f2]


# -- filter constructors -----------------------------------------------------------


@pytest.mark.parametrize("eps,tol", [(1e-3, TOL64), (1e-12, TOL_EPS12)])
@pytest.mark.parametrize("tw,tc", [(0.1, 0.0), ([0.1, 0.03], [0.0, 0.25]), (0.05, 0.2)])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_delay_filter_matches_jax(eps, tol, tw, tc, which):
    flag = _flags(NFREQ, 4)[which]
    NFj, ij = jops.delay_filter(FREQ, flag, tw, tc, eps)
    NFt, it = tops.delay_filter(FREQ, flag, tw, tc, eps, device="cpu")
    assert NFt.dtype == (torch.complex128 if np.any(np.abs(tc) > 0) else torch.float64)
    assert [list(i) for i in it] == [list(i) for i in ij]
    x = np.random.default_rng(0).standard_normal((NFREQ, 8)) * (1 + 0j)
    for k in range(NFj.shape[0]):
        assert _rel(NFt[k].numpy() @ x, NFj[k] @ x) <= tol
        masked = ~flag[:, ij[k][0]]
        assert np.all(NFt[k].numpy()[masked] == 0) and np.all(NFt[k].numpy()[:, masked] == 0)


def test_highpass_delay_filter_rejects_low_delay_as_jax_does():
    NF, index = tops.highpass_delay_filter(FREQ, 0.1, np.ones((NFREQ, 1), bool), epsilon=1e-12, device="cpu")
    NF = NF[0].numpy()
    assert np.abs(NF @ _tone(0.02)).max() < 1e-4
    assert np.abs(NF @ _tone(0.35)).max() > 0.8
    # a complex stop band at +0.2 us rejects exp(-2 pi i 0.2 f) only
    NFc = tops.delay_filter(FREQ, np.ones((NFREQ, 1), bool), 0.05, 0.2, 1e-12, device="cpu")[0][0].numpy()
    assert np.abs(NFc @ _tone(-0.2)).max() < 1e-4 and np.abs(NFc @ _tone(0.2)).max() > 0.8


def test_the_pass_band_survives_the_factorisation():
    """The float64 factorisation keeps the O(1) pass-band eigenvalues that a
    float32 cutoff would drop (``tests/test_dayenu.py``'s x64-off case), and
    a float32 input is factorised in float64."""
    NF, _ = tops.delay_filter(FREQ, np.ones((NFREQ, 1), bool), 0.05, 0.0, 1e-12, device="cpu")
    assert NF.dtype == torch.float64
    assert float(torch.diagonal(NF[0]).abs().mean()) > 0.5
    assert tops.hermitian_pinv_batched(torch.eye(4, dtype=torch.float32)[None]).dtype == torch.float64


def test_the_pass_band_survives_at_1024_channels_where_the_jax_cutoff_drops_it():
    """Deliberate difference: at CHIME's 1024 channels and epsilon 1e-12 the
    JAX package's cutoff (max|w| n eps_f64, ~1.5 here) drops the pass band's
    eigenvalues of 1, and its filter returns almost nothing; the port drops
    eigenvalues below ``numpy.linalg.pinv``'s 1e-15 max|w| and passes a
    high-delay tone, as numpy's pinv does."""
    freq = np.linspace(400.0, 800.0, 1024, endpoint=False)
    flag = np.ones((1024, 1), bool)
    tone = np.exp(2j * np.pi * 0.6 * freq)
    NFj = jops.delay_filter(freq, flag, 0.2, 0.0, 1e-12)[0][0]
    NFt = tops.delay_filter(freq, flag, 0.2, 0.0, 1e-12, device="cpu")[0][0].numpy()
    NFn = np.linalg.pinv(tops.delay_covariance(freq, 0.2, 0.0, 1e-12), hermitian=True)
    assert np.abs(NFj @ tone).max() < 0.1
    assert np.abs(NFt @ tone).max() > 0.8
    assert _rel(NFt @ tone, NFn @ tone) <= TOL_EPS12


def test_hermitian_pinv_batched_on_a_1e12_condition_covariance():
    rng = np.random.default_rng(4)
    n = 24
    out = []
    for cplx in (False, True):
        a = rng.standard_normal((n, n)) + (1j * rng.standard_normal((n, n)) if cplx else 0)
        V = np.linalg.qr(a)[0]
        w = np.concatenate([np.logspace(12, 0, n - 2), [0.0, 0.0]])
        C = (V * w) @ V.conj().T
        C = 0.5 * (C + C.conj().T)
        expect = (V[:, :-2] / w[:-2]) @ V[:, :-2].conj().T
        P = tops.hermitian_pinv_batched(C[None], device="cpu")[0].numpy()
        Pj = np.asarray(jops.hermitian_pinv_batched(C[None]))[0]
        assert _rel(P, expect) <= 1e-4 and _rel(Pj, expect) <= 1e-4
        # the two exact zeros are dropped, not inverted
        assert np.abs(V[:, -2:].conj().T @ P @ V[:, -2:]).max() < 1e-6
        out.append(_rel(P, Pj))
    assert max(out) <= 1e-4


@pytest.mark.parametrize("eps,tol", [(1e-3, TOL64), (1e-10, TOL_EPS12)])
def test_mmode_filters_match_jax(eps, tol):
    nra = 64
    ra = np.linspace(0, 2 * np.pi, nra, endpoint=False)
    flag = np.ones((2, nra), bool)
    flag[1, 5:9] = False
    x = np.exp(1j * np.outer(ra, [3.0, 12.0, 20.0, 25.0]))
    for name, args in (("bandpass_mmode_filter", (20.0, 5.0)), ("lowpass_mmode_filter", (10.0,)),
                       ("highpass_mmode_filter", (10.0,))):
        Fj, ij = getattr(jops, name)(ra, *args, flag, epsilon=eps)
        Ft, it = getattr(tops, name)(ra, *args, flag, epsilon=eps, device="cpu")
        assert len(it) == len(ij) and all(np.array_equal(a[0], b[0]) for a, b in zip(it, ij))
        for k in range(Fj.shape[0]):
            assert _rel(Ft[k].numpy() @ x, Fj[k] @ x) <= tol, name


def test_mmode_filters_pass_and_reject_as_jax_does():
    nra = 128
    ra = np.linspace(0, 2 * np.pi, nra, endpoint=False)
    flag = np.ones((1, nra), bool)
    lo, hi, mid = (np.exp(1j * m * ra) for m in (3.0, 30.0, 20.0))
    HP = tops.highpass_mmode_filter(ra, 10.0, flag, device="cpu")[0][0].numpy()
    LP = tops.lowpass_mmode_filter(ra, 10.0, flag, device="cpu")[0][0].numpy()
    BP = tops.bandpass_mmode_filter(ra, 20.0, 5.0, flag, device="cpu")[0][0].numpy()
    assert np.abs(HP @ lo).max() < 1e-4 and np.abs(HP @ hi).max() > 0.5
    assert np.abs(LP @ hi).max() < 1e-3 and np.abs(LP @ lo).max() > 0.5
    assert np.abs(BP @ mid).max() > 0.5 and np.abs(BP @ lo).max() < 1e-3


def test_instantaneous_m_matches_jax():
    args = (np.linspace(-0.3, 0.3, 5), np.radians(45), np.radians(30), np.array([10.0, -3, 0, 4, 7]), 2.0, 0.5)
    assert np.array_equal(tops.instantaneous_m(*args), jops.instantaneous_m(*args))


def test_apply_filter_freq_matches_jax():
    rng = np.random.default_rng(1)
    NF = tops.delay_filter(FREQ, _flags(NFREQ, 1)[1], 0.1, epsilon=1e-6, device="cpu")[0][0]
    vis = (rng.standard_normal((NFREQ, 3, 5)) + 1j * rng.standard_normal((NFREQ, 3, 5))).astype(np.complex64)
    var = rng.uniform(0.5, 2.0, (NFREQ, 3, 5)).astype(np.float32)
    fj, wj = jops.apply_filter_freq(NF.numpy(), vis, var)
    ft, wt = tops.apply_filter_freq(NF, torch.as_tensor(vis), torch.as_tensor(var))
    assert ft.dtype == torch.complex64 and wt.dtype == torch.float32
    assert _rel(ft, fj) <= TOL32 and _rel(wt, wj) <= TOL32


# -- tasks on sidereal streams ---------------------------------------------------------------


@pytest.fixture(scope="module")
def dishes():
    kw = dict(grid_ew=2, grid_ns=2, spacing_ew=6.0, spacing_ns=6.0, latitude=45.0,
              freq_lower=400.0, freq_upper=464.0, num_freq=4)
    return JDish(**kw), UnpolarisedDishArray(**kw)


def _streams(pattern, nra=8, nstack=3, seed=0):
    """The JAX tests' foreground scene (a low-delay tone per product) plus a
    high-delay tone and noise, in a stream of each package, with a flag
    pattern: 'none', 'channel' (one dead channel), 'times' (channels dead
    at some times only, different per product), 'baseline' (one dead
    product) or 'sample' (one dead RA sample everywhere)."""
    rng = np.random.default_rng(seed)
    prod = np.zeros(nstack, dtype=[("input_a", int), ("input_b", int)])
    prod["input_a"], prod["input_b"] = [0, 0, 1, 0, 1, 2][:nstack], [1, 2, 2, 3, 3, 3][:nstack]
    vis = 10.0 * _tone(0.01)[:, None, None] * np.ones((NFREQ, nstack, nra))
    vis = vis + _tone(0.3)[:, None, None] * rng.standard_normal((1, nstack, nra))
    vis = (vis + 0.1 * (rng.standard_normal(vis.shape) + 1j * rng.standard_normal(vis.shape))).astype(np.complex64)
    w = rng.uniform(0.5, 2.0, vis.shape).astype(np.float32)
    if pattern == "channel":
        w[5] = 0.0
    elif pattern == "times":
        w[5, 0, 1:4] = 0.0
        w[30:32, 1, 2] = 0.0
        w[5, 2, 1:4] = 0.0
    elif pattern == "baseline":
        w[:, 1] = 0.0
    elif pattern == "sample":
        w[:, :, 3] = 0.0
        w[40, 0, :5] = 0.0
    kw = dict(freq=FREQ, stack=nstack, input=4, prod=prod, ra=nra)
    js, ts = jcontainers.SiderealStream(**kw), containers.SiderealStream(**kw, device="cpu")
    js.vis[:], js.weight[:] = vis, w
    ts.vis[:], ts.weight[:] = vis, w
    return js, ts, vis


def _same_stream(jo, to, scale, dsets=("vis", "weight")):
    if "vis" in dsets:
        assert _rel(to.vis[:], np.asarray(jo.vis[:]), scale) <= TOL32
    if "weight" in dsets:
        wj, wt = np.asarray(jo.weight[:]), _np(to.weight[:])
        assert np.array_equal(wj == 0, wt == 0)
        assert _rel(wt, wj) <= TOL32


PATTERNS = ["none", "channel", "times", "baseline", "sample"]


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("single_mask", [True, False])
def test_dayenu_delay_filter_matches_jax(dishes, pattern, single_mask):
    js, ts, vis = _streams(pattern)
    params = {"tauw": 0.1, "za_cut": 1.0, "epsilon": EPS_TASK, "single_mask": single_mask,
              "atten_threshold": 0.5 if pattern == "times" else 0.0}
    jo = _run(jdayenu.DayenuDelayFilter(), params, js, setup=(dishes[0],))
    to = _run(tdayenu.DayenuDelayFilter(), params, ts, setup=(dishes[1],))
    assert to is ts
    _same_stream(jo, to, np.abs(vis).max())


@pytest.mark.parametrize("single_mask", [True, False])
def test_dayenu_delay_filter_at_the_default_epsilon_rejects_the_foreground(dishes, single_mask):
    js, ts, vis = _streams("channel")
    base = np.broadcast_to(10.0 * _tone(0.01)[:, None, None], vis.shape).astype(np.complex64)
    js.vis[:], ts.vis[:] = base, base
    params = {"tauw": 0.1, "za_cut": 0.0, "single_mask": single_mask}
    jo = _run(jdayenu.DayenuDelayFilter(), params, js, setup=(dishes[0],))
    to = _run(tdayenu.DayenuDelayFilter(), params, ts, setup=(dishes[1],))
    for out in (np.asarray(jo.vis[:]), _np(to.vis[:])):
        assert np.abs(out).max() < 1e-4 * 10.0
    assert np.all(_np(to.weight[:])[5] == 0) and np.abs(_np(to.vis[:])[5]).max() == 0
    assert _rel(to.weight[:], np.asarray(jo.weight[:])) <= TOL_EPS12


def test_dayenu_delay_filter_zeroes_a_baseline_whose_factorisation_fails(dishes, monkeypatch):
    """Rows of a group whose eigh fails take zero weight and keep their data
    (the JAX loop's LinAlgError branch); the other baselines are unchanged."""
    _, ref, vis = _streams("times")
    _run(tdayenu.DayenuDelayFilter(), {"tauw": 0.1, "epsilon": EPS_TASK, "single_mask": False}, ref,
         setup=(dishes[1],))
    _, ts, _ = _streams("times")
    real = tops.hermitian_pinv_batched
    bad_mask = torch.ones(NFREQ, dtype=torch.bool)
    bad_mask[5] = False  # baseline 0's masked times (channel 5)

    def failing(cov, *a, **k):
        diag = torch.diagonal(cov, dim1=-2, dim2=-1)
        if bool(((diag != 0) == bad_mask).all(dim=-1).any()):
            raise torch.linalg.LinAlgError("forced")
        return real(cov, *a, **k)

    monkeypatch.setattr(tops, "hermitian_pinv_batched", failing)
    _run(tdayenu.DayenuDelayFilter(), {"tauw": 0.1, "epsilon": EPS_TASK, "single_mask": False}, ts,
         setup=(dishes[1],))
    # baselines 0 and 2 have the failing mask at times 1-3
    w = _np(ts.weight[:])
    assert np.all(w[:, [0, 2]] == 0)
    assert np.array_equal(_np(ts.vis[:])[:, [0, 2]], vis[:, [0, 2]])
    assert np.array_equal(w[:, 1], _np(ref.weight[:])[:, 1])
    assert np.array_equal(_np(ts.vis[:])[:, 1], _np(ref.vis[:])[:, 1])


@pytest.mark.parametrize("pattern", ["none", "times", "sample"])
@pytest.mark.parametrize("single_mask", [True, False])
@pytest.mark.parametrize("reduce", [False, True])
def test_fixed_cutoff_matches_jax(pattern, single_mask, reduce):
    js, ts, vis = _streams(pattern, nstack=4)
    params = {"tauw": 0.1, "epsilon": EPS_TASK, "single_mask": single_mask, "reduce_baseline": reduce}
    jo = _run(jdayenu.DayenuDelayFilterFixedCutoff(), params, js)
    to = _run(tdayenu.DayenuDelayFilterFixedCutoff(), params, ts)
    assert (to is ts) == (not reduce)
    if reduce:
        assert to.vis.shape == tuple(jo.vis.shape) == (NFREQ, 1, 8)
        assert np.array_equal(_np(to.weight[:]), np.asarray(jo.weight[:]))
        assert _rel(to.vis[:], np.asarray(jo.vis[:])) <= 1e-4  # chi^2 of a float32 filtered residual
    else:
        _same_stream(jo, to, np.abs(vis).max())


def test_fixed_cutoff_masks_short_baselines_as_jax_does(dishes):
    # both packages read the telescope's baselines, so the stream has one stack each
    js, ts, vis = _streams("channel", nstack=len(dishes[0].baselines))
    params = {"tauw": 0.1, "epsilon": EPS_TASK, "mask_short": 7.0}
    jo = _run(jdayenu.DayenuDelayFilterFixedCutoff(), params, js, setup=(dishes[0],))
    to = _run(tdayenu.DayenuDelayFilterFixedCutoff(), params, ts, setup=(dishes[1],))
    _same_stream(jo, to, np.abs(vis).max())


def test_fixed_cutoff_reduce_at_the_default_epsilon_as_jax_does():
    js, ts, _ = _streams("none", nstack=3)
    rng = np.random.default_rng(7)
    base = np.broadcast_to(10.0 * _tone(0.01)[:, None, None], (NFREQ, 3, 8))
    data = (base + (rng.standard_normal(base.shape) + 1j * rng.standard_normal(base.shape)) / np.sqrt(2))
    for c in (js, ts):
        c.vis[:] = data.astype(np.complex64)
        c.weight[:] = np.ones(data.shape, np.float32)
    params = {"tauw": 0.1, "reduce_baseline": True}
    for task, s in ((jdayenu.DayenuDelayFilterFixedCutoff(), js), (tdayenu.DayenuDelayFilterFixedCutoff(), ts)):
        out = _run(task, params, s)
        chi2, valid = _np(out.vis[:]).real, _np(out.weight[:]) > 0
        assert np.median(chi2[valid]) < 10.0


# -- hybrid visibilities ---------------------------------------------------------------


def _hybrid(pattern, seed=2, nel=3, nra=6, new=2, npol=2, nfreq=32):
    rng = np.random.default_rng(seed)
    freq = FREQ[:nfreq]
    shape = (npol, nfreq, new, nel, nra)
    vis = 10.0 * _tone(0.02, freq)[None, :, None, None, None] * rng.standard_normal(shape[:1] + (1,) + shape[2:])
    vis = (vis + (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)
    w = rng.uniform(0.5, 2.0, (npol, nfreq, new, nra)).astype(np.float32)
    if pattern == "cells":
        w[:, 4, 0, 1:3] = 0.0
        w[1, 9, 1, 2] = 0.0  # one pol only: the column's mask loses channel 9
        w[:, :, 1, 5] = 0.0  # a dead column
    kw = dict(freq=freq, pol=np.array(["XX", "YY"][:npol]), ew=np.arange(new) * 20.0,
              el=np.linspace(-0.2, 0.2, nel), ra=nra)
    out = []
    for mod, extra in ((jcontainers, {}), (containers, {"device": "cpu"})):
        hv = mod.HybridVisStream(**kw, **extra)
        hv.vis[:], hv.weight[:] = vis, w
        out.append(hv)
    return out[0], out[1], vis, w


@pytest.mark.parametrize("pattern", ["none", "cells"])
@pytest.mark.parametrize("params", [
    {"save_filter": True, "calculate_cov": True},
    {"tauw": [0.1, 0.05], "tauc": [0.0, 0.3], "save_filter": True, "calculate_cov": True},
    {"save_filter": True, "apply_filter": False},
    {"atten_threshold": 0.5},
])
def test_hybrid_filter_matches_jax(pattern, params):
    jh, th, vis, _ = _hybrid(pattern)
    params = {"tauw": 0.1, "epsilon": EPS_TASK, **params}
    jo = _run(jdayenu.DayenuDelayFilterHybridVis(), params, jh)
    to = _run(tdayenu.DayenuDelayFilterHybridVis(), params, th)
    _same_stream(jo, to, np.abs(vis).max())
    if params.get("save_filter"):
        assert to.filter.dtype == (torch.complex128 if "tauc" in params else torch.float64)
        fj, ft = np.asarray(jo.filter[:]), _np(to.filter[:])
        assert np.array_equal(fj == 0, ft == 0) and _rel(ft, fj) <= 1e-8
    if params.get("calculate_cov"):
        assert _rel(to.freq_cov[:], np.asarray(jo.freq_cov[:])) <= TOL_COV


def _saved_filter(pattern):
    """A filter container from the port's hybrid filter, its twin for the JAX package."""
    jh, th, _, _ = _hybrid(pattern, seed=5)
    params = {"tauw": 0.1, "epsilon": EPS_TASK, "save_filter": True, "calculate_cov": True}
    _run(tdayenu.DayenuDelayFilterHybridVis(), params, th)
    jh.add_dataset("filter")
    jh.filter[:] = _np(th.filter[:])
    jh.add_dataset("freq_cov")
    jh.freq_cov[:] = _np(th.freq_cov[:])
    jh.weight[:] = _np(th.weight[:])
    return jh, th


@pytest.mark.parametrize("pattern", ["none", "cells"])
@pytest.mark.parametrize("params", [{"calculate_cov": True}, {"copy_weight": True, "calculate_cov": True},
                                    {"atten_threshold": 0.5, "copy_tag": True}])
def test_apply_delay_filter_matches_jax(pattern, params):
    jsrc, tsrc = _saved_filter(pattern)
    jsrc.attrs["tag"] = tsrc.attrs["tag"] = "fg"
    jh, th, vis, w = _hybrid("cells" if pattern == "none" else "none", seed=9)
    # a channel the filter assumes valid goes missing in one column
    for h in (jh, th):
        ww = _np(h.weight[:]).copy()
        ww[0, 7, 0, 4] = 0.0
        h.weight[:] = ww
    jo = _run(jdayenu.ApplyDelayFilterHybridVis(), params, jh, jsrc)
    to = _run(tdayenu.ApplyDelayFilterHybridVis(), params, th, tsrc)
    _same_stream(jo, to, np.abs(vis).max())
    if params.get("calculate_cov"):
        assert _rel(to.freq_cov[:], np.asarray(jo.freq_cov[:])) <= 1e-12
    if params.get("copy_tag"):
        assert to.attrs["tag"] == "fg"


def test_apply_delay_filter_single_source_matches_the_two_input_task():
    jsrc, tsrc = _saved_filter("cells")
    _, a, _, _ = _hybrid("none", seed=11)
    _, b, _, _ = _hybrid("none", seed=11)
    task = tdayenu.ApplyDelayFilterHybridVisSingleSource()
    task.read_config({})
    task.setup(tsrc)
    out = task.process(a)
    ref = _run(tdayenu.ApplyDelayFilterHybridVis(), {}, b, tsrc)
    assert torch.equal(out.vis[:], ref.vis[:]) and torch.equal(out.weight[:], ref.weight[:])


def test_apply_delay_filter_rejects_mismatched_axes():
    _, tsrc = _saved_filter("none")
    _, th, _, _ = _hybrid("none", nra=5)
    with pytest.raises(ValueError, match="ra axes do not match"):
        _run(tdayenu.ApplyDelayFilterHybridVis(), {}, th, tsrc)


# -- ring maps ---------------------------------------------------------------


def _ringmaps(pattern, nra=5, nel=3, seed=3):
    rng = np.random.default_rng(seed)
    shape = (2, 2, NFREQ, nra, nel)
    m = 5.0 * np.cos(2 * np.pi * 0.01 * FREQ)[None, None, :, None, None] + rng.standard_normal(shape)
    w = rng.uniform(0.5, 2.0, shape[1:])
    if pattern == "cells":
        w[0, 7, :, 1] = 0.0
        w[1, 12, 2:4, 0] = 0.0
        w[1, :, :, 2] = 0.0
    kw = dict(freq=FREQ, beam=np.arange(2), pol=np.array(["XX", "YY"]), ra=nra, el=np.linspace(-0.1, 0.1, nel))
    out = []
    for mod, extra in ((jcontainers, {}), (containers, {"device": "cpu"})):
        rm = mod.RingMap(**kw, **extra)
        rm.map[:] = m
        rm.datasets["weight"][:] = w
        out.append(rm)
    return out[0], out[1], m


@pytest.mark.parametrize("pattern", ["none", "cells"])
@pytest.mark.parametrize("single_mask", [True, False])
def test_map_filter_matches_jax(pattern, single_mask):
    jr, tr, m = _ringmaps(pattern)
    params = {"tauw": 0.1, "epsilon": EPS64, "single_mask": single_mask}
    jo = _run(jdayenu.DayenuDelayFilterMap(), params, jr)
    to = _run(tdayenu.DayenuDelayFilterMap(), params, tr)
    assert _rel(to.map[:], np.asarray(jo.map[:]), np.abs(m).max()) <= TOL64
    wj, wt = np.asarray(jo.weight[:]), _np(to.weight[:])
    assert np.array_equal(wj == 0, wt == 0) and _rel(wt, wj) <= TOL64


def test_map_filter_with_a_cutoff_file_matches_jax(tmp_path):
    jr, tr, m = _ringmaps("none")
    cut = containers.DelayCutoff(pol=np.array(["XX", "YY"]), el=np.linspace(-0.2, 0.2, 5), device="cpu")
    cut.cutoff[:] = np.array([[0.05, 0.08, 0.1, 0.12, 0.15], [0.1, 0.1, 0.2, 0.1, 0.1]])
    path = str(tmp_path / "cut.h5")
    cut.save(path)
    params = {"tauw": 0.1, "epsilon": EPS64, "filename": path}
    jo = _run(jdayenu.DayenuDelayFilterMap(), params, jr)
    to = _run(tdayenu.DayenuDelayFilterMap(), params, tr)
    assert _rel(to.map[:], np.asarray(jo.map[:]), np.abs(m).max()) <= TOL64


def test_map_filter_at_the_default_epsilon_rejects_the_foreground():
    _, tr, _ = _ringmaps("none")
    tr.map[:] = 5.0 * np.cos(2 * np.pi * 0.01 * FREQ)[None, None, :, None, None] * np.ones(tr.map.shape)
    out = _run(tdayenu.DayenuDelayFilterMap(), {"tauw": 0.1}, tr)
    assert float(out.map[:].abs().max()) < 1e-3 * 5.0


# -- m-mode filter ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cylinders():
    kw = dict(num_cylinders=3, num_feeds=2, cylinder_spacing=20.0, feed_spacing=6.0, latitude=45.0,
              freq_lower=400.0, freq_upper=420.0, num_freq=3)
    return JUCyl(**kw), UnpolarisedCylinderTelescope(**kw)


@pytest.mark.parametrize("flagged", [False, True])
def test_m_filter_matches_jax(cylinders, flagged):
    jtel, ttel = cylinders
    nra, nstack = 64, jtel.nbase
    rng = np.random.default_rng(6)
    ra_deg = np.linspace(0, 360, nra, endpoint=False)
    up = np.asarray(jtel.uniquepairs)
    prod = np.zeros(nstack, dtype=[("input_a", int), ("input_b", int)])
    prod["input_a"], prod["input_b"] = up[:, 0], up[:, 1]
    stack = np.zeros(nstack, dtype=[("prod", int), ("conjugate", bool)])
    stack["prod"] = np.arange(nstack)
    ra = np.radians(ra_deg)
    vis = (1.0 + np.exp(1j * 25.0 * ra)[None, None] + np.exp(-1j * 3.0 * ra)[None, None]
           + 0.1 * rng.standard_normal((3, nstack, nra))).astype(np.complex64)
    w = np.ones(vis.shape, np.float32)
    if flagged:
        w[1, :, 10:13] = 0.0
        w[2, 0] = 0.0
    outs = []
    for mod, tel, extra in ((jcontainers, jtel, {}), (containers, ttel, {"device": "cpu"})):
        ss = mod.SiderealStream(freq=jtel.frequencies, stack=nstack, input=jtel.nfeed, prod=nstack, ra=ra_deg,
                                **extra)
        ss.create_index_map("prod", prod)
        ss.create_index_map("stack", stack)
        ss.vis[:], ss.weight[:] = vis, w
        outs.append(ss)
    params = {"dec": 45.0, "epsilon": 1e-4}
    jo = _run(jdayenu.DayenuMFilter(), params, outs[0], setup=(jtel,))
    to = _run(tdayenu.DayenuMFilter(), params, outs[1], setup=(ttel,))
    _same_stream(jo, to, np.abs(vis).max())
    assert bool(torch.isfinite(to.vis[:]).all())
