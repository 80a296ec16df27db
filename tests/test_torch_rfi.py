"""SumThreshold, the scale-invariant rank and the flagging library's tools:
draco_tpu_torch against draco_tpu on the same seeded numpy inputs.

The port runs ``ops/rfi.py`` as torch ops on the CPU here (float64, as on
the card); the JAX package runs under the tests' x64.

Tolerances: the masks are equal.  SumThreshold's window sums are
cumulative-sum differences whose last bits depend on the summation order,
so the data are Gaussian draws with no sample within rounding of a
threshold.  SIR's windows tie exactly when their flagged fraction is
``1 - eta`` (a tie the comparison makes on sums of ``mask + (eta - 1)``);
the equality cases use eta 0.23, 0.37 and 0.61, whose ``1 - eta`` no
window of these lengths can reach, and ``test_sir_tie_case_at_eta_0_2``
names the tie case: the port must equal the brute-force definition there,
as the JAX package's own test brackets it.  The host scipy tools
(``arPLS_1d``, ``IarPLS_1d``, ``penalized_least_squares_1d``,
``apply_hysteresis_threshold``) are the same numpy code and are held to
equality; ``taper_mask`` (a float64 ``conv1d`` against ``jnp.convolve``)
within 1e-12.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from draco_tpu.ops import rfi as jrfi
from draco_tpu.ops import tools as jtools
from draco_tpu_torch.ops import rfi, tools


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread for torch and the BLAS pools: these sizes gain nothing from
    threads, and beside other test workers spinning pools run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _plane(seed, shape=(48, 64)):
    rng = np.random.Generator(np.random.SFC64(seed))
    data = rng.standard_normal(shape)
    data[..., 20, :] += 9.0  # a bad frequency
    data[..., :, 33] += 9.0  # a bad time
    data[..., 5, 10:14] += 4.0
    return data, rng


@pytest.mark.parametrize(
    "kwargs",
    [
        {"max_m": 8},
        {"max_m": 16, "remove_median": False, "threshold1": 4.0},
        {"max_m": 4, "correct_for_missing": False, "axes": 1},
        {"max_m": 8, "only_positive": True, "rho": 1.2},
        {"max_m": 8, "axes": (0,)},
    ],
)
def test_sumthreshold_matches_jax(kwargs):
    data, rng = _plane(1)
    start = rng.uniform(size=data.shape) < 0.05
    data[3, 3] = np.nan
    got = rfi.sumthreshold(data, start_flag=start, device="cpu", **kwargs)
    want = jrfi.sumthreshold(data, start_flag=start, **kwargs)
    assert got.dtype == bool and got.shape == data.shape
    assert np.array_equal(got, want)
    assert got[start].all() and got[3, 3]
    assert np.array_equal(rfi.sumthreshold_py(data, start_flag=start, device="cpu", **kwargs), got)


def test_sumthreshold_with_variance_matches_jax():
    data, rng = _plane(2, (3, 40, 96))
    var = rng.uniform(0.5, 2.0, data.shape)
    kw = dict(max_m=16, threshold1=5.0, remove_median=False, rho=1.0, variance=var)
    got = rfi.sumthreshold(data, device="cpu", **kw)
    assert np.array_equal(got, jrfi.sumthreshold(data, **kw))
    # a tensor input runs on its own device and gives the same mask
    assert np.array_equal(rfi.sumthreshold(torch.from_numpy(data), variance=torch.from_numpy(var),
                                           max_m=16, threshold1=5.0, remove_median=False, rho=1.0), got)
    with pytest.raises(RuntimeError, match="explicit threshold1"):
        rfi.sumthreshold(data, variance=var, device="cpu")


def test_sumthreshold_flags_the_outliers():
    data, _ = _plane(3, (64, 64))
    data[20, :] += 11.0
    data[:, 33] += 11.0
    mask = rfi.sumthreshold(data, max_m=8, device="cpu")
    assert mask[20].mean() > 0.9 and mask[:, 33].mean() > 0.9
    clean = np.ones_like(mask)
    clean[20] = False
    clean[:, 33] = False
    assert mask[clean].mean() < 0.2


def _masks(seed, shape):
    rng = np.random.Generator(np.random.SFC64(seed))
    m = rng.uniform(size=shape) < 0.3
    m[..., 5:9] = True
    return m


@pytest.mark.parametrize("eta", [0.23, 0.37, 0.61])
@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_sir1d_matches_jax(eta, axis):
    m = _masks(4, (12, 20, 31))
    got = rfi.sir1d(m, eta=eta, axis=axis, device="cpu")
    assert np.array_equal(got, jrfi.sir1d(m, eta=eta, axis=axis))
    assert (got | m == got).all()


@pytest.mark.parametrize("eta", [0.23, (0.37, 0.61)])
def test_scale_invariant_rank_and_sir_match_jax(eta):
    m = _masks(5, (16, 3, 40))
    axes = (0, -1)
    got = rfi.scale_invariant_rank(m, eta=eta, axis=axes, device="cpu")
    assert np.array_equal(got, jrfi.scale_invariant_rank(m, eta=eta, axis=axes))
    e = eta if np.isscalar(eta) else eta[0]
    for kw in ({}, {"only_freq": True}, {"only_time": True}):
        assert np.array_equal(rfi.sir(m, eta=e, device="cpu", **kw), jrfi.sir(m, eta=e, **kw))
    with pytest.raises(ValueError, match="pair up"):
        rfi.scale_invariant_rank(m, eta=(0.1, 0.2, 0.3), axis=axes, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        rfi.sir(m, only_freq=True, only_time=True, device="cpu")
    with pytest.raises(ValueError, match="freq, prod, time"):
        rfi.sir(m[0], device="cpu")


def _brute(mask, eta, slack=0.0):
    n = len(mask)
    w = mask.astype(float) + (eta - 1.0)
    out = mask.copy()
    for a in range(n):
        for b in range(a + 1, n + 1):
            if w[a:b].sum() >= -slack:
                out[a:b] = True
    return out


def test_sir_tie_case_at_eta_0_2():
    """The tie case, named: at eta 0.2 a window of 5 with 4 flagged has a
    flagged fraction of exactly 1 - eta, and whether it is flagged depends
    on the rounding of the prefix sums, which differs between torch's scan
    and XLA's (the two packages disagree on such windows).  As the JAX
    package's own test does, the port is bracketed: it contains the strict
    brute-force definition and is contained in the one slackened by 1e-6;
    and the right-edge runs that the reference's scan skips are dilated."""
    edge = np.zeros(10, bool)
    edge[8:] = True
    for eta in (0.2, 0.5):
        assert np.array_equal(rfi.sir1d(edge, eta=eta, device="cpu"), _brute(edge, eta))
    rng = np.random.default_rng(7)
    for _ in range(40):
        m = rng.random(rng.integers(1, 24)) < 0.3
        for eta in (0.2, 0.5):
            got = rfi.sir1d(m, eta=eta, device="cpu")
            assert (got | _brute(m, eta) == got).all()
            assert (got | _brute(m, eta, slack=1e-6) == _brute(m, eta, 1e-6)).all()
    base = np.zeros((1, 50), dtype=bool)
    base[0, 20:25] = True
    assert np.array_equal(rfi.scale_invariant_rank(base, eta=0.0, axis=-1, device="cpu"), base)
    assert rfi.scale_invariant_rank(base, eta=0.5, axis=-1, device="cpu").sum() > base.sum()


# -- ops/tools.py: the baseline fits, hysteresis and the taper ------------------------


def _spectrum(seed=0, n=200):
    rng = np.random.Generator(np.random.SFC64(seed))
    x = np.linspace(0, 10, n)
    y = 2.0 + 0.3 * x + 0.05 * rng.standard_normal(n)
    y[[30, 90, 150]] += 20.0
    mask = rng.uniform(size=n) < 0.1
    return y, mask


@pytest.mark.parametrize("fit", ["arPLS_1d", "IarPLS_1d"])
@pytest.mark.parametrize("lam", [5e1, 1e4])
def test_baseline_fits_match_jax(fit, lam):
    y, mask = _spectrum()
    got = getattr(tools, fit)(y, mask=mask, lam=lam)
    assert np.array_equal(got, getattr(jtools, fit)(y, mask=mask, lam=lam))
    base = 2.0 + 0.3 * np.linspace(0, 10, 200)
    good = np.ones(200, bool)
    good[[30, 90, 150]] = False
    if lam == 1e4:
        assert np.abs(got[good] - base[good]).mean() < 0.5


def test_penalized_least_squares_matches_jax_and_refuses_bad_input():
    y, mask = _spectrum(1)

    def reweight(resid, m, it):
        return np.where(resid > 0, 0.1, 1.0)

    got = tools.penalized_least_squares_1d(y, reweight, mask=mask, lam=1e3, max_iter=5)
    assert np.array_equal(got, jtools.penalized_least_squares_1d(y, reweight, mask=mask, lam=1e3, max_iter=5))
    with pytest.raises(ValueError, match="1D data"):
        tools.penalized_least_squares_1d(np.ones((3, 4)), reweight)
    with pytest.warns(UserWarning, match="Every sample is masked"):
        assert not tools.penalized_least_squares_1d(y, reweight, mask=np.ones(200, bool)).any()


@pytest.mark.parametrize("shape", [(5, 20), (4, 6, 9)])
def test_apply_hysteresis_threshold_matches_jax(shape):
    rng = np.random.Generator(np.random.SFC64(8))
    img = rng.uniform(0, 4, shape)
    img.reshape(-1)[::17] = 10.0
    got = tools.apply_hysteresis_threshold(img, 2.5, 8.0)
    assert np.array_equal(got, jtools.apply_hysteresis_threshold(img, 2.5, 8.0))
    assert not tools.apply_hysteresis_threshold(img, 20.0, 30.0).any()
    small = np.zeros((5, 20))
    small[2, 5:10], small[2, 7], small[4, 15:18] = 3.0, 10.0, 3.0
    m = tools.apply_hysteresis_threshold(small, low=2.0, high=8.0)
    assert m[2, 5:10].all() and not m[4, 15:18].any()


@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("nwidth", [2, 4, 7])
def test_taper_mask_matches_jax(outer, nwidth):
    rng = np.random.Generator(np.random.SFC64(9))
    mask = rng.uniform(size=(6, 70)) < 0.15
    mask[0, 20:30] = True
    got = tools.taper_mask(mask, nwidth, outer=outer, device="cpu")
    want = np.asarray(jtools.taper_mask(mask, nwidth, outer=outer))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-12
    one = tools.taper_mask(mask[0], nwidth, device="cpu")
    assert tuple(one.shape) == (1, 70)
    if not outer and nwidth == 4:
        t = one[0].numpy()
        assert np.isclose(t[25], 1.0) and np.isclose(t[0], 0.0) and ((t > 0.05) & (t < 0.95)).any()
