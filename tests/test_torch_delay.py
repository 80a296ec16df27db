"""The delay-spectrum path: draco_tpu_torch against draco_tpu on the same inputs.

Small sizes (17-65 channels, 3-8 baselines, 16-64 samples), numpy inputs
from a seed; the JAX package on the CPU with 64-bit types, the port on the
CPU.  Tolerances, max|diff| / max|ref| unless stated:

- Fourier matrices, ``window_generalised``, ``ops/kernels``, the axis
  helpers: exact (copies) or 1e-12;
- ``null_filter``: the projector within 1e-10 where the design's singular
  values are well separated; at the oversampled default mode count (a
  continuum of singular values around the 1e-8 cut) the kept-mode counts
  equal and the projectors within 1e-6;
- weighted convolution filters 1e-10; ``delay_spectrum_fft`` 1e-12; the
  Wiener filter 1e-10;
- the host Gibbs samplers (auto, both signal-draw forms, and cross) with
  the same numpy seed: 1e-12;
- one batched Gibbs step with recorded draws against the JAX host sampler
  handed an rng object that returns those draws: 1e-10 in float64;
- the batched samplers: a baseline's chain bit-identical alone and in a batch, failed chains
  marked, recovery statistics with the JAX package's bounds
  (``tests/test_delay.py``);
- ``LogLikePS`` value, gradient and Hessian and ``maxpost`` against the
  JAX host float64 path (``DRACO_TPU_DELAYOPT_DEVICE=0``): 1e-8;
- every task on the same float32 container: 1e-5 (the trimmed means are
  float32 sums in either package).

Deliberate differences, each held here: the batched chains are seeded per
baseline (not the JAX PRNG), so they are compared statistically; the NRML
core is complex128 with no retry and no switch; failed cross chains are
re-sampled in complex128 on the same device, not on the host.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from draco_tpu.analysis import delay as jdelay
from draco_tpu.analysis import delayopt as jdelayopt
from draco_tpu.analysis import transform as jtransform
from draco_tpu.core import containers as jcontainers
from draco_tpu.ops import delay as jops
from draco_tpu.ops import filters as jfilters
from draco_tpu.ops import kernels as jkernels
from draco_tpu.ops import tools as jtools
from draco_tpu.telescope import PolarisedCylinderTelescope as JPolCylinder
from draco_tpu_torch.analysis import delay as tdelay
from draco_tpu_torch.analysis import delayopt as tdelayopt
from draco_tpu_torch.analysis import transform as ttransform
from draco_tpu_torch.core import containers
from draco_tpu_torch.device import default_device
from draco_tpu_torch.ops import delay as tops
from draco_tpu_torch.ops import filters as tfilters
from draco_tpu_torch.ops import kernels as tkernels
from draco_tpu_torch.ops import tools as ttools
from draco_tpu_torch.telescope import PolarisedCylinderTelescope

TOL32 = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch and the BLAS and OpenMP pools: these sizes
    gain nothing from threads, and beside five other test workers the
    spinning pools ran the file tens of times slower."""
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


def mock_freq_data(freq, ntime, delaycut, nbase=1, noise=0.0, seed=0):
    """Flat-delay-spectrum data band-limited below ``delaycut`` (``tests/test_delay.py``'s).

    Returns (data [nbase, ntime, nfreq], weight [nbase, nfreq]).
    """
    rng = np.random.Generator(np.random.SFC64(seed))
    nfreq = len(freq)
    delays = np.fft.fftfreq(nfreq, d=freq[1] - freq[0])
    S = (np.abs(delays) < delaycut).astype(float)
    data = np.zeros((nbase, ntime, nfreq), dtype=np.complex128)
    for b in range(nbase):
        amp = (rng.standard_normal((ntime, nfreq)) + 1j * rng.standard_normal((ntime, nfreq))) * np.sqrt(S / 2)
        data[b] = np.fft.fft(amp, axis=-1)
    if noise:
        data += noise * (rng.standard_normal(data.shape) + 1j * rng.standard_normal(data.shape))
    return data, np.ones((nbase, nfreq)) / max(2 * noise**2, 1e-4)


def make_streams(freq, ntime, delaycut, nstack=3, noise=0.01, seed=0, flag=True):
    """The same data in a JAX and a port ``SiderealStream`` [freq, stack, ra]; with
    ``flag``, one dead channel and one dead sample on every stack."""
    data, weight = mock_freq_data(freq, ntime, delaycut, nbase=nstack, noise=noise, seed=seed)
    vis = data.transpose(2, 0, 1).astype(np.complex64)
    w = np.broadcast_to(weight.T[:, :, None], vis.shape).astype(np.float32).copy()
    if flag:
        w[3], w[:, :, 5] = 0.0, 0.0
    prod = np.array([[0, 0], [0, 1], [1, 1], [0, 2], [1, 2], [2, 2]])[:nstack]
    kw = dict(freq=freq, input=3, ra=ntime, stack=None, prod=prod)
    js, ts = jcontainers.SiderealStream(**kw), containers.SiderealStream(**kw, device="cpu")
    js.vis[:], js.weight[:] = vis, w
    ts.vis[:], ts.weight[:] = vis, w
    return js, ts


def _run(task, params, *inputs, setup=()):
    task.read_config(params)
    if setup:
        task.setup(*setup)
    return task.process(*inputs)


# -- host copies: exact ------------------------------------------------------------


@pytest.mark.parametrize("N,fsel", [(16, None), (17, None), (32, np.array([0, 3, 4, 9, 16]))])
def test_fourier_matrices_match_jax(N, fsel):
    for name in ("fourier_matrix_r2c", "fourier_matrix_c2r", "fourier_matrix_c2c", "fourier_matrix"):
        assert np.array_equal(getattr(tops, name)(N, fsel), getattr(jops, name)(N, fsel)), name


@pytest.mark.parametrize("window", ["uniform", "hann", "hamming", "blackman", "nuttall", "blackman_nuttall",
                                    "blackman_harris", "triangular", "tukey-0.4"])
def test_window_generalised_matches_jax(window):
    x = np.linspace(-0.2, 1.2, 57)
    assert np.abs(ttools.window_generalised(x, window).numpy() - np.asarray(jtools.window_generalised(x, window))).max() <= 1e-12
    xt = torch.as_tensor(x, dtype=torch.float32)
    assert ttools.window_generalised(xt, window).dtype == torch.float32


@pytest.mark.parametrize("spec", [{"name": "matern", "width": 5.0, "nu": 1.5, "epsilon": 1e-8},
                                  {"name": "gaussian", "width": 2.0}, {"name": "rational", "a": 2.0},
                                  {"name": "periodic", "period": 7.0}])
def test_kernels_match_jax(spec):
    x = np.arange(12.0)
    assert np.array_equal(tkernels.get_kernel(spec)(x), jkernels.get_kernel(spec)(x))
    for name in ("moving_average_inverse",):
        assert np.array_equal(tkernels.get_kernel(name=name, N=9, width=3, alpha=2.0),
                              jkernels.get_kernel(name=name, N=9, width=3, alpha=2.0))
    assert np.array_equal(tkernels.moving_average_inverse(8, 3), jkernels.moving_average_inverse(8, 3))


@pytest.mark.parametrize("axis", [0, 2, (0, 2), (1,)])
def test_axis_helpers_match_jax(axis):
    arr = np.random.Generator(np.random.SFC64(3)).standard_normal((3, 4, 5))
    front = jops._move_front(arr, axis, arr.shape)
    assert np.array_equal(tops._move_front(arr, axis, arr.shape), front)
    tfront = tops._move_front(torch.from_numpy(arr), axis, arr.shape)
    assert np.array_equal(tfront.numpy(), front)
    assert np.array_equal(tops._inv_move_front(tfront, axis, arr.shape).numpy(), arr)
    assert np.array_equal(tops._inv_move_front(front, axis, arr.shape), jops._inv_move_front(front, axis, arr.shape))


def test_flatten_and_match_axes_match_jax():
    freq = np.linspace(400.0, 416.0, 17)
    js, ts = make_streams(freq, 8, 0.3)
    for keep in (["ra", "freq"], ["freq"], ["stack", "ra"]):
        jr, jc = jops.flatten_axes(js.vis, keep)
        tr, tc = tops.flatten_axes(ts.vis, keep)
        assert tc == jc and np.array_equal(tr.numpy(), jr)
    flags = containers.SiderealStream(freq=freq, input=3, ra=8, stack=None, prod=np.array([[0, 0], [0, 1], [1, 1]]),
                                      device="cpu")
    jflags = jcontainers.SiderealStream(freq=freq, input=3, ra=8, stack=None, prod=np.array([[0, 0], [0, 1], [1, 1]]))
    flags.input_flags[:] = np.arange(24.0).reshape(3, 8)
    jflags.input_flags[:] = np.arange(24.0).reshape(3, 8)
    jr, _ = jops.flatten_axes(jflags.input_flags, ["ra"], match_dset=jflags.input_flags)
    tr, _ = tops.flatten_axes(flags.input_flags, ["ra"], match_dset=flags.input_flags)
    assert np.array_equal(tr.numpy(), jr)
    assert np.array_equal(tops.match_axes(ts.vis, ts.weight).numpy(), jops.match_axes(js.vis, js.weight))


# -- filters ------------------------------------------------------------------------


@pytest.mark.parametrize("num_modes,cut,window,type_", [(8, 0.2, True, "high"), (8, 0.2, False, "low"),
                                                        (12, 0.2, False, "high"), (4, 0.1, "hann", "high")])
def test_null_filter_matches_jax(num_modes, cut, window, type_):
    freq = np.linspace(400.0, 432.0, 33)
    mask = np.ones(33)
    mask[[5, 20]] = 0.0
    ref = jfilters.null_filter(freq, cut, mask, num_modes=num_modes, window=window, type_=type_)
    got = tfilters.null_filter(freq, cut, mask, num_modes=num_modes, window=window, type_=type_, device="cpu")
    assert got.dtype == torch.complex128
    assert _rel(got, ref) <= 1e-10


def test_null_filter_at_the_oversampled_default_keeps_the_same_modes():
    """26 modes over 0.4 us on a 32 MHz band oversample the delay grid: the
    design's singular values run on below the 1e-8 cut, and the singular
    vectors there are determined to about sqrt(eps).  Kept-mode counts
    agree; the projectors within 1e-6; the port's is idempotent within 1e-8
    (the masked rows of those vectors are zero to about eps / sigma)."""
    freq = np.linspace(400.0, 432.0, 33)
    mask = np.ones(33)
    mask[5] = 0.0
    ref = jfilters.null_filter(freq, 0.2, mask, num_modes=26)
    got = tfilters.null_filter(freq, 0.2, mask, num_modes=26, window=False, device="cpu")
    ref_nw = jfilters.null_filter(freq, 0.2, mask, num_modes=26, window=False)
    assert np.linalg.matrix_rank(np.eye(33) * mask - ref_nw, tol=1e-6) == np.linalg.matrix_rank(
        np.eye(33) * mask - got.numpy(), tol=1e-6)
    assert _rel(got, ref_nw) <= 1e-6
    assert _rel(tfilters.null_filter(freq, 0.2, mask, num_modes=26, device="cpu"), ref) <= 1e-6
    assert _rel(got @ got, got) <= 1e-8


@pytest.mark.parametrize("complex_data,axis", [(True, -1), (False, 0), (True, 1)])
def test_weighted_convolution_filters_match_jax(complex_data, axis):
    rng = np.random.Generator(np.random.SFC64(5))
    x = rng.standard_normal((6, 40)) + (1j * rng.standard_normal((6, 40)) if complex_data else 0.0)
    w = rng.uniform(0.0, 1.0, x.shape)
    w[:, 7:10] = 0.0
    samples = np.linspace(0.0, 1.0, x.shape[axis])
    for t, j in ((tfilters.lowpass_weighted_convolution_filter, jfilters.lowpass_weighted_convolution_filter),
                 (tfilters.highpass_weighted_convolution_filter, jfilters.highpass_weighted_convolution_filter)):
        ref = j(x, w, samples, 8.0, axis=axis)
        got = t(torch.from_numpy(x), torch.from_numpy(w), samples, 8.0, axis=axis)
        assert _rel(got, ref) <= 1e-10


# -- estimators -----------------------------------------------------------------------


@pytest.mark.parametrize("window", ["nuttall", None])
def test_delay_spectrum_fft_matches_jax(window):
    data, _ = mock_freq_data(np.linspace(400.0, 416.0, 17), 8, 0.3, noise=0.01)
    ref = jops.delay_spectrum_fft(data[0], 17, window)
    assert _rel(tops.delay_spectrum_fft(torch.from_numpy(data[0]), 17, window), ref) <= 1e-12


@pytest.mark.parametrize("complex_timedomain", [False, True])
def test_wiener_filter_matches_jax(complex_timedomain):
    freq = np.linspace(400.0, 416.0, 17)
    data, weight = mock_freq_data(freq, 16, 0.3, noise=0.05)
    N = 17 if complex_timedomain else 32
    S = np.where(np.abs(np.fft.fftfreq(N, d=1.0)) < 0.3, 1.0, 1e-6)
    fsel = np.arange(17)
    args = (S, data[0], N, weight[0])
    kw = dict(fsel=fsel, complex_timedomain=complex_timedomain)
    assert _rel(tops.delay_spectrum_wiener_filter(*args, **kw), jops.delay_spectrum_wiener_filter(*args, **kw)) <= 1e-10


@pytest.mark.parametrize("nfreq_sel,complex_timedomain", [(17, False), (5, False), (17, True)])
def test_host_gibbs_matches_jax(nfreq_sel, complex_timedomain):
    """Both signal-draw forms (the dense delay basis and, with 5 of 17
    channels, the channel basis) and the complex time domain."""
    freq = np.linspace(400.0, 416.0, 17)
    data, weight = mock_freq_data(freq, 24, 0.3, noise=0.02)
    fsel = np.arange(17)[:: 17 // nfreq_sel][:nfreq_sel]
    N = 17 if complex_timedomain else 32
    kw = dict(fsel=fsel, niter=6, complex_timedomain=complex_timedomain)
    args = (data[0][:, fsel], N, weight[0][fsel], np.full(N, 10.0))
    j, jok = jops.delay_power_spectrum_gibbs(*args, rng=np.random.Generator(np.random.SFC64(4)), **kw)
    t, tok = tops.delay_power_spectrum_gibbs(*args, rng=np.random.Generator(np.random.SFC64(4)), **kw)
    assert jok and tok and len(t) == len(j) == 6
    assert _rel(np.array(t), np.array(j)) <= 1e-12


def test_host_cross_gibbs_matches_jax():
    freq = np.linspace(400.0, 408.0, 9)
    d1, w1 = mock_freq_data(freq, 16, 0.4, noise=0.05, seed=1)
    d2, _ = mock_freq_data(freq, 16, 0.4, noise=0.05, seed=2)
    data, Ni = np.stack([d1[0], d2[0]]), np.stack([w1[0], w1[0]])
    S0 = np.eye(2)[:, :, None] * np.full(16, 10.0)
    j = jops.delay_spectrum_gibbs_cross(data, 16, Ni, S0, niter=4, rng=np.random.Generator(np.random.SFC64(9)))
    t = tops.delay_spectrum_gibbs_cross(data, 16, Ni, S0, niter=4, rng=np.random.Generator(np.random.SFC64(9)))
    assert _rel(np.array(t), np.array(j)) <= 1e-12


class _Recorded:
    """An rng that hands out pre-drawn arrays in the order they are asked for."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def standard_normal(self, shape):
        out = self.arrays.pop(0)
        assert out.shape == tuple(shape)
        return out

    def chisquare(self, df, size):
        out = self.arrays.pop(0)
        assert out.shape == (size,)
        return out


@pytest.mark.parametrize("complex_timedomain", [False, True])
def test_batched_gibbs_step_matches_the_host_sampler_with_recorded_draws(complex_timedomain):
    """One step of the batched chain (``gibbs_step``, float64) against the JAX
    host ``delay_power_spectrum_gibbs`` (dense delay basis) handed the same
    standard normals and chi-square draws, for two baselines: 1e-10."""
    freq = np.linspace(400.0, 416.0, 17)
    data, weight = mock_freq_data(freq, 20, 0.3, nbase=2, noise=0.02, seed=6)
    weight[1] *= np.linspace(0.5, 2.0, 17)
    N = 17 if complex_timedomain else 32
    nd, nrow, nsamp = (2 * N if complex_timedomain else N), 34, 20
    fsel = np.arange(17)
    rng = np.random.Generator(np.random.SFC64(8))
    S = rng.uniform(0.5, 20.0, (2, N))
    w1, w2, chi2 = rng.standard_normal((2, nd, nsamp)), rng.standard_normal((2, nrow, nsamp)), rng.chisquare(nsamp, (2, N))
    refs = []
    for b in range(2):
        draws, ok = jops.delay_power_spectrum_gibbs(
            data[b], N, weight[b], S[b], fsel=fsel, niter=1, complex_timedomain=complex_timedomain,
            rng=_Recorded([w1[b], w2[b], chi2[b]]),
        )
        assert ok
        refs.append(draws[0])
    d, Ft, taper, Nih = tops.gibbs_inputs(torch.from_numpy(data), N, torch.from_numpy(weight), "nuttall", fsel,
                                          complex_timedomain)
    dw, FTNiF = tops.gibbs_batch_design(d, Ft, taper, Nih)
    got, info = tops.gibbs_step(FTNiF, Ft, Nih, dw, torch.from_numpy(S), torch.from_numpy(w1).transpose(1, 2),
                                torch.from_numpy(w2).transpose(1, 2), torch.from_numpy(chi2), complex_timedomain)
    assert got.dtype == torch.float64 and bool((info == 0).all())
    assert _rel(got, np.array(refs)) <= 1e-10


def _batched(data, weight, N, **kw):
    S0 = np.full((data.shape[0], N), 10.0)
    return tops.delay_power_spectrum_gibbs_batched(torch.from_numpy(data), N, torch.from_numpy(weight), S0, **kw)


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_batched_gibbs_does_not_depend_on_the_other_baselines(dtype):
    """7 baselines in batches of 2 (the tail padded): a baseline run alone
    gives its chain again bit for bit, from any place in the batches; the
    same data under other seeds give other samples."""
    freq = np.linspace(400.0, 416.0, 17)
    data, weight = mock_freq_data(freq, 16, 0.3, nbase=7, noise=0.02)
    data = torch.from_numpy(data).to(dtype)
    kw = dict(niter=3, batch=2)
    S0 = np.full((7, 32), 10.0)
    every, failed = tops.delay_power_spectrum_gibbs_batched(data, 32, weight, S0, seeds=list(range(100, 107)), **kw)
    assert every.dtype == data.real.dtype and every.shape == (3, 7, 32) and not bool(failed.any())
    other, _ = tops.delay_power_spectrum_gibbs_batched(data, 32, weight, S0, seeds=list(range(200, 207)), **kw)
    assert not torch.equal(other, every)
    for b in (1, 4, 6):  # the second of a batch, the first of a batch, the padded tail
        alone, _ = tops.delay_power_spectrum_gibbs_batched(data[b : b + 1], 32, weight[b : b + 1], S0[b : b + 1],
                                                           seeds=[100 + b], **kw)
        assert torch.equal(alone[:, 0], every[:, b])


def test_batched_gibbs_marks_a_failed_chain():
    """A baseline whose normal matrix cannot be factorised (negative inverse
    noise: a NaN design) is reported failed by cholesky_ex's info; the others
    are untouched."""
    freq = np.linspace(400.0, 416.0, 17)
    data, weight = mock_freq_data(freq, 16, 0.3, nbase=3, noise=0.02)
    ok, f_ok = _batched(data, weight, 32, niter=3, batch=2)
    weight[1] = -1.0
    bad, failed = _batched(data, weight, 32, niter=3, batch=2)
    assert failed.tolist() == [False, True, False] and not bool(f_ok.any())
    assert torch.equal(bad[:, [0, 2]], ok[:, [0, 2]])


def test_batched_gibbs_recovers_the_delay_cut():
    """``tests/test_delay.py``'s statistics on the port's chain: in-band over
    out-of-band medians above 20 on each of 3 baselines."""
    freq = np.linspace(400.0, 416.0, 17)
    data, weight = mock_freq_data(freq, 32, 0.4, nbase=3, noise=0.01)
    samples, failed = _batched(data, weight, 32, niter=30, batch=4)
    assert samples.shape == (30, 3, 32) and not bool(failed.any())
    spec = np.median(samples[-15:].numpy(), axis=0)
    delays = np.fft.fftfreq(32, d=freq[1] - freq[0])
    inband, outband = np.abs(delays) < 0.25, np.abs(delays) > 0.45
    for b in range(3):
        assert np.median(spec[b][inband]) > 20 * np.median(spec[b][outband])


def test_batched_cross_gibbs_matches_the_host_statistics():
    """``tests/test_delay.py``'s cross statistics on the port's chain: autos
    separate in from out of band by 20, the nearly identical datasets' cross
    over auto within 0.9-1.1 in band, the spectra Hermitian."""
    freq = np.linspace(400.0, 416.0, 17)
    d1, w1 = mock_freq_data(freq, ntime=32, delaycut=0.35, nbase=3, noise=0.01)
    mix = np.random.default_rng(7)
    d2 = d1 + 0.01 * (mix.standard_normal(d1.shape) + 1j * mix.standard_normal(d1.shape))
    data, Ni = np.stack([d1, d2], axis=1), np.stack([w1, w1], axis=1)
    S0 = np.broadcast_to(np.eye(2)[None, :, :, None] * 10.0, (3, 2, 2, 32)).copy()
    samples, failed = tops.delay_spectrum_gibbs_cross_batched(torch.from_numpy(data), 32, torch.from_numpy(Ni), S0,
                                                              niter=30, bchunk=2)
    assert samples.shape == (30, 3, 2, 2, 32) and not bool(failed.any())
    spec = np.median(samples[-15:].numpy(), axis=0)
    delays = np.fft.fftfreq(32, d=freq[1] - freq[0])
    inb, outb = np.abs(delays) < 0.25, np.abs(delays) > 0.45
    for b in range(3):
        auto = spec[b, 0, 0].real
        assert np.median(auto[inb]) > 20 * np.median(auto[outb])
        assert 0.9 < np.median(spec[b, 0, 1].real[inb]) / np.median(auto[inb]) < 1.1
        np.testing.assert_allclose(spec[b, 0, 1], np.conj(spec[b, 1, 0]), rtol=1e-4, atol=1e-8)


def test_batched_cross_gibbs_seeds_each_baseline():
    """Identical data on three baselines (chunks of 2 and a padded tail of 1)
    give three different chains; a baseline alone gives its chain again."""
    freq = np.linspace(400.0, 408.0, 9)
    d1, w1 = mock_freq_data(freq, 16, 0.4, noise=0.05)
    data = np.broadcast_to(d1[0][None, None], (3, 1, 16, 9)).copy()
    Ni = np.broadcast_to(w1[0][None, None], (3, 1, 9)).copy()
    S0 = np.ones((3, 1, 1, 16)) * 10.0
    s, failed = tops.delay_spectrum_gibbs_cross_batched(torch.from_numpy(data), 16, torch.from_numpy(Ni), S0, niter=6,
                                                        bchunk=2, seeds=[1, 2, 3])
    assert bool(torch.isfinite(torch.view_as_real(s)).all()) and not bool(failed.any())
    assert not torch.allclose(s[:, 0], s[:, 2]) and not torch.allclose(s[:, 0], s[:, 1])
    alone, _ = tops.delay_spectrum_gibbs_cross_batched(torch.from_numpy(data[2:]), 16, torch.from_numpy(Ni[2:]),
                                                       S0[2:], niter=6, bchunk=2, seeds=[3])
    assert torch.allclose(alone[:, 0], s[:, 2], rtol=1e-12, atol=0)


# -- delayopt ---------------------------------------------------------------------------


@pytest.fixture
def likelihood_inputs():
    rng = np.random.Generator(np.random.SFC64(11))
    nchan, ndelay, nsamp = 24, 32, 6
    rows = rng.standard_normal((nsamp, nchan)) + 1j * rng.standard_normal((nsamp, nchan))
    MF = rng.standard_normal((nchan, ndelay)) + 1j * rng.standard_normal((nchan, ndelay))
    N = rng.uniform(0.5, 2.0, nchan)
    return (rows.T @ rows.conj()) / nsamp, MF, N, nsamp, np.log(rng.uniform(0.5, 2.0, ndelay))


@pytest.mark.parametrize("exact_hessian", [True, False])
def test_loglike_matches_the_jax_host_path(likelihood_inputs, monkeypatch, exact_hessian):
    """The port's complex128 core against the JAX package's host float64 scipy
    path (its device core switched off): value, gradient, Hessian within 1e-8."""
    X, MF, N, nsamp, logs = likelihood_inputs
    monkeypatch.setenv("DRACO_TPU_DELAYOPT_DEVICE", "0")
    j = jdelayopt.LogLikePS(X, MF, N, nsamp, exact_hessian=exact_hessian)
    t = tdelayopt.LogLikePS(X, MF, N, nsamp, exact_hessian=exact_hessian, device="cpu")
    assert abs(t.value(logs) - j.value(logs)) <= 1e-8 * abs(j.value(logs))
    assert _rel(t.gradient(logs), j.gradient(logs)) <= 1e-8
    assert _rel(t.hessian(logs), j.hessian(logs)) <= 1e-8
    p = tdelayopt.AddFunctions([t, tdelayopt.GaussianProcessPrior(32)])
    q = jdelayopt.AddFunctions([j, jdelayopt.GaussianProcessPrior(32)])
    assert abs(p.value(logs) - q.value(logs)) <= 1e-8 * abs(q.value(logs))
    assert _rel(p.hessian(logs), q.hessian(logs)) <= 1e-8


def test_loglike_raises_where_the_covariance_is_not_positive_definite(likelihood_inputs):
    """No retry: a covariance that cannot be factorised raises LinAlgError,
    as scipy's ``cho_factor`` does (``maxpost`` reports it as no success)."""
    X, MF, N, nsamp, logs = likelihood_inputs
    t = tdelayopt.LogLikePS(X, MF, -N, nsamp, bounds=(1e-10, 1e-9), device="cpu")
    with pytest.raises(np.linalg.LinAlgError):
        t.value(logs)


def test_maxpost_matches_the_jax_host_path(monkeypatch):
    freq = np.linspace(400.0, 416.0, 17)
    data, weight = mock_freq_data(freq, 64, 0.3, noise=0.02)
    monkeypatch.setenv("DRACO_TPU_DELAYOPT_DEVICE", "0")
    js, jok = jdelayopt.delay_power_spectrum_maxpost(data[0], 32, weight[0], maxiter=15)
    ts, tok = tdelayopt.delay_power_spectrum_maxpost(data[0], 32, weight[0], maxiter=15, device="cpu")
    assert tok == jok and len(ts) == len(js) > 2
    assert _rel(ts[-1], js[-1]) <= 1e-8
    delays = np.fft.fftfreq(32, d=freq[1] - freq[0])
    assert np.median(ts[-1][np.abs(delays) < 0.2]) > 10 * np.median(ts[-1][np.abs(delays) > 0.45])


# -- tasks on the same container ---------------------------------------------------------


def _pair(cls_name, params, *inputs_pair):
    j = _run(getattr(jdelay, cls_name)(), params, *[p[0] for p in inputs_pair])
    t = _run(getattr(tdelay, cls_name)(), params, *[p[1] for p in inputs_pair])
    return j, t


def test_gibbs_task_with_the_same_seed_matches_jax():
    freq = np.linspace(400.0, 416.0, 17)
    streams = make_streams(freq, 32, 0.3)
    j, t = _pair("DelayPowerSpectrumGibbs", {"nsamp": 10, "seed": 11, "save_spectrum_mask": True,
                                             "save_samples": True}, streams)
    assert isinstance(t, containers.DelaySpectrum) and np.array_equal(t.delay, j.delay)
    assert _rel(t.spectrum[:], np.asarray(j.spectrum[:])) <= TOL32
    assert _rel(t.datasets["spectrum_samples"][:], np.asarray(j.datasets["spectrum_samples"][:])) <= TOL32
    assert np.array_equal(t.datasets["spectrum_mask"][:], np.asarray(j.datasets["spectrum_mask"][:]))


@pytest.mark.parametrize("params", [{"complex_timedomain": True}, {"complex_timedomain": True, "apply_window": False,
                                                                  "save_spectrum_mask": True}])
def test_fft_and_power_spectrum_tasks_match_jax(params):
    freq = np.linspace(400.0, 416.0, 17)
    streams = make_streams(freq, 8, 0.3, noise=0.001)
    # the FFT estimator is complex-to-complex: keep every channel (the flagged one too)
    j, t = _pair("DelaySpectrumFFT", {"freq_frac": -1.0, **params}, streams)
    assert isinstance(t, containers.DelayTransform)
    assert _rel(t.spectrum[:], np.asarray(j.spectrum[:])) <= TOL32
    jp, tp = _pair("DelaySpectrumToPowerSpectrum", {}, (j, t))
    assert _rel(tp.spectrum[:], np.asarray(jp.spectrum[:])) <= TOL32
    if params.get("save_spectrum_mask"):
        assert np.array_equal(tp.datasets["spectrum_mask"][:], np.asarray(jp.datasets["spectrum_mask"][:]))


@pytest.mark.parametrize("complex_timedomain", [False, True])
def test_wiener_task_matches_jax(complex_timedomain):
    freq = np.linspace(400.0, 416.0, 17)
    js, ts = make_streams(freq, 16, 0.3, noise=0.05)
    N = 17 if complex_timedomain else 34  # 16 channel steps and the skipped Nyquist: 2 x 17 delays
    S = np.where(np.abs(np.fft.fftshift(np.fft.fftfreq(N, d=1.0))) < 0.3, 1.0, 1e-3)
    dps = [cls(baseline=3, delay=np.arange(N), sample=1) for cls in (jcontainers.DelaySpectrum,)]
    dps.append(containers.DelaySpectrum(baseline=3, delay=np.arange(N), sample=1, device="cpu"))
    for d in dps:
        d.spectrum[:] = np.broadcast_to(S, (3, N))
    params = {"complex_timedomain": complex_timedomain, "save_spectrum_mask": True}
    j = _run(jdelay.DelaySpectrumWienerFilter(), params, js, setup=(dps[0],))
    t = _run(tdelay.DelaySpectrumWienerFilter(), params, ts, setup=(dps[1],))
    assert _rel(t.spectrum[:], np.asarray(j.spectrum[:])) <= TOL32
    it = _run(tdelay.DelaySpectrumWienerFilterIteratePS(), params, ts, dps[1])
    assert torch.equal(it.spectrum[:], t.spectrum[:])


def test_nrml_task_matches_jax(monkeypatch):
    monkeypatch.setenv("DRACO_TPU_DELAYOPT_DEVICE", "0")
    freq = np.linspace(400.0, 416.0, 17)
    streams = make_streams(freq, 32, 0.3, nstack=2, noise=0.02)
    j, t = _pair("DelayPowerSpectrumNRML", {"nsamp": 8, "save_spectrum_mask": True}, streams)
    assert _rel(t.spectrum[:], np.asarray(j.spectrum[:])) <= TOL32
    assert np.array_equal(t.datasets["spectrum_mask"][:], np.asarray(j.datasets["spectrum_mask"][:]))


def test_cross_task_with_the_same_seed_matches_jax():
    freq = np.linspace(400.0, 408.0, 9)
    a, b = make_streams(freq, 16, 0.5, nstack=2, seed=1), make_streams(freq, 16, 0.5, nstack=2, seed=2)
    j, t = _pair("DelayCrossPowerSpectrumEstimator", {"nsamp": 4, "seed": 21, "save_samples": True}, a, b)
    assert isinstance(t, containers.DelayCrossSpectrum)
    assert _rel(t.spectrum[:], np.asarray(j.spectrum[:])) <= TOL32
    assert _rel(t.datasets["spectrum_samples"][:], np.asarray(j.datasets["spectrum_samples"][:])) <= TOL32


def test_batched_tasks_recover_the_band_as_jax_does():
    """Both batched estimators against the JAX package's per-baseline host
    estimators on the same streams (their draws differ: per-baseline seeds
    and torch generators against numpy's), with ``tests/test_delay.py``'s
    bounds: in-band over out-of-band medians above 10 on every baseline in
    both, the in-band medians of port over JAX within 0.5-2 (20 samples,
    half kept).  The cross estimators on two streams of 4 baselines, 20
    samples, half kept: the median of one chain's auto over its delays
    scattered by 0.05-0.08 in its log over 12 seeds, so the median of the
    8 pooled autos scatters by about 1.25 x 0.07 / sqrt(8) = 0.031 and the
    log of port's over JAX's by 0.044 (0.039 measured over 10 seed pairs):
    the bounds 0.85-1.18 are 3.7 of those, and a scale error of 2 fails."""
    freq = np.linspace(400.0, 416.0, 17)
    js, ts = make_streams(freq, 32, 0.3, flag=False)
    params = {"nsamp": 20, "seed": 11, "save_spectrum_mask": True, "save_samples": True}
    t = _run(tdelay.DelayPowerSpectrumGibbsBatched(), params, ts)
    j = _run(jdelay.DelayPowerSpectrumGibbs(), params, js)
    inband, outband = np.abs(t.delay) < 0.2, np.abs(t.delay) > 0.45
    tspec, jspec = t.spectrum[:].numpy(), np.asarray(j.spectrum[:])
    for spec in (tspec, jspec):
        for b in range(3):
            assert np.median(spec[b][inband]) > 10 * np.median(spec[b][outband])
    r = np.median(tspec[:, inband], -1) / np.median(jspec[:, inband], -1)
    assert np.all((r > 0.5) & (r < 2.0))
    assert not t.datasets["spectrum_mask"][:].any() and t.attrs["gibbs_failed"] == 0
    assert t.datasets["spectrum_samples"][:].shape == (20, 3, 34)

    (ja, ta), (jb, tb) = make_streams(freq, 32, 0.5, nstack=4, seed=1), make_streams(freq, 32, 0.5, nstack=4, seed=2)
    tc = _run(tdelay.DelayCrossPowerSpectrumEstimatorBatched(), {"nsamp": 20, "seed": 21, "save_samples": True}, ta, tb)
    jc = _run(jdelay.DelayCrossPowerSpectrumEstimator(), {"nsamp": 20, "seed": 21}, ja, jb)
    assert tc.attrs["gibbs_resampled"] == 0 and bool(torch.isfinite(tc.spectrum[:]).all()) and bool((tc.spectrum[:] != 0).any())
    # spectrum [dataset, dataset, baseline, delay]: the 2 x 4 autos pooled
    tauto, jauto = (np.stack([np.asarray(s)[i, i].real for i in (0, 1)]) for s in (tc.spectrum[:].numpy(), jc.spectrum[:]))
    r = np.median(tauto) / np.median(jauto)
    assert 0.85 <= r <= 1.18, r


def test_batched_gibbs_task_masks_failed_chains(monkeypatch):
    real = tdelay.delay_power_spectrum_gibbs_batched

    def one_fails(*args, **kw):
        s, failed = real(*args, **kw)
        failed[0] = True
        return s, failed

    monkeypatch.setattr(tdelay, "delay_power_spectrum_gibbs_batched", one_fails)
    _, ts = make_streams(np.linspace(400.0, 416.0, 17), 16, 0.3)
    out = _run(tdelay.DelayPowerSpectrumGibbsBatched(), {"nsamp": 4, "seed": 1, "save_spectrum_mask": True}, ts)
    assert out.attrs["gibbs_failed"] == 1 and out.datasets["spectrum_mask"][:].tolist() == [True, False, False]
    assert bool((out.spectrum[:][0] == 0).all()) and bool((out.spectrum[:][1:] != 0).any())


def test_batched_cross_task_resamples_failed_chains_in_complex128_on_the_device(monkeypatch):
    """Deliberate difference: the JAX task sends a chain its device sampler
    could not factorise to the host float64 sampler; the port samples it
    again in complex128 with the same seed on the same device."""
    real = tdelay.delay_spectrum_gibbs_cross_batched
    dtypes = []

    def first_fails_in_complex64(data, *args, **kw):
        dtypes.append(data.dtype)
        s, failed = real(data, *args, **kw)
        if data.dtype == torch.complex64:
            failed[0] = True
        return s, failed

    monkeypatch.setattr(tdelay, "delay_spectrum_gibbs_cross_batched", first_fails_in_complex64)
    freq = np.linspace(400.0, 408.0, 9)
    a, b = make_streams(freq, 16, 0.5, nstack=2, seed=1)[1], make_streams(freq, 16, 0.5, nstack=2, seed=2)[1]
    out = _run(tdelay.DelayCrossPowerSpectrumEstimatorBatched(), {"nsamp": 4, "seed": 3}, a, b)
    assert out.attrs["gibbs_resampled"] == 1 and dtypes == [torch.complex64, torch.complex128]
    assert bool(torch.isfinite(out.spectrum[:]).all()) and bool((out.spectrum[:][..., 0, :] != 0).any())


# -- filters as tasks, Stokes I ---------------------------------------------------------------


@pytest.fixture(scope="module")
def pol_cylinder():
    kw = dict(num_cylinders=2, num_feeds=4, feed_spacing=0.5, cylinder_width=20.0, cylinder_spacing=22.0,
              latitude=49.0, freq_lower=400.0, freq_upper=432.0, num_freq=33, auto_correlations=True)
    return JPolCylinder(**kw), PolarisedCylinderTelescope(**kw)


def _pol_streams(tel_pair, ntime=12, seed=3):
    """One stream per package on the telescope's unique pairs: a smooth
    (low-delay) foreground per product, white noise, one dead channel and
    one dead sample."""
    jtel, _ = tel_pair
    pairs = np.asarray(jtel.uniquepairs)
    rng = np.random.Generator(np.random.SFC64(seed))
    nf, npair = jtel.nfreq, len(pairs)
    freq = jtel.frequencies
    tau = rng.uniform(-0.05, 0.05, (npair, 2))
    amp = rng.standard_normal((npair, 2, ntime)) + 1j * rng.standard_normal((npair, 2, ntime))
    fg = np.einsum("pkt,fpk->fpt", amp, np.exp(2j * np.pi * freq[:, None, None] * tau[None]))
    vis = (10 * fg + 0.1 * (rng.standard_normal(fg.shape) + 1j * rng.standard_normal(fg.shape))).astype(np.complex64)
    w = np.ones(vis.shape, np.float32)
    w[7], w[:, :, 4] = 0.0, 0.0
    prod = np.empty(npair, dtype=[("input_a", int), ("input_b", int)])
    prod["input_a"], prod["input_b"] = pairs.T
    kw = dict(freq=freq, ra=ntime, input=jtel.nfeed, prod=prod)
    js, ts = jcontainers.SiderealStream(**kw), containers.SiderealStream(**kw, device="cpu")
    js.vis[:], js.weight[:] = vis, w
    ts.vis[:], ts.weight[:] = vis, w
    return js, ts


@pytest.mark.parametrize("params", [{"delay_cut": 0.1}, {"delay_cut": 0.05, "za_cut": 0.5, "window": True,
                                                        "telescope_orientation": "none"}])
def test_delay_filter_matches_jax(pol_cylinder, params):
    js, ts = _pol_streams(pol_cylinder)
    before = ts.vis[:].clone()
    jo = _run(jdelay.DelayFilter(), params, js, setup=(pol_cylinder[0],))
    to = _run(tdelay.DelayFilter(), params, ts, setup=(pol_cylinder[1],))
    assert to is ts
    assert np.array_equal(to.weight[:].numpy(), np.asarray(jo.weight[:]))
    assert _rel(to.vis[:], np.asarray(jo.vis[:])) <= TOL32 * np.abs(before.numpy()).max() / np.abs(np.asarray(jo.vis[:])).max()
    live = to.weight[:] > 0
    assert (to.vis[:][live].abs() ** 2).sum() < 1e-2 * (before[live].abs() ** 2).sum()


def test_delay_filter_base_matches_jax(pol_cylinder):
    """Within 1e-5 of the float32 input's peak, as ``DelayFilter``."""
    js, ts = _pol_streams(pol_cylinder)
    before = ts.vis[:].clone()
    params = {"delay_cut": 0.1}
    jo = _run(jdelay.DelayFilterBase(), params, js, setup=(pol_cylinder[0],))
    to = _run(tdelay.DelayFilterBase(), params, ts, setup=(pol_cylinder[1],))
    assert np.array_equal(to.weight[:].numpy(), np.asarray(jo.weight[:]))
    assert _rel(to.vis[:], np.asarray(jo.vis[:])) <= TOL32 * np.abs(before.numpy()).max() / np.abs(np.asarray(jo.vis[:])).max()


def test_stokes_i_matches_jax(pol_cylinder):
    js, ts = _pol_streams(pol_cylinder)
    jo = _run(jtransform.StokesIVis(), {}, js, setup=(pol_cylinder[0],))
    to = _run(ttransform.StokesIVis(), {}, ts, setup=(pol_cylinder[1],))
    assert np.array_equal(to.index_map["stack"], jo.index_map["stack"])
    assert _rel(to.vis[:], np.asarray(jo.vis[:])) <= 1e-6
    assert np.array_equal(to.weight[:].numpy(), np.asarray(jo.weight[:]))
    vis, weight, ubase = ttransform.stokes_I(ts, pol_cylinder[1])
    assert torch.equal(vis, to.vis[:]) and torch.equal(weight, to.weight[:])
    assert np.array_equal(ubase, to.index_map["stack"])


@pytest.mark.parametrize("name", ["DelayPowerSpectrumStokesIEstimator", "DelayPowerSpectrumGeneralEstimator"])
def test_deprecated_estimators_raise(name):
    with pytest.raises(DeprecationWarning):
        getattr(tdelay, name)().setup()
