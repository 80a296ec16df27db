"""The wavelet transform and spectrum: draco_tpu_torch against draco_tpu on the same inputs.

Small sizes (64-512 samples, 2-6 baselines), numpy inputs from a seed; the
JAX package on the CPU with 64-bit types, the port on the CPU.
Tolerances, max|diff| / max|ref|:

- the wavelet zoo's multipliers, centre frequencies and scales: 1e-12;
- ``cwt`` / ``cwt_morlet`` / ``cwt_var`` in float64: 1e-10; on complex64
  data: 1e-5;
- the Wiener in-fill (complex128 in both packages here): 1e-7 (it inverts
  ``F diag(D) F^H``, whose condition on these spectra is ~1e6, and then
  solves with the inverse: 3.0e-8 measured);
- ``WaveletSpectrumEstimator`` on complex64 data: 1e-4 of the spectrum's
  peak (the port transforms the in-filled data in complex64, the JAX
  package with 64-bit types in complex128: a float32 CWT and variance).
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from draco_tpu.analysis import wavelet as jwavelet
from draco_tpu.core import containers as jcontainers
from draco_tpu.ops import wavelet as jops
from draco_tpu_torch.analysis import wavelet as twavelet
from draco_tpu_torch.core import containers
from draco_tpu_torch.device import default_device
from draco_tpu_torch.ops import wavelet as tops

ZOO = ("morl", "cmor1.5-1.0", "mexh", "gaus2", "gaus1", "cmor")


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


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-300)


@pytest.mark.parametrize("name", ZOO)
def test_wavelet_zoo_matches_jax(name):
    w = np.linspace(-10, 10, 301)
    assert _rel(tops.wavelet_fourier(torch.as_tensor(w), name), np.asarray(jops.wavelet_fourier(w, name))) <= 1e-12
    assert tops.central_frequency(name, dt=0.5) == jops.central_frequency(name, dt=0.5)
    f = np.linspace(0.02, 0.2, 7)
    assert np.array_equal(tops.frequency2scale(f, wavelet=name), jops.frequency2scale(f, wavelet=name))
    assert np.array_equal(tops.frequency2scale(f, w0=6.0), jops.frequency2scale(f, w0=6.0))
    with pytest.raises(ValueError, match="Unsupported wavelet"):
        tops.wavelet_fourier(torch.zeros(3), "haar")


@pytest.mark.parametrize("name", ("morl", "cmor1.5-1.0", "mexh", "gaus2"))
def test_every_named_wavelet_finds_the_tone(name):
    """``tests/test_flagging2.py::test_wavelet_zoo`` on the port, and its transform against the JAX one."""
    n = 512
    t = np.arange(n)
    x = np.cos(2 * np.pi * 0.07 * t)
    freqs = np.linspace(0.02, 0.2, 40)
    scales = tops.frequency2scale(freqs, wavelet=name)
    W = tops.cwt(torch.as_tensor(x), scales, wavelet=name)
    assert _rel(W, np.asarray(jops.cwt(x, scales, wavelet=name))) <= 1e-10
    power = (W[:, n // 4 : -n // 4].abs() ** 2).mean(dim=-1)
    assert abs(freqs[int(torch.argmax(power))] - 0.07) < 0.02


@pytest.mark.parametrize("axis", [-1, 0, 1])
@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_cwt_and_var_match_jax(axis, dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((6, 8, 64)) + (1j * rng.standard_normal((6, 8, 64)) if dtype == np.complex64 else 0))
    x = x.astype(dtype)
    scales = tops.frequency2scale(np.linspace(0.05, 0.3, 5))
    tol = 1e-10 if dtype == np.float64 else 1e-5
    W = tops.cwt(torch.as_tensor(x), scales, axis=axis)
    Wj = np.asarray(jops.cwt(x, scales, axis=axis))
    assert W.dtype == (torch.complex128 if dtype == np.float64 else torch.complex64)
    assert _rel(W, Wj) <= tol
    assert _rel(tops.cwt_morlet(torch.as_tensor(x), scales, w0=6.0, axis=axis),
                np.asarray(jops.cwt_morlet(x, scales, w0=6.0, axis=axis))) <= tol
    assert _rel(tops.cwt_var(W, axis=2), np.asarray(jops.cwt_var(Wj, axis=2))) <= tol


def _streams(nfreq=48, nstack=4, nra=16, seed=3, flag=True):
    """A stream of each package: band-limited spectra, noise, a flagged channel and a flagged sample."""
    rng = np.random.default_rng(seed)
    freq = np.linspace(400.0, 448.0, nfreq, endpoint=False)
    tau = rng.uniform(-0.3, 0.3, (nstack, 3))
    amp = rng.standard_normal((nstack, 3, nra)) + 1j * rng.standard_normal((nstack, 3, nra))
    vis = np.einsum("skt,fsk->fst", amp, np.exp(2j * np.pi * freq[:, None, None] * tau[None]))
    vis = (vis + 0.1 * (rng.standard_normal(vis.shape) + 1j * rng.standard_normal(vis.shape))).astype(np.complex64)
    w = np.full(vis.shape, 100.0, np.float32)
    if flag:
        w[9] = 0.0
        w[:, :, 4] = 0.0
    kw = dict(freq=freq, stack=nstack, input=4, prod=nstack, ra=nra)
    js, ts = jcontainers.SiderealStream(**kw), containers.SiderealStream(**kw, device="cpu")
    js.vis[:], js.weight[:] = vis, w
    ts.vis[:], ts.weight[:] = vis, w
    return js, ts


def _dspec(mod, nbase=4, nfreq=48, extra=None):
    """A delay spectrum of each package's container type, flat below 0.3 us
    (``tests/test_sensitivity.py``'s form)."""
    delays = np.fft.fftshift(np.fft.fftfreq(nfreq, 1.0))
    ds = mod.DelaySpectrum(baseline=nbase, delay=delays, **(extra or {}))
    spec = np.where(np.abs(delays) < 0.3, 1.0, 1e-6) * np.linspace(1.0, 2.0, nbase)[:, None]
    ds.spectrum[:] = spec
    return ds


def test_wiener_infill_matches_jax():
    rng = np.random.default_rng(4)
    d = (rng.standard_normal((4, 16, 48)) + 1j * rng.standard_normal((4, 16, 48))).astype(np.complex64)
    Ni = np.abs(rng.standard_normal((4, 48))).astype(np.float32)
    Ni[:, 9] = 0.0
    ds = _dspec(jcontainers)
    D = np.asarray(ds.spectrum[:])
    freq = np.linspace(400.0, 448.0, 48, endpoint=False)
    F = np.exp(-2.0j * np.pi * np.asarray(ds.index_map["delay"])[None, :] * freq[:, None])
    ref = np.asarray(jwavelet._wiener_infill(d, Ni, D, F))
    got, nfail = twavelet.wiener_infill(torch.as_tensor(d), torch.as_tensor(Ni), torch.as_tensor(D),
                                        torch.as_tensor(F))
    assert got.dtype == torch.complex128 and nfail == 0
    assert _rel(got, ref) <= 1e-7


@pytest.mark.parametrize("params", [{}, {"chunks": 3, "ndelay": 20}, {"wavelet": "mexh", "chunks": 1}])
def test_wavelet_spectrum_estimator_matches_jax(params, monkeypatch):
    js, ts = _streams()
    jds, tds = _dspec(jcontainers), _dspec(containers, extra={"device": "cpu"})
    params = {"average_axis": "ra", "ndelay": 32, **params}
    jo = _run(jwavelet.WaveletSpectrumEstimator(), params, js, jds)
    to = _run(twavelet.WaveletSpectrumEstimator(), params, ts, tds)
    # the port's baseline blocks: several, with a small block budget
    monkeypatch.setattr(twavelet, "CWT_BLOCK_ELEMENTS", 32 * 16 * 48)
    blocked = _run(twavelet.WaveletSpectrumEstimator(), params, ts, tds)
    assert tuple(to.spectrum.shape) == tuple(jo.spectrum.shape)
    assert np.array_equal(to.index_map["delay"], jo.index_map["delay"])
    assert _rel(to.spectrum[:], np.asarray(jo.spectrum[:])) <= 1e-4
    assert _rel(to.weight[:], np.asarray(jo.weight[:])) <= 1e-6
    assert torch.equal(blocked.spectrum[:], to.spectrum[:])
    assert list(to.attrs["baseline_axes"]) == list(jo.attrs["baseline_axes"])
    assert to.attrs["infill_failed"] == 0


def test_a_baseline_without_delay_power_gets_a_zero_spectrum():
    """The JAX package's in-fill inverts a zero matrix there (NaN); the port
    in-fills zeros, counts the baseline and leaves the others as they were."""
    js, ts = _streams()
    tds = _dspec(containers, extra={"device": "cpu"})
    ref = _run(twavelet.WaveletSpectrumEstimator(), {"average_axis": "ra", "ndelay": 16}, ts, tds)
    tds.spectrum[:][2] = 0.0
    out = _run(twavelet.WaveletSpectrumEstimator(), {"average_axis": "ra", "ndelay": 16}, ts, tds)
    assert out.attrs["infill_failed"] == 1
    assert bool((out.spectrum[:][2] == 0).all())
    keep = [0, 1, 3]
    assert torch.equal(out.spectrum[:][keep], ref.spectrum[:][keep])


def _run(task, params, *inputs):
    task.read_config(params)
    return task.process(*inputs)
