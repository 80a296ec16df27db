"""The synthesis layer: draco_tpu_torch against draco_tpu on the same inputs.

Product-array tools, random draws, noise tasks, gains, weighted medians and
mock catalogues, each in both packages on the same seeded numpy inputs (the
port on the CPU, JAX on the CPU with 64-bit types on).

Tolerances.  Exact (bit for bit) for the host draws (gains, the numpy
Wishart twins, mock catalogues, medians) and for pure index work (cmap,
icmap, extract_diagonal, unpack_product_array, redundancy counts);
max|diff| / max|ref| <= 1e-6 where a product is formed in complex128 and
stored in complex64 (apply_gain, the radiometer weights).  The device
draws cannot match the JAX package's PRNG, so they are held to their
statistics; each bound is derived where it is stated.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from draco_tpu.core import containers as jcontainers
from draco_tpu.core import task as jtask
from draco_tpu.ops import median as jmedian
from draco_tpu.ops import random as jrandom
from draco_tpu.ops import tools as jtools
from draco_tpu.synthesis import gain as jgain
from draco_tpu.synthesis import mockcatalog as jmock
from draco_tpu.synthesis import noise as jnoise
from draco_tpu_torch.core import containers
from draco_tpu_torch.core.task import PipelineStopIteration
from draco_tpu_torch.device import default_device
from draco_tpu_torch.ops import median, tools
from draco_tpu_torch.ops import random as trandom
from draco_tpu_torch.synthesis import gain, mockcatalog, noise

TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _full_stream(package, nfreq=2, nfeed=4, nra=16, seed=0):
    """Full-triangle sidereal stream with positive-definite expectation
    matrices V = X X^H / 2n + 10 I (the JAX tests' ``make_full_stream``)."""
    rng = np.random.Generator(np.random.SFC64(seed))
    ss = package.SiderealStream(freq=np.linspace(800.0, 780.0, nfreq), input=nfeed, ra=nra)
    iu = np.triu_indices(nfeed)
    vis = np.zeros((nfreq, nfeed * (nfeed + 1) // 2, nra), dtype=np.complex64)
    for fi in range(nfreq):
        for ti in range(nra):
            X = rng.standard_normal((nfeed, 2 * nfeed)) + 1j * rng.standard_normal((nfeed, 2 * nfeed))
            vis[fi, :, ti] = (X @ X.conj().T / (2 * nfeed) + 10 * np.eye(nfeed))[iu]
    ss.vis[:] = vis
    ss.weight[:] = 1.0
    return ss


def _run(task, params, setup=(), *inputs):
    task.read_config(params)
    if setup is not None:
        task.setup(*setup)
    return task.process(*inputs)


# -- ops/tools: the product-array helpers -------------------------------------


def test_cmap_icmap_match_jax():
    n = 7
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    assert np.array_equal(tools.cmap(i, j, n), jtools.cmap(i, j, n))
    ix = np.arange(n * (n + 1) // 2)
    assert all(np.array_equal(a, b) for a, b in zip(tools.icmap(ix, n), jtools.icmap(ix, n)))
    assert tools.icmap(5, n) == jtools.icmap(5, n)


@pytest.mark.parametrize("form", ["triangle", "prod_map", "in_place", "real_out"])
def test_apply_gain_matches_jax(form):
    rng = np.random.Generator(np.random.SFC64(1))
    ninput, ntime = 5, 6
    nprod = ninput * (ninput + 1) // 2
    vis = (rng.standard_normal((2, nprod, ntime)) + 1j * rng.standard_normal((2, nprod, ntime))).astype(np.complex64)
    g = rng.standard_normal((2, ninput, ntime)) + 1j * rng.standard_normal((2, ninput, ntime))
    prod_map = None
    if form == "prod_map":
        pairs = np.stack(np.triu_indices(ninput), -1)[rng.permutation(nprod)]
        prod_map = np.zeros(nprod, dtype=[("input_a", "<u2"), ("input_b", "<u2")])
        prod_map["input_a"], prod_map["input_b"] = pairs.T
    if form == "real_out":
        w = rng.uniform(0.5, 2.0, (2, nprod, ntime)).astype(np.float32)
        fac = rng.uniform(0.5, 2.0, (2, ninput, ntime))
        want = np.asarray(jtools.apply_gain(w, fac)).real
        got = torch.from_numpy(w.copy())
        tools.apply_gain(got, torch.from_numpy(fac), out=got)
        assert got.dtype == torch.float32 and _rel(got, want) <= TOL
        return
    want = np.asarray(jtools.apply_gain(vis, g, prod_map=prod_map)).astype(np.complex64)
    if form == "in_place":
        got = torch.from_numpy(vis.copy())
        tools.apply_gain(got, torch.from_numpy(g), out=got)
    else:
        got = tools.apply_gain(torch.from_numpy(vis), torch.from_numpy(g), prod_map=prod_map).to(torch.complex64)
    assert _rel(got, want) <= TOL


def test_apply_gain_in_place_works_in_blocks(monkeypatch):
    """Blocks of a few products give the one-shot answer exactly."""
    rng = np.random.Generator(np.random.SFC64(2))
    vis = torch.from_numpy(rng.standard_normal((3, 21, 8)) + 1j * rng.standard_normal((3, 21, 8)))
    g = torch.from_numpy(rng.standard_normal((3, 6, 8)) + 1j * rng.standard_normal((3, 6, 8)))
    whole = tools.apply_gain(vis, g)
    monkeypatch.setattr(tools, "BLOCK_ELEMENTS", 3 * 8 * 4)
    blocks = list(tools.axis_blocks(21, 3 * 8, tools.BLOCK_ELEMENTS))
    assert len(blocks) == 6
    out = vis.clone()
    tools.apply_gain(out, g, out=out)
    assert torch.equal(out, whole)


def test_extract_diagonal_and_unpack_match_jax():
    rng = np.random.Generator(np.random.SFC64(3))
    n, nprod = 6, 21
    ut = (rng.standard_normal((2, nprod, 3)) + 1j * rng.standard_normal((2, nprod, 3))).astype(np.complex64)
    assert np.array_equal(tools.extract_diagonal(torch.from_numpy(ut)).numpy(), np.asarray(jtools.extract_diagonal(ut)))
    got = tools.unpack_product_array(torch.from_numpy(ut), axis=1)
    assert got.shape == (2, n, n, 3)
    assert np.array_equal(got.numpy(), np.asarray(jtools.unpack_product_array(ut, axis=1)))
    with pytest.raises(ValueError):
        tools.unpack_product_array(torch.zeros(2, 20))


def test_calculate_redundancy_matches_jax():
    rng = np.random.Generator(np.random.SFC64(4))
    ninput, nt = 5, 7
    flags = (rng.uniform(size=(ninput, nt)) > 0.3).astype(np.float32)
    prod = np.zeros(15, dtype=[("input_a", "<u2"), ("input_b", "<u2")])
    prod["input_a"], prod["input_b"] = np.triu_indices(ninput)
    stack = rng.integers(-1, 6, 15)  # -1: a product in no stack
    want = np.asarray(jtools.calculate_redundancy(flags, prod, stack, 6))
    assert np.array_equal(tools.calculate_redundancy(torch.from_numpy(flags), prod, stack, 6).numpy(), want)
    # all-zero flags count as ones; a time selection keeps the other samples' test
    zeros = np.zeros_like(flags)
    want = np.asarray(jtools.calculate_redundancy(zeros, prod, stack, 6))
    assert np.array_equal(tools.calculate_redundancy(torch.from_numpy(zeros), prod, stack, 6).numpy(), want)
    part = tools.calculate_redundancy(torch.from_numpy(flags), prod, stack, 6, times=slice(2, 5))
    assert np.array_equal(part.numpy(), np.asarray(jtools.calculate_redundancy(flags, prod, stack, 6))[:, 2:5])


# -- ops/random ----------------------------------------------------------------


def test_numpy_twins_match_jax_exactly():
    C = np.array([[2.0, 0.5 + 0.2j], [0.5 - 0.2j, 1.0]])
    for fn, jfn, args in (
        (trandom.complex_normal_np, jrandom.complex_normal_np, dict(size=(3, 4), scale=2.0)),
        (trandom.standard_complex_wishart_np, jrandom.standard_complex_wishart_np, dict(m=3, n=7)),
        (trandom.complex_wishart_np, jrandom.complex_wishart_np, dict(C=C, n=9)),
    ):
        got = fn(**args, rng=np.random.default_rng(5))
        assert np.array_equal(got, jfn(**args, rng=np.random.default_rng(5)))


def test_complex_normal_statistics():
    """N = 2^16 draws with E|x|^2 = 4: the sample mean of |x|^2 has relative
    standard error 1/sqrt(N) = 0.004 (|x|^2 is exponential), the bound is
    0.02 (5 sigma); |mean x| ~ 2/sqrt(N) = 0.008, bound 0.04."""
    g = torch.Generator().manual_seed(6)
    x = trandom.complex_normal((1 << 16,), loc=0.0, scale=2.0, generator=g)
    assert x.dtype == torch.complex64
    assert abs((x.abs() ** 2).mean().item() / 4.0 - 1.0) <= 0.02
    assert x.mean().abs().item() <= 0.04
    y = trandom.standard_complex_normal((4,), generator=torch.Generator().manual_seed(6), dtype=torch.complex128)
    assert y.dtype == torch.complex128


def test_complex_wishart_mean_and_variance():
    """N = 4000 draws of W ~ CW(n = 50, C), 4 x 4.  E W = n C and
    E|W_ij - n C_ij|^2 = n C_ii C_jj exactly.  The sample mean's error per
    entry is sqrt(n C_ii C_jj / N): held to 5 of those.  The sample variance
    over n C_ii C_jj has relative standard error ~ sqrt(2 / N) = 0.022 (an
    entry is near Gaussian at n = 50): held to 0.15."""
    rng = np.random.Generator(np.random.SFC64(7))
    X = rng.standard_normal((4, 8)) + 1j * rng.standard_normal((4, 8))
    C = X @ X.conj().T / 8 + np.eye(4)
    N, n = 4000, 50
    Cb = torch.from_numpy(np.broadcast_to(C, (N, 4, 4)).copy())
    W = trandom.complex_wishart(Cb, n, generator=torch.Generator().manual_seed(8)).numpy()
    d = np.real(np.diag(C))
    scale = n * np.sqrt(d[:, None] * d[None, :]) / n**0.5  # sqrt(n C_ii C_jj)
    assert (np.abs(W.mean(0) - n * C) <= 5 * scale / np.sqrt(N)).all()
    ratio = (np.abs(W - n * C) ** 2).mean(0) / scale**2
    assert np.abs(ratio - 1.0).max() <= 0.15
    # Hermitian, positive diagonal
    assert np.allclose(W, W.conj().transpose(0, 2, 1), atol=1e-9) and (np.real(np.einsum("nii->ni", W)) > 0).all()


# -- synthesis/noise -------------------------------------------------------------


def test_receiver_temperature_matches_jax():
    js, ts = _full_stream(jcontainers), _full_stream(containers)
    jout = _run(jnoise.ReceiverTemperature(), {"recv_temp": 50.0}, None, js)
    tout = _run(noise.ReceiverTemperature(), {"recv_temp": 50.0}, None, ts)
    assert tout is ts
    assert np.array_equal(tout.vis[:].numpy(), np.asarray(jout.vis[:]))


def test_gaussian_noise_weights_match_jax_and_noise_has_their_variance():
    """Weights exact against the JAX package.  The noise: 3 feeds x 512 RA
    samples; E|v|^2 = std^2 on the 3 cross products (1536 draws, relative
    standard error 0.026) and var = std^2 on the real autos (1536 draws,
    0.036): held to 0.2."""
    js = _full_stream(jcontainers, nfreq=1, nfeed=3, nra=512)
    ts = _full_stream(containers, nfreq=1, nfeed=3, nra=512)
    ts.vis[:] = 0.0
    cfg = {"recv_temp": 40.0, "ndays": 1.0, "seed": 1}
    jout = _run(jnoise.GaussianNoise(), cfg, (), js)
    tout = _run(noise.GaussianNoise(), cfg, (), ts)
    assert _rel(tout.weight[:], np.asarray(jout.weight[:])) <= TOL
    dt = 240 * (ts.ra[1] - ts.ra[0]) * noise.STELLAR_S
    std2 = 40.0**2 / int(dt * ts.index_map["freq"]["width"][0] * 1e6)
    vis = tout.vis[:].numpy()
    cross = vis[:, [1, 2, 4]]
    autos = vis[:, [0, 3, 5]]
    assert abs(np.mean(np.abs(cross) ** 2) / std2 - 1) <= 0.2
    assert np.all(autos.imag == 0) and abs(np.var(autos.real) / std2 - 1) <= 0.2


def test_gaussian_noise_dataset():
    """Weight 4 -> E|v|^2 = 0.25 on 3 x 256 cross draws (relative standard
    error 0.036): held to 0.2; autos real; the same seed gives the same draw."""
    outs = []
    for _ in range(2):
        ts = _full_stream(containers, nfreq=1, nfeed=3, nra=256)
        ts.weight[:] = 4.0
        outs.append(_run(noise.GaussianNoiseDataset(), {"seed": 2}, None, ts).vis[:].numpy())
    vis = outs[0]
    assert abs(np.mean(np.abs(vis[:, [1, 2, 4]]) ** 2) / 0.25 - 1) <= 0.2
    assert np.all(vis[:, [0, 3, 5]].imag == 0)
    assert np.array_equal(outs[0], outs[1])


def test_multiple_gaussian_noise_datasets():
    ts = _full_stream(containers, nfreq=1, nfeed=3, nra=8)
    task = noise.MultipleGaussianNoiseDatasets()
    task.read_config({"niter": 2, "seed": 3})
    task.setup(ts)
    outs = [task.next(), task.next()]
    with pytest.raises(PipelineStopIteration):
        task.next()
    assert outs[0] is not ts and not torch.equal(outs[0].vis[:], outs[1].vis[:])


def _noise_model(package, seed=9):
    nm = package.FreqNoiseModel(freq=np.linspace(700.0, 690.0, 3), ra=5, pol=np.array(["XX", "XY", "YX", "YY"]),
                                ew=np.arange(2), ns=np.arange(6))
    rng = np.random.Generator(np.random.SFC64(seed))
    nm.add_dataset("freq_cov")
    A = rng.standard_normal(nm.freq_cov.shape)
    nm.freq_cov[:] = np.tril(A)
    nm.redundancy[:] = rng.integers(1, 4, nm.redundancy.shape)
    nm.weight[:] = rng.uniform(0.5, 2.0, nm.weight.shape)
    return nm


def test_freq_correlated_noise():
    """Weights and redundancy exact against the JAX package; the EW = 0 plane
    obeys the Hermitian fix-up of every pol pair below the Nyquist entry
    (which the later pols of the loop overwrite), and a pol's own NS = 0
    entry is real."""
    jout = _run(jnoise.FreqCorrelatedNoise(), {"seed": 1, "save_redundancy": True}, None, _noise_model(jcontainers))
    tout = _run(noise.FreqCorrelatedNoise(), {"seed": 1, "save_redundancy": True}, None, _noise_model(containers))
    assert np.array_equal(tout.weight[:].numpy(), np.asarray(jout.weight[:]))
    assert np.array_equal(tout.datasets["redundancy"][:].numpy(), np.asarray(jout.datasets["redundancy"][:]))
    v = tout.vis[:].numpy()  # [pol, f, ew, ns, ra]
    assert v.shape == np.asarray(jout.vis[:]).shape
    nns = v.shape[3]
    nyp = nns // 2 + 1
    for pi, po in ((0, 0), (1, 2), (2, 1), (3, 3)):
        assert np.array_equal(v[po, :, 0, nns - 1 : nns - nyp + 1 : -1], v[pi, :, 0, 1 : nyp - 1].conj())
    assert np.all(v[[0, 3], :, 0, 0].imag == 0)


def _z_scores(expect, sample, nsamp):
    """z = (W - V) / sqrt(V_ii V_jj / n) of every cross product."""
    nfeed = int((2 * expect.shape[1]) ** 0.5)
    ia, ib = np.triu_indices(nfeed)
    cross = ia != ib
    diag = tools.cmap(np.arange(nfeed), np.arange(nfeed), nfeed)
    va = expect[:, diag[ia[cross]]].real
    vb = expect[:, diag[ib[cross]]].real
    return (sample[:, cross] - expect[:, cross]) / np.sqrt(va * vb / nsamp)


def test_sample_noise_wishart():
    """Both packages on the same expectation stream (4 feeds, 2 x 256 rows,
    n = sample_frac dt df ~ 1000): z = (W - V) / sqrt(V_ii V_jj / n) of a
    complex Wishart sample has E|z|^2 = 1 exactly.  3072 cross z's: the
    mean of |z|^2 has standard error ~1/sqrt(3072) = 0.018, held to 0.1;
    |mean z| ~ 0.018, held to 0.1.  Autos stay real and positive; the
    weights follow noise.py:347-357."""
    frac = 1000.0 / (240 * 360 / 256 * noise.STELLAR_S * 20e6)
    cfg = {"sample_frac": frac, "seed": 4}
    for package, mod in ((containers, noise), (jcontainers, jnoise)):
        task = mod.SampleNoise()
        ss = _full_stream(package, nfreq=2, nfeed=4, nra=256, seed=3)
        expect = np.asarray(ss.vis[:]).copy()
        dt, _ = mod._time_interval(ss)
        nsamp = (frac * dt * ss.index_map["freq"]["width"] * 1e6).astype(int)[:, None, None]
        out = _run(task, cfg, None, ss)
        vis = np.asarray(out.vis[:])
        assert np.isfinite(vis).all()
        z = _z_scores(expect, vis, nsamp)
        assert abs(np.mean(np.abs(z) ** 2) - 1) <= 0.1, package.__name__
        assert abs(np.mean(z)) <= 0.1, package.__name__
        autos = vis[:, tools.cmap(np.arange(4), np.arange(4), 4)]
        assert np.all(np.abs(autos.imag) <= 1e-6 * autos.real) and (autos.real > 0).all()
        wfac = np.sqrt(nsamp) / autos.real
        ia, ib = np.triu_indices(4)
        assert np.allclose(np.asarray(out.weight[:]), wfac[:, ia] * wfac[:, ib], rtol=1e-5)


def test_sample_noise_streaming_chunks(monkeypatch):
    """A budget of one row a chunk (2 x 128 rows): finite, autos real and
    positive, and the time mean of the sample within 0.1 + 0.1 |V| of the
    expectation (the per-row scatter is sqrt(V_ii V_jj / n) ~ 10 / 30)."""
    monkeypatch.setenv("DRACO_TPU_SAMPLENOISE_CHUNK_GB", "1e-6")
    ss = _full_stream(containers, nfreq=2, nfeed=3, nra=128, seed=3)
    expect = ss.vis[:].numpy().copy()
    frac = 1000.0 / (240 * 360 / 128 * noise.STELLAR_S * 20e6)
    vis = _run(noise.SampleNoise(), {"sample_frac": frac, "seed": 4}, None, ss).vis[:].numpy()
    assert np.isfinite(vis).all()
    autos = vis[:, tools.cmap(np.arange(3), np.arange(3), 3)]
    assert np.all(autos.imag == 0) or np.abs(autos.imag).max() <= 1e-6 * autos.real.max()
    assert (autos.real > 0).all()
    assert np.allclose(vis.mean(-1), expect.mean(-1), rtol=0.1, atol=0.1)


def test_sample_noise_chunking_invariant(monkeypatch):
    """The same seed gives bit-identical samples under any chunk budget:
    each row's generator is seeded from its global (freq, time) index."""

    def run(budget):
        monkeypatch.setenv("DRACO_TPU_SAMPLENOISE_CHUNK_GB", budget)
        ss = _full_stream(containers, nfreq=2, nfeed=3, nra=16, seed=3)
        return _run(noise.SampleNoise(), {"sample_frac": 1e-6, "seed": 4}, None, ss).vis[:].clone()

    assert torch.equal(run("2"), run("1e-6"))
    assert not torch.equal(run("2"), _run(
        noise.SampleNoise(), {"sample_frac": 1e-6, "seed": 5}, None, _full_stream(containers, 2, 3, 16, 3)
    ).vis[:])


def test_sample_noise_rejects_a_matrix_that_is_not_positive_definite():
    ss = _full_stream(containers, nfreq=1, nfeed=3, nra=4)
    ss.vis[:, 0] = -100.0  # a negative auto
    with pytest.raises(RuntimeError, match="Cholesky"):
        _run(noise.SampleNoise(), {"seed": 1}, None, ss)


# -- synthesis/gain --------------------------------------------------------------


def _dualpol(package):
    return package.PolarisedCylinderTelescope(
        num_cylinders=2, num_feeds=4, cylinder_width=10.0, cylinder_spacing=12.0, feed_spacing=1.0,
        latitude=45.0, freq_lower=400.0, freq_upper=420.0, num_freq=2, auto_correlations=True,
        force_lmax=23, force_mmax=23,
    )


@pytest.fixture(scope="module")
def dualpol():
    import draco_tpu.telescope as J

    from draco_tpu_torch import telescope as T

    return _dualpol(J), _dualpol(T)


def test_random_sidereal_gains_match_jax_exactly(dualpol):
    """Two LSDs of gains from one seed, the second conditioned on the first."""
    jtel, tel = dualpol
    cfg = {"seed": 7, "start_time": "2015-10-05 12:15:00", "end_time": "2015-10-07 12:15:00",
           "sigma_amp": 0.01, "sigma_phase": 0.02, "corr_length_amp": 3000.0, "corr_length_phase": 5000.0}
    outs = []
    for package, task_cls, t in ((jcontainers, jgain.RandomSiderealGains, jtel), (containers, gain.RandomSiderealGains, tel)):
        ss = package.SiderealStream(freq=t.frequencies, input=t.nfeed, ra=32)
        task = task_cls()
        task.read_config(cfg)
        task.setup(t, ss)
        outs.append([task.process(), task.process()])
        with pytest.raises((PipelineStopIteration, jtask.PipelineStopIteration)):
            task.process()
    for jg, tg in zip(*outs):
        assert isinstance(tg, containers.SiderealGainData) and tg.attrs["lsd"] == jg.attrs["lsd"]
        assert np.array_equal(tg.gain[:].numpy(), np.asarray(jg.gain[:]))


def test_random_gains_on_a_time_stream_match_jax_exactly():
    outs = []
    for package, task_cls in ((jcontainers, jgain.RandomGains), (containers, gain.RandomGains)):
        task = task_cls()
        task.read_config({"seed": 5, "sigma_amp": 0.05, "sigma_phase": 0.02, "amp": True, "phase": True})
        gains = []
        for t0 in (0.0, 640.0):
            ts = package.TimeStream(freq=np.array([800.0, 790.0]), input=4, time=t0 + np.arange(64.0) * 10.0)
            gains.append(np.asarray(task.process(ts).gain[:]))
        outs.append(gains)
    for j, t in zip(*outs):
        assert np.array_equal(t, j)


@pytest.mark.parametrize("conditioned", [False, True])
def test_gaussian_process_draws_match_jax_exactly(conditioned):
    x = np.linspace(0.0, 1000.0, 40)
    cov = gain.squared_exponential(200.0, 0.5)
    jcov = jgain.squared_exponential(200.0, 0.5)
    prev = np.random.default_rng(1).standard_normal((3, 40)) if conditioned else None
    px = x - 1000.0 if conditioned else None
    got = gain.generate_fluctuations(x, cov, 3, px, prev, rng=np.random.default_rng(2))
    want = jgain.generate_fluctuations(x, jcov, 3, px, prev, rng=np.random.default_rng(2))
    assert np.array_equal(got, want)
    assert np.array_equal(
        gain.gaussian_realisation(x, cov, 2, rng=np.random.default_rng(3)),
        jgain.gaussian_realisation(x, jcov, 2, rng=np.random.default_rng(3)),
    )


@pytest.mark.parametrize("only_gains", [False, True])
def test_gain_stacker_matches_jax(only_gains):
    outs = []
    for package, mod in ((jcontainers, jgain), (containers, gain)):
        ss = _full_stream(package, nfreq=1, nfeed=3, nra=8)
        task = mod.GainStacker()
        task.read_config({"only_gains": only_gains})
        task.setup(ss)
        rng = np.random.Generator(np.random.SFC64(4))
        for day in range(3):
            g = package.SiderealGainData(freq=ss.freq, input=3, ra=8)
            g.gain[:] = 1.0 + 0.1 * (rng.standard_normal((1, 3, 8)) + 1j * rng.standard_normal((1, 3, 8)))
            g.attrs["lsd"] = day
            assert task.process(g) is None
        outs.append(task.process_finish())
    jout, tout = outs
    assert _rel(tout.vis[:], np.asarray(jout.vis[:])) <= TOL
    assert np.array_equal(tout.weight[:].numpy(), np.asarray(jout.weight[:]))


# -- ops/median --------------------------------------------------------------------


def test_weighted_medians_match_jax():
    rng = np.random.Generator(np.random.SFC64(5))
    x = rng.standard_normal((4, 30))
    w = (rng.uniform(size=(4, 30)) > 0.3) * rng.uniform(0.5, 2.0, (4, 30))
    w[1] = 0.0  # a row with no valid samples
    assert np.array_equal(median.weighted_median(x, w), jmedian.weighted_median(x, w))
    assert np.array_equal(median.quantile(x, w, 0.3), jmedian.quantile(x, w, 0.3))
    got = median.moving_weighted_median(x, w, (1, 5))
    assert np.allclose(got, jmedian.moving_weighted_median(x, w, (1, 5)), rtol=0, atol=1e-15)
    assert np.allclose(median.moving_weighted_median(x[0], w[0], 3), jmedian.moving_weighted_median(x[0], w[0], 3))


# -- synthesis/mockcatalog -----------------------------------------------------------


def _catalog(package, nsrc=2000, seed=11):
    rng = np.random.Generator(np.random.SFC64(seed))
    cat = package.SpectroscopicCatalog(object_id=np.arange(nsrc))
    pos = np.zeros(nsrc, dtype=[("ra", np.float64), ("dec", np.float64)])
    pos["ra"] = rng.uniform(0, 180.0, nsrc)
    pos["dec"] = rng.uniform(-30.0, 60.0, nsrc)
    red = np.zeros(nsrc, dtype=[("z", np.float64), ("z_error", np.float64)])
    red["z"] = rng.uniform(0.9, 2.4, nsrc)
    red["z_error"] = 0.01
    cat["position"][:] = pos
    cat["redshift"][:] = red
    cat.attrs["tag"] = "qso_mock"
    return cat


def _zmap(package, mod, nside=8, nz=8, seed=12):
    zlims = np.linspace(0.9, 2.4, nz + 1)
    freq = mod._zlims_to_freq(0.5 * (zlims[:-1] + zlims[1:]), zlims)
    m = package.Map(nside=nside, polarisation=False, freq=freq)
    m.map[:] = np.random.Generator(np.random.SFC64(seed)).uniform(0.0, 1.0, m.map.shape)
    return m


def _mock_case(name, package, mod):
    if name == "SelectionFunctionEstimator":
        return _run(mod.SelectionFunctionEstimator(), {"nside": 8, "n_z": 8, "n_modes": 3, "tracer": "QSO"},
                    None, _catalog(package))
    if name == "ResizeSelectionFunctionMap":
        sf = _run(mod.SelectionFunctionEstimator(), {"nside": 8, "n_z": 8, "n_modes": 3}, None, _catalog(package))
        return _run(mod.ResizeSelectionFunctionMap(), {"smooth": True}, None, sf, _zmap(package, mod, 16, 12))
    if name == "PdfGeneratorUncorrelated":
        return _run(mod.PdfGeneratorUncorrelated(), {}, None, _zmap(package, mod))
    if name == "PdfGeneratorWithSelectionFunction":
        return _run(mod.PdfGeneratorWithSelectionFunction(), {"tracer": "QSO"}, None,
                    _zmap(package, mod), _zmap(package, mod, seed=13))
    if name == "PdfGeneratorNoSelectionFunction":
        return _run(mod.PdfGeneratorNoSelectionFunction(), {"use_voxel_volumes": True}, None, _zmap(package, mod))
    if name == "MockCatalogGenerator":
        task = mod.MockCatalogGenerator()
        task.read_config({"nsource": 500, "ncat": 1, "seed": 3})
        task.setup(_zmap(package, mod))
        return task.process()
    if name.startswith("AddEBOSSZErrorsToCatalog"):
        tracer = name.split(":")[1]
        return _run(mod.AddEBOSSZErrorsToCatalog(), {"tracer": tracer, "seed": 6}, None, _catalog(package))
    if name == "AddGaussianZErrorsToCatalog":
        return _run(mod.AddGaussianZErrorsToCatalog(), {"sigma": 0.01, "sigma_type": "sigma_z_over_1plusz", "seed": 5},
                    None, _catalog(package))
    if name == "MapPixelLocationGenerator":
        task = mod.MapPixelLocationGenerator()
        task.read_config({"freq_idx": 1})
        task.setup(_zmap(package, mod, nside=4))
        return task.process()
    raise AssertionError(name)


@pytest.mark.parametrize("name", [
    "SelectionFunctionEstimator", "ResizeSelectionFunctionMap", "PdfGeneratorUncorrelated",
    "PdfGeneratorWithSelectionFunction", "PdfGeneratorNoSelectionFunction", "MockCatalogGenerator",
    "AddGaussianZErrorsToCatalog", "AddEBOSSZErrorsToCatalog:QSO", "AddEBOSSZErrorsToCatalog:QSOalt",
    "AddEBOSSZErrorsToCatalog:ELG", "AddEBOSSZErrorsToCatalog:LRG", "MapPixelLocationGenerator",
])
def test_mockcatalog_matches_jax(name):
    """Catalogues exactly (host draws from the same seed); maps exactly, or
    to 1e-12 of their peak where the smoothing runs an SHT."""
    jout = _mock_case(name, jcontainers, jmock)
    tout = _mock_case(name, containers, mockcatalog)
    assert type(tout).__name__ == type(jout).__name__
    assert {k: v for k, v in tout.attrs.items()} == {k: v for k, v in jout.attrs.items()}
    if isinstance(tout, containers.Map):
        tol = 1e-12 if name == "ResizeSelectionFunctionMap" else 0.0
        assert _rel(tout.map[:], np.asarray(jout.map[:])) <= tol
        return
    for ds in ("position", "redshift"):
        assert np.array_equal(tout[ds][:], np.asarray(jout[ds][:])), ds


# -- the port stands alone -------------------------------------------------------


def test_synthesis_modules_import_no_jax():
    """Each module of this slice, imported alone in a fresh process, pulls in
    neither jax nor draco_tpu."""
    modules = [
        "draco_tpu_torch.ops.random", "draco_tpu_torch.ops.median", "draco_tpu_torch.ops.cosmology",
        "draco_tpu_torch.ops.tools", "draco_tpu_torch.synthesis.noise", "draco_tpu_torch.synthesis.gain",
        "draco_tpu_torch.synthesis.skymodel", "draco_tpu_torch.synthesis.mockcatalog",
        "draco_tpu_torch.analysis.calibration", "draco_tpu_torch.analysis.transform",
    ]
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'draco_tpu') or m.startswith(('jax.', 'draco_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, env=dict(os.environ, PYTHONPATH=root),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
