"""CUDA kernels of draco_tpu_torch against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  This
file imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernel against its plain version in float64 on the same
inputs, max|diff| / max|ref| <= 1e-5 for the float32 kernel (float32 sums)
and <= 1e-12 for the float64 kernel; the band-end zeros exactly.  The
beamforming kernel against its plain version on the same float32 inputs,
<= 1e-5 of the largest sum (their sine and cosine routines and summation
orders differ).
"""

import numpy as np
import pytest
import torch

from draco_tpu_torch.ops import banded, cuda_kernels, regrid, tools

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel(got, ref):
    return ((got.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


def _lanczos_R(m, n, a=5, seed=4, permute=False):
    """A Lanczos regrid matrix [m, n] with empty pad rows, as the regridder
    builds it; with ``permute`` its columns are shuffled, so that every
    tile's sample window is full width."""
    rng = np.random.Generator(np.random.SFC64(seed))
    samples = np.sort(rng.uniform(0, 1, n))
    R = regrid.lanczos_forward_matrix(np.linspace(-0.1, 1.1, m), samples, a=a).T
    if permute:
        R = R[:, rng.permutation(n)]
    return torch.from_numpy(np.ascontiguousarray(R))


def _check(cuda, R, Ni, bw, dtype):
    R, Ni = R.to(dtype).to(cuda), Ni.to(dtype).to(cuda)
    before = cuda_kernels.launches["banded_covariance"]
    out = cuda_kernels.banded_covariance_batched(R, Ni, bw)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["banded_covariance"] == before + 1
    ref = banded.banded_covariance(R.double(), Ni.double(), bw)
    m = R.shape[0]
    assert out.shape == (Ni.shape[0], bw + 1, m) and out.dtype == dtype
    assert _rel(out, ref) <= TOL[dtype]
    for d in range(bw + 1):
        assert (out[:, d, max(m - d, 0) :] == 0).all()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "m,n,B,bw",
    [(300, 1000, 5, 9), (128, 64, 2, 0), (97, 130, 3, 31), (2, 77, 1, 4), (300, 1000, 70, 33), (30, 100, 3, 40)],
)
def test_banded_covariance_kernel_matches_plain(cuda, m, n, B, bw, dtype):
    g = torch.Generator(device="cpu").manual_seed(m * n + bw)
    R = torch.randn(m, n, generator=g)
    Ni = torch.rand(B, n, generator=g)
    Ni[:, n // 3 : n // 3 + 5] = 0.0
    _check(cuda, R, Ni, bw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("permute", [False, True])
@pytest.mark.parametrize("m,n,B,bw", [(300, 1000, 37, 9), (300, 1000, 5, 33), (20, 500, 4, 9)])
def test_banded_covariance_kernel_on_a_lanczos_band(cuda, m, n, B, bw, permute, dtype):
    R = _lanczos_R(m, n, permute=permute)
    Ni = torch.from_numpy(np.random.Generator(np.random.SFC64(m + B)).uniform(0.5, 2.0, (B, n)))
    _check(cuda, R, Ni, bw, dtype)


def test_banded_covariance_kernel_is_deterministic(cuda):
    R = _lanczos_R(300, 1000).float().to(cuda)
    Ni = torch.rand(70, 1000, device=cuda)
    a = cuda_kernels.banded_covariance_batched(R, Ni, 9)
    b = cuda_kernels.banded_covariance_batched(R, Ni, 9)
    assert torch.equal(a, b)


def test_banded_covariance_kernel_rejects_what_it_does_not_take(cuda):
    R = torch.randn(40, 64, device=cuda)
    Ni = torch.rand(3, 64, device=cuda)
    with pytest.raises(TypeError):
        cuda_kernels.banded_covariance_batched(R.half(), Ni.half(), 3)
    with pytest.raises(TypeError):
        cuda_kernels.banded_covariance_batched(R, Ni.double(), 3)
    with pytest.raises(ValueError):
        cuda_kernels.banded_covariance_batched(R.T.contiguous().T, Ni, 3)
    with pytest.raises(ValueError):
        cuda_kernels.banded_covariance_batched(R, Ni.cpu(), 3)


@pytest.mark.parametrize(
    "a,ydtype", [(5, torch.complex64), (5, torch.complex128), (17, torch.complex64), (17, torch.complex128)]
)
def test_band_wiener_on_the_card_matches_the_cpu(cuda, a, ydtype):
    rng = np.random.Generator(np.random.SFC64(4))
    m, n, k, bw = 120, 500, 4, 2 * a - 1
    grid = np.linspace(0, 1, m)
    R = regrid.lanczos_forward_matrix(grid, np.sort(rng.uniform(0, 1, n)), a=a).T
    R = torch.as_tensor(R, dtype=torch.float64)
    Ni = torch.as_tensor(rng.uniform(0.5, 2.0, (k, n)))
    y = torch.as_tensor(rng.standard_normal((k, n)) + 1j * rng.standard_normal((k, n)))
    Si = torch.full((m,), 1e-1, dtype=torch.float64)
    xh, nw = regrid.band_wiener(R, Ni, Si, y, bw)
    rdt = torch.float64 if ydtype == torch.complex128 else torch.float32
    before = cuda_kernels.launches["banded_covariance"]
    xg, ng = regrid.band_wiener(
        R.to(rdt).to(cuda), Ni.to(rdt).to(cuda), Si.to(rdt).to(cuda), y.to(ydtype).to(cuda), bw
    )
    assert cuda_kernels.launches["banded_covariance"] == before + 1
    assert xg.dtype == ydtype and ng.dtype == rdt
    # the card's banded solve in its own type against float64 on the CPU
    tol = 1e-5 if rdt == torch.float32 else 1e-10
    assert _rel(ng.cpu(), nw) <= tol
    assert _rel(torch.view_as_real(xg.cpu()), torch.view_as_real(xh)) <= tol


def _cylinder_bt(nside=16):
    from draco_tpu_torch.telescope import BeamTransfer, UnpolarisedCylinderTelescope

    tel = UnpolarisedCylinderTelescope(
        num_cylinders=2, cylinder_width=10.0, cylinder_spacing=12.0, num_feeds=3, feed_spacing=2.0,
        latitude=45.0, freq_lower=400.0, freq_upper=500.0, num_freq=2, auto_correlations=True,
        force_lmax=3 * nside - 1, force_mmax=3 * nside - 1,
    )
    return BeamTransfer(tel, nside=nside)


def test_prepare_state_defaults_to_the_card(cuda):
    from draco_tpu_torch.telescope import roundtrip

    state = roundtrip.prepare_state(_cylinder_bt(), chunk=4)
    assert state["form"] == "fullsphere"
    for name in ("va", "u_re", "bla", "uidx"):
        assert state[name].device == cuda, name
    assert state["lam"]["belt"].device == cuda and state["plan"]["W"][0].device == cuda


@pytest.mark.parametrize("weighted", [False, True])
def test_fullsphere_round_trip_on_the_card_matches_the_cpu(cuda, weighted):
    """float32 on the card against float32 on the CPU: only the order of
    the sums differs, max|diff| / max|ref| <= 1e-5."""
    from draco_tpu_torch.telescope import roundtrip

    bt = _cylinder_bt()
    tel = bt.telescope
    rng = np.random.Generator(np.random.SFC64(21))
    sky = rng.standard_normal((tel.nfreq, 1, 12 * 16**2)).astype(np.float32)
    w = None
    if weighted:
        w = rng.uniform(0.5, 2.0, (tel.mmax + 1, 2, tel.nfreq, len(tel.uniquepairs))).astype(np.float32)
    on_card = roundtrip.fused_simulate_to_map(bt, sky, chunk=4, weight=w)
    on_cpu = roundtrip.fused_simulate_to_map(bt, sky, chunk=4, weight=w, device="cpu")
    assert on_card.device == cuda and on_card.dtype == torch.float32
    assert _rel(on_card.cpu(), on_cpu) <= 1e-5


def test_generate_and_streaming_on_the_card_match_the_cpu(cuda):
    from draco_tpu_torch.ops import sht

    sky = np.random.Generator(np.random.SFC64(5)).standard_normal((2, 1, 12 * 16**2)).astype(np.float32)
    out = {}
    for device in (cuda, torch.device("cpu")):
        bt = _cylinder_bt()
        bt.generate(device=device)
        alm = sht.sphtrans_sky(sky, device=device)
        vis = bt.project_sky_to_telescope_streaming(alm)
        assert bt._bp.device == device and vis.device == device
        out[device.type] = (bt._bp.cpu(), vis.cpu())
    for card, cpu in zip(out["cuda"], out["cpu"]):
        assert _rel(torch.view_as_real(card), torch.view_as_real(cpu)) <= 1e-5


def test_containers_default_to_the_card(cuda):
    from draco_tpu_torch.core import containers

    ss = containers.SiderealStream(freq=np.array([400.0, 410.0]), input=3, ra=8)
    assert ss.device == cuda
    assert ss.vis[:].device == cuda and ss.weight[:].device == cuda
    ss.vis[:] = np.ones(ss.vis.shape)
    host = np.asarray(ss.vis)
    assert isinstance(host, np.ndarray) and host.shape == ss.vis.shape and (host == 1).all()
    assert containers.empty_like(ss).device == cuda


def _chain_b(device, nside=16):
    """SimulateSidereal -> MModeTransform -> DirtyMapMaker, all streaming,
    on ``device``."""
    from draco_tpu_torch.analysis.mapmaker import DirtyMapMaker
    from draco_tpu_torch.analysis.transform import MModeTransform
    from draco_tpu_torch.core import containers
    from draco_tpu_torch.synthesis.stream import SimulateSidereal
    from draco_tpu_torch.telescope import BeamTransfer, UnpolarisedDishArray

    tel = UnpolarisedDishArray(
        grid_ew=2, grid_ns=2, spacing_ew=4.0, spacing_ns=4.0, latitude=30.0, freq_lower=400.0,
        freq_upper=500.0, num_freq=2, dish_width=8.0, auto_correlations=True,
        force_lmax=3 * nside - 1, force_mmax=3 * nside - 1,
    )
    bt = BeamTransfer(tel, nside=nside)
    sky = containers.Map(nside=nside, polarisation=False, freq=tel.frequencies, device=device)
    sky.map[:] = np.random.Generator(np.random.SFC64(16)).standard_normal(sky.map.shape)
    out = sky
    for task, params, setup in (
        (SimulateSidereal(), {"streaming": True, "baseline_chunk": 4}, (bt,)),
        (MModeTransform(), {}, (tel,)),
        (DirtyMapMaker(), {"nside": nside, "streaming": True, "baseline_chunk": 4}, (bt,)),
    ):
        task.read_config(params)
        task.setup(*setup)
        out = task.process(out)
    return out.map[:]


def test_task_chain_on_the_card_matches_the_cpu(cuda):
    """Chain B at nside 16: float32 on the card against float32 on the CPU,
    max|diff| / max|ref| <= 1e-5."""
    on_card = _chain_b(cuda)
    on_cpu = _chain_b(torch.device("cpu"))
    assert on_card.device == cuda
    assert _rel(on_card.cpu(), on_cpu) <= 1e-5


def _expectation_stream(device, nfeed, nra, seed=17):
    """A full-triangle stream of positive-definite expectation matrices
    V = X X^H / 2n + 10 I, one frequency of 20 MHz, on ``device``."""
    from draco_tpu_torch.core import containers

    rng = np.random.Generator(np.random.SFC64(seed))
    ss = containers.SiderealStream(freq=np.array([800.0, 780.0]), input=nfeed, ra=nra, device=device)
    iu = np.triu_indices(nfeed)
    X = rng.standard_normal((2, nra, nfeed, 2 * nfeed)) + 1j * rng.standard_normal((2, nra, nfeed, 2 * nfeed))
    V = X @ X.conj().transpose(0, 1, 3, 2) / (2 * nfeed) + 10 * np.eye(nfeed)
    ss.vis[:] = np.moveaxis(V[:, :, iu[0], iu[1]], 1, 2).astype(np.complex64)
    ss.weight[:] = 1.0
    return ss


def test_sample_noise_is_chunk_invariant_on_the_card(cuda, monkeypatch):
    """64 feeds, 2 x 12 rows: budgets of all rows and of one row a chunk give
    bit-identical samples (each row is drawn from its own seed and factored
    on its own)."""
    from draco_tpu_torch.synthesis.noise import SampleNoise

    def run(budget):
        monkeypatch.setenv("DRACO_TPU_SAMPLENOISE_CHUNK_GB", budget)
        task = SampleNoise()
        task.read_config({"seed": 3, "sample_frac": 1e-6})
        out = task.process(_expectation_stream(cuda, 64, 12))
        return out.vis[:]

    whole, rows = run("2"), run("1e-4")
    assert whole.device == cuda and torch.isfinite(torch.view_as_real(whole)).all()
    assert torch.equal(whole, rows)


def test_sample_noise_statistics_on_the_card(cuda):
    """64 feeds x 2 x 64 rows, n ~ 1000: z = (W - V) / sqrt(V_ii V_jj / n)
    of the 258,048 cross products has E|z|^2 = 1; the sample mean's
    standard error is ~0.002 (rows of one matrix are weakly correlated),
    held to 0.02, and |mean z| to 0.02.  Autos real and positive."""
    from draco_tpu_torch.ops import tools
    from draco_tpu_torch.synthesis.noise import STELLAR_S, SampleNoise

    ss = _expectation_stream(cuda, 64, 64)
    expect = ss.vis[:].clone()
    frac = 1000.0 / (240 * 360 / 64 * STELLAR_S * 20e6)
    task = SampleNoise()
    task.read_config({"seed": 4, "sample_frac": frac})
    vis = task.process(ss).vis[:]
    n = int(frac * 240 * 360 / 64 * STELLAR_S * 20e6)
    ia, ib = np.triu_indices(64)
    cross = torch.as_tensor(np.flatnonzero(ia != ib), device=cuda)
    diag = tools.cmap(np.arange(64), np.arange(64), 64)
    va = expect[:, torch.as_tensor(diag[ia[ia != ib]], device=cuda)].real
    vb = expect[:, torch.as_tensor(diag[ib[ia != ib]], device=cuda)].real
    z = (vis[:, cross] - expect[:, cross]).to(torch.complex128) / (va * vb / n).double().sqrt()
    assert abs((z.abs() ** 2).mean().item() - 1.0) <= 0.02
    assert z.mean().abs().item() <= 0.02
    autos = tools.extract_diagonal(vis)
    assert (autos.real > 0).all() and (autos.imag.abs() <= 1e-5 * autos.real).all()


def test_complex_wishart_statistics_on_the_card(cuda):
    """N = 4000 draws of CW(n = 50, C), 4 x 4, from a card generator: the
    sample mean within 5 standard errors sqrt(n C_ii C_jj / N) of n C and
    E|W_ij - n C_ij|^2 / (n C_ii C_jj) within 0.15 of 1 (standard error
    ~0.022)."""
    from draco_tpu_torch.ops import random as trandom

    rng = np.random.Generator(np.random.SFC64(7))
    X = rng.standard_normal((4, 8)) + 1j * rng.standard_normal((4, 8))
    C = X @ X.conj().T / 8 + np.eye(4)
    N, n = 4000, 50
    Cb = torch.as_tensor(np.broadcast_to(C, (N, 4, 4)).copy(), device=cuda)
    W = trandom.complex_wishart(Cb, n, generator=torch.Generator(device=cuda).manual_seed(8))
    assert W.device == cuda
    W = W.cpu().numpy()
    d = np.real(np.diag(C))
    scale = np.sqrt(n * d[:, None] * d[None, :])
    assert (np.abs(W.mean(0) - n * C) <= 5 * scale / np.sqrt(N)).all()
    assert np.abs((np.abs(W - n * C) ** 2).mean(0) / scale**2 - 1.0).max() <= 0.15


def _band_limited(freq, ntime, delaycut, nbase, noise, seed=0):
    """``tests/test_delay.py``'s flat-delay-spectrum data below ``delaycut``,
    on a white floor 1e-2 of the band's power that the weights do not state:
    (data [nbase, ntime, nfreq] complex128, weight [nbase, nfreq]).  Without
    the floor the spectrum out of band has no power to find, and a float32
    chain shrinks it towards zero until 1 / S overflows."""
    rng = np.random.Generator(np.random.SFC64(seed))
    nfreq = len(freq)
    S = (np.abs(np.fft.fftfreq(nfreq, d=freq[1] - freq[0])) < delaycut) + 1e-2
    amp = (rng.standard_normal((nbase, ntime, nfreq)) + 1j * rng.standard_normal((nbase, ntime, nfreq))) * np.sqrt(S / 2)
    data = np.fft.fft(amp, axis=-1) + noise * (rng.standard_normal(amp.shape) + 1j * rng.standard_normal(amp.shape))
    return data, np.ones((nbase, nfreq)) / (2 * noise**2)


def test_batched_gibbs_on_the_card_matches_the_cpu_statistics(cuda):
    """64 channels, 8 baselines, 30 iterations from the same seeds: on the
    card (float32) and the CPU (float64) every chain separates in-band from
    out-of-band power by 20, and the in-band medians agree within 0.7-1.43.
    The card's generators draw other numbers than the CPU's; over 8 seeds on
    the CPU one chain's in-band median scattered by up to 0.058 in its log,
    so the log of the ratio of two has a spread up to 0.083: the bounds are
    4.3 of those."""
    from draco_tpu_torch.ops import delay as dops

    freq = np.linspace(400.0, 425.0, 65)
    data, weight = _band_limited(freq, 64, 0.4, 8, 0.1)
    S0 = np.full((8, 128), 10.0)
    kw = dict(niter=30, seeds=list(range(8)), batch=4)
    card, failed = dops.delay_power_spectrum_gibbs_batched(torch.as_tensor(data, device=cuda).to(torch.complex64), 128,
                                                           torch.as_tensor(weight, device=cuda), S0, **kw)
    cpu, _ = dops.delay_power_spectrum_gibbs_batched(torch.as_tensor(data), 128, torch.as_tensor(weight), S0, **kw)
    assert card.device == cuda and card.dtype == torch.float32 and not bool(failed.any())
    delays = np.fft.fftfreq(128, d=freq[1] - freq[0])
    inband, outband = np.abs(delays) < 0.3, np.abs(delays) > 0.6
    spec = {k: np.median(v[-15:].cpu().double().numpy(), axis=0) for k, v in (("card", card), ("cpu", cpu))}
    for s in spec.values():
        assert (np.median(s[:, inband], -1) > 20 * np.median(s[:, outband], -1)).all()
    r = np.median(spec["card"][:, inband], -1) / np.median(spec["cpu"][:, inband], -1)
    assert ((r > 0.7) & (r < 1.43)).all(), r


def test_batched_gibbs_does_not_depend_on_the_other_baselines_on_the_card(cuda):
    """7 baselines in batches of 2: a baseline run alone gives its chain
    again bit for bit."""
    from draco_tpu_torch.ops import delay as dops

    freq = np.linspace(400.0, 425.0, 65)
    data, weight = _band_limited(freq, 32, 0.4, 7, 0.1)
    d = torch.as_tensor(data, device=cuda).to(torch.complex64)
    S0 = np.full((7, 128), 10.0)
    every, _ = dops.delay_power_spectrum_gibbs_batched(d, 128, weight, S0, niter=6, seeds=list(range(10, 17)), batch=2)
    alone, _ = dops.delay_power_spectrum_gibbs_batched(d[5:6], 128, weight[5:6], S0[5:6], niter=6, seeds=[15], batch=2)
    assert torch.equal(alone[:, 0], every[:, 5])


def test_batched_cross_gibbs_on_the_card_matches_the_cpu_statistics(cuda):
    """Two nearly identical datasets on 3 baselines, 30 iterations, complex64
    on the card and complex128 on the CPU: the autos separate in from out of
    band by 20 on both, cross over auto within 0.9-1.1 in band, and the
    card's in-band autos within 0.5-2 of the CPU's.  The two chains draw
    different numbers (a card generator and a CPU one from the same seed);
    over 8 seeds on the CPU one chain's in-band median scattered by 0.10-0.15
    in its log, so the log of the ratio of two has a spread up to 0.21: the
    bounds are 3.3 of those."""
    from draco_tpu_torch.ops import delay as dops

    freq = np.linspace(400.0, 416.0, 17)
    d1, w1 = _band_limited(freq, 32, 0.35, 3, 0.01)
    d2 = d1 + 0.01 * np.random.Generator(np.random.SFC64(7)).standard_normal(d1.shape)
    data, Ni = np.stack([d1, d2], axis=1), np.stack([w1, w1], axis=1)
    S0 = np.broadcast_to(np.eye(2)[None, :, :, None] * 10.0, (3, 2, 2, 32)).copy()
    kw = dict(niter=30, seeds=[1, 2, 3], bchunk=2)
    card, failed = dops.delay_spectrum_gibbs_cross_batched(torch.as_tensor(data, device=cuda).to(torch.complex64), 32,
                                                           torch.as_tensor(Ni, device=cuda), S0, **kw)
    cpu, _ = dops.delay_spectrum_gibbs_cross_batched(torch.as_tensor(data), 32, torch.as_tensor(Ni), S0, **kw)
    assert card.device == cuda and card.dtype == torch.complex64 and not bool(failed.any())
    delays = np.fft.fftfreq(32, d=freq[1] - freq[0])
    inb, outb = np.abs(delays) < 0.25, np.abs(delays) > 0.45
    spec = {k: np.median(v[-15:].cpu().numpy(), axis=0) for k, v in (("card", card), ("cpu", cpu))}
    for s in spec.values():
        auto = s[:, 0, 0].real
        assert (np.median(auto[:, inb], -1) > 20 * np.median(auto[:, outb], -1)).all()
        ratio = np.median(s[:, 0, 1].real[:, inb], -1) / np.median(auto[:, inb], -1)
        assert ((ratio > 0.9) & (ratio < 1.1)).all()
    r = np.median(spec["card"][:, 0, 0].real[:, inb], -1) / np.median(spec["cpu"][:, 0, 0].real[:, inb], -1)
    assert ((r > 0.5) & (r < 2.0)).all(), r


# -- the ring-map and power-spectrum path: the card against the CPU --------------------------

def _rel_any(got, ref):
    """max|got - ref| / max|ref| of real or complex tensors, in float64."""
    wide = torch.complex128 if ref.is_complex() else torch.float64
    got, ref = got.to(wide), ref.to(wide)
    return ((got - ref).abs().max() / ref.abs().max()).item()


RING_CYL = dict(
    num_cylinders=2, num_feeds=4, feed_spacing=1.0, cylinder_spacing=10.0, cylinder_width=10.0, latitude=45.0,
    freq_lower=500.0, freq_upper=520.0, num_freq=4, auto_correlations=True,
)


def _ring_stream(device, tel, nra=32, seed=23):
    from draco_tpu_torch.core import containers

    prod = np.array([[int(a), int(b)] for a, b in tel.uniquepairs])
    ss = containers.SiderealStream(freq=tel.frequencies, input=tel.nfeed, ra=nra, prod=prod, device=device)
    rng = np.random.Generator(np.random.SFC64(seed))
    shape = ss.vis.shape
    ss.vis[:] = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    weight = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    weight[1, 3] = 0.0
    ss.weight[:] = weight
    ss.input_flags[:] = np.ones(ss.input_flags.shape, dtype=np.float32)
    return ss


def _run_task(task, params, setup, *inputs):
    task.read_config(params)
    if setup is not None:
        task.setup(*setup)
    return task.process(*inputs)


@pytest.mark.parametrize("weight", ["natural", "hann"])
def test_ring_map_maker_on_the_card_matches_the_cpu(cuda, weight):
    """MakeVisGrid -> BeamformNS (precision 64) -> BeamformEW: the grid
    exactly, the hybrid stream and the ring map within 1e-6."""
    from draco_tpu_torch.analysis import ringmapmaker as rmm
    from draco_tpu_torch.telescope import PolarisedCylinderTelescope

    tel = PolarisedCylinderTelescope(**RING_CYL)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        grid = _run_task(rmm.MakeVisGrid(), {}, (tel,), _ring_stream(dev, tel))
        hv = _run_task(rmm.BeamformNS(), {"npix": 64, "weight": weight, "save_dirty_beam": True}, None, grid)
        rm = _run_task(rmm.BeamformEW(), {}, None, hv)
        out[dev.type] = (grid, hv, rm)
    (grid, hv, rm), (cgrid, chv, crm) = out["cuda"], out["cpu"]
    assert rm.map[:].device == cuda
    assert torch.equal(grid.vis[:].cpu(), cgrid.vis[:]) and torch.equal(grid.redundancy[:].cpu(), cgrid.redundancy[:])
    for name in ("vis", "vis_weight", "dirty_beam"):
        assert _rel_any(hv.datasets[name][:].cpu(), chv.datasets[name][:]) <= 1e-6, name
    for name in ("map", "weight", "rms", "dirty_beam"):
        assert _rel_any(rm.datasets[name][:].cpu(), crm.datasets[name][:]) <= 1e-6, name


def _hybrid_mmodes_on(device, mmax=16, seed=5):
    from draco_tpu_torch.core import containers

    hv = containers.HybridVisMModes(
        mmax=mmax, oddra=False, freq=np.array([500.0, 510.0]), pol=np.array(["XX", "YY"]), ew=np.array([0.0, 20.0]),
        el=np.linspace(-0.2, 0.2, 4), device=device,
    )
    rng = np.random.Generator(np.random.SFC64(seed))
    shape = hv.vis.shape
    hv.vis[:] = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    hv.weight[:] = rng.uniform(0.5, 2.0, hv.weight.shape).astype(np.float32)
    return hv


@pytest.mark.parametrize("maker", ["WienerRingMapMakerAnalytical", "TikhonovRingMapMakerAnalytical"])
def test_deconvolving_maker_on_the_card_matches_the_cpu(cuda, maker):
    """The analytical beam's m-modes and the deconvolved map, weight and
    dirty-beam power within 1e-6 (complex128 in both; the beam stored complex64)."""
    from draco_tpu_torch.analysis import ringmapmaker as rmm
    from draco_tpu_torch.telescope import PolarisedCylinderTelescope

    tel = PolarisedCylinderTelescope(**dict(RING_CYL, cylinder_spacing=20.0, num_freq=2))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        out[dev.type] = _run_task(getattr(rmm, maker)(), {"save_dirty_beam": True}, (tel,), _hybrid_mmodes_on(dev))
    assert out["cuda"].map[:].device == cuda
    for name in ("map", "weight", "dirty_beam_power", "dirty_beam"):
        assert _rel_any(out["cuda"].datasets[name][:].cpu(), out["cpu"].datasets[name][:]) <= 1e-6, name


def _hybrid_stream_on(device, tel, nra=8, seed=8):
    from draco_tpu_torch.core import containers

    hv = containers.HybridVisStream(
        freq=tel.frequencies, pol=np.array(["XX", "YY"]), ew=np.array([0.0, 20.0]), el=np.linspace(-0.3, 0.3, 5),
        ra=nra, device=device,
    )
    rng = np.random.Generator(np.random.SFC64(seed))
    w = rng.uniform(0.5, 2.0, hv.weight.shape)
    w[0, 1, 0, 3] = 0.0
    hv.weight[:] = w.astype(np.float32)
    hv.attrs.update(beamform_ns_weight="natural", beamform_ns_include_auto=False, beamform_ns_scaled=False,
                    beamform_ns_freqmin=float(tel.frequencies.min()), beamform_ns_nsmax=1.0)
    nf = len(tel.frequencies)
    a = rng.standard_normal((2, 2, nra, nf, nf))
    hv.add_dataset("freq_cov")
    hv.freq_cov[:] = np.moveaxis(np.einsum("pxrij,pxrkj->pxrik", a, a) + nf * np.eye(nf), (3, 4), (1, 2))
    return hv


def test_reconstruct_vis_freq_cov_on_the_card_matches_the_cpu(cuda):
    """The batched cuSOLVER Cholesky against the CPU's within 1e-10 (float64),
    and a failed factorisation raises on the card too."""
    from draco_tpu_torch.analysis import ringmapmaker as rmm
    from draco_tpu_torch.telescope import PolarisedCylinderTelescope

    tel = PolarisedCylinderTelescope(**dict(RING_CYL, num_feeds=3, feed_spacing=0.5, cylinder_spacing=20.0))
    card = _run_task(rmm.ReconstructVisFreqCov(), {}, (tel,), _hybrid_stream_on(cuda, tel))
    cpu = _run_task(rmm.ReconstructVisFreqCov(), {}, (tel,), _hybrid_stream_on(torch.device("cpu"), tel))
    assert card.freq_cov[:].device == cuda
    assert _rel_any(card.freq_cov[:].cpu(), cpu.freq_cov[:]) <= 1e-10
    assert _rel_any(card.weight[:].cpu(), cpu.weight[:]) <= 1e-6
    bad = _hybrid_stream_on(cuda, tel)
    bad.freq_cov[0, 1, 1, 0, 2] = -5.0
    with pytest.raises(RuntimeError, match="Cholesky factorisation failed"):
        _run_task(rmm.ReconstructVisFreqCov(), {}, (tel,), bad)


def test_wiener_delay_transform_on_the_card_matches_the_cpu(cuda):
    """The Wiener operator (batched ``inv_ex`` in complex128, stored
    complex64) within 1e-6, the applied transform within 1e-5 and the
    spatial transform within 1e-5 of the CPU's, with two masked channels."""
    from draco_tpu_torch.analysis import powerspec as ps
    from draco_tpu_torch.core import containers
    from draco_tpu_torch.telescope import UnpolarisedDishArray

    freq = np.linspace(500.0, 532.0, 32, endpoint=False)
    tel = UnpolarisedDishArray(grid_ew=2, grid_ns=2, spacing_ew=20.0, spacing_ns=6.0, latitude=45.0,
                               freq_lower=500.0, freq_upper=532.0, num_freq=2, auto_correlations=True)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        rng = np.random.Generator(np.random.SFC64(3))
        rm = containers.RingMap(freq=freq, beam=np.arange(1), pol=np.array(["XX", "YY"]), ra=8,
                                el=np.linspace(-0.05, 0.05, 5), device=dev)
        rm.map[:] = np.cos(2 * np.pi * 5 / 32 * freq)[None, None, :, None, None] + 0.1 * rng.standard_normal(rm.map.shape)
        w = rng.uniform(0.5, 2.0, rm.weight.shape)
        w[:, 10:12] = 0.0
        rm.weight[:] = w
        for name in ("filter", "freq_cov"):
            rm.add_dataset(name)
            rm.datasets[name][:] = np.broadcast_to(np.eye(32)[None, :, :, None], rm.datasets[name].shape)
        rm.add_dataset("dirty_beam_power")
        rm.dirty_beam_power[:] = rng.uniform(0.5, 1.5, rm.dirty_beam_power.shape)
        op = _run_task(ps.ConstructWienerDelayTransform(), {"prior_amp": 100.0}, None, rm)
        ds = _run_task(ps.ApplyWienerDelayTransform(), {}, None, rm, op)
        cube = _run_task(ps.SpatialTransformDelayMap(), {"ew_min": 0.0, "ew_max": 10.0, "ns_bl": 10.0}, (tel,), ds)
        out[dev.type] = (op, ds, cube)
    (op, ds, cube), (cop, cds, ccube) = out["cuda"], out["cpu"]
    assert op.filter[:].device == cuda and cube.vis[:].device == cuda
    assert _rel_any(op.filter[:].cpu(), cop.filter[:]) <= 1e-6
    assert _rel_any(ds.spectrum[:].cpu(), cds.spectrum[:]) <= 1e-5
    assert _rel_any(cube.vis[:].cpu(), ccube.vis[:]) <= 1e-5


def _beamform_inputs(seed, nfreq=3, nra=50, nprod=45, S=5, nha=11, dev="cpu"):
    """Seeded inputs of the beamforming kernel: one window across the RA
    wrap, zero weights (a whole RA row, a whole product, single cells),
    nprod not a multiple of 32; vis complex64, the rest float32.  A window
    longer than nra wraps more than once."""
    rng = np.random.Generator(np.random.SFC64(seed))
    vis = (rng.standard_normal((nfreq, nra, nprod)) + 1j * rng.standard_normal((nfreq, nra, nprod))).astype(np.complex64)
    sw = rng.uniform(0.5, 2.0, (nfreq, nra, nprod)).astype(np.float32)
    sw[0, 3] = 0.0
    sw[:, :, 5] = 0.0
    vw = rng.uniform(0.5, 2.0, (nfreq, nra, nprod)).astype(np.float32)
    vw[1, 10, :4] = 0.0
    start = rng.integers(0, max(1, nra - nha), S)
    start[0] = nra - nha // 2
    ra_idx = ((start[:, None] + np.arange(nha)) % nra).astype(np.int32)
    ha = rng.uniform(-0.1, 0.1, (S, nha))
    dec = np.radians(rng.uniform(20, 70, (S, 1)))
    lat = np.radians(49.0)
    a = (np.cos(dec) * np.sin(ha)).astype(np.float32)
    b = (np.cos(lat) * np.sin(dec) - np.sin(lat) * np.cos(dec) * np.cos(ha)).astype(np.float32)
    # CHIME-like baselines: up to ~300 wavelengths
    u = rng.uniform(-130, 130, (nfreq, nprod)).astype(np.float32)
    v = rng.uniform(-260, 260, (nfreq, nprod)).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in (vis, sw, vw, ra_idx, a, b, u, v)]


@pytest.mark.parametrize("natural", [True, False])
@pytest.mark.parametrize("S,nprod,nha", [(5, 45, 11), (1, 32, 7), (3, 1789, 85), (40, 7, 3)])
def test_beamform_kernel_matches_plain(cuda, natural, S, nprod, nha):
    """Kernel against plain version on the same float32 inputs: both form the
    phase from the same rounded d and reduce it to turns, but take their sine
    and cosine from different routines and sum in another order; 1e-5 of the
    largest |F| (and of W, Q)."""
    from draco_tpu_torch.ops import interferometry

    vis, sw, vw, ra_idx, a, b, u, v = _beamform_inputs(S * nprod, S=S, nprod=nprod, nha=nha, nra=max(50, nha + 2),
                                                       dev=cuda)
    before = cuda_kernels.launches["beamform"]
    F, W, Q = cuda_kernels.beamform_sums(vis, sw, vw if natural else None, ra_idx, a, b, u, v, natural)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["beamform"] == before + 1
    Fp, Wp, Qp = interferometry.beamform_sums_plain(vis, sw, vw, ra_idx, a, b, u, v, natural)
    assert cuda_kernels.launches["beamform"] == before + 1
    assert F.shape == (vis.shape[0], S, nha) and F.dtype == torch.float32
    assert _rel(F, Fp) <= 1e-5 and _rel(W, Wp) <= 1e-5
    if natural:
        assert _rel(Q, Qp) <= 1e-5
    else:
        assert Q is None and Qp is None
    again = cuda_kernels.beamform_sums(vis, sw, vw if natural else None, ra_idx, a, b, u, v, natural)
    assert torch.equal(again[0], F)  # no atomics: the same sums every run


@pytest.mark.parametrize("natural", [True, False])
@pytest.mark.parametrize(
    "S,nra,nprod,nha,pad",
    [(512, 64, 45, 11, 0), (512, 64, 1789, 11, 4), (40, 64, 7155, 11, 0), (3, 16, 33, 85, 0), (8, 50, 2049, 5, 2)],
    ids=["shared-rows", "padded-above-K", "beyond-a-tile", "window-longer-than-day", "tile-plus-one"],
)
def test_beamform_kernel_on_shared_rows_matches_plain(cuda, natural, S, nra, nprod, nha, pad):
    """Many sources on few RA rows (512 over 64), the last ``pad`` slots of
    every window padded at RA index 0 (row 0 then takes 2048 pairs, more
    than one work item), odd nprod, nprod beyond one shared-memory tile:
    1e-5 of the largest sum, one launch, the same bits on a rerun."""
    from draco_tpu_torch.ops import interferometry

    vis, sw, vw, ra_idx, a, b, u, v = _beamform_inputs(S + nprod, S=S, nprod=nprod, nha=nha, nra=nra, dev=cuda)
    if pad:
        ra_idx[:, nha - pad :] = 0
        a[:, nha - pad :] = 0.0
    if pad and S * pad > cuda_kernels.BEAMFORM_ITEM_PAIRS:
        assert int(cuda_kernels.beamform_plan(ra_idx, nra).item_row.eq(0).sum()) > 1
    before = cuda_kernels.launches["beamform"]
    got = cuda_kernels.beamform_sums(vis, sw, vw if natural else None, ra_idx, a, b, u, v, natural)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["beamform"] == before + 1
    ref = interferometry.beamform_sums_plain(vis, sw, vw, ra_idx, a, b, u, v, natural)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        assert g.shape == (vis.shape[0], S, nha) and _rel(g, r) <= 1e-5
    again = cuda_kernels.beamform_sums(vis, sw, vw if natural else None, ra_idx, a, b, u, v, natural)
    for g, h in zip(got, again):
        assert (g is None and h is None) or torch.equal(g, h)  # one writer an output, a fixed order


def _beam_stream(device, tel, nra=64, seed=29):
    """A seeded stacked sidereal stream of every unique pair, on ``device``."""
    from draco_tpu_torch.analysis.transform import TelescopeStreamMixIn
    from draco_tpu_torch.core import containers

    maps = TelescopeStreamMixIn()
    maps.setup(tel)
    ss = containers.SiderealStream(freq=tel.frequencies, input=tel.nfeed, prod=maps.bt_prod, stack=maps.bt_stack,
                                   reverse_map_stack=maps.bt_rev, ra=nra, device=device)
    ss.attrs["lsd"] = 1000
    rng = np.random.Generator(np.random.SFC64(seed))
    shape = ss.vis.shape
    ss.vis[:] = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    weight = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    weight[0, 2] = 0.0
    ss.weight[:] = weight
    ss.input_flags[:] = np.ones(ss.input_flags.shape, dtype=np.float32)
    return ss


@pytest.mark.parametrize("collapse_ha", [True, False])
def test_beamform_cat_on_the_card_matches_the_cpu(cuda, collapse_ha):
    """BeamFormCat on 200 sources over 64 RA samples: on the card one
    launch a polarisation for the whole catalogue, on the CPU batches of
    32 of the plain version; formed beams and weights within 1e-5."""
    from draco_tpu_torch.analysis import beamform
    from draco_tpu_torch.core import containers
    from draco_tpu_torch.telescope import PolarisedCylinderTelescope

    tel = PolarisedCylinderTelescope(**dict(RING_CYL, num_freq=2))
    nsrc = 200
    out = {}
    for dev in (cuda, torch.device("cpu")):
        cat = containers.SourceCatalog(object_id=np.arange(nsrc))
        pos = np.zeros(nsrc, dtype=[("ra", np.float64), ("dec", np.float64)])
        pos["ra"], pos["dec"] = np.linspace(0.0, 359.0, nsrc), 45.0 + 5.0 * np.sin(np.arange(nsrc))
        cat["position"][:] = pos
        cat.attrs["coordinates"] = "CIRS"
        before = cuda_kernels.launches["beamform"]
        fb = _run_task(beamform.BeamFormCat(), {"timetrack": 6000.0, "collapse_ha": collapse_ha}, (tel,
                       _beam_stream(dev, tel)), cat)
        out[dev.type] = (fb, cuda_kernels.launches["beamform"] - before)
    (fb, nlaunch), (cfb, claunch) = out["cuda"], out["cpu"]
    assert nlaunch == 4 and claunch == 0
    assert fb.beam[:].device == cuda
    for name in ("beam", "weight"):
        assert _rel(fb.datasets[name][:].cpu(), cfb.datasets[name][:]) <= 1e-5, name


def test_beamform_kernel_ha_resolved_padding_on_the_card(cuda):
    """HA-resolved beamforming with padded window slots (index 0, validity 0)
    on the card against the CPU, natural and inverse-variance weights."""
    from draco_tpu_torch.ops import interferometry

    vis, sw, vw, ra_idx, a, b, u, v = _beamform_inputs(21)
    S, nha = ra_idx.shape
    valid = torch.ones(S, nha)
    valid[2, -4:] = 0.0
    ra_idx[2, -4:] = 0
    cosha, sinha = torch.rand(S, nha).double(), torch.rand(S, nha).double()
    sd, cd = torch.rand(S).double(), torch.rand(S).double()
    for inv in (False, True):
        args = (vis, sw, vw, ra_idx, cosha, sinha, sd, cd, 0.8, u, v, valid, inv)
        got = interferometry.beamform_sources_batched_ha(*[x.to(cuda) if torch.is_tensor(x) else x for x in args])
        ref = interferometry.beamform_sources_batched_ha(*args)
        for g, r in zip(got, ref):
            assert _rel(g.cpu(), r) <= 1e-5
            assert (g.cpu()[2, :, -4:] == 0).all()


def test_beamform_kernel_refuses_what_it_does_not_take(cuda):
    vis, sw, vw, ra_idx, a, b, u, v = _beamform_inputs(3, dev=cuda)
    with pytest.raises(TypeError):
        cuda_kernels.beamform_sums(vis.to(torch.complex128), sw, vw, ra_idx, a, b, u, v, True)
    with pytest.raises(TypeError):
        cuda_kernels.beamform_sums(vis, sw.double(), vw, ra_idx, a, b, u, v, True)
    with pytest.raises(IndexError):
        cuda_kernels.beamform_sums(vis, sw, vw, ra_idx + vis.shape[1], a, b, u, v, True)
    with pytest.raises(ValueError):
        cuda_kernels.beamform_sums(vis, sw, vw, ra_idx, a, b, u.cpu(), v, True)


# -- the DAYENU and DPSS filter path (float64 eigh, batched Cholesky) --------------------


def _crel(got, ref):
    """max|diff| / max|ref| of real or complex tensors."""
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("eps,tol", [(1e-3, 1e-10), (1e-12, 1e-2)])
def test_dayenu_pinv_on_the_card_matches_the_cpu(cuda, eps, tol):
    """The float64 eigh pseudo-inverse applied to data, on the card against the CPU:
    1e-10 at epsilon 1e-3; at 1e-12 the covariance's condition (1e12) leaves
    the filter determined only to ~1e-4-1e-2 between two LAPACKs."""
    from draco_tpu_torch.ops import dayenu

    freq = np.linspace(400.0, 464.0, 128, endpoint=False)
    flag = np.ones((128, 3), bool)
    flag[10, 1] = False
    flag[40:44, 2] = False
    x = torch.randn(128, 16, dtype=torch.complex128, generator=torch.Generator().manual_seed(2))
    ref, iref = dayenu.delay_filter(freq, flag, [0.1, 0.05], [0.0, 0.3], eps, device="cpu")
    got, igot = dayenu.delay_filter(freq, flag, [0.1, 0.05], [0.0, 0.3], eps, device=cuda)
    assert got.dtype == torch.complex128 and got.device.type == "cuda"
    assert [list(i) for i in igot] == [list(i) for i in iref]
    for k in range(ref.shape[0]):
        assert _crel((got[k] @ x.to(cuda)).cpu(), ref[k] @ x) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dpss_solve_on_the_card_matches_the_cpu(cuda, dtype):
    """The batched DPSS solve (shared and single weight rows) on the card against
    the CPU in the same type: 1e-10 in float64, 1e-3 in float32 (a Wiener
    system of condition ~1e5); the card's float64 basis spans the CPU's within
    1e-4."""
    from draco_tpu_torch.ops import dpss

    n = 256
    A = dpss.get_basis(dpss.make_covariance(np.arange(n), 0.05, 0.0, device="cpu"), dtype=np.float64)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, n, dtype=torch.complex128, generator=g)
    Ni = torch.rand(64, n, dtype=torch.float64, generator=g) + 0.5
    Ni[:40, 100:110] = 0.0  # 40 rows share a gap
    Ni[40:, :] = torch.where(torch.rand(24, n, generator=g) < 0.1, 0.0, Ni[40:])  # rows of their own
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    args = (x.to(cdt), Ni.to(dtype), A.to(dtype))
    ref = dpss.solve_batched(*args)
    got = dpss.solve_batched(*(a.to(cuda) for a in args))
    tol = 1e-10 if dtype == torch.float64 else 1e-3
    assert _crel(got[0].cpu(), ref[0]) <= tol and _crel(got[1].cpu(), ref[1]) <= tol
    Ag = dpss.get_basis(dpss.make_covariance(np.arange(n), 0.05, 0.0, device=cuda), dtype=np.float64)
    # the kept modes reach down to 1e-12 of the largest eigenvalue, where the eigenvectors are known only to
    # eps / 1e-12: the span agrees to ~1e-5 (2.0e-5 measured), the same modes kept
    assert Ag.shape == A.shape and _crel((Ag @ Ag.T).cpu(), A @ A.T) <= 1e-4


# -- the Legendre recurrence kernel and the chunked SHT -------------------------


def _legendre_case(s, m_vals, mode, device):
    wdt = cuda_kernels.LEGENDRE_MODES[mode]

    def t(a):
        return torch.as_tensor(a, dtype=wdt, device=device)

    r = np.arange(s.info.nring)
    return (t(s._x[r]), t(s._lnsin[r]), t(s._cm[m_vals]), t(s._a_tab[:, m_vals]), t(s._b_tab[:, m_vals]),
            torch.as_tensor(m_vals, device=device))


@pytest.mark.parametrize("mode", ["f64", "f32", "2f"])
@pytest.mark.parametrize("nside,lmax,m0,chunk,l0", [(64, 191, 0, 64, 0), (64, 191, 128, 64, 128), (8, 383, 320, 64, 0),
                                                     (128, 383, 0, 384, 0)])
def test_legendre_kernel_matches_plain(cuda, mode, nside, lmax, m0, chunk, l0):
    """The kernel against its plain version on the same card inputs: float64
    within 1e-12 of the block's largest value, two-float hi + lo within 1e-9,
    float32 within 1e-5.  (8, 383, m 320-383) is the polar-underflow regime."""
    from draco_tpu_torch.ops import sht

    s = sht.SHT(nside, lmax, lmax)
    m_vals = np.arange(m0, m0 + chunk)
    args = _legendre_case(s, m_vals, mode, cuda)
    before = cuda_kernels.launches["legendre"]
    got = cuda_kernels.legendre_block(*args, mode, l0=l0)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["legendre"] == before + 1
    ref = sht._legendre_block_core(*args, two_float=mode == "2f", l0=l0)
    if mode == "2f":
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.bfloat16
        got, ref = (got[0].double() + got[1].double()), (ref[0].double() + ref[1].double())
    scale = ref.double().abs().max()
    tol = {"f64": 1e-12, "2f": 1e-9, "f32": 1e-5}[mode]
    assert got.shape == (lmax + 1 - l0, chunk, s.info.nring)
    assert ((got.double() - ref.double()).abs().max() / scale).item() <= tol
    assert bool(torch.isfinite(got).all())


def test_legendre_kernel_refuses_what_it_does_not_take(cuda):
    from draco_tpu_torch.ops import sht

    s = sht.SHT(8)
    args = _legendre_case(s, np.arange(8), "f64", cuda)
    with pytest.raises(TypeError):
        cuda_kernels.legendre_block(*args, "f32")
    with pytest.raises(ValueError):
        cuda_kernels.legendre_block(*args[:-1], args[-1].cpu(), "f64")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chunked_sht_on_the_card_matches_the_cpu(cuda, dtype, monkeypatch):
    """The chunked route on the card launches the kernel once a chunk and
    agrees with the CPU's: 1e-5 in float32, 1e-10 in float64."""
    from draco_tpu_torch.ops import sht

    monkeypatch.setattr(sht, "TABLE_BUDGET_BYTES", 0)
    s = sht.SHT(32, 95, 95, chunk_m=16)
    maps = torch.from_numpy(np.random.Generator(np.random.SFC64(5)).standard_normal((2, 12 * 32**2))).to(dtype)
    before = cuda_kernels.launches["legendre"]
    alm = s.analysis(maps.to(cuda))
    back = s.synthesis(alm)
    torch.cuda.synchronize()
    assert s.last_route == "chunked" and cuda_kernels.launches["legendre"] == before + 12
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    assert _crel(alm.cpu(), s.analysis(maps)) <= tol
    assert _rel(back.cpu(), s.synthesis(alm.cpu())) <= tol


def test_segment_sum_on_the_card_is_bitwise_the_cpus(cuda):
    """The fixed-order segment sum on the card: the CPU's bits, run after run."""
    rng = np.random.Generator(np.random.SFC64(31))
    dst = rng.integers(0, 50, 5000)
    x = torch.from_numpy(rng.standard_normal((4, 5000, 16)) + 1j * rng.standard_normal((4, 5000, 16)))
    ref = tools.segment_sum(x, tools.segment_plan(dst, 50, "cpu"), 1)
    plan = tools.segment_plan(dst, 50, cuda)
    outs = [tools.segment_sum(x.to(cuda), plan, 1).cpu() for _ in range(3)]
    assert all(torch.equal(o, ref) for o in outs)
