"""The sidereal reduction: draco_tpu_torch against draco_tpu on the same inputs.

Small sizes (those of ``tests/test_sidereal.py`` and ``tests/test_gp.py``: a
2-dish array, 2 frequencies, 96-256 time samples a day, 16-64 RA bins),
numpy inputs from a seed; the JAX package on the CPU with 64-bit types, the
port on the CPU, on one thread.  Tolerances, max|diff| / max|ref|:

- the host helpers (``_ensure_list``, ``get_slice_to_broadcast``,
  ``_search_nearest``): exact;
- the stencil regridders (nearest, linear, cubic): 1e-6 (the same float64
  taps and coefficients, complex64 sums rounded after every tap in both);
- ``SiderealRegridderGP``: 1e-6 (complex64 projection in both);
- ``SiderealRebinner``: 1e-6 for the visibilities (the JAX package weights
  them in complex64, the port in complex128; both rebin in float64), 1e-6
  for the float32 weights and effective RA, the sample counts exact;
- ``RebinGradientCorrection``: 1e-6 (the JAX package rounds the gradient to
  complex64, the port keeps it in complex128);
- ``SiderealStacker``: 1e-6 for the complex64 stack and the float32 weights
  and sample variance (float32 updates in both, in another order of
  operations), the sample counts exact;
- ``SiderealStackerMatch``: the stack within 2e-3 of float64 numpy and 3e-3
  of the JAX package (the float32 cancellation of each day's mean, see the
  test), its weights and effective RA 1e-5.

Deliberate differences, held here: the stackers update their state in
place in the stack container's own datasets (the JAX package's donated
buffers), shown by the stack's tensors staying the same objects from day to
day; the rebinner, the correction and the stackers work in blocks of the
leading axis, shown by a run with a one-frequency block budget giving the
same result.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from draco_tpu.analysis import sidereal as jsidereal
from draco_tpu.core import containers as jcontainers
from draco_tpu.telescope import UnpolarisedDishArray as JDish
from draco_tpu_torch.analysis import sidereal
from draco_tpu_torch.core import containers
from draco_tpu_torch.device import default_device
from draco_tpu_torch.telescope import UnpolarisedDishArray

OBS = dict(grid_ew=2, grid_ns=1, spacing_ew=5.0, latitude=40.0, num_freq=2, force_lmax=10, force_mmax=10)


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for torch and the BLAS pools: these sizes gain nothing
    from threads, and beside other test workers spinning pools are slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def observers():
    return JDish(**OBS), UnpolarisedDishArray(**OBS)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    return np.abs(got - ref).max() / (scale if scale > 0 else 1.0)


def assert_same(pc, jc, tol=0.0, exact=()):
    """Every dataset of the port's container against the JAX one's; ``exact`` names those compared exactly."""
    assert set(pc.datasets) == set(jc.datasets), (set(pc.datasets), set(jc.datasets))
    for name, ds in jc.datasets.items():
        got, ref = _np(pc.datasets[name][:]), np.asarray(ds[:])
        if tol == 0.0 or name in exact or ref.dtype.kind not in "fc":
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            assert _rel(got, ref) <= tol, (name, _rel(got, ref))
    for ax, imap in jc.index_map.items():
        np.testing.assert_array_equal(np.asarray(pc.index_map[ax]), np.asarray(imap), err_msg=ax)


def day_stream(package, observer, lsd=100, ntime=96, jitter=0.2, seed=2, flags=True):
    """A TimeStream covering one sidereal day: a smooth signal, noise and flagged cells."""
    t0 = observer.lsd_to_unix(lsd)
    t1 = observer.lsd_to_unix(lsd + 1)
    rng = np.random.Generator(np.random.SFC64(seed))
    time = np.linspace(t0, t1, ntime, endpoint=False)
    if jitter:
        dt = (t1 - t0) / ntime
        time = np.sort(time + rng.uniform(-jitter, jitter, ntime) * dt)
    ts = package.TimeStream(freq=np.array([400.0, 500.0]), input=2, time=time)
    phase = 2 * np.pi * (observer.unix_to_lsd(time) - lsd)
    sig = 1.0 + 0.5 * np.cos(3 * phase) + 0.2 * np.sin(7 * phase) + 0.1j * np.sin(2 * phase)
    shape = ts.vis.shape
    noise = 0.05 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    ts.vis[:] = (sig + noise).astype(np.complex64)
    w = rng.uniform(50.0, 150.0, shape).astype(np.float32)
    if flags:
        w[0, 1, 10:14] = 0.0
        w[1, :, 40] = 0.0
    ts.weight[:] = w
    ts.attrs["lsd"] = lsd
    return ts


def sidereal_day(package, nra=32, lsd=0, seed=5, nfreq=2, nstack=3, eff_ra=False):
    """A SiderealStream day of noise about a fixed truth, with varying weights and a few zero weights."""
    ss = package.SiderealStream(freq=np.linspace(400.0, 500.0, nfreq), input=2, ra=nra, stack=nstack, prod=nstack)
    rng = np.random.Generator(np.random.SFC64(100 + seed))
    truth = np.random.Generator(np.random.SFC64(1)).standard_normal(ss.vis.shape) * (1 + 0.5j)
    shape = ss.vis.shape
    ss.vis[:] = (truth + 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) + seed).astype(
        np.complex64
    )
    w = rng.uniform(50.0, 150.0, shape).astype(np.float32)
    w[0, 0, seed % nra] = 0.0
    w[-1, 1, 3:6] = 0.0
    ss.weight[:] = w
    if eff_ra:
        ss.add_dataset("effective_ra")
        ss.effective_ra[:] = (np.asarray(ss.ra) + rng.uniform(-0.1, 0.1, shape)).astype(np.float32)
        ss.add_dataset("nsample")
        ss.nsample[:] = rng.integers(1, 4, shape).astype(np.uint16)
    ss.attrs["lsd"] = lsd
    ss.attrs["tag"] = f"lsd_{lsd}"
    return ss


def _run(task, params, setup, *inputs):
    task.read_config(params)
    if setup is not None:
        task.setup(*setup)
    return task.process(*inputs)


def test_host_helpers_match_jax():
    assert sidereal._ensure_list(3) == jsidereal._ensure_list(3) == [3]
    assert sidereal._ensure_list((1, 2)) == jsidereal._ensure_list((1, 2))
    for w, d in ((("freq", "ra"), ("freq", "stack", "ra")), (("pol", "freq", "ra"), ("pol", "freq", "ew", "ra"))):
        assert sidereal.get_slice_to_broadcast(w, d) == jsidereal.get_slice_to_broadcast(w, d)
    x = np.sort(np.random.default_rng(1).uniform(0, 10, 40))
    xe = np.random.default_rng(2).uniform(-1, 11, 100)
    np.testing.assert_array_equal(sidereal._search_nearest(x, xe), jsidereal._search_nearest(x, xe))


@pytest.mark.parametrize(
    "cls, params",
    [
        ("SiderealRegridderNearest", {"samples": 64}),
        ("SiderealRegridderLinear", {"samples": 64}),
        ("SiderealRegridderCubic", {"samples": 64}),
        ("SiderealRegridderGP", {"samples": 48, "kernel_width": 5}),
    ],
)
def test_regridders_match_jax(observers, cls, params):
    jobs, obs = observers
    ref = _run(getattr(jsidereal, cls)(), params, (jobs,), day_stream(jcontainers, jobs, ntime=128))
    got = _run(getattr(sidereal, cls)(), params, (obs,), day_stream(containers, obs, ntime=128))
    assert got.attrs["lsd"] == ref.attrs["lsd"]
    assert_same(got, ref, 1e-6)
    assert (_np(got.weight[:]) > 0).mean() > 0.3


@pytest.mark.parametrize("weight", ["inverse_variance", "uniform"])
@pytest.mark.parametrize("source", ["time", "sidereal"])
def test_rebinner_matches_jax(observers, weight, source, monkeypatch):
    jobs, obs = observers
    params = {"samples": 64, "weight": weight}
    if source == "time":
        jin, pin = day_stream(jcontainers, jobs, ntime=256), day_stream(containers, obs, ntime=256)
    else:
        jin, pin = sidereal_day(jcontainers, nra=200, lsd=100), sidereal_day(containers, nra=200, lsd=100)
    ref = _run(jsidereal.SiderealRebinner(), params, (jobs,), jin)
    got = _run(sidereal.SiderealRebinner(), params, (obs,), pin)
    assert type(got).__name__ == type(ref).__name__
    assert_same(got, ref, 1e-6, exact=("nsample",))
    # one frequency a block: the same result
    monkeypatch.setattr(sidereal, "BLOCK_ELEMENTS", pin.weight[0].numel())
    again = _run(sidereal.SiderealRebinner(), params, (obs,), day_stream(containers, obs, ntime=256)
                 if source == "time" else sidereal_day(containers, nra=200, lsd=100))
    assert_same(again, ref, 1e-6, exact=("nsample",))


def test_rebin_gradient_correction_matches_jax(observers):
    jobs, obs = observers
    outs = []
    for package, mod, o in ((jcontainers, jsidereal, jobs), (containers, sidereal, obs)):
        rebin = _run(mod.SiderealRebinner(), {"samples": 64}, (o,), day_stream(package, o, ntime=256))
        ref_day = _run(mod.SiderealRebinner(), {"samples": 64}, (o,), day_stream(package, o, ntime=256, seed=3))
        outs.append(_run(mod.RebinGradientCorrection(), {}, (ref_day,), rebin))
        # a reference without effective RA takes the grid
        plain = _run(mod.SiderealRegridderLinear(), {"samples": 64}, (o,), day_stream(package, o, ntime=256, seed=4))
        outs.append(_run(mod.RebinGradientCorrection(), {}, (plain,),
                         _run(mod.SiderealRebinner(), {"samples": 64}, (o,), day_stream(package, o, ntime=256))))
    for ref, got in ((outs[0], outs[2]), (outs[1], outs[3])):
        assert "effective_ra" not in got.datasets
        assert_same(got, ref, 1e-6, exact=("nsample",))


@pytest.mark.parametrize(
    "params",
    [{}, {"weight": "uniform"}, {"with_sample_variance": True}, {"weight": "uniform", "with_sample_variance": True}],
)
@pytest.mark.parametrize("eff_ra", [False, True])
def test_stacker_matches_jax(params, eff_ra):
    stacks = []
    for package, mod in ((jcontainers, jsidereal), (containers, sidereal)):
        task = mod.SiderealStacker()
        task.read_config(params)
        ptrs = set()
        for d in range(3):
            task.process(sidereal_day(package, lsd=d, seed=d, eff_ra=eff_ra))
            if package is containers:
                ptrs.add(task.stack.vis[:].data_ptr())
        stacks.append(task.process_finish())
        if package is containers:
            # the running state is the stack's own dataset, updated in place
            assert ptrs == {stacks[-1].vis[:].data_ptr()}
    ref, got = stacks
    np.testing.assert_array_equal(got.attrs["lsd"], ref.attrs["lsd"])
    assert got.attrs["tag"] == ref.attrs["tag"]
    assert_same(got, ref, 1e-6, exact=("nsample",))


def test_stacker_in_blocks_matches_jax(monkeypatch):
    ref_task = jsidereal.SiderealStacker()
    ref_task.read_config({"with_sample_variance": True})
    task = sidereal.SiderealStacker()
    task.read_config({"with_sample_variance": True})
    monkeypatch.setattr(sidereal, "BLOCK_ELEMENTS", 3 * 32)
    for d in range(3):
        ref_task.process(sidereal_day(jcontainers, nfreq=4, lsd=d, seed=d))
        task.process(sidereal_day(containers, nfreq=4, lsd=d, seed=d))
    assert_same(task.process_finish(), ref_task.process_finish(), 1e-6, exact=("nsample",))


def _match_stack_f64(days):
    """The matched stack of ``days`` in float64 numpy, the JAX package's algorithm written out."""
    st, Ni_s, V = 0.0, 0.0, []
    for day in days:
        d, w = _np(day.vis[:]).astype(np.complex128), _np(day.weight[:]).astype(np.float64)
        Ni = w.mean(axis=1)
        v = Ni / np.sqrt(Ni.sum(axis=1))[:, None]
        st = st + d * Ni[:, None, :] - v[:, None, :] * np.einsum("fsr,fr->fs", d, v)[:, :, None]
        Ni_s = Ni_s + Ni
        V.append(v)
    V64 = np.array(V).transpose(1, 2, 0) / Ni_s[:, :, None]
    M = np.eye(len(days))[None] - np.einsum("frd,fr,fre->fde", V64, Ni_s, V64)
    Y = np.einsum("fde,fse->fds", np.linalg.pinv(M, rcond=1e-8), np.einsum("fsr,frd->fsd", st, V64))
    sv = st / Ni_s[:, None, :] + np.einsum("frd,fds->fsr", V64, Y)
    return sv - (np.median(sv.real, axis=2) + 1j * np.median(sv.imag, axis=2))[:, :, None]


@pytest.mark.parametrize("eff_ra", [False, True])
def test_stacker_match_matches_jax(eff_ra, monkeypatch):
    """The deconvolution removes each day's mean (here up to twice the
    signal) from float32 sums weighted by Ni ~ 100: both packages keep ~1e-3
    of the largest value from that cancellation (measured 1.0e-3 for the JAX
    package and 6.1e-4 for the port against float64 numpy).  The stack is
    held to float64 numpy within 2e-3 and to the JAX package within 3e-3; the
    weights and effective RA, without such a cancellation, within 1e-5."""
    stacks = []
    for package, mod in ((jcontainers, jsidereal), (containers, sidereal)):
        task = mod.SiderealStackerMatch()
        task.read_config({})
        for d in range(3):
            task.process(sidereal_day(package, nfreq=3, lsd=d, seed=d, eff_ra=eff_ra))
        if package is containers:
            monkeypatch.setattr(sidereal, "BLOCK_ELEMENTS", 3 * 32)
        stacks.append(task.process_finish())
    ref, got = stacks
    np.testing.assert_array_equal(got.attrs["lsd"], ref.attrs["lsd"])
    assert set(got.datasets) == set(ref.datasets)
    truth = _match_stack_f64([sidereal_day(containers, nfreq=3, lsd=d, seed=d) for d in range(3)])
    assert _rel(got.vis[:], truth) <= 2e-3
    assert _rel(got.vis[:], ref.vis[:]) <= 3e-3
    for name in set(ref.datasets) - {"vis"}:
        assert _rel(got.datasets[name][:], ref.datasets[name][:]) <= 1e-5, name
