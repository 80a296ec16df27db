"""The rest of transform.py, the tool and regrid helpers and the GP
resampler: draco_tpu_torch against draco_tpu on the same inputs.

Small sizes (those of ``tests/test_transform2.py`` and ``tests/test_gp.py``),
numpy inputs from a seed; the JAX package on the CPU with 64-bit types, the
port on the CPU, on one thread.  Tolerances, max|diff| / max|ref|:

- the host helpers (``broadcast_weights``, ``find_contiguous_slices``,
  ``correct_phase_wrap``, ``rebin_matrix``, ``lanczos_inverse_matrix``,
  ``grad_1d``, ``taylor_coeff``) and the selection tasks
  (``GenerateSubBands``, ``Downselect``): exact;
- ``ElevationDependentHybridVisWeight``: exactly the weights broadcast over
  elevation (the JAX task raises ``KeyError`` on every input: it reads the
  weight through the dataset it has just deleted);
- ``grad_1d_rows`` against ``grad_1d`` row by row: 1e-12 (float64; the
  port writes np.gradient's uneven-spacing stencil out, numpy switches to
  the even one where the spacing is exactly even);
- ``SelectPol``, ``PolWeightedAverage``, ``MixData`` and its subclasses:
  1e-6 (float32 sums of float32 data in both);
- ``TransformJanskyToKelvin``: 1e-6 (both scale in float64 and round to the
  datasets' complex64 and float32);
- ``HPFTimeStream``: 1e-6 (complex128 normal equations in both, different
  solvers, rounded to the complex64 dataset), the rows without weight
  untouched exactly;
- the GP resampler: 1e-9 for float64 data (float64 solves in both), 1e-6
  for complex64 data (projected in complex64 in both).

``regrid_sidereal`` in frequency blocks (a deliberate difference from the
JAX package, which solves every row in one program) against one block:
1e-4 in float32 and 1e-11 in float64, the rounding of either type times the
condition of the Wiener system (up to ~1/epsilon = 1e3 across a flagged
gap).  The rows are independent, but not bit for bit: the dirty map's
matrix product and the banded solver's short reductions add in an order
that the CPU kernels pick by the batch's size.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from draco_tpu.analysis import transform as jtransform
from draco_tpu.core import containers as jcontainers
from draco_tpu.core.task import PipelineStopIteration as JStop
from draco_tpu.ops import gaussian_process as jgp
from draco_tpu.ops import regrid as jregrid
from draco_tpu.ops import tools as jtools
from draco_tpu.telescope import UnpolarisedDishArray as JDish
from draco_tpu_torch.analysis import transform
from draco_tpu_torch.core import containers
from draco_tpu_torch.core.task import PipelineStopIteration
from draco_tpu_torch.device import default_device
from draco_tpu_torch.ops import gaussian_process as gp
from draco_tpu_torch.ops import regrid, tools
from draco_tpu_torch.telescope import UnpolarisedDishArray

DISH = dict(
    grid_ew=2, grid_ns=2, spacing_ew=6.0, spacing_ns=6.0, latitude=45.0, freq_lower=400.0, freq_upper=420.0,
    num_freq=2, auto_correlations=True,
)


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


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    return np.abs(got - ref).max() / (scale if scale > 0 else 1.0)


def to_port(jc):
    """The port's container of the same class, axes, attributes and data as the JAX container ``jc``."""
    cls = getattr(containers, type(jc).__name__)
    kwargs = {name: np.asarray(imap) for name, imap in jc.index_map.items()}
    if "stack" in jc.reverse_map:
        kwargs["reverse_map_stack"] = np.asarray(jc.reverse_map["stack"])
    pc = cls(skip_datasets=True, **kwargs)
    for name, ds in jc.datasets.items():
        pc.add_dataset(name)
        pc.datasets[name][:] = np.asarray(ds[:])
    pc.attrs.update(jc.attrs)
    return pc


def assert_same(pc, jc, tol=0.0, names=None):
    """Every dataset (or ``names``) of the port's container against the JAX one's."""
    names = list(jc.datasets) if names is None else names
    assert set(pc.datasets) == set(jc.datasets)
    for name in names:
        got, ref = _np(pc.datasets[name][:]), np.asarray(jc.datasets[name][:])
        if tol == 0.0 or ref.dtype.kind not in "fc":
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            assert _rel(got, ref) <= tol, (name, _rel(got, ref))
    for ax, imap in jc.index_map.items():
        np.testing.assert_array_equal(np.asarray(pc.index_map[ax]), np.asarray(imap), err_msg=ax)


def _run(task, params, setup, *inputs):
    task.read_config(params)
    if setup is not None:
        task.setup(*setup)
    return task.process(*inputs)


# -- the tool and regrid helpers ------------------------------------------------


def test_broadcast_weights_matches_jax():
    for w, d in ((("freq", "ra"), ("freq", "stack", "ra")), (("pol", "ra"), ("pol", "freq", "ra"))):
        assert tools.broadcast_weights(w, d) == jtools.broadcast_weights(w, d)
    for w, d in ((("ra", "freq"), ("freq", "ra")), (("el",), ("freq",))):
        with pytest.raises(ValueError):
            tools.broadcast_weights(w, d)


def test_find_contiguous_slices_and_phase_wrap_match_jax():
    idx = [0, 1, 2, 5, 6, 9, 11, 12]
    assert tools.find_contiguous_slices(idx) == jtools.find_contiguous_slices(idx)
    assert tools.find_contiguous_slices([]) == []
    phi = np.random.default_rng(3).uniform(-900, 900, 64)
    for deg in (False, True):
        ref = np.asarray(jtools.correct_phase_wrap(phi, deg=deg))
        assert _rel(tools.correct_phase_wrap(phi, deg=deg), ref) <= 1e-15
        assert _rel(tools.correct_phase_wrap(torch.as_tensor(phi), deg=deg), ref) <= 1e-15


def test_regrid_host_matrices_match_jax():
    rng = np.random.default_rng(5)
    tra = np.sort(rng.uniform(0.0, 1.0, 90))
    ra = np.linspace(0.0, 1.0, 40, endpoint=False)
    width = np.median(np.abs(np.diff(tra)))
    np.testing.assert_array_equal(regrid.rebin_matrix(tra, ra, width), jregrid.rebin_matrix(tra, ra, width))
    x = np.linspace(0.0, 1.0, 30)
    np.testing.assert_array_equal(
        regrid.lanczos_inverse_matrix(x, tra[:50], 3), jregrid.lanczos_inverse_matrix(x, tra[:50], 3)
    )
    Ni = rng.uniform(0.5, 2.0, 40)
    for period in (None, 1.0):
        ours = regrid.taylor_coeff(ra, 2, 3, Ni, 1e-3, period=period)
        ref = jregrid.taylor_coeff(ra, 2, 3, Ni, 1e-3, period=period)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.toarray(), b.toarray())


@pytest.mark.parametrize("uneven", [False, True])
def test_grad_1d_rows_matches_jax_row_by_row(uneven):
    rng = np.random.default_rng(7)
    n, nrow = 48, 6
    x = (rng.standard_normal((nrow, n)) + 1j * rng.standard_normal((nrow, n))).astype(np.complex128)
    si = np.linspace(0.0, 360.0, n, endpoint=False)
    if uneven:
        si = np.sort(si + rng.uniform(-2.0, 2.0, (nrow, n)), axis=-1)
    mask = rng.uniform(size=(nrow, n)) < 0.1
    mask[2] = False
    slope, bad = regrid.grad_1d_rows(torch.as_tensor(x), torch.as_tensor(si), torch.as_tensor(mask), period=360.0)
    for r in range(nrow):
        ref, ref_bad = jregrid.grad_1d(x[r], si[r] if uneven else si, mask[r], period=360.0)
        np.testing.assert_array_equal(_np(bad[r]), ref_bad)
        assert np.abs(_np(slope[r]) - ref).max() <= 1e-12 * np.abs(ref).max()
        ref_np, _ = regrid.grad_1d(x[r], si[r] if uneven else si, mask[r], period=360.0)
        np.testing.assert_array_equal(ref_np, ref)


@pytest.mark.parametrize("dtype, tol", [(np.complex64, 1e-4), (np.complex128, 1e-11)])
def test_regrid_in_blocks_matches_unblocked(dtype, tol, monkeypatch):
    rng = np.random.default_rng(9)
    nfreq, nbase, ntime = 4, 3, 200
    times = np.sort(rng.uniform(0.0, 1.0, ntime))
    times[0], times[-1] = 0.0, 1.0
    vis = torch.as_tensor((rng.standard_normal((nfreq, nbase, ntime)) + 1j * rng.standard_normal((nfreq, nbase, ntime)))
                          .astype(dtype))
    weight = torch.as_tensor(rng.uniform(0.5, 2.0, (nfreq, nbase, ntime)))
    weight[1, :, 50:60] = 0.0
    monkeypatch.setattr(transform, "REGRID_BLOCK_BYTES", 1 << 40)
    whole = transform.regrid_sidereal(vis, weight, times, 64, 0.0, 1.0)
    # the band covariance of one frequency's rows: 3 rows x 10 diagonals x 114 samples
    one = 3 * 10 * 114 * vis.real.element_size()
    for block in (1, one, 2 * one + 1):
        monkeypatch.setattr(transform, "REGRID_BLOCK_BYTES", block)
        part = transform.regrid_sidereal(vis, weight, times, 64, 0.0, 1.0)
        np.testing.assert_array_equal(part[0], whole[0])
        assert _rel(part[1], whole[1]) <= tol and _rel(part[2], whole[2]) <= tol


# -- the GP resampler ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_gp_resample_matches_jax(dtype):
    rng = np.random.default_rng(11)
    n_in, n_out = 60, 70
    xi = (np.arange(n_in) + rng.uniform(-0.2, 0.2, n_in)) / n_in
    xo = np.linspace(-0.05, 1.05, n_out)
    data = rng.standard_normal((3, n_in, 2))
    if dtype == np.complex64:
        data = data + 1j * rng.standard_normal((3, n_in, 2))
    data = data.astype(dtype)
    weight = rng.uniform(0.5, 2.0, data.shape)
    weight[1, 20:35] = 0.0
    weight[2] = 0.0
    spec = {"name": "matern", "width": 5.0, "alpha": 1.0, "nu": 2.5, "epsilon": 1e-6}
    ref_x, ref_w = jgp.resample(data, weight, xi=xi, xo=xo, cutoff_dist=1.7, cutoff_partition=1, kernel_spec=spec)
    got_x, got_w = gp.resample(torch.as_tensor(data), torch.as_tensor(weight), xi=xi, xo=xo, cutoff_dist=1.7,
                               cutoff_partition=1, kernel_spec=spec)
    tol = 1e-9 if dtype == np.float64 else 1e-6
    assert got_x.dtype == torch.as_tensor(ref_x).dtype
    assert _rel(got_x, ref_x) <= tol
    assert _rel(got_w, ref_w) <= 1e-9


# -- the transform tasks ----------------------------------------------------------


def _small_stream(package, value, weight, nra=4, seed=0):
    ss = package.SiderealStream(freq=np.array([400.0, 410.0]), stack=3, input=4, prod=3, ra=nra)
    rng = np.random.default_rng(seed)
    shape = ss.vis.shape
    ss.vis[:] = (value + rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    w = np.full(shape, weight, dtype=np.float32) * rng.uniform(0.5, 1.5, shape).astype(np.float32)
    w[0, 1, 2] = 0.0
    ss.weight[:] = w
    ss.attrs["tag"] = f"v{value}"
    return ss


@pytest.mark.parametrize(
    "cls, params, nin",
    [
        ("Jackknife", {}, 2),
        ("MixData", {"data_coeff": [1.0, 0.5, -2.0], "weight_coeff": [1.0, 0.0, 0.5], "tag_coeff": [True, False, True]},
         3),
        ("MixData", {"data_coeff": [1.0, 1.0], "weight_coeff": [0.5, 0.5], "invert_weight": True,
                     "require_nonzero_weight": True}, 2),
    ],
)
def test_mix_data_matches_jax(cls, params, nin):
    streams = [(_small_stream(jcontainers, 3.0 * i, 2.0, seed=i), _small_stream(containers, 3.0 * i, 2.0, seed=i))
               for i in range(nin)]
    outs = []
    for mod, k in ((jtransform, 0), (transform, 1)):
        task = getattr(mod, cls)()
        task.read_config(params)
        task.setup()
        for pair in streams:
            task.process(pair[k])
        outs.append(task.process_finish())
    ref, got = outs
    assert got.attrs["tag"] == ref.attrs["tag"]
    assert_same(got, ref, 1e-6)


def test_mix_two_datasets_matches_jax():
    params = {"data_coeff": [1.0, 1.0], "weight_coeff": [0.5, 0.5], "tag_coeff": [True, False]}
    ref = _run(jtransform.MixTwoDatasets(), params, (), _small_stream(jcontainers, 5.0, 1.0, seed=1),
               _small_stream(jcontainers, 3.0, 1.0, seed=2))
    got = _run(transform.MixTwoDatasets(), params, (), _small_stream(containers, 5.0, 1.0, seed=1),
               _small_stream(containers, 3.0, 1.0, seed=2))
    assert got.attrs["tag"] == ref.attrs["tag"] == "v5.0"
    assert_same(got, ref, 1e-6)


@pytest.mark.parametrize(
    "selections", [{"freq_index": [1], "ra_range": [0, 4]}, {"stack_index": [0, 2], "freq_map": [(410.0, 10.0)]}]
)
def test_downselect_matches_jax(selections):
    jss, ss = _small_stream(jcontainers, 1.0, 1.0, nra=8), _small_stream(containers, 1.0, 1.0, nra=8)
    if "freq_map" in selections:
        fmap = jss.index_map["freq"]
        selections = {"stack_index": [0, 2], "freq_map": [fmap[1]]}
    ref = _run(jtransform.Downselect(), {"selections": selections}, None, jss)
    got = _run(transform.Downselect(), {"selections": selections}, None, ss)
    assert_same(got, ref)


def test_generate_subbands_matches_jax():
    outs = []
    for package, mod, stop in ((jcontainers, jtransform, JStop), (containers, transform, PipelineStopIteration)):
        ss = package.SiderealStream(freq=np.linspace(400, 432, 8, endpoint=False), stack=2, input=3, prod=2, ra=4)
        ss.vis[:] = (np.arange(8)[:, None, None] * np.ones((1, 2, 4))).astype(np.complex64)
        ss.weight[:] = np.ones(ss.weight.shape, dtype=np.float32)
        ss.attrs["tag"] = "base"
        task = mod.GenerateSubBands()
        task.read_config({"sub_band_spec": {"band_a": {"channel_range": [0, 4]},
                                            "band_b": {"freq_physical_range": [416.0, 432.0]}}})
        task.setup(ss)
        outs.append([task.process(), task.process()])
        with pytest.raises(stop):
            task.process()
    for ref, got in zip(*outs):
        assert got.attrs["tag"] == ref.attrs["tag"]
        assert_same(got, ref)


def _polcont(package, pols, seed=4):
    rm = package.RingMap(freq=np.array([400.0, 410.0]), beam=np.arange(1), pol=np.array(pols), ra=4,
                         el=np.linspace(-0.1, 0.1, 3))
    rng = np.random.default_rng(seed)
    rm.map[:] = rng.standard_normal(rm.map.shape)
    w = rng.uniform(0.5, 2.0, rm.datasets["weight"].shape)
    w[1, 0, 2] = 0.0
    rm.datasets["weight"][:] = w
    return rm


@pytest.mark.parametrize("pol", [["I", "Q"], ["U", "V", "I"]])
def test_select_pol_matches_jax(pol):
    pols = ["XX", "reXY", "imXY", "YY"]
    ref = _run(jtransform.SelectPol(), {"pol": pol}, (), _polcont(jcontainers, pols))
    got = _run(transform.SelectPol(), {"pol": pol}, (), _polcont(containers, pols))
    assert list(got.index_map["pol"]) == list(ref.index_map["pol"])
    assert_same(got, ref, 1e-6)


def test_pol_weighted_average_matches_jax():
    ref = _run(jtransform.PolWeightedAverage(), {}, None, _polcont(jcontainers, ["XX", "XY", "YY"]))
    got = _run(transform.PolWeightedAverage(), {}, None, _polcont(containers, ["XX", "XY", "YY"]))
    assert_same(got, ref, 1e-6)


def test_elevation_dependent_weight_broadcasts_over_elevation():
    """The JAX task reads ``data.weight`` after deleting ``vis_weight`` and
    raises ``KeyError`` (its container's ``weight`` still names the deleted
    dataset); the port's container switches its weight to the new dataset,
    so the port is held to the task's documented result: the weights
    broadcast over the elevation axis."""
    hv = containers.HybridVisStream(freq=np.array([400.0, 410.0]), pol=np.array(["XX", "YY"]), ew=np.arange(2),
                                    el=np.linspace(-0.5, 0.5, 3), ra=5)
    hv.vis[:] = np.ones(hv.vis.shape, dtype=np.complex64)
    w = np.random.default_rng(2).uniform(size=hv.weight.shape).astype(np.float32)
    hv.weight[:] = w
    out = _run(transform.ElevationDependentHybridVisWeight(), {}, None, hv)
    assert "vis_weight" not in out.datasets and out.weight.name == "elevation_vis_weight"
    np.testing.assert_array_equal(_np(out.weight[:]), np.broadcast_to(w[..., None, :], out.vis.shape))
    again = _run(transform.ElevationDependentHybridVisWeight(), {}, None, out)
    np.testing.assert_array_equal(_np(again.weight[:]), np.broadcast_to(w[..., None, :], out.vis.shape))


@pytest.mark.parametrize("to_kelvin", [True, False])
def test_jansky_to_kelvin_matches_jax(to_kelvin):
    outs = []
    for package, mod, telcls in ((jcontainers, jtransform, JDish), (containers, transform, UnpolarisedDishArray)):
        tel = telcls(**DISH)
        nstack = tel.npairs
        prod = np.zeros(nstack, dtype=[("input_a", int), ("input_b", int)])
        prod["input_a"], prod["input_b"] = tel.uniquepairs[:, 0], tel.uniquepairs[:, 1]
        ss = package.SiderealStream(freq=tel.frequencies, stack=nstack, input=tel.nfeed, prod=prod, ra=4)
        rng = np.random.default_rng(6)
        ss.vis[:] = (rng.standard_normal(ss.vis.shape) + 1j * rng.standard_normal(ss.vis.shape)).astype(np.complex64)
        ss.weight[:] = rng.uniform(0.5, 2.0, ss.weight.shape).astype(np.float32)
        params = {"convert_Jy_to_K": to_kelvin, "share": "none", "nside": 16}
        outs.append(_run(mod.TransformJanskyToKelvin(), params, (tel,), ss))
    ref, got = outs
    assert_same(got, ref, 1e-6)


def test_hpf_timestream_matches_jax():
    outs = []
    for package, mod in ((jcontainers, jtransform), (containers, transform)):
        ts = package.TimeStream(freq=np.array([400.0, 410.0]), stack=3, input=4, prod=3,
                                time=1.0e9 + 10.0 * np.arange(120))
        rng = np.random.default_rng(8)
        t = np.arange(120)
        slow = np.cos(2 * np.pi * t / 300.0)[None, None]
        ts.vis[:] = (slow + 0.1 * rng.standard_normal(ts.vis.shape) + 0.1j * rng.standard_normal(ts.vis.shape)
                     ).astype(np.complex64)
        w = rng.uniform(0.5, 2.0, ts.weight.shape).astype(np.float32)
        w[1, 2] = 0.0
        ts.weight[:] = w
        outs.append(_run(mod.HPFTimeStream(), {"tau": 200.0}, None, ts))
    ref, got = outs
    assert _rel(got.vis[:], ref.vis[:]) <= 1e-6
    np.testing.assert_array_equal(_np(got.vis[1, 2]), np.asarray(ref.vis[:])[1, 2])
