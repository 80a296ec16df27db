"""Wiener regridding and m-mode packing: draco_tpu_torch against draco_tpu.

Tolerances: float32 against float32, max|diff| / max|ref| <= 2e-5;
float64 against float64, 1e-10.
"""

import numpy as np
import pytest
import torch

from draco_tpu.analysis.transform import LanczosRegridder
from draco_tpu.ops import mmode as jmmode
from draco_tpu.ops import regrid as jregrid
from draco_tpu.ops.tools import invert_no_zero as j_invert_no_zero
from draco_tpu_torch.analysis import transform
from draco_tpu_torch.ops import mmode, regrid

TOL32 = 2e-5
TOL64 = 1e-10


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _wiener_problem(complex_y, seed=9):
    rng = np.random.Generator(np.random.SFC64(seed))
    m, n, k, bw = 96, 240, 3, 7
    grid = np.linspace(0, 1, m)
    samples = np.sort(rng.uniform(0, 1, n))
    R = regrid.lanczos_forward_matrix(grid, samples, a=4).T.astype(np.float32)
    Ni = rng.uniform(0.5, 2.0, (k, n)).astype(np.float32)
    y = rng.standard_normal((k, n)).astype(np.float32)
    if complex_y:
        y = (y + 1j * rng.standard_normal((k, n))).astype(np.complex64)
    Si = np.full(m, 1e-1, dtype=np.float32)
    return R, Ni, Si, y, bw


def test_lanczos_matrix_is_the_reference():
    x = np.linspace(0, 2, 50)
    y = np.sort(np.random.Generator(np.random.SFC64(2)).uniform(0, 2, 70))
    for periodic in (False, True):
        assert np.array_equal(
            regrid.lanczos_forward_matrix(x, y, 5, periodic),
            jregrid.lanczos_forward_matrix(x, y, 5, periodic),
        )


@pytest.mark.parametrize("complex_y", [False, True])
def test_band_wiener_matches_jax(complex_y):
    R, Ni, Si, y, bw = _wiener_problem(complex_y)
    xh, nw = regrid.band_wiener(
        torch.from_numpy(R), torch.from_numpy(Ni), torch.from_numpy(Si), torch.from_numpy(y), bw
    )
    jxh, jnw = jregrid.band_wiener(R, Ni, Si, y, bw, use_pallas=False)
    assert xh.dtype == (torch.complex64 if complex_y else torch.float32)
    assert xh.shape == tuple(jxh.shape) and nw.shape == tuple(jnw.shape)
    assert _rel(xh.numpy(), jxh) <= TOL32
    assert _rel(nw.numpy(), jnw) <= TOL32


@pytest.mark.parametrize("complex_y", [False, True])
def test_band_wiener_float64_matches_jax(complex_y):
    R, Ni, Si, y, bw = _wiener_problem(complex_y)
    R, Ni, Si = R.astype(np.float64), Ni.astype(np.float64), Si.astype(np.float64)
    y = y.astype(np.complex128 if complex_y else np.float64)
    xh, nw = regrid.band_wiener(
        torch.from_numpy(R), torch.from_numpy(Ni), torch.from_numpy(Si), torch.from_numpy(y), bw
    )
    jxh, jnw = jregrid.band_wiener(R, Ni, Si, y, bw, use_pallas=False)
    assert xh.dtype == (torch.complex128 if complex_y else torch.float64)
    assert nw.dtype == torch.float64
    assert _rel(xh.numpy(), jxh) <= TOL64
    assert _rel(nw.numpy(), jnw) <= TOL64


def test_band_wiener_rejects_complex_R():
    R, Ni, Si, y, bw = _wiener_problem(False)
    with pytest.raises(TypeError):
        regrid.band_wiener(
            torch.from_numpy(R.astype(np.complex64)), torch.from_numpy(Ni),
            torch.from_numpy(Si), torch.from_numpy(y), bw,
        )


def _stream(nb, ntime, seed=4):
    """Irregular samples over one period with a zero-weight gap."""
    rng = np.random.Generator(np.random.SFC64(seed))
    times = np.sort(rng.uniform(0.0, 1.0, ntime))
    times[0], times[-1] = 0.0, 1.0
    phase = 2 * np.pi * times
    vis = np.exp(1j * (np.arange(1, nb + 1)[:, None] * phase[None, :]))
    vis = vis + 0.1 * (rng.standard_normal(vis.shape) + 1j * rng.standard_normal(vis.shape))
    weight = rng.uniform(0.5, 2.0, (nb, ntime))
    weight[:, ntime // 2 : ntime // 2 + 5] = 0.0
    return times, vis, weight


def test_regrid_sidereal_matches_lanczos_regridder():
    times, vis, weight = _stream(3, 400)
    task = LanczosRegridder()
    task.samples, task.start, task.end = 64, 0.0, 1.0
    task.kernel_width, task.epsilon = 5, 1e-3
    jgrid, jvis, jni = task._regrid(vis, weight, times)

    grid, out, ni = transform.regrid_sidereal(
        torch.from_numpy(vis), torch.from_numpy(weight), times, 64, 0.0, 1.0, 5, 1e-3
    )
    assert np.array_equal(grid, jgrid)
    assert out.dtype == torch.complex128 and out.shape == jvis.shape
    assert _rel(out.numpy(), jvis) <= TOL64
    assert _rel(ni.numpy(), jni) <= TOL64


def test_regrid_sidereal_wide_kernel_matches_lanczos_regridder():
    # kernel width 17: band width 33, past the 31 the first CUDA kernel took
    times, vis, weight = _stream(2, 500, seed=6)
    task = LanczosRegridder()
    task.samples, task.start, task.end = 48, 0.0, 1.0
    task.kernel_width, task.epsilon = 17, 1e-3
    jgrid, jvis, jni = task._regrid(vis, weight, times)

    grid, out, ni = transform.regrid_sidereal(
        torch.from_numpy(vis), torch.from_numpy(weight), times, 48, 0.0, 1.0, 17, 1e-3
    )
    assert np.array_equal(grid, jgrid)
    assert out.shape == jvis.shape and ni.shape == jni.shape
    assert _rel(out.numpy(), jvis) <= TOL64
    assert _rel(ni.numpy(), jni) <= TOL64


def test_regrid_sidereal_rejects_out_of_range():
    times, vis, weight = _stream(2, 50)
    with pytest.raises(ValueError):
        transform.regrid_sidereal(
            torch.from_numpy(vis), torch.from_numpy(weight), times, 16, -0.5, 1.0
        )


@pytest.mark.parametrize("nra,mmax", [(64, 31), (65, 32), (64, 20), (40, 30)])
def test_make_marray_matches_jax(nra, mmax):
    rng = np.random.Generator(np.random.SFC64(nra))
    ts = (rng.standard_normal((2, 3, nra)) + 1j * rng.standard_normal((2, 3, nra))).astype(np.complex64)
    got = mmode.make_marray(torch.from_numpy(ts), mmax=mmax).numpy()
    ref = np.asarray(jmmode.make_marray(ts, mmax=mmax))
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL32
    back = mmode.mmodes_to_sidereal(torch.from_numpy(got), n=nra, oddra=bool(nra % 2)).numpy()
    jback = np.asarray(jmmode.mmodes_to_sidereal(ref, n=nra, oddra=bool(nra % 2)))
    assert _rel(back, jback) <= TOL32


def test_mmode_weights_match_the_transform_formula():
    rng = np.random.Generator(np.random.SFC64(8))
    ni = rng.uniform(0.5, 2.0, (2, 5, 48))
    ni[0, 1] = 0.0
    ni[1, 2, :10] = 0.0
    got = transform.mmode_weights(torch.from_numpy(ni), 23).numpy()
    nra = ni.shape[-1]
    var_sum = np.asarray(j_invert_no_zero(ni)).sum(axis=-1)
    ref = nra**2 * np.asarray(j_invert_no_zero(var_sum))
    assert got.shape == (24, 2, 2, 5)
    assert np.allclose(got, np.broadcast_to(ref, got.shape), rtol=1e-14, atol=0)
    assert np.all(got[:, :, 0, 1] == 0.0)
