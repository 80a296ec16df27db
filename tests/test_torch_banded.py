"""Banded covariance and banded Cholesky: draco_tpu_torch against draco_tpu.

Tolerances: float32 against float32, max|diff| / max|ref| <= 2e-5 (the
sums run in another order); float64 against float64, 1e-12; the zeros past
the band end are exact.  The CUDA kernel's sample windows
(``cuda_kernels.tile_windows``) are checked here on the CPU: they must
cover every nonzero product of their tile, and the plain sum restricted to
them must equal the dense one.
"""

import numpy as np
import pytest
import torch

from draco_tpu.ops import banded as jbanded
from draco_tpu.ops.pallas_kernels import banded_covariance_pallas
from draco_tpu_torch.ops import banded, cuda_kernels, regrid

TOL32 = 2e-5
TOL64 = 1e-12


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


def _problem(m, n, B, seed=5):
    rng = np.random.Generator(np.random.SFC64(seed))
    R = rng.standard_normal((m, n)).astype(np.float32)
    Ni = rng.uniform(0.5, 2.0, (B, n)).astype(np.float32)
    Ni[:, n // 3 : n // 3 + 7] = 0.0  # a zero-weight gap
    return R, Ni


@pytest.mark.parametrize("m,n,B,bw", [(100, 300, 3, 5), (64, 256, 2, 11), (97, 130, 4, 9)])
def test_banded_covariance_matches_jax(m, n, B, bw):
    R, Ni = _problem(m, n, B)
    got = banded.banded_covariance(torch.from_numpy(R), torch.from_numpy(Ni), bw).numpy()
    ref = np.stack([np.asarray(jbanded.banded_covariance(R, Ni[b], bw)) for b in range(B)])
    pallas = np.asarray(
        banded_covariance_pallas(R, Ni, bw, tile_j=32, tile_t=128, interpret=True)
    )
    assert got.shape == ref.shape == pallas.shape == (B, bw + 1, m)
    assert _rel(got, ref) <= TOL32
    assert _rel(got, pallas) <= TOL32
    for d in range(bw + 1):
        assert np.all(got[:, d, m - d :] == 0.0)


def test_wrapper_on_cpu_runs_the_plain_version():
    R, Ni = _problem(40, 90, 3)
    Rt, Nit = torch.from_numpy(R), torch.from_numpy(Ni)
    before = cuda_kernels.launches["banded_covariance"]
    out = cuda_kernels.banded_covariance_batched(Rt, Nit, 4)
    assert cuda_kernels.launches["banded_covariance"] == before
    assert torch.equal(out, banded.banded_covariance(Rt, Nit, 4))


def test_wrapper_rejects_bad_shapes():
    R, Ni = _problem(40, 90, 3)
    with pytest.raises(ValueError):
        cuda_kernels.banded_covariance_batched(torch.from_numpy(R), torch.from_numpy(Ni[:, :50]), 4)
    with pytest.raises(ValueError):
        cuda_kernels.banded_covariance_batched(torch.from_numpy(R), torch.from_numpy(Ni), -1)


def _spd_band(m, bw, B, dtype, seed=7):
    rng = np.random.Generator(np.random.SFC64(seed))
    R = rng.standard_normal((m, 3 * m)).astype(dtype)
    # a banded Gram matrix: zero R outside a band of rows per column
    for i in range(m):
        R[i, : max(0, 3 * (i - bw // 2))] = 0.0
        R[i, 3 * (i + bw // 2 + 1) :] = 0.0
    Ni = rng.uniform(0.5, 2.0, (B, 3 * m)).astype(dtype)
    ab = np.stack([np.asarray(jbanded.banded_covariance(R, Ni[b], bw)) for b in range(B)])
    ab[:, 0] += 1e-2
    rhs = rng.standard_normal((B, m)).astype(dtype)
    return ab, rhs


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, TOL32)])
def test_solveh_banded_matches_jax(dtype, tol):
    m, bw, B = 60, 5, 3
    ab, rhs = _spd_band(m, bw, B, dtype)
    got = banded.solveh_banded_lower(torch.from_numpy(ab), torch.from_numpy(rhs), bw).numpy()
    ref = np.stack(
        [np.asarray(jbanded.solveh_banded_lower(ab[b], rhs[b], bw)) for b in range(B)]
    )
    assert got.dtype == dtype
    # the factor and solves follow the same recurrences in the same order
    assert _rel(got, ref) <= tol
    lb = banded.banded_cholesky(torch.from_numpy(ab), bw).numpy()
    lb_ref = np.stack([np.asarray(jbanded.banded_cholesky(ab[b], bw)) for b in range(B)])
    assert _rel(lb, lb_ref) <= (1e-12 if dtype == np.float64 else TOL32)


def test_solveh_banded_against_dense_solve():
    m, bw, B = 40, 3, 2
    ab, rhs = _spd_band(m, bw, B, np.float64, seed=3)
    x = banded.solveh_banded_lower(torch.from_numpy(ab), torch.from_numpy(rhs), bw).numpy()
    for b in range(B):
        A = np.zeros((m, m))
        for d in range(bw + 1):
            idx = np.arange(m - d)
            A[idx + d, idx] = ab[b, d, : m - d]
            A[idx, idx + d] = ab[b, d, : m - d]
        assert np.allclose(A @ x[b], rhs[b], atol=1e-9 * np.abs(rhs[b]).max())


def test_singular_band_gives_nan():
    ab = torch.zeros(2, 3, 10, dtype=torch.float64)
    ab[:, 0] = 1.0
    ab[1, 0, 4] = -1.0
    lb = banded.banded_cholesky(ab, 2)
    assert torch.isfinite(lb[0]).all()
    assert torch.isnan(lb[1, 0, 4:]).all()


def _lanczos_rows(m, n, lo, hi, seed=11):
    """A Lanczos interpolation matrix [m, n] from m grid points on [lo, hi]
    onto n sorted samples of [0, 1), as the regridder builds it."""
    rng = np.random.Generator(np.random.SFC64(seed))
    samples = np.sort(rng.uniform(0.0, 1.0, n))
    return regrid.lanczos_forward_matrix(np.linspace(lo, hi, m), samples, a=5).T.copy()


def _window_case(name):
    """(R [m, n] float64, bw) for one shape the kernel's windows must handle."""
    if name == "lanczos":  # a band like the smoke's R
        return _lanczos_rows(200, 800, 0.0, 1.0), 9
    if name == "permuted":  # the same band with its columns shuffled
        R = _lanczos_rows(200, 800, 0.0, 1.0)
        return R[:, np.random.Generator(np.random.SFC64(3)).permutation(800)].copy(), 9
    if name == "empty_rows":  # grid points far beyond the samples, as the pad rows
        R = _lanczos_rows(180, 600, -0.5, 1.5)
        assert (~R.any(axis=1)).sum() >= 64
        return R, 9
    if name == "small":  # fewer rows than one tile
        return _lanczos_rows(13, 300, 0.0, 1.0), 5
    if name == "bw_ge_m":
        return _lanczos_rows(12, 200, 0.0, 1.0), 15
    raise ValueError(name)


WINDOW_CASES = ["lanczos", "permuted", "empty_rows", "small", "bw_ge_m"]


@pytest.mark.parametrize("tile_rows", [16, 64])
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_tile_windows_cover_every_nonzero_product(case, tile_rows):
    R, bw = _window_case(case)
    m, n = R.shape
    win = cuda_kernels.tile_windows(torch.from_numpy(R), tile_rows).numpy()
    assert win.shape == (-(-m // tile_rows), 2) and win.dtype == np.int32
    for tile, (lo, hi) in enumerate(win):
        rows = np.arange(tile * tile_rows, min(m, (tile + 1) * tile_rows))
        if not R[rows].any():  # empty rows widen nothing
            assert (lo, hi) == (n, 0)
            continue
        for d in range(min(bw, m - 1) + 1):
            j = rows[rows + d < m]
            t = np.flatnonzero((R[j + d] * R[j] != 0).any(axis=0))
            assert t.size == 0 or (lo <= t.min() and t.max() < hi)
        # and the window is no wider than the tile's own nonzeros
        t = np.flatnonzero(R[rows].any(axis=0))
        assert (lo, hi) == (t.min(), t.max() + 1)
    span = np.clip(win[:, 1] - win[:, 0], 0, None)
    if case == "lanczos":
        assert span.max() < 2 * tile_rows / m * n
    if case == "permuted":
        assert span.min() > 0.9 * n


def _windowed_covariance(R, Ni, bw, win, tile_rows):
    """The kernel's sum in plain torch: each tile's rows summed only over
    its window, whose start is rounded down to 8 samples as in the kernel."""
    m = R.shape[0]
    out = torch.zeros(Ni.shape[0], bw + 1, m, dtype=R.dtype)
    for tile, (lo, hi) in enumerate(win.tolist()):
        lo &= ~7
        if hi <= lo:
            continue
        j0, j1 = tile * tile_rows, min(m, (tile + 1) * tile_rows)
        out[:, :, j0:j1] = banded.banded_covariance(R[:, lo:hi], Ni[:, lo:hi], bw)[:, :, j0:j1]
    return out


@pytest.mark.parametrize("tile_rows", [16, 64])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL32), (torch.float64, TOL64)])
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_windowed_sum_equals_the_dense_sum(case, dtype, tol, tile_rows):
    R, bw = _window_case(case)
    rng = np.random.Generator(np.random.SFC64(6))
    Ni = rng.uniform(0.5, 2.0, (3, R.shape[1]))
    Ni[:, 50:60] = 0.0
    Rt, Nit = torch.from_numpy(R).to(dtype), torch.from_numpy(Ni).to(dtype)
    win = cuda_kernels.tile_windows(Rt, tile_rows)
    got = _windowed_covariance(Rt, Nit, bw, win, tile_rows)
    ref = banded.banded_covariance(Rt, Nit, bw)
    assert _rel(got.numpy(), ref.numpy()) <= tol
    m = R.shape[0]
    for d in range(bw + 1):
        assert (got[:, d, max(m - d, 0) :] == 0).all()
