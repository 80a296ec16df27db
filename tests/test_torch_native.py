"""The native host medians: draco_tpu_torch.native against numpy and the JAX package.

The port builds its own copy of ``fast_host.c`` into ``draco_tpu_torch/_build``
by the builder of the CUDA kernels (``draco_tpu_torch/_build.py``) and raises
when the build fails; ``method="numpy"`` is its plain version.

Tolerance: bit-equal.  A weighted median picks values of its input, and
the weights here are integers (0/1 masks and small counts), so every
cumulative sum is exact and the three formulations (the port's C, the
port's numpy, the JAX package's) agree to the bit.
"""

import hashlib

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from draco_tpu.ops import median as jmedian
from draco_tpu_torch import _build, native
from draco_tpu_torch.ops import median


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One OpenMP thread: these sizes gain nothing from threads, and beside
    other test workers spinning pools run tens of times slower.  The library
    is loaded first, so that the limit reaches its OpenMP pool."""
    native.load()
    with threadpool_limits(1):
        yield


def _data(seed, shape, frac=0.3, counts=False):
    rng = np.random.Generator(np.random.SFC64(seed))
    x = rng.standard_normal(shape)
    x[..., ::7] = np.round(x[..., ::7], 1)  # ties between values
    w = (rng.uniform(size=shape) > frac).astype(np.float64)
    if counts:
        w *= rng.integers(1, 4, shape)
    return x, w


def test_the_library_builds_from_the_ports_source_into_build():
    lib = native.load()
    path = _build.library_path(_build.HOST)
    assert path.exists() and path.parent == _build.BUILD_DIR and _build.BUILD_DIR.name == "_build"
    assert _build.BUILD_DIR.parent.name == "draco_tpu_torch" and _build.HOST_SOURCE.parent.name == "native"
    assert _build.HOST_SOURCE.parent.parent.name == "draco_tpu_torch" and _build.HOST_SOURCE.name == "fast_host.c"
    key = _build.HOST_SOURCE.read_bytes() + " ".join((_build.CC, *_build.CC_FLAGS)).encode()
    assert hashlib.sha256(key).hexdigest()[:16] in path.name and path.name.startswith("libfast_host-")
    assert _build.CC == "cc" and "-fopenmp" in _build.CC_FLAGS and native.omp_threads() >= 1
    assert lib is native.load()


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No quiet fall back: a compiler that does not exist makes the load raise."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="building fast_host.c failed"):
        native.load()
    with pytest.raises(RuntimeError, match="building fast_host.c failed"):
        median.weighted_median(np.ones(3), np.ones(3))
    assert not list(tmp_path.glob("*.so"))


def test_no_switch_turns_the_library_off(monkeypatch):
    monkeypatch.setenv("DRACO_TPU_NO_NATIVE", "1")
    x, w = _data(1, (4, 30))
    assert np.array_equal(median.weighted_median(x, w), native.weighted_median(x, w))
    with pytest.raises(ValueError, match="method must be one of"):
        median.weighted_median(x, w, method="fast")


@pytest.mark.parametrize("counts", [False, True], ids=["mask", "counts"])
@pytest.mark.parametrize("shape", [(10, 200), (3, 4, 51), (7,)])
def test_weighted_median_is_bit_equal(shape, counts):
    x, w = _data(2, shape, counts=counts)
    got = median.weighted_median(x, w)
    assert np.array_equal(got, median.weighted_median(x, w, method="numpy"))
    assert np.array_equal(got, jmedian.weighted_median(x, w))
    w[0] = 0.0  # a row without weight (or a 1-D sample) gives 0 / is ignored
    assert np.array_equal(median.weighted_median(x, w), jmedian.weighted_median(x, w))
    if x.ndim > 1:
        assert np.all(median.weighted_median(x, w)[0] == 0.0)
    assert np.array_equal(median.weighted_median(x, w, axis=0), jmedian.weighted_median(x, w, axis=0))


@pytest.mark.parametrize("size", [(5, 9), (9, 17), (1, 101), (37, 181), 3])
def test_moving_weighted_median_is_bit_equal(size):
    x, w = _data(3, (2, 16, 110), frac=0.25)
    got = median.moving_weighted_median(x, w, size)
    assert got.shape == x.shape
    assert np.array_equal(got, median.moving_weighted_median(x, w, size, method="numpy"))
    assert np.array_equal(got, jmedian.moving_weighted_median(x, w, size))


def test_moving_weighted_median_1d_and_odd_windows():
    x, w = _data(4, (64,))
    got = median.moving_weighted_median(x, w, 9)
    assert np.array_equal(got, median.moving_weighted_median(x, w, 9, method="numpy"))
    assert np.array_equal(got, jmedian.moving_weighted_median(x, w, 9))
    with pytest.raises(ValueError, match="must be odd"):
        median.moving_weighted_median(x[None], w[None], (4, 3))
    with pytest.raises(ValueError, match="odd and positive"):
        native.moving_weighted_median(x[None], w[None], (3, 0))
    with pytest.raises(ValueError, match="last two axes"):
        native.moving_weighted_median(x, w, (3, 3))


# -- mirrors of the JAX package's median tests (tests/test_flagging2.py, test_native.py)


def test_weighted_median_small_cases():
    x = np.array([1.0, 2.0, 3.0, 4.0, 100.0])
    assert median.weighted_median(x, np.ones(5)) == 3.0
    assert median.weighted_median(x, np.array([1, 1, 1, 1, 0.0])) == 2.5
    assert median.weighted_median(x, np.zeros(5)) == 0.0
    y = np.random.default_rng(0).standard_normal((4, 21))
    assert np.array_equal(median.weighted_median(y, np.ones_like(y)), np.median(y, axis=-1))


def test_moving_weighted_median_interior_matches_a_plain_median():
    from scipy.ndimage import median_filter

    x = np.random.default_rng(1).standard_normal((8, 32))
    m = median.moving_weighted_median(x, np.ones_like(x), (1, 5))
    for i in range(8):
        for j in range(2, 30):
            assert m[i, j] == np.median(x[i, j - 2 : j + 3])
    x1 = np.random.default_rng(4).standard_normal(64)
    assert np.array_equal(median.moving_weighted_median(x1, np.ones_like(x1), 9)[4:-4],
                          median_filter(x1, size=9, mode="constant")[4:-4])


def test_quantile_matches_jax():
    x, w = _data(5, (5, 101))
    for q in (0.0, 0.15, 0.5, 0.85, 1.0):
        assert np.array_equal(median.quantile(x, w, q), jmedian.quantile(x, w, q))
    assert np.array_equal(median.quantile(x, np.ones_like(x), 0.5), median.weighted_median(x, np.ones_like(x)))
    assert median.quantile(x, np.zeros_like(x), 0.15).tolist() == [0.0] * 5
