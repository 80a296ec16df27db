"""Gaussian-process covariance kernels (host numpy and scipy).

A copy of ``draco_tpu.ops.kernels``, which re-provides reference
``draco/util/kernels.py`` (gaussian:65, rational:95, matern:131,
periodic:187, moving_average_inverse:229, convert_band_diagonal:381):
covariance builders used by the GP regridders and the delay
maximum-likelihood prior.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gamma as gamma_fn
from scipy.special import kv

__all__ = [
    "gaussian",
    "rational",
    "matern",
    "periodic",
    "moving_average_inverse",
    "convert_band_diagonal",
    "get_kernel",
]


def _distances(x, y=None):
    x = np.asarray(x, dtype=np.float64)
    y = x if y is None else np.asarray(y, dtype=np.float64)
    return np.abs(x[:, np.newaxis] - y[np.newaxis, :])


def gaussian(x, y=None, *, width: float = 1.0, alpha: float = 1.0, epsilon: float = 0.0):
    """Squared-exponential kernel (reference kernels.py:65)."""
    r = _distances(x, y)
    K = alpha**2 * np.exp(-0.5 * (r / width) ** 2)
    if epsilon and (y is None):
        K = K + epsilon * np.eye(K.shape[0])
    return K


def rational(
    x, y=None, *, width: float = 1.0, alpha: float = 1.0, a: float = 1.0,
    epsilon: float = 0.0,
):
    """Rational quadratic kernel (reference kernels.py:95)."""
    r = _distances(x, y)
    K = alpha**2 * (1 + r**2 / (2 * a * width**2)) ** (-a)
    if epsilon and (y is None):
        K = K + epsilon * np.eye(K.shape[0])
    return K


def matern(
    x, y=None, *, width: float = 1.0, alpha: float = 1.0, nu: float = 2.5,
    epsilon: float = 0.0,
):
    """Matern kernel of order nu (reference kernels.py:131)."""
    r = _distances(x, y)
    arg = np.sqrt(2 * nu) * r / width
    with np.errstate(invalid="ignore", over="ignore"):
        K = (
            alpha**2
            * (2 ** (1 - nu) / gamma_fn(nu))
            * arg**nu
            * kv(nu, arg)
        )
    K = np.where(r == 0, alpha**2, K)
    K = np.nan_to_num(K)
    if epsilon and (y is None):
        K = K + epsilon * np.eye(K.shape[0])
    return K


def periodic(
    x, y=None, *, width: float = 1.0, alpha: float = 1.0, period: float = 1.0,
    epsilon: float = 0.0,
):
    """Exp-sine-squared periodic kernel (reference kernels.py:187)."""
    r = _distances(x, y)
    K = alpha**2 * np.exp(-2 * np.sin(np.pi * r / period) ** 2 / width**2)
    if epsilon and (y is None):
        K = K + epsilon * np.eye(K.shape[0])
    return K


def moving_average_inverse(n: int, width: int, alpha: float = 1.0):
    """Inverse covariance of a moving-average smoothness prior.

    (reference kernels.py:229): D^T D regulariser where D is a
    moving-average difference operator of the given width.
    """
    # local moving-average operator over EXACTLY `width` samples
    # (centred for odd widths, shifted for even — matching
    # moving_average_inverse_kernel so the two entry points agree)
    M = np.zeros((n, n))
    half_lo = (width - 1) // 2
    half_hi = width - half_lo
    for i in range(n):
        lo = max(0, i - half_lo)
        hi = min(n, i + half_hi)
        M[i, lo:hi] = 1.0 / (hi - lo)
    D = np.eye(n) - M
    return alpha * (D.T @ D)


def convert_band_diagonal(K: np.ndarray, bw: int | None = None):
    """Convert a dense symmetric matrix to lower band-diagonal storage.

    (reference kernels.py:381): ab[d, j] = K[j+d, j] for d = 0..bw.
    """
    n = K.shape[0]
    if bw is None:
        # find effective bandwidth
        nz = np.nonzero(np.abs(K) > 1e-12 * np.abs(K).max())
        bw = int(np.abs(nz[0] - nz[1]).max()) if len(nz[0]) else 0
    ab = np.zeros((bw + 1, n), dtype=K.dtype)
    for d in range(bw + 1):
        ab[d, : n - d] = np.diag(K, -d)
    return ab, bw


_KERNELS = {
    "gaussian": gaussian,
    "rational": rational,
    "matern": matern,
    "periodic": periodic,
}


# ---------------------------------------------------------------------------
# Reference-compatible N-based API (reference kernels.py:21-277)
# ---------------------------------------------------------------------------


def _N_to_xy(N):
    """Reference convention: N is a size, array, or 2-tuple thereof."""
    if isinstance(N, (int, np.integer)) or isinstance(N, np.ndarray):
        N = (N, N)
    x = np.arange(N[0]) if isinstance(N[0], (int, np.integer)) else np.asarray(N[0])
    y = np.arange(N[1]) if isinstance(N[1], (int, np.integer)) else np.asarray(N[1])
    return x, y


def euclidean_difference_kernel(N, width):
    """Normalised euclidean distance matrix (reference kernels.py:~240)."""
    if isinstance(width, (int, float)):
        width = (width, width)
    x, y = _N_to_xy(N)
    return np.abs(
        (x / width[0])[:, np.newaxis] - (y / width[1])[np.newaxis, :]
    )


def squared_difference_kernel(N, width):
    """Normalised squared distance matrix (reference kernels.py:278)."""
    return euclidean_difference_kernel(N, width) ** 2


def gaussian_kernel(N, width=1.0, alpha=1.0, **kw):
    """Gaussian kernel, reference N-based API (reference kernels.py:65)."""
    x, y = _N_to_xy(N)
    return gaussian(x, y, width=width, alpha=alpha, **kw)


def rational_kernel(N, width=1.0, alpha=1.0, a=1.0, **kw):
    """Rational quadratic kernel, reference API (kernels.py:95)."""
    x, y = _N_to_xy(N)
    return rational(x, y, width=width, alpha=alpha, a=a, **kw)


def matern_kernel(N, width=1.0, alpha=1.0, nu=2.5, **kw):
    """Matern kernel, reference API (kernels.py:131)."""
    x, y = _N_to_xy(N)
    return matern(x, y, width=width, alpha=alpha, nu=nu, **kw)


def periodic_kernel(N, width=1.0, alpha=1.0, period=1.0, **kw):
    """Periodic kernel, reference API (kernels.py:187)."""
    x, y = _N_to_xy(N)
    return periodic(x, y, width=width, alpha=alpha, period=period, **kw)


def moving_average_inverse_kernel(N: int, width: int, alpha: float, periodic: bool = True):
    """Moving-average smoothness prior (reference kernels.py:229)."""
    W = np.zeros((N, N))
    for i in range(N):
        ll, ul = i - (width - 1) // 2, i + (width + 1) // 2
        if not periodic:
            ll, ul = max(0, ll), min(ul, N)
        v = np.arange(ll, ul)
        W[i][v % N if periodic else v] = 1.0 / len(v)
    IW = np.identity(N) - W
    return alpha * (IW.T @ IW)


def is_hermitian_positive_definite(x: np.ndarray) -> bool:
    """True if ``x`` is Hermitian positive-definite (reference kernels.py)."""
    from scipy import linalg as la

    x = np.asarray(x)
    if not np.allclose(x, x.conj().T):
        return False
    try:
        la.cholesky(x, lower=False)
    except la.LinAlgError:
        return False
    return True


_NAME_KERNELS = {
    "gaussian": gaussian_kernel,
    "rational": rational_kernel,
    "matern": matern_kernel,
    "periodic": periodic_kernel,
    "moving_average_inverse": moving_average_inverse_kernel,
}


def get_kernel(spec=None, *, name=None, N=None, **params):
    """Build a kernel.

    Two call styles: ``get_kernel({"name": ..., ...})`` returns a callable
    ``k(x, y=None)`` over coordinates; ``get_kernel(name=..., N=..., ...)``
    returns the kernel array directly (reference kernels.py:21 API).
    """
    if isinstance(spec, dict):
        spec = dict(spec)
        kname = spec.pop("name")
        fn = _KERNELS[kname]

        def k(x, y=None):
            return fn(x, y, **spec)

        return k

    if name is None:
        raise ValueError("Must provide either a spec dict or a kernel name.")
    banded = params.pop("banded", False)
    if N is not None:
        params["N"] = N
    K = _NAME_KERNELS[name](**params)
    if banded:
        # reference API: return lower band-diagonal storage (ab, bw) —
        # silently returning a dense matrix would be misread as band
        # rows by a banded solver
        return convert_band_diagonal(K)
    return K
