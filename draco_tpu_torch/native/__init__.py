"""Native host kernels (C + OpenMP), built at first use and loaded with ctypes.

Port of ``draco_tpu.native``: the sliding-window order statistics that
stay on the host (reference ``draco/util/_fast_tools.pyx`` and caput's
median module), from the port's own copy of the C source,
``fast_host.c`` next to this file.

The library is built at its first load by :mod:`draco_tpu_torch._build`
(``cc`` with OpenMP, into ``draco_tpu_torch/_build/``).  A failed build or
load raises: there is no quiet fall back to numpy and no switch to turn the
library off.  The numpy formulation is chosen only by its callers' explicit
``method="numpy"`` (:mod:`draco_tpu_torch.ops.median`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build

__all__ = ["load", "weighted_median", "moving_weighted_median", "omp_threads"]


def load() -> ctypes.CDLL:
    """Build the library if needed and return it; raises if either fails."""
    lib = _build.load(_build.HOST)
    if lib.omp_get_max_threads.argtypes is None:
        c_dp = ctypes.POINTER(ctypes.c_double)
        lib.weighted_median_f64.argtypes = [c_dp, c_dp, c_dp, ctypes.c_long, ctypes.c_long]
        lib.weighted_median_f64.restype = None
        lib.moving_weighted_median_f64.argtypes = [c_dp, c_dp, c_dp, *(ctypes.c_long,) * 4]
        lib.moving_weighted_median_f64.restype = None
        lib.omp_get_max_threads.argtypes = []
        lib.omp_get_max_threads.restype = ctypes.c_int
    return lib


def omp_threads() -> int:
    """The OpenMP threads a parallel region of the library would use."""
    return int(load().omp_get_max_threads())


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def weighted_median(x, w) -> np.ndarray:
    """Batched weighted median ("split" convention) along the last axis."""
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    w = np.ascontiguousarray(np.broadcast_to(w, x.shape), dtype=np.float64)
    x2 = x.reshape(-1, x.shape[-1])
    w2 = w.reshape(-1, x.shape[-1])
    out = np.empty(x2.shape[0], dtype=np.float64)
    lib.weighted_median_f64(_ptr(x2), _ptr(w2), _ptr(out), x2.shape[0], x2.shape[1])
    return out.reshape(x.shape[:-1])


def moving_weighted_median(x, w, size) -> np.ndarray:
    """2-D moving-window weighted median over the last two axes; samples
    outside the array carry zero weight."""
    s0, s1 = (int(size), int(size)) if np.isscalar(size) else (int(size[0]), int(size[1]))
    if s0 < 1 or s1 < 1 or s0 % 2 == 0 or s1 % 2 == 0:
        raise ValueError(f"Window sizes must be odd and positive, got {size}.")
    x = np.asarray(x)
    if x.ndim < 2:
        raise ValueError(f"The moving median runs over the last two axes; got {x.ndim}-D data.")
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    w = np.ascontiguousarray(np.broadcast_to(w, x.shape), dtype=np.float64)
    n0, n1 = x.shape[-2:]
    x3 = x.reshape(-1, n0, n1)
    w3 = w.reshape(-1, n0, n1)
    out = np.empty_like(x3)
    for b in range(x3.shape[0]):
        lib.moving_weighted_median_f64(_ptr(x3[b]), _ptr(w3[b]), _ptr(out[b]), n0, n1, s0, s1)
    return out.reshape(x.shape)
