"""Native host kernels (C + OpenMP), built at first use and loaded with ctypes.

Port of ``draco_tpu.native``: the sliding-window order statistics that
stay on the host (reference ``draco/util/_fast_tools.pyx`` and caput's
median module), from the port's own copy of the C source,
``fast_host.c`` next to this file.

The library is compiled by the system C compiler ``cc`` with OpenMP at
the first call (``$CC`` is not read: a toolchain wrapper there may lack
OpenMP), into ``draco_tpu_torch/_build/`` under a
name that carries a hash of the source and the flags.  It is written to a
temporary file and renamed into place, so processes that build it at once
do not see each other's partial output.  A failed build or load raises:
there is no quiet fall back to numpy and no switch to turn the library
off.  The numpy formulation is chosen only by its callers' explicit
``method="numpy"`` (:mod:`draco_tpu_torch.ops.median`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

__all__ = ["load", "weighted_median", "moving_weighted_median", "omp_threads", "build_seconds"]

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "fast_host.c"
BUILD_DIR = _HERE.parent / "_build"
COMPILER = "cc"
CFLAGS = ("-O3", "-fno-math-errno", "-fno-trapping-math", "-fPIC", "-shared", "-fopenmp")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: seconds the compiler took in this process (0.0 when the library was built already)
build_seconds: float = 0.0


def library_path() -> Path:
    """Path of the built library for the current source, compiler and flags."""
    key = SOURCE.read_bytes() + " ".join((COMPILER, *CFLAGS)).encode()
    return BUILD_DIR / f"libfast_host-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [COMPILER, *CFLAGS, str(SOURCE), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"building the native library failed: {' '.join(cmd)}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native library failed (rc {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """Build the library if needed and return it; raises if either fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            c_dp = ctypes.POINTER(ctypes.c_double)
            lib.weighted_median_f64.argtypes = [c_dp, c_dp, c_dp, ctypes.c_long, ctypes.c_long]
            lib.weighted_median_f64.restype = None
            lib.moving_weighted_median_f64.argtypes = [c_dp, c_dp, c_dp, *(ctypes.c_long,) * 4]
            lib.moving_weighted_median_f64.restype = None
            lib.omp_get_max_threads.argtypes = []
            lib.omp_get_max_threads.restype = ctypes.c_int
            _lib = lib
    return _lib


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
