"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under ``_build/``
next to this file, then loaded with :mod:`ctypes`.  The library name
carries a hash of the source, so an edited kernel is rebuilt and a built
one is reused.  Nothing is compiled when the package is imported: the
first launch of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# seconds spent in nvcc per kernel, for reporting set-up time
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path("/usr/local/cuda/bin/nvcc")
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or in /usr/local/cuda/bin: "
        "the CUDA toolkit is needed to build the kernels"
    )


def library_path(name: str) -> Path:
    """Path of the built library for ``csrc/<name>.cu`` at its current source."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, path)
            build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
        return lib
