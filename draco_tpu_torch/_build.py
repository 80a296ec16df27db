"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under ``_build/``
next to this file, then loaded with :mod:`ctypes`.  The library name
carries a hash of the source, so an edited kernel is rebuilt and a built
one is reused.  Nothing is compiled when the package is imported: the
first launch of a kernel builds it, or :func:`build_all` builds every
kernel at once, one ``nvcc`` process for each source.
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


def sources() -> list[str]:
    """Names of the kernels in ``csrc/`` (one ``<name>.cu`` each)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc_cmd(name: str, out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Build every kernel of ``names`` (default: all of ``csrc/``) that is not
    built yet, one ``nvcc`` process for each source, all started together;
    return the seconds from the start to each one's end."""
    names = sources() if names is None else list(names)
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in todo:
            tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(_nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            build_seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{out}\n{err}")
            else:
                os.replace(tmp, library_path(name))
        if failed:
            raise RuntimeError("\n".join(failed))
        return {name: build_seconds[name] for name in todo}


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
