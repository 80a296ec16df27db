"""Build and load the port's compiled code: the CUDA kernels and the host library.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``); the host library ``native/fast_host.c``
(name :data:`HOST`) by the system C compiler ``cc`` with OpenMP (``$CC``
is not read: a toolchain wrapper there may lack OpenMP).  Each goes into a
shared library under ``_build/`` next to this file, loaded with
:mod:`ctypes`.  The library name carries a hash of the source, the
compiler and its flags, so an edited source is rebuilt and a built one is
reused; the compiler writes a temporary file that is then renamed into
place, so processes that build at once do not see each other's partial
output.  A failed build raises.  Nothing is compiled when the package is
imported: the first load of a library builds it, or :func:`build_all`
builds several at once, one compiler process for each source.
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
HOST = "fast_host"
HOST_SOURCE = _HERE / "native" / "fast_host.c"
CC = "cc"
CC_FLAGS = ("-O3", "-fno-math-errno", "-fno-trapping-math", "-fPIC", "-shared", "-fopenmp")
# seconds one compiler may take before its build counts as failed
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# seconds from the start of a build to each library's end, for reporting set-up time
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


def _recipe(name: str) -> tuple[Path, str, tuple[str, ...]]:
    """(source, compiler, flags) of library ``name``."""
    if name == HOST:
        return HOST_SOURCE, CC, CC_FLAGS
    return CSRC / f"{name}.cu", "nvcc", NVCC_FLAGS


def library_path(name: str) -> Path:
    """Path of the built library ``name`` at its current source, compiler and flags."""
    src, compiler, flags = _recipe(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join((compiler, *flags)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def sources() -> list[str]:
    """Names of the kernels in ``csrc/`` (one ``<name>.cu`` each)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _command(name: str, out: Path) -> list[str]:
    src, compiler, flags = _recipe(name)
    return [_nvcc() if compiler == "nvcc" else compiler, *flags, "-o", str(out), str(src)]


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Build every library of ``names`` (default: the kernels of ``csrc/``)
    that is not built yet, one compiler process for each source, all
    started together; return the seconds from the start to each one's end.
    Raises RuntimeError naming every source that failed."""
    names = sources() if names is None else list(names)
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs, failed = {}, []
        for name in todo:
            tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
            cmd = _command(name, tmp)
            try:
                procs[name] = (tmp, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                          text=True))
            except OSError as exc:
                failed.append(f"building {_recipe(name)[0].name} failed: {' '.join(cmd)}: {exc}")
        for name, (tmp, cmd, proc) in procs.items():
            try:
                out, err = proc.communicate(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
                err += f"\n(killed after {BUILD_TIMEOUT_S} s)"
            build_seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"building {_recipe(name)[0].name} failed (rc {proc.returncode}): {' '.join(cmd)}\n"
                              f"{out}\n{err}")
            else:
                os.replace(tmp, library_path(name))
        if failed:
            raise RuntimeError("\n".join(failed))
        return {name: build_seconds[name] for name in todo}


def load(name: str) -> ctypes.CDLL:
    """Build library ``name`` (a kernel of ``csrc/``, or :data:`HOST`) if
    needed and return it loaded."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
