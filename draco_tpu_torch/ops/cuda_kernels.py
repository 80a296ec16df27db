"""Wrappers of the hand-written CUDA kernels.

``banded_covariance_batched`` replaces the TPU kernel
``draco_tpu/ops/pallas_kernels.py::banded_covariance_pallas``: all band
diagonals of ``R diag(Ni_b) R^T`` for a batch of weight rows.  On a CUDA
tensor it launches ``csrc/banded_covariance.cu`` (built on first use) on
the current stream; on a CPU tensor it runs the plain reference
:func:`draco_tpu_torch.ops.banded.banded_covariance`.  It never falls back
from the card to the plain version: a CUDA input that the kernel does not
take raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import banded

__all__ = ["banded_covariance_batched", "tile_rows", "tile_windows", "launches", "reset_launches"]

# kernel name -> launches since the last reset (incremented only where a
# kernel is actually launched)
launches: dict[str, int] = {"banded_covariance": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _banded_covariance_lib() -> ctypes.CDLL:
    lib = _build.load("banded_covariance")
    if lib.banded_covariance_f32.argtypes is None:
        for fn in (lib.banded_covariance_f32, lib.banded_covariance_f64):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.banded_covariance_tile_rows.argtypes = []
        lib.banded_covariance_tile_rows.restype = ctypes.c_int
    return lib


def tile_rows() -> int:
    """Rows of R per block of the CUDA kernel (its ``TJ``), which sets the
    tiles of :func:`tile_windows`.  Builds the kernel on first use."""
    return _banded_covariance_lib().banded_covariance_tile_rows()


def tile_windows(R: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """Sample window ``[lo, hi)`` of each tile of ``tile_rows`` rows of R.

    A product ``R[j+d, t] R[j, t]`` is nonzero only where ``R[j, t]`` is, so
    for the rows j of one tile it lies between the first and the last
    nonzero column of one of those rows: the window is the union of those
    spans, from the first to the last column where any row of the tile is
    nonzero.  An empty row widens nothing; a tile of empty rows gets
    ``lo = n > hi = 0``.  Nothing assumes the nonzeros are sorted or
    banded: scattered ones give a wide window.

    R [m, n] -> int32 [ceil(m / tile_rows), 2] on R's device.
    """
    m, n = R.shape
    ntiles = -(-m // tile_rows)
    nz = torch.zeros(ntiles * tile_rows, n, dtype=torch.bool, device=R.device)
    torch.ne(R, 0, out=nz[:m])
    # the columns where any row of the tile is nonzero; argmax gives the
    # first maximal index, so the first such column (and, flipped, the last)
    tile_nz = nz.view(ntiles, tile_rows, n).any(dim=1).view(torch.uint8)
    lo = tile_nz.argmax(dim=1)
    hi = n - tile_nz.flip(1).argmax(dim=1)
    has = tile_nz.gather(1, lo[:, None])[:, 0].bool()
    windows = torch.stack([torch.where(has, lo, n), torch.where(has, hi, 0)], dim=1)
    return windows.to(torch.int32).contiguous()


def banded_covariance_batched(R: torch.Tensor, Ni: torch.Tensor, bw: int) -> torch.Tensor:
    """``C[b, d, j] = sum_t R[j+d, t] Ni[b, t] R[j, t]`` for d = 0..bw.

    R [m, n] shared by the batch, Ni [B, n].  Returns [B, bw+1, m], exactly
    zero past the band end, for any ``bw >= 0``.  CUDA inputs must be
    contiguous, on one device, and both float32 or both float64; each type
    is summed in itself.
    """
    if R.ndim != 2 or Ni.ndim != 2 or Ni.shape[1] != R.shape[1]:
        raise ValueError(
            f"expected R [m, n] and Ni [B, n], got {tuple(R.shape)} and {tuple(Ni.shape)}"
        )
    if bw < 0:
        raise ValueError(f"bw must be >= 0, got {bw}")
    if R.device.type == "cpu" and Ni.device.type == "cpu":
        return banded.banded_covariance(R, Ni, bw)
    if not (R.is_cuda and Ni.is_cuda and R.device == Ni.device):
        raise ValueError(f"R and Ni must share one CUDA device, got {R.device} and {Ni.device}")
    if R.dtype != Ni.dtype or R.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA kernel takes float32 or float64 for both, got {R.dtype} and {Ni.dtype}")
    if not (R.is_contiguous() and Ni.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous R and Ni")
    lib = _banded_covariance_lib()
    fn = lib.banded_covariance_f32 if R.dtype == torch.float32 else lib.banded_covariance_f64
    m, n = R.shape
    B = Ni.shape[0]
    out = torch.empty(B, bw + 1, m, dtype=R.dtype, device=R.device)
    with torch.cuda.device(R.device):
        windows = tile_windows(R, tile_rows())
        stream = torch.cuda.current_stream(R.device).cuda_stream
        err = fn(R.data_ptr(), Ni.data_ptr(), windows.data_ptr(), out.data_ptr(), m, n, B, bw, stream)
    if err != 0:
        raise RuntimeError(f"banded_covariance kernel launch failed: CUDA error {err}")
    launches["banded_covariance"] += 1
    return out
