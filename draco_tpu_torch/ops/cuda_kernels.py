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

__all__ = ["banded_covariance_batched", "launches", "reset_launches"]

# kernel name -> launches since the last reset (incremented only where a
# kernel is actually launched)
launches: dict[str, int] = {"banded_covariance": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _banded_covariance_lib() -> ctypes.CDLL:
    lib = _build.load("banded_covariance")
    fn = lib.banded_covariance_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.banded_covariance_max_bw.argtypes = []
        lib.banded_covariance_max_bw.restype = ctypes.c_int
    return lib


def banded_covariance_batched(R: torch.Tensor, Ni: torch.Tensor, bw: int) -> torch.Tensor:
    """``C[b, d, j] = sum_t R[j+d, t] Ni[b, t] R[j, t]`` for d = 0..bw.

    R [m, n] shared by the batch, Ni [B, n].  Returns [B, bw+1, m], exactly
    zero past the band end.  CUDA inputs must be contiguous float32 on one
    device.
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
    if R.dtype != torch.float32 or Ni.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {R.dtype} and {Ni.dtype}")
    if not (R.is_contiguous() and Ni.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous R and Ni")
    lib = _banded_covariance_lib()
    max_bw = lib.banded_covariance_max_bw()
    if bw > max_bw:
        raise ValueError(f"the CUDA kernel takes bw <= {max_bw}, got {bw}")
    m, n = R.shape
    B = Ni.shape[0]
    out = torch.empty(B, bw + 1, m, dtype=torch.float32, device=R.device)
    with torch.cuda.device(R.device):
        stream = torch.cuda.current_stream(R.device).cuda_stream
        err = lib.banded_covariance_f32(
            R.data_ptr(), Ni.data_ptr(), out.data_ptr(), m, n, B, bw, stream
        )
    if err != 0:
        raise RuntimeError(f"banded_covariance kernel launch failed: CUDA error {err}")
    launches["banded_covariance"] += 1
    return out
