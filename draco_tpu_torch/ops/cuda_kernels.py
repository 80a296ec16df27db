"""Wrappers of the hand-written CUDA kernels.

Each wrapper launches its kernel (built on first use, on the current
stream) for CUDA tensors and runs the kernel's plain version for CPU
tensors; it never falls back from the card to the plain version: a CUDA
input that the kernel does not take raises.  ``launches`` counts the
kernel launches by name.

``banded_covariance_batched`` replaces the TPU kernel
``draco_tpu/ops/pallas_kernels.py::banded_covariance_pallas``: all band
diagonals of ``R diag(Ni_b) R^T`` for a batch of weight rows.  On a CUDA
tensor it launches ``csrc/banded_covariance.cu`` (built on first use) on
the current stream; on a CPU tensor it runs the plain reference
:func:`draco_tpu_torch.ops.banded.banded_covariance`.

``beamform_sums`` replaces the XLA programs of the JAX package's source
beamformers (``draco_tpu/ops/interferometry.py``: ``_beamform_sources_jit``,
``_beamform_sources_ha_jit``, ``_beamform_kernel_jit``): on a CUDA tensor it
builds the row plan of :func:`beamform_plan` and launches
``csrc/beamform.cu`` once; on a CPU tensor it runs
:func:`draco_tpu_torch.ops.interferometry.beamform_sums_plain`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from . import banded

__all__ = [
    "banded_covariance_batched",
    "beamform_plan",
    "beamform_sums",
    "legendre_block",
    "tile_rows",
    "tile_windows",
    "launches",
    "reset_launches",
]

# kernel name -> launches since the last reset (incremented only where a
# kernel is actually launched)
launches: dict[str, int] = {"banded_covariance": 0, "beamform": 0, "legendre": 0}


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


# most (s, h) pairs one block of the beamform kernel takes: a row hit by more
# (the padded window slots at RA index 0, or a catalogue piled on few RA
# samples) is cut into several work items
BEAMFORM_ITEM_PAIRS = 256


class BeamformPlan(NamedTuple):
    """The (s, h) pairs of ``ra_idx`` grouped by RA row, as the beamform kernel takes them.

    ``pairs`` [S * nha] holds j = s * nha + h stably sorted by ``ra_idx[s,
    h]``; work item i takes ``pairs[item_start[i] : item_start[i] +
    item_count[i]]``, all on row ``item_row[i]``, 1 to ``max_pairs`` of them.
    Items run in row order, and a row's items in pair order.  int32 tensors on
    ``ra_idx``'s device.
    """

    pairs: torch.Tensor
    item_row: torch.Tensor
    item_start: torch.Tensor
    item_count: torch.Tensor


def beamform_plan(ra_idx: torch.Tensor, nra: int, max_pairs: int = BEAMFORM_ITEM_PAIRS) -> BeamformPlan:
    """Invert ``ra_idx`` [S, nha] into the rows' pair lists (CSR), each cut
    into work items of at most ``max_pairs`` pairs; raises IndexError for an
    RA index outside [0, nra).

    Index bookkeeping in torch on ``ra_idx``'s device: a stable sort by row,
    each pair's rank within its row (a binary search for the row's start),
    an item heading every ``max_pairs``-th pair of a row; two host reads
    (the index range, the number of items).
    """
    i32 = torch.int32
    rows, pairs = torch.sort(ra_idx.reshape(-1), stable=True)
    if len(rows) == 0:
        empty = torch.zeros(0, dtype=i32, device=rows.device)
        return BeamformPlan(empty, empty, empty, empty)
    lo, hi = rows[[0, -1]].tolist()
    if lo < 0 or hi >= nra:
        raise IndexError(f"an RA index lies outside [0, {nra})")
    rank = torch.arange(len(rows), device=rows.device) - torch.searchsorted(rows, rows)
    item_start = torch.nonzero(rank % max_pairs == 0).squeeze(1)
    item_row = rows[item_start]
    item_count = (torch.searchsorted(rows, item_row, right=True) - item_start).clamp_(max=max_pairs)
    return BeamformPlan(pairs.to(i32), item_row.to(i32), item_start.to(i32), item_count.to(i32))


def _beamform_lib() -> ctypes.CDLL:
    lib = _build.load("beamform")
    if lib.beamform_rows_f32.argtypes is None:
        lib.beamform_rows_f32.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.beamform_rows_f32.restype = ctypes.c_int
    return lib


def beamform_sums(vis, sw, vw, ra_idx, a, b, u, v, natural: bool):
    """The beamforming contraction of one polarisation's stacks.

    vis [nfreq, nra, nprod] complex; sw and (natural weights only) vw
    [nfreq, nra, nprod]; ra_idx [S, nha] RA indices; a, b [S, nha] the
    track coefficients; u, v [nfreq, nprod] in wavelengths.  Returns (F, W,
    Q) [nfreq, S, nha] as
    :func:`~draco_tpu_torch.ops.interferometry.beamform_sums_plain` defines
    them (Q None unless ``natural``).  CUDA inputs must be contiguous, on
    one device, vis complex64, the rest float32 and ra_idx int32, every RA
    index in [0, nra) (:func:`beamform_plan` raises IndexError).  On the
    card the whole call is one launch of the kernel over the row plan,
    however many sources it holds.
    """
    nfreq, nra, nprod = vis.shape
    S, nha = ra_idx.shape
    inputs = [vis, sw, ra_idx, a, b, u, v] + ([vw] if natural else [])
    shapes = {"sw": (sw, vis.shape), "a": (a, ra_idx.shape), "b": (b, ra_idx.shape), "u": (u, (nfreq, nprod)),
              "v": (v, (nfreq, nprod))}
    if natural:
        if vw is None:
            raise ValueError("natural weights need vw")
        shapes["vw"] = (vw, vis.shape)
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if all(x.device.type == "cpu" for x in inputs):
        # interferometry imports this module for the wrapper: its plain
        # version is reached at call time
        from .interferometry import beamform_sums_plain

        return beamform_sums_plain(vis, sw, vw, ra_idx, a, b, u, v, natural)
    if not all(x.is_cuda and x.device == vis.device for x in inputs):
        raise ValueError("the beamform inputs must share one CUDA device")
    if vis.dtype != torch.complex64 or ra_idx.dtype != torch.int32 or any(
        x.dtype != torch.float32 for x in inputs if x is not vis and x is not ra_idx
    ):
        raise TypeError(
            "the CUDA beamform kernel takes complex64 vis, int32 ra_idx and float32 for the rest, got "
            + ", ".join(str(x.dtype) for x in inputs)
        )
    if not all(x.is_contiguous() for x in inputs):
        raise ValueError("the CUDA beamform kernel takes contiguous inputs")
    lib = _beamform_lib()
    F = torch.empty(nfreq, S, nha, dtype=torch.float32, device=vis.device)
    W = torch.empty_like(F)
    Q = torch.empty_like(F) if natural else None
    with torch.cuda.device(vis.device):
        plan = beamform_plan(ra_idx, nra)
        stream = torch.cuda.current_stream(vis.device).cuda_stream
        err = lib.beamform_rows_f32(
            vis.data_ptr(), sw.data_ptr(), vw.data_ptr() if natural else None, *(x.data_ptr() for x in plan),
            a.data_ptr(), b.data_ptr(), u.data_ptr(), v.data_ptr(), F.data_ptr(), W.data_ptr(),
            Q.data_ptr() if natural else None, nfreq, nra, nprod, S * nha, len(plan.item_row), BEAMFORM_ITEM_PAIRS,
            int(natural), stream,
        )
    if err != 0:
        raise RuntimeError(f"beamform kernel launch failed: CUDA error {err}")
    launches["beamform"] += 1
    return F, W, Q


def _legendre_lib() -> ctypes.CDLL:
    lib = _build.load("legendre")
    if lib.legendre_f64.argtypes is None:
        for fn in (lib.legendre_f64, lib.legendre_f32, lib.legendre_2f):
            fn.argtypes = [ctypes.c_void_p] * (8 if fn is lib.legendre_2f else 7) + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


# the working type of each mode of legendre_block
LEGENDRE_MODES = {"f64": torch.float64, "f32": torch.float32, "2f": torch.float64}
# rings a row of the kernel's output is padded to: a warp's 32 stores then
# fill whole 32-byte sectors (rows of 4095 rings, unpadded, took the kernel
# 2.2-2.4x as long on chip_smoke.py phase 21's chunk on an H100)
LEGENDRE_ROW_ALIGN = 32


def legendre_block(x, lnsin, cm_c, a_tab, b_tab, mv, mode: str, l0: int = 0):
    """Lambda[l - l0, c, r] for l = l0..L by the upward l-recurrence.

    x, lnsin [R]; cm_c [C] seed log coefficients; a_tab, b_tab [L+1, C]; mv
    [C] the m values, none below ``l0``.  ``mode`` "f64" and "f32" run the
    recurrence in that type and return [L+1-l0, C, R] of it; "2f" runs it in
    float64 and returns the pair (hi float32, lo bfloat16).  Every argument
    is in the mode's working type (``LEGENDRE_MODES``) but ``mv`` (integer).
    On CPU tensors this is :func:`draco_tpu_torch.ops.sht._legendre_block_core`;
    on the card one launch of ``csrc/legendre.cu``, whose output rows are
    padded to a multiple of ``LEGENDRE_ROW_ALIGN`` rings (the result is a
    view of the first R of each).
    """
    if mode not in LEGENDRE_MODES:
        raise ValueError(f"mode must be one of {sorted(LEGENDRE_MODES)}, got {mode!r}")
    inputs = (x, lnsin, cm_c, a_tab, b_tab)
    (R,), (C,) = x.shape, mv.shape
    L1 = a_tab.shape[0]
    if lnsin.shape != (R,) or cm_c.shape != (C,) or a_tab.shape != (L1, C) or b_tab.shape != (L1, C):
        raise ValueError(
            f"expected x, lnsin [R], cm_c, mv [C], a_tab, b_tab [L+1, C]; got "
            + ", ".join(str(tuple(t.shape)) for t in (*inputs, mv))
        )
    if not 0 <= l0 <= L1:
        raise ValueError(f"l0 must lie in [0, {L1}], got {l0}")
    if all(t.device.type == "cpu" for t in (*inputs, mv)):
        # sht imports this module for the wrapper: its plain version is
        # reached at call time
        from .sht import _legendre_block_core

        return _legendre_block_core(x, lnsin, cm_c, a_tab, b_tab, mv, two_float=mode == "2f", l0=l0)
    dev = x.device
    if not all(t.is_cuda and t.device == dev for t in (*inputs, mv)):
        raise ValueError("the legendre inputs must share one CUDA device")
    wdt = LEGENDRE_MODES[mode]
    if any(t.dtype != wdt for t in inputs) or mv.dtype not in (torch.int32, torch.int64):
        raise TypeError(
            f"the CUDA legendre kernel's mode {mode!r} takes {wdt} and an integer mv, got "
            + ", ".join(str(t.dtype) for t in (*inputs, mv))
        )
    inputs = [t.contiguous() for t in inputs]
    mv32 = mv.to(torch.int32).contiguous()
    lib = _legendre_lib()
    rs = -(-R // LEGENDRE_ROW_ALIGN) * LEGENDRE_ROW_ALIGN
    shape = (L1 - l0, C, rs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in inputs] + [mv32.data_ptr()]
        if mode == "2f":
            hi = torch.empty(shape, dtype=torch.float32, device=dev)
            lo = torch.empty(shape, dtype=torch.bfloat16, device=dev)
            err = lib.legendre_2f(*ptrs, hi.data_ptr(), lo.data_ptr(), L1, l0, C, R, rs, stream)
            result = (hi[..., :R], lo[..., :R])
        else:
            result = torch.empty(shape, dtype=wdt, device=dev)
            fn = lib.legendre_f64 if mode == "f64" else lib.legendre_f32
            err = fn(*ptrs, result.data_ptr(), L1, l0, C, R, rs, stream)
            result = result[..., :R]
    if err != 0:
        raise RuntimeError(f"legendre kernel launch failed: CUDA error {err}")
    launches["legendre"] += 1
    return result
