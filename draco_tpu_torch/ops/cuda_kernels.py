"""Wrappers of the hand-written CUDA kernels.

Each wrapper chooses from its inputs between its kernel and the kernel's
plain version: the kernel for the CUDA inputs it takes, the plain version
for CPU inputs.  It never falls back from the card to the plain version:
any other CUDA input raises.  Every kernel launches
through :func:`_launch`: the operator ``draco_tpu_torch::<name>`` (so that
``torch.profiler`` links the kernel's device time to the span that
launched it), on the current stream of its tensors' device; ``launches``
counts the launches by name.

``banded_covariance_batched`` replaces the TPU kernel
``draco_tpu/ops/pallas_kernels.py::banded_covariance_pallas``: all band
diagonals of ``R diag(Ni_b) R^T`` for a batch of weight rows.  On a CUDA
tensor it launches ``csrc/banded_covariance.cu``; on a CPU tensor it runs
the plain reference :func:`draco_tpu_torch.ops.banded.banded_covariance`.

``beamform_sums`` replaces the XLA programs of the JAX package's source
beamformers (``draco_tpu/ops/interferometry.py``: ``_beamform_sources_jit``,
``_beamform_sources_ha_jit``, ``_beamform_kernel_jit``): on a CUDA tensor it
builds the row plan of :func:`beamform_plan` and launches
``csrc/beamform.cu`` once; on a CPU tensor it runs
:func:`draco_tpu_torch.ops.interferometry.beamform_sums_plain`.

``legendre_block`` replaces the JAX package's Legendre recurrence
(``draco_tpu/ops/sht.py::_legendre_block_core``, a ``lax.scan``): on a CUDA
tensor one launch of ``csrc/legendre.cu`` for a block of m; on a CPU tensor
:func:`draco_tpu_torch.ops.sht._legendre_block_core`.

``fringe_planes`` makes one baseline chunk's fringe x beam planes for the
fused round trip (``telescope/roundtrip.py``), which the JAX package leaves
to XLA to fuse: the three-float phase of ``ops/tools.py::phase_frac3``,
``sincos_turns``, the per-step rotation on a uniform frequency grid and the
beam product, written once in the layout the chunk's consumer reads (the
windowed form's (re, im) [nfreq, chunk, npol * K], the full-sphere form's
stacked [2, nfreq, chunk, npol, K]).  On float32 CUDA tensors it launches
``csrc/fringe.cu`` once, bit-equal to the plain version on the card; on CPU
tensors it runs the plain version, :func:`fringe_planes_plain`, which
float64 reference states call by name on either device.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from .. import _build
from . import banded
from .tools import phase_frac3, sincos_turns

__all__ = [
    "banded_covariance_batched",
    "beamform_plan",
    "beamform_sums",
    "legendre_block",
    "fringe_planes",
    "fringe_planes_plain",
    "fringe_kernel_takes",
    "tile_rows",
    "tile_windows",
    "launches",
    "reset_launches",
]

# kernel name -> launches since the last reset (incremented only where a
# kernel is actually launched)
launches: dict[str, int] = {"banded_covariance": 0, "beamform": 0, "legendre": 0, "fringe": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# kernel (csrc/<kernel>.cu) -> its C entry points' argtypes: a launch entry
# takes a tensor's pointer (or NULL) for each c_void_p, an integer for each
# other argument, and the stream last; every entry returns an int (a launch
# its CUDA error)
_ENTRIES = {
    "banded_covariance": {
        "banded_covariance_f32": [_PTR] * 4 + [_INT] * 4 + [_PTR],
        "banded_covariance_f64": [_PTR] * 4 + [_INT] * 4 + [_PTR],
        "banded_covariance_tile_rows": [],
    },
    "beamform": {"beamform_rows_f32": [_PTR] * 14 + [_INT] * 7 + [_PTR]},
    "legendre": {
        "legendre_f64": [_PTR] * 7 + [_INT] * 5 + [_PTR],
        "legendre_f32": [_PTR] * 7 + [_INT] * 5 + [_PTR],
        "legendre_2f": [_PTR] * 8 + [_INT] * 5 + [_PTR],
    },
    "fringe": {"fringe_planes_f32": [_PTR] * 3 + [_I64] + [_PTR] * 7 + [_I64] + [_PTR] * 2 + [_INT] * 8 + [_PTR]},
}


@functools.cache
def _library(kernel: str) -> ctypes.CDLL:
    """``csrc/<kernel>.cu``'s library (built on first use), its entry points bound."""
    lib = _build.load(kernel)
    for entry, argtypes in _ENTRIES[kernel].items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


@functools.cache
def _entry_point(kernel: str, entry: str):
    """(bound entry point, which of its arguments before the stream are
    pointers, how many are)."""
    is_ptr = tuple(k is _PTR for k in _ENTRIES[kernel][entry][:-1])
    return getattr(_library(kernel), entry), is_ptr, sum(is_ptr)


def _run(kernel: str, entry: str, inputs, outputs, ints) -> None:
    """The CUDA implementation of the operator ``draco_tpu_torch::<kernel>``:
    one call of the C entry point ``entry``, its pointers from ``inputs``
    then ``outputs`` and its integers from ``ints`` in the order of its
    argtypes, on the current stream of the outputs' device."""
    fn, is_ptr, nptr = _entry_point(kernel, entry)
    tensors = (*inputs, *outputs)
    if nptr != len(tensors) or len(is_ptr) - nptr != len(ints):
        raise TypeError(f"{entry} takes {nptr} tensors and {len(is_ptr) - nptr} integers, "
                        f"got {len(tensors)} and {len(ints)}")
    ptrs, nums = iter(tensors), iter(ints)
    args = [(None if (t := next(ptrs)) is None else t.data_ptr()) if p else next(nums) for p in is_ptr]
    dev = next(t.device for t in outputs if t is not None)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


_ops_lock = threading.Lock()
# the operator library that holds the launches, made at the first launch
_op_library: torch.library.Library | None = None
# kernel -> its operator draco_tpu_torch::<kernel>
_ops: dict = {}


def _operators() -> dict:
    """Kernel -> its operator ``draco_tpu_torch::<kernel>``, registered for
    CUDA at the first call: ``(entry, inputs, outputs, ints)``, of which
    only ``outputs`` are marked as written."""
    global _op_library
    with _ops_lock:
        if _op_library is None:
            lib = torch.library.Library("draco_tpu_torch", "FRAGMENT")
            for name in _ENTRIES:
                lib.define(f"{name}(str entry, Tensor?[] inputs, Tensor(a!)?[] outputs, int[] ints) -> ()")
                lib.impl(name, functools.partial(_run, name), "CUDA")
                _ops[name] = getattr(torch.ops.draco_tpu_torch, name).default
            _op_library = lib
    return _ops


def _launch(kernel: str, entry: str, inputs, outputs, ints) -> None:
    """Launch ``entry`` of ``csrc/<kernel>.cu`` through its operator and
    count it.  Under ``torch.profiler`` an operator's host range is what a
    kernel launched inside it is linked to, so a trace gives the kernel's
    device time to the span that launched it; a launch from plain Python
    reaches the trace unlinked.  The wrapper has checked the tensors: one
    CUDA device, the kernel's types, contiguous."""
    _operators()[kernel](entry, list(inputs), list(outputs), list(ints))
    launches[kernel] += 1


def tile_rows() -> int:
    """Rows of R per block of the CUDA kernel (its ``TJ``), which sets the
    tiles of :func:`tile_windows`.  Builds the kernel on first use."""
    return _library("banded_covariance").banded_covariance_tile_rows()


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
    entry = "banded_covariance_f32" if R.dtype == torch.float32 else "banded_covariance_f64"
    m, n = R.shape
    B = Ni.shape[0]
    out = torch.empty(B, bw + 1, m, dtype=R.dtype, device=R.device)
    windows = tile_windows(R, tile_rows())
    _launch("banded_covariance", entry, (R, Ni, windows), (out,), (m, n, B, bw))
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
    F = torch.empty(nfreq, S, nha, dtype=torch.float32, device=vis.device)
    W = torch.empty_like(F)
    Q = torch.empty_like(F) if natural else None
    plan = beamform_plan(ra_idx, nra)
    _launch(
        "beamform", "beamform_rows_f32", (vis, sw, vw if natural else None, *plan, a, b, u, v), (F, W, Q),
        (nfreq, nra, nprod, S * nha, len(plan.item_row), BEAMFORM_ITEM_PAIRS, int(natural)),
    )
    return F, W, Q


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
    operands = [t.contiguous() for t in inputs] + [mv.to(torch.int32).contiguous()]
    rs = -(-R // LEGENDRE_ROW_ALIGN) * LEGENDRE_ROW_ALIGN
    shape = (L1 - l0, C, rs)
    if mode == "2f":
        outs = (torch.empty(shape, dtype=torch.float32, device=dev), torch.empty(shape, dtype=torch.bfloat16, device=dev))
    else:
        outs = (torch.empty(shape, dtype=wdt, device=dev),)
    _launch("legendre", f"legendre_{mode}", operands, outs, (L1, l0, C, R, rs))
    result = tuple(t[..., :R] for t in outs)
    return result if mode == "2f" else result[0]


def _vector_width(K: int, tensors) -> int:
    """Pixels a thread of the fringe kernel stores at once: the widest of 4
    and 2 that divides K and to whose 4-byte multiple every beam and output
    pointer is aligned, else 1."""
    for v in (4, 2):
        if K % v == 0 and all(t.data_ptr() % (4 * v) == 0 for t in tensors):
            return v
    return 1


def fringe_kernel_takes(t: torch.Tensor) -> bool:
    """Whether the fringe kernel takes an operand like ``t``: float32 on the card."""
    return t.is_cuda and t.dtype == torch.float32


def fringe_planes(ba, bb, bc, va, vb, vc, u_re, u_im, uidx, row0: int, uniform_freq: bool, uniform_real: bool,
                  lidx=None, geom_rows: int = 0, stacked: bool = False):
    """Fringe x beam planes of the C = ``len(uidx)`` rows of one baseline chunk.

    Row i's phase is ``frac(b . n)`` of coefficient row ``row0 + lidx[i]``
    (``row0 + i`` without ``lidx``) of ba/bb/bc [G, R, 3] against the pixel
    vectors va/vb/vc [K, 3], both as three-float operands (a float64 operand
    and two zeros for float64 states); G is 2 (base and per-step phase) when
    ``uniform_freq``, else one group a frequency.  ``lidx`` indexes the
    ``geom_rows`` rows from ``row0`` (the full-sphere form's geometry dedup:
    the plain version evaluates the trig of those rows, then gathers).  Its
    beam is ``u_re[:, 0]`` when ``uniform_real``, else ``u_re + i u_im`` at
    ``[:, uidx[i]]``, of [nfreq, U, npol, K].  Returns (re, im) [nfreq, C,
    npol * K], or with ``stacked`` the tensor [2, nfreq, C, npol, K] that
    holds them.

    On float32 CUDA tensors (int64 indices, contiguous, one device) one
    launch of ``csrc/fringe.cu`` into one tensor that holds both planes; it
    trusts the indices to lie in range (reading none, so the call never
    waits for the device).  On CPU tensors :func:`fringe_planes_plain`.
    Any other CUDA input raises, float64 ones included.
    """
    nfreq, _, npol, K = u_re.shape
    (C,) = uidx.shape
    G, R = ba.shape[:2]
    floats = (ba, bb, bc, va, vb, vc, u_re, u_im)
    indices = (uidx,) if lidx is None else (uidx, lidx)
    if any(t.shape != (G, R, 3) for t in (bb, bc)) or any(t.shape != (K, 3) for t in (va, vb, vc)):
        raise ValueError(
            "expected ba, bb, bc [G, R, 3] and va, vb, vc [K, 3], got "
            + ", ".join(str(tuple(t.shape)) for t in floats[:6])
        )
    if u_im.shape != u_re.shape or G != (2 if uniform_freq else nfreq) or (lidx is not None and lidx.shape != (C,)):
        raise ValueError(
            f"expected u_re, u_im [nfreq, U, npol, K], {2 if uniform_freq else nfreq} coefficient groups and "
            f"lidx [C]; got u_re {tuple(u_re.shape)}, u_im {tuple(u_im.shape)}, G {G}, "
            f"lidx {None if lidx is None else tuple(lidx.shape)}"
        )
    if lidx is not None and geom_rows < 1:
        raise ValueError(f"lidx indexes geom_rows rows from row0, got geom_rows {geom_rows}")
    nrows = C if lidx is None else geom_rows
    if row0 < 0 or row0 + nrows > R:
        raise IndexError(f"rows [{row0}, {row0 + nrows}) lie outside the {R} coefficient rows")
    args = (ba, bb, bc, va, vb, vc, u_re, u_im, uidx, row0, uniform_freq, uniform_real, lidx, geom_rows, stacked)
    if all(t.device.type == "cpu" for t in floats + indices):
        return fringe_planes_plain(*args)
    dev = u_re.device
    if not all(t.is_cuda and t.device == dev for t in floats + indices):
        raise ValueError("the fringe inputs must share one CUDA device")
    if not all(map(fringe_kernel_takes, floats)) or any(t.dtype != torch.int64 for t in indices):
        raise TypeError(
            "the CUDA fringe kernel takes float32 operands and int64 indices, got "
            + ", ".join(str(t.dtype) for t in floats + indices)
        )
    if not all(t.is_contiguous() for t in floats + indices):
        raise ValueError("the CUDA fringe kernel takes contiguous inputs")
    X = torch.empty(2, nfreq, C, npol, K, dtype=torch.float32, device=dev)
    _launch(
        "fringe", "fringe_planes_f32", (ba, bb, bc, va, vb, vc, u_re, u_im, uidx, lidx), (X[0], X[1]),
        (R, row0, nfreq, C, npol, K, u_re.shape[1], int(uniform_freq), int(uniform_real),
         _vector_width(K, (u_re, u_im, X[0], X[1]))),
    )
    if stacked:
        return X
    return X[0].view(nfreq, C, npol * K), X[1].view(nfreq, C, npol * K)


def _fringe_trig(ba, bb, bc, va, vb, vc, c0, chunk, nfreq, uniform):
    """(cos, sin) fringe planes [nfreq, chunk, K] of rows ``[c0, c0 + chunk)``.

    Uniform grids rotate the base phasor by the per-step phasor once per
    frequency.
    """
    Ba = ba[:, c0 : c0 + chunk]
    Bb = bb[:, c0 : c0 + chunk]
    Bc = bc[:, c0 : c0 + chunk]
    if not uniform:
        return sincos_turns(phase_frac3(Ba, Bb, Bc, va, vb, vc))
    c_f, s_f = sincos_turns(phase_frac3(Ba[0], Bb[0], Bc[0], va, vb, vc))
    if nfreq == 1:
        return c_f[None], s_f[None]
    cd, sd = sincos_turns(phase_frac3(Ba[1], Bb[1], Bc[1], va, vb, vc))
    cs, ss = [c_f], [s_f]
    for _ in range(nfreq - 1):
        c_f, s_f = cs[-1] * cd - ss[-1] * sd, cs[-1] * sd + ss[-1] * cd
        cs.append(c_f)
        ss.append(s_f)
    return torch.stack(cs), torch.stack(ss)


def fringe_planes_plain(ba, bb, bc, va, vb, vc, u_re, u_im, uidx, row0: int, uniform_freq: bool, uniform_real: bool,
                        lidx=None, geom_rows: int = 0, stacked: bool = False):
    """The plain version of :func:`fringe_planes` (the same arguments,
    which it does not check), in the operands' type on their device: the
    fringe trig of the chunk's rows (or of its ``geom_rows`` geometry rows,
    then a row gather from geometries to products), then the beam product.
    On float32 CUDA operands the kernel's every bit.  Float64 reference
    states call it by name on either device, as the reference and not as a
    fallback."""
    nfreq, _, npol, K = u_re.shape
    (C,) = uidx.shape
    if lidx is None:
        cph, sph = _fringe_trig(ba, bb, bc, va, vb, vc, row0, C, nfreq, uniform_freq)  # [f, C, K]
    else:
        cg, sg = _fringe_trig(ba, bb, bc, va, vb, vc, row0, geom_rows, nfreq, uniform_freq)  # [f, Gc, K]
        cph, sph = cg.index_select(1, lidx), sg.index_select(1, lidx)
        del cg, sg
    if uniform_real:
        b = u_re[:, 0][:, None]  # [f, 1, p, K]
        re, im = b * cph[:, :, None], b * sph[:, :, None]
    else:
        br = u_re.index_select(1, uidx)  # [f, C, p, K]
        bi = u_im.index_select(1, uidx)
        cp = cph[:, :, None]
        sp = sph[:, :, None]
        re, im = br * cp - bi * sp, br * sp + bi * cp
    del cph, sph
    if stacked:
        return torch.stack([re, im])
    return re.reshape(nfreq, C, npol * K), im.reshape(nfreq, C, npol * K)
