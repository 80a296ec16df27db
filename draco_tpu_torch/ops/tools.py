"""Numeric tools: exact fringe phases, safe inverses and product arrays.

Port of the fringe subset of ``draco_tpu.ops.tools``
(``twofloat_split``, ``phase_frac``, ``threefloat_split``,
``phase_frac3``, ``sincos_turns``), ``invert_no_zero``, the host key
lookups (``find_key``, ``find_keys``, ``find_inputs``,
``redefine_stack_index_map``) and the product-array helpers (``cmap``,
``icmap``, ``apply_gain``, ``extract_diagonal``,
``unpack_product_array``, ``calculate_redundancy``), the apodisation
windows (``window_generalised``) and the small helpers of the stacking and
beamforming tasks (``broadcast_weights``, ``correct_phase_wrap``,
``find_contiguous_slices``) and the flagging library's baseline fits and
mask helpers (``penalized_least_squares_1d``, ``arPLS_1d``, ``IarPLS_1d``
and ``apply_hysteresis_threshold``: host scipy, as in the JAX package;
``taper_mask``: a float64 ``conv1d`` on the device), and the stack-map
helpers ``polarization_map`` and ``baseline_vector`` (host numpy, as in the
JAX package).

The exact-phase scheme rests on every high product being an exact
float32 value and on no fused multiply-add changing a rounded product.
Eager PyTorch runs each elementwise op as its own kernel, so the
expressions below are kept as separate multiplies and adds: do not
rewrite them with ``addcmul`` or compile them.

The product-array helpers take tensors and run on their device.
``apply_gain`` with ``out=`` works through the product axis in blocks,
so that a gain applied in place to a full-triangle stream never makes a
temporary of the stream's size.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "invert_no_zero", "twofloat_split", "phase_frac", "threefloat_split", "phase_frac3", "sincos_turns",
    "find_key", "find_keys", "find_inputs", "redefine_stack_index_map", "cmap", "icmap",
    "unique_pair_indices", "apply_gain", "extract_diagonal", "unpack_product_array", "redundancy_index",
    "calculate_redundancy", "stack_redundancy", "segment_plan", "segment_sum",
    "axis_blocks", "svd", "window_generalised", "broadcast_weights", "correct_phase_wrap", "find_contiguous_slices",
    "penalized_least_squares_1d", "arPLS_1d", "IarPLS_1d", "apply_hysteresis_threshold", "taper_mask",
    "polarization_map", "baseline_vector",
]

# elements of the largest temporary a blocked helper makes
BLOCK_ELEMENTS = 1 << 25

# torch.linalg.svd's keyword argument that names the cuSOLVER routine (CUDA tensors only)
SVD_ROUTINE_KEYWORD = "dri" + "ver"

# Veltkamp split constant for float32 (2^12 + 1)
_DEKKER_SPLIT = 4097.0


def invert_no_zero(x):
    """Reciprocal returning exactly zero where ``|x|`` is below the smallest
    normal: a tensor on its device, host data as numpy in its own type."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if x.dtype.kind not in "fc":
            x = x.astype(np.float64)
        small = np.abs(x) < np.finfo(x.dtype).tiny
        return np.where(small, 0.0, 1.0 / np.where(small, 1.0, x))
    small = torch.abs(x) < torch.finfo(x.real.dtype).tiny
    return torch.where(small, torch.zeros_like(x), 1.0 / torch.where(small, torch.ones_like(x), x))


def window_generalised(x, window: str = "nuttall") -> torch.Tensor:
    """High-order apodisation windows at arbitrary locations in [0, 1] (reference tools.py:547).

    ``x`` is a tensor (the window is made on its device, in its float type) or
    host data (a float64 CPU tensor).  Zero outside [0, 1].
    """
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x, dtype=np.float64))
    if window == "triangular":
        w = 1.0 - 2.0 * torch.abs(x - 0.5)
    elif window.startswith("tukey"):
        alpha = 0.5 * float(window.split("-")[1])
        w = torch.ones_like(x)
        w = torch.where(x < alpha, 0.5 * (1.0 + torch.cos(math.pi * (x - alpha) / alpha)), w)
        w = torch.where(x >= (1.0 - alpha), 0.5 * (1.0 + torch.cos(math.pi * (x - (1.0 - alpha)) / alpha)), w)
    else:
        a = torch.as_tensor(_COSINE_WINDOW_COEFFS[window], dtype=x.dtype, device=x.device)
        t = 2 * math.pi * torch.arange(4, dtype=x.dtype, device=x.device)[:, None] * x.reshape(-1)[None, :]
        w = (a[:, None] * torch.cos(t)).sum(dim=0).reshape(x.shape)
    return torch.where((x >= 0) & (x <= 1), w, torch.zeros_like(w))


# Generalised-cosine window coefficient table (a0..a3); values follow the
# standard published definitions of each window
_COSINE_WINDOW_COEFFS = {
    "uniform": (1.0, 0.0, 0.0, 0.0),
    "hann": (0.5, -0.5, 0.0, 0.0),
    "hamming": (0.53836, -0.46164, 0.0, 0.0),
    "blackman": (0.42, -0.5, 0.08, 0.0),
    "nuttall": (0.355768, -0.487396, 0.144232, -0.012604),
    "blackman_nuttall": (0.3635819, -0.4891775, 0.1365995, -0.0106411),
    "blackman_harris": (0.35875, -0.48829, 0.14128, -0.01168),
}
_COSINE_WINDOW_COEFFS["hanning"] = _COSINE_WINDOW_COEFFS["hann"]


def twofloat_split(a64: np.ndarray):
    """Split an f64 array into an (hi, lo) pair of f32 arrays.  Host numpy."""
    a64 = np.asarray(a64, dtype=np.float64)
    hi = a64.astype(np.float32)
    lo = (a64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def phase_frac(bh, bl, vh, vl):
    """``frac(b . n)`` in turns for two-float operands.

    bh/bl [..., 3] broadcast against vh/vl [K, 3] -> [..., K].  Each
    component's product gets its rounding error from a Dekker two-product
    and is reduced mod 1 on its own; absolute error ~eps_f32 independent
    of ``|b . n|``.
    """
    r_sum = None
    e_sum = None
    for x in range(3):
        b1 = bh[..., x][..., None]
        v1 = vh[:, x]
        p = b1 * v1
        bs = b1 * _DEKKER_SPLIT
        bhh = bs - (bs - b1)
        bll = b1 - bhh
        vs = v1 * _DEKKER_SPLIT
        vhh = vs - (vs - v1)
        vll = v1 - vhh
        e = ((bhh * vhh - p) + bhh * vll + bll * vhh) + bll * vll
        c = b1 * vl[:, x] + bl[..., x][..., None] * v1
        r = p - torch.round(p)
        r_sum = r if r_sum is None else r_sum + r
        e_sum = (e + c) if e_sum is None else e_sum + (e + c)
    y = r_sum + e_sum
    return y - torch.round(y)


def threefloat_split(a64: np.ndarray):
    """Split an f64 array into three f32 parts (12 + 12 + 24-bit mantissas).

    ``a64 ~= a + b + c`` with ``a``/``b`` carrying at most 12 significant
    bits each (the top and bottom halves of ``float32(a64)``'s mantissa)
    and ``c`` the f32 of the remainder.  Products of two 12-bit parts fit
    the 24-bit f32 significand exactly.  Host numpy.
    """
    a64 = np.asarray(a64, dtype=np.float64)
    hi = a64.astype(np.float32)
    a = (hi.view(np.uint32) & np.uint32(0xFFFFF000)).view(np.float32)
    b = hi - a
    c = (a64 - hi.astype(np.float64)).astype(np.float32)
    return a, b, c


def phase_frac3(ba, bb, bc, va, vb, vc):
    """``frac(b . n)`` in turns from three-part operands.

    ba/bb/bc [..., 3] broadcast against va/vb/vc [K, 3] -> [..., K].  The
    high products a*a, a*b, b*a are exact and reduced mod 1 term by term;
    the remaining cross terms are ~2^-24 relative and summed directly.
    Absolute error ~3e-7 turns independent of ``|b . n|``.
    """
    y = None
    for x in range(3):
        b_a = ba[..., x][..., None]
        b_b = bb[..., x][..., None]
        b_c = bc[..., x][..., None]
        v_a = va[:, x]
        v_b = vb[:, x]
        v_c = vc[:, x]
        paa = b_a * v_a
        pab = b_a * v_b
        pba = b_b * v_a
        r = (paa - torch.round(paa)) + (pab - torch.round(pab))
        r = r + (pba - torch.round(pba))
        small = b_b * v_b + (b_a * v_c + b_c * v_a) + (b_b * v_c + b_c * v_b)
        rc = r + small
        rc = rc - torch.round(rc)
        y = rc if y is None else y + rc
    return y - torch.round(y)


def sincos_turns(t: torch.Tensor):
    """(cos, sin) of ``2*pi*t`` for turns ``t`` near [-0.5, 0.5].

    float32: reduce to the nearest quarter turn and evaluate short
    Taylor polynomials on the residual (|x| <= pi/4; max abs error ~1e-7),
    then rotate by the quadrant.  float64 takes exact ``cos``/``sin``, so
    reference runs are not limited by the polynomial truncation.
    """
    if t.dtype == torch.float64:
        ph = 2 * math.pi * t
        return torch.cos(ph), torch.sin(ph)
    q = torch.round(4.0 * t)
    x = 2 * math.pi * (t - 0.25 * q)
    x2 = x * x
    c = 1.0 + x2 * (-0.5 + x2 * (1.0 / 24 + x2 * (-1.0 / 720 + x2 * (1.0 / 40320))))
    s = x * (1.0 + x2 * (-1.0 / 6 + x2 * (1.0 / 120 + x2 * (-1.0 / 5040 + x2 / 362880))))
    qm = q - 4.0 * torch.floor(q * 0.25)
    odd = (qm == 1.0) | (qm == 3.0)
    neg_c = (qm == 1.0) | (qm == 2.0)
    neg_s = (qm == 2.0) | (qm == 3.0)
    cos_v = torch.where(odd, s, c)
    sin_v = torch.where(odd, c, s)
    cos_v = torch.where(neg_c, -cos_v, cos_v)
    sin_v = torch.where(neg_s, -sin_v, sin_v)
    return cos_v, sin_v


def svd(A: torch.Tensor, full_matrices: bool = False):
    """SVD ``(U, s, Vh)`` of a batch of matrices, on their device (economy
    form unless ``full_matrices``).

    On a CUDA tensor this is cuSOLVER's QR-iteration ``gesvd``.  PyTorch's
    default there (the Jacobi ``gesvdj``) left the beam transfer matrices
    of a 191-pair cylinder 3.3e-4 from their reconstruction and took 2.5x
    as long, fell back to ``gesvd`` at the highest m (one non-zero
    column), and ``gesvda`` did not converge at all; ``gesvd`` reconstructs
    them to 4.9e-6 (``scripts/torch_linalg_rates.py --kl`` on an NVIDIA H100
    80GB HBM3 at 700 W; ``PERF.md``).  The relative singular-value cuts
    taken downstream (1e-6, 1e-3) need that accuracy.
    """
    routine = {SVD_ROUTINE_KEYWORD: "gesvd"} if A.is_cuda else {}
    return torch.linalg.svd(A, full_matrices=full_matrices, **routine)


def find_key(key_list, key):
    """Index of ``key`` in ``key_list`` or None (reference tools.py:66)."""
    try:
        entries = [tuple(x) for x in key_list]
        key = tuple(key)
    except TypeError:
        entries = list(key_list)
    try:
        return entries.index(key)
    except ValueError:
        return None


def _norm_key(k):
    """Normalise a key element: HDF5 round trips turn unicode into bytes."""
    if isinstance(k, bytes):
        return k.decode()
    if isinstance(k, np.str_):
        return str(k)
    return k


def find_keys(key_list, keys, require_match: bool = False):
    """Indices of ``keys`` in ``key_list`` (reference tools.py:95).

    String keys compare equal across the bytes/unicode divide (HDF5 stores
    fixed-width strings as bytes).
    """

    def _tup(kk):
        # str/bytes are iterable but are scalar keys, not tuples
        if isinstance(kk, (str, bytes, np.str_, np.bytes_)):
            raise TypeError
        return tuple(_norm_key(x) for x in kk)

    try:
        positions = {_tup(kk): ii for ii, kk in enumerate(key_list)}
        found = [positions.get(_tup(key)) for key in keys]
    except TypeError:
        positions = {_norm_key(kk): ii for ii, kk in enumerate(key_list)}
        found = [positions.get(_norm_key(key)) for key in keys]
    if require_match and None in found:
        raise ValueError("Some requested keys are absent.")
    return found


def find_inputs(input_index, inputs, require_match: bool = False):
    """Indices of ``inputs`` in ``input_index`` keyed on channel id (reference tools.py:130)."""
    names = input_index.dtype.names or ()
    if "correlator_input" in names:
        field = "correlator_input"
    elif "chan_id" in names:
        field = "chan_id"
    else:
        return find_keys(input_index, inputs, require_match=require_match)
    if inputs.dtype.names and field not in inputs.dtype.names:
        raise ValueError(f"`inputs` array does not have a `{field}` field.")
    return find_keys(input_index[field], inputs[field], require_match=require_match)


def redefine_stack_index_map(telescope, inputs, prod, stack, reverse_stack):
    """Re-pick stack representatives using only unmasked telescope inputs.

    (reference tools.py:359-414).  Returns (stack_new, stack_flag) where
    ``stack_flag`` is False for stacks with no valid representative.  Host numpy.
    """
    tel_index = find_inputs(telescope.input_index, inputs, require_match=False)
    stack_new = stack.copy()
    stack_flag = np.zeros(stack_new.size, dtype=bool)
    prod_pairs = np.stack([prod["input_a"], prod["input_b"]], axis=-1)
    feedmask = telescope.feedmask  # a property that rebuilds on each access: read it once

    def product_ok(pind):
        a, b = prod_pairs[pind]
        ta, tb = tel_index[a], tel_index[b]
        return ta is not None and tb is not None and feedmask[ta, tb]

    for sind in range(stack_new.size):
        if product_ok(stack["prod"][sind]):
            stack_flag[sind] = True
            continue
        # representative masked out: pick any surviving member product
        for member in np.flatnonzero(reverse_stack["stack"] == sind):
            if product_ok(member):
                stack_new["prod"][sind] = member
                stack_new["conjugate"][sind] = reverse_stack[member]["conjugate"]
                stack_flag[sind] = True
                break
    return stack_new, stack_flag


def cmap(i, j, n):
    """Pair index of feeds (i, j) in upper-triangle order (reference tools.py:21)."""
    i, j = np.minimum(i, j), np.maximum(i, j)
    return (n * (n + 1) // 2) - ((n - i) * (n - i + 1) // 2) + (j - i)


def icmap(ix, n):
    """Feed indices (i, j) of pair index ``ix`` (reference tools.py:42); vectorised."""
    ix = np.asarray(ix)
    # the largest i with cmap(i, i, n) <= ix
    t = n * (n + 1) // 2 - ix
    k = np.ceil((np.sqrt(8 * t.astype(np.float64) + 1) - 1) / 2).astype(np.int64)
    i = n - k
    j = ix - cmap(i, i, n) + i
    if np.ndim(ix) == 0:
        return int(i), int(j)
    return i, j


def unique_pair_indices(n: int, autos: bool = True) -> np.ndarray:
    """All upper-triangle feed pairs [(i, j)] of ``n`` feeds."""
    i, j = np.triu_indices(n, k=0 if autos else 1)
    return np.stack([i, j], axis=-1)


def _pair_inputs(prod_map, nprod: int, ninput: int):
    """(input_a, input_b) host arrays of every product."""
    if prod_map is None:
        if nprod != ninput * (ninput + 1) // 2:
            raise ValueError("Number of inputs does not match number of products.")
        pm = unique_pair_indices(ninput)
        return pm[:, 0], pm[:, 1]
    if len(prod_map) != nprod:
        raise ValueError("prod_map must list exactly one entry per product.")
    pm = np.asarray(prod_map)
    if pm.dtype.names:
        return pm["input_a"].astype(np.int64), pm["input_b"].astype(np.int64)
    return pm[:, 0].astype(np.int64), pm[:, 1].astype(np.int64)


def axis_blocks(n: int, elements_per_index: int, max_elements: int = BLOCK_ELEMENTS):
    """``(start, stop)`` blocks of an axis of length ``n`` whose slices hold at
    most ``max_elements`` elements (at least one index each)."""
    step = max(1, max_elements // max(1, elements_per_index))
    for start in range(0, n, step):
        yield start, min(start + step, n)


class SegmentPlan(NamedTuple):
    """The fixed-order sum of a segment sum (:func:`segment_plan`).

    ``order`` sorts the items by output (stably).  In that order each
    output's items are summed as a pairwise tree: level s adds the item s
    places on into every item whose rank in its output is a multiple of
    2 s, ``levels[k] = (into, from)`` for s = 2^k, until each output's
    first item (at ``heads``, for the outputs ``outs`` that have items)
    holds its sum.
    """

    nout: int
    order: torch.Tensor
    levels: list
    heads: torch.Tensor
    outs: torch.Tensor


def segment_plan(dst, nout: int, device) -> SegmentPlan:
    """Plan of the sum of items i into outputs ``dst[i]`` (host ints in [0, nout))."""
    dst = np.asarray(dst, dtype=np.int64)
    order = np.argsort(dst, kind="stable")
    sd = dst[order]
    first = np.searchsorted(sd, sd)
    rank = np.arange(len(sd)) - first
    count = np.bincount(sd, minlength=nout)[sd]
    levels = []
    step = 1
    while step < int(count.max(initial=0)):
        into = np.flatnonzero((rank % (2 * step) == 0) & (rank + step < count))
        levels.append((torch.as_tensor(into, device=device), torch.as_tensor(into + step, device=device)))
        step *= 2
    outs = np.unique(sd)

    def t(a):
        return torch.as_tensor(a, device=device)

    return SegmentPlan(nout, t(order), levels, t(np.searchsorted(sd, outs)), t(outs))


def segment_sum(x: torch.Tensor, plan: SegmentPlan, dim: int = 1) -> torch.Tensor:
    """Sum the items along ``dim`` of ``x`` into the outputs of ``plan``, in a
    fixed order: the same bits on every run and on either device.

    ``index_add_`` on a CUDA tensor adds repeated indices with atomics, in
    an order that changes from run to run; here each level of the pairwise
    tree writes every item at most once.
    """
    y = x.index_select(dim, plan.order)
    for into, src in plan.levels:
        y.index_copy_(dim, into, y.index_select(dim, into) + y.index_select(dim, src))
    shape = list(x.shape)
    shape[dim] = plan.nout
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    return out.index_copy_(dim, plan.outs, y.index_select(dim, plan.heads))


def _sorted_plan(sd: torch.Tensor, nout: int) -> SegmentPlan:
    """:func:`segment_plan` of outputs ``sd`` already in ascending order,
    built on their device (the same integer plan the host builds)."""
    dev = sd.device
    n = sd.shape[0]
    first = torch.searchsorted(sd, sd)
    rank = torch.arange(n, device=dev) - first
    count = torch.bincount(sd, minlength=nout)[sd]
    levels = []
    step, most = 1, int(count.max()) if n else 0
    while step < most:
        into = torch.nonzero((rank % (2 * step) == 0) & (rank + step < count)).flatten()
        levels.append((into, into + step))
        step *= 2
    outs = torch.unique_consecutive(sd)
    return SegmentPlan(nout, torch.arange(n, device=dev), levels, torch.searchsorted(sd, outs), outs)


def binned_sum(x: torch.Tensor, bins: torch.Tensor, nbins: int) -> torch.Tensor:
    """Sum the last axis of ``x`` [..., n] into ``nbins`` bins (``bins`` [n],
    ints in [0, nbins)), on ``x``'s device.

    Each bin's items are summed in ascending order of value as a pairwise
    tree (:func:`segment_sum`): the same bits on every run and device, and
    for any order of the items (a bin's sum depends on the multiset of its
    values only).  ``bincount(weights=...)`` on the card adds with atomics,
    in an order that changes from run to run.
    """
    bins = bins.to(device=x.device, dtype=torch.long)
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    # lexicographic (bin, value) order of each row: by value, then stably by bin
    by_value = torch.sort(x, dim=1, stable=True).indices
    by_bin = torch.sort(bins[by_value], dim=1, stable=True).indices
    xs = x.gather(1, by_value.gather(1, by_bin))
    plan = _sorted_plan(torch.sort(bins).values, nbins)
    return segment_sum(xs, plan, dim=1).reshape(*lead, nbins)


def apply_gain(vis: torch.Tensor, gain, axis: int = 1, out: torch.Tensor | None = None, prod_map=None):
    """Apply per-input gains to products: ``out_p = vis_p g_a conj(g_b)``.

    (reference tools.py:210-272).  ``gain`` has the input axis where ``vis``
    has the product axis and broadcasts against it elsewhere; ``prod_map``
    gives (input_a, input_b) per product, the upper-triangle order if
    omitted.  The product is formed in the promoted type of ``vis`` and
    ``gain``.  With ``out`` (which may be ``vis`` itself) the result is
    written there block by block along the product axis, with no
    temporary of ``vis``'s size; a real ``out`` takes the real part.
    """
    gain = torch.as_tensor(gain, device=vis.device)
    axis = axis % vis.ndim
    ia, ib = _pair_inputs(prod_map, vis.shape[axis], gain.shape[axis])
    ia = torch.as_tensor(ia, device=vis.device)
    ib = torch.as_tensor(ib, device=vis.device)

    def block(p0, p1):
        v = vis.narrow(axis, p0, p1 - p0)
        ga = gain.index_select(axis, ia[p0:p1])
        gb = gain.index_select(axis, ib[p0:p1])
        return v * ga * gb.conj()

    if out is None:
        return block(0, vis.shape[axis])
    per_index = vis.numel() // max(1, vis.shape[axis])
    for p0, p1 in axis_blocks(vis.shape[axis], per_index):
        res = block(p0, p1)
        if res.is_complex() and not out.is_complex():
            res = res.real
        out.narrow(axis, p0, p1 - p0).copy_(res)
    return out


def _diagonal_index(nprod: int) -> np.ndarray:
    nside = int((2 * nprod) ** 0.5)
    if nprod != nside * (nside + 1) // 2:
        raise RuntimeError(
            f"Array length ({nprod}) does not correspond to the upper triangle of a square matrix"
        )
    return cmap(np.arange(nside), np.arange(nside), nside)


def extract_diagonal(utmat: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """The autocorrelations of an upper-triangle product axis (reference tools.py:275)."""
    idx = _diagonal_index(utmat.shape[axis])
    return utmat.index_select(axis, torch.as_tensor(idx, device=utmat.device))


def unpack_product_array(utmat: torch.Tensor, axis: int = 1, nside: int | None = None) -> torch.Tensor:
    """Expand an upper-triangle product axis into a Hermitian [n, n] pair of axes.

    (reference draco/util/_fast_tools.pyx:91): a gather and a conjugation
    of the lower triangle.
    """
    axis = axis % utmat.ndim
    nprod = utmat.shape[axis]
    n_full = int((2 * nprod) ** 0.5)
    if n_full * (n_full + 1) // 2 != nprod:
        raise ValueError(f"axis length {nprod} is not a triangular number.")
    if nside is not None and nside != n_full:
        # indexing a feed subset still needs cmap over the full packing n
        raise NotImplementedError(
            f"feed subsets (nside={nside} != packing n={n_full}) are not supported; pass the full feed count."
        )
    ii, jj = np.meshgrid(np.arange(n_full), np.arange(n_full), indexing="ij")
    pidx = torch.as_tensor(cmap(ii, jj, n_full).ravel(), device=utmat.device)
    gathered = utmat.index_select(axis, pidx)
    gathered = gathered.reshape(utmat.shape[:axis] + (n_full, n_full) + utmat.shape[axis + 1 :])
    if not gathered.is_complex():
        return gathered
    lower = torch.as_tensor(ii > jj, device=utmat.device)
    lower = lower.reshape((1,) * axis + (n_full, n_full) + (1,) * (utmat.ndim - axis - 1))
    return torch.where(lower, gathered.conj(), gathered)


def redundancy_index(prod_map, stack_index, nstack: int, ninput: int, device):
    """(input_a, input_b, stack) index tensors on ``device`` of the products
    that :func:`calculate_redundancy` counts (those in a stack below ``nstack``)."""
    ia, ib = _pair_inputs(prod_map, len(prod_map), ninput)
    stack_index = np.asarray(stack_index).astype(np.int64)
    valid = np.flatnonzero((stack_index >= 0) & (stack_index < nstack))
    return tuple(torch.as_tensor(a[valid], device=device) for a in (ia, ib, stack_index))


def calculate_redundancy(input_flags, prod_map, stack_index, nstack: int, times=slice(None), index=None) -> torch.Tensor:
    """Per-stack redundancy counts from per-input flags (reference tools.py:313).

    ``redundancy[s, t] = sum over products p in stack s of
    flag[input_a(p), t] * flag[input_b(p), t]`` for the time samples
    ``times``; flags that are zero at every sample count as all ones.
    float32 [nstack, nt] on the flags' device, accumulated with
    ``index_add_``.  ``index`` is :func:`redundancy_index` of the same
    maps, for a caller that counts block by block.
    """
    flags = torch.as_tensor(input_flags)
    flags = flags.to(torch.float32) if bool(flags.any()) else torch.ones(flags.shape, device=flags.device)
    flags = flags[:, times]
    if index is None:
        index = redundancy_index(prod_map, stack_index, nstack, flags.shape[0], flags.device)
    ia, ib, seg = index
    red = torch.zeros(nstack, flags.shape[1], dtype=torch.float32, device=flags.device)
    return red.index_add_(0, seg, flags[ia] * flags[ib])


def stack_redundancy(input_flags, prod_map, stack_index, nstack: int, block_elements: int = 1 << 28) -> torch.Tensor:
    """:func:`calculate_redundancy` [nstack, nt] counted a block of time
    samples at a time, so that a full product triangle times every sample
    never sits on the device at once."""
    flags = torch.as_tensor(input_flags)
    index = redundancy_index(prod_map, stack_index, nstack, flags.shape[0], flags.device)
    # flags that are zero at every sample count as all ones: decide once for the whole set
    if not bool(flags.any()):
        flags = torch.ones(flags.shape, dtype=torch.float32, device=flags.device)
    nt = flags.shape[1]
    out = torch.empty(nstack, nt, dtype=torch.float32, device=flags.device)
    for t0, t1 in axis_blocks(nt, len(index[0]), block_elements):
        out[:, t0:t1] = calculate_redundancy(flags, prod_map, stack_index, nstack, slice(t0, t1), index)
    return out


def broadcast_weights(waxis_names, daxis_names):
    """Slice tuple broadcasting a weight array onto a data array (reference tools.py:173)."""
    extra = set(waxis_names) - set(daxis_names)
    if extra:
        raise ValueError(f"The weight carries axes the data lacks: {extra}")
    in_data_order = [ax for ax in daxis_names if ax in waxis_names]
    if in_data_order != list(waxis_names):
        raise ValueError(f"Weight axes {waxis_names} do not appear in data axes {daxis_names} in the correct order.")
    kept = set(waxis_names)
    return tuple(slice(None) if ax in kept else None for ax in daxis_names)


def correct_phase_wrap(phi, deg: bool = False):
    """Wrap phase into [-pi, pi) or [-180, 180) (reference tools.py:894).

    A tensor stays a tensor on its device; host data comes back as numpy.
    """
    period = 180.0 if deg else np.pi
    if isinstance(phi, torch.Tensor):
        return torch.remainder(phi + period, 2 * period) - period
    return ((np.asarray(phi) + period) % (2 * period)) - period


def find_contiguous_slices(index):
    """Convert indices into contiguous slices (reference tools.py:916)."""
    index = list(index)
    slices = []
    if not index:
        return slices
    start = prev = index[0]
    for x in index[1:]:
        if x == prev + 1:
            prev = x
            continue
        slices.append(slice(start, prev + 1))
        start = prev = x
    slices.append(slice(start, prev + 1))
    return slices


def penalized_least_squares_1d(y, reweight_func, mask=None, lam: float = 1e2, epsilon: float = 1e-2,
                               max_iter: int = 100):
    """Iteratively reweighted penalised-least-squares baseline (reference tools.py:600-714).

    Solves ``(W + lam D2^T D2) z = W y`` with a banded Cholesky solve,
    iterating the weights via ``reweight_func``.  Host scipy, as in the JAX
    package: a 1-D spectrum of at most a few thousand channels.
    """
    import warnings

    from scipy import linalg as la
    from scipy.sparse import dia_array

    y = np.squeeze(np.asarray(y, dtype=np.float64))
    if y.ndim != 1:
        raise ValueError(f"Expected 1D data array - got shape {y.shape}")
    n = y.shape[0]
    if mask is None:
        mask = np.zeros(n, dtype=bool)
    elif np.all(mask):
        warnings.warn("Every sample is masked; nothing to fit.")
        return np.zeros_like(y)
    mask = np.squeeze(np.asarray(mask, dtype=bool))

    # lower-banded lam * D2 D2^T for the second-difference operator D2
    stencil = np.tile([[1.0], [-2.0], [1.0]], (1, n - 1))
    d2 = dia_array((stencil, [-2, -1, 0]), shape=(n, n - 2))
    smooth = lam * (d2 @ d2.T)
    bands = np.ones((3, n), dtype=np.float64)
    for off in range(3):
        bands[off, : n - off] = smooth.diagonal(off)

    weights = np.zeros((3, n), dtype=np.float64)
    weights[0] = 1.0
    fit = np.zeros_like(y)
    for it in range(max_iter):
        weights[:, mask] = 0.0
        w = weights[0]
        fit = la.solveh_banded(bands + weights, w * y, lower=True, check_finite=False)
        w_next = reweight_func(y - fit, mask, it)
        if la.norm(w - w_next) / max(la.norm(w), 1e-30) < epsilon:
            break
        weights[0] = w_next
    else:
        warnings.warn(f"Baseline fit still moving after {max_iter} iterations.")
    return fit


def arPLS_1d(y, mask=None, lam: float = 1e2, epsilon: float = 1e-2, max_iter: int = 100):
    """Asymmetrically reweighted PLS baseline (reference tools.py:717-780)."""
    y = np.asarray(y, dtype=np.float64)
    exp_cap = np.log(np.finfo(y.dtype).max)

    def _reweight(resid, m, it):
        below = (resid < 0) & ~m
        if not below.any():
            return np.full_like(resid, 0.5)
        mu = np.mean(resid, where=below)
        sigma = np.std(resid, where=below)
        arg = np.clip(2 * (resid - (2 * sigma - mu)) * invert_no_zero(sigma), -exp_cap, exp_cap)
        return invert_no_zero(np.exp(arg) + 1.0)

    return penalized_least_squares_1d(y, _reweight, mask, lam, epsilon, max_iter)


def IarPLS_1d(y, mask=None, lam: float = 1e2, epsilon: float = 1e-2, max_iter: int = 100):
    """Improved asymmetrically reweighted PLS baseline (reference tools.py:783-841)."""
    y = np.asarray(y, dtype=np.float64)
    sqr_cap = np.finfo(y.dtype).max ** 0.5
    exp_cap = np.log(np.finfo(y.dtype).max)

    def _reweight(resid, m, it):
        below = (resid < 0) & ~m
        sigma = np.std(resid, where=below) if below.any() else 0.0
        gain = np.exp(np.clip(it + 1, -exp_cap, exp_cap))
        arg = np.clip(gain * (resid - 2 * sigma) * invert_no_zero(sigma), -sqr_cap, sqr_cap)
        return 0.5 * (1 - arg * invert_no_zero(np.hypot(1.0, arg)))

    return penalized_least_squares_1d(y, _reweight, mask, lam, epsilon, max_iter)


def apply_hysteresis_threshold(image, low, high):
    """Hysteresis thresholding (skimage.filters.apply_hysteresis_threshold), host scipy.

    Points above ``high`` are kept, plus any points above ``low`` connected
    (8-connectivity in 2D / full connectivity in nD) to a point above
    ``high``.
    """
    from scipy import ndimage

    image = np.asarray(image)
    mask_low = image > low
    mask_high = image > high
    labels, num = ndimage.label(mask_low, structure=np.ones((3,) * image.ndim, dtype=bool))
    if num == 0:
        return mask_high
    sums = np.bincount(labels.ravel(), weights=mask_high.ravel(), minlength=num + 1)
    good_label = sums > 0
    good_label[0] = False
    return good_label[labels]


def taper_mask(mask, nwidth: int, outer: bool = False, device=None) -> torch.Tensor:
    """Taper a 2D mask along the last axis with a Hann kernel (reference tools.py:844).

    The mask is edge-extended by the kernel's width, convolved row by row
    (``conv1d`` in float64 on the mask's device, or ``device`` for host
    input), thresholded at 1 and convolved again.  Returns a float64 tensor.
    """
    from ..device import as_tensor

    m = as_tensor(mask if isinstance(mask, torch.Tensor) else np.asarray(mask), device).to(torch.float64)
    m = torch.atleast_2d(m).reshape(-1, m.shape[-1])
    width = 2 * nwidth - 1
    kernel = torch.as_tensor(np.hanning(width), dtype=torch.float64, device=m.device)
    kernel = (kernel / kernel.sum()).reshape(1, 1, -1)

    tapered = torch.cat([m[:, :1].expand(-1, width), m, m[:, -1:].expand(-1, width)], dim=-1)
    if outer:
        tapered = 1.0 - tapered

    def conv(x):
        # np.convolve(row, kernel, "same"): the Hann kernel is symmetric
        return torch.nn.functional.conv1d(x[:, None], kernel, padding=(width - 1) // 2)[:, 0]

    tapered = conv(torch.isclose(conv(tapered), torch.ones((), dtype=torch.float64, device=m.device)).to(torch.float64))
    if outer:
        tapered = 1.0 - tapered
    return tapered[:, width:-width]


def _stack_inputs(index_map):
    """The correlator inputs (chan_id) of each stack entry's representative product."""
    inp = np.asarray(index_map["input"])
    input_map = inp["chan_id"] if inp.dtype.names else inp
    stack = np.asarray(index_map["stack"])
    prod = np.asarray(index_map["prod"])
    pi = stack["prod"] if stack.dtype.names else stack[:, 0]
    pa = prod[pi]["input_a"] if prod.dtype.names else prod[pi, 0]
    pb = prod[pi]["input_b"] if prod.dtype.names else prod[pi, 1]
    return input_map[pa].astype(int), input_map[pb].astype(int)


def polarization_map(index_map, telescope, exclude_autos: bool = True) -> np.ndarray:
    """Map each stack entry to pol = ['XX', 'XY', 'YX', 'YY'] (reference tools.py:417-500, vectorised; host).

    Entries that are autos (when excluded) or use non-standard feeds map
    to -1.
    """
    teltype = getattr(telescope, "stack_type", "redundant")
    if teltype != "redundant":
        raise RuntimeError(f"Telescope stack type needs to be 'redundant'. Is {teltype}")

    ipt0, ipt1 = _stack_inputs(index_map)
    beamclass = telescope.beamclass
    bc0 = beamclass[ipt0]
    bc1 = beamclass[ipt1]
    good = (bc0 <= 1) & (bc1 <= 1)
    if exclude_autos:
        good &= ipt0 != ipt1

    conj = telescope.feedconj[ipt0, ipt1]
    b0 = np.where(conj, bc1, bc0)
    b1 = np.where(conj, bc0, bc1)
    # pol index in ['XX', 'XY', 'YX', 'YY'] = 2*b0 + b1
    return np.where(good, 2 * b0 + b1, -1).astype(int)


def baseline_vector(index_map, telescope) -> np.ndarray:
    """Baseline vectors in metres, shape [2, nstack] (reference tools.py:503-543, vectorised; host)."""
    ipt0, ipt1 = _stack_inputs(index_map)
    unique_index = telescope.feedmap[ipt0, ipt1]
    return telescope.baselines[unique_index].T.astype(np.float64)
