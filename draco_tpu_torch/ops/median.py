"""Weighted median routines (host).

Port of ``draco_tpu.ops.median``: replacements for the caput
``algorithms.median`` Cython module (usage at reference
draco/analysis/flagging.py:1329-1331, 1655-1665, 1692-1754).
:func:`weighted_median` and :func:`moving_weighted_median` run the
OpenMP kernels of :mod:`draco_tpu_torch.native` (``method="native"``, the
default) or, when the caller asks for it with ``method="numpy"``, the
vectorised sort-and-cumulate formulation, the plain version the native
one is held against.  Both give the same medians: each picks values of
the input, and with integer weights (masks) the cumulative sums are exact.
"""

from __future__ import annotations

import numpy as np

from .. import native

__all__ = ["weighted_median", "moving_weighted_median", "quantile"]


_METHODS = ("native", "numpy")


def _check_method(method: str) -> None:
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, not {method!r}")


def weighted_median(x, w, axis: int = -1, method: str = "native"):
    """Weighted median of ``x`` along ``axis`` ("split" convention).

    Samples with zero weight are ignored; rows with no valid samples
    return 0.  With unit weights this matches ``np.median``.
    """
    _check_method(method)
    x0 = np.asarray(x, dtype=np.float64)
    w0 = np.broadcast_to(np.asarray(w, dtype=np.float64), x0.shape)
    x = np.moveaxis(x0, axis, -1)
    w = np.moveaxis(w0, axis, -1)
    if method == "native":
        return native.weighted_median(x, w)

    order = np.argsort(x, axis=-1)
    xs = np.take_along_axis(x, order, -1)
    ws = np.take_along_axis(w, order, -1)

    cw = np.cumsum(ws, axis=-1)
    tot = cw[..., -1:]
    half = 0.5 * tot

    # 'split': average the lowest value with cumweight >= half and the
    # lowest with cumweight > half
    lo = np.argmax(cw >= half, axis=-1)
    hi = np.argmax(cw > half, axis=-1)
    med = 0.5 * (
        np.take_along_axis(xs, lo[..., None], -1)[..., 0]
        + np.take_along_axis(xs, hi[..., None], -1)[..., 0]
    )
    return np.where(tot[..., 0] > 0, med, 0.0)


def quantile(x, w, q, axis: int = -1):
    """Weighted quantile of ``x`` along ``axis``.

    Native replacement for caput ``algorithms.median.quantile`` (used by
    reference draco/analysis/flagging.py:1937 ``RFISensitivityMask._mask_1d``):
    the weighted ``q``-quantile with the same "split" convention as
    :func:`weighted_median` — with ``q=0.5`` the two agree exactly.
    Samples with zero weight are ignored; rows with no valid samples
    return 0.
    """
    q = float(q)
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"Quantile must be in [0, 1], got {q}.")
    x0 = np.asarray(x, dtype=np.float64)
    w0 = np.broadcast_to(np.asarray(w, dtype=np.float64), x0.shape)
    x = np.moveaxis(x0, axis, -1)
    w = np.moveaxis(w0, axis, -1)

    order = np.argsort(x, axis=-1)
    xs = np.take_along_axis(x, order, -1)
    ws = np.take_along_axis(w, order, -1)

    cw = np.cumsum(ws, axis=-1)
    tot = cw[..., -1:]
    target = q * tot

    # zero-weight samples are IGNORED at the extremes too: at q=0 the
    # lower bracket must land on the first sample with weight (cw >= 0
    # is satisfied by a leading flagged sample), and at q=1 the clamp
    # must pick the LAST weighted sample, not whatever sorts after it
    has_w = ws > 0
    idx = np.arange(x.shape[-1])
    first_valid = np.argmax(has_w, axis=-1)
    last_valid = x.shape[-1] - 1 - np.argmax(has_w[..., ::-1], axis=-1)

    lo = np.argmax((cw >= target) & has_w, axis=-1)
    lo = np.where(((cw >= target) & has_w).any(axis=-1), lo, first_valid)
    hi = np.argmax((cw > target) & has_w, axis=-1)
    hi = np.where(((cw > target) & has_w).any(axis=-1), hi, last_valid)
    del idx
    med = 0.5 * (
        np.take_along_axis(xs, lo[..., None], -1)[..., 0]
        + np.take_along_axis(xs, hi[..., None], -1)[..., 0]
    )
    return np.where(tot[..., 0] > 0, med, 0.0)


def moving_weighted_median(x, w, size, method: str = "native"):
    """Moving-window weighted median of ``x``.

    1-D input with a scalar (odd) ``size`` filters along the single axis;
    otherwise filters over the last two axes with ``size = (s0, s1)``.

    Equivalent of caput ``median.moving_weighted_median``: each output
    sample is the weighted median over a centred ``size = (s0, s1)``
    window; samples outside the edges carry zero weight.

    ``method="native"`` runs the OpenMP kernel; ``"numpy"`` materialises
    the windows with ``sliding_window_view`` and reduces them with one
    vectorised weighted median, chunked over rows to bound memory.
    """
    _check_method(method)
    x = np.asarray(x, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    if x.ndim == 1 and np.isscalar(size):
        # caput's 1-D form (reference flagging.py:1944): window along the
        # single axis.
        out = moving_weighted_median(x[:, None], w[:, None], (int(size), 1), method=method)
        return out[:, 0]
    if np.isscalar(size):
        size = (int(size), int(size))
    s0, s1 = int(size[0]), int(size[1])
    if s0 % 2 == 0 or s1 % 2 == 0:
        raise ValueError(f"Window sizes must be odd, got {size}.")
    if method == "native":
        return native.moving_weighted_median(x, w, (s0, s1))

    lead = x.shape[:-2]
    n0, n1 = x.shape[-2:]
    x2 = x.reshape(-1, n0, n1)
    w2 = np.broadcast_to(w, x.shape).reshape(-1, n0, n1)

    p0, p1 = s0 // 2, s1 // 2
    pad = ((0, 0), (p0, p0), (p1, p1))
    xp = np.pad(x2, pad, mode="edge")
    wp = np.pad(w2, pad, mode="constant", constant_values=0.0)

    out = np.empty_like(x2)

    # Chunk over the first (batch * row) extent to bound window memory
    max_elems = 16_000_000
    rows_per_chunk = max(1, int(max_elems / max(n1 * s0 * s1, 1)))

    for b in range(x2.shape[0]):
        for r0 in range(0, n0, rows_per_chunk):
            r1 = min(r0 + rows_per_chunk, n0)
            xv = np.lib.stride_tricks.sliding_window_view(
                xp[b, r0 : r1 + 2 * p0], (s0, s1)
            ).reshape(r1 - r0, n1, -1)
            wv = np.lib.stride_tricks.sliding_window_view(
                wp[b, r0 : r1 + 2 * p0], (s0, s1)
            ).reshape(r1 - r0, n1, -1)
            out[b, r0:r1] = weighted_median(xv, wv, axis=-1, method="numpy")

    return out.reshape(*lead, n0, n1)
