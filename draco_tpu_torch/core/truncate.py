"""Lossy mantissa truncation for storage.

The reference's container specs mark selected datasets for bit
truncation before compression (reference draco/core/containers.py:
510-523 — ``"truncate": True`` for a fixed relative precision, or
``{"weight_dataset": ...}`` to derive a per-element tolerance from the
inverse-variance weights; the algorithm itself lives in the caput
dependency, which is not vendored with the reference). Rounding away
mantissa bits that sit below the statistical noise floor makes the
gzip-compressed HDF5 datasets several times smaller at no scientific
cost.

This is an I/O-time transform, so it runs as vectorised numpy bit
manipulation on the host: the datasets are copied to the host for the
write anyway, so the mantissas are rounded there.

Semantics
---------
``bit_truncate(x, abs_tol)`` rounds each element of ``x`` to the
fewest mantissa bits such that the rounding error stays strictly within
the elementwise absolute tolerance; elements with ``|x| <= abs_tol``
are flushed to zero (long runs of identical bytes are what the
compressor feeds on). Tolerances that are zero, negative or non-finite
leave the element untouched, as do non-finite values.

Defaults: relative precision ``1e-5`` (aligned with the framework's
end-to-end accuracy budget, BASELINE.json) and a weight-derived
``variance_increase`` of ``1e-3`` (truncation noise adds at most 0.1%
to the variance already present in the data).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "bit_truncate",
    "bit_truncate_relative",
    "bit_truncate_weights",
    "truncate_dataset",
    "DEFAULT_PRECISION",
    "DEFAULT_VARIANCE_INCREASE",
]

DEFAULT_PRECISION = 1e-5
DEFAULT_VARIANCE_INCREASE = 1e-3

# dtype -> (unsigned view dtype, mantissa bits, exponent field mask, bias)
_FLOAT_SPEC = {
    np.dtype(np.float32): (np.uint32, 23, 0xFF, 127),
    np.dtype(np.float64): (np.uint64, 52, 0x7FF, 1023),
}

_COMPLEX_PARTS = {
    np.dtype(np.complex64): np.float32,
    np.dtype(np.complex128): np.float64,
}


def bit_truncate(x: np.ndarray, abs_tol) -> np.ndarray:
    """Round ``x`` so each element's error is below ``abs_tol``.

    Parameters
    ----------
    x
        Float or complex array (f32/f64/c64/c128). Returned unchanged
        (as a copy) for any other dtype.
    abs_tol
        Scalar or array broadcastable to ``x.shape``: the largest
        acceptable absolute error per element. For complex input the
        tolerance applies to the real and imaginary parts separately.

    Returns
    -------
    A new array of the same dtype with low-order mantissa bits rounded
    away wherever the tolerance allows.
    """
    x = np.asarray(x)

    part = _COMPLEX_PARTS.get(x.dtype)
    if part is not None:
        tol = np.asarray(abs_tol)
        re = bit_truncate(np.ascontiguousarray(x.real), tol)
        im = bit_truncate(np.ascontiguousarray(x.imag), tol)
        out = np.empty(x.shape, dtype=x.dtype)
        out.real = re
        out.imag = im
        return out

    spec = _FLOAT_SPEC.get(x.dtype)
    if spec is None:
        return np.array(x, copy=True)

    uty, mbits, emax, bias = spec
    tol = np.asarray(abs_tol, dtype=np.float64)

    out = np.ascontiguousarray(x).copy()
    if out.size == 0:
        return out
    ui = out.view(uty)

    sign_bit = uty(1) << uty(mbits + emax.bit_length())
    sign = ui & sign_bit
    mag = ui & (sign_bit - uty(1))
    e_v = (mag >> uty(mbits)).astype(np.int64)

    tol_ok = np.isfinite(tol) & (tol > 0)
    # floor(log2(tol)) + 1: frexp gives tol = m * 2**et with m in [0.5, 1)
    _, et = np.frexp(np.where(tol_ok, tol, 1.0))
    # Largest b with rounding error 2**(b-1) ulp = 2**(b-1+e_v-bias-mbits)
    # guaranteed <= 2**(et-1) <= tol.
    b = np.clip(et.astype(np.int64) - e_v + (bias + mbits), 0, mbits)

    finite = e_v != emax  # excludes inf/nan
    normal = e_v != 0  # excludes zero/subnormal (different ulp scale)
    # e_v == emax-1 could carry into inf when the round-half is added;
    # values that large are never truncation candidates in practice.
    safe = e_v < emax - 1
    flush = tol_ok & finite & (np.abs(out) <= tol)
    apply = tol_ok & normal & safe & (b > 0) & ~flush

    bb = b.astype(uty)
    one = uty(1)
    half = np.left_shift(one, bb - np.where(apply, one, uty(0)))
    keep = ~(np.left_shift(one, bb) - one)
    # Adding the half-ulp may carry from the mantissa into the exponent
    # field — in IEEE bit ordering that *is* correct round-to-nearest.
    rounded = (mag + np.where(apply, half, uty(0))) & np.where(apply, keep, ~uty(0))

    new = np.where(apply, sign | rounded, ui)
    new = np.where(flush, uty(0), new)
    ui[...] = new
    return out


def bit_truncate_relative(x: np.ndarray, prec: float = DEFAULT_PRECISION) -> np.ndarray:
    """Truncate to a relative precision: error < ``prec * |x|`` per element."""
    x = np.asarray(x)
    return bit_truncate(x, prec * np.abs(x))


def bit_truncate_weights(
    x: np.ndarray,
    weight: np.ndarray,
    variance_increase: float = DEFAULT_VARIANCE_INCREASE,
    fallback_prec: float = DEFAULT_PRECISION,
) -> np.ndarray:
    """Truncate with a noise-derived tolerance.

    ``weight`` is an inverse variance (the framework's universal weight
    convention); the tolerance ``sqrt(variance_increase / weight)``
    bounds the extra variance truncation injects to a fraction
    ``variance_increase`` of the noise already present. Elements with
    non-positive weight fall back to relative truncation at
    ``fallback_prec``.
    """
    x = np.asarray(x)
    w = np.asarray(weight, dtype=np.float64)
    w = np.broadcast_to(w, x.shape)
    good = w > 0
    tol = np.sqrt(variance_increase / np.where(good, w, 1.0))
    tol = np.where(good, tol, fallback_prec * np.abs(x))
    return bit_truncate(x, tol)


def truncate_dataset(arr: np.ndarray, tspec, weight: np.ndarray | None) -> np.ndarray:
    """Apply a container-spec ``truncate`` entry to ``arr``.

    ``tspec`` is the spec value (``True`` or a dict with optional
    ``weight_dataset`` / ``variance_increase``); ``weight`` is the
    resolved weight array (or None when unavailable, in which case the
    weight-based request degrades to relative truncation).
    """
    if arr.dtype not in _FLOAT_SPEC and arr.dtype not in _COMPLEX_PARTS:
        return arr
    if isinstance(tspec, dict) and tspec.get("weight_dataset"):
        if weight is not None and np.shape(weight) == arr.shape:
            return bit_truncate_weights(
                arr,
                weight,
                variance_increase=tspec.get(
                    "variance_increase", DEFAULT_VARIANCE_INCREASE
                ),
            )
    return bit_truncate_relative(arr, DEFAULT_PRECISION)
