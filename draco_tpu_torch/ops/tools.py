"""Numeric tools of the round trip: exact fringe phases and safe inverses.

Port of the fringe subset of ``draco_tpu.ops.tools``
(``twofloat_split``, ``phase_frac``, ``threefloat_split``,
``phase_frac3``, ``sincos_turns``), ``invert_no_zero`` and the host key
lookups ``find_key``/``find_keys``.

The exact-phase scheme rests on every high product being an exact
float32 value and on no fused multiply-add changing a rounded product.
Eager PyTorch runs each elementwise op as its own kernel, so the
expressions below are kept as separate multiplies and adds: do not
rewrite them with ``addcmul`` or compile them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "invert_no_zero", "twofloat_split", "phase_frac", "threefloat_split", "phase_frac3", "sincos_turns",
    "find_key", "find_keys",
]

# Veltkamp split constant for float32 (2^12 + 1)
_DEKKER_SPLIT = 4097.0


def invert_no_zero(x: torch.Tensor) -> torch.Tensor:
    """Reciprocal returning exactly zero where ``|x|`` is below the smallest normal."""
    small = torch.abs(x) < torch.finfo(x.real.dtype).tiny
    return torch.where(small, torch.zeros_like(x), 1.0 / torch.where(small, torch.ones_like(x), x))


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
