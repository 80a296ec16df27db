"""RFI excision on the device: SumThreshold and the scale-invariant rank.

Port of ``draco_tpu.ops.rfi`` (reference ``draco/util/rfi.py``:
sumthreshold_py:8, scale_invariant_rank:205, sir:260):

* **SumThreshold** flags progressively longer runs of contaminated
  samples.  Every windowed sum is a cumulative-sum difference along the
  swept axis, batched over all the others.
* **SIR** (scale-invariant rank, arXiv:1201.3364) flags sample ``i`` iff
  some window ``[a, b)`` containing it has ``sum (mask - 1 + eta) >= 0``;
  with ``P`` the prefix sums of that weight this is ``max_{b > i} P[b] >=
  min_{a <= i} P[a]``: a forward ``cummin`` and a reverse ``cummax``.

Both run as torch ops on a device: the input tensor's, or ``device`` for
host input (:func:`draco_tpu_torch.device.resolve`: the first CUDA card
unless the CPU is asked for).  They work in float64 everywhere.  The JAX
package works in float32 on its chip (``draco_tpu/ops/rfi.py:41``), where
the cumulative sums over a day of 8640 samples lose ~1e-4 of a window sum
and flip samples that lie near the threshold; the H100 has float64.  The
masks come back as host numpy booleans, as container masks are.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import as_tensor

__all__ = ["sumthreshold", "sumthreshold_py", "scale_invariant_rank", "sir1d", "sir"]


def _to_device(x, device, dtype):
    """``x`` as a tensor of ``dtype``: a tensor stays on its device unless
    ``device`` is named; host data goes to ``device``."""
    return as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x), device).to(dtype)


def _trailing_window_sum(x: torch.Tensor, m: int) -> torch.Tensor:
    """``y[i] = sum(x[i-m+1 : i+1])`` along the last axis, edge-replicated.

    Matches the alignment of the reference's window-sum correlation
    (``correlate1d(..., origin=(m-1)//2, mode="nearest")``).
    """
    if m == 1:
        return x
    n = x.shape[-1]
    xp = torch.cat([x[..., :1].expand(*x.shape[:-1], m - 1), x], dim=-1)
    c = torch.cumsum(xp, dim=-1)
    c0 = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    return c0[..., m:] - c0[..., :n]


def _leading_window_any(mask: torch.Tensor, m: int) -> torch.Tensor:
    """``y[i] = any(mask[i : i+m])`` along the last axis, edge-replicated.

    The back-spread step: a window whose sum trips the threshold has its
    right edge at the hit position, so each output looks ``m-1`` places
    to the right.
    """
    if m == 1:
        return mask
    n = mask.shape[-1]
    xi = mask.to(torch.int32)
    xp = torch.cat([xi, xi[..., -1:].expand(*xi.shape[:-1], m - 1)], dim=-1)
    c = torch.cumsum(xp, dim=-1)
    c0 = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    return (c0[..., m:] - c0[..., :n]) > 0


def _masked_quantile(x: torch.Tensor, valid: torch.Tensor, q: float) -> torch.Tensor:
    """Quantile of ``x[valid]`` with numpy's linear interpolation, by a sort
    (``torch.quantile`` refuses inputs above 2^24 elements)."""
    s = torch.sort(torch.where(valid, x, torch.inf).reshape(-1)).values
    n = int(valid.sum())
    pos = q * (max(n, 1) - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def sumthreshold(
    data,
    max_m: int = 16,
    start_flag=None,
    threshold1=None,
    remove_median: bool = True,
    correct_for_missing: bool = True,
    variance=None,
    rho=None,
    axes=None,
    only_positive: bool = False,
    device=None,
) -> np.ndarray:
    """Multi-scale SumThreshold outlier mask, computed on the device.

    Parameters mirror reference ``draco/util/rfi.py:8-140``: window lengths
    double from 1 to ``max_m``; ``threshold1`` is the single-sample
    threshold (default: 95th percentile of the unflagged data, or required
    in units of sigma when ``variance`` is supplied); ``rho`` controls the
    per-octave threshold falloff; ``axes`` lists the axes to sweep (default
    all, last first).  Non-finite samples and ``start_flag`` seed the mask.

    Returns a boolean numpy mask of the same shape as ``data``.
    """
    d = _to_device(data, device, torch.float64)
    dev = d.device
    if axes is None:
        axes = tuple(range(d.ndim - 1, -1, -1))
    elif np.isscalar(axes):
        axes = (int(axes),)
    else:
        axes = tuple(int(a) for a in axes)

    use_variance = variance is not None
    if use_variance:
        correct_for_missing = True
        if threshold1 is None:
            raise RuntimeError(
                "sumthreshold: supplying a variance estimate requires an explicit threshold1 (in units of sigma)."
            )
    if rho is None:
        rho = 0.9428 if correct_for_missing else 1.5

    flag = ~torch.isfinite(d)
    if start_flag is not None:
        flag |= _to_device(start_flag, dev, torch.bool)
    var = _to_device(variance, dev, torch.float64) if use_variance else None

    valid = ~flag
    if remove_median:
        d = d - _masked_quantile(d, valid, 0.5)
    thresh1 = _masked_quantile(d, valid, 0.95) if threshold1 is None else float(threshold1)

    m = 1
    while m <= max_m:
        thresh = thresh1 / float(rho) ** np.log2(m)
        for axis in axes:
            ds = torch.where(flag, 0.0, d)
            cnt = torch.where(flag, 0.0, var) if use_variance else (~flag).to(d.dtype)
            dsum = _trailing_window_sum(torch.movedim(ds, axis, -1), m)
            csum = _trailing_window_sum(torch.movedim(cnt, axis, -1), m)
            if correct_for_missing:
                csum = torch.sqrt(csum)
            excess = dsum if only_positive else torch.abs(dsum)
            hit = excess > csum * thresh
            flag = flag | torch.movedim(_leading_window_any(hit, m), -1, axis)
        m *= 2

    return flag.cpu().numpy()


def sumthreshold_py(*args, **kwargs):
    """Alias kept for reference-path compatibility (the reference exposes
    its pure-python implementation under this name)."""
    return sumthreshold(*args, **kwargs)


def _sir_along_last(mask: torch.Tensor, eta: float) -> torch.Tensor:
    # mask + (eta - 1), kept in this exact form: flagged samples weigh
    # 1 + (eta - 1), which differs from eta in the last bit, and the >=
    # comparison below ties on exactly these values (reference parity)
    w = mask.to(torch.float64) + (eta - 1.0)
    p = torch.cumsum(w, dim=-1)
    p0 = torch.cat([torch.zeros_like(p[..., :1]), p], dim=-1)
    # best window start at or before i / best window end strictly after i,
    # including windows that end at the array end (the definitional SIR,
    # applied symmetrically, as the JAX package does)
    best_start = torch.cummin(p0[..., :-1], dim=-1).values
    best_end = torch.flip(torch.cummax(torch.flip(p0[..., 1:], (-1,)), dim=-1).values, (-1,))
    return mask | (best_end >= best_start)


def sir1d(basemask, eta: float = 0.2, axis: int = -1, device=None) -> np.ndarray:
    """Scale-invariant-rank dilation of a boolean mask along one axis.

    A sample is flagged when it lies inside any window whose flagged
    fraction is at least ``1 - eta`` (arXiv:1201.3364); ``eta = 0``
    returns the mask unchanged, ``eta = 1`` flags everything.  Runs as two
    directional scans on the device, batched over all other axes.
    Semantics of reference ``draco/util/rfi.py:147-204``.  Windows whose
    flagged fraction is *exactly* ``1 - eta`` sit on a float tie whose
    direction depends on the summation order of the prefix sums.
    """
    m = _to_device(basemask, device, torch.bool)
    ax = axis % m.ndim
    out = _sir_along_last(torch.movedim(m, ax, -1), float(eta))
    return torch.movedim(out, -1, ax).cpu().numpy()


def scale_invariant_rank(basemask, eta=0.2, axis=-1, device=None) -> np.ndarray:
    """SIR applied independently along each listed axis, OR-combined.

    Each axis dilates the *original* mask; results are unioned.  ``eta``
    may be a scalar or a per-axis sequence.  Semantics of reference
    ``draco/util/rfi.py:205-259``.
    """
    basemask = np.asarray(basemask.cpu() if isinstance(basemask, torch.Tensor) else basemask, dtype=bool)
    if basemask.ndim < 1:
        raise ValueError("scale_invariant_rank: mask must be at least 1-D.")
    axis = (axis,) if np.isscalar(axis) else tuple(axis)
    eta = (eta,) * len(axis) if np.isscalar(eta) else tuple(eta)
    if len(eta) != len(axis):
        raise ValueError(
            f"scale_invariant_rank: got {len(eta)} eta values for {len(axis)} axes; they must pair up one-to-one."
        )
    out = np.zeros_like(basemask)
    for ax, et in zip(axis, eta):
        out |= sir1d(basemask, eta=et, axis=ax, device=device)
    return out


def sir(basemask, eta: float = 0.2, only_freq: bool = False, only_time: bool = False, device=None) -> np.ndarray:
    """SIR over the freq and time axes of a ``[freq, prod, time]`` mask.

    Deprecated in the reference (``draco/util/rfi.py:260``) but kept for
    parity.
    """
    basemask = np.asarray(basemask, dtype=bool)
    if basemask.ndim != 3:
        raise ValueError(f"sir expects a [freq, prod, time] mask; got {basemask.ndim}-D.")
    if only_freq and only_time:
        raise ValueError("sir: only_freq and only_time are mutually exclusive.")
    axes = []
    if not only_time:
        axes.append(0)
    if not only_freq:
        axes.append(2)
    return basemask | scale_invariant_rank(basemask, eta=eta, axis=tuple(axes), device=device)
