"""Sidereal regridding and m-mode weights, as plain functions.

Port of the math of ``draco_tpu.analysis.transform``:
``LanczosRegridder._regrid`` (the maximum-likelihood inverse of a Lanczos
interpolation onto a regular sidereal grid, reference
transform.py:854-986) and the m-mode noise-weight formula of
``MModeTransform`` (reference transform.py:599-602).  The container and
task layers are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import regrid as regrid_ops
from ..ops.tools import invert_no_zero

__all__ = ["regrid_sidereal", "mmode_weights"]


def regrid_sidereal(
    vis: torch.Tensor,
    weight: torch.Tensor,
    times: np.ndarray,
    samples: int,
    start: float,
    end: float,
    kernel_width: int = 5,
    epsilon: float = 1e-3,
):
    """Regrid irregularly sampled data onto ``samples`` regular points.

    vis [..., ntime] (real or complex) and its inverse-noise weight [...,
    ntime] at host sample times ``times`` [ntime]; the output grid spans
    ``[start, end)``.  The Wiener solve runs on ``vis.device`` in the real
    dtype of ``vis``.

    Returns ``(grid [samples] numpy, vis_out [..., samples], ni [...,
    samples])`` where ``ni`` is the inverse-noise weight of each output
    sample.
    """
    times = np.asarray(times, dtype=np.float64)
    if start < times[0] or end > times[-1]:
        raise ValueError("start or end of the regrid falls outside the sample times")
    # padded output grid, trimmed after the solve to drop the edge wrap
    pad = 5 * kernel_width
    span = end - start
    ticks = np.arange(-pad, samples + pad, dtype=np.float64)
    grid = start + span * ticks / samples

    rdt = vis.real.dtype
    projector = regrid_ops.lanczos_forward_matrix(grid, times, kernel_width).T
    R = torch.as_tensor(np.ascontiguousarray(projector), dtype=rdt).to(vis.device)
    Si = torch.full((grid.size,), epsilon, dtype=rdt, device=vis.device)

    ntime = vis.shape[-1]
    solved, ni = regrid_ops.band_wiener(
        R,
        weight.reshape(-1, ntime).to(rdt).contiguous(),
        Si,
        vis.reshape(-1, ntime),
        2 * kernel_width - 1,
    )
    out_shape = (*vis.shape[:-1], samples)
    solved = solved[:, pad:-pad].reshape(out_shape)
    ni = ni[:, pad:-pad].reshape(out_shape)
    return grid[pad:-pad].copy(), solved, ni


def mmode_weights(ni: torch.Tensor, mmax: int) -> torch.Tensor:
    """m-mode noise weights from sidereal inverse-noise weights.

    ni [..., nra] -> [mmax+1, 2, ...]: the inverse of the summed
    per-sample variances times nra^2, the same for every (m, msign).
    """
    nra = ni.shape[-1]
    var_sum = invert_no_zero(ni).sum(dim=-1)
    weight_sum = nra**2 * invert_no_zero(var_sum)
    return weight_sum.expand(mmax + 1, 2, *weight_sum.shape).contiguous()
