"""Gaussian-process regression resampling.

Port of ``draco_tpu.ops.gaussian_process``, which re-provides reference
``draco/util/gaussian_process.py`` (resample:11, interpolate_unweighted:71,
_select_interp_samples:229, _combine_gp_kernels_from_specs:290,
_build_gp_kernels_from_spec:324).

The kernels (:mod:`draco_tpu_torch.ops.kernels`) and the output-sample
selection are host numpy; the projection runs on the data's device: masked
rows are padded to an identity block and every row's operator ``A = K*
K^-1`` comes from one batched solve in float64, with the data and variance
propagated by two batched products.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import kernels
from .tools import invert_no_zero

__all__ = ["resample", "interpolate_unweighted"]


def resample(
    data: torch.Tensor,
    weight: torch.Tensor,
    xi,
    xo,
    cutoff_dist: float = 1.0,
    cutoff_partition: int = 0,
    kernel_spec=None,
):
    """Resample a dataset with a GP kernel (reference gaussian_process.py:11).

    Parameters
    ----------
    data : [nbatch, nsamp_in, nother] tensor
        Data; the second axis is interpolated.
    weight : tensor broadcastable to ``data``
        Inverse-variance weights.
    xi, xo : host arrays
        Input / output sample locations.
    cutoff_dist : float
        Maximum distance (input samples) from the nth nearest unflagged
        input to keep an output sample.
    cutoff_partition : int
        Which nearest sample the cutoff refers to.
    kernel_spec : dict or list of dicts
        Kernel name/width/parameters.

    Returns
    -------
    xout [nbatch, nsamp_out, nother] in the dtype of ``data``, wout (float64)
    """
    if kernel_spec is None:
        kernel_spec = {}
    if not isinstance(kernel_spec, (list, tuple)):
        kernel_spec = [kernel_spec]

    Ki, Ks = _combine_gp_kernels_from_specs((xo, xi), kernel_spec)

    kwidth = 0.0
    for spec in kernel_spec:
        kwidth = max(kwidth, spec.get("width", 0.0))

    weight = weight.expand(data.shape)
    inp_mask = (weight != 0).any(dim=-1).cpu().numpy()
    xm = _select_interp_samples(xi, xo, inp_mask, kwidth, cutoff_dist, cutoff_partition)
    if not np.any(xm):
        # the reference returns silent zeros; at least say why (a kernel
        # width <= 1 makes the strict kw_cutoff comparison unsatisfiable)
        logging.getLogger(__name__).warning(
            "GP resample: every output sample is outside the kernel "
            f"support (kwidth={kwidth}); returning zeros."
        )

    return interpolate_unweighted(data, weight, Ki, Ks, interp_samples=xm)


def _gp_project_batch(data: torch.Tensor, weight: torch.Tensor, K: torch.Tensor, Kstar: torch.Tensor):
    """Batched GP projection: one identity-padded solve for every row.

    data, weight : [B, ns, nj]; K : [ns, ns]; Kstar : [nt, ns], float64.
    Returns (xout [B, nt, nj], var [B, nt, nj]).
    """
    # row mask collapsed over the trailing axis (reference gaussian_process.py:90)
    m = (weight > 0).any(dim=-1)  # [B, ns]
    mf = m.to(K.dtype)

    M2 = mf[:, :, None] * mf[:, None, :]
    eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    Kp = K[None] * M2 + eye * (1.0 - mf[:, None, :] * eye)

    # A[b] = Kstar K_b^-1, masked to valid source columns
    A = torch.linalg.solve(Kp, Kstar.T.expand(m.shape[0], *Kstar.T.shape)).transpose(1, 2)
    A = A * mf[:, None, :]

    valid = (weight > 0).to(data.real.dtype)
    xout = torch.matmul(A.to(data.dtype), data * valid)
    var = torch.matmul((A**2).to(weight.dtype), invert_no_zero(weight))
    return xout, var


def interpolate_unweighted(data: torch.Tensor, weight: torch.Tensor, K, Kstar, interp_samples=None):
    """GP interpolation assuming noise-free signal (reference :71).

    All rows are solved in one batched call on the data's device: the
    operators in float64, the data projected in its own dtype, as the JAX
    package does.
    """
    dev = data.device
    weight = weight.expand(data.shape).to(torch.float64)
    xout, var = _gp_project_batch(
        data,
        weight,
        torch.as_tensor(np.asarray(K, dtype=np.float64), device=dev),
        torch.as_tensor(np.asarray(Kstar, dtype=np.float64), device=dev),
    )
    wout = invert_no_zero(var)

    if interp_samples is not None:
        sel = torch.as_tensor(np.asarray(interp_samples), device=dev)[..., None]
        xout = xout * sel
        wout = wout * sel

    # clip numerical-noise negatives
    bad = wout < 0
    xout = torch.where(bad, torch.zeros_like(xout), xout)
    wout = torch.where(bad, torch.zeros_like(wout), wout)
    return xout, wout


def _select_interp_samples(xi, xo, mask, kwidth, cutoff, partition: int = 0):
    """Mask output samples too far from valid inputs (reference :229)."""
    dist = np.subtract.outer(xo, xi)
    dist /= np.median(np.abs(np.diff(xi)))

    out = np.empty((mask.shape[0], xo.shape[0]), dtype=bool)
    kw_cutoff = kwidth - 1

    for ii in range(mask.shape[0]):
        mi = mask[ii]
        if not np.any(mi):
            out[ii] = False
            continue

        dmi = dist[:, mi]
        pdist = np.min(dmi, axis=-1, where=dmi > 0, initial=kw_cutoff)
        ndist = np.max(dmi, axis=-1, where=dmi < 0, initial=-kw_cutoff)

        out[ii] = np.maximum(pdist, abs(ndist)) < kw_cutoff
        part = min(partition, dmi.shape[-1] - 1)
        out[ii] &= np.partition(np.abs(dmi), part, axis=-1)[:, part] < cutoff

    return out


def _combine_gp_kernels_from_specs(samples, kernel_params):
    """Multiply kernels from multiple specs, accumulating epsilon (:290)."""
    if not isinstance(kernel_params, (list, tuple)):
        kernel_params = [kernel_params]

    Ki = None
    Ks = None
    epsilon = None

    for kspec in kernel_params:
        kspec = dict(kspec)
        var = kspec.pop("epsilon", 0.0)
        ki, ks = _build_gp_kernels_from_spec(samples, kspec)

        if Ki is None:
            Ki, Ks = ki, ks
            epsilon = np.zeros(Ki.shape[0], dtype=Ki.dtype)
        else:
            Ki = Ki * ki
            Ks = Ks * ks

        epsilon += var

    Ki = Ki + np.diag(epsilon)
    return Ki, Ks


def _build_gp_kernels_from_spec(samples, kernel_spec):
    """Build (input, projection) kernels from one spec (:324)."""
    kernel_spec = dict(kernel_spec)
    xo, xi = samples

    dx = np.median(np.abs(np.diff(xi)))

    width = kernel_spec.pop("width", 1.0) * dx
    name = kernel_spec.pop("name", "gaussian")
    epsilon = kernel_spec.pop("epsilon", 0.0)

    fn = kernels._KERNELS[name]
    Ki = fn(xi, width=width, **kernel_spec)
    Ki = Ki + epsilon * np.eye(Ki.shape[0])
    Ks = fn(xo, xi, width=width, **kernel_spec)

    return Ki.astype(np.float64), Ks.astype(np.float64)
