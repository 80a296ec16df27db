"""Interferometry helpers: fringestop phases and source beamforming.

Port of ``draco_tpu.ops.interferometry``, which re-provides reference
``draco/util/interferometry.py`` (fringestop_phase:15) and replaces the
Cython ``beamform`` (reference draco/util/_fast_tools.pyx:211).

The three beamformers (:func:`beamform_kernel`, one source's window;
:func:`beamform_sources_batched`, a batch of sources with the hour angle
collapsed; :func:`beamform_sources_batched_ha`, HA-resolved) reduce to one
contraction, :func:`beamform_sums`: for every (freq, source, HA) the
weighted fringestopped sum over the products, the summed weight and, for
natural weights, the propagated variance.  On the card it is the
hand-written CUDA kernel ``csrc/beamform.cu``
(:func:`draco_tpu_torch.ops.cuda_kernels.beamform_sums`); on the CPU its
plain version :func:`beamform_sums_plain`.  The primary-beam weighting, the
HA collapse and the normalisation act on ``[freq, source, HA]`` arrays in
torch, as the JAX programs write them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cuda_kernels
from .tools import invert_no_zero

__all__ = [
    "projected_distance",
    "fringestop_phase",
    "beamform_sums_plain",
    "beamform_kernel",
    "beamform_sources_batched",
    "beamform_sources_batched_ha",
]


def _sincos(x):
    """(sin, cos) of a tensor on its device, a scalar as Python floats, else numpy."""
    if isinstance(x, torch.Tensor):
        return torch.sin(x), torch.cos(x)
    if np.ndim(x) == 0:
        return math.sin(float(x)), math.cos(float(x))
    return np.sin(x), np.cos(x)


def projected_distance(ha, lat, dec, u, v, w=0.0):
    """Baseline distance projected towards a source, in wavelengths.

    All angles in radians; (u, v, w) = (EW, NS, up) baseline components of
    (d_i - d_j) / lambda.  Arguments broadcast together; tensors stay on
    their device, host data comes back as numpy.
    """
    sinh, cosh_ = _sincos(ha)
    sind, cosd = _sincos(dec)
    sinl, cosl = _sincos(lat)
    return u * cosd * sinh + v * (cosl * sind - sinl * cosd * cosh_) + w * (sinl * sind + cosl * cosd * cosh_)


def fringestop_phase(ha, lat, dec, u, v, w=0.0):
    """Phase that *corrects* the fringing for a source at (ha, dec).

    (reference interferometry.py:15-44)
    """
    d = projected_distance(ha, lat, dec, u, v, w)
    if isinstance(d, torch.Tensor):
        return torch.polar(torch.ones_like(d), -2.0 * math.pi * d)
    return np.exp(-2.0j * np.pi * d)


def beamform_sums_plain(vis, sw, vw, ra_idx, a, b, u, v, natural: bool):
    """The beamforming contraction, written out in torch.

    vis [nfreq, nra, nprod] complex; sw, vw [nfreq, nra, nprod] real (vw
    only read for natural weights); ra_idx [S, nha] int; a = cos(dec)
    sin(H) and b = cos(lat) sin(dec) - sin(lat) cos(dec) cos(H), both [S,
    nha]; u, v [nfreq, nprod] in wavelengths.  With r = ra_idx[s, h] and d
    = u[f, p] a[s, h] + v[f, p] b[s, h] (turns), returns [nfreq, S, nha]
    sums over p:

    - F = sum sw[f, r, p] Re(vis[f, r, p] exp(-2 pi i d)),
    - W = sum sw[f, r, p],
    - Q = sum sw[f, r, p]^2 invert_no_zero(vw[f, r, p]) (None unless ``natural``).

    The phase is reduced to ``d - round(d)`` turns before the sine and
    cosine, as the CUDA kernel does.  It gathers the [nfreq, S, nha, nprod]
    windows: the card's kernel exists so that nothing of that size is made.
    """
    nfreq = vis.shape[0]
    S, nha = ra_idx.shape
    flat = ra_idx.reshape(-1).long()
    vis_g = vis.index_select(1, flat).reshape(nfreq, S, nha, -1)
    sw_g = sw.index_select(1, flat).reshape(nfreq, S, nha, -1)
    d = u[:, None, None, :] * a[None, :, :, None] + v[:, None, None, :] * b[None, :, :, None]
    ang = 2 * math.pi * (d - torch.round(d))
    F = (sw_g * (vis_g.real * torch.cos(ang) + vis_g.imag * torch.sin(ang))).sum(dim=-1)
    W = sw_g.sum(dim=-1)
    Q = None
    if natural:
        vw_g = vw.index_select(1, flat).reshape(nfreq, S, nha, -1)
        Q = (sw_g**2 * invert_no_zero(vw_g)).sum(dim=-1)
    return F, W, Q


def _track_coefficients(cosha, sinha, sind, cosd, lat: float):
    """(a, b) of :func:`beamform_sums_plain` for sources [S] along their tracks [S, nha]."""
    sinl, cosl = math.sin(lat), math.cos(lat)
    a = cosd[:, None] * sinha
    b = cosl * sind[:, None] - sinl * cosd[:, None] * cosha
    return a, b


def _as_device(x, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x`` (host data or tensor) on ``like``'s device, contiguous, in ``dtype`` (default: like's real dtype)."""
    dtype = like.real.dtype if dtype is None else dtype
    return torch.as_tensor(x).to(device=like.device, dtype=dtype).contiguous()


def beamform_kernel(vis, sumweight, dec, lat, cosha, sinha, u, v):
    """Fringestop + weighted product sum of one source's window.

    Replacement of the Cython ``beamform`` (reference
    draco/util/_fast_tools.pyx:211): for each (freq, ha), the sum over
    products of weight * Re(vis * fringestop_phase).

    Parameters
    ----------
    vis : [nfreq, nha, nprod] complex tensor
    sumweight : [nfreq, nha, nprod] real
    dec, lat : float (radians)
    cosha, sinha : [nha]
    u, v : [nfreq, nprod] baseline components in wavelengths

    Returns
    -------
    formed : [nfreq, nha] real (unnormalised weighted sum)
    """
    vis = vis.contiguous()
    nha = vis.shape[1]
    rdt = vis.real.dtype
    cosha = _as_device(cosha, vis, torch.float64)[None]
    sinha = _as_device(sinha, vis, torch.float64)[None]
    dec_t = torch.tensor([dec], dtype=torch.float64, device=vis.device)
    a, b = _track_coefficients(cosha, sinha, torch.sin(dec_t), torch.cos(dec_t), lat)
    ra_idx = torch.arange(nha, dtype=torch.int32, device=vis.device)[None]
    F, _, _ = cuda_kernels.beamform_sums(
        vis, _as_device(sumweight, vis), None, ra_idx, a.to(rdt).contiguous(), b.to(rdt).contiguous(),
        _as_device(u, vis), _as_device(v, vis), natural=False,
    )
    return F[:, 0]


def beamform_sources_batched(
    vis, sumweight, visweight, ra_idx, cosha, sinha, sind, cosd, lat, u, v, primary_beam, inverse_variance: bool
):
    """Beamform a BATCH of sources with the hour angle collapsed.

    Parameters
    ----------
    vis : [nfreq, nra, nprod] complex tensor (on the device that computes)
    sumweight, visweight : [nfreq, nra, nprod] real tensors
    ra_idx : [S, nha] int RA indices of each source's window
    cosha, sinha : [S, nha]
    sind, cosd : [S] sin/cos of each source declination
    lat : float (radians)
    u, v : [nfreq, nprod] baseline components in wavelengths
    primary_beam : [S, nfreq, nha] beam power at each source track
    inverse_variance : bool
        Weight mode: True returns the summed weight as the output weight;
        False propagates sw^2 / vw.

    Returns
    -------
    formed : [S, nfreq] beam-and-weight normalised flux
    weight : [S, nfreq] output weights (before the factor-2 real-part
        variance correction)
    """
    F, sw_h, Q = _sums(vis, sumweight, visweight, ra_idx, cosha, sinha, sind, cosd, lat, u, v, inverse_variance)
    pbT = _as_device(primary_beam, vis).permute(1, 0, 2)  # [f, S, h]
    sumw = (sw_h * pbT**2).sum(dim=-1)  # [f, S]
    formed_full = (F * pbT).sum(dim=-1) * invert_no_zero(sumw)
    if inverse_variance:
        wout = sumw
    else:
        w2 = (Q * pbT**2).sum(dim=-1)
        wout = sumw**2 * invert_no_zero(w2)
    return formed_full.T, wout.T


def beamform_sources_batched_ha(
    vis, sumweight, visweight, ra_idx, cosha, sinha, sind, cosd, lat, u, v, ha_valid, inverse_variance: bool
):
    """HA-resolved variant of :func:`beamform_sources_batched`.

    Returns the normalised formed beam and weights per hour-angle bin
    instead of collapsing the track; padded / edge-clipped window slots are
    zeroed through ``ha_valid`` [S, nha].

    Returns
    -------
    formed : [S, nfreq, nha]
    weight : [S, nfreq, nha]
    """
    F, sumw, Q = _sums(vis, sumweight, visweight, ra_idx, cosha, sinha, sind, cosd, lat, u, v, inverse_variance)
    valid = _as_device(ha_valid, vis)[None]  # [1, S, h]
    formed_n = F * invert_no_zero(sumw) * valid
    if inverse_variance:
        wout = sumw * valid
    else:
        wout = sumw**2 * invert_no_zero(Q) * valid
    return formed_n.permute(1, 0, 2), wout.permute(1, 0, 2)


def _sums(vis, sw, vw, ra_idx, cosha, sinha, sind, cosd, lat, u, v, inverse_variance):
    """Track coefficients from host or device inputs, then :func:`beamform_sums`."""
    rdt = vis.real.dtype
    cosha, sinha, sind, cosd = (_as_device(x, vis, torch.float64) for x in (cosha, sinha, sind, cosd))
    a, b = _track_coefficients(cosha, sinha, sind, cosd, float(lat))
    return cuda_kernels.beamform_sums(
        vis.contiguous(), _as_device(sw, vis), None if inverse_variance else _as_device(vw, vis),
        _as_device(ra_idx, vis, torch.int32), a.to(rdt).contiguous(), b.to(rdt).contiguous(),
        _as_device(u, vis), _as_device(v, vis), natural=not inverse_variance,
    )
