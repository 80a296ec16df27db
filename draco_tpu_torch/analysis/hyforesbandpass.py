"""HyFoReS bandpass gain correction.

Port of ``draco_tpu.analysis.hyforesbandpass`` (reference
``draco/analysis/hyforesbandpass.py``: DelayFilterHyFoReSBandpassHybridVis:51,
DelayFilterHyFoReSBandpassHybridVisMask:346, HyFoReSBandpassHybridVis:589,
HyFoReSBandpassHybridVisMask:747, HyFoReSBandpassHybridVisMaskKeepSource:915,
DelayFilterHyFoReSBandpassHybridVisClean:1092).

HyFoReS cross-correlates unfiltered (foreground-dominated) visibilities
with delay-filtered (signal-dominated) visibilities to estimate residual
bandpass gain errors and their window matrix; the Clean task
pseudo-inverts the window and subtracts the residuals.

The tasks work on the streams' device.  Each (pol, ew, ra) column has its
own saved [freq, freq] filter: the filter application, the gain and window
sums and the filtered covariance run as batched products over a block of
RA columns at a time (the sums accumulate in complex128).  The window's
pseudo-inverse is a batched ``torch.linalg.svd`` with its default cuSOLVER routine.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.task import ContainerTask
from ..ops.tools import axis_blocks, invert_no_zero
from .ringmapmaker import find_grid_indices

C_LIGHT = 299792458.0


def _validate_axes(a, b):
    for axis, get in [
        ("freq", lambda c: np.asarray(c.freq)),
        ("el", lambda c: np.asarray(c.index_map["el"])),
        ("ew", lambda c: np.asarray(c.index_map["ew"])),
        ("pol", lambda c: np.asarray(c.index_map["pol"])),
        ("ra", lambda c: np.asarray(c.ra)),
    ]:
        if not np.array_equal(get(a), get(b)):
            raise ValueError(f"{axis} does not match for hybrid visibilities.")


def _get_delay_filter(hv, pf_hv):
    """The delay-filter dataset, from whichever container carries it.

    The DAYENU task stores ``filter`` on the stream it filtered (pf_hv);
    the reference reads it from the raw input, which raised KeyError in
    standard pipelines.  Axis consistency is validated either way.
    """
    _validate_axes(hv, pf_hv)
    for c in (pf_hv, hv):
        try:
            return c.filter[:]
        except (KeyError, AttributeError):
            continue
    raise KeyError(
        "Neither input carries a delay 'filter' dataset; run the DAYENU delay filter with save_filter: true first."
    )


def _blocks(filt):
    """RA blocks of a [pol, freq, freq, ew, ra] filter whose per-block temporaries stay bounded."""
    npol, nfreq, _, new, nra = filt.shape
    return axis_blocks(nra, npol * nfreq * nfreq * new * 4)


def _nanmedian(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``numpy.nanmedian`` along ``dim`` (NaN where a slice is all NaN)."""
    xs = torch.sort(x, dim=dim).values  # NaN sorts last
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    lo = torch.gather(xs, dim, ((n - 1) // 2).clamp(min=0))
    hi = torch.gather(xs, dim, (n // 2).clamp(max=x.shape[dim] - 1))
    med = 0.5 * (lo + hi)
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def _atten_low(filt, threshold):
    """The low-attenuation flag [pol, freq, ew, ra]: each filter's diagonal against its median nonzero entry."""
    diag = torch.diagonal(filt, dim1=1, dim2=2).abs().permute(0, 3, 1, 2)  # [pol, freq, ew, ra]
    nz = diag > 0.0
    med = _nanmedian(torch.where(nz, diag, torch.full_like(diag, float("nan"))), 1)
    med = torch.where(nz.any(dim=1, keepdim=True), med, torch.zeros_like(med))
    return diag > threshold * torch.nan_to_num(med)


def _apply_filter_batch(vis, weight, filt, atten_threshold, log):
    """Apply a per-(pol, ew, time) spectral filter (reference hyforesbandpass.py:137-191).

    Returns (post_vis, weight) with invalidated samples zero-weighted; the
    inputs are not changed.
    """
    npol, nfreq, new, nel, nra = vis.shape
    post = torch.empty_like(vis)
    weight = weight.clone()
    nmissing = 0
    for t0, t1 in _blocks(filt):
        F = filt[..., t0:t1]  # [pol, f, g, ew, t]
        flag = weight[..., t0:t1] > 0.0  # [pol, g, ew, t]
        valid_freq = (F.abs() > 0.0).any(dim=1)  # [pol, g, ew, t]
        missing = (valid_freq & ~flag).any(dim=1)  # [pol, ew, t]
        empty = ~valid_freq.any(dim=1)
        bad = missing | empty
        nmissing += int(missing.sum())
        weight[..., t0:t1] *= ~bad[:, None]
        Fb = F.permute(0, 3, 4, 1, 2).to(vis.dtype)  # [pol, ew, t, f, g]
        vb = vis[..., t0:t1].permute(0, 2, 4, 1, 3)  # [pol, ew, t, g, el]
        out = (Fb @ vb) * ~bad[..., None, None]
        post[..., t0:t1] = out.permute(0, 3, 1, 4, 2)
        del Fb, vb, out
    if nmissing:
        log.warning(f"{nmissing} (pol, ew, ra) samples are missing frequencies that were assumed valid during "
                    "filter generation.")

    if atten_threshold > 0.0:
        for t0, t1 in _blocks(filt):
            flag_low = _atten_low(filt[..., t0:t1], atten_threshold)
            weight[..., t0:t1] *= flag_low.to(weight.dtype)
            post[..., t0:t1] *= flag_low[:, :, :, None, :]
    return post, weight


def _estimate_gains_window(vis, post_vis, weight, filt, el_mask):
    """HyFoReS gain and window estimation (reference hyforesbandpass.py:196-294).

    ``yN = sum conj(fg) pv``, ``D = sum |fg|^2`` over (el, ra) and ``N[f, g]
    = sum conj(fg_f) fg_g filt[f, g]`` with fg = vis - post_vis on the kept
    (weight, el) samples; returns (y = yN / D, W = N / D), complex128.
    """
    npol, nfreq, new, nel, nra = vis.shape
    dev = vis.device
    c128 = torch.complex128
    yN = torch.zeros((npol, new, nfreq), dtype=c128, device=dev)
    D = torch.zeros((npol, new, nfreq), dtype=torch.float64, device=dev)
    N = torch.zeros((npol, new, nfreq, nfreq), dtype=c128, device=dev)
    el = torch.as_tensor(np.asarray(el_mask), device=dev).to(torch.float64)
    for t0, t1 in _blocks(filt):
        m = (weight[..., t0:t1] > 0.0).to(torch.float64)[:, :, :, None, :] * el[None, None, None, :, None]
        pv = post_vis[..., t0:t1].to(c128) * m
        fg = vis[..., t0:t1].to(c128) * m - pv
        yN += torch.einsum("pfxet,pfxet->pxf", fg.conj(), pv)
        D += (fg.abs() ** 2).sum(dim=(3, 4)).permute(0, 2, 1)
        fgt = fg.permute(0, 2, 4, 1, 3)  # [pol, ew, t, f, el]
        gram = fgt.conj() @ fgt.transpose(-1, -2)  # [pol, ew, t, f, g]
        N += (gram * filt[..., t0:t1].permute(0, 3, 4, 1, 2).to(c128)).sum(dim=2)
        del m, pv, fg, fgt, gram
    iD = invert_no_zero(D)
    return yN * iD, N * iD[..., None]


def _freq_cov(filt, cvar):
    """Filtered frequency-frequency covariance ``NF diag(cvar) NF^H`` of every (pol, ew, ra) column,
    [pol, f, h, ew, ra] in float64 (complex128 for a complex filter)."""
    npol, nfreq, _, new, nra = filt.shape
    dt = torch.complex128 if filt.is_complex() else torch.float64
    out = torch.empty((npol, nfreq, nfreq, new, nra), dtype=dt, device=filt.device)
    for t0, t1 in _blocks(filt):
        F = filt[..., t0:t1].permute(0, 3, 4, 1, 2).to(dt)  # [pol, ew, t, f, g]
        cv = cvar[..., t0:t1].permute(0, 2, 3, 1).to(dt)  # [pol, ew, t, g]
        out[..., t0:t1] = ((F * cv[..., None, :]) @ F.conj().transpose(-1, -2)).permute(0, 3, 4, 1, 2)
    return out


class DelayFilterHyFoReSBandpassHybridVis(ContainerTask):
    """Estimate bandpass gains + window from unfiltered hybrid vis (reference hyforesbandpass.py:51-343).

    Applies the stored DAYENU filter, then cross-correlates the filtered
    and unfiltered data.

    Attributes
    ----------
    atten_threshold : float
        Mask channels whose filter diagonal is below this fraction of the
        median (0 disables).
    """

    atten_threshold = config.float_prop(0.0)

    def setup(self, manager):
        """Extract the minimum NS baseline separation (for alias masking)."""
        telescope = io.get_telescope(manager)
        self.min_ysep = find_grid_indices(telescope.baselines)[3]

    def process(self, hv, source):
        """Apply the DAYENU filter then estimate the gains and window."""
        _validate_axes(source, hv)
        vis = hv.vis[:]
        filt = source.filter[:]
        post_vis, weight = _apply_filter_batch(vis, hv.weight[:], filt, self.atten_threshold, self.log)
        return self._estimate(hv, vis, post_vis, weight, filt)

    def _estimate(self, hv, vis, post_vis, weight, filt):
        y, W = _estimate_gains_window(vis, post_vis, weight, filt, self.aliased_el_mask(hv))
        bp_gain_win = containers.VisBandpassWindowBaseline(
            pol=hv.index_map["pol"], ew=hv.index_map["ew"], freq=hv.index_map["freq"], device=vis.device,
        )
        bp_gain_win.bandpass[:] = y
        bp_gain_win.window[:] = W
        return bp_gain_win

    def aliased_el_mask(self, hv):
        """Mask |sin(za)| beyond the aliased horizon (reference :307)."""
        freq = np.max(np.asarray(hv.freq))
        horizon_limit = self.get_horizon_limit(freq)
        el = np.asarray(hv.index_map["el"])
        return np.abs(el) < horizon_limit

    def get_horizon_limit(self, freq):
        """sin(za) where the southern horizon aliases (reference :328)."""
        return C_LIGHT / (freq * 1e6 * self.min_ysep) - 1.0


def _keep(maskf, masksf=None):
    """The kept pixels [pol, freq, 1, el, ra] of a RingMapMask (pol, freq, ra, el), or of a sidelobe
    mask with a main-lobe mask kept."""
    mask = torch.as_tensor(np.asarray(maskf.mask[:])).transpose(-1, -2)[:, :, None]
    if masksf is None:
        return ~mask
    masks = torch.as_tensor(np.asarray(masksf.mask[:])).transpose(-1, -2)[:, :, None]
    return ~(mask & ~masks)


class DelayFilterHyFoReSBandpassHybridVisMask(DelayFilterHyFoReSBandpassHybridVis):
    """As the base task, with a sidelobe pixel mask (reference hyforesbandpass.py:346-586)."""

    def process(self, hv, source, maskf):
        """Apply the DAYENU filter and the pixel mask, then HyFoReS."""
        _validate_axes(source, hv)
        filt = source.filter[:]
        post_vis, weight = _apply_filter_batch(hv.vis[:], hv.weight[:], filt, self.atten_threshold, self.log)
        keep = _keep(maskf).to(post_vis.device)
        return self._estimate(hv, hv.vis[:] * keep, post_vis * keep, weight, filt)


class HyFoReSBandpassHybridVis(DelayFilterHyFoReSBandpassHybridVis):
    """HyFoReS on pre-filtered inputs, no internal delay filter (reference hyforesbandpass.py:589-744)."""

    def process(self, hv, pf_hv):
        """Estimate the gains and window from (pre, post)-filtered data."""
        filt = _get_delay_filter(hv, pf_hv)
        return self._estimate(hv, hv.vis[:], pf_hv.vis[:], pf_hv.weight[:], filt)


class HyFoReSBandpassHybridVisMask(DelayFilterHyFoReSBandpassHybridVis):
    """HyFoReS on pre-filtered inputs with a sidelobe pixel mask (reference hyforesbandpass.py:747-912)."""

    def process(self, hv, pf_hv, maskf):
        """Estimate the gains and window, masking flagged pixels."""
        filt = _get_delay_filter(hv, pf_hv)
        keep = _keep(maskf).to(hv.vis[:].device)
        return self._estimate(hv, hv.vis[:] * keep, pf_hv.vis[:] * keep, pf_hv.weight[:], filt)


class HyFoReSBandpassHybridVisMaskKeepSource(DelayFilterHyFoReSBandpassHybridVis):
    """HyFoReS masking source sidelobes while keeping main lobes (reference hyforesbandpass.py:915-1089)."""

    def process(self, hv, pf_hv, maskf, masksf):
        """Estimate gains and window keeping source main lobes."""
        filt = _get_delay_filter(hv, pf_hv)
        keep = _keep(maskf, masksf).to(hv.vis[:].device)
        return self._estimate(hv, hv.vis[:] * keep, pf_hv.vis[:] * keep, pf_hv.weight[:], filt)


class DelayFilterHyFoReSBandpassHybridVisClean(ContainerTask):
    """Compensate the bandpass window and subtract foreground residuals (reference hyforesbandpass.py:1092-1292).

    Attributes
    ----------
    cutoff : float
        SVD cutoff when pseudo-inverting the window (0 disables
        compensation).
    atten_threshold : float
        Low-attenuation channel masking threshold.
    calculate_cov : bool
        Store the freq-freq noise covariance.
    """

    cutoff = config.float_prop(1e-1)
    atten_threshold = config.float_prop(0.0)
    calculate_cov = config.bool_prop(False)

    def process(self, hv, source, bp):
        """Apply the gain correction and the DAYENU filter."""
        _validate_axes(source, hv)

        if self.calculate_cov:
            name = "complex_freq_cov" if "complex_filter" in source.datasets else "freq_cov"
            if name not in hv.datasets:
                hv.add_dataset(name)
            hv.freq_cov[:] = 0

        vis = hv.vis[:]
        dev = vis.device
        npol, nfreq, new = vis.shape[:3]

        y = bp.bandpass[:].to(dev)
        W = bp.window[:].to(dev)

        s_val = torch.zeros((npol, new, nfreq), dtype=torch.float64, device=dev)
        rank = np.zeros((npol, new))
        if self.cutoff == 0.0:
            g = y
            self.log.debug("Window compensation disabled")
        else:
            u, s, vh = torch.linalg.svd(W.reshape(-1, nfreq, nfreq), full_matrices=False)
            s_val = s.reshape(npol, new, nfreq)
            keep = s > self.cutoff
            sinv = torch.where(keep, invert_no_zero(s), torch.zeros_like(s))
            W_pinv = (vh.conj().transpose(1, 2) * sinv[:, None, :].to(vh.dtype)) @ u.conj().transpose(1, 2)
            rank = keep.sum(dim=-1).reshape(npol, new).cpu().numpy()
            g = (W_pinv @ y.reshape(-1, nfreq, 1).to(W_pinv.dtype))[..., 0].reshape(npol, new, nfreq)
            self.log.debug("Gain window compensated")

        comp_bandpass = containers.VisBandpassCompensateBaseline(
            pol=hv.index_map["pol"], ew=hv.index_map["ew"], freq=hv.index_map["freq"], device=dev,
        )
        comp_bandpass.sval[:] = s_val
        comp_bandpass.comp_bandpass[:] = g
        comp_bandpass.attrs["rank"] = rank
        comp_bandpass.attrs["cutoff"] = self.cutoff

        weight = hv.weight[:]
        filt = source.filter[:]

        # Gain correction (pol, freq, ew), applied in the data's type
        diag_m = 1 - g.transpose(1, 2)  # [pol, freq, ew]
        cvis = vis * diag_m.to(vis.dtype)[:, :, :, None, None]
        cvar = invert_no_zero(weight.to(torch.float64)) * diag_m.abs()[..., None] ** 2  # [pol, freq, ew, ra]

        fvis, new_weight = _apply_filter_batch(cvis, weight, filt, 0.0, self.log)
        del cvis
        # Propagate variance through |NF|^2
        out_weight = torch.empty_like(cvar)
        for t0, t1 in _blocks(filt):
            F2 = filt[..., t0:t1].abs().to(torch.float64).permute(0, 3, 4, 1, 2) ** 2  # [pol, ew, t, f, g]
            fvar = (F2 @ cvar[..., t0:t1].permute(0, 2, 3, 1)[..., None])[..., 0]  # [pol, ew, t, f]
            out_weight[..., t0:t1] = invert_no_zero(fvar).permute(0, 3, 1, 2)
        out_weight *= new_weight > 0

        if self.calculate_cov:
            hv.freq_cov[:] = _freq_cov(filt, cvar)

        if self.atten_threshold > 0.0:
            for t0, t1 in _blocks(filt):
                out_weight[..., t0:t1] *= _atten_low(filt[..., t0:t1], self.atten_threshold).to(out_weight.dtype)

        hv.vis[:] = fvis
        hv.weight[:] = out_weight
        return hv, comp_bandpass
