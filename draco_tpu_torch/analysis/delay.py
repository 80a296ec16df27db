"""Delay-space spectrum estimation and filtering tasks.

Port of ``draco_tpu.analysis.delay`` (reference ``draco/analysis/delay.py``:
DelayFilter:29, DelayFilterBase:156, DelayTransformBase:347, the container
mixins :675-873, DelaySpectrumBase:874, DelaySpectrumFFT:960,
DelaySpectrumWienerFilter:982, DelaySpectrumToPowerSpectrum:1061,
DelayPowerSpectrumBase:1114, DelayPowerSpectrumGibbs:1218,
DelayPowerSpectrumNRML:1270, DelayCrossPowerSpectrumEstimator:1304).

The tasks work on their container's device.  ``DelayFilter`` builds one
null-space projector per (delay cut, channel mask) group, in float64 on the
device, and applies it in place as a product over blocks of the group's
stacks (the JAX package projects on the host).  The batched Gibbs
estimators run every baseline whose retained frequency mask equals the
batch union through :mod:`draco_tpu_torch.ops.delay`'s device chains;
the rest take the per-baseline host samplers.

Where the batched estimators differ from the JAX package:

* each baseline's chain has its own seed (:meth:`RandomTask.row_seeds`),
  so its samples do not depend on the other baselines;
* a chain whose Cholesky factorisation fails (``cholesky_ex``'s ``info``;
  the device does not raise) is masked and counted by the auto estimator
  (the output's attr ``gibbs_failed``), as the JAX package masks
  non-finite chains;
* the cross estimator re-samples such chains in complex128 on the same
  device (``gibbs_resampled``) where the JAX package sends them to the host
  float64 sampler, and raises if one fails there too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.task import ContainerTask, RandomTask
from ..ops import filters, tools
from ..ops.delay import (
    CROSS_BATCH,
    _inv_move_front,
    _move_front,
    _take_view,
    delay_power_spectrum_gibbs,
    delay_power_spectrum_gibbs_batched,
    delay_spectrum_fft,
    delay_spectrum_gibbs_cross,
    delay_spectrum_gibbs_cross_batched,
    delay_spectrum_wiener_filter,
    flatten_axes,
    match_axes,
)
from .delayopt import delay_power_spectrum_maxpost

C_US = 299.792458  # m / us (c such that baseline[m] / C_US is in us)


def _mode_count(bandwidth: float, cut_us: float) -> int:
    """Fourier modes spanned by a delay cut over a bandwidth (>= 1)."""
    return max(int(4.0 * bandwidth * cut_us + 0.5), 1)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _median(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``numpy.median`` along ``dim``: the mean of the two middle values for an even count."""
    xs = torch.sort(x, dim=dim).values
    n = xs.shape[dim]
    mid = xs.narrow(dim, (n - 1) // 2, 2 - n % 2)
    return mid.mean(dim=dim)


# Per-container defaults for the generic filter: (loop axis, dataset)
_FILTER_DEFAULTS = (
    (containers.SiderealStream, "stack", "vis"),
    (containers.HybridVisMModes, "m", "vis"),
    (containers.RingMap, "el", "map"),
    (containers.GridBeam, "theta", "beam"),
)


def _filter_defaults_for(ss):
    for cls, ax, dset in _FILTER_DEFAULTS:
        if isinstance(ss, cls):
            return ax, dset
    raise ValueError(f"No default filter axes known for {type(ss)}.")


# ---------------------
# Delay filter classes
# ---------------------


class DelayFilter(ContainerTask):
    """Project out delays below a cut (reference delay.py:29-153), on the stream's device.

    Attributes
    ----------
    delay_cut : float
        Delay cut in microseconds.
    za_cut : float
        Sine of max zenith angle for the baseline-dependent cut.
    extra_cut : float
        Additional delay threshold beyond the baseline term.
    weight_tol : float
        (Kept for API parity.)
    telescope_orientation : 'NS' | 'EW' | 'none'
        Baseline component used for the baseline-dependent cut.
    window : bool
        Apply the window function while filtering.
    """

    delay_cut = config.float_prop(0.1)
    za_cut = config.float_prop(1.0)
    extra_cut = config.float_prop(0.0)
    weight_tol = config.float_prop(1e-4)
    telescope_orientation = config.enum(["NS", "EW", "none"], default="NS")
    window = config.bool_prop(False)

    def setup(self, telescope):
        self.telescope = io.get_telescope(telescope)

    def _horizon_cuts(self, ss):
        """Per-stack delay cuts in microseconds from the array geometry."""
        pairs = ss.prodstack
        pos = self.telescope.feedpositions
        sep = pos[pairs["input_a"].astype(int)] - pos[pairs["input_b"].astype(int)]
        component = {
            "NS": lambda s: np.abs(s[:, 1]),
            "EW": lambda s: np.abs(s[:, 0]),
            "none": lambda s: np.linalg.norm(s, axis=1),
        }[self.telescope_orientation]
        horizon = self.za_cut * component(sep) / C_US + self.extra_cut
        return np.maximum(horizon, self.delay_cut)

    def process(self, ss):
        freq = ss.freq
        bandwidth = np.ptp(freq)
        cuts = self._horizon_cuts(ss)
        vis, wgt = ss.vis[:], ss.weight[:]
        nfreq, nstack, ntime = vis.shape

        # Keep only channels sampled as often as the best channel of each
        # stack, and only times sampled as often as each stack's best time
        per_chan = torch.zeros((nfreq, nstack), dtype=torch.int64, device=wgt.device)
        per_time = torch.zeros((nstack, ntime), dtype=torch.int64, device=wgt.device)
        for f0, f1 in tools.axis_blocks(nfreq, nstack * ntime):
            live = wgt[f0:f1] > 0.0
            per_chan[f0:f1] = live.sum(dim=2)
            per_time += live.sum(dim=0)
            del live
        chan_keep = per_chan == per_chan.max(dim=0, keepdim=True).values
        time_keep = per_time == per_time.max(dim=1, keepdim=True).values

        # Redundant arrays share baseline lengths and flag patterns: ONE
        # null-space projector per unique (cut, channel-mask) group, applied
        # to the group's stacks block by block (reference delay.py:100-140
        # takes an SVD per baseline)
        keep_host = _host(chan_keep)
        groups: dict = {}
        for bi in range(nstack):
            groups.setdefault((float(cuts[bi]), keep_host[:, bi].tobytes()), []).append(bi)
        self.log.debug("DelayFilter: %d baselines in %d filter groups", nstack, len(groups))
        for (cut, _), members in groups.items():
            proj = filters.null_filter(
                freq, cut, keep_host[:, members[0]], num_modes=_mode_count(bandwidth, cut),
                window=self.window, device=vis.device,
            ).to(vis.dtype)
            sel = torch.as_tensor(members, device=vis.device)
            for i0, i1 in tools.axis_blocks(len(members), nfreq * ntime):
                block = vis.index_select(1, sel[i0:i1])
                vis.index_copy_(1, sel[i0:i1], (proj @ block.reshape(nfreq, -1)).reshape(block.shape))
                del block
        wgt.mul_(chan_keep[:, :, None])
        wgt.mul_(time_keep[None, :, :])
        return ss


class DelayFilterBase(ContainerTask):
    """Delay filter over a configurable axis/dataset (reference delay.py:156), on the container's device.

    Attributes
    ----------
    delay_cut : float
        Delay cut in microseconds.
    window : bool
        Apply the window function while filtering.
    axis, dataset : str
        Axis to iterate over and dataset to filter (container defaults).
    """

    delay_cut = config.float_prop(0.1)
    window = config.bool_prop(False)
    axis = config.str_prop(None)
    dataset = config.str_prop(None)

    def setup(self, telescope):
        self.telescope = io.get_telescope(telescope)

    def _delay_cut(self, ss, axis: str, ind: int) -> float:
        """Delay cut in microseconds for one element of the loop axis."""
        return self.delay_cut

    def _filter_slice(self, vis_2d, wgt_2d, freq, cut, bandwidth):
        """Filter one [freq, flat-rest] slice; returns (filtered, mask)."""
        chan_keep = _best_sampled_mask(wgt_2d, axis=1)
        time_keep = _best_sampled_mask(wgt_2d, axis=0)
        proj = filters.null_filter(
            freq, cut, chan_keep, num_modes=_mode_count(bandwidth, cut), window=self.window, device=vis_2d.device
        )
        filtered = proj @ vis_2d.to(proj.dtype)
        if not vis_2d.is_complex():
            filtered = filtered.real
        return filtered, torch.outer(chan_keep, time_keep)

    def process(self, ss):
        if not isinstance(ss, containers.FreqContainer):
            raise TypeError(f"A FreqContainer subclass is required here, not {type(ss)}.")
        default_ax, default_ds = (
            _filter_defaults_for(ss) if self.axis is None or self.dataset is None else (None, None)
        )
        loop_axis = self.axis or default_ax
        dset_name = self.dataset or default_ds

        freq = ss.freq
        bandwidth = np.ptp(freq)

        target = ss.datasets[dset_name]
        values = target[:]
        wgt_full = match_axes(target, ss.weight).expand(values.shape)
        keep_full = torch.ones(values.shape, dtype=torch.float64, device=values.device)

        layout = list(target.axes)
        loop_pos = layout.index(loop_axis)
        freq_pos = layout.index("freq")
        inner_freq_pos = freq_pos - (1 if freq_pos > loop_pos else 0)

        for bi in range(values.shape[loop_pos]):
            block = _take_view(values, bi, loop_pos)
            block_2d = _move_front(block, inner_freq_pos, block.shape)
            w_block = _take_view(wgt_full, bi, loop_pos)
            w_2d = _move_front(w_block, inner_freq_pos, w_block.shape)
            filtered, mask = self._filter_slice(
                block_2d, w_2d, freq, self._delay_cut(ss, loop_axis, bi), bandwidth
            )
            block.copy_(_inv_move_front(filtered, inner_freq_pos, block.shape))
            keep_block = _take_view(keep_full, bi, loop_pos)
            keep_block.copy_(_inv_move_front(mask, inner_freq_pos, keep_block.shape))

        # Reduce the combined mask onto the weight axes and apply it
        waxes = set(ss.weight.axes)
        extra = tuple(i for i, ax in enumerate(layout) if ax not in waxes)
        keep_w = keep_full.amin(dim=extra) if extra else keep_full
        ss.weight[:].mul_(keep_w.to(ss.weight.dtype))
        return ss


def _best_sampled_mask(weight_2d, axis):
    """1.0 where a row/column is sampled as often as the best one."""
    counts = (weight_2d > 0.0).sum(dim=axis)
    return (counts == counts.max()).to(torch.float64)


# -----------------------------
# Delay transform base classes
# -----------------------------


def _spectral_grid(freq, *, zero, spacing, nchan, skip_nyquist, complex_td):
    """(delay axis [us], effective channel indices) for a frequency axis.

    Infers the underlying regular channel grid the samples sit on
    (reference delay.py:461 semantics).
    """
    if complex_td:
        n = len(freq)
        return np.fft.fftshift(np.fft.fftfreq(n, d=spacing)), np.arange(n)
    chans = (np.abs(freq - zero) / spacing).astype(np.int64)
    if nchan is None:
        nchan = int(chans[-1]) + 1 + (1 if skip_nyquist else 0)
    ntap = 2 * (nchan - 1)
    return np.fft.fftshift(np.fft.fftfreq(ntap, d=spacing)), chans


class DelayTransformBase(ContainerTask):
    """Base class for frequency -> delay transforms (reference delay.py:347).

    See the reference docstring for the full attribute list; semantics are
    preserved (freq_zero/freq_spacing/nfreq channel-grid inference, window
    choice, complex_timedomain, weight_boost, freq/time pruning fractions,
    mean removal, frequency scaling).
    """

    freq_zero = config.float_prop(None)
    freq_spacing = config.float_prop(None)
    nfreq = config.int_prop(None)
    skip_nyquist = config.bool_prop(True)
    apply_window = config.bool_prop(True)
    window = config.enum(
        ["uniform", "hann", "hanning", "hamming", "blackman", "nuttall", "blackman_nuttall", "blackman_harris"],
        default="nuttall",
    )
    complex_timedomain = config.bool_prop(False)
    use_average_weights = config.bool_prop(True)
    weight_boost = config.float_prop(1.0)
    freq_frac = config.float_prop(0.0)
    time_frac = config.float_prop(0.0)
    remove_mean = config.bool_prop(True)
    scale_freq = config.bool_prop(False)

    # window name actually applied (recorded in output attrs)
    @property
    def _window_name(self):
        return self.window if self.apply_window else None

    def process(self, ss):
        """Estimate the delay spectrum or power spectrum of the input."""
        self._device = ss.device
        delays, chans = self._spectral_axis(ss)
        rows, wrows, coords = self._gather_rows(ss)
        out = self._blank_output(ss, delays, coords)
        out.attrs["window_los"] = str(self._window_name)
        return self._fill_output(rows, wrows, out, delays, chans)

    def _spectral_axis(self, ss):
        """Delay grid + effective channel indices (reference delay.py:461)."""
        if isinstance(ss, containers.FreqContainer):
            freq = ss.freq
        elif len(ss) > 0:
            freq = ss[0].freq
        else:
            raise TypeError("The input carries no freq axis to transform.")
        return _spectral_grid(
            freq,
            zero=freq[0] if self.freq_zero is None else self.freq_zero,
            spacing=np.abs(np.diff(freq)).min() if self.freq_spacing is None else self.freq_spacing,
            nchan=len(freq) if self.complex_timedomain else self.nfreq,
            skip_nyquist=self.skip_nyquist,
            complex_td=self.complex_timedomain,
        )

    def _trim_block(self, data, weight):
        """Prune dead channels/times + clean data (reference delay.py:516), on the data's device.

        Returns (data, weight, kept_freq, kept_time) with host masks, or None
        when nothing usable remains.
        """
        ntime, nchan = data.shape[-2:]
        live = weight > 0
        if not bool(live.any()):
            return None
        t_occ = live.to(torch.float64).mean(dim=-1).reshape(-1, ntime).mean(dim=0)
        t_keep = t_occ > self.time_frac
        live = live[..., t_keep, :]
        f_occ = live.to(torch.float64).mean(dim=-2).reshape(-1, nchan).mean(dim=0)
        f_keep = f_occ > self.freq_frac
        if not bool(f_keep.any()):
            return None
        data = data[..., t_keep, :][..., f_keep]
        weight = weight[..., t_keep, :][..., f_keep]
        if self.remove_mean:
            data = data - data.mean(dim=-2, keepdim=True)
        if not bool((data != 0).any()):
            return None
        if self.scale_freq:
            per_chan = data.std(dim=-2, correction=0)[..., None, :]
            overall = data.std(dim=(-1, -2), correction=0)[..., None, None]
            data = data * tools.invert_no_zero(per_chan / overall)
        if self.use_average_weights:
            weight = weight.mean(dim=-2)
        return data, weight * self.weight_boost, _host(f_keep), _host(t_keep)

    # subclass hooks ---------------------------------------------------
    def _gather_rows(self, ss):
        raise NotImplementedError()

    def _fill_output(self, rows, wrows, out, delays, chans):
        raise NotImplementedError()

    def _blank_output(self, ss, delays, coords):
        raise NotImplementedError()


def _attach_coords(out, source, coords):
    """Copy the flattened coordinate index maps onto an output container."""
    for ax in coords:
        out.create_index_map(ax, source.index_map[ax])
    out.attrs["baseline_axes"] = coords


def _flat_row_count(source, coords) -> int:
    n = 1
    for ax in coords:
        n *= len(source.index_map[ax])
    return n


class GeneralInputContainerMixin:
    """Flatten all non-(sample, freq) axes into a baseline axis (reference delay.py:675)."""

    dataset = config.str_prop(None)
    sample_axis = config.str_prop("ra")

    def _gather_rows(self, ss):
        ss.redistribute("freq")
        if self.dataset is None:
            target = ss.data
        elif self.dataset in ss.datasets:
            target = ss[self.dataset]
        else:
            raise ValueError(
                f"Specified dataset to delay transform ({self.dataset}) missing from container type {type(ss)}."
            )
        if self.sample_axis not in ss.axes_spec() or self.sample_axis not in target.axes:
            raise ValueError(f"{type(ss)} has no axis named {self.sample_axis!r} to average over.")
        keep = [self.sample_axis, "freq"]
        rows, coords = flatten_axes(target, keep)
        wrows, _ = flatten_axes(ss.weight, keep, match_dset=target)
        return rows, wrows, coords


class DelayPowerSpectrumContainerMixin(GeneralInputContainerMixin):
    """Create DelaySpectrum outputs (reference delay.py:744)."""

    nsamp = config.int_prop(1)
    save_samples = config.bool_prop(False)
    save_spectrum_mask = config.bool_prop(False)

    def _blank_output(self, ss, delays, coords):
        if isinstance(coords, np.ndarray):
            baseline = coords
        elif len(coords) == 1:
            baseline = ss.index_map[coords[0]]
        else:
            baseline = np.arange(_flat_row_count(ss, coords))
        out = containers.DelaySpectrum(
            baseline=baseline, delay=delays, sample=self.nsamp, attrs_from=ss, device=ss.device
        )
        if isinstance(coords, list):
            _attach_coords(out, ss, coords)
        for name, wanted in (("spectrum_samples", self.save_samples), ("spectrum_mask", self.save_spectrum_mask)):
            if wanted:
                out.add_dataset(name)
        out.attrs["freq"] = ss.freq
        return out


class DelaySpectrumContainerMixin(GeneralInputContainerMixin):
    """Create DelayTransform outputs (reference delay.py:821)."""

    save_spectrum_mask = config.bool_prop(False)

    def _blank_output(self, ss, delays, coords):
        out = containers.DelayTransform(
            baseline=np.arange(_flat_row_count(ss, coords)),
            sample=ss.index_map[self.sample_axis],
            delay=delays,
            attrs_from=ss,
            weight_boost=self.weight_boost,
            device=ss.device,
        )
        _attach_coords(out, ss, coords)
        if self.save_spectrum_mask:
            out.add_dataset("spectrum_mask")
        out.attrs["freq"] = ss.freq
        return out


# -------------------------------------
# Delay spectrum (transform) tasks
# -------------------------------------


class DelaySpectrumBase(DelaySpectrumContainerMixin, DelayTransformBase):
    """Base for per-baseline delay transforms (reference delay.py:874)."""

    def _fill_output(self, rows, wrows, out, delays, chans):
        nrow = out.spectrum.shape[0]
        priors = self._initial_spectra(nrow, len(delays), delays.dtype)
        spectrum = out.spectrum[:]
        mask_ds = out.datasets["spectrum_mask"][:] if self.save_spectrum_mask else None
        for bi in range(nrow):
            trimmed = self._trim_block(rows[bi], wrows[bi])
            if trimmed is None:
                if mask_ds is not None:
                    mask_ds[bi] = True
                continue
            block, w, f_keep, t_keep = trimmed
            spec = self._row_spectrum(block, w, priors[bi], len(delays), chans[f_keep])
            spectrum[bi, torch.as_tensor(t_keep, device=spectrum.device)] = torch.as_tensor(
                spec, device=spectrum.device
            ).to(spectrum.dtype)
            if mask_ds is not None:
                mask_ds[bi][~t_keep] = True
        return out

    def _initial_spectra(self, nrow, ndelay, dtype):
        return [None] * nrow

    def _row_spectrum(self, block, w, prior, ndelay, chans):
        raise NotImplementedError()


class DelaySpectrumFFT(DelaySpectrumBase):
    """Delay spectrum via inverse FFT (reference delay.py:960), on the data's device."""

    def _row_spectrum(self, block, w, prior, ndelay, chans):
        return torch.fft.fftshift(delay_spectrum_fft(block, ndelay, self._window_name), dim=-1)


class DelaySpectrumWienerFilter(DelaySpectrumBase):
    """Delay spectrum via Wiener filtering (reference delay.py:982).  The filter is host numpy.

    See arXiv:2202.01242 Eq. A6.
    """

    def setup(self, dps=None):
        self.dps = dps

    def _initial_spectra(self, nrow, ndelay, dtype):
        return _host(self.dps.spectrum[:])

    def _row_spectrum(self, block, w, prior, ndelay, chans):
        filtered = delay_spectrum_wiener_filter(
            np.fft.fftshift(prior),
            _host(block),
            ndelay,
            _host(w),
            window=self._window_name,
            fsel=chans,
            complex_timedomain=self.complex_timedomain,
        )
        return np.fft.fftshift(filtered, axes=-1)


class DelaySpectrumWienerFilterIteratePS(DelaySpectrumWienerFilter):
    """Wiener filter with a per-cycle power spectrum (reference delay.py:1027)."""

    def process(self, ss, dps):
        self.dps = dps
        return super().process(ss)


class DelaySpectrumToPowerSpectrum(ContainerTask):
    """Delay power spectrum = variance of a delay spectrum over samples (reference delay.py:1061)."""

    def process(self, dspec: containers.DelayTransform) -> containers.DelaySpectrum:
        pspec = containers.DelaySpectrum(attrs_from=dspec, axes_from=dspec)
        ds = dspec.spectrum[:]
        if "spectrum_mask" not in dspec.datasets:
            pspec.spectrum[:] = ds.var(dim=1, correction=0)
            return pspec
        w = torch.as_tensor(~dspec.datasets["spectrum_mask"][:], device=ds.device)[..., None]
        count = w.sum(dim=1)
        mean = torch.where(w, ds, 0).sum(dim=1) / count
        ps = torch.where(w, (ds - mean[:, None]).abs() ** 2, 0).sum(dim=1) / count
        nans = torch.isnan(ps)
        pspec.add_dataset("spectrum_mask")
        pspec.datasets["spectrum_mask"][:] = _host(nans.any(dim=-1))
        pspec.spectrum[:] = torch.where(nans, 0.0, ps)
        return pspec


# ---------------------------------------------------
# Direct delay power spectrum tasks
# ---------------------------------------------------


class DelayPowerSpectrumBase(DelayPowerSpectrumContainerMixin, DelayTransformBase):
    """Base for direct power spectrum estimation, one baseline at a time (reference delay.py:1114)."""

    def _fill_output(self, rows, wrows, out, delays, chans, subset=None):
        nrow = out.spectrum.shape[0]
        ndelay = len(delays)
        priors = self._initial_spectra(nrow, ndelay, delays.dtype)
        mask_ds = out.datasets["spectrum_mask"][:] if self.save_spectrum_mask else None
        samples_ds = out.datasets["spectrum_samples"] if self.save_samples else None

        for bi in range(nrow) if subset is None else subset:
            trimmed = self._trim_block(rows[bi], wrows[bi])
            if trimmed is None:
                if mask_ds is not None:
                    mask_ds[bi] = True
                continue
            block, w, f_keep, _ = trimmed
            spec, draws, converged = self._row_spectrum(block, w, priors[bi], ndelay, chans[f_keep])
            out.spectrum[bi] = spec
            if mask_ds is not None and not converged:
                mask_ds[bi] = True
            if samples_ds is not None and draws:
                samples_ds[:, bi] = 0.0
                samples_ds[-len(draws) :, bi] = np.array([np.fft.fftshift(s) for s in draws])

        if mask_ds is not None:
            self.log.debug(f"Gibbs converged on {nrow - mask_ds.sum()} of {nrow} valid baselines.")
        return out

    def _initial_spectra(self, nrow, ndelay, dtype):
        raise NotImplementedError()

    def _row_spectrum(self, block, w, prior, ndelay, chans):
        raise NotImplementedError()


class DelayPowerSpectrumGibbs(DelayPowerSpectrumBase, RandomTask):
    """Gibbs-sampled delay power spectrum, baseline by baseline on the host (reference delay.py:1218).

    Attributes
    ----------
    initial_amplitude : float
        Flat initial power spectrum amplitude.
    median_frac : float
        Return the median over this final fraction of samples.
    """

    initial_amplitude = config.float_prop(10.0)
    median_frac = config.float_prop(0.5)

    def _initial_spectra(self, nrow, ndelay, dtype):
        return np.full((nrow, ndelay), self.initial_amplitude, dtype=dtype)

    def _row_spectrum(self, block, w, prior, ndelay, chans):
        draws, converged = delay_power_spectrum_gibbs(
            _host(block),
            ndelay,
            _host(w),
            prior,
            window=self._window_name,
            fsel=chans,
            niter=self.nsamp,
            rng=self.rng,
            complex_timedomain=self.complex_timedomain,
        )
        keep = int(self.nsamp * self.median_frac)
        if not draws:
            return prior, draws, False
        return np.fft.fftshift(np.median(draws[-keep:], axis=0)), draws, converged


def _batch_cut_masks(wmask: torch.Tensor, time_frac, freq_frac):
    """Batch analogue of ``_trim_block``'s pruning, shared by the batched
    Gibbs estimators: common dead-time pruning, then the per-baseline
    retained-channel criterion against the batch union.

    wmask : bool tensor [nbase, ..., ntime, nfreq] (any number of middle axes).
    Returns host (non_zero_time, freq_ok, uniform) or None when nothing
    survives (callers fall back to the per-baseline sampler).
    """
    ntime, nfreq = wmask.shape[-2:]
    t_occ = wmask.sum(dim=-1, dtype=torch.int32).to(torch.float64) / nfreq
    non_zero_time = t_occ.reshape(-1, ntime).mean(dim=0) > time_frac
    if not bool(non_zero_time.any()):
        return None
    wmask_t = wmask.index_select(-2, torch.nonzero(non_zero_time).flatten())
    axes = tuple(range(1, wmask_t.ndim - 1))
    nmid = int(np.prod([wmask_t.shape[a] for a in axes]))
    fmask = wmask_t.sum(dim=axes, dtype=torch.int32).to(torch.float64) / nmid > freq_frac  # [nbase, nfreq]
    freq_ok = fmask.any(dim=0)
    uniform = (fmask == freq_ok).all(dim=-1) & wmask_t.reshape(wmask_t.shape[0], -1).any(dim=-1)
    if not bool(freq_ok.any()) or not bool(uniform.any()):
        return None
    return _host(non_zero_time), _host(freq_ok), _host(uniform)


def _select(x: torch.Tensor, sel, non_zero_time, freq_ok) -> torch.Tensor:
    """x[sel][..., non_zero_time, :][..., freq_ok] with index tensors on x's device."""

    def idx(m):
        return torch.as_tensor(np.flatnonzero(m), device=x.device)

    x = x.index_select(0, torch.as_tensor(sel, device=x.device))
    return x.index_select(x.ndim - 2, idx(non_zero_time)).index_select(x.ndim - 1, idx(freq_ok))


class DelayPowerSpectrumGibbsBatched(DelayPowerSpectrumGibbs):
    """Batched-Gibbs power spectrum: the chains advance together on the device.

    Takes the baselines whose retained frequency mask equals the batch
    union (per-baseline trimming would otherwise vary it); the others fall
    back to the per-baseline sampler of the parent class.  Each baseline's
    chain is seeded on its own, so its samples do not depend on the other
    baselines.

    The chain runs :data:`~draco_tpu_torch.ops.delay.GIBBS_BATCH` baselines
    at a time.  The output's attr ``gibbs_failed`` counts the chains whose
    factorisation failed (masked).
    """

    def _fill_output(self, rows, wrows, out, delays, chans):
        if self.scale_freq or not self.use_average_weights:
            # per-baseline semantics that do not batch
            self.log.info("scale_freq / use_average_weights=False configured: taking the per-baseline sampler.")
            return super()._fill_output(rows, wrows, out, delays, chans)

        ndelay = len(delays)
        masks = _batch_cut_masks(wrows > 0, self.time_frac, self.freq_frac)
        if masks is None:
            return super()._fill_output(rows, wrows, out, delays, chans)
        non_zero_time, freq_ok, uniform = masks

        rest = np.flatnonzero(~uniform)
        if len(rest):
            self.log.info(f"{len(rest)} baselines have non-uniform frequency masks; sampling them per baseline.")
            super()._fill_output(rows, wrows, out, delays, chans, subset=rest)

        sel = np.flatnonzero(uniform)
        data = _select(rows, sel, non_zero_time, freq_ok)
        if self.remove_mean:
            data -= data.mean(dim=-2, keepdim=True)
        w = _select(wrows, sel, non_zero_time, freq_ok).mean(dim=-2) * self.weight_boost

        priors = self._initial_spectra(len(sel), ndelay, delays.dtype)
        draws, failed = delay_power_spectrum_gibbs_batched(
            data,
            ndelay,
            w,
            priors,
            window=self._window_name,
            fsel=chans[freq_ok],
            niter=self.nsamp,
            seeds=self.row_seeds(len(sel)),
            complex_timedomain=self.complex_timedomain,
        )  # [niter, nbase_sel, ndelay]
        keep = int(self.nsamp * self.median_frac)
        spec = torch.fft.fftshift(_median(draws[-keep:], dim=0), dim=-1)

        # a failed factorisation (cholesky_ex's info) or a non-finite chain
        # is masked, not written
        bad = failed | ~torch.isfinite(spec).all(dim=-1)
        bad |= (data.reshape(len(sel), -1) == 0).all(dim=-1)
        n_failed = int(bad.sum())
        if n_failed:
            self.log.warning(f"{n_failed} batched Gibbs chains failed or produced non-finite spectra; masking them.")
        spec = torch.where(bad[:, None], 0.0, spec)

        sel_t = torch.as_tensor(sel, device=spec.device)
        out.spectrum[:].index_copy_(0, sel_t, spec.to(out.spectrum.dtype))
        if self.save_samples:
            sd = out.datasets["spectrum_samples"][:]
            sd[-len(draws) :].index_copy_(1, sel_t, torch.fft.fftshift(draws, dim=-1).to(sd.dtype))
        if self.save_spectrum_mask:
            out.datasets["spectrum_mask"][:][sel] = _host(bad)
        out.attrs["gibbs_failed"] = n_failed
        return out


class DelayPowerSpectrumNRML(DelayPowerSpectrumBase):
    """Maximum-likelihood (NRML) power spectrum (reference delay.py:1270).

    scipy's Newton-CG drives each baseline on the host; the likelihood's
    factorisations run in complex128 on the data's device.
    """

    maxpost_tol = config.float_prop(1e-3)
    nsamp = config.int_prop(100)

    def _initial_spectra(self, nrow, ndelay, dtype):
        return [None] * nrow

    def _row_spectrum(self, block, w, prior, ndelay, chans):
        draws, converged = delay_power_spectrum_maxpost(
            _host(block),
            ndelay,
            _host(w),
            prior,
            window=self._window_name,
            fsel=chans,
            maxiter=self.nsamp,
            tol=self.maxpost_tol,
            device=self._device,
        )
        return np.fft.fftshift(draws[-1]), draws, converged


class DelayCrossPowerSpectrumEstimator(DelayPowerSpectrumGibbs):
    """Pairwise delay cross-power spectra, baseline by baseline on the host (reference delay.py:1304)."""

    def _gather_rows(self, sslist):
        if not isinstance(sslist, (list, tuple)):
            sslist = [sslist]
        if len(sslist) == 0:
            raise ValueError("No datasets passed.")
        freq_ref = sslist[0].freq
        all_rows, all_wrows = [], []
        coords = None
        for ss in sslist:
            # ANY mismatched channel invalidates the cross-correlation
            if len(ss.freq) != len(freq_ref) or (ss.freq != freq_ref).any():
                raise ValueError("Cross-spectrum inputs disagree on the frequency axis.")
            rows, wrows, ca = GeneralInputContainerMixin._gather_rows(self, ss)
            if coords is not None and coords != ca:
                raise ValueError("Cross-spectrum inputs disagree on their axis layout.")
            all_rows.append(rows)
            all_wrows.append(wrows)
            coords = ca
        return all_rows, all_wrows, coords

    def _spectral_axis(self, ss):
        if isinstance(ss, (list, tuple)):
            ss = ss[0]
        return super()._spectral_axis(ss)

    def _blank_output(self, ss, delays, coords):
        first = ss[0] if isinstance(ss, (list, tuple)) else ss
        nstream = len(ss) if isinstance(ss, (list, tuple)) else 1
        baseline = first.index_map[coords[0]] if len(coords) == 1 else np.arange(_flat_row_count(first, coords))
        out = containers.DelayCrossSpectrum(
            baseline=baseline, dataset=np.arange(nstream), delay=delays, sample=self.nsamp, attrs_from=first,
            device=first.device,
        )
        _attach_coords(out, first, coords)
        if self.save_samples:
            out.add_dataset("spectrum_samples")
        out.attrs["freq"] = first.freq
        return out

    def _coupled_priors(self, nrow, nstream, ndelay, dtype):
        priors = self._initial_spectra(nrow, ndelay, dtype)
        return np.identity(nstream)[np.newaxis, ..., np.newaxis] * priors[:, np.newaxis, np.newaxis]

    def _fill_output(self, rows, wrows, out, delays, chans, subset=None):
        ndelay = len(delays)
        nrow = out.spectrum.shape[-2]
        priors = self._coupled_priors(nrow, len(rows), ndelay, delays.dtype)
        samples_ds = out.datasets["spectrum_samples"] if self.save_samples else None

        for bi in range(nrow) if subset is None else subset:
            trimmed = self._trim_block(torch.stack([r[bi] for r in rows]), torch.stack([w[bi] for w in wrows]))
            if trimmed is None:
                continue
            block, w, f_keep, _ = trimmed
            draws = delay_spectrum_gibbs_cross(
                _host(block),
                ndelay,
                _host(w),
                priors[bi],
                window=self._window_name,
                fsel=chans[f_keep],
                niter=self.nsamp,
                rng=self.rng,
            )
            middle = np.median(draws[-(self.nsamp // 2) :], axis=0)
            out.spectrum[..., bi, :] = np.fft.fftshift(middle.real, axes=-1)
            if samples_ds is not None:
                samples_ds[..., bi, :] = np.fft.fftshift(np.array(draws).real, axes=-1)
        return out

    def process(self, *sslist):
        """Estimate the cross power spectra of several containers."""
        sslist = list(sslist)
        self._device = sslist[0].device
        delays, chans = self._spectral_axis(sslist)
        rows, wrows, coords = self._gather_rows(sslist)
        out = self._blank_output(sslist, delays, coords)
        out.attrs["window_los"] = str(self._window_name)
        return self._fill_output(rows, wrows, out, delays, chans)


class DelayCrossPowerSpectrumEstimatorBatched(DelayCrossPowerSpectrumEstimator):
    """Batched cross-PS Gibbs: the baselines' chains advance on the device.

    Mirrors :class:`DelayPowerSpectrumGibbsBatched`: baselines whose
    retained frequency mask equals the batch union run as batched device
    chains (complex Cholesky over the coupled ``nd N`` system, ``bchunk``
    baselines a call); the rest take the per-baseline host sampler.  A
    chain whose factorisation fails in the data's precision is re-sampled
    in complex128 on the same device (counted in the output's attr
    ``gibbs_resampled``); one that fails there too raises.

    Attributes
    ----------
    bchunk : int
        Baselines per device call (bounds the Cholesky workspace).
    """

    bchunk = config.int_prop(CROSS_BATCH)

    def _fill_output(self, rows, wrows, out, delays, chans):
        if self.scale_freq or not self.use_average_weights:
            self.log.info("scale_freq / use_average_weights=False configured: taking the per-baseline sampler.")
            return super()._fill_output(rows, wrows, out, delays, chans)

        ndelay = len(delays)
        dv = torch.stack(rows, dim=1)  # [nbase, nd, nsample, nfreq]
        wv = torch.stack(wrows, dim=1)
        nstream = dv.shape[1]

        masks = _batch_cut_masks(wv > 0, self.time_frac, self.freq_frac)
        if masks is None:
            return super()._fill_output(rows, wrows, out, delays, chans)
        non_zero_time, freq_ok, uniform = masks

        rest = np.flatnonzero(~uniform)
        if len(rest):
            self.log.info(f"{len(rest)} baselines have non-uniform frequency masks; sampling them per baseline.")
            super()._fill_output(rows, wrows, out, delays, chans, subset=rest)

        sel = np.flatnonzero(uniform)
        data = _select(dv, sel, non_zero_time, freq_ok)
        if self.remove_mean:
            data = data - data.mean(dim=-2, keepdim=True)
        w = _select(wv, sel, non_zero_time, freq_ok).mean(dim=-2) * self.weight_boost  # [bsel, nd, nfreq']
        coupled = self._coupled_priors(len(sel), nstream, ndelay, delays.dtype)
        seeds = self.row_seeds(len(sel))
        kw = dict(window=self._window_name, fsel=chans[freq_ok], niter=self.nsamp, bchunk=self.bchunk)
        draws, failed = delay_spectrum_gibbs_cross_batched(data, ndelay, w, coupled, seeds=seeds, **kw)

        # The coupled system's condition number is ~1 + S_prior x nfreq x
        # Ni; past ~1e7 a complex64 factorisation breaks down.  Those
        # chains are drawn again in complex128 on the same device.
        redo = np.flatnonzero(_host(failed))
        if len(redo):
            self.log.info(f"{len(redo)} chains failed in {data.dtype}; re-sampling them in complex128 on the device.")
            r = torch.as_tensor(redo, device=data.device)
            again, failed2 = delay_spectrum_gibbs_cross_batched(
                data.index_select(0, r).to(torch.complex128), ndelay, w.index_select(0, r).double(), coupled[redo],
                seeds=[seeds[i] for i in redo], **kw,
            )
            if bool(failed2.any()):
                raise RuntimeError(f"{int(failed2.sum())} cross-spectrum chains failed in complex128 as well")
            draws = draws.to(torch.complex128)
            draws[:, r] = again
        out.attrs["gibbs_resampled"] = len(redo)

        keep = int(self.nsamp * self.median_frac)
        spec = torch.fft.fftshift(_median(draws[-keep:].real, dim=0), dim=-1)
        sel_t = torch.as_tensor(sel, device=spec.device)
        out.spectrum[:].index_copy_(2, sel_t, spec.movedim(0, -2).to(out.spectrum.dtype))
        if self.save_samples:
            sd = out.datasets["spectrum_samples"][:]
            sd[-len(draws) :].index_copy_(
                3, sel_t, torch.fft.fftshift(draws.real.movedim(1, -2), dim=-1).to(sd.dtype)
            )
        return out


class DelayPowerSpectrumStokesIEstimator(DelayPowerSpectrumGibbs):
    """Deprecated (reference delay.py:1451)."""

    def setup(self, requires=None):
        """Raise a deprecation warning."""
        raise DeprecationWarning(
            "DelayPowerSpectrumStokesIEstimator is retained only for "
            "compatibility: form Stokes I explicitly "
            "Use `transform.StokesIVis` to generate Stokes I visibilities, "
            "and run DelayPowerSpectrumGibbs or DelayPowerSpectrumNRML."
        )


class DelayPowerSpectrumGeneralEstimator(DelayPowerSpectrumGibbs):
    """Deprecated (reference delay.py:1464)."""

    def setup(self, requires=None):
        """Raise a deprecation warning."""
        raise DeprecationWarning(
            "DelayPowerSpectrumGeneralEstimator is retained only for "
            "compatibility; prefer DelayPowerSpectrumGibbs or "
            "DelayPowerSpectrumNRML."
        )
