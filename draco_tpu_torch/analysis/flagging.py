"""Flagging of bad or unwanted data: RFI excision on a (freq, time) grid.

Port of the part of ``draco_tpu.analysis.flagging`` (reference
``draco/analysis/flagging.py``: RFIMask:2120, ApplyTimeFreqMask:2222 and
the mad:3231 / tv_channels_flag:3316 helpers) that the analysis example
config runs.  The MAD statistics are host numpy over the moving weighted
median, as in the JAX package; the mask is applied to the weights on the
stream's device.  ``ROADMAP.md`` lists the module's other tasks.

Masking convention: True marks contaminated samples.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers
from ..core.task import ContainerTask
from ..ops import filters
# the chi-squared reduction that the JAX package's grouped RFIStaticVisMask
# chains (flagging.py:1383-1394); that group comes with the module's other tasks
from .transform import ReduceChisqInverseRedundancy  # noqa: F401


def _pct(mask) -> float:
    """Percentage of True samples in a boolean array."""
    return 100.0 * float(np.mean(mask))


def _rfi_mask_for(stream, by_pol: bool = False):
    """An (optionally per-pol) RFI-mask container on the stream's axes.

    Picks the sidereal variant when the stream carries an ``ra`` axis.
    """
    sid = "ra" in stream.index_map
    if by_pol:
        cls = containers.SiderealRFIMaskByPol if sid else containers.RFIMaskByPol
    else:
        cls = containers.SiderealRFIMask if sid else containers.RFIMask
    return cls(axes_from=stream, attrs_from=stream)


def _writable_copy(data, share: str):
    """The container a weight-editing task should write into.

    ``share="all"`` edits in place; ``"none"`` deep-copies; any other
    value copies with that dataset shared.
    """
    if share == "all":
        return data
    return data.copy() if share == "none" else data.copy(shared=(share,))


class RFIMask(ContainerTask):
    """MAD + TV-channel RFI masking on a single stack (reference flagging.py:2120)."""

    sigma = config.float_prop(5.0)
    tv_fraction = config.float_prop(0.5)
    stack_ind = config.int_prop(0)

    def process(self, sstream):
        # one stack's (freq, time) plane comes to the host: the moving
        # medians are host numpy
        vis = sstream.vis[:][:, self.stack_ind].cpu().numpy()
        wgt = sstream.weight[:][:, self.stack_ind].cpu().numpy()

        # deviation in MAD units, with unestimable cells treated as bad
        low_weight = wgt < 1e-4 * wgt.mean()
        dev = mad(vis, low_weight)
        dev = np.where(np.isnan(dev), 2 * self.sigma, dev)

        tv_bands = tv_channels_flag(dev, sstream.freq, sigma=self.sigma, f=self.tv_fraction)
        out = _rfi_mask_for(sstream)
        out.mask[:] = tv_bands | (dev > self.sigma)
        self.log.info(f"RFI cut removes {_pct(out.mask[:]):0.2f}% of the data.")
        return out


class ApplyTimeFreqMask(ContainerTask):
    """Zero weights at masked (freq, time) samples (reference flagging.py:2222).

    The weights are multiplied where they lie (the stream's device), in
    place of the JAX package's host copy.
    """

    share = config.enum(["none", "vis", "map", "all"], default="all")
    collapse_pol = config.bool_prop(False)
    match_axes = config.bool_prop(True)

    #: mask container family -> required stream axis
    _family = (
        ((containers.RFIMask, containers.RFIMaskByPol), "time"),
        ((containers.SiderealRFIMask, containers.SiderealRFIMaskByPol), "ra"),
    )

    def process(self, tstream, rfimask):
        for classes, ax in self._family:
            if isinstance(rfimask, classes):
                tax = ax
                break
        else:
            raise TypeError(f"The mask must be an RFIMask or SiderealRFIMask, not {type(rfimask)}.")
        if tax not in tstream.index_map:
            kind = "time" if tax == "time" else "sidereal"
            raise TypeError(f"A {kind}-like container is needed; received {type(tstream)}.")
        stream_samples = tstream.index_map[tax]
        mask_samples = rfimask.index_map[tax]

        if not np.array_equal(tstream.freq, rfimask.freq):
            raise ValueError("Stream and mask disagree on the freq axis.")

        if self.match_axes:
            if not np.array_equal(stream_samples, mask_samples):
                raise ValueError("Stream and mask disagree on the time-like axis.")
            pick_stream = pick_mask = slice(None)
        else:
            pick_stream = np.isin(stream_samples, mask_samples)
            pick_mask = np.isin(mask_samples, stream_samples)
            if not pick_stream.any():
                raise ValueError("The stream and mask time axes do not overlap.")

        tstream.redistribute("freq")
        waxes = list(tstream.weight.axes)
        maxes = list(rfimask.mask.axes)
        mask = np.asarray(rfimask.mask[:])

        if "pol" in maxes:
            if self.collapse_pol or "pol" not in waxes:
                mask = mask.any(axis=maxes.index("pol"))
                maxes.remove("pol")
            elif not np.array_equal(tstream.index_map["pol"], rfimask.index_map["pol"]):
                raise ValueError("Stream and mask disagree on the pol axis.")

        grow = [slice(None) if ax in maxes else np.newaxis for ax in waxes]
        grow[waxes.index(tax)] = pick_mask

        out = _writable_copy(tstream, self.share)
        w = out.weight[:]
        keep = torch.as_tensor(~mask[tuple(grow)], device=w.device).to(w.dtype)
        if self.match_axes:
            w.mul_(keep)
        else:
            into = [slice(None)] * len(waxes)
            into[waxes.index(tax)] = torch.as_tensor(pick_stream, device=w.device)
            w[tuple(into)] *= keep
        return out


# Compatibility alias (reference flagging.py:3227)
ApplyRFIMask = ApplyTimeFreqMask


# ---------------------------------------------------------------------------
# Helper functions (reference flagging.py:3231-3430)
# ---------------------------------------------------------------------------


def mad(x, mask, base_size=(11, 3), mad_size=(21, 21), debug=False, sigma=True):
    """MAD deviation of freq-time data (reference flagging.py:3231)."""
    smooth = filters.medfilt(x, mask, size=base_size)
    dev = np.abs(x - smooth)
    spread = filters.medfilt(dev, mask, size=mad_size)
    if sigma:
        spread = spread * 1.4826  # MAD -> rms for a Gaussian
    with np.errstate(divide="ignore", invalid="ignore"):
        significance = dev / spread
    return (significance, dev, spread) if debug else significance


def inverse_binom_cdf_prob(k, N, F):
    """Trial probability with binomial CDF F at (k, N) (reference flagging.py:3274)."""
    from scipy.special import betaincinv

    return betaincinv(k + 1, N - k, 1 - F)


def sigma_to_p(sigma):
    """Two-tailed Gaussian excursion probability (reference flagging.py:3302)."""
    import scipy.stats as ss

    return 2 * ss.norm.sf(sigma)


def p_to_sigma(p):
    """Sigma exceeded with two-tailed probability p (reference flagging.py:3309)."""
    import scipy.stats as ss

    return ss.norm.isf(p / 2)


#: North-American TV broadcast bands: 67 stations of 6 MHz from 398 MHz
_TV_BAND_EDGES = 398.0 + 6.0 * np.arange(68)


def tv_channels_flag(x, freq, sigma=5, f=0.5, debug=False):
    """Flag whole TV-station bands whose bad-sample fraction exceeds ``f``.

    Within each 6 MHz broadcast band the per-band significance threshold
    is set so a fraction ``f`` of the band's channels exceeding it is a
    ``sigma``-level event under the binomial null; any band where the
    observed fraction tops ``f`` is masked in full.  Semantics of
    reference flagging.py:3316-3381.
    """
    x = np.asarray(x)
    null_p = sigma_to_p(sigma)
    half_ch = 0.5 * np.median(np.abs(np.diff(freq)))
    # ones init: channels outside every TV band keep frac = 1 and are
    # masked, as in the reference (flagging.py:3344; benign for bands fully
    # inside [398, 800] MHz, surprising outside)
    bad_frac = np.ones_like(x, dtype=np.float32)

    for band_lo, band_hi in zip(_TV_BAND_EDGES[:-1], _TV_BAND_EDGES[1:]):
        members = np.flatnonzero((freq + half_ch >= band_lo) & (freq - half_ch <= band_hi))
        if members.size == 0:
            continue
        n = members.size
        level = p_to_sigma(inverse_binom_cdf_prob(int(f * n), n, 1 - null_p))
        bad_frac[members] = np.mean(x[members] > level, axis=0)

    mask = bad_frac > f
    return (mask, bad_frac) if debug else mask
