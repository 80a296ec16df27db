"""Data interpolation / DPSS inpainting tasks.

Port of ``draco_tpu.analysis.interpolate`` (reference
``draco/analysis/interpolate.py``: DPSSFilter:13, DPSSFilterBaseline:193,
DPSSFilterDelay:272, DPSSFilterMMode:315, StokesIMixin:354,
DPSSFilterDelayStokesI:363, DPSSFilterMModeStokesI:367).

The tasks work on their container's device.  Every basis is built in
float64 there (the unique cuts' ``eigh`` calls batched); the rows that use
a basis are solved together (:mod:`..ops.dpss`: one factorisation for each
unique weight row), and the variance accumulation and gap flags run for
every row at once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, io
from ..core.task import ContainerTask
from ..ops import dpss

C_LIGHT = 299792458.0


class DPSSFilter(ContainerTask):
    """Fill data gaps using DPSS inpainting (reference interpolate.py:13).

    Projects a partially-masked series onto the Slepian basis that maximally
    concentrates spectral power within configured top-hat windows, Wiener
    solves for the coefficients, and writes filtered/inpainted values back.

    Attributes
    ----------
    inpaint : bool
        If True, only flagged values are replaced.  Otherwise the whole
        dataset is the filtered version.  Default True.
    axis : str
        Axis to inpaint over ("freq" or "ra").  Default "freq".
    iter_axes : list
        Independent axes; the first one present groups the basis map.
    centres, halfwidths : list
        Top-hat window centres / half-widths (Fourier-inverse units of the
        axis samples).
    epsilon : float
        Wiener inverse signal variance regulariser.  Default 1e-3.
    cutoff_frac : float
        Re-flag gaps wider than ``cutoff_frac * fs / max(halfwidths)``.
    copy : bool
        Copy the container instead of writing in place.
    """

    inpaint = config.bool_prop(True)
    axis = config.enum(["freq", "ra"], default="freq")
    iter_axes = config.list_prop(["stack", "el"])
    centres = config.list_prop()
    halfwidths = config.list_prop()
    epsilon = config.float_prop(1.0e-3)
    cutoff_frac = config.float_prop(1.0)
    copy = config.bool_prop(True)

    def setup(self, mask=None):
        """Optionally use a mask container (True = flagged) to select the samples to inpaint.

        If omitted, samples with zero weight are inpainted.
        """
        self.mask = mask

    def process(self, data):
        """Inpaint the visibility dataset of ``data``."""
        try:
            samples = np.asarray(getattr(data, self.axis))
        except AttributeError as exc:
            raise ValueError(f"No axis named {self.axis!r} on the input.") from exc
        if samples.dtype.names and "centre" in samples.dtype.names:
            samples = samples["centre"]

        self._set_sel(data)

        vis = data.vis[:]
        weight = data.weight[:]
        axes = list(data.vis.attrs["axis"])

        vinp, winp = self._filter(vis, weight, axes, samples)

        out = data.copy() if self.copy else data
        out.vis[:] = vinp
        out.weight[:] = winp
        return out

    # -- core ---------------------------------------------------------------

    def _filter(self, vis, weight, axes, samples):
        """Group rows by basis and solve each group together (interpolate.py:123)."""
        sax = axes.index(self.axis)
        iter_present = [a for a in self.iter_axes if a in axes]
        if not iter_present:
            raise ValueError(f"None of iter_axes {self.iter_axes} in dataset axes {axes}.")
        gax = axes.index(iter_present[0])

        # Layout [group, middle, nsamp]: group = first iteration axis,
        # samples last, everything else flattened
        def to_gms(arr):
            a = torch.movedim(arr, (gax, sax), (0, -1))
            return a.reshape(arr.shape[gax], -1, arr.shape[sax]), a.shape

        vobs, vshape = to_gms(vis)
        wobs, _ = to_gms(weight)

        if self.mask is not None:
            # Broadcast the (True = flagged) mask against the vis axes, then
            # invert: True = keep (reference interpolate.py:134-136)
            maxes = list(self.mask.mask.attrs["axis"])
            marr = torch.as_tensor(np.asarray(self.mask.mask[:]), device=vis.device)
            sl = tuple(slice(None) if ax in maxes else None for ax in axes)
            mobs, _ = to_gms(~marr[sl].expand(vis.shape))
        else:
            mobs = None

        modes, amap, cutoff = self._get_basis(samples, vobs.shape[0], vis.device)
        amap = np.asarray(amap)

        vinp = torch.zeros_like(vobs)
        winp = torch.zeros_like(wobs)

        for bi in range(len(modes)):
            rows = torch.as_tensor(np.flatnonzero(amap == bi), device=vis.device)
            if rows.numel() == 0:
                continue
            A = modes[bi]
            v = vobs[rows]
            w = wobs[rows]
            M = w > 0
            W = mobs[rows] if mobs is not None else M

            # masked samples must not drive the Wiener fit: with no mask
            # container W == M, so this is w unchanged
            xf, wf = dpss.filter_batched(v, w * W, A, W, self.epsilon)
            # accumulate the gap-interpolated original variance on the RAW
            # filtered weights (reference order: filter -> accumulate ->
            # keep-override)
            wf = dpss.accumulate_variance(w, wf, W)
            if self.inpaint:
                xf = torch.where(W, v.to(xf.dtype), xf)
                wf = torch.where(W, w.to(wf.dtype), wf)
            wf = wf * dpss.flag_above_cutoff(M, cutoff[bi])

            vinp[rows] = xf.to(vinp.dtype)
            winp[rows] = wf.to(winp.dtype)

        def from_gms(arr):
            return torch.movedim(arr.reshape(vshape), (0, -1), (gax, sax))

        return from_gms(vinp), from_gms(winp)

    # -- overridables ---------------------------------------------------------

    def _set_sel(self, data):
        """Hook for subclasses to extract per-row metadata."""

    def _sample_rate(self, samples):
        return 1 / np.median(abs(np.diff(samples)))

    def _get_basis(self, samples, ngroup, device):
        """One shared basis for every row (reference interpolate.py:175)."""
        cov = dpss.make_covariance(samples, self.halfwidths, self.centres, device=device)
        cutoff = self.cutoff_frac * self._sample_rate(samples) / np.max(self.halfwidths)
        return [dpss.get_basis(cov)], [0] * ngroup, [cutoff]


class DPSSFilterBaseline(DPSSFilter):
    """Base class: per-baseline basis selection (reference interpolate.py:193).

    Subclasses implement ``_get_baseline_cuts``; unique cuts each get a
    basis (their ``eigh`` calls batched), rows map onto them via the
    baseline -> cut map.

    Attributes
    ----------
    telescope_orientation : "NS" | "EW" | "none"
        Which baseline component sets the cut.
    """

    telescope_orientation = config.enum(["NS", "EW", "none"], default="NS")

    def setup(self, telescope, mask=None):
        """Load a telescope object (and optional mask)."""
        self.telescope = io.get_telescope(telescope)
        super().setup(mask)

    def _set_sel(self, data):
        """Baselines for each stack row (reference interpolate.py:230)."""
        prod = data.prodstack
        sel = self.telescope.feedmap[(prod["input_a"], prod["input_b"])]
        self._baselines = self.telescope.baselines[sel]

    def _get_basis(self, samples, ngroup, device):
        """A basis per unique baseline cut (reference interpolate.py:237)."""
        cuts, amap = np.unique(self._get_baseline_cuts(), return_inverse=True)
        self.log.debug(f"Building {len(cuts)} bases (cuts {cuts.min()}-{cuts.max()}).")
        modes = dpss.get_bases([dpss.make_covariance(samples, cut, 0.0, device=device) for cut in cuts])
        # one cutoff PER basis group: a short baseline (small delay cut)
        # tolerates proportionally wider gaps than the longest one
        scale = self.cutoff_frac * self._sample_rate(samples)
        return modes, amap.reshape(-1), [scale / c for c in cuts]

    def _component_lengths(self, fringe_axis=False):
        """|baseline| along the configured orientation per stack row.

        fringe_axis swaps the component convention (m cuts scale with the
        EW extent for an NS orientation and vice versa).
        """
        column = {"NS": 1, "EW": 0}.get(self.telescope_orientation)
        if column is None:
            return np.linalg.norm(self._baselines, axis=1)
        if fringe_axis:
            column = 1 - column
        return abs(self._baselines[:, column])

    def _get_baseline_cuts(self):
        raise NotImplementedError()


class DPSSFilterDelay(DPSSFilterBaseline):
    """Inpaint in frequency with a baseline-dependent delay cut (reference interpolate.py:272-312).

    Attributes
    ----------
    za_cut : float
        Sine of the max zenith angle in the baseline-dependent delay
        (1 = horizon).  Default 1.
    extra_cut : float
        Additive delay threshold beyond the baseline term (microseconds).
    """

    axis = config.enum(["freq"], default="freq")
    za_cut = config.float_prop(1.0)
    extra_cut = config.float_prop(0.0)

    def _get_baseline_cuts(self):
        blen = self._component_lengths()
        horizon_us = self.za_cut * blen / C_LIGHT * 1.0e6 + self.extra_cut
        return np.round(np.maximum(horizon_us, self.halfwidths[0]), decimals=3)


class DPSSFilterMMode(DPSSFilterBaseline):
    """Inpaint in RA with a baseline-dependent m cut (reference interpolate.py:315-351).

    The cut uses the fringe-direction component (opposite convention to
    the delay cut).
    """

    axis = config.enum(["ra"], default="ra")

    def _get_baseline_cuts(self):
        blen = self._component_lengths(fringe_axis=True)
        freq = self.telescope.freq_start
        dec = np.deg2rad(self.telescope.latitude)
        # Max m per baseline, compensating for RA samples in degrees
        mcut = (np.pi / 180) * freq * 1e6 * blen / (C_LIGHT * np.cos(dec))
        return np.round(np.maximum(mcut, self.halfwidths[0]), decimals=2)


class StokesIMixin:
    """Baseline selection for Stokes-I stacked data (interpolate.py:354)."""

    def _set_sel(self, data):
        bl = np.asarray(data.stack)
        if bl.dtype.names is not None:
            raise TypeError(
                "Stokes-I DPSS filtering expects the stack index map to "
                "hold baseline VECTORS (a StokesIVis output); this "
                "container carries the (prod, conjugate) stack map — "
                "run StokesIVis first or use the telescope-based task."
            )
        self._baselines = bl


class DPSSFilterDelayStokesI(StokesIMixin, DPSSFilterDelay):
    """Inpaint Stokes I with a baseline-dependent delay cut."""


class DPSSFilterMModeStokesI(StokesIMixin, DPSSFilterMMode):
    """Inpaint Stokes I with a baseline-dependent m-mode cut."""
