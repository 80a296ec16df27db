"""Data calibration tasks.

Port of ``draco_tpu.analysis.calibration`` (reference
``draco/analysis/calibration.py``, ApplyGain:12): apply per-input complex
gains (or their inverse) to visibility products through
:func:`draco_tpu_torch.ops.tools.apply_gain`, in place on the stream's
device, block by block over the products.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers
from ..core.task import ContainerTask
from ..ops import tools

# Gain containers resolved over the stack axis rather than per input
_COMMON_MODE = (containers.CommonModeGainData, containers.CommonModeSiderealGainData)
# Gain containers carrying a sidereal (RA) sample axis
_SIDEREAL = (containers.SiderealGainData, containers.CommonModeSiderealGainData)


def _sample_axis_check(gain, tstream):
    """Raise when the gain and stream sample grids differ."""
    if isinstance(gain, _SIDEREAL):
        if (gain.ra != tstream.ra).any():
            raise RuntimeError("Gain and sidereal stream sample different RA points.")
    elif (gain.time != tstream.time).any():
        raise RuntimeError("Gain and timestream sample different time points.")


class ApplyGain(ContainerTask):
    """Apply a set of gains to a timestream or sidereal stack, in place.

    (reference calibration.py:12-195)

    Attributes
    ----------
    inverse : bool
        Apply the inverse of the gains (calibration) rather than the gains.
    update_weight : bool
        Scale the weight dataset consistently.
    smoothing_length : float
        Median-smooth gains over this many seconds (time streams only).
    """

    inverse = config.bool_prop(True)
    update_weight = config.bool_prop(False)
    smoothing_length = config.float_prop(None)

    def _load_gain(self, gain, tstream):
        """(gain values, gain weights or None), broadcastable over time."""
        if isinstance(gain, containers.StaticGainData):
            gw = gain.weight
            return gain.gain[:][..., None], (gw[:][..., None] if gw is not None else None)

        known = (containers.GainData, containers.SiderealGainData) + _COMMON_MODE
        if not isinstance(gain, known):
            raise RuntimeError("Unrecognised gain container layout.")

        g = torch.nan_to_num(gain.gain[:])
        gw = None if gain.weight is None else gain.weight[:]
        _sample_axis_check(gain, tstream)
        if self.smoothing_length is not None and not isinstance(gain, _SIDEREAL):
            g, gw = self._smooth(g, gw, gain)
        return g, gw

    def process(self, tstream, gain):
        tstream.redistribute("freq")
        gain.redistribute("freq")

        common = isinstance(gain, _COMMON_MODE)
        if tstream.is_stacked and not common:
            raise ValueError(f"Per-input gains cannot be pushed onto stacked data ({tstream!s})")

        vis = tstream.vis[:]
        g, gw = self._load_gain(gain, tstream)
        g = torch.nan_to_num(g).to(vis.device)
        g_inv = tools.invert_no_zero(g)

        self.log.info("Applying inverse gain." if self.inverse else "Applying gain.")
        g_vis = g_inv if self.inverse else g
        if common:
            vis *= (g_vis.abs() ** 2)[:, None, :].to(vis.real.dtype)
        else:
            tools.apply_gain(vis, g_vis, prod_map=tstream.prod, out=vis)

        # the weight factor; None when it is one everywhere
        wfac = None
        if self.update_weight:
            self.log.info("Applying gain to weight.")
            wfac = (g if self.inverse else g_inv).abs() ** 2
        if gw is not None:
            flag = (gw > 0.0).to(g.real.dtype).to(vis.device)
            wfac = flag if wfac is None else wfac * flag
        if wfac is not None:
            w = tstream.weight[:]
            if common:
                w *= (wfac**2)[:, None, :].to(w.dtype)
            else:
                tools.apply_gain(w, wfac, prod_map=tstream.prod, out=w)

        new_units = gain.gain.attrs.get("convert_units_to")
        if new_units is not None:
            tstream.vis.attrs["units"] = new_units
        return tstream

    def _smooth(self, g, gw, gain):
        """Weighted median smoothing of amplitude and phase over time, on the host.

        (reference :102-139, caput median.moving_weighted_median): flagged
        samples (weight 0, gains nan_to_num'd to 0) carry zero weight, so
        they cannot drag good neighbours' smoothed gain to zero.
        """
        from ..ops.median import moving_weighted_median

        dev = g.device
        g = g.cpu().numpy()
        gw = None if gw is None else gw.cpu().numpy()
        cadence = gain.time[1] - gain.time[0]
        half = int(np.ceil(self.smoothing_length / cadence)) // 2
        window = (1, 2 * half + 1)

        ntime = g.shape[-1]
        rows = g.reshape(-1, ntime)
        flags = np.ones(rows.shape, dtype=np.float64) if gw is None else (gw.reshape(-1, ntime) > 0) * 1.0

        amp = np.asarray(moving_weighted_median(np.abs(rows), flags, window))
        phase = np.asarray(moving_weighted_median(np.angle(rows), flags, window))
        g = (amp * np.exp(1.0j * phase)).reshape(g.shape)

        if gw is not None:
            shape = gw.shape
            gw = np.asarray(moving_weighted_median(gw.reshape(-1, ntime), flags, window)).reshape(shape)
            gw[flags.reshape(shape) == 0] = 0.0
            gw = torch.as_tensor(gw, device=dev)
        return torch.as_tensor(g, device=dev), gw
