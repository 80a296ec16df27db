"""Group and regrid timestreams into sidereal days.

Port of the first part of ``draco_tpu.analysis.sidereal``: reference
``draco/analysis/sidereal.py`` (SiderealGrouper:27, SiderealRegridder:160).
The regrid is :class:`~draco_tpu_torch.analysis.transform.LanczosRegridder`'s
banded Wiener filter on the data's device, whose banded covariance is the
hand-written CUDA kernel on the card.  The other regridders and the
stackers of the reference module are a later slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.containers import concatenate_tod
from ..core.task import ContainerTask
from .transform import LanczosRegridder

# Speed of light in m / (MHz * s): lambda[m] = C / f[MHz]
C_MHZ_M = 299.792458


class SiderealGrouper(ContainerTask):
    """Group individual timestreams into whole sidereal days.

    (reference sidereal.py:27-157)
    """

    padding = config.float_prop(0.0)
    offset = config.float_prop(0.0)
    min_day_length = config.float_prop(0.10)

    def __init__(self):
        super().__init__()
        self._group = []
        self._group_day = None

    def setup(self, manager):
        self.observer = io.get_telescope(manager)

    def _day_of(self, unix_time, pad):
        """Integer LSD containing ``unix_time`` padded by ``pad`` seconds."""
        return int(self.observer.unix_to_lsd(unix_time + pad - self.offset))

    def process(self, tstream):
        first_day = self._day_of(tstream.time[0], -self.padding)
        last_day = self._day_of(tstream.time[-1], self.padding)
        if self._group_day is None:
            self._group_day = first_day
        if first_day == self._group_day:
            self._group.append(tstream)
        self.log.info("Grouping another file under LSD %i", first_day)

        if last_day <= self._group_day:
            return None
        # the file crossed into a new day: the running group is complete
        self.log.info("Joining the collected files of LSD %i", self._group_day)
        finished = self._assemble()
        self._group = [tstream]
        self._group_day = last_day
        return finished

    def process_finish(self):
        return self._assemble() if self._group else None

    def _assemble(self):
        day = self._group_day
        files = self._group
        self._group = []
        span = (
            self.observer.unix_to_lsd(files[0].time[0]),
            self.observer.unix_to_lsd(files[-1].time[-1]),
        )
        if min(span[1], day + 1) - max(span[0], day) < self.min_day_length:
            return None
        self.log.info("Assembling LSD %i from %i files", day, len(files))
        out = concatenate_tod(files)
        out.attrs.update(tag=f"lsd_{day:d}", lsd=day)
        return out


class SiderealRegridder(LanczosRegridder):
    """Regrid a sidereal day onto a regular RA grid.

    (reference sidereal.py:160-278): the maximum-likelihood inverse
    Lanczos regrid over ``[lsd, lsd + 1]``, with optional fringe-rate
    down-mixing, on the data's device.
    """

    down_mix = config.bool_prop(False)

    def process(self, data):
        self.log.info(f"Regrid of LSD {data.attrs['lsd']}")
        data.redistribute("freq")
        self.start = float(data.attrs["lsd"])
        self.end = self.start + 1

        if "time" in data.index_map:
            source_samples = self.observer.unix_to_lsd(data.time)
        elif "ra" in data.index_map:
            source_samples = self.start + data.ra / 360.0
        else:
            raise TypeError(f"Invalid input data container {data.__class__.__name__}.")

        weight = data.weight[:]
        vis_data = data.vis[:]

        if self.down_mix:
            self.log.info("Fringe-rate down-mix applied ahead of the regrid.")
            freq = data.freq
            vis_data = vis_data * self._get_phase(freq, data.prodstack, source_samples, vis_data)

        new_grid, sts, ni = self._regrid(vis_data, weight, source_samples)

        if self.down_mix:
            phase = self._get_phase(freq, data.prodstack, new_grid, sts).conj()
            sts = sts * phase
            ni = ni * (phase.abs() > 0.0).to(ni.dtype)

        sdata = containers.SiderealStream(attrs_from=data, axes_from=data, ra=self.samples)
        sdata.vis[:] = sts
        sdata.weight[:] = ni
        sdata.attrs.update(lsd=self.start, tag=f"lsd_{self.start:.0f}")
        return sdata

    def _get_phase(self, freq, prod, lsd, like: torch.Tensor) -> torch.Tensor:
        """Zenith fringe-rate sinusoid [freq, baseline, sample] (reference
        sidereal.py:255-278), built on ``like``'s device in its dtype."""
        tel = self.observer
        mask = tel.feedmask[prod["input_a"], prod["input_b"]]
        # east-west fringe rate of the zenith-pointing phase centre, in rad
        # per sidereal turn, per (freq, baseline)
        u_ew = np.outer(np.asarray(freq) / C_MHZ_M, tel.baselines[:, 0])
        omega = -2.0 * np.pi * u_ew * np.cos(np.radians(tel.latitude))
        turns = 2.0 * np.pi * np.mod(np.asarray(lsd), 1.0)
        dev = like.device
        angle = torch.as_tensor(omega, device=dev)[..., None] * torch.as_tensor(turns, device=dev)
        amp = torch.as_tensor(mask, dtype=torch.float64, device=dev)[None, :, None].expand_as(angle)
        # mask * exp(-i omega turns)
        return torch.polar(amp, -angle).to(like.dtype)
