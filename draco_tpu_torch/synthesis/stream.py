"""Simulate sidereal and time stream data.

Port of ``draco_tpu.synthesis.stream``: reference
``draco/synthesis/stream.py`` (SimulateSidereal:22, ExpandProducts:181,
MakeTimeStream:249, MakeTimeStreamFixedInput:346, MakeTimeStreamFixedTime:378,
MakeMultipleTimeStreams:410, MakeSiderealDayStream:495).

The simulate spine (reference stream.py:85-140), map -> alm (SHT) -> per-m
beam transfer projection -> inverse FFT over RA, runs as batched torch
operations on the map's device in float32, with no per-m Python loop.

``MakeTimeStream`` gives its output container the ``time`` and ``ra`` axes
only where that container type has them, so a ``HybridVisStream`` (which
has no time axis) resamples along RA; the JAX package always passes
``time=`` and raises ``TypeError`` there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.task import ContainerTask, PipelineStopIteration
from ..ops import mmode, regrid, sht
from ..ops.tools import axis_blocks, find_keys, invert_no_zero


class SimulateSidereal(ContainerTask):
    """Create a simulated sidereal dataset from an input map.

    (reference stream.py:22-178)

    Attributes
    ----------
    stacked : bool
        Label the output baselines as a stacked set (index_map/stack +
        reverse_map/stack from the telescope) rather than a down-selection.
    fast_ra : bool
        Round the sidereal axis up to the next 2/3/5-smooth length; the
        extra samples carry no extra information (the m-mode content is
        the same).
    streaming : bool
        Use the streaming (factorised) projection, which never
        materialises the beam transfer matrices.
    baseline_chunk : int
        Baselines per chunk of the streaming projection.
    """

    stacked = config.bool_prop(True)
    fast_ra = config.bool_prop(False)
    streaming = config.bool_prop(False)
    baseline_chunk = config.int_prop(256)

    # every channel is simulated on its own: under a mesh each rank
    # simulates its own channels
    freq_local = True

    def setup(self, bt):
        """Set the beam transfer manager (BeamTransfer or ProductManager)."""
        self.beamtransfer = io.get_beamtransfer(bt)
        self.telescope = io.get_telescope(bt)

    def process(self, map_: containers.Map) -> containers.SiderealStream:
        """Simulate a SiderealStream from a Map, on the map's device."""
        bt = self.beamtransfer
        tel = self.telescope

        lmax, mmax = tel.lmax, tel.mmax
        ntime = mmode.fast_fft_size(2 * mmax + 1) if self.fast_ra else 2 * mmax + 1

        freqmap = map_.index_map["freq"][:]
        # the telescope channels of the map's (all of them, or a rank's slab)
        freqs = find_keys(list(tel.frequencies), list(freqmap["centre"]))
        if None in freqs or len(freqs) == 0:
            raise ValueError("The sky map and beam-transfer frequency axes disagree.")

        # sky harmonics of every (freq, pol) map, trimmed to mmax; the
        # simulation runs in float32, the JAX package's device precision
        sky = map_.map[:].to(torch.float32)
        # channel by channel: a channel's bits do not depend on the slab
        alm = sht.sphtrans_sky(sky, lmax=lmax, per_channel=True)[..., : mmax + 1]

        if self.streaming:
            vis_m = bt.project_sky_to_telescope_streaming(alm, chunk=self.baseline_chunk, freqs=freqs)
        else:
            bt.generate(device=sky.device)
            vis_m = bt.project_sky_to_telescope(alm, freqs=freqs)  # [m+1, 2, nfreq, nb]
        # the simulated m-modes always fill the largest negative m (oddra)
        vis_stream = mmode.mmodes_to_sidereal(vis_m, n=ntime, oddra=True)  # [f, b, t]
        del alm, vis_m

        # A redundancy-stacked telescope (fewer unique pairs than the full
        # triangle) carries its own prod/stack maps; otherwise label each
        # unique pair directly.
        full_triangle = tel.npairs == tel.nfeed * (tel.nfeed + 1) // 2
        if self.stacked and not full_triangle:
            pair_kwargs = dict(
                prod=tel.index_map_prod,
                stack=tel.index_map_stack,
                reverse_map_stack=tel.reverse_map_stack,
            )
        else:
            pairs = np.asarray(tel.uniquepairs)
            prod_map = np.empty(len(pairs), dtype=[("input_a", int), ("input_b", int)])
            prod_map["input_a"], prod_map["input_b"] = pairs.T
            pair_kwargs = {"prod": prod_map}

        sstream = containers.SiderealStream(
            freq=freqmap,
            ra=ntime,
            input=getattr(tel, "input_index", tel.nfeed),
            distributed=True,
            device=map_.device,
            **pair_kwargs,
        )
        sstream.vis[:] = vis_stream
        sstream.weight[:] = 1.0
        return sstream


class ExpandProducts(ContainerTask):
    """Un-wrap collated products to the full triangle (reference stream.py:181).

    A gather along the stack axis with a conjugation mask replaces the
    per-product Python loop (reference stream.py:233-244).
    """

    def setup(self, telescope):
        self.telescope = io.get_telescope(telescope)

    def process(self, sstream: containers.SiderealStream) -> containers.SiderealStream:
        tel = self.telescope
        ninput = len(sstream.input)
        fi, fj = np.triu_indices(ninput)
        nprod = fi.size
        prod = np.empty(nprod, dtype=[("input_a", int), ("input_b", int)])
        prod["input_a"], prod["input_b"] = fi, fj

        new_stream = containers.SiderealStream(prod=prod, stack=None, axes_from=sstream)

        dev = sstream.device
        unique_ind = tel.feedmap[fi, fj]  # [nprod]
        valid_np = unique_ind >= 0
        idx = torch.as_tensor(np.where(valid_np, unique_ind, 0), dtype=torch.long, device=dev)
        conj = torch.as_tensor(tel.feedconj[fi, fj], dtype=torch.bool, device=dev)[None, :, None]
        valid = torch.as_tensor(valid_np, device=dev)[None, :, None]

        # product blocks written into the new stream's own datasets: no
        # temporary of the full triangle's size
        vis_in, vis, weight = sstream.vis[:], new_stream.vis[:], new_stream.weight[:]
        for p0, p1 in axis_blocks(nprod, vis.shape[0] * vis.shape[2]):
            gathered = vis_in.index_select(1, idx[p0:p1])  # [f, block, ra]
            vis[:, p0:p1] = torch.where(conj[:, p0:p1], gathered.conj(), gathered) * valid[:, p0:p1]
            weight[:, p0:p1] = valid[:, p0:p1]

        # Identity stack maps to mimic an N^2 file (reference stream.py:221-230)
        fwd, rev = containers.default_stack_maps(nprod)
        new_stream.create_index_map("stack", fwd)
        new_stream.create_reverse_map("stack", rev)
        return new_stream


class MakeTimeStream(ContainerTask):
    """Sample a sidereal stream at the times of a timestream.

    (reference stream.py:249-343): periodic Lanczos interpolation of the
    RA axis, applied on the stream's device; weights combine as inverse
    variances.
    """

    lanczos_width = config.int_prop(5)

    # output container per input type; checked in order so subclasses
    # that appear in both rows resolve to the more specific mapping
    _output_types = (
        (containers.HybridVisStream, containers.HybridVisStream),
        (containers.SiderealStream, containers.TimeStream),
    )

    def setup(self, observer):
        self.observer = io.get_telescope(observer)

    def _sample_times(self, tstream):
        """(unix time, RA degrees) of the target samples."""
        if hasattr(tstream, "time") and "time" in tstream.index_map:
            t = tstream.time[:]
            return t, self.observer.unix_to_lsa(t)
        ra = tstream.ra[:]
        day = tstream.attrs.get("lsd", tstream.attrs.get("csd"))
        return self.observer.lsd_to_unix(day + ra / 360.0), ra

    def process(self, sstream, tstream):
        time, tra = self._sample_times(tstream)

        for in_type, out_type in self._output_types:
            if isinstance(sstream, in_type):
                break
        else:
            raise TypeError(f"No valid container mapping for {sstream.__class__}.")

        # the sample axes the output type has: a TimeStream's time, a
        # HybridVisStream's ra (it has no time axis)
        axes = out_type.axes_spec()
        kw = {name: value for name, value in (("time", time), ("ra", tra)) if name in axes}
        out = out_type(axes_from=sstream, attrs_from=sstream, **kw)

        R = torch.as_tensor(
            regrid.lanczos_forward_matrix(sstream.ra, tra % 360, self.lanczos_width, periodic=True).T,
            device=sstream.device,
        )  # [nra, nsample]

        def along_ra(ds, combine):
            ax = list(ds.axes).index("ra")
            moved = ds[:].movedim(ax, -1)
            return combine(moved, R.to(moved.dtype)).movedim(-1, ax)

        out.data[:] = along_ra(sstream.data, lambda x, r: x @ r)
        out.weight[:] = along_ra(sstream.weight, lambda w, r: invert_no_zero(invert_no_zero(w) @ (r**2)))
        return out


class MakeTimeStreamFixedInput(MakeTimeStream):
    """Make multiple time streams from a single input (reference stream.py:346)."""

    def setup(self, observer, sstream):
        super().setup(observer)
        self.sstream = sstream

    def process(self, tstream):
        return super().process(self.sstream, tstream)


class MakeTimeStreamFixedTime(MakeTimeStream):
    """Make multiple time streams for fixed time samples (reference stream.py:378)."""

    def setup(self, observer, tstream):
        super().setup(observer)
        self.tstream = tstream

    def process(self, sstream):
        return super().process(sstream, self.tstream)


class MakeMultipleTimeStreams(MakeTimeStreamFixedInput):
    """Generate a series of time stream files from a sidereal stream.

    (reference stream.py:410-492)
    """

    start_time = config.utc_time()
    end_time = config.utc_time()
    integration_time = config.float_prop(None)
    integration_frame_exp = config.int_prop(23)
    samples_per_file = config.int_prop(1024)

    _time_axes = None

    def process(self):
        if self._time_axes is None:
            self._time_axes = self._iter_time_axes()
        try:
            tstream = next(self._time_axes)
        except StopIteration:
            raise PipelineStopIteration() from None
        return super().process(tstream)

    def _iter_time_axes(self):
        """Yield one TOD time axis per output file across the span.

        Samples are spaced by ``integration_time`` seconds when given, else
        by an FPGA frame count of ``2**integration_frame_exp`` (2.56 us
        frames); the FPGA case carries a structured (fpga_count, ctime)
        axis like real correlator data.
        """
        fpga_frames = self.integration_time is None
        step = 2.56e-6 * 2**self.integration_frame_exp if fpga_frames else self.integration_time
        cursor = self.start_time
        while cursor < self.end_time:
            n = min(self.samples_per_file, int(np.ceil((self.end_time - cursor) / step)))
            stamps = cursor + step * np.arange(1, n + 1)
            cursor += n * step
            if fpga_frames:
                axis = np.zeros(n, dtype=[("fpga_count", np.uint64), ("ctime", np.float64)])
                axis["ctime"] = stamps
                frames = (stamps - self.start_time) / step
                axis["fpga_count"] = (frames * 2**self.integration_frame_exp).astype(np.uint64)
            else:
                axis = stamps
            yield containers.TODContainer(time=axis, skip_datasets=True, device=self.sstream.device)


class MakeSiderealDayStream(ContainerTask):
    """Emit a copy of a base sidereal stream for every LSD in a time range.

    (reference stream.py:495-561)
    """

    start_time = config.utc_time()
    end_time = config.utc_time()

    def setup(self, bt, sstream):
        observer = io.get_telescope(bt)
        lsd_start = observer.unix_to_lsd(self.start_time)
        lsd_end = observer.unix_to_lsd(self.end_time)
        self.log.info("Simulating the sidereal range LSD %i..%i", int(lsd_start), int(lsd_end))
        # first full day after the start, through the last day before the end
        self._days = iter(range(int(lsd_start + 1), int(np.ceil(lsd_end))))
        self.sstream = sstream

    def process(self):
        try:
            day = next(self._days)
        except StopIteration:
            raise PipelineStopIteration() from None
        out = self.sstream.copy()
        out.attrs.update(tag=f"lsd_{day}", lsd=day)
        return out
