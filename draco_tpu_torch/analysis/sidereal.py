"""Group, regrid, rebin and stack timestreams into sidereal days.

Port of ``draco_tpu.analysis.sidereal``: reference
``draco/analysis/sidereal.py`` (SiderealGrouper:27, SiderealRegridder:160
with GP:281/nearest:362/linear:386/cubic:464 variants, SiderealRebinner:550,
RebinGradientCorrection:734, SiderealStacker:834, SiderealStackerMatch:1082).

Everything runs on the data's device.  The Lanczos regrid is
:class:`~draco_tpu_torch.analysis.transform.LanczosRegridder`'s banded
Wiener filter, whose banded covariance is the hand-written CUDA kernel on
the card; the stencil regridders are gathers; the rebinner is a dense
product with the rebinning matrix in float64, a frequency block at a time.

Deliberate differences from the JAX package, each held by a test of
``tests/test_torch_sidereal.py``: the stackers update their running state in
place (the JAX package's donated jitted buffers) and keep it in the stack
container's own datasets, a frequency block at a time; the rebinner and the
gradient correction work in frequency and row blocks, where the JAX package
works on the host (the rebinner) or row by row (the correction).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.containers import concatenate_tod, empty_like
from ..core.task import ContainerTask
from ..ops import regrid, tools
from ..ops.tools import invert_no_zero
from .transform import LanczosRegridder

# Speed of light in m / (MHz * s): lambda[m] = C / f[MHz]
C_MHZ_M = 299.792458

# elements of the largest float64 temporary of a block (rebinner, correction, stackers)
BLOCK_ELEMENTS = 1 << 27


def _ensure_list(x):
    return list(x) if hasattr(x, "__iter__") else [x]


def get_slice_to_broadcast(weight_axis, dataset_axis):
    """Slice broadcasting the weights against a dataset (reference :1253)."""
    assert len(weight_axis) <= len(dataset_axis)
    assert all(wax in tuple(dataset_axis) for wax in weight_axis)
    common = [ax for ax in dataset_axis if ax in tuple(weight_axis)]
    assert all(wax == dax for wax, dax in zip(weight_axis, common))
    return tuple(slice(None) if ax in tuple(weight_axis) else None for ax in dataset_axis)


def _lead_blocks(x: torch.Tensor):
    """Blocks of ``x``'s leading axis of at most ``BLOCK_ELEMENTS`` elements."""
    per = x[0].numel() if x.ndim > 1 else 1
    return tools.axis_blocks(x.shape[0], per, BLOCK_ELEMENTS)


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


def _search_nearest(x, xeval):
    """Index of the element of sorted ``x`` nearest each value in ``xeval``."""
    right = np.clip(np.searchsorted(x, xeval), 0, x.size - 1)
    left = np.clip(right - 1, 0, None)
    return np.where(np.abs(xeval - x[left]) < np.abs(x[right] - xeval), left, right)


def _apply_stencil(vis, weight, x, grid, taps, coeffs, invalid, reach):
    """Shared gather-and-combine core of the stencil regridders.

    One engine serves nearest/linear/cubic: each variant supplies its tap
    indices ``taps`` [T, ngrid] (already clipped into range), tap weights
    ``coeffs`` [T, ngrid], and a precomputed ``invalid`` column mask for
    stencils that ran off the domain (host numpy).  The engine adds the
    distance rule — any tap farther than ``reach`` median input spacings
    from its target zeroes that column — combines the variance through the
    stencil, and requires every tap to be unflagged.  ``vis`` and
    ``weight`` are tensors; the gathers run on their device.
    """
    x = np.asarray(x)
    spacing = np.median(np.abs(np.diff(x)))
    dead = invalid | (np.abs(x[taps] - grid[None]) > reach * spacing).any(axis=0)

    dev = vis.device
    flagged = weight > 0.0
    var = invert_no_zero(weight)
    out_shape = (*vis.shape[:-1], grid.size)
    out_vis = torch.zeros(out_shape, dtype=vis.dtype, device=dev)
    out_var = torch.zeros(out_shape, dtype=torch.float64, device=dev)
    out_ok = torch.ones(out_shape, dtype=torch.bool, device=dev)
    for tap, cc in zip(taps, coeffs):
        idx = torch.as_tensor(tap, dtype=torch.long, device=dev)
        cc = torch.as_tensor(cc, dtype=torch.float64, device=dev)
        out_vis += cc * vis.index_select(-1, idx)
        out_var += cc**2 * var.index_select(-1, idx)
        out_ok &= flagged.index_select(-1, idx)
    alive = out_ok & ~torch.as_tensor(dead, device=dev)
    out_weight = invert_no_zero(out_var) * alive
    return out_vis, out_weight.to(torch.float32)


class _StencilRegridder(SiderealRegridder):
    """Base for the fixed-stencil (nearest/linear/cubic) regridders."""

    #: max tap distance from the target, in median input spacings
    reach = 1.0

    def _stencil(self, x, grid):
        """Return (taps [T, ngrid], coeffs [T, ngrid], invalid [ngrid])."""
        raise NotImplementedError()

    def _regrid(self, vis, weight, lsd):
        grid = np.linspace(self.start, self.end, self.samples, endpoint=False)
        taps, coeffs, invalid = self._stencil(np.asarray(lsd), grid)
        out_vis, out_weight = _apply_stencil(vis, weight, lsd, grid, taps, coeffs, invalid, self.reach)
        return grid, out_vis, out_weight


class SiderealRegridderNearest(_StencilRegridder):
    """Nearest-neighbour regridding (reference sidereal.py:362)."""

    def _stencil(self, x, grid):
        pick = _search_nearest(x, grid)
        return pick[None], np.ones((1, grid.size)), np.zeros(grid.size, bool)


class SiderealRegridderLinear(_StencilRegridder):
    """Linear-interpolation regridding (reference sidereal.py:386)."""

    def _stencil(self, x, grid):
        hi = np.searchsorted(x, grid)
        invalid = (hi == 0) | (hi == x.size)
        hi = np.clip(hi, 1, x.size - 1)
        lo = hi - 1
        span = invert_no_zero(x[hi] - x[lo])
        return (
            np.stack([lo, hi]),
            np.stack([(x[hi] - grid) * span, (grid - x[lo]) * span]),
            invalid,
        )


class SiderealRegridderCubic(_StencilRegridder):
    """Cubic Hermite (Catmull-Rom) spline regridding (reference :464)."""

    reach = 2.0

    def _stencil(self, x, grid):
        taps = np.searchsorted(x, grid)[None] + np.arange(-2, 2)[:, None]
        invalid = ((taps < 0) | (taps >= x.size)).any(axis=0)
        taps = np.clip(taps, 0, x.size - 1)
        u = (grid - x[taps[1]]) * invert_no_zero(x[taps[2]] - x[taps[1]])
        # Catmull-Rom basis at spline parameter u
        coeffs = 0.5 * np.stack(
            [
                u * ((2 - u) * u - 1),
                u * u * (3 * u - 5) + 2,
                u * ((4 - 3 * u) * u + 1),
                u * u * (u - 1),
            ]
        )
        return taps, coeffs, invalid


class SiderealRegridderGP(SiderealRegridder):
    """Regrid with Gaussian-process regression (reference sidereal.py:281).

    Uses a Matern-5/2 kernel; the per-frequency masked solves run as one
    batched solve on the data's device (see
    :mod:`draco_tpu_torch.ops.gaussian_process`).

    Attributes
    ----------
    mask_cutoff : float
        Max distance (input samples) from the nth nearest valid input to
        keep an output sample.  Default 1.7.
    mask_cutoff_partition : int
        Which nearest sample (0-indexed) the cutoff applies to.
    """

    mask_cutoff = config.float_prop(1.7)
    mask_cutoff_partition = config.int_prop(1)

    def _regrid(self, vis, weight, times):
        from ..ops import gaussian_process
        from ..ops.delay import _inv_move_front, _move_front

        pad = 5 * self.kernel_width
        grid = np.arange(-pad, self.samples + pad, dtype=np.float64) / self.samples

        times = times - self.start

        vx = _move_front(vis, (0, vis.ndim - 1), vis.shape)
        wx = _move_front(weight, (0, weight.ndim - 1), weight.shape)
        # [nfreq * ntime, rest] -> [nfreq, ntime, rest]
        vx = vx.reshape(vis.shape[0], vis.shape[-1], -1)
        wx = wx.reshape(weight.shape[0], weight.shape[-1], -1)

        kernel_spec = dict(name="matern", width=self.kernel_width, alpha=1.0, nu=2.5, epsilon=self.epsilon)

        vout, wout = gaussian_process.resample(
            vx,
            wx,
            xi=times,
            xo=grid,
            cutoff_dist=self.mask_cutoff,
            cutoff_partition=self.mask_cutoff_partition,
            kernel_spec=kernel_spec,
        )

        grid = grid[pad:-pad].copy()
        vout = vout[:, pad:-pad].reshape(vis.shape[0], -1)
        wout = wout[:, pad:-pad].reshape(weight.shape[0], -1)
        vout = _inv_move_front(vout, (0, vis.ndim - 1), (*vis.shape[:-1], self.samples))
        wout = _inv_move_front(wout, (0, weight.ndim - 1), (*weight.shape[:-1], self.samples))

        return grid * (self.end - self.start) + self.start, vout, wout


class SiderealRebinner(SiderealRegridder):
    """Rebin a sidereal day by fractional bin assignment.

    (reference sidereal.py:550-731): tracks the weighted effective RA bin
    centre for the downstream gradient correction.  Each product with the
    rebinning matrix runs on the data's device in float64 (complex128 for
    the visibilities, as two real products), a block of the leading axis at
    a time; the outputs round to the datasets' types.
    """

    weight = config.enum(["uniform", "inverse_variance"], default="inverse_variance")

    # output container per input type, most specific first
    _output_types = (
        (containers.HybridVisStream, containers.HybridVisStream),
        (containers.TimeStream, containers.SiderealStream),
        (containers.SiderealStream, containers.SiderealStream),
    )

    def process(self, data):
        self.log.info(f"Rebin of LSD {data.attrs['lsd']:.0f} ({self.weight} weights).")
        for in_type, out_type in self._output_types:
            if isinstance(data, in_type):
                break
        else:
            raise TypeError(f"No valid container mapping for {data.__class__}.")

        data.redistribute("freq")
        self.start = float(data.attrs["lsd"])
        self.end = self.start + 1

        if "ra" in data.index_map:
            timestamp_lsd = self.start + data.ra / 360.0
        else:
            timestamp_lsd = self.observer.unix_to_lsd(data.time)

        sdata = out_type(ra=self.samples, axes_from=data, attrs_from=data)
        sdata.add_dataset("effective_ra")
        sdata.add_dataset("nsample")

        weight = data.weight[:]
        vis_data = data.vis[:]
        dev = vis_data.device
        # the weight dataset may have fewer axes than vis (e.g.
        # HybridVisStream's vis_weight has no 'el'): align by NAME so
        # broadcasting never pairs unrelated axes
        vax = list(data.vis.axes)
        wax = list(data.weight.axes)
        to_vis = tuple(slice(None) if ax in wax else None for ax in vax)
        blockable = to_vis[0] == slice(None)

        width_t = np.median(np.abs(np.diff(timestamp_lsd)))
        target_lsd = np.linspace(self.start, self.end, self.samples, endpoint=False)
        R = regrid.rebin_matrix(timestamp_lsd, target_lsd, width_t=width_t)
        Rt = torch.as_tensor(np.ascontiguousarray(R.T), device=dev)  # [ntime, nra] float64
        Rtsq = Rt**2
        # time stamps relative to the day: float64 holds them exactly enough either way
        t_rel = torch.as_tensor(timestamp_lsd - self.start, device=dev)

        def cmatmul(x, M):
            return torch.complex(x.real @ M, x.imag @ M) if x.is_complex() else x @ M

        # auxiliary datasets rebin after the blocks; those weighted like the
        # data need the whole norm and weight, and then there is one block
        handled = {data.vis.name, data.weight.name, "vis", "weight", "vis_weight", "nsample", "effective_ra"}
        extra = [n for n in data.datasets if n not in handled and n in sdata.dataset_spec()]
        weighted = [
            n for n in extra
            if {"ra", "time"} & set(data.datasets[n].axes)
            and ("freq_cov" in n or set(wax) <= set(data.datasets[n].axes))
        ]
        blocks = (
            list(tools.axis_blocks(weight.shape[0], weight[0].numel(), BLOCK_ELEMENTS))
            if blockable and not weighted
            else [(0, weight.shape[0])]
        )
        for b0, b1 in blocks:
            sl = slice(b0, b1)
            wb = weight[sl].to(torch.float64)
            vb = vis_data[sl]
            m = (wb > 0.0).to(torch.float64)
            if self.weight == "uniform":
                v = invert_no_zero(wb)
                w = m
            else:
                v = wb
                w = wb
            norm = invert_no_zero(w @ Rt)
            vdt = torch.complex128 if vb.is_complex() else torch.float64
            ssv = norm[to_vis] * cmatmul(vb.to(vdt) * w[to_vis], Rt)
            ssn = m @ Rt
            sera = 360 * (norm * ((t_rel * w) @ Rt))
            rvar = v @ Rtsq
            ssw = invert_no_zero(norm**2 * rvar)
            # effective RA falls back to the grid where the weights are zero (no discontinuities)
            grid_ra = torch.as_tensor(sdata.ra, device=dev).expand_as(sera)
            sera = torch.where(ssw == 0.0, grid_ra, sera)
            sdata.vis[sl] = ssv
            sdata.weight[sl] = ssw
            sdata.datasets["nsample"][sl] = ssn
            sdata.datasets["effective_ra"][sl] = sera
            del ssv, vb

        # Carry every auxiliary dataset through the rebin (reference
        # sidereal.py:624-666): weighted mean with the same norm;
        # freq_cov quadratically (one weight/norm factor per freq axis).
        for name in extra:
            ds = data.datasets[name]
            arr = ds[:]
            if name not in sdata.datasets:
                sdata.add_dataset(name)
            axes_d = list(ds.axes)
            if "ra" not in axes_d and "time" not in axes_d:
                sdata.datasets[name][:] = arr
                continue
            adt = torch.complex128 if arr.is_complex() else torch.float64
            if "freq_cov" in name:
                # axes [pol, freq, freq_sum, ew, ra]: each freq axis
                # carries its own weight and normalisation factor
                new = norm[:, :, None] * norm[:, None] * cmatmul(arr.to(adt) * w[:, :, None] * w[:, None], Rtsq)
            elif set(wax) <= set(axes_d):
                to_d = tuple(slice(None) if ax in wax else None for ax in axes_d)
                new = norm[to_d] * cmatmul(arr.to(adt) * w[to_d], Rt)
            else:
                # no compatible weight: plain (mask-free) mean rebin
                uni = invert_no_zero(torch.ones(arr.shape[-1], dtype=torch.float64, device=dev) @ Rt)
                new = uni * cmatmul(arr.to(adt), Rt)
            sdata.datasets[name][:] = new
        sdata.attrs.update(lsd=self.start, tag=f"lsd_{self.start:.0f}")
        return sdata


class RebinGradientCorrection(ContainerTask):
    """Shift rebinned samples to bin centres using a local gradient.

    (reference sidereal.py:734-831).  Every row's gradient comes from
    :func:`~draco_tpu_torch.ops.regrid.grad_1d_rows` on the data's device,
    a block of rows at a time (the JAX package loops over the rows on the
    host).
    """

    def setup(self, sstream_ref: containers.SiderealStream):
        self.sstream_ref = sstream_ref

    def process(self, sstream: containers.SiderealStream):
        self.sstream_ref.redistribute("freq")
        sstream.redistribute("freq")

        if "effective_ra" not in sstream.datasets:
            self.log.info(
                f"Dataset of type ({type(sstream)}) has no effective_ra dataset. No correction will be applied."
            )
            return sstream
        era = sstream.datasets["effective_ra"][:]
        dev = era.device

        if "effective_ra" in self.sstream_ref.datasets:
            ref_ra = self.sstream_ref.datasets["effective_ra"][:].to(dev)
        else:
            ref_ra = torch.as_tensor(self.sstream_ref.ra, device=dev)

        vis = sstream.vis[:]
        weight = sstream.weight[:]
        ref_vis = self.sstream_ref.vis[:].to(dev)
        ref_weight = self.sstream_ref.weight[:].to(dev)
        grid_ra = torch.as_tensor(sstream.ra, device=dev)

        # flatten every leading axis into rows; the data's tensors update in place
        nra = vis.shape[-1]
        rows = (x.reshape(-1, nra) for x in (vis, weight, era, ref_vis, ref_weight))
        v_all, w_all, e_all, rv_all, rw_all = rows
        rra_all = ref_ra.reshape(-1, nra) if ref_ra.ndim > 1 else ref_ra
        for r0, r1 in tools.axis_blocks(v_all.shape[0], 4 * nra, BLOCK_ELEMENTS):
            rra = rra_all[r0:r1] if rra_all.ndim > 1 else rra_all
            grad, bad = regrid.grad_1d_rows(
                rv_all[r0:r1].to(torch.complex128 if vis.is_complex() else torch.float64),
                rra.to(torch.float64),
                rw_all[r0:r1] == 0.0,
                period=360.0,
            )
            w = w_all[r0:r1]
            shift = grad * (w > 0.0) * (e_all[r0:r1].to(torch.float64) - grid_ra)
            v_all[r0:r1] = v_all[r0:r1] - shift
            w *= ~bad

        del sstream["effective_ra"]
        return sstream


class SiderealStacker(ContainerTask):
    """Streaming mean/variance stack of sidereal days.

    (reference sidereal.py:834-1079): West (1979) running update; optional
    sample-variance dataset with Bessel correction.  The running state lives
    on the data's device in the stack container's own ``vis``, ``weight``
    and ``sample_variance`` datasets, with the sample count and the sum of
    squared coefficients in float32 beside them; each day updates them in
    place (:func:`_stack_update`), a frequency block at a time, where the
    JAX package donates the buffers to a jitted update.
    """

    tag = config.str_prop("stack")
    weight = config.enum(["uniform", "inverse_variance"], default="inverse_variance")
    with_sample_variance = config.bool_prop(False)

    stack = None

    def _begin(self, sdata):
        """Zero-filled stack container + broadcast slices, from day one."""
        self.stack = empty_like(sdata)
        stack_ds = self.stack.datasets
        if "nsample" not in stack_ds:
            self.stack.add_dataset("nsample")
        if self.with_sample_variance and "sample_variance" not in stack_ds:
            self.stack.add_dataset("sample_variance")

        wax = sdata.weight.axes
        self.weight_slice = {"vis": get_slice_to_broadcast(wax, sdata.vis.axes)}
        # datasets beyond the container defaults ride along; frequency
        # covariances accumulate QUADRATICALLY — one coefficient per freq
        # axis (reference sidereal.py:922-926,1052-1058), finished with a
        # (norm_i * norm_j)^-1 normalisation in process_finish
        self.additional_datasets = [name for name in sdata.datasets if name not in stack_ds]
        for name in self.additional_datasets:
            self.log.info(f"Creating {name} dataset in the stack.")
            self.stack.add_dataset(name)
            slc = get_slice_to_broadcast(wax, sdata.datasets[name].axes)
            if "freq_cov" in name:
                slc = (slc, get_slice_to_broadcast(wax, sdata.swapped_freq_cov_axis))
            self.weight_slice[name] = slc

        # empty_like and add_dataset make every dataset zero
        self.lsd_list = []
        dev = self.stack.weight[:].device
        self.nsample = torch.zeros(self.stack.weight.shape, dtype=torch.float32, device=dev)
        self.sum_coeff_sq = torch.zeros(self.stack.weight.shape, dtype=torch.float32, device=dev)

    def process(self, sdata):
        if self.stack is None:
            self._begin(sdata)
        elif not isinstance(sdata, type(self.stack)):
            raise TypeError(
                f"Stacker input {type(sdata)} differs from the existing stack type {type(self.stack)}."
            )

        input_lsd = _ensure_list(sdata.attrs.get("lsd", sdata.attrs.get("csd", -1)))
        self.log.info(f"Folding LSD {input_lsd} into the stack ({self.weight} weights).")
        self.lsd_list += input_lsd

        weight = sdata.weight[:].to(torch.float32)
        if "nsample" in sdata.datasets:
            count = sdata.nsample[:].to(torch.float32) * (weight > 0.0)
        else:
            count = (weight > 0.0).to(torch.float32)

        st = self.stack
        wslc = self.weight_slice["vis"]
        sv = st.sample_variance[:] if self.with_sample_variance else None
        keep = bool(self.additional_datasets)
        coeff = torch.empty_like(weight) if keep else None
        inv = torch.empty_like(weight) if keep else None
        # blocks of the leading axis where the weight shares it with the data
        blocks = _lead_blocks(weight) if wslc[0] == slice(None) else [(0, weight.shape[0])]
        for b0, b1 in blocks:
            sl = slice(b0, b1)
            c, i = _stack_update(
                st.vis[sl], st.weight[sl], self.nsample[sl], self.sum_coeff_sq[sl],
                None if sv is None else sv[:, sl],
                sdata.vis[sl], weight[sl], count[sl], wslc, uniform=(self.weight == "uniform"),
            )
            if keep:
                coeff[sl], inv[sl] = c, i

        for name in self.additional_datasets:
            ws = self.weight_slice[name]
            stn = st[name][:]
            new = sdata[name][:]
            if "freq_cov" in name:
                stn += coeff[ws[0]] * coeff[ws[1]] * new
            else:
                stn += coeff[ws] * (new - stn) * inv[ws]

    def process_finish(self):
        st = self.stack
        st.attrs["tag"] = self.tag
        st.attrs["lsd"] = np.array(self.lsd_list)
        st.nsample[:] = self.nsample

        st_weight = st.weight[:]
        if self.weight == "uniform":
            norm = self.nsample
            st_weight.copy_(invert_no_zero(st_weight) * norm**2)
        else:
            norm = st_weight

        if self.with_sample_variance:
            norm_b = norm - self.sum_coeff_sq * invert_no_zero(norm)
            wslc = (None, *self.weight_slice["vis"])
            scale = torch.where(self.nsample > 1, invert_no_zero(norm_b), torch.zeros_like(norm_b))
            st.sample_variance[:] *= scale[wslc]

        # finish the quadratic covariance accumulation
        for name in getattr(self, "additional_datasets", []):
            if "freq_cov" in name:
                ws = self.weight_slice[name]
                st[name][:] *= invert_no_zero(norm[ws[0]] * norm[ws[1]])

        # for samples with no data, effective ra falls back to the grid ra
        if "effective_ra" in st.datasets:
            era = st.datasets["effective_ra"][:]
            grid_ra = torch.as_tensor(st.ra, device=era.device).to(era.dtype).expand_as(era)
            era.copy_(torch.where(st.weight[:] == 0.0, grid_ra, era))

        self.nsample = self.sum_coeff_sq = None
        return st


def _stack_update(st_vis, st_weight, st_nsample, scs, sv, vis, weight, count, wslc, uniform: bool):
    """One day of the West (1979) update of :class:`SiderealStacker`, in place.

    The running (vis, weight, nsample, sum-coeff-sq, sample-variance) state
    is updated where it lies (the JAX package's ``_build_stack_update``
    donates it to a jitted program); ``sv`` is None without sample
    variance.  Returns the day's (coeff, 1 / sum_coeff).
    """
    st_nsample += count
    if uniform:
        coeff = count
        st_weight += coeff**2 * invert_no_zero(weight)
        sum_coeff = st_nsample
    else:
        coeff = weight
        st_weight += weight
        sum_coeff = st_weight
    inv = invert_no_zero(sum_coeff)
    delta_before = coeff[wslc] * (vis - st_vis)
    st_vis += delta_before * inv[wslc]
    scs += coeff**2
    if sv is not None:
        delta_after = vis - st_vis
        sv[0] += delta_before.real * delta_after.real
        sv[1] += delta_before.real * delta_after.imag
        sv[2] += delta_before.imag * delta_after.imag
    return coeff, inv


def _match_stack_update(st_vis, st_weight, d, weight):
    """One day of Wiener-matched stacking, in place on the state's device.

    Returns the day's (Ni_d [freq, ra], v [freq, ra]).
    """
    Ni_d = weight.mean(dim=1)  # [freq, ra]
    tr_Ni = Ni_d.sum(dim=1)
    v = Ni_d * invert_no_zero(tr_Ni[:, None]) ** 0.5
    st_vis += d * Ni_d[:, None, :] - v[:, None, :] * torch.matmul(d, v[:, :, None].to(d.dtype))
    st_weight += invert_no_zero(weight) * Ni_d[:, None, :] ** 2
    return Ni_d, v


def _match_stack_finish(st_vis, st_weight, Ni_s64, Va64):
    """Crosstalk-marginalised deconvolution, batched over frequency, in place.

    ``M = I - V^T Ni V`` is structurally singular (the undetermined per-day
    mean mode); its pinv MUST truncate that mode.  In float32 the mode's
    singular value is roundoff at ~1e-7 sigma_max, above an rcond of 1e-8,
    so the pinv runs on the host in float64 (M is [nfreq, nday, nday]);
    only the large vis/weight correction applies on the state's device, in
    float32, a frequency block at a time.
    """
    nday = Va64.shape[-1]
    N_s64 = invert_no_zero(Ni_s64)  # [f, ra]
    V64 = Va64 * N_s64[:, :, None]  # [f, ra, nday]
    M = np.eye(nday)[None] - np.einsum("frd,fr,fre->fde", V64, Ni_s64, V64)
    A64 = np.linalg.pinv(M, rcond=1e-8)

    dev = st_vis.device
    rdt = st_weight.dtype
    Ni_s = torch.as_tensor(Ni_s64, device=dev).to(rdt)
    N_s = torch.as_tensor(N_s64, device=dev).to(rdt)
    V = torch.as_tensor(V64, device=dev).to(rdt).to(st_vis.dtype)
    A = torch.as_tensor(A64, device=dev).to(rdt).to(st_vis.dtype)
    for f0, f1 in _lead_blocks(st_weight):
        sv = st_vis[f0:f1]
        X = torch.einsum("fsr,frd->fsd", sv, V[f0:f1])
        Y = torch.einsum("fde,fse->fds", A[f0:f1], X)
        sv.copy_(sv * N_s[f0:f1, None, :] + torch.einsum("frd,fds->fsr", V[f0:f1], Y))
        sw = st_weight[f0:f1]
        sw.copy_(invert_no_zero(sw) * (Ni_s[f0:f1] ** 2)[:, None, :])


def _median_last(x: torch.Tensor) -> torch.Tensor:
    """``np.median`` along the last axis: the mean of the two middle values
    of an even count (``torch.median`` takes the lower one)."""
    srt = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    if n % 2:
        return srt[..., n // 2]
    return (srt[..., n // 2 - 1] + srt[..., n // 2]) / 2


class SiderealStackerMatch(ContainerTask):
    """Wiener-matched stacking marginalising per-day crosstalk.

    (reference sidereal.py:1082-1250): each day's unknown time-mean is
    treated as extra noise; the final deconvolution fixes the undetermined
    mean mode by zeroing the 24h median.  The running state is the stack
    container's ``vis`` and ``weight`` on the data's device, updated in
    place each day (:func:`_match_stack_update`); the per-day mode vectors
    come back to the host in float64 for the final deconvolution.
    """

    tag = config.str_prop("stack")

    stack = None
    lsd_list = None
    count = 0

    def _begin(self, sdata):
        """Fresh zeroed stack plus the per-day mode bookkeeping."""
        self.log.info("Starting new stack.")
        self.stack = empty_like(sdata)  # every dataset zero
        nfreq, _, nra = sdata.weight.shape
        self.Ni_s = np.zeros((nfreq, nra), dtype=np.float64)
        self.Vm = []
        self.lsd_list = []
        self.count = 0

    def process(self, sdata):
        if self.stack is None:
            self._begin(sdata)
        elif not isinstance(sdata, type(self.stack)):
            raise TypeError(
                f"Stacker input {type(sdata)} differs from the existing stack type {type(self.stack)}."
            )

        label = sdata.attrs.get("tag", f"stream_{self.count}")
        self.log.info(f"Adding {label} to stack.")

        Ni_d, v = _match_stack_update(
            self.stack.vis[:], self.stack.weight[:], sdata.vis[:], sdata.weight[:].to(torch.float32)
        )
        Ni_d64 = Ni_d.cpu().numpy().astype(np.float64)
        self.Ni_s += Ni_d64
        self.Vm.append(v.cpu().numpy().astype(np.float64))

        # Track effective RA bin centres through the stack (reference
        # sidereal.py:1168-1177, with the broadcasting written out), in
        # float64 on the data's device; the running weight sum is kept
        # beside the stack so the per-day update never reads the state
        if "effective_ra" in sdata.datasets:
            dev = sdata.weight[:].device
            w_day = sdata.weight[:].to(torch.float64)
            Ni_dt = torch.as_tensor(Ni_d64, device=dev)
            if "effective_ra" not in self.stack.datasets:
                self.stack.add_dataset("effective_ra")
                self.stack.datasets["effective_ra"][:] = 0.0
                self._wsum = torch.zeros(w_day.shape, dtype=torch.float64, device=dev)
            self._wsum += invert_no_zero(w_day) * Ni_dt[:, None, :] ** 2
            era_ds = self.stack.datasets["effective_ra"]
            era = era_ds[:].to(torch.float64)
            delta = Ni_dt[:, None, :] * (sdata.datasets["effective_ra"][:].to(torch.float64) - era)
            sum_weight = invert_no_zero(self._wsum) * torch.as_tensor(self.Ni_s, device=dev)[:, None, :] ** 2
            era += delta * invert_no_zero(sum_weight.mean(dim=1))[:, None, :]
            era_ds[:] = era

        self.lsd_list.extend(_ensure_list(sdata.attrs.get("lsd", sdata.attrs.get("csd", -1))))
        self.count += 1

    def process_finish(self):
        self.stack.attrs["tag"] = self.tag
        Va = np.array(self.Vm).transpose(1, 2, 0)  # [freq, ra, nday]

        # batched deconvolution over all frequencies at once (the reference
        # runs a per-frequency host pinv loop)
        sv = self.stack.vis[:]
        _match_stack_finish(sv, self.stack.weight[:], self.Ni_s, Va)
        for f0, f1 in _lead_blocks(sv):
            blk = sv[f0:f1]
            median = torch.complex(_median_last(blk.real), _median_last(blk.imag))
            blk -= median[:, :, None]
        self.stack.attrs["lsd"] = np.array(self.lsd_list)
        return self.stack
