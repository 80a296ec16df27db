"""Transforms of the main path: m-modes, RA/frequency reshaping, regridding.

Port of ``draco_tpu.analysis.transform`` up to the regridders and the
product collation: reference ``draco/analysis/transform.py``
(TelescopeStreamMixIn:91, CollateProducts:142, FrequencyRebin:20,
SelectFreq:333, MModeTransform:535, MModeInverseTransform:708,
SiderealMModeResample:795, ShiftRA:993, Regridder:854), the Stokes I
extraction (StokesIVis:1333, stokes_I:1382) and the weighted reductions
(ReduceBase:1904, ReduceVar:2065, ReduceChisq:2092,
ReduceChisqInverseRedundancy:2120).  Every task works on its container's
device.

Two plain functions carry the math of the slice:

* :func:`regrid_sidereal`, the maximum-likelihood inverse of a Lanczos
  interpolation onto a regular grid (``LanczosRegridder._regrid``,
  reference transform.py:854-986), whose banded covariance is the
  hand-written CUDA kernel on the card;
* :func:`mmode_weights`, the m-mode noise weights of ``MModeTransform``
  (reference transform.py:599-602).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.task import ContainerTask, group_tasks
from ..ops import mmode
from ..ops import regrid as regrid_ops
from ..ops import tools
from ..ops.tools import invert_no_zero

__all__ = [
    "regrid_sidereal",
    "mmode_weights",
    "FrequencyRebin",
    "SelectFreq",
    "MModeTransform",
    "MModeInverseTransform",
    "SiderealMModeResample",
    "ShiftRA",
    "LanczosRegridder",
    "Regridder",
    "TelescopeStreamMixIn",
    "CollateProducts",
    "StokesIVis",
    "stokes_I",
    "ReduceBase",
    "ReduceVar",
    "ReduceChisq",
    "ReduceChisqInverseRedundancy",
]


def regrid_sidereal(
    vis: torch.Tensor,
    weight: torch.Tensor,
    times: np.ndarray,
    samples: int,
    start: float,
    end: float,
    kernel_width: int = 5,
    epsilon: float = 1e-3,
):
    """Regrid irregularly sampled data onto ``samples`` regular points.

    vis [..., ntime] (real or complex) and its inverse-noise weight [...,
    ntime] at host sample times ``times`` [ntime]; the output grid spans
    ``[start, end)``.  The Wiener solve runs on ``vis.device`` in the real
    dtype of ``vis``.

    Returns ``(grid [samples] numpy, vis_out [..., samples], ni [...,
    samples])`` where ``ni`` is the inverse-noise weight of each output
    sample.
    """
    times = np.asarray(times, dtype=np.float64)
    if start < times[0] or end > times[-1]:
        raise ValueError("start or end of the regrid falls outside the sample times")
    # padded output grid, trimmed after the solve to drop the edge wrap
    pad = 5 * kernel_width
    span = end - start
    ticks = np.arange(-pad, samples + pad, dtype=np.float64)
    grid = start + span * ticks / samples

    rdt = vis.real.dtype
    projector = regrid_ops.lanczos_forward_matrix(grid, times, kernel_width).T
    R = torch.as_tensor(np.ascontiguousarray(projector), dtype=rdt).to(vis.device)
    Si = torch.full((grid.size,), epsilon, dtype=rdt, device=vis.device)

    ntime = vis.shape[-1]
    solved, ni = regrid_ops.band_wiener(
        R,
        weight.reshape(-1, ntime).to(rdt).contiguous(),
        Si,
        vis.reshape(-1, ntime),
        2 * kernel_width - 1,
    )
    out_shape = (*vis.shape[:-1], samples)
    solved = solved[:, pad:-pad].reshape(out_shape)
    ni = ni[:, pad:-pad].reshape(out_shape)
    return grid[pad:-pad].copy(), solved, ni


def mmode_weights(ni: torch.Tensor, mmax: int) -> torch.Tensor:
    """m-mode noise weights from sidereal inverse-noise weights.

    ni [..., nra] -> [mmax+1, 2, ...]: the inverse of the summed
    per-sample variances times nra^2, the same for every (m, msign).
    """
    nra = ni.shape[-1]
    var_sum = invert_no_zero(ni).sum(dim=-1)
    weight_sum = nra**2 * invert_no_zero(var_sum)
    return weight_sum.expand(mmax + 1, 2, *weight_sum.shape).contiguous()


def _window(m: int, nra: int, like: torch.Tensor) -> torch.Tensor:
    """sinc(m / nra) of the rectangular RA integration window, [m, 1, ...]
    broadcasting against an [m, ...] tensor like ``like``."""
    w = torch.as_tensor(np.sinc(np.arange(m) / nra), dtype=like.real.dtype, device=like.device)
    return w.reshape((m,) + (1,) * (like.ndim - 1))


class FrequencyRebin(ContainerTask):
    """Rebin neighbouring frequency channels (reference transform.py:20).

    Attributes
    ----------
    channel_bin : int
        Number of channels to merge.
    """

    channel_bin = config.int_prop(1)

    def process(self, ss):
        if "freq" not in ss.index_map:
            raise RuntimeError("A freq axis is required for rebinning.")
        cb = self.channel_bin
        if len(ss.freq) % cb != 0:
            raise RuntimeError("The channel count is not a multiple of the bin size.")

        freq_map = ss.index_map["freq"]
        centre = freq_map["centre"].reshape(-1, cb).mean(axis=-1)
        width = freq_map["width"].reshape(-1, cb).sum(axis=-1)
        new_freq = np.zeros(len(centre), dtype=freq_map.dtype)
        new_freq["centre"] = centre
        new_freq["width"] = width

        sb = ss.__class__(freq=new_freq, axes_from=ss, attrs_from=ss)

        for name, ds in ss.datasets.items():
            if name not in sb.dataset_spec():
                continue
            if name not in sb.datasets:
                sb.add_dataset(name)
            if "freq" not in ds.axes:
                sb.datasets[name][:] = ds[:]
                continue
            fax = list(ds.axes).index("freq")
            arr = ds[:].movedim(fax, 0)
            shape = (len(centre), cb) + tuple(arr.shape[1:])
            if name.endswith("weight") or name == "weight":
                # inverse-variance weights combine as a sum
                new = arr.reshape(shape).sum(dim=1)
            elif name == "vis" and "vis" in ss.datasets:
                # weighted average with the weight dataset
                w = ss.weight[:].movedim(fax, 0)
                num = (arr * w).reshape(shape).sum(dim=1)
                den = w.reshape(shape).sum(dim=1)
                new = num * invert_no_zero(den)
            else:
                new = arr.reshape(shape).mean(dim=1)
            sb.datasets[name][:] = new.movedim(0, fax)
        return sb


class SelectFreq(ContainerTask):
    """Select a subset of frequencies (reference transform.py:333).

    Attributes
    ----------
    freq_physical : list
        Physical frequencies (MHz) to select.
    channel_range : list
        [start, stop, (step)] channel range.
    channel_index : list
        Explicit channel indices.
    freq_physical_range : list
        [low, high] physical frequency bounds.
    """

    freq_physical = config.list_prop([])
    channel_range = config.list_prop([])
    channel_index = config.list_prop([])
    freq_physical_range = config.list_prop([])

    def _chosen_channels(self, freq):
        """Resolve the configured selection to an index/slice."""
        if self.freq_physical:
            return sorted({np.argmin(np.abs(freq - fp)) for fp in self.freq_physical})
        if self.channel_range and (len(self.channel_range) <= 3):
            return slice(*self.channel_range)
        if self.channel_index:
            return self.channel_index
        if self.freq_physical_range:
            low, high = sorted(self.freq_physical_range)
            return np.where((freq >= low) & (freq < high))[0]
        raise ValueError(
            "Must specify one of freq_physical, channel_range, channel_index or freq_physical_range."
        )

    def process(self, data):
        freq_map = data.index_map["freq"]
        freq = freq_map["centre"] if freq_map.dtype.names else freq_map

        fsel = np.arange(len(freq))[self._chosen_channels(freq)]
        newdata = data.__class__(freq=freq_map[fsel], axes_from=data, attrs_from=data)
        # also carries freq-independent datasets across unchanged
        containers.copy_datasets_filter(data, newdata, selection={"freq": fsel})
        return newdata


class MModeTransform(ContainerTask):
    """Transform a sidereal stream to m-modes (reference transform.py:535).

    One batched FFT over RA and the +/-m packing
    (:func:`draco_tpu_torch.ops.mmode.make_marray`), on the stream's device.

    Attributes
    ----------
    remove_integration_window : bool
        Deconvolve the finite-width rectangular RA integration window.
    """

    remove_integration_window = config.bool_prop(False)
    # accepted for reference-config compatibility (transform.py:555): the
    # transform is always torch's batched FFT
    use_fftw = config.bool_prop(True)

    def setup(self, manager=None):
        """Optionally set the telescope to define mmax."""
        self.telescope = io.get_telescope(manager) if manager is not None else None

    def process(self, sstream) -> containers.MContainer:
        contmap = {
            containers.SiderealStream: containers.MModes,
            containers.HybridVisStream: containers.HybridVisMModes,
        }
        out_cont = None
        for cls in type(sstream).__mro__:
            if cls in contmap:
                out_cont = contmap[cls]
                break
        if out_cont is None:
            raise TypeError(f"No m-mode container for {type(sstream)}")

        sstream.redistribute("freq")
        svis = sstream.vis[:]
        sweight = sstream.weight[:]
        nra = sweight.shape[-1]
        mmax = svis.shape[-1] // 2 if self.telescope is None else self.telescope.mmax

        ma = out_cont(mmax=mmax, oddra=bool(nra % 2), axes_from=sstream, attrs_from=sstream)
        mvis = mmode.make_marray(svis, mmax=mmax)
        # noise variance of the m-modes: the sum of the per-sample
        # variances (reference transform.py:599-602), for every (m, msign)
        mw = mmode_weights(sweight, mmax)
        if self.remove_integration_window:
            w_win = _window(mmax + 1, nra, mvis)
            mvis = mvis * invert_no_zero(w_win)
            mw = mw * w_win**2
        ma.vis[:] = mvis
        ma.weight[:] = mw
        return ma


class MModeInverseTransform(ContainerTask):
    """Transform m-modes back to a sidereal stream (reference transform.py:708).

    Attributes
    ----------
    nra : int
        Number of output RA bins (default: Nyquist for the stored mmax).
    apply_integration_window : bool
        Re-apply the rectangular integration window.
    """

    nra = config.int_prop(None)
    apply_integration_window = config.bool_prop(False)

    def process(self, mmodes: containers.MContainer):
        mmodes.redistribute("freq")
        nra = self.nra
        if nra is None:
            # critically-sampled RA count for the stored mmax
            nra = 2 * mmodes.mmax + int(bool(mmodes.oddra))

        mvis = mmodes.vis[:]
        mweight = mmodes.weight[:]
        if self.apply_integration_window:
            w = _window(mvis.shape[0], nra, mvis)
            mvis = mvis * w
            mweight = mweight * invert_no_zero(w) ** 2
        ssarray = mmode.mmodes_to_sidereal(mvis, n=nra, oddra=bool(mmodes.oddra))

        sstream = containers.SiderealStream(
            ra=ssarray.shape[-1], axes_from=mmodes, attrs_from=mmodes, distributed=True
        )
        sstream.vis[:] = ssarray
        # no time information is recoverable: spread the m = 0 weight over
        # RA (reference transform.py:788-790)
        sstream.weight[:] = (mweight[0, 0] / sstream.vis.shape[-1])[..., None]
        return sstream


class SiderealMModeResample(group_tasks(MModeTransform, MModeInverseTransform)):
    """Resample a sidereal stream by forward+inverse m-mode transform.

    (reference transform.py:795)
    """


class ShiftRA(ContainerTask):
    """Add an offset to the RA axis (reference transform.py:993).

    Attributes
    ----------
    delta : float
        Shift in degrees.
    periodic : bool
        Wrap and roll so the axis stays in [0, 360).
    """

    delta = config.float_prop(0.0)
    periodic = config.bool_prop(False)

    def process(self, sscont: containers.SiderealContainer):
        if not isinstance(sscont, containers.SiderealContainer):
            raise TypeError(f"Expected SiderealContainer, got {type(sscont)}")
        ra = sscont.index_map["ra"] + self.delta
        if self.periodic:
            shift = int(np.argmin(ra % 360.0))
            ra = np.roll(ra % 360.0, -shift)
            for ds in sscont.datasets.values():
                if "ra" in ds.axes:
                    ax = list(ds.axes).index("ra")
                    data = ds[:]
                    ds[:] = torch.roll(data, -shift, dims=ax) if isinstance(data, torch.Tensor) else np.roll(
                        data, -shift, axis=ax
                    )
        sscont.create_index_map("ra", ra)
        return sscont


class LanczosRegridder(ContainerTask):
    """Interpolate the time-like axis onto a regular grid.

    Maximum-likelihood inverse of a Lanczos interpolation via the banded
    Wiener filter (reference transform.py:854-986): :func:`regrid_sidereal`
    on the data's device, whose banded covariance is the hand-written CUDA
    kernel on the card.

    Attributes
    ----------
    samples : int
        Number of output samples.
    start, end : float
        Range of the output grid (defaults to the data bounds).
    kernel_width : int
        Lanczos kernel width.
    epsilon : float
        Regulariser (inverse signal variance).
    mask_zero_weight : bool
        Zero output weights where the input weights were all zero.
    """

    samples = config.int_prop(1024)
    start = config.float_prop(None)
    end = config.float_prop(None)
    kernel_width = config.int_prop(5)
    epsilon = config.float_prop(1e-3)
    mask_zero_weight = config.bool_prop(False)

    def setup(self, observer):
        self.observer = io.get_telescope(observer)

    def process(self, data):
        data.redistribute("freq")
        weight = data.weight[:]
        vis_data = data.vis[:]

        timelike_axis = data.vis.attrs["axis"][-1]
        times = data.index_map[timelike_axis][:]
        if times.dtype.names and "ctime" in times.dtype.names:
            times = times["ctime"]

        if self.start is None:
            self.start = float(times[0])
        if self.end is None:
            self.end = float(times[-1])
        if self.start < times[0] or self.end > times[-1]:
            msg = "Start or end points for regridder fall outside bounds of input data."
            self.log.error(msg)
            raise RuntimeError(msg)

        new_grid, new_vis, ni = self._regrid(vis_data, weight, times)

        new_data = data.__class__(axes_from=data, attrs_from=data, **{timelike_axis: new_grid})
        new_data.vis[:] = new_vis
        new_data.weight[:] = ni
        return new_data

    def _regrid(self, vis_data, weight, times):
        grid, solved, ni = regrid_sidereal(
            vis_data, weight, times, self.samples, self.start, self.end, self.kernel_width, self.epsilon
        )
        if self.mask_zero_weight:
            had_data = weight.sum(dim=-1) != 0.0
            ni = ni * had_data[..., None]
        return grid, solved, ni


# Alias for compatibility
Regridder = LanczosRegridder


class TelescopeStreamMixIn:
    """Telescope-defined prod/stack index maps (reference transform.py:91-139).

    ``bt_prod``, ``bt_stack`` and ``bt_rev`` build streams compatible
    with a telescope's baseline configuration.
    """

    def setup(self, tel):
        """Set the telescope instance and precompute index maps."""
        self.telescope = tel = io.get_telescope(tel)
        nfeed = tel.nfeed

        # stack map: each unique pair's upper-triangle product id, with a
        # conjugation bit when the pair is stored lower-triangle
        pairs = np.asarray(tel.uniquepairs)
        self.bt_stack = np.zeros(len(pairs), dtype=[("prod", "<u4"), ("conjugate", "u1")])
        self.bt_stack["prod"] = tools.cmap(pairs.min(axis=1), pairs.max(axis=1), nfeed)
        self.bt_stack["conjugate"] = pairs[:, 0] > pairs[:, 1]

        # full upper-triangle product map
        ia, ib = np.triu_indices(nfeed)
        self.bt_prod = np.zeros(ia.size, dtype=[("input_a", "<u2"), ("input_b", "<u2")])
        self.bt_prod["input_a"] = ia
        self.bt_prod["input_b"] = ib

        # reverse map: product -> stack (masked products park one past the end)
        ok = tel.feedmask[ia, ib]
        self.bt_rev = np.zeros(ok.size, dtype=[("stack", "<u4"), ("conjugate", "u1")])
        self.bt_rev["stack"] = np.where(ok, tel.feedmap[ia, ib], tel.npairs)
        self.bt_rev["conjugate"] = ok & (tel.feedconj[ia, ib] != 0)


class CollateProducts(TelescopeStreamMixIn, ContainerTask):
    """Extract and order the correlation products for map-making.

    (reference transform.py:142-330).  Each incoming product is mapped
    onto a telescope stack on the host; the device accumulates the
    weighted products of each stack with ``index_add_`` in float64, block
    by block along the time axis, so that a full-triangle stream is never
    copied whole.

    Attributes
    ----------
    weight : "natural" | "uniform" | "inverse_variance"
        Redundant-baseline weighting for the stack.
    """

    weight = config.enum(["natural", "uniform", "inverse_variance"], default="natural")

    def _incoming_products(self, ss):
        """(product pairs, conjugation flags) of the incoming stream."""
        if not ss.is_stacked:
            return ss.prod, np.zeros(ss.prod.size, dtype=bool)
        stack_new, stack_flag = tools.redefine_stack_index_map(
            self.telescope, ss.input, ss.prod, ss.stack, ss.reverse_map["stack"]
        )
        dropped = int((~stack_flag).sum())
        if dropped:
            self.log.warning(f"{dropped} stacks are flagged out by the telescope model.")
        return ss.prod[stack_new["prod"]], stack_new["conjugate"].astype(bool)

    def process(self, ss):
        """Select and reorder products to match the telescope config."""
        tel = self.telescope
        input_ind = tools.find_inputs(tel.input_index, ss.input, require_match=False)
        rev_input_ind = tools.find_inputs(ss.input, tel.input_index, require_match=True)
        freq_ind = tools.find_keys(np.asarray(ss.freq), tel.frequencies, require_match=True)

        ss_prod, ss_conj = self._incoming_products(ss)

        sp = ss.__class__(
            freq=ss.index_map["freq"][freq_ind],
            input=tel.input_index,
            prod=self.bt_prod,
            stack=self.bt_stack,
            reverse_map_stack=self.bt_rev,
            axes_from=ss,
            attrs_from=ss,
        )
        dev = sp.device

        if "input_flags" in sp.datasets or "input_flags" in sp.dataset_spec():
            if "input_flags" not in sp.datasets:
                sp.add_dataset("input_flags")
            sp.datasets["input_flags"][:] = ss.input_flags[:][torch.as_tensor(rev_input_ind, device=dev)]

        # gather/scatter indices on the host: each incoming product onto a
        # telescope feed pair, then onto its output stack
        fa = np.array([-1 if x is None else x for x in input_ind], dtype=int)
        bi = fa[ss_prod["input_a"].astype(int)]
        bj = fa[ss_prod["input_b"].astype(int)]
        known = (bi >= 0) & (bj >= 0)
        stack_of = np.where(known, tel.feedmap[np.maximum(bi, 0), np.maximum(bj, 0)], -1)
        src = np.flatnonzero(known & (stack_of >= 0))
        conj = tel.feedconj[bi[src], bj[src]] != ss_conj[src]

        src_t = torch.as_tensor(src, device=dev)
        dst_t = torch.as_tensor(stack_of[src], device=dev)
        conj_t = torch.as_tensor(conj, device=dev)[None, :, None]
        fidx = torch.as_tensor(freq_ind, device=dev)
        vis, weight = ss.vis[:], ss.weight[:]
        nfreq_out, nstack_out, ntime = sp.vis.shape

        if self.weight != "inverse_variance":
            red_index = tools.redundancy_index(
                ss.index_map["prod"], ss.reverse_map["stack"]["stack"], vis.shape[1], len(ss.input), dev
            )

        for t0, t1 in tools.axis_blocks(ntime, vis.shape[0] * max(1, src.size)):
            v = vis[:, :, t0:t1].index_select(0, fidx).index_select(1, src_t).to(torch.complex128)
            w = weight[:, :, t0:t1].index_select(0, fidx).index_select(1, src_t).to(torch.float64)
            if self.weight == "inverse_variance":
                wss = w
            else:
                # the redundancy of each incoming stack over these samples
                red = tools.calculate_redundancy(
                    ss.input_flags[:], None, None, vis.shape[1], times=slice(t0, t1), index=red_index
                )
                if self.weight == "uniform":
                    red = (red > 0).to(red.dtype)
                wss = (w > 0.0) * red.index_select(0, src_t)[None].to(torch.float64)
            v = torch.where(conj_t, v.conj(), v)
            shape = (nfreq_out, nstack_out, t1 - t0)
            acc_vis = torch.zeros(shape, dtype=torch.complex128, device=dev).index_add_(1, dst_t, wss * v)
            acc_var = torch.zeros(shape, dtype=torch.float64, device=dev).index_add_(
                1, dst_t, wss**2 * invert_no_zero(w)
            )
            counter = torch.zeros(shape, dtype=torch.float64, device=dev).index_add_(1, dst_t, wss)
            del v, w, wss
            sp.vis[:, :, t0:t1] = acc_vis * invert_no_zero(counter)
            sp.weight[:, :, t0:t1] = counter**2 * invert_no_zero(acc_var)

        # copy any other frequency-filtered datasets (those on the input,
        # prod or stack axes are handled above)
        containers.copy_datasets_filter(
            ss, sp, selection={"freq": freq_ind}, exclude_axes=("input", "prod", "stack")
        )
        return sp


class StokesIVis(ContainerTask):
    """Extract instrumental Stokes I from visibilities (reference transform.py:1333-1448)."""

    def setup(self, telescope):
        """Set the telescope object."""
        self.telescope = io.get_telescope(telescope)

    def process(self, data):
        """Combine co-pol baselines into Stokes I (shrinks the stack axis), on the data's device."""
        src, dst, baselines = stokes_I_index(self.telescope)
        out = containers.empty_like(data, stack=baselines)
        stokes_I_sum(data.vis[:], src, dst, out=out.vis[:])
        stokes_I_sum(data.weight[:], src, dst, out=out.weight[:])
        return out


def stokes_I_index(tel):
    """(src, dst, ubase): the co-pol stacks of ``tel`` that form Stokes I, the
    unique baseline each one adds into, and those baselines [nbase, 2].

    Stacks are grouped by their baseline vector rounded to 1e-4 m; a
    co-pol stack counts when its group holds all four pol products and
    its feeds are not masked.  Host numpy.
    """
    key = np.around(tel.baselines @ np.array([1.0, 1.0j]), 4)
    uniq, uinv, ucount = np.unique(key, return_inverse=True, return_counts=True)
    ubase = np.stack([uniq.real, uniq.imag], axis=-1)
    pairs = tel.uniquepairs
    pol_a, pol_b = tel.polarisation[pairs].T
    good = (pol_a == pol_b) & (ucount[uinv] >= 4) & (tel.feedmap[pairs[:, 0], pairs[:, 1]] != -1)
    src = np.flatnonzero(good)
    return src, uinv[src], ubase


def stokes_I_sum(x: torch.Tensor, src, dst, nbase: int | None = None, out: torch.Tensor | None = None):
    """Sum the stacks ``src`` of ``x`` [freq, stack, time] into baselines ``dst``
    with ``index_add_`` on x's device, block by block along frequency; into
    ``out`` [freq, nbase, time] (zeroed first) if given."""
    if out is None:
        out = torch.zeros((x.shape[0], nbase, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        out.zero_()
    src_t = torch.as_tensor(src, device=x.device)
    dst_t = torch.as_tensor(dst, device=x.device)
    for f0, f1 in tools.axis_blocks(x.shape[0], len(src) * x.shape[2]):
        out[f0:f1].index_add_(1, dst_t, x[f0:f1].index_select(1, src_t).to(out.dtype))
    return out


def stokes_I(sstream, tel):
    """Extract instrumental Stokes I from a time/sidereal stream (reference transform.py:1382-1448).

    The per-product accumulation is ``index_add_`` over the unique baseline
    vectors on the stream's device.  Returns (vis_I [freq, nbase, time],
    weight_I, ubase [nbase, 2]).
    """
    src, dst, ubase = stokes_I_index(tel)
    nb = ubase.shape[0]
    return stokes_I_sum(sstream.vis[:], src, dst, nb), stokes_I_sum(sstream.weight[:], src, dst, nb), ubase


class ReduceBase(ContainerTask):
    """Weighted reduction across named axes (reference transform.py:1904).

    Non-functional without overriding :meth:`reduction`.  At least one axis
    must be excluded from the reduction.  The reduction runs on the
    dataset's device.

    Attributes
    ----------
    axes : list
        Axis names to reduce over.
    dataset : str
        Dataset name to reduce.
    weighting : "none" | "masked" | "weighted"
    """

    axes = config.list_prop()
    dataset = config.str_prop()
    weighting = config.enum(["none", "masked", "weighted"], default="none")

    _op = None

    def process(self, data):
        """Apply the reduction; reduced axes collapse to length 1."""
        out = self._make_output_container(data)
        out.add_dataset(self.dataset)

        ds = data.datasets[self.dataset]
        ds_axes = list(ds.attrs["axis"])
        arr = ds[:]

        weight, w_axes = self._get_weights(data)
        if weight is not None:
            wslc = tuple(slice(None) if ax in w_axes else None for ax in ds_axes)
            weight = torch.as_tensor(weight, device=arr.device)[wslc]
        else:
            weight = torch.ones(ds.shape, dtype=torch.float32, device=arr.device)
            wslc = None
        weight = weight.expand(ds.shape)

        apply_over = tuple(ds_axes.index(ax) for ax in self.axes if ax in ds_axes)
        reduced, reduced_weight = self.reduction(arr, weight, apply_over)
        out[self.dataset][:] = reduced

        if hasattr(out, "weight"):
            if wslc is not None:
                reduced_weight = reduced_weight[tuple(0 if ws is None else ws for ws in wslc)]
            out.weight[:] = reduced_weight
        return out

    def _get_weights(self, data):
        """Weights for the reduction (reference transform.py:2016)."""
        if hasattr(data, "weight"):
            return data.weight[:], list(data.weight.attrs["axis"])
        if self.weighting != "none":
            raise RuntimeError("Weighted/masked averaging needs a weight dataset, which is absent.")
        return None, None

    def _make_output_container(self, data):
        """Same container type with the reduced axes collapsed to one entry."""
        collapsed = {ax: np.asarray(data.index_map[ax])[:1] for ax in self.axes}
        out = data.__class__(axes_from=data, attrs_from=data, skip_datasets=True, **collapsed)
        out.attrs.update(
            reduced=True,
            reduction_axes=np.array(self.axes),
            reduced_dataset=self.dataset,
            reduction_op=self._op,
        )
        for wname in ("weight", "vis_weight"):
            if wname in data.datasets:
                out.add_dataset(wname)
                break
        return out

    def reduction(self, arr, weight, axis):
        """Override to implement the reduction operation."""
        raise NotImplementedError

    @staticmethod
    def _weighted_mean(arr, weight, axis):
        """(summed weight, weighted mean), keeping the reduced axes."""
        ws = weight.sum(dim=axis, keepdim=True)
        return ws, (weight * arr).sum(dim=axis, keepdim=True) * invert_no_zero(ws)


class ReduceVar(ReduceBase):
    """Weighted variance over the given axes (reference transform.py:2065)."""

    _op = "variance"

    def reduction(self, arr, weight, axis):
        if self.weighting == "none":
            v = torch.var(arr, dim=axis, correction=0, keepdim=True)
            return v, torch.ones_like(v)

        if self.weighting == "masked":
            weight = (weight > 0).to(torch.float32)

        ws, mu = self._weighted_mean(arr, weight, axis)
        # (arr - mu)**2, not |arr - mu|**2: for complex data the reference
        # stores the complex pseudo-variance (transform.py:2087);
        # ReduceChisq below uses the magnitude
        v = (weight * (arr - mu) ** 2).sum(dim=axis, keepdim=True) * invert_no_zero(ws)
        return v, ws


class ReduceChisq(ReduceBase):
    """Chi-squared per dof assuming weights are inverse noise variance.

    (reference transform.py:2092)
    """

    _op = "chisq_per_dof"

    def reduction(self, arr, weight, axis):
        dof = ((weight > 0).sum(dim=axis, keepdim=True) - 1).clamp(min=0).to(arr.real.dtype)
        _, mu = self._weighted_mean(arr, weight, axis)
        chisq = (weight * (arr - mu).abs() ** 2).sum(dim=axis, keepdim=True)
        return chisq * invert_no_zero(dof), dof


class _InverseStackRedundancyWeights(ReduceBase):
    """Weights that undo redundancy averaging (reference transform.py:2120)."""

    def _get_weights(self, data):
        if "stack" not in data.index_map:
            raise RuntimeError("Weight calculation needs a 'stack' entry in the index map.")
        counts = tools.calculate_redundancy(
            data.input_flags[:],
            data.index_map["prod"][:],
            data.reverse_map["stack"]["stack"][:],
            len(data.index_map["stack"]),
        )
        return data.weight[:] * invert_no_zero(counts**2)[None], list(data.weight.attrs["axis"])


class ReduceChisqInverseRedundancy(ReduceChisq, _InverseStackRedundancyWeights):
    """Chi-squared per dof, undoing redundancy averaging."""
