"""Transforms of the main path: m-modes, RA/frequency reshaping, regridding.

Port of ``draco_tpu.analysis.transform`` up to the regridders and the
product collation: reference ``draco/analysis/transform.py``
(TelescopeStreamMixIn:91, CollateProducts:142, FrequencyRebin:20,
SelectFreq:333, MModeTransform:535, MModeInverseTransform:708,
SiderealMModeResample:795, ShiftRA:993, Regridder:854), the Stokes I
extraction (StokesIVis:1333, stokes_I:1382) and the weighted reductions
(ReduceBase:1904, ReduceVar:2065, ReduceChisq:2092,
ReduceChisqInverseRedundancy:2120), and the rest of the JAX module:
GenerateSubBands:436, ElevationDependentHybridVisWeight:500, SelectPol:1068,
PolWeightedAverage:1234, TransformJanskyToKelvin:1451, MixData:1606,
Jackknife:1800, MixTwoDatasets:1814, Downselect:1848 and HPFTimeStream:2146.
Every task works on its container's device.

Two plain functions carry the math of the slice:

* :func:`regrid_sidereal`, the maximum-likelihood inverse of a Lanczos
  interpolation onto a regular grid (``LanczosRegridder._regrid``,
  reference transform.py:854-986), whose banded covariance is the
  hand-written CUDA kernel on the card.  Its rows are independent, and it
  solves them in blocks of whole leading-axis (frequency) entries, so that
  the band covariance and its Cholesky factor of a CHIME-width day do not
  all live on the card at once: a deliberate difference from the JAX
  package, which solves every row in one program;
* :func:`mmode_weights`, the m-mode noise weights of ``MModeTransform``
  (reference transform.py:599-602).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.task import ContainerTask, PipelineStopIteration, group_tasks
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
    "GenerateSubBands",
    "ElevationDependentHybridVisWeight",
    "SelectPol",
    "PolWeightedAverage",
    "TransformJanskyToKelvin",
    "MixData",
    "Jackknife",
    "MixTwoDatasets",
    "Downselect",
    "HPFTimeStream",
]

# bytes of one block's band covariance in regrid_sidereal (the Cholesky
# factor overwrites it; the weighted data, the dirty map and the solution add
# about half as much again): a CHIME day of 16 channels x 7155 stacks on a
# 4096-sample grid is two blocks of eight channels.  The banded solve's
# column loop costs the same for any block, so fewer blocks are faster
REGRID_BLOCK_BYTES = 9 << 30

C_LIGHT = 299792458.0


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
    dtype of ``vis``, over blocks of whole leading-axis entries whose band
    covariance takes at most ``REGRID_BLOCK_BYTES`` (at least one entry a
    block); the rows are independent, so the blocks change no result.

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
    bw = 2 * kernel_width - 1
    rows = vis.reshape(-1, ntime)
    wrows = weight.reshape(-1, ntime)
    nrows = rows.shape[0]
    nlead = vis.shape[0] if vis.ndim > 1 else 1
    per_lead = nrows // nlead
    # whole leading-axis entries a block, as many rows as the band covariance budget holds
    max_rows = REGRID_BLOCK_BYTES // ((bw + 1) * grid.size * R.element_size())
    solved = torch.empty((nrows, samples), dtype=vis.dtype, device=vis.device)
    ni = torch.empty((nrows, samples), dtype=rdt, device=vis.device)
    for l0, l1 in tools.axis_blocks(nlead, per_lead, max_rows):
        r0, r1 = l0 * per_lead, l1 * per_lead
        xh, nw = regrid_ops.band_wiener(R, wrows[r0:r1].to(rdt).contiguous(), Si, rows[r0:r1], bw)
        solved[r0:r1] = xh[:, pad:-pad]
        ni[r0:r1] = nw[:, pad:-pad]
        del xh, nw
    out_shape = (*vis.shape[:-1], samples)
    return grid[pad:-pad].copy(), solved.reshape(out_shape), ni.reshape(out_shape)


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
        counts = tools.stack_redundancy(
            data.input_flags[:],
            data.index_map["prod"][:],
            data.reverse_map["stack"]["stack"][:],
            len(data.index_map["stack"]),
        )
        return data.weight[:] * invert_no_zero(counts**2)[None], list(data.weight.attrs["axis"])


class ReduceChisqInverseRedundancy(ReduceChisq, _InverseStackRedundancyWeights):
    """Chi-squared per dof, undoing redundancy averaging."""


class GenerateSubBands(SelectFreq):
    """Generate multiple frequency sub-bands from one container.

    (reference transform.py:436-497)

    Attributes
    ----------
    sub_band_spec : dict
        ``{tag: {<SelectFreq property>: value, ...}, ...}`` — one output
        per entry.
    """

    sub_band_spec = config.dict_prop()

    def setup(self, data):
        """Cache the container to sub-divide."""
        self.data = data
        self.base_tag = data.attrs.get("tag", None)
        self._pending = list(self.sub_band_spec)

    def process(self):
        """Emit the next sub-band."""
        if not self._pending:
            raise PipelineStopIteration

        tag = self._pending.pop(0)
        self._configure_band(self.sub_band_spec[tag])
        self.data.attrs["tag"] = tag if self.base_tag is None else f"{self.base_tag}_{tag}"
        return super().process(self.data)

    def _configure_band(self, spec):
        """Reset every SelectFreq property, then apply this band's spec."""
        for key, prop in vars(SelectFreq).items():
            if isinstance(prop, config.Property):
                setattr(self, key, spec.get(key, prop._default_value()))


class ElevationDependentHybridVisWeight(ContainerTask):
    """Broadcast hybrid-vis weights over the elevation axis (reference transform.py:500-532)."""

    def process(self, data):
        if "elevation_vis_weight" in data:
            self.log.debug("Requested dataset already present; leaving it in place.")
        else:
            weights = data["vis_weight"][:]
            del data["vis_weight"]
            data.add_dataset("elevation_vis_weight")
            data.weight[:] = weights[..., None, :].expand(data.weight.shape)
        return data


def _clone_for_pol(polcont, pol_labels):
    """Clone a container with a new pol axis, mirroring its datasets."""
    out = containers.empty_like(polcont, pol=np.array(pol_labels))
    known = out.dataset_spec()
    for name in polcont.datasets:
        if name not in out.datasets and name in known:
            out.add_dataset(name)
    return out


def _pol_labels(cont) -> list[str]:
    return [p.decode() if isinstance(p, bytes) else str(p) for p in cont.index_map["pol"]]


class SelectPol(ContainerTask):
    """Extract Stokes parameters from beamformed data.

    (reference transform.py:1068-1231).  Supports I, Q, U, V from linear
    polarisations XX, YY, reXY, imXY.  Numeric datasets combine on their
    device; bool datasets (numpy) on the host.

    Attributes
    ----------
    pol : list
        Subset of ["I", "Q", "U", "V"].
    """

    pol = config.list_prop()

    # Stokes parameter -> {instrumental pol: sign} recipe
    P = {
        "I": {"XX": 1, "YY": 1},
        "Q": {"XX": 1, "YY": -1},
        "U": {"reXY": 1},
        "V": {"imXY": 1},
    }

    def setup(self):
        """Validate the requested polarisations."""
        unknown = set(self.pol) - set(self.P)
        if unknown:
            raise ValueError(f"Cannot form {sorted(unknown)}; supported selections are {list(self.P)}.")
        if len(set(self.pol)) != len(self.pol):
            raise ValueError("`pol` lists the same Stokes parameter twice.")

    def _combine_pol(self, name, arr, pax, input_pol, kind):
        """Combine the pol axis of one dataset into the requested Stokes.

        kind: 'data' (signed sum / N), 'weight' (inverse-variance
        composition with a joint positivity flag), or 'other'.
        """
        at = lambda i: (slice(None),) * pax + (i,)  # noqa: E731
        out_shape = arr.shape[:pax] + (len(self.pol),) + arr.shape[pax + 1 :]
        if not isinstance(arr, torch.Tensor):
            # bool (and other host) datasets: an OR over the recipe's pols
            out = np.zeros(out_shape, dtype=arr.dtype)
            for oo, stokes in enumerate(self.pol):
                for pname in self.P[stokes]:
                    out[at(oo)] |= arr[at(input_pol.index(pname))]
            return out
        out = torch.zeros(out_shape, dtype=arr.dtype, device=arr.device)
        integer = not (arr.is_floating_point() or arr.is_complex())

        for oo, stokes in enumerate(self.pol):
            recipe = self.P[stokes]
            nsum = len(recipe)
            dst = out[at(oo)]
            live = torch.ones(dst.shape, dtype=torch.bool, device=arr.device)

            for pname, sign in recipe.items():
                row = arr[at(input_pol.index(pname))]
                if kind == "data":
                    dst += sign * row
                elif kind == "weight":
                    live &= row > 0.0
                    dst += invert_no_zero(row)
                else:
                    dst += row

            if kind == "weight":
                out[at(oo)] = live * nsum**2 * invert_no_zero(dst)
            elif integer:
                out[at(oo)] = dst // nsum
            elif "freq_cov" in name:
                out[at(oo)] = dst / nsum**2
            else:
                out[at(oo)] = dst / nsum
        return out

    def process(self, polcont):
        """Extract the requested Stokes parameters."""
        if "pol" not in polcont.index_map:
            raise ValueError(f"{type(polcont)} carries no pol axis to select over.")
        input_pol = _pol_labels(polcont)

        needed = {p for stokes in self.pol for p in self.P[stokes]}
        absent = sorted(needed - set(input_pol))
        if absent:
            raise ValueError(f"Forming {self.pol} requires polarisations {absent}, which the input lacks.")

        data_name = getattr(polcont, "_data_dset_name", None)
        weight_name = getattr(polcont, "_weight_dset_name", None)

        outcont = _clone_for_pol(polcont, self.pol)

        for name, dset in polcont.datasets.items():
            if name not in outcont.datasets:
                continue
            out_dset = outcont.datasets[name]
            axis_names = list(dset.attrs["axis"])
            if "pol" not in axis_names:
                out_dset[:] = dset[:]
                continue
            kind = "data" if name == data_name else "weight" if name == weight_name else "other"
            out_dset[:] = self._combine_pol(name, dset[:], axis_names.index("pol"), input_pol, kind)

        return outcont


class PolWeightedAverage(ContainerTask):
    """Optimally weighted pseudo-Stokes I from XX and YY (reference transform.py:1234-1330)."""

    def process(self, polcont):
        """Compute the weighted average over the XX/YY pol axis."""
        if not hasattr(polcont, "_weight_dset_name"):
            raise TypeError("Input must be a subclass of DataWeightContainer.")
        if "pol" not in polcont.index_map:
            raise ValueError(f"Input container of type {type(polcont)} has no 'pol' axis.")

        input_pol = _pol_labels(polcont)
        try:
            ixx = input_pol.index("XX")
            iyy = input_pol.index("YY")
        except ValueError:
            raise ValueError("Stokes I needs the XX and YY polarisations present.") from None

        # slice picking exactly the XX and YY entries of the pol axis
        step = abs(iyy - ixx)
        first = min(ixx, iyy)
        copol = slice(first, first + step + 1, step)

        def pol_axis_of(axis_names):
            axis = list(axis_names).index("pol")
            return axis, (slice(None),) * axis + (copol,)

        outcont = _clone_for_pol(polcont, ["I"])

        waxis = polcont.weight.attrs["axis"]
        wpax, wslc = pol_axis_of(waxis)

        weight = polcont.weight[:][wslc]
        wsum = weight.sum(dim=wpax, keepdim=True)
        outcont.weight[:] = wsum
        norm = invert_no_zero(wsum)

        for name, dset in polcont.datasets.items():
            if name == polcont._weight_dset_name or name not in outcont.datasets:
                continue
            target = outcont.datasets[name]
            if "pol" not in dset.attrs["axis"]:
                target[:] = dset[:]
                continue
            pax, dslc = pol_axis_of(dset.attrs["axis"])
            wexp = tools.broadcast_weights(waxis, dset.attrs["axis"])
            target[:] = (weight[wexp] * dset[:][dslc]).sum(dim=pax, keepdim=True) * norm[wexp]

        return outcont


class TransformJanskyToKelvin(ContainerTask):
    """Convert visibilities between Jy and Kelvin units.

    (reference transform.py:1451-1603).  Integrates the primary beam solid
    angle from the telescope model on the host; the factors apply on the
    data's device in float64.

    Attributes
    ----------
    convert_Jy_to_K : bool
        Direction of the conversion.
    reference_declination : float
        Flux reference declination in degrees (default: zenith).
    share : "none" | "all"
        Whether to copy the container before modifying.
    nside : int
        Healpix resolution for the beam-area integral.
    """

    convert_Jy_to_K = config.bool_prop(True)
    reference_declination = config.float_prop(None)
    share = config.enum(["none", "all"], default="all")
    nside = config.int_prop(256)

    def setup(self, telescope):
        """Set the telescope object."""
        self.telescope = io.get_telescope(telescope)
        if self.reference_declination is None:
            self.reference_declination = self.telescope.latitude
        self._omega_cache = {}

    def _beam_area(self, feed, freq_ind):
        """Primary beam solid angle normalised at the reference declination."""
        from ..ops import healpix

        beam = np.asarray(self.telescope.beam(feed, freq_ind, self.nside))
        horizon = self.telescope.horizon_mask(self.nside)
        if beam.ndim == 2:
            beam_pow = np.sum(np.abs(beam) ** 2, axis=-1) * horizon
        else:
            beam_pow = np.abs(beam) ** 2 * horizon

        pxarea = 4 * np.pi / beam_pow.shape[0]
        omega = beam_pow.sum() * pxarea

        ref_pix = int(
            np.asarray(healpix.ang2pix(self.nside, np.radians(90.0 - self.reference_declination), 0.0)).reshape(-1)[0]
        )
        omega *= invert_no_zero(beam_pow[ref_pix])
        return float(omega)

    def _omega_per_pair(self, sstream, freqs):
        """sqrt(omega_i * omega_j) per (freq, prodstack) entry.

        Solid angles are cached per (beamclass, freq); only one feed per
        beamclass is ever integrated.
        """
        tel = self.telescope
        pairs = sstream.prodstack
        bc = tel.beamclass[np.stack([pairs["input_a"], pairs["input_b"]], axis=-1)]

        channel = {f: int(np.argmin(np.abs(tel.frequencies - f))) for f in freqs}
        # one representative feed index per beamclass
        flat_feeds = np.stack([pairs["input_a"], pairs["input_b"]], axis=-1).ravel()
        rep = dict(zip(bc.ravel(), flat_feeds))
        for klass, feed in rep.items():
            for f, fi in channel.items():
                if (klass, f) not in self._omega_cache:
                    self._omega_cache[(klass, f)] = self._beam_area(feed, fi)

        lookup = np.vectorize(lambda klass, f: self._omega_cache[(klass, f)])
        om = np.empty((len(freqs), len(pairs)))
        for fi, f in enumerate(freqs):
            om[fi] = np.sqrt(lookup(bc[:, 0], f) * lookup(bc[:, 1], f))
        return om

    def process(self, sstream):
        """Apply the conversion to the data and weights."""
        kB = 1.380649e-23
        freqs = np.asarray(sstream.freq)

        om_ij = self._omega_per_pair(sstream, freqs)
        wavelength = (C_LIGHT / (freqs * 1e6))[:, np.newaxis, np.newaxis]
        K_to_Jy = 2 * 1e26 * kB * om_ij[:, :, np.newaxis] / wavelength**2
        Jy_to_K = invert_no_zero(K_to_Jy)

        out = sstream if self.share == "all" else sstream.copy()
        d_fac, w_fac = (Jy_to_K, K_to_Jy) if self.convert_Jy_to_K else (K_to_Jy, Jy_to_K)
        dev = out.vis[:].device
        out.vis[:] = out.vis[:] * torch.as_tensor(d_fac, device=dev)
        out.weight[:] = out.weight[:] * torch.as_tensor(w_fac**2, device=dev)
        return out


class MixData(ContainerTask):
    """Mix containers with specified linear coefficients.

    (reference transform.py:1606-1797).  Useful for signal injection,
    jackknives, weight replacement, etc.  No normalisation is applied.

    Attributes
    ----------
    data_coeff, weight_coeff : list
        Per-input coefficients for the data / weight datasets.
    tag_coeff : list
        Which input tags contribute to the output tag.
    aux_coeff : dict
        ``{dataset_name: [coefficients]}`` for auxiliary datasets.
    invert_weight : bool
        Mix variances instead of inverse variances.
    require_nonzero_weight : bool
        Zero the output weight wherever any input weight was zero.
    """

    data_coeff = config.list_type(float)
    weight_coeff = config.list_type(float)
    tag_coeff = config.list_type(bool)
    aux_coeff = config.dict_prop({})
    invert_weight = config.bool_prop(False)
    require_nonzero_weight = config.bool_prop(False)

    mixed_data = None

    def setup(self):
        """Validate coefficient lists."""
        if len(self.data_coeff) != len(self.weight_coeff):
            raise config.ConfigError("One weight coefficient is needed per data coefficient.")
        self._data_ind = 0
        self._tags = []
        self._wfunc = invert_no_zero if self.invert_weight else (lambda x: x)

    def _start_mix(self, data):
        """Zero-initialised accumulator shaped like the first input."""
        acc = containers.empty_like(data)
        targets = ["data", "weight", *self.aux_coeff]
        for key in targets:
            if key in ("data", "weight"):
                ds = getattr(acc, key)
            else:
                if key not in acc.datasets:
                    acc.add_dataset(key)
                ds = acc.datasets[key]
            ds[:] = 0
        if self.require_nonzero_weight:
            self._flag = torch.ones(acc.weight.shape, dtype=torch.bool, device=acc.weight[:].device)
        return acc

    def _accumulate(self, target, coeff, values):
        if coeff != 0.0:
            target[:] = target[:] + coeff * values

    def process(self, data):
        """Add one container into the mix."""
        step = self._data_ind
        if step >= len(self.data_coeff):
            raise RuntimeError("This task cannot accept more items than there are coefficients set.")

        if self.mixed_data is None:
            self.mixed_data = self._start_mix(data)
        acc = self.mixed_data

        if type(acc) is not type(data):
            raise TypeError(f"Mixed containers disagree: {type(data)} vs type(data_stack) (={type(acc)})")
        if tuple(acc.data.shape) != tuple(data.data.shape):
            raise ValueError(f"Mixed datasets disagree in shape: {data.data.shape} vs {acc.data.shape}")

        self._accumulate(acc.data, self.data_coeff[step], data.data[:])
        wco = self.weight_coeff[step]
        if wco != 0.0:
            self._accumulate(acc.weight, wco, self._wfunc(data.weight[:]))
            if self.require_nonzero_weight:
                self._flag &= data.weight[:] > 0.0
        for key, coeffs in self.aux_coeff.items():
            self._accumulate(acc.datasets[key], coeffs[step], data.datasets[key][:])

        take_tag = self.tag_coeff is None or self.tag_coeff[step]
        if take_tag and "tag" in data.attrs:
            self._tags.append(data.attrs["tag"])

        self._data_ind = step + 1

    def _make_output(self):
        if self._data_ind != len(self.data_coeff):
            raise RuntimeError(
                f"Mixing ended early: {self._data_ind} inputs arrived but "
                f"{len(self.data_coeff)} coefficients were configured."
            )
        data = self.mixed_data
        self.mixed_data = None

        final_w = data.weight[:]
        if self.require_nonzero_weight:
            final_w = final_w * self._flag
            self._flag = None
        data.weight[:] = self._wfunc(final_w)
        data.attrs["tag"] = "_".join(self._tags)
        return data

    def process_finish(self):
        """Return the mixed container."""
        return self._make_output()


class Jackknife(MixData):
    """Half-difference jackknife of two datasets (reference transform.py:1800)."""

    data_coeff = config.list_type(float, default=[0.5, -0.5])
    weight_coeff = config.list_type(float, default=[0.25, 0.25])
    tag_coeff = config.list_type(bool, default=[True, True])
    invert_weight = config.bool_prop(True)
    require_nonzero_weight = config.bool_prop(True)


class MixTwoDatasets(MixData):
    """Mix exactly two datasets per iteration (reference transform.py:1814)."""

    data_coeff = config.list_type(float, 2)
    weight_coeff = config.list_type(float, 2)
    tag_coeff = config.list_type(bool, 2)

    def process(self, data1, data2):
        """Combine the two inputs and emit the result immediately."""
        for d in (data1, data2):
            super().process(d)
        out = self._make_output()
        self._data_ind = 0
        self._tags = []
        return out

    def process_finish(self):
        """No-op: outputs are emitted per iteration."""
        return None


class Downselect(io.SelectionsMixin, ContainerTask):
    """Apply axis selections to every dataset of a container.

    (reference transform.py:1848-1901).  Selections use the SelectionsMixin
    syntax (``<axis>_range`` / ``<axis>_index``) plus ``<axis>_map`` for
    selection by index-map value.
    """

    _sel_extra_suffixes = ("_map",)

    def process(self, data):
        """Apply the downselections."""
        sel = self._resolve_sel()

        # also support selection by index-map entry
        if self.selections:
            for k, v in self.selections.items():
                if k.endswith("_map"):
                    axis_name = k[: -len("_map")]
                    imap = list(data.index_map[axis_name])
                    sel[axis_name] = [imap.index(x) for x in v]

        output_axes = {}
        for ax, ax_sel in sel.items():
            imap = np.asarray(data.index_map[ax])
            output_axes[ax] = imap[ax_sel] if isinstance(ax_sel, slice) else imap[np.asarray(ax_sel)]

        out = data.__class__(axes_from=data, attrs_from=data, skip_datasets=True, **output_axes)
        containers.copy_datasets_filter(data, out, selection=sel)
        return out


class HPFTimeStream(ContainerTask):
    """High-pass filter a timestream (reference transform.py:2146).

    Solves for a low-pass model in a truncated Fourier basis and subtracts
    it.  The per-row Wiener solves (reference transform.py:2230-2251) run as
    one batched solve on the data's device (:func:`_hpf_rows`).

    Attributes
    ----------
    tau : float
        Timescale in seconds below which fluctuations are kept (i.e.
        fluctuations slower than tau are removed).
    pad : float
        Implicit zero-padding in multiples of tau (edge-effect mitigation).
    window : bool
        Apply a Blackman window to the basis.
    prior : float
        Expected scale of the slow fluctuations (regulariser).
    """

    tau = config.float_prop()
    pad = config.float_prop(2)
    window = config.bool_prop(True)
    prior = config.float_prop(1e2)

    def process(self, tstream):
        if "time" != tuple(tstream.data.attrs["axis"])[-1]:
            raise TypeError("The dataset must end with its 'time' axis.")
        if tuple(tstream.data.shape) != tuple(tstream.weight.shape):
            raise ValueError("Weights do not match the data shape.")

        tau = 2 * self.tau if self.window else self.tau

        times = np.asarray(tstream.time)
        dt = np.diff(times)
        if not np.allclose(dt, dt[0], atol=1e-4):
            self.log.warning("Irregular sample spacing detected; results may degrade.")

        span = 2 * tau + times[-1] - times[0]
        nmodes = int(np.ceil(span / tau))
        low_freqs = np.arange(-nmodes, nmodes) / span

        F = np.exp(2.0j * np.pi * np.outer(times, low_freqs))
        if self.window:
            F = F * np.blackman(2 * nmodes)

        d = tstream.data[:]
        dflat = d.reshape(-1, len(times))
        wflat = tstream.weight[:].reshape(-1, len(times)).to(torch.float64)
        filtered = _hpf_rows(dflat, wflat, torch.as_tensor(F, device=d.device), self.prior)
        tstream.data[:] = filtered.reshape(d.shape)
        return tstream


def _hpf_rows(d: torch.Tensor, w: torch.Tensor, F: torch.Tensor, prior: float) -> torch.Tensor:
    """Batched low-pass solve + subtract for :class:`HPFTimeStream`: d [rows,
    t] complex, w [rows, t] float64, F [t, modes] complex128."""
    Fh = F.conj().T
    wsum = w.sum(dim=-1, keepdim=True)
    mu = (d * w).sum(dim=-1, keepdim=True) * invert_no_zero(wsum)
    dd = d - mu

    dirty = (dd * w) @ Fh.T  # [rows, modes]
    Ci = torch.einsum("mt,rt,tn->rmn", Fh, w.to(F.dtype), F)
    Ci = Ci + torch.eye(F.shape[1], dtype=F.dtype, device=F.device) / prior**2

    f_lpf = torch.linalg.solve(Ci, dirty[..., None])[..., 0]
    t_lpf = f_lpf.real @ F.real.T - f_lpf.imag @ F.imag.T
    out = dd - t_lpf
    # rows with no valid data are left unchanged
    return torch.where(wsum > 0, out, d.to(out.dtype))
