"""DAYENU delay and m-mode filtering tasks (arXiv:2004.11397).

Port of ``draco_tpu.analysis.dayenu`` (reference ``draco/analysis/dayenu.py``:
DayenuDelayFilter:20, DayenuDelayFilterFixedCutoff:195,
DayenuDelayFilterHybridVis:407, ApplyDelayFilterHybridVis:575,
ApplyDelayFilterHybridVisSingleSource:742, DayenuDelayFilterMap:776,
DayenuMFilter:977).

The tasks work in place on their container's device.  The JAX package
loops over baselines, times, (ew, time, pol) cells or (pol, el) cells and
issues a device call for each; here the rows are grouped by the filter
they need (their delay cut and frequency mask), every group's filter is
factorised once in float64 on the device (:mod:`..ops.dayenu`), and each
group is applied as one product over a block of its rows.  The results
equal the JAX tasks' within the rounding of the products; the
``LinAlgError`` handling of the per-baseline, per-time and per-cell paths
is kept for the rows of a group whose factorisation fails.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.task import ContainerTask
from ..ops import dayenu as dayenu_ops
from ..ops.tools import axis_blocks, invert_no_zero
from . import transform

C_LIGHT = 299792458.0


def _median(x: torch.Tensor) -> torch.Tensor:
    """``numpy.median`` of a 1-D tensor (the mean of the two middle values for an even count)."""
    xs = torch.sort(x).values
    n = xs.numel()
    return xs[(n - 1) // 2 : n // 2 + 1].mean()


def _atten_flag(NF: torch.Tensor, threshold: float) -> torch.Tensor:
    """Low-attenuation frequency flag from a filter diagonal (reference dayenu.py:149-155)."""
    diag = torch.diagonal(NF).abs()
    nz = diag > 0.0
    if not bool(nz.any()):
        return torch.zeros_like(diag, dtype=torch.bool)
    return diag > threshold * _median(diag[nz])


def _pack_rows(mask: torch.Tensor) -> torch.Tensor:
    """Bool rows [n, k] packed into int64 words [n, ceil(k / 62)] (equal rows, equal words), a block of rows at
    a time."""
    n, k = mask.shape
    nw = -(-k // 62)
    shifts = torch.arange(62, device=mask.device, dtype=torch.int64)
    out = torch.empty((n, nw), dtype=torch.int64, device=mask.device)
    for r0, r1 in axis_blocks(n, nw * 62):
        pad = torch.zeros((r1 - r0, nw * 62), dtype=torch.int64, device=mask.device)
        pad[:, :k] = mask[r0:r1]
        out[r0:r1] = (pad.view(r1 - r0, nw, 62) << shifts).sum(dim=-1)
    return out


def _unique_rows(mask: torch.Tensor):
    """(unique bool rows, inverse index) of a [n, k] bool tensor."""
    _, first, inv = _unique_first(_pack_rows(mask))
    return mask[first], inv


def _unique_first(keys: torch.Tensor):
    """(unique keys, index of each key's first row, inverse index) of [n] or [n, w] integer keys."""
    uk, inv = torch.unique(keys, dim=0, return_inverse=True)
    n = inv.shape[0]
    first = torch.full((uk.shape[0],), n, dtype=torch.int64, device=keys.device)
    first.scatter_reduce_(0, inv, torch.arange(n, device=keys.device), reduce="amin")
    return uk, first, inv


def _highpass_pinv(freq, cuts, masks: torch.Tensor, epsilon, catch: bool = False):
    """DAYENU high-pass filters for each (cut, mask) pair, factorised in float64 on the masks' device.

    An all-False mask gives the zero filter without a factorisation.  With
    ``catch``, a chunk whose ``eigh`` fails is retried a filter at a time and
    the filters that fail are flagged instead of raising.

    Returns (NF float64 [n, nfreq, nfreq], failed bool [n]).
    """
    dev = masks.device
    nu, nfreq = masks.shape
    f = torch.as_tensor(np.asarray(freq, dtype=np.float64), device=dev)
    dfreq = f[:, None] - f[None, :]
    eye = torch.eye(nfreq, dtype=torch.float64, device=dev)
    NF = torch.zeros((nu, nfreq, nfreq), dtype=torch.float64, device=dev)
    failed = torch.zeros(nu, dtype=torch.bool, device=dev)
    live = torch.nonzero(masks.any(dim=1)).squeeze(1).tolist()
    cuts = np.asarray(cuts, dtype=np.float64)
    step = max(1, dayenu_ops.EIGH_CHUNK_BYTES // (nfreq * nfreq * 8))

    def build(idx):
        c = torch.as_tensor(cuts[idx], device=dev)[:, None, None]
        m = masks[idx].to(torch.float64)
        mask2 = m[:, None, :] * m[:, :, None]
        return (eye + torch.sinc(2.0 * c * dfreq) / epsilon) * mask2, mask2

    for i0 in range(0, len(live), step):
        idx = live[i0 : i0 + step]
        cov, mask2 = build(idx)
        try:
            NF[idx] = dayenu_ops.hermitian_pinv_batched(cov) * mask2
        except torch.linalg.LinAlgError:
            if not catch:
                raise
            for i in idx:
                cov_i, mask_i = build([i])
                try:
                    NF[i] = dayenu_ops.hermitian_pinv_batched(cov_i)[0] * mask_i[0]
                except torch.linalg.LinAlgError:
                    failed[i] = True
        del cov, mask2
    return NF, failed


def _group_keys(cut_of_row, mask_rows: torch.Tensor):
    """Group rows by (cut rounded to 1e-6 us, mask).

    Returns (unique cuts [n], unique masks [n, nfreq], group of each row).
    """
    dev = mask_rows.device
    ucut, cinv = np.unique(np.round(np.asarray(cut_of_row, dtype=np.float64), 6), return_inverse=True)
    words = _pack_rows(mask_rows)
    keys = torch.cat([torch.as_tensor(cinv.reshape(-1), device=dev)[:, None], words], dim=1)
    uk, first, gid = _unique_first(keys)
    return ucut[uk[:, 0].cpu().numpy()], mask_rows[first], gid


def _apply_columns(X: torch.Tensor, Wt: torch.Tensor, NF: torch.Tensor, gid: torch.Tensor, atten: float = 0.0):
    """Filter the columns of ``X`` [nfreq, ncol, ...] in place, group by group.

    Column ``c`` takes filter ``NF[gid[c]]`` (``gid`` -1: untouched).  Its
    weights ``Wt[:, c]`` become ``1 / (|NF|^2 @ var)`` (``var = 1 / Wt`` in the
    weights' type, the product in float64),
    times the low-attenuation flag when ``atten`` > 0.  The filter is cast to
    the data's type for the product; real data keeps the real part.
    """
    nfreq = X.shape[0]
    per_col = int(np.prod(X.shape[2:], dtype=np.int64))
    real = not X.is_complex()
    for g in range(NF.shape[0]):
        cols = torch.nonzero(gid == g).squeeze(1)
        if cols.numel() == 0:
            continue
        F = NF[g]
        Fd = F.to(X.dtype) if (not real or not F.is_complex()) else F
        F2 = F.abs() ** 2
        fl = _atten_flag(F, atten).to(torch.float64)[:, None] if atten > 0.0 else None
        for c0, c1 in axis_blocks(cols.numel(), nfreq * max(per_col, 1)):
            sel = cols[c0:c1]
            xb = X.index_select(1, sel)
            out = (Fd @ xb.reshape(nfreq, -1)).reshape(xb.shape)
            X.index_copy_(1, sel, out.real if real and out.is_complex() else out)
            del xb, out
            fw = invert_no_zero(F2 @ invert_no_zero(Wt.index_select(1, sel)).to(torch.float64))
            if fl is not None:
                fw = fw * fl
            Wt.index_copy_(1, sel, fw.to(Wt.dtype))


class DayenuDelayFilter(ContainerTask):
    """Apply a DAYENU high-pass delay filter to visibility data (reference dayenu.py:20-192).

    Attributes
    ----------
    za_cut : float
        Sine of the max zenith angle in the baseline-dependent delay cut
        (1 = horizon; 0 disables the baseline term).
    telescope_orientation : "NS" | "EW" | "none"
        Baseline component used for the cut.
    epsilon : float
        Stop-band rejection.  Default 1e-12.
    tauw : float
        Instrumental delay cut in microseconds.  Default 0.1.
    single_mask : bool
        Use one frequency mask for all times (frequencies valid at every
        time).  Otherwise build a filter per unique single-time mask.
    atten_threshold : float
        Mask frequencies whose filter diagonal is below this fraction of
        the median (0 disables).
    """

    za_cut = config.float_prop(1.0)
    telescope_orientation = config.enum(["NS", "EW", "none"], default="NS")
    epsilon = config.float_prop(1e-12)
    tauw = config.float_prop(0.100)
    single_mask = config.bool_prop(True)
    atten_threshold = config.float_prop(0.0)

    def setup(self, telescope):
        """Set the telescope used to obtain baselines."""
        self.telescope = io.get_telescope(telescope)
        self.log.info(f"Using an instrumental delay width of {self.tauw:.3f} us.")

    def process(self, stream):
        """Filter delays from a SiderealStream or TimeStream in place."""
        freq = np.asarray(stream.freq)
        cutoff = self._get_cut(stream.prodstack)

        vis = stream.vis[:]
        weight = stream.weight[:]
        nfreq, nprod, ntime = vis.shape
        X = vis.view(nfreq, nprod * ntime)
        Wt = weight.view(nfreq, nprod * ntime)

        if self.single_mask:
            # One mask per baseline: frequencies valid at ALL times
            masks = (weight > 0.0).all(dim=-1).T  # [nprod, nfreq]
            weight.mul_(masks.T[:, :, None])
            valid = torch.nonzero(masks.any(dim=-1)).squeeze(1)
            if valid.numel():
                ucut, umask, gid = _group_keys(cutoff[valid.cpu().numpy()], masks[valid])
                NF, _ = _highpass_pinv(freq, ucut, umask, self.epsilon)
                row_gid = torch.full((nprod,), -1, dtype=torch.int64, device=vis.device)
                row_gid[valid] = gid
                _apply_columns(X, Wt, NF, row_gid.repeat_interleave(ntime), self.atten_threshold)
        else:
            flag = weight > 0.0
            live = flag.any(dim=0).any(dim=-1)  # baselines with any valid sample
            cols = torch.nonzero(live.repeat_interleave(ntime)).squeeze(1)
            if cols.numel():
                col_masks = flag.view(nfreq, -1).index_select(1, cols).T  # [ncol, nfreq]
                col_base = (cols // ntime).cpu().numpy()
                ucut, umask, gid = _group_keys(cutoff[col_base], col_masks)
                del col_masks
                NF, failed = _highpass_pinv(freq, ucut, umask, self.epsilon, catch=True)
                col_gid = torch.full((nprod * ntime,), -1, dtype=torch.int64, device=vis.device)
                col_gid[cols] = gid
                if bool(failed.any()):
                    bad = torch.unique(torch.div(cols[failed[gid]], ntime, rounding_mode="floor"))
                    for bb in bad.tolist():
                        self.log.error(f"Failed to converge on baseline {bb}.")
                    weight[:, bad] = 0.0
                    col_gid.view(nprod, ntime)[bad] = -1
                _apply_columns(X, Wt, NF, col_gid, self.atten_threshold)
        return stream

    def _get_cut(self, prod):
        """Baseline-dependent delay cutoff (reference dayenu.py:177)."""
        pos = self.telescope.feedpositions
        baselines = pos[prod["input_a"], :] - pos[prod["input_b"], :]
        if self.telescope_orientation == "NS":
            baselines = abs(baselines[:, 1])
        elif self.telescope_orientation == "EW":
            baselines = abs(baselines[:, 0])
        else:
            baselines = np.sqrt(np.sum(baselines**2, axis=-1))

        return 1e6 * self.za_cut * baselines / C_LIGHT + self.tauw


class DayenuDelayFilterFixedCutoff(transform.ReduceChisq):
    """DAYENU high-pass with one cutoff for all baselines (reference dayenu.py:195-404).

    Times are grouped by their frequency mask (one filter for each unique
    mask, built at once); optionally the output is reduced over the stack
    axis to a chi-squared-per-dof statistic.

    Attributes
    ----------
    epsilon, tauw, single_mask, atten_threshold
        As in :class:`DayenuDelayFilter` (tauw default 0.45 microseconds).
    reduce_baseline : bool
        Return chi-squared per dof over baselines after filtering.
    mask_short : float
        Mask baselines shorter than this many metres (needs a telescope).
    """

    epsilon = config.float_prop(1e-12)
    tauw = config.float_prop(0.450)
    single_mask = config.bool_prop(True)
    atten_threshold = config.float_prop(0.0)

    reduce_baseline = config.bool_prop(False)
    mask_short = config.float_prop(None)

    dataset = "vis"
    axes = ("stack",)

    def setup(self, telescope=None):
        """Set the telescope model (only needed to mask short baselines)."""
        self.tel = None if telescope is None else io.get_telescope(telescope)
        if self.tel is None and self.mask_short is not None:
            raise RuntimeError("Short-baseline masking needs a telescope model at setup.")

    def process(self, stream):
        """Filter delays below the cutoff; optionally reduce over stack."""
        freq = np.asarray(stream.freq)
        vis = stream.vis[:]
        weight = stream.weight[:]
        nfreq, nstack, ntime = vis.shape
        dev = vis.device

        if self.reduce_baseline:
            out = self._make_output_container(stream)
            out.add_dataset(self.dataset)
            for dset in out.datasets.values():
                dset[:] = 0
            ovis, oweight = out.vis[:], out.weight[:]
        else:
            out, ovis, oweight = stream, vis, weight

        baseline_flag = (weight > 0.0).any(dim=2).any(dim=0)
        if self.mask_short is not None:
            blen = np.sqrt(np.sum(self.tel.baselines**2, axis=1))
            baseline_flag &= torch.as_tensor(blen >= self.mask_short, device=dev)
        if not bool(baseline_flag.any()):
            self.log.error("No valid baselines remain after flagging.")
            return None

        valid = torch.nonzero(baseline_flag).squeeze(1)
        nvalid = valid.numel()
        if not self.reduce_baseline:
            oweight[:, ~baseline_flag, :] = 0.0

        # the valid baselines' data as [freq, time, baseline] columns
        tv = vis.index_select(1, valid).transpose(1, 2).contiguous()
        tw = weight.index_select(1, valid).transpose(1, 2).contiguous()
        flag = tw > 0.0  # [nfreq, ntime, nvalid]

        if self.single_mask:
            # [ntime, nfreq] masks: frequencies valid for ALL valid baselines
            masks = flag.all(dim=2).T
            good_t = masks.any(dim=-1)
            if not self.reduce_baseline:
                oweight[:, :, ~good_t] = 0.0
            gt = torch.nonzero(good_t).squeeze(1)
            if gt.numel() == 0:
                return self._finish(out, ovis, oweight)
            ucut, umask, gid = _group_keys(np.full(gt.numel(), self.tauw), masks[gt])
            NF, _ = _highpass_pinv(freq, ucut, umask, self.epsilon)
            t_gid = torch.full((ntime,), -1, dtype=torch.int64, device=dev)
            t_gid[gt] = gid
            col_gid = t_gid.repeat_interleave(nvalid)
            done = good_t
        else:
            anyt = flag.any(dim=2).any(dim=0)  # times with a valid sample
            oweight[:, :, ~anyt] = 0.0
            cols = torch.nonzero(anyt.repeat_interleave(nvalid)).squeeze(1)
            col_gid = torch.full((ntime * nvalid,), -1, dtype=torch.int64, device=dev)
            done = anyt.clone()
            if cols.numel():
                col_masks = flag.view(nfreq, -1).index_select(1, cols).T
                ucut, umask, gid = _group_keys(np.full(cols.numel(), self.tauw), col_masks)
                del col_masks
                NF, failed = _highpass_pinv(freq, ucut, umask, self.epsilon, catch=True)
                col_gid[cols] = gid
                if bool(failed.any()):
                    bad_t = torch.unique(torch.div(cols[failed[gid]], nvalid, rounding_mode="floor"))
                    for tt in bad_t.tolist():
                        self.log.error(f"Failed to converge at time {tt}.")
                    oweight[:, :, bad_t] = 0.0
                    col_gid.view(ntime, nvalid)[bad_t] = -1
                    done[bad_t] = False
            else:
                NF = torch.zeros((0, nfreq, nfreq), dtype=torch.float64, device=dev)

        # the filtered columns; a column of no group (flagged everywhere in a
        # good time) comes out zero, as the JAX tasks' zero filter gives
        fv = torch.where(col_gid.view(ntime, nvalid)[None] >= 0, tv, torch.zeros_like(tv))
        fw = torch.where(col_gid.view(ntime, nvalid)[None] >= 0, tw, torch.zeros_like(tw))
        _apply_columns(fv.view(nfreq, -1), fw.view(nfreq, -1), NF, col_gid, self.atten_threshold)
        del tv, tw
        ti = torch.nonzero(done).squeeze(1)
        fv, fw = fv.index_select(1, ti), fw.index_select(1, ti)  # [nfreq, nt, nvalid]
        if self.reduce_baseline:
            rv, rw = self.reduction(fv, fw, (2,))
            ovis[:, :, ti] = rv[:, :, 0][:, None].to(ovis.dtype)
            oweight[:, :, ti] = rw[:, :, 0][:, None].to(oweight.dtype)
        else:
            ovis[:, valid[:, None], ti[None, :]] = fv.transpose(1, 2).to(ovis.dtype)
            oweight[:, valid[:, None], ti[None, :]] = fw.transpose(1, 2).to(oweight.dtype)
        return self._finish(out, ovis, oweight)

    @staticmethod
    def _finish(out, ovis, oweight):
        out.vis[:] = ovis
        out.weight[:] = oweight
        return out


def _hybrid_groups(freq, weight, tauw, tauc, epsilon):
    """One DAYENU filter for each unique (ew, time) frequency mask of a hybrid stream.

    The mask of a column is the frequencies valid at every pol.  Returns
    (NF [ngroup, nfreq, nfreq], group of each (ew, time) column [new, ntime],
    -1 where no frequency is valid).
    """
    flag_all = (weight > 0.0).all(dim=0)  # [nfreq, new, ntime]
    nfreq, new, ntime = flag_all.shape
    flag_cols = flag_all.reshape(nfreq, -1)
    any_valid = flag_cols.any(dim=0)
    cols = torch.nonzero(any_valid).squeeze(1)
    group = torch.full((new * ntime,), -1, dtype=torch.int64, device=weight.device)
    if cols.numel() == 0:
        return torch.zeros((0, nfreq, nfreq), dtype=torch.float64, device=weight.device), group.view(new, ntime)
    umask, inv = _unique_rows(flag_cols.index_select(1, cols).T)
    cov = dayenu_ops.delay_covariance(freq, tauw, tauc, epsilon)
    NF = dayenu_ops.batched_masked_pinv(cov, umask, device=weight.device)
    group[cols] = inv
    return NF, group.view(new, ntime)


def _check_axes(a, b, what="axes do not match for hybrid visibilities."):
    for axis, get in [
        ("freq", lambda c: c.freq),
        ("el", lambda c: c.index_map["el"]),
        ("ew", lambda c: c.index_map["ew"]),
        ("pol", lambda c: c.index_map["pol"]),
        ("ra", lambda c: c.ra),
    ]:
        if not np.array_equal(np.asarray(get(a)), np.asarray(get(b))):
            raise ValueError(f"{axis} {what}")


def _weighted_cov(F: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """``F diag(var_k) F^H`` for each column k of ``var`` [nfreq, k]: [nfreq, nfreq, k] in float64/complex128."""
    F = F.to(torch.complex128 if F.is_complex() else torch.float64)
    out = (F[None] * var.T.to(F.dtype)[:, None, :]) @ F.conj().T[None]
    return out.permute(1, 2, 0)


class DayenuDelayFilterHybridVis(ContainerTask):
    """DAYENU high-pass filter for hybrid beamformed visibilities (reference dayenu.py:407-572).

    One filter for each unique (ew, time) frequency mask; each is applied to
    all of its columns, every pol, in one product over a block of times.

    Attributes
    ----------
    tauw, tauc, epsilon : float or [nstopband] lists
        Stop-band half-width / centre (microseconds) and rejection.
    atten_threshold : float
        Low-attenuation frequency masking threshold.
    apply_filter, save_filter, calculate_cov : bool
        Apply the filter / store it in the container / store the
        freq-freq noise covariance.
    """

    tauw = config.Property(proptype=np.atleast_1d, default=0.4)
    tauc = config.Property(proptype=np.atleast_1d, default=0.0)
    epsilon = config.Property(proptype=np.atleast_1d, default=1e-12)

    atten_threshold = config.float_prop(0.0)
    apply_filter = config.bool_prop(True)
    save_filter = config.bool_prop(False)
    calculate_cov = config.bool_prop(False)

    def setup(self):
        """Validate the apply/save combination."""
        if not self.apply_filter and not self.save_filter:
            raise RuntimeError("Enable `save_filter`, `apply_filter`, or both — not neither.")

    def process(self, stream):
        """Filter a HybridVisStream in place."""
        is_complex = np.any(np.abs(self.tauc) > 0.0)

        if self.save_filter:
            name = "complex_filter" if is_complex else "filter"
            if name not in stream.datasets:
                stream.add_dataset(name)
            stream.filter[:] = 0
        if self.calculate_cov:
            name = "complex_freq_cov" if is_complex else "freq_cov"
            if name not in stream.datasets:
                stream.add_dataset(name)
            stream.freq_cov[:] = 0

        freq = np.asarray(stream.freq)
        vis = stream.vis[:]
        weight = stream.weight[:]
        filt = stream.filter[:] if self.save_filter else None
        fcov = stream.freq_cov[:] if self.calculate_cov else None
        npol, nfreq, new, nel, ntime = vis.shape

        NF, group = _hybrid_groups(freq, weight, self.tauw, self.tauc, self.epsilon)

        for g in range(NF.shape[0]):
            F = NF[g]
            Fd = F.to(vis.dtype)
            F2 = F.abs() ** 2
            fl = _atten_flag(F, self.atten_threshold) if self.atten_threshold > 0.0 else None
            for xx in range(new):
                ts = torch.nonzero(group[xx] == g).squeeze(1)
                if ts.numel() == 0:
                    continue
                if self.save_filter:
                    filt[:, :, :, xx].index_copy_(
                        -1, ts, F.to(filt.dtype)[None, :, :, None].expand(npol, nfreq, nfreq, ts.numel()))
                if not self.apply_filter:
                    continue
                for t0, t1 in axis_blocks(ts.numel(), npol * nfreq * nel):
                    sel = ts[t0:t1]
                    vb = vis[:, :, xx].index_select(-1, sel)  # [pol, freq, el, t]
                    out = Fd @ vb.reshape(npol, nfreq, -1)
                    vis[:, :, xx].index_copy_(-1, sel, out.reshape(vb.shape))
                    del vb, out
                    var = invert_no_zero(weight[:, :, xx].index_select(-1, sel)).to(torch.float64)  # [pol, f, t]
                    fw = invert_no_zero(F2 @ var)
                    if fl is not None:
                        fw = fw * fl[:, None]
                    weight[:, :, xx].index_copy_(-1, sel, fw.to(weight.dtype))
                    if fcov is not None:
                        cov = torch.stack([_weighted_cov(F, var[p]) for p in range(npol)])
                        fcov[:, :, :, xx].index_copy_(-1, sel, cov.to(fcov.dtype))
        return stream


class ApplyDelayFilterHybridVis(ContainerTask):
    """Apply a previously saved DAYENU filter to hybrid visibilities (reference dayenu.py:575-739).

    Used to push the foreground filter through a 21-cm simulation.  Every
    (pol, ew, time) column has its own saved filter; a block of columns is
    applied as one batched product.

    Attributes
    ----------
    atten_threshold : float
        Low-attenuation frequency masking threshold.
    calculate_cov : bool
        Store the freq-freq noise covariance.
    copy_weight : bool
        Copy weights from the filter container instead of propagating.
    copy_tag : bool
        Copy the tag from the filter container.
    """

    atten_threshold = config.float_prop(0.0)
    calculate_cov = config.bool_prop(False)
    copy_weight = config.bool_prop(False)
    copy_tag = config.bool_prop(False)

    def process(self, hv, source):
        """Apply ``source``'s filter to ``hv``."""
        _check_axes(source, hv)

        if self.copy_tag:
            hv.attrs["tag"] = source.attrs["tag"]

        if self.calculate_cov:
            name = "complex_freq_cov" if source.filter.dtype.is_complex else "freq_cov"
            if name not in hv.datasets:
                hv.add_dataset(name)
            hv.freq_cov[:] = 0

        vis = hv.vis[:]
        weight = hv.weight[:]
        filt = source.filter[:]  # [pol, freq, freq_sum, ew, ra]
        fcov = hv.freq_cov[:] if self.calculate_cov else None
        npol, nfreq, new, nel, ntime = vis.shape

        for xx in range(new):
            for t0, t1 in axis_blocks(ntime, npol * nfreq * max(nfreq, nel) * 4):
                w = weight[:, :, xx, t0:t1]  # [pol, f, t]
                flag = w > 0.0
                F = filt[:, :, :, xx, t0:t1].permute(0, 3, 1, 2)  # [pol, t, f, g]
                valid_freq = (F.abs() > 0.0).any(dim=2)  # [pol, t, g]
                live = flag.any(dim=1)  # [pol, t]
                empty = ~valid_freq.any(dim=-1)
                missing = (valid_freq & ~flag.transpose(1, 2)).any(dim=-1)
                if bool((live & ~empty & missing).any()):
                    self.log.warning("Missing frequencies assumed valid during filter generation.")
                zero = live & (empty | missing)
                ok = live & ~zero  # [pol, t]
                vb = vis[:, :, xx, :, t0:t1].permute(0, 3, 1, 2)  # [pol, t, g, el]
                out = F.to(vis.dtype) @ vb
                vnew = torch.where(ok[:, :, None, None], out, vb).permute(0, 2, 3, 1)
                vis[:, :, xx, :, t0:t1] = vnew
                del vb, out, vnew
                if self.copy_weight:
                    continue
                var = invert_no_zero(w).to(torch.float64).transpose(1, 2)  # [pol, t, g]
                fw = invert_no_zero((F.abs().to(torch.float64) ** 2 @ var[..., None])[..., 0])  # [pol, t, f]
                if self.atten_threshold > 0.0:
                    fw = fw * _atten_flags(F, self.atten_threshold)
                wnew = torch.where(ok[:, :, None], fw, torch.where(zero[:, :, None], 0.0, w.transpose(1, 2).double()))
                weight[:, :, xx, t0:t1] = wnew.transpose(1, 2).to(weight.dtype)
                if fcov is not None:
                    Fc = F.to(torch.complex128 if F.is_complex() else torch.float64)
                    cov = (Fc * var[:, :, None, :].to(Fc.dtype)) @ Fc.conj().transpose(-1, -2)  # [pol, t, f, h]
                    fcov[:, :, :, xx, t0:t1] = torch.where(ok[:, :, None, None], cov, 0).permute(0, 2, 3, 1).to(
                        fcov.dtype)

        if self.copy_weight:
            weight[:] = source.weight[:]
            if self.calculate_cov:
                fcov[:] = source.freq_cov[:]
        return hv


def _atten_flags(F: torch.Tensor, threshold: float) -> torch.Tensor:
    """:func:`_atten_flag` of each filter of ``F`` [..., f, f]: [..., f] float64."""
    lead = F.shape[:-2]
    flat = F.reshape(-1, *F.shape[-2:])
    out = torch.stack([_atten_flag(flat[i], threshold) for i in range(flat.shape[0])])
    return out.reshape(*lead, F.shape[-1]).to(torch.float64)


class ApplyDelayFilterHybridVisSingleSource(ApplyDelayFilterHybridVis):
    """Apply ONE saved filter to multiple datasets (reference dayenu.py:742)."""

    def setup(self, source):
        """Set the filter container."""
        self.source = source

    def process(self, hv):
        """Apply the stored filter to ``hv``."""
        return super().process(hv, self.source)


def _polname(p):
    return p.decode() if isinstance(p, bytes) else str(p)


class DayenuDelayFilterMap(ContainerTask):
    """DAYENU high-pass delay filter for ring maps (reference dayenu.py:776-974).

    The delay cutoff may vary with map elevation via a DelayCutoff file;
    (pol, el) cells, or with ``single_mask: false`` their (pol, ra, el)
    columns, that share a (cutoff, mask) pair take one filter, applied to
    them together.

    Attributes
    ----------
    epsilon : float
        Stop-band rejection.
    filename : str
        Optional DelayCutoff container; its cutoff dataset is interpolated
        in el.
    tauw : float
        Cutoff in microseconds (fallback / out-of-range value).
    single_mask : bool
        One frequency mask for all RAs.
    atten_threshold : float
        Low-attenuation frequency masking threshold.
    """

    epsilon = config.float_prop(1e-12)
    filename = config.str_prop(None)
    tauw = config.float_prop(0.100)
    single_mask = config.bool_prop(True)
    atten_threshold = config.float_prop(0.0)

    def setup(self):
        """Build the el -> cutoff interpolator if a file was given."""
        if self.filename is not None:
            import scipy.interpolate

            fcut = containers.DelayCutoff.from_file(self.filename)
            kind = fcut.attrs.get("kind", "linear")
            cut = np.asarray(fcut.cutoff[:])
            self._cut_interpolator = {
                pol: scipy.interpolate.interp1d(
                    np.asarray(fcut.el), cut[pp], kind=kind, bounds_error=False, fill_value=self.tauw
                )
                for pp, pol in enumerate(fcut.pol)
            }
        else:
            self._cut_interpolator = None

    def process(self, ringmap):
        """Filter delays from a RingMap in place."""
        freq = np.asarray(ringmap.freq)
        rm = ringmap.map[:]  # [beam, pol, freq, ra, el]
        weight = ringmap.weight[:]  # [pol, freq, ra, el]
        nbeam, npol, nfreq, nra, nel = rm.shape
        els = np.asarray(ringmap.index_map["el"])
        pols = np.asarray(ringmap.index_map["pol"])
        cell_cut = np.array([[self._get_cut(els[ee], pol=_polname(pols[pp])) for ee in range(nel)]
                             for pp in range(npol)])  # [pol, el]

        # columns (pol, ra, el) with frequency first
        X = rm.permute(2, 1, 3, 4, 0).contiguous()  # [freq, pol, ra, el, beam]
        Wt = weight.permute(1, 0, 2, 3).contiguous()  # [freq, pol, ra, el]
        ncol = npol * nra * nel
        dev = rm.device
        col_cut = np.broadcast_to(cell_cut[:, None, :], (npol, nra, nel)).reshape(-1)
        col_gid = torch.full((ncol,), -1, dtype=torch.int64, device=dev)

        if self.single_mask:
            flag = (Wt > 0.0).all(dim=2)  # [freq, pol, el]
            Wt.mul_(flag[:, :, None, :])
            cells = torch.nonzero(flag.any(dim=0).reshape(-1)).squeeze(1)  # cell = pol * nel + el
            if cells.numel():
                ucut, umask, gid = _group_keys(cell_cut.reshape(-1)[cells.cpu().numpy()],
                                               flag.reshape(nfreq, -1).index_select(1, cells).T)
                NF, _ = _highpass_pinv(freq, ucut, umask, self.epsilon)
                cell_gid = torch.full((npol * nel,), -1, dtype=torch.int64, device=dev)
                cell_gid[cells] = gid
                col_gid = cell_gid.view(npol, 1, nel).expand(npol, nra, nel).reshape(-1)
                _apply_columns(X.view(nfreq, ncol, nbeam), Wt.view(nfreq, ncol), NF, col_gid, self.atten_threshold)
        else:
            flag = Wt > 0.0  # [freq, pol, ra, el]
            live = flag.any(dim=0).any(dim=1)  # [pol, el]
            cols = torch.nonzero(live[:, None, :].expand(npol, nra, nel).reshape(-1)).squeeze(1)
            if cols.numel():
                ucut, umask, gid = _group_keys(col_cut[cols.cpu().numpy()],
                                               flag.view(nfreq, -1).index_select(1, cols).T)
                NF, failed = _highpass_pinv(freq, ucut, umask, self.epsilon, catch=True)
                col_gid[cols] = gid
                if bool(failed.any()):
                    bad = torch.unique(cols[failed[gid]])
                    bp, be = torch.div(bad, nra * nel, rounding_mode="floor"), bad % nel
                    for pp, ee in sorted(set(zip(bp.tolist(), be.tolist()))):
                        self.log.error(f"Failed to converge at el {els[ee]:0.3f}.")
                        Wt[:, pp, :, ee] = 0.0
                        col_gid.view(npol, nra, nel)[pp, :, ee] = -1
                _apply_columns(X.view(nfreq, ncol, nbeam), Wt.view(nfreq, ncol), NF, col_gid, self.atten_threshold)

        rm.copy_(X.permute(4, 1, 0, 2, 3))
        weight.copy_(Wt.permute(1, 0, 2, 3))
        return ringmap

    def _get_cut(self, el, pol=None, **kwargs):
        """Delay cutoff in microseconds (reference dayenu.py:964)."""
        if self._cut_interpolator is None:
            return self.tauw
        if pol in self._cut_interpolator:
            return float(self._cut_interpolator[pol](el))
        return float(np.max([func(el) for func in self._cut_interpolator.values()]))


class DayenuMFilter(ContainerTask):
    """DAYENU bandpass m-mode filter (reference dayenu.py:977-1122).

    Keeps m-modes around the fringe rate of a source at declination
    ``dec``; intercylinder baselines are mixed down before low-pass
    filtering.  A channel's two filters are factorised together in
    float64 on the device; its intracylinder rows take one product, and its
    intercylinder rows, each mixed by its own separation's fringe rate,
    another.

    Attributes
    ----------
    dec : float
        Declination (degrees) setting the pass-band centre.
    epsilon : float
        Stop-band rejection.  Default 1e-10.
    fkeep_intra, fkeep_inter : float
        Pass-band widths as fractions of the cylinder-width fringe rate.
    """

    dec = config.float_prop(40.0)
    epsilon = config.float_prop(1e-10)
    fkeep_intra = config.float_prop(0.75)
    fkeep_inter = config.float_prop(0.75)

    def setup(self, telescope):
        """Set the telescope used to obtain baselines."""
        self.telescope = io.get_telescope(telescope)

    def process(self, stream):
        """Filter m-modes from a SiderealStream in place."""
        ra = np.radians(np.asarray(stream.ra, dtype=np.float64))
        freq = np.asarray(stream.freq)
        nfreq = freq.size

        prod = stream.prodstack
        pos = self.telescope.feedpositions
        spacing = self.telescope.cylinder_spacing
        baselines = pos[prod["input_a"], 0] - pos[prod["input_b"], 0]
        baselines = np.round(baselines / spacing) * spacing
        db = 0.5 * spacing
        intra = np.abs(baselines) < db

        vis = stream.vis[:]
        weight = stream.weight[:]
        dev = vis.device
        ra_t = torch.as_tensor(ra, device=dev)
        intra_rows = torch.as_tensor(np.flatnonzero(intra), device=dev)
        inter_rows = torch.as_tensor(np.flatnonzero(~intra), device=dev)

        for ff, nu in enumerate(freq):
            flag = weight[ff] > 0.0
            gb = flag.any(dim=-1)
            ngb = int(gb.sum())
            if ngb == 0:
                continue

            # Mask RAs where >10% of valid baselines are masked
            flag = flag[gb].sum(dim=0, keepdim=True) > (0.90 * float(ngb))
            weight[ff] *= flag.to(weight.dtype)
            if not bool(flag.any()):
                continue

            self.log.debug(f"DAYENU pass on channel {ff:d}/{nfreq:d}.")

            m_cut = np.abs(self._get_cut(nu, db))
            m_center_intra = 0.5 * (2.0 - self.fkeep_intra) * m_cut
            m_cut_intra = 0.5 * self.fkeep_intra * m_cut
            m_cut_inter = self.fkeep_inter * m_cut

            INTRA, _ = dayenu_ops.bandpass_mmode_filter(ra, m_center_intra, m_cut_intra, flag, epsilon=self.epsilon)
            INTER, _ = dayenu_ops.lowpass_mmode_filter(ra, m_cut_inter, flag, epsilon=self.epsilon)

            v = vis[ff]
            if intra_rows.numel():
                v[intra_rows] = v.index_select(0, intra_rows) @ INTRA[0].T.to(v.dtype)
            if inter_rows.numel():
                m_center = torch.as_tensor(self._get_cut(nu, baselines[~intra]), device=dev)
                mixer = torch.polar(torch.ones_like(ra_t)[None], -m_center[:, None] * ra_t[None]).to(v.dtype)
                filtered = (v.index_select(0, inter_rows) * mixer) @ INTER[0].T.to(v.dtype)
                v[inter_rows] = filtered * mixer.conj()
        return stream

    def _get_cut(self, freq, xsep):
        """Fringe-rate m of a source at ``self.dec`` (reference dayenu.py:1117)."""
        lmbda = C_LIGHT / (freq * 1e6)
        u = xsep / lmbda
        return dayenu_ops.instantaneous_m(0.0, np.radians(self.telescope.latitude), np.radians(self.dec), u, 0.0)
