"""FFT ring-map making for cartesian arrays.

Port of ``draco_tpu.analysis.ringmapmaker`` (reference
``draco/analysis/ringmapmaker.py``: MakeVisGrid:38, BeamformNS:186,
BeamformEW:356, RingMapMaker:534, DeconvolveHybridMBase:538,
DeconvolveAnalyticalBeam:968, TikhonovRingMapMaker:1075,
WienerRingMapMaker:1123, RADependentWeights:1202,
ReconstructVisNoiseBase:1318, ReconstructVisWeight:1517,
ReconstructVisFreqCov:1604, find_grid_indices:1745).

Every task works on its container's device:

* the grid scatter is two ordered passes of ``index_put_`` (the mirrored
  intracylinder products first, so that measured products win a
  collision), each with its target cells made unique on the host;
* the NS beamforming is a batched complex matmul ``[el, ns] @ [ns, ra]``
  over (pol, ew) and the EW stage a pol rotation and an ``irfft``, both
  in blocks of frequency so that their complex128 transients are one
  block's;
* the m-space deconvolution runs in blocks of frequency, with the
  analytical beam's m-modes made on the device;
* the freq-freq covariance is factorised by one batched ``cholesky_ex``,
  and a failed factorisation raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.task import ContainerTask, group_tasks
from ..ops import mmode
from ..ops.tools import axis_blocks, calculate_redundancy, invert_no_zero, redundancy_index, window_generalised
from .transform import TelescopeStreamMixIn

C_LIGHT = 299792458.0

__all__ = [
    "find_basis",
    "find_grid_indices",
    "MakeVisGrid",
    "BeamformNS",
    "BeamformEW",
    "RingMapMaker",
    "DeconvolveHybridMBase",
    "DeconvolveAnalyticalBeam",
    "TikhonovRingMapMaker",
    "WienerRingMapMaker",
    "TikhonovRingMapMakerAnalytical",
    "WienerRingMapMakerAnalytical",
    "RADependentWeights",
    "ReconstructVisNoiseBase",
    "ReconstructVisWeight",
    "ReconstructVisFreqCov",
]


def _ew_weighting(scheme, template: torch.Tensor, exclude_cyl=()) -> torch.Tensor:
    """Unnormalised per-EW-column weights, broadcastable over ``template``.

    ``template`` is a tensor whose ``-2`` axis indexes EW separation.
    ``scheme = "inverse_variance"`` returns a float64 copy of the template
    itself; ``"uniform"`` equal weights; ``"natural"`` a linear fall-off
    with cylinder separation.  Columns listed in ``exclude_cyl`` are
    zeroed (reference ringmapmaker.py:1094-1121,1252-1270).
    """
    if scheme == "inverse_variance":
        w = template.to(torch.float64, copy=True)
    else:
        n_ew = template.shape[-2]
        col = np.ones(n_ew) if scheme == "uniform" else (n_ew - np.arange(n_ew)).astype(float)
        shape = [1] * template.ndim
        shape[-2] = n_ew
        w = torch.as_tensor(col, dtype=torch.float64, device=template.device).reshape(shape).clone()
    for cyl in exclude_cyl:
        w[..., cyl, :] = 0.0
    return w


def _sum_normalised(w: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Normalise weights to unit sum along ``axis`` (zero-safe)."""
    return w * invert_no_zero(w.sum(dim=axis, keepdim=True))


def _ns_fft_axis(ny, min_ysep):
    """NS positions in FFT ordering for an ny-point grid."""
    return np.fft.fftfreq(ny, d=1.0 / (ny * min_ysep))


def _pol_names(imap) -> list[str]:
    return [p.decode() if isinstance(p, bytes) else str(p) for p in imap]


def find_basis(baselines):
    """Unit vectors of the (mostly-X, mostly-Y) grid axes.

    (reference ringmapmaker.py:1715-1742)
    """
    baselines = np.asarray(baselines)
    norms = np.einsum("ij,ij->i", baselines, baselines)
    shortest = int(np.argmin(np.where(norms == 0, 1e30, norms)))

    first = baselines[shortest]
    perp = np.array([first[1], -first[0]])
    xh, yh = (first, perp) if abs(first[0]) > abs(perp[0]) else (perp, first)

    def unit(v, component):
        direction = np.sign(v[component]) or 1.0
        return direction * v / np.linalg.norm(v)

    return unit(xh, 0), unit(yh, 1)


def find_grid_indices(baselines):
    """Integer grid indices and minimum separations of a cartesian layout.

    (reference ringmapmaker.py:1745)
    """
    baselines = np.asarray(baselines)

    def _indices(sep):
        nonzero = np.abs(sep[np.abs(sep) > 1e-6])
        minsep = nonzero.min() if nonzero.size else 1.0
        return np.rint(sep / minsep).astype(int), minsep

    xind, min_xsep = _indices(baselines[:, 0])
    yind, min_ysep = _indices(baselines[:, 1])
    return xind, yind, min_xsep, min_ysep


def scatter_plan(passes, grid_shape):
    """The grid scatter's passes with every target cell written once a pass.

    ``passes`` is a list of ``(pol, x, y, source, conj)`` index arrays, in
    the order they are written; ``grid_shape`` is (npol, nx, ny).  Negative
    x and y wrap, as numpy indexing does (the NS axis is in FFT order).
    Where a pass names a cell more than once its last source is kept:
    what numpy's in-order assignment leaves.  ``index_put_`` writes
    repeated cells in no defined order on CUDA, so each pass handed to it
    must name every cell once; the passes themselves run in order.
    """
    npol, nx, ny = grid_shape
    plan = []
    for p, x, y, src, conj in passes:
        p, x, y = np.asarray(p), np.asarray(x) % nx, np.asarray(y) % ny
        flat = np.ravel_multi_index((p, x, y), grid_shape)
        _, first_from_end = np.unique(flat[::-1], return_index=True)
        keep = np.sort(len(flat) - 1 - first_from_end)
        plan.append((p[keep], x[keep], y[keep], np.asarray(src)[keep], conj))
    return plan


def _place(dataset, source: torch.Tensor, plan, freq_axis: bool) -> None:
    """Scatter rows of ``source`` onto ``dataset`` ([pol, (freq,) ew, ns, ...]).

    ``source`` is [freq, product, ra] (``freq_axis``) or [product, ra]; the
    passes of ``plan`` run in order, in blocks of frequency.
    """
    buf = dataset[:]
    dev = buf.device
    steps = []
    for p, x, y, src, conj in plan:
        idx = tuple(torch.as_tensor(a, dtype=torch.long, device=dev) for a in (p, x, y))
        steps.append((idx, torch.as_tensor(src, dtype=torch.long, device=dev), conj))
    if not freq_axis:
        for idx, src, conj in steps:
            rows = source.index_select(0, src)
            buf[idx] = (rows.conj_physical() if conj else rows).to(buf.dtype)
        return
    # the grid axes in front of freq: [pol, ew, ns, freq, ra]
    view = buf.permute(0, 2, 3, 1, 4)
    nfreq = source.shape[0]
    for f0, f1 in axis_blocks(nfreq, source.shape[1] * source.shape[2]):
        block = view[:, :, :, f0:f1]
        for idx, src, conj in steps:
            rows = source[f0:f1].index_select(1, src).transpose(0, 1)
            block[idx] = (rows.conj_physical() if conj else rows).to(buf.dtype)


class MakeVisGrid(ContainerTask):
    """Scatter stacked visibilities onto a pol x EW x NS grid.

    (reference ringmapmaker.py:38-183).  Intracylinder (x == 0) products
    also land at the mirrored NS position under the conjugate
    polarisation; the mirrors are written first, so that a measured
    product always wins a collision (:func:`scatter_plan`).
    """

    centered = config.bool_prop(False)
    save_redundancy = config.bool_prop(True)

    def setup(self, tel):
        self.telescope = io.get_telescope(tel)

    def process(self, sstream):
        tel = self.telescope
        table = sstream.prodstack
        if not np.array_equal(np.stack([table["input_a"], table["input_b"]], axis=-1), tel.uniquepairs):
            raise ValueError("The stream's product table differs from the beam-transfer one.")

        # polarisation label of every unique pair, and its slot on the
        # output pol axis; the conjugate-slot map serves the mirrors
        feedpol = np.asarray(tel.polarisation)[tel.uniquepairs]
        pol, pind = np.unique(np.char.add(feedpol[:, 0], feedpol[:, 1]), return_inverse=True)
        if len(pol) != 4:
            raise RuntimeError(f"Four polarisation products are required; the input has {pol}")
        pconjmap = np.unique([b + a for a, b in pol], return_inverse=True)[1]

        xind, yind, min_xsep, min_ysep = find_grid_indices(tel.baselines)
        half_ns = np.abs(yind).max()
        ny = 2 * half_ns + 1
        vis_pos_x = np.arange(np.abs(xind).max() + 1) * min_xsep
        if self.centered:
            vis_pos_y = np.arange(-half_ns, half_ns + 1) * min_ysep
            ns_offset = half_ns
        else:
            vis_pos_y = _ns_fft_axis(ny, min_ysep)
            ns_offset = 0

        if "ra" in sstream.index_map:
            ra = sstream.ra
        elif "lsd" in sstream.attrs:
            ra = 360 * (tel.unix_to_lsd(sstream.time) - sstream.attrs["lsd"])
        else:
            ra = tel.unix_to_lsa(sstream.time)

        grid = containers.VisGridStream(
            pol=pol, ew=vis_pos_x, ns=vis_pos_y, ra=ra, axes_from=sstream, attrs_from=sstream
        )

        intra = np.flatnonzero(xind == 0)
        plan = scatter_plan(
            [
                (pconjmap[pind[intra]], xind[intra], ns_offset - yind[intra], intra, True),
                (pind, xind, ns_offset + yind, np.arange(len(pind)), False),
            ],
            (len(pol), len(vis_pos_x), ny),
        )
        _place(grid.vis, sstream.vis[:], plan, freq_axis=True)
        # weights and redundancy are real: the mirror conj is a no-op
        _place(grid.weight, sstream.weight[:], plan, freq_axis=True)
        if self.save_redundancy:
            # block by block along RA: a full-triangle product map would
            # otherwise make [nprod, nra] temporaries
            flags = sstream.input_flags[:]
            nstack, nra = sstream.vis.shape[1], flags.shape[1]
            index = redundancy_index(
                sstream.index_map["prod"][:], sstream.reverse_map["stack"]["stack"][:], nstack, flags.shape[0],
                flags.device,
            )
            redundancy = torch.empty((nstack, nra), dtype=torch.float32, device=flags.device)
            for t0, t1 in axis_blocks(nra, max(1, len(index[0]))):
                redundancy[:, t0:t1] = calculate_redundancy(flags, None, None, nstack, times=slice(t0, t1), index=index)
            grid.add_dataset("redundancy")
            _place(grid.datasets["redundancy"], redundancy, plan, freq_axis=False)
        return grid


class BeamformNS(ContainerTask):
    """Beamform in the NS direction onto an elevation grid.

    (reference ringmapmaker.py:186-353): per frequency a complex matmul
    ``F [el, ns] @ (weighted grid) [ns, ra]`` batched over (pol, ew), in
    blocks of frequency on the grid's device.
    """

    npix = config.int_prop(512)
    span = config.float_prop(1.0)
    weight = config.str_prop("natural")
    scaled = config.bool_prop(False)
    include_auto = config.bool_prop(False)
    save_dirty_beam = config.bool_prop(False)
    precision = config.enum([32, 64], default=64)

    def process(self, gstream):
        gstream.redistribute("freq")
        vis = gstream.vis[:]  # [pol, f, ew, ns, ra]
        gsw = gstream.weight[:]
        dev = vis.device
        npol, nfreq, new, nns, nra = vis.shape

        el = self.span * np.linspace(-1.0, 1.0, self.npix)
        hv = containers.HybridVisStream(el=el, axes_from=gstream, attrs_from=gstream)
        if self.save_dirty_beam:
            hv.add_dataset("dirty_beam")

        nspos = gstream.index_map["ns"][:]
        freq = gstream.freq
        iwv = (freq * 1e6) / C_LIGHT  # [f]

        baselines_present = (gsw.amax(dim=(0, 1, 2, 4)) > 0).cpu().numpy()
        nsmax = np.abs(nspos[baselines_present]).max() if baselines_present.sum() > 0 else 0.0
        self.log.info(f"Longest NS separation: {nsmax:.2f} m")

        hv.attrs.update(
            beamform_ns_weight=self.weight,
            beamform_ns_scaled=self.scaled,
            beamform_ns_include_auto=self.include_auto,
            beamform_ns_freqmin=freq.min(),
            beamform_ns_nsmax=nsmax,
        )

        rdt = torch.float32 if self.precision == 32 else torch.float64
        if self.weight == "natural":
            if "redundancy" not in gstream.datasets:
                raise RuntimeError(
                    "Must set save_redundancy = True for task MakeVisGrid in order to use a natural weight scheme."
                )
            red = gstream.datasets["redundancy"][:].to(rdt)  # [pol, ew, ns, ra]
        elif self.weight != "inverse_variance":
            vpos = nspos[np.newaxis, :] * iwv[:, np.newaxis]  # [f, ns]
            vmax = nsmax * iwv.min() if self.scaled else nsmax * iwv[:, np.newaxis]
            x = 0.5 * (vpos / vmax + 1)
            ns_weight = window_generalised(x, window=self.weight).to(device=dev, dtype=rdt)

        # phase angles [el, ns], made in float64 on the host as the JAX package does
        phase = torch.as_tensor(2.0 * np.pi * nspos[np.newaxis, :] * el[:, np.newaxis], dtype=rdt, device=dev)
        iwv_t = torch.as_tensor(iwv, dtype=rdt, device=dev)

        for f0, f1 in axis_blocks(nfreq, npol * new * nns * nra):
            w = gsw[:, f0:f1].to(rdt)
            if self.weight == "inverse_variance":
                gw = w
            elif self.weight == "natural":
                gw = red[:, None].expand(w.shape)
            else:
                gw = (w > 0) * ns_weight[None, f0:f1, None, :, None]
            gw = gw * (w > 0)
            if not self.include_auto:
                gw[..., 0, 0, :] = 0.0
            gw = gw * invert_no_zero(gw.sum(dim=-2))[..., None, :]

            ang = phase[None] * iwv_t[f0:f1, None, None]  # [fb, el, ns]
            F = torch.complex(torch.cos(ang), -torch.sin(ang))
            gvw = (vis[:, f0:f1].to(F.dtype) * gw).transpose(0, 1)  # [fb, pol, ew, ns, ra]
            hvv = torch.matmul(F[:, None, None], gvw)  # [fb, pol, ew, el, ra]
            hv.vis[:, f0:f1] = hvv.transpose(0, 1)
            del gvw, hvv
            if self.save_dirty_beam:
                # the real part of F @ gw
                hvb = torch.matmul(F.real[:, None, None], gw.transpose(0, 1))
                hv.dirty_beam[:, f0:f1] = hvb.transpose(0, 1)
            t = (invert_no_zero(w) * gw**2).sum(dim=-2)
            hv.weight[:, f0:f1] = invert_no_zero(t)
        return hv


class BeamformEW(ContainerTask):
    """Final EW beamforming: pol rotation + irfft over EW.

    (reference ringmapmaker.py:356-531), in blocks of frequency in
    complex128 on the hybrid stream's device.
    """

    exclude_intracyl = config.bool_prop(False)
    single_beam = config.bool_prop(False)
    weight_ew = config.enum(["natural", "uniform"], default="natural")
    flag_ew = config.list_prop(None)

    @staticmethod
    def _get_pol(pols):
        """Output polarisations + rotation matrix (reference :500-531)."""
        have_cross = {"XY", "YX"} & set(pols)
        if len(have_cross) == 1:
            raise ValueError(f"Cross-polarisations must come as an XY/YX pair; found {pols}.")
        dpol = (["XX"] if "XX" in pols else []) + (["reXY", "imXY"] if have_cross else [])
        if "YY" in pols:
            dpol.append("YY")

        # rotation: identity on co-pol rows, re/im split on the cross pair
        P = np.eye(len(dpol), dtype=np.complex64)
        if have_cross:
            i = dpol.index("reXY")
            P[i, i : i + 2] = [0.5, 0.5]
            P[i + 1, i : i + 2] = [-0.5j, 0.5j]
        return np.array(dpol, dtype="U4"), P

    def _ew_column_weights(self, n_ew):
        """Normalised per-EW-separation weights for the final transform."""
        w = np.ones(n_ew) if self.weight_ew == "uniform" else n_ew - np.arange(n_ew, dtype=np.float64)
        if self.exclude_intracyl:
            w[0] = 0.0
        if self.flag_ew is not None:
            if len(self.flag_ew) != n_ew:
                raise ValueError(
                    f"flag_ew has {len(self.flag_ew)} entries but the stream has {n_ew} EW separations."
                )
            w *= np.asarray(self.flag_ew, dtype=bool)
        if self.single_beam:
            # both fringe signs of every non-intracylinder column fold
            # into the single synthesized beam
            w[1:] *= 2
        return w / w.sum()

    def process(self, hstream):
        hstream.redistribute("freq")
        vis = hstream.vis[:]  # [pol, f, ew, el, ra]
        dev = vis.device
        npol, nfreq, n_ew, nel, nra = vis.shape
        nbeam = 1 if self.single_beam else 2 * n_ew - 1
        pol, P = self._get_pol(_pol_names(hstream.index_map["pol"]))
        Pt = torch.as_tensor(P, dtype=torch.complex128, device=dev)
        wew = torch.as_tensor(self._ew_column_weights(n_ew), dtype=torch.float64, device=dev)

        save_dirty_beam = "dirty_beam" in hstream.datasets
        rm = containers.RingMap(beam=np.arange(nbeam), pol=pol, axes_from=hstream, attrs_from=hstream)
        rm.add_dataset("rms")
        if save_dirty_beam:
            rm.add_dataset("dirty_beam")

        def form(x):
            """[pol_in, fb, ew, el, ra] -> beams [beam, pol, fb, ra, el]."""
            v = torch.tensordot(Pt, x.to(torch.complex128), dims=([1], [0])) * wew[None, None, :, None, None]
            if self.single_beam:
                b = v.real.sum(dim=2, keepdim=True)
            else:
                b = torch.fft.irfft(v, n=nbeam, dim=2) * nbeam
            return b.permute(2, 0, 1, 4, 3)

        for f0, f1 in axis_blocks(nfreq, npol * n_ew * nel * nra):
            rm.map[:, :, f0:f1] = form(vis[:, f0:f1])
            if save_dirty_beam:
                rm.dirty_beam[:, :, f0:f1] = form(hstream.dirty_beam[:, f0:f1])

        P2 = Pt.abs() ** 2
        var = torch.tensordot(P2, invert_no_zero(hstream.weight[:].to(torch.float64)), dims=([1], [0]))
        rm_var = 0.5 * ((wew**2)[None, None, :, None] * var).sum(dim=2)  # [pol, f, ra]
        inv = torch.where(rm_var > 0, 1.0 / torch.where(rm_var > 0, rm_var, 1.0), 0.0)
        rm.datasets["weight"][:] = inv[..., None].expand(rm.datasets["weight"].shape)
        rm.datasets["rms"][:] = rm_var.sqrt()
        return rm


class RingMapMaker(group_tasks(MakeVisGrid, BeamformNS, BeamformEW)):
    """Make a ringmap from a sidereal stream (reference ringmapmaker.py:534)."""


def _deconvolve_core(hv, bv, jw, inv_var, jwin, eps, skip_deconvolution: bool, nra: int, iref: int):
    """The m-space deconvolution of one block of frequencies, in complex128.

    hv, bv [m, msign, pol, f, ew, el]; jw [m, msign, pol, f, ew, 1] the EW
    averaging weights; inv_var the same shape; jwin [m or 1, 1, f, el or 1]
    the window; eps [m or 1, 1, f, 1] the regulariser.  Returns (map [pol,
    f, ra, el], dirty-beam power [pol, f, el], dirty beam [pol, f, ra, el],
    weight [pol, f, el]).  The map is normalised so that the dirty beam's
    m-space mean, its value at transit, is 1: a point source of unit flux
    reads 1 at its pixel.
    """
    jb = bv.to(torch.complex128)
    jh = hv.to(torch.complex128)
    nm = hv.shape[0]

    # Sum over (msign, ew) -> [m, pol, freq, el]
    sum_weight = (jw * jb.abs() ** 2).sum(dim=(1, -2))
    C_inv = torch.ones_like(sum_weight) if skip_deconvolution else eps + sum_weight
    inv_C = invert_no_zero(C_inv)

    map_m = jwin * (jb.conj() * jw * jh).sum(dim=(1, -2)) * inv_C
    dirty_beam_m = jwin * sum_weight * inv_C

    # Normalisation: dirty beam at transit; [pol, freq, el]
    norm = invert_no_zero(dirty_beam_m.mean(dim=0))
    if skip_deconvolution:
        norm = norm[:, :, iref, None]

    def to_ra(x):
        # [m, pol, freq, el] -> [pol, freq, ra, el]
        xr = torch.fft.irfft(x.movedim(0, -1).to(torch.complex128), n=nra, dim=-1)
        return xr.movedim(-1, 2)

    map_ra = to_ra(map_m) * norm[:, :, None, :]
    dirty_beam_ra = to_ra(dirty_beam_m) * norm[:, :, None, :]
    db_power = (dirty_beam_ra**2).sum(dim=2) / nra

    # Noise propagation (reference ringmapmaker.py:801-823): ordering
    # chosen to avoid overflow as the NS beam drops to zero
    var = invert_no_zero(inv_var)
    sigma = (((jw * jb.abs()) ** 2) * var).sum(dim=(1, -2)).sqrt()
    sum_var_map_m = 0.5 * ((sigma * jwin * norm[None] * invert_no_zero(nm * C_inv)) ** 2).sum(dim=0)
    return map_ra, db_power, dirty_beam_ra, invert_no_zero(sum_var_map_m)


class DeconvolveHybridMBase(ContainerTask):
    """Base class for deconvolving ringmap makers (reference ringmapmaker.py:538).

    The deconvolution, normalisation, dirty beam and noise propagation of
    :func:`_deconvolve_core` run over all (m, pol, el) of a block of
    frequencies at once, with one batched irfft back to RA.

    Attributes
    ----------
    exclude_cyl : list of int
        Cylinder separations to exclude (0 = intracylinder, ...).
    exclude_intracyl : bool
        Deprecated alias for ``exclude_cyl = [0]``.
    skip_deconvolution : bool
        Skip the transfer-function deconvolution.
    reference_declination : float
        Flux normalisation declination when skipping deconvolution.
    save_dirty_beam : bool
        Store the EW synthesized beam per declination.
    window_type, window_size, window_scaled
        Optional window shaping the EW synthesized beam.
    """

    exclude_cyl = config.list_type(int, maxlength=3, default=[])
    exclude_intracyl = config.bool_prop(False)
    skip_deconvolution = config.bool_prop(False)
    reference_declination = config.float_prop(None)
    save_dirty_beam = config.bool_prop(False)

    window_type = config.enum(
        ["none", "uniform", "hann", "hanning", "hamming", "blackman", "nuttall", "blackman_nuttall",
         "blackman_harris"],
        default="none",
    )
    window_size = config.float_prop(1.0)
    window_scaled = config.bool_prop(False)

    def setup(self, manager=None):
        """Set the telescope instance (needed for windows / normalisation)."""
        self.telescope = None if manager is None else io.get_telescope(manager)
        if self.telescope is None and self.window_type != "none":
            raise RuntimeError("Applying a window requires a product manager at setup.")

        dropped = set(self.exclude_cyl)
        if self.exclude_intracyl:
            dropped.add(0)
        self.exclude_cyl = sorted(dropped)

    def process(self, hybrid_vis_m, hybrid_beam_m):
        """Deconvolve the beam m-modes from the visibility m-modes."""
        for axis, get in [
            ("freq", lambda c: np.asarray(c.freq)),
            ("el", lambda c: np.asarray(c.index_map["el"])),
            ("ew", lambda c: np.asarray(c.index_map["ew"])),
            ("pol", lambda c: np.asarray(c.index_map["pol"])),
        ]:
            if not np.array_equal(get(hybrid_vis_m), get(hybrid_beam_m)):
                raise ValueError(f"{axis} does not match for beam and visibilities.")
        if hybrid_vis_m.mmax > hybrid_beam_m.mmax:
            raise ValueError("The beam model's m range is too small for these visibilities")

        freq = np.asarray(hybrid_vis_m.freq)
        m = np.asarray(hybrid_vis_m.index_map["m"])
        mmax = hybrid_vis_m.mmax
        nra = 2 * mmax + int(hybrid_vis_m.oddra)

        rm = containers.RingMap(beam=1, ra=nra, axes_from=hybrid_vis_m, attrs_from=hybrid_vis_m)
        rm.add_dataset("dirty_beam_power")
        if self.save_dirty_beam:
            rm.add_dataset("dirty_beam")

        rm.attrs["exclude_cyl"] = self.exclude_cyl
        if hasattr(self, "weight_ew"):
            rm.attrs["weight_ew"] = self.weight_ew

        hv = hybrid_vis_m.vis[:]  # [m, msign, pol, freq, ew, el]
        dev = hv.device
        nm, _, npol, nfreq, new, nel = hv.shape

        # Window over (freq, m, el) as [nm, 1(pol), nfreq, nel], float32 values as in the JAX package
        if self.window_type != "none":
            window = self._get_window(hybrid_vis_m)  # [nfreq, nm, nel]
            win = np.moveaxis(window, 0, 1)[:, np.newaxis, :, :]
        else:
            win = np.ones((1, 1, nfreq, 1), dtype=np.float32)
        win = torch.as_tensor(win, device=dev).to(torch.float64)

        iref = 0
        if self.skip_deconvolution:
            el = np.asarray(rm.index_map["el"])
            if self.reference_declination is None:
                iref = int(np.argmin(np.abs(el)))
                self.log.info("Map normalisation referenced to zenith.")
            else:
                dec = np.degrees(np.arcsin(el)) + self.telescope.latitude
                iref = int(np.argmin(np.abs(dec - self.reference_declination)))
                self.log.info(f"Map normalisation referenced to declination {dec[iref]:0.2f} deg.")
            eps = np.zeros((1, 1, nfreq, 1))
        else:
            # [nm, 1(pol), nfreq, 1(el)]
            eps = np.stack(
                [np.broadcast_to(np.asarray(self._get_regularisation(f, m), dtype=float), (m.size, 1, 1)) for f in freq],
                axis=2,
            )
        eps = torch.as_tensor(np.ascontiguousarray(eps), dtype=torch.float64, device=dev)

        bv = hybrid_beam_m.vis[:][: (mmax + 1)]
        inv_var = hybrid_vis_m.weight[:].to(torch.float64)[..., None]  # [m, msign, pol, freq, ew, 1]
        weight = self._get_weight(inv_var) * (inv_var > 0.0)

        for f0, f1 in axis_blocks(nfreq, nm * 2 * npol * new * nel):
            fs = slice(f0, f1)
            map_ra, db_power, dirty_beam_ra, weight_out = _deconvolve_core(
                hv[:, :, :, fs],
                bv[:, :, :, fs],
                weight[:, :, :, fs],
                inv_var[:, :, :, fs],
                win[:, :, fs],
                eps[:, :, fs],
                self.skip_deconvolution,
                nra,
                iref,
            )
            rm.map[0, :, fs] = map_ra
            rm.dirty_beam_power[0, :, fs] = db_power
            if self.save_dirty_beam:
                rm.dirty_beam[0, :, fs] = dirty_beam_ra
            rm.weight[:, fs] = weight_out[:, :, None, :].expand(-1, -1, nra, -1)
        return rm

    def _get_window(self, hybrid_vis_m):
        """EW-sensitivity window over (freq, m, el) (reference :827-923); host numpy."""
        msg = "scaled" if self.window_scaled else "fixed-width"
        self.log.info(
            f"NS apodisation: {self.window_type} window, frequency-{msg}, relative width {self.window_size}."
        )

        freq = np.asarray(hybrid_vis_m.freq)
        m = np.asarray(hybrid_vis_m.index_map["m"])
        el = np.asarray(hybrid_vis_m.index_map["el"])

        ew = np.array([x for i, x in enumerate(np.asarray(hybrid_vis_m.index_map["ew"])) if i not in self.exclude_cyl])

        nlocal = freq.size

        dec = np.arcsin(el[np.newaxis, :]) + np.radians(self.telescope.latitude)
        lmbda = C_LIGHT / (freq[:, np.newaxis] * 1e6)

        ews = np.sort(np.abs(ew))
        # pad the band edge by half the outermost column spacing
        pad = 0.5 * (ews[-1] - ews[-2]) if len(ews) > 1 else 0.5 * max(ews[-1], 1.0)
        hi_ew = ews[-1] + pad
        positive = ews[ews > 0.0]
        lo_ew = 0.5 * positive[0] if np.min(ews) > 0.0 else -hi_ew

        centre_ew = 0.5 * (lo_ew + hi_ew)
        half_band = 0.5 * self.window_size * (hi_ew - lo_ew)

        ew_to_m = 2.0 * np.pi * np.abs(np.cos(dec)) / lmbda
        min_m = ew_to_m * (centre_ew - half_band)
        max_m = ew_to_m * (centre_ew + half_band)

        if self.window_scaled:
            min_m = np.max(min_m, axis=0, keepdims=True)
            max_m = np.min(max_m, axis=0, keepdims=True)

        # normalised coordinate u in [0, 1] inside the band, zero outside
        lo = min_m[:, np.newaxis, :]  # [freq, 1, el]
        hi = max_m[:, np.newaxis, :]
        mm = m[np.newaxis, :, np.newaxis].astype(float)
        span = hi - lo
        u = np.clip((mm - lo) * _host_inverse(span), 0.0, 1.0)
        inside = (mm >= lo) & (mm <= hi)
        window = (window_generalised(u, window=self.window_type).numpy() * inside).astype(np.float32)

        if self.window_scaled:
            window = np.repeat(window, nlocal, axis=0)

        return window

    def _get_weight(self, inv_var):
        """EW-baseline averaging weights (subclass responsibility)."""
        raise NotImplementedError(f"{self.__class__} is abstract: implement _get_weight.")

    def _get_regularisation(self, freq, m):
        """Deconvolution regulariser (subclass responsibility)."""
        raise NotImplementedError(f"{self.__class__} is abstract: implement _get_regularisation.")


class DeconvolveAnalyticalBeam(DeconvolveHybridMBase):
    """Deconvolve an analytic (driftscan-style) beam model.

    (reference ringmapmaker.py:968-1072).  The beam's m-modes are made on
    the device, in blocks of frequency, with :func:`~draco_tpu_torch.ops.mmode.make_marray`.
    """

    telescope = None

    def setup(self, telescope):
        """Set the telescope object (base-class cylinder exclusion)."""
        super().setup(telescope)

    def process(self, hybrid_vis_m):
        """Compute the analytic beam m-modes, then deconvolve."""
        hybrid_beam_m = self._get_beam_mmodes(hybrid_vis_m)
        return super().process(hybrid_vis_m, hybrid_beam_m)

    #: EW voltage beam width prefactors per feed polarisation, in
    #: MHz-degrees-of-sigma units (CHIME-like fits)
    _EW_SIGMA_PREFACTOR = {"X": 14.87857614, "Y": 9.95746878}

    def _get_beam_mmodes(self, hybrid_vis_m):
        mmax = hybrid_vis_m.mmax
        nra = 2 * mmax + int(hybrid_vis_m.oddra)
        freqs = np.asarray(hybrid_vis_m.freq)
        ewpos = np.asarray(hybrid_vis_m.index_map["ew"])
        dec = np.arcsin(np.asarray(hybrid_vis_m.index_map["el"])) + np.radians(self.telescope.latitude)
        pol = _pol_names(hybrid_vis_m.index_map["pol"])

        # Per-(pol, freq, el) Gaussian width: the product pair's sigmas
        # combine as sig_a sig_b / sqrt(sig_a^2 + sig_b^2)
        base = np.array([[self._EW_SIGMA_PREFACTOR[c] for c in p] for p in pol])  # [pol, 2]
        per_fd = 1.0 / (freqs[:, None] * np.cos(dec)[None, :])  # [freq, el]
        sa, sb = (base[:, i, None, None] * per_fd[None] for i in (0, 1))  # each [pol, freq, el]
        sigma = sa * sb / np.hypot(sa, sb)

        phi = np.radians(np.linspace(0.0, 360.0, nra, endpoint=False))
        taper_arg = -0.5 * (2 * np.tan(phi / 2)) ** 2  # [ra]
        u = ewpos[None, :] * (freqs[:, None] * 1e6 / C_LIGHT)  # [freq, ew]

        hybrid_beam_m = containers.empty_like(hybrid_vis_m)
        bvis = hybrid_beam_m.vis[:]
        dev = bvis.device

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=dev)

        sigma, taper_arg, u, cosdec, sinphi = t(sigma), t(taper_arg), t(u), t(np.cos(dec)), t(np.sin(phi))

        # beam[p, f, x, e, r] = EW fringe at projected baseline u cos(dec)
        # times a Gaussian envelope in tan(phi/2)
        npol, new, nel = len(pol), ewpos.size, dec.size
        for f0, f1 in axis_blocks(freqs.size, npol * new * nel * nra):
            fs = slice(f0, f1)
            envelope = torch.exp(taper_arg / sigma[:, fs, None, :, None] ** 2)  # [pol, f, 1, el, ra]
            arg = 2.0 * np.pi * u[fs, :, None, None] * cosdec[None, None, :, None] * sinphi
            fringe = torch.polar(torch.ones_like(arg), arg)  # [f, ew, el, ra]
            beam = fringe[None] * envelope  # [pol, f, ew, el, ra]
            bvis[:, :, :, fs] = mmode.make_marray(beam.conj(), mmax=mmax)  # -> [m, msign, pol, f, ew, el]
            del envelope, arg, fringe, beam
        return hybrid_beam_m


class TikhonovRingMapMaker(DeconvolveHybridMBase):
    """Tikhonov-regularised deconvolving map maker.

    (reference ringmapmaker.py:1075)

    Attributes
    ----------
    weight_ew : "natural" | "uniform" | "inverse_variance"
        EW baseline weighting.
    inv_SN : float
        Regularisation parameter.
    """

    weight_ew = config.enum(["natural", "uniform", "inverse_variance"], default="natural")
    inv_SN = config.float_prop(1e-6)

    def _get_weight(self, inv_var):
        return _sum_normalised(_ew_weighting(self.weight_ew, inv_var, self.exclude_cyl))

    def _get_regularisation(self, *args):
        return self.inv_SN


class WienerRingMapMaker(DeconvolveHybridMBase):
    """Wiener-regularised deconvolving map maker.

    (reference ringmapmaker.py:1123).  The regulariser is the inverse of a
    power-law prior for galactic + point source emission.

    Attributes
    ----------
    gal_amp, gal_alpha, gal_beta : float
        Galactic synchrotron m-mode prior (amplitude, freq and m slopes).
    psrc_amp, psrc_alpha : float
        Point source prior.
    """

    gal_amp = config.float_prop(1.41)
    gal_alpha = config.float_prop(-1.75)
    gal_beta = config.float_prop(-0.75)

    psrc_amp = config.float_prop(0.045)
    psrc_alpha = config.float_prop(-1.0)

    pivot_freq = 600.0
    weight_ew = "inverse_variance"

    def _get_regularisation(self, freq, m, *args):
        nu = freq / self.pivot_freq
        m_slope = np.where(m > 0.0, m, 1.0) ** self.gal_beta
        gal = self.gal_amp * nu**self.gal_alpha * m_slope
        psrc = self.psrc_amp * nu**self.psrc_alpha
        prior = gal**2 + psrc**2
        return _host_inverse(prior)[:, np.newaxis, np.newaxis]

    def _get_weight(self, inv_var):
        return _ew_weighting("inverse_variance", inv_var, self.exclude_cyl)


class TikhonovRingMapMakerAnalytical(DeconvolveAnalyticalBeam, TikhonovRingMapMaker):
    """Tikhonov deconvolution of the analytical beam model."""


class WienerRingMapMakerAnalytical(DeconvolveAnalyticalBeam, WienerRingMapMaker):
    """Wiener deconvolution of the analytical beam model."""


# Aliases to support old names
TikhonovRingMapMakerExternal = TikhonovRingMapMaker
WienerRingMapMakerExternal = WienerRingMapMaker


class RADependentWeights(ContainerTask):
    """Restore the RA dependence of deconvolved ring-map weights.

    (reference ringmapmaker.py:1202).  The m-mode round trip loses the RA
    dependence of the noise; it is reconstructed from the hybrid
    visibility weights, on their device.
    """

    def process(self, hybrid_vis, ringmap):
        """Scale the ringmap weights by the hybrid weights' RA dependence."""
        exclude_cyl = ringmap.attrs.get("exclude_cyl", None)
        weight_scheme = ringmap.attrs.get("weight_ew", None)

        if (exclude_cyl is None) or (weight_scheme is None):
            raise RuntimeError(
                "Reconstructing the noise RA dependence needs the ring-map maker's `weight_ew`/`exclude_cyl` "
                "settings stored in the container attributes; they are missing here."
            )

        save_filter = False
        for dset in ["filter", "complex_filter"]:
            if dset in hybrid_vis.datasets:
                ringmap.add_dataset(dset)
                save_filter = True

        save_cov = False
        if weight_scheme != "inverse_variance":
            for dset in ["freq_cov", "complex_freq_cov"]:
                if dset in hybrid_vis.datasets:
                    ringmap.add_dataset(dset)
                    save_cov = True

        var = invert_no_zero(hybrid_vis.weight[:].to(torch.float64))  # [pol, freq, ew, ra]
        var_time_avg = var.mean(dim=-1, keepdim=True)

        weight_ew = _ew_weighting(
            weight_scheme,
            invert_no_zero(var_time_avg) if weight_scheme == "inverse_variance" else var,
            exclude_cyl,
        )

        ra_dependence = (weight_ew**2 * var_time_avg).sum(dim=-2) * invert_no_zero((weight_ew**2 * var).sum(dim=-2))
        ringmap.weight[:] = ringmap.weight[:] * ra_dependence[..., None]

        if save_filter:
            filt = hybrid_vis.filter[:]  # [pol, freq, freq_sum, ew, ra]
            wew = _sum_normalised(weight_ew)[:, :, None]
            ringmap.filter[:] = (wew * filt).sum(dim=-2)

        if save_cov:
            cov = hybrid_vis.freq_cov[:]
            wew = weight_ew.squeeze()
            wew2 = wew[:, None] ** 2 * invert_no_zero(wew.sum() ** 2)
            ringmap.freq_cov[:] = (wew2 * cov).sum(dim=-2)

        return ringmap


class ReconstructVisNoiseBase(TelescopeStreamMixIn, ContainerTask):
    """Base for reconstructing visibility noise statistics.

    (reference ringmapmaker.py:1318).  Reproduces the statistical
    properties of hybrid beamformed visibilities (weights or freq-freq
    covariance) from the baseline layout and beamforming window.  The
    layout and window are host numpy; the output is made on the hybrid
    stream's device.
    """

    def process(self, hv):
        """Build the noise-statistics container for ``hv``."""
        self._parse_attrs(hv.attrs)
        freq = np.asarray(hv.freq)
        layout = self._compute_layout(hv)
        window = self._compute_window(freq, layout)
        return self._fill_output(hv, window, layout)

    def _parse_attrs(self, attrs):
        for name in ("weight", "scaled", "include_auto", "freqmin", "nsmax"):
            setattr(self, name, attrs[f"beamform_ns_{name}"])
        if self.weight == "inverse_variance":
            raise ValueError("The inverse_variance weighting mode has no RA reconstruction.")
        self.wvmin = C_LIGHT * 1e-6 / self.freqmin

    def _compute_layout(self, hv):
        """Baseline grid layout + redundancy (reference :1375-1463)."""
        tel = self.telescope
        out_pol = _pol_names(hv.index_map["pol"])
        npol = len(out_pol)

        # map each unique pair's polarisation product onto the output
        # pol axis; pairs whose product isn't in the output get -1
        pair_pols = tel.polarisation[tel.uniquepairs]
        labels, inverse = np.unique(np.char.add(pair_pols[:, 0], pair_pols[:, 1]), return_inverse=True)
        slot = {name: i for i, name in enumerate(out_pol)}
        pol_of_pair = np.array([slot.get(p, -1) for p in labels[inverse]])

        xind, yind, min_xsep, min_ysep = find_grid_indices(tel.baselines)
        ns_extent = np.abs(yind) * min_ysep
        within_ns = ns_extent <= self.nsmax + 0.5 * min_ysep

        ny = 2 * np.abs(yind).max() + 1
        nspos = _ns_fft_axis(ny, min_ysep)

        ewpos = np.asarray(hv.index_map["ew"])
        nx = ewpos.size
        full_x = np.arange(np.abs(xind).max() + 1) * min_xsep
        if not np.allclose(full_x, ewpos):
            raise RuntimeError("A truncated ew axis cannot be processed here.")

        keep = (pol_of_pair >= 0) & within_ns
        xind, yind, pind = xind[keep], yind[keep], pol_of_pair[keep]

        pconjmap = np.unique([p[1] + p[0] for p in out_pol], return_inverse=True)[1]

        input_flags = np.all(tel.feedmask, axis=-1, keepdims=True)
        nbaseline = calculate_redundancy(
            torch.as_tensor(input_flags.astype(np.float32)),
            np.stack([self.bt_prod["input_a"], self.bt_prod["input_b"]], axis=-1),
            self.bt_rev["stack"],
            len(self.bt_stack),
        ).numpy()[:, 0].astype(np.float64)
        kept_counts = nbaseline[keep]

        counts_grid = np.zeros((npol, nx, ny), dtype=float)
        counts_grid[pind, np.abs(xind), yind] = kept_counts
        intra = np.flatnonzero(xind == 0)
        counts_grid[pconjmap[pind[intra]], 0, -yind[intra]] = kept_counts[intra]

        return dict(
            xind=xind, yind=yind, pind=pind, ewpos=ewpos, nspos=nspos, nbaseline_grid=counts_grid,
            nbaseline=nbaseline, flag=keep, pconjmap=pconjmap, npol=npol, nx=nx, ny=ny,
        )

    def _compute_window(self, freq, layout):
        """Normalised NS beamforming window (reference :1465-1506); host numpy."""
        nfreq = freq.size
        window = np.empty((layout["npol"], nfreq, layout["nx"], layout["ny"]), dtype=float)

        if self.weight == "natural":
            window[:] = layout["nbaseline_grid"][:, np.newaxis]
        else:
            # [nfreq, ny] fringe coordinates in wavelengths, folded into
            # the window's [0, 1] argument; broadcast over (pol, ew)
            per_wv = freq * 1e6 / C_LIGHT
            vpos = layout["nspos"][np.newaxis, :] * per_wv[:, np.newaxis]
            vmax = self.nsmax * ((1.0 / self.wvmin) if self.scaled else per_wv[:, np.newaxis])
            arg = 0.5 * (vpos / vmax + 1)
            window[:] = window_generalised(arg, window=self.weight).numpy()[np.newaxis, :, np.newaxis, :]

        if not self.include_auto:
            # as BeamformNS: the (ew=0, ns=0) auto sample is excluded unless
            # include_auto is set (the JAX package's deliberate deviation
            # from the reference's reconstructor, ringmapmaker.py:1140-1147)
            window[:, :, 0, 0] = 0.0

        return window * _host_inverse(np.sum(window, axis=-1, keepdims=True))

    def _fill_output(self, hv, window, layout):
        raise NotImplementedError("abstract: subclasses define _fill_output.")


def _host_inverse(x):
    """``invert_no_zero`` of a host array, as a host array."""
    return invert_no_zero(torch.as_tensor(np.asarray(x))).numpy()


class ReconstructVisWeight(ReconstructVisNoiseBase):
    """SiderealStream weights reproducing hybrid beamformed weights.

    (reference ringmapmaker.py:1517).  Output visibilities are zero; the
    weights beamform back to the input container's weights.
    """

    def _fill_output(self, hv, window, layout):
        ss = containers.SiderealStream(
            axes_from=hv,
            attrs_from=hv,
            input=self.telescope.input_index,
            prod=self.bt_prod,
            stack=self.bt_stack,
            reverse_map_stack=self.bt_rev,
        )
        dev = ss.device

        noise_factor = np.sum(window**2 * _host_inverse(layout["nbaseline_grid"][:, np.newaxis]), axis=-1)
        w0 = hv.weight[:].to(torch.float64) * torch.as_tensor(noise_factor, device=dev)[..., None]  # [pol, f, ew, ra]

        kept = torch.as_tensor(np.flatnonzero(layout["flag"]), device=dev)
        counts = torch.as_tensor(layout["nbaseline"][layout["flag"]], device=dev)
        pind = torch.as_tensor(layout["pind"], device=dev)
        xabs = torch.as_tensor(np.abs(layout["xind"]), device=dev)
        gathered = w0[pind, :, xabs, :].transpose(0, 1)  # [f, nkept, ra]
        wss = torch.zeros(ss.weight.shape, dtype=torch.float64, device=dev)
        wss[:, kept] = counts[None, :, None] * gathered
        ss.weight[:] = wss
        return ss


class ReconstructVisFreqCov(ReconstructVisNoiseBase):
    """Cholesky factors of the freq-freq covariance per (pol, ew, ra).

    (reference ringmapmaker.py:1604).  The per-(pol, ew, ra) masked
    Cholesky loop is one batched ``cholesky_ex`` on the stream's device,
    with masked channels padded to the identity; a factorisation that
    fails raises.
    """

    def _fill_output(self, hv, window, layout):
        out = containers.FreqNoiseModel(axes_from=hv, attrs_from=hv, ns=layout["nspos"])
        dataset_name = "complex_freq_cov" if "complex_freq_cov" in hv.datasets else "freq_cov"
        out.add_dataset(dataset_name)
        out.redundancy[:] = torch.as_tensor(layout["nbaseline_grid"])

        inv_nb = _host_inverse(layout["nbaseline_grid"][:, np.newaxis])
        # Noise factor (pol, freq, freq_sum, ew)
        noise_factor = np.einsum("pfxn,pgxn->pfgx", window * np.sqrt(inv_nb), window * np.sqrt(inv_nb))

        cov_in = hv.freq_cov[:]  # [pol, freq, freq_sum, ew, ra]
        dev = cov_in.device
        inv_noise_factor = invert_no_zero(torch.as_tensor(noise_factor, device=dev))
        nfreq = cov_in.shape[1]

        # Normalised covariances, batched: [pol, ew, ra, freq, freq]
        C_all = (cov_in * inv_noise_factor[..., None]).movedim((1, 2), (-2, -1))
        M = (hv.weight[:] > 0.0).movedim(1, -1).to(C_all.real.dtype)  # [pol, ew, ra, f]
        M2 = M[..., :, None] * M[..., None, :]

        eye = torch.eye(nfreq, dtype=C_all.real.dtype, device=dev)
        B = C_all * M2 + eye * (1.0 - M[..., None, :] * eye)
        L, info = torch.linalg.cholesky_ex(B)
        failed = int((info != 0).sum())
        if failed:
            raise RuntimeError(
                f"ReconstructVisFreqCov: the Cholesky factorisation failed for {failed} of {info.numel()} "
                "(pol, ew, ra) covariances"
            )
        out.freq_cov[:] = L * M2

        diag = torch.diagonal(C_all, dim1=-2, dim2=-1) * M  # [pol, ew, ra, f]
        out.weight[:] = invert_no_zero(diag).movedim(-1, 1)
        return out
