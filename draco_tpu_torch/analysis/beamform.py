"""Beamform visibilities at source locations.

Port of ``draco_tpu.analysis.beamform``, which re-provides reference
``draco/analysis/beamform.py`` (BeamFormBase:32, BeamForm:668,
BeamFormCat:710, BeamFormExternal(Mixin):752-908, RingMapBeamForm:915,
RingMapStack2D:1097, HybridVisBeamForm:1305, FitBeamFormed:1489,
HealpixBeamForm:1676, icrs_to_cirs:1773).

The fringestop + weighted product sum (the Cython ``beamform``, reference
draco/util/_fast_tools.pyx:211) runs on the data's device through
:mod:`draco_tpu_torch.ops.interferometry`, whose contraction is the
hand-written CUDA kernel ``csrc/beamform.cu`` on the card.  The catalogue,
window and primary-beam bookkeeping is host numpy, as in the JAX package;
the primary beam of the whole catalogue is evaluated in one ``beam_at`` call
per (feed, frequency) where the JAX package calls it per source.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.task import ContainerTask
from ..ops import healpix, tools
from ..ops.interferometry import (
    beamform_kernel,
    beamform_sources_batched,
    beamform_sources_batched_ha,
    fringestop_phase,
)
from ..ops.tools import invert_no_zero
from .sidereal import _search_nearest

C = 299792458.0
NU21 = 1420.405751768
SIDEREAL_S = 86164.0905 / 86400.0

# time samples a block when counting the stacks' redundancy
_REDUNDANCY_BLOCK = 1 << 28


def icrs_to_cirs(ra, dec, epoch, apparent=True):
    """Convert ICRS to CIRS coordinates at the given epoch.

    (reference beamform.py:1773) — the JAX package's rigid first-order
    precession of the equatorial pole (the reference uses skyfield),
    copied as it is.
    """
    # Julian years since J2000
    T = (np.asarray(epoch, dtype=np.float64) - 946728000.0) / (365.25 * 86400.0)
    # General precession in RA/Dec (first order, arcsec/yr -> deg)
    ra = np.asarray(ra, dtype=np.float64)
    dec = np.asarray(dec, dtype=np.float64)
    m = 3.075 * 15 / 3600.0  # deg per year
    n = 20.043 / 3600.0  # deg per year
    ra_c = ra + T * (m + n * np.sin(np.radians(ra)) * np.tan(np.radians(dec)))
    dec_c = dec + T * n * np.cos(np.radians(ra))
    return ra_c % 360.0, dec_c


class BeamFormBase(ContainerTask):
    """Base class for beamforming tasks (reference beamform.py:32).

    See the reference docstring for the attribute list (collapse_ha,
    polarization, weight, no_beam_model, timetrack, variable_timetrack,
    freqside); semantics are preserved.  The visibilities and weights of
    each processed polarisation are held on the data's device as complex64
    and float32 [freq, ra, product] (the layout the kernel reads).
    """

    collapse_ha = config.bool_prop(True)
    polarization = config.enum(["I", "full", "copol", "stokes"], default="full")
    weight = config.enum(["natural", "uniform", "inverse_variance"], default="natural")
    no_beam_model = config.bool_prop(False)
    timetrack = config.float_prop(900.0)
    variable_timetrack = config.bool_prop(False)
    freqside = config.int_prop(None)
    # Sources per batched call (the reference advances one source per
    # Cython call, beamform.py:290); 1 selects the per-source path.
    source_batch = config.int_prop(32)
    data_available = True

    # polarization mode -> (stacks processed, outputs produced)
    _POL_MODES = {
        "I": (["XX", "YY"], ["I"]),
        "full": (["XX", "XY", "YX", "YY"], None),
        "copol": (["XX", "YY"], None),
    }

    def setup(self, manager):
        self.telescope = io.get_telescope(manager)
        self.latitude = np.deg2rad(self.telescope.latitude)

        if self.polarization not in self._POL_MODES:
            raise RuntimeError("Stokes-parameter beamforming is not available")
        self.process_pol, ret = self._POL_MODES[self.polarization]
        self.return_pol = self.process_pol if ret is None else ret
        self.npol = len(self.process_pol)

        pol_list = list(np.asarray(self.telescope.polarisation))
        self.map_pol_feed = {pstr: pol_list.index(pstr) for pstr in ["X", "Y"] if pstr in pol_list}

        if self.variable_timetrack and not self.collapse_ha:
            raise NotImplementedError(
                "Must collapse over hour angle if tracking sources for declination dependent amount of time."
            )

    # -- data/catalog parsing (reference beamform.py:515-665) -----------------
    def _process_data(self, data):
        self.tag_data = data.attrs.get("tag")
        self.is_sstream = "ra" in data.index_map
        if self.is_sstream:
            self.ra = data.ra
            self.epoch = self.telescope.lsd_to_unix(np.mean(data.attrs.get("lsd", 0)))
            # seconds per sample: 240 s of solar time per sidereal degree
            dt = 240.0 * SIDEREAL_S * np.median(np.abs(np.diff(self.ra)))
        else:
            self.ra = self.telescope.unix_to_lsa(data.time)
            self.epoch = data.time.mean()
            dt = np.median(np.abs(np.diff(data.time)))

        self.freq = data.index_map["freq"]
        self.nfreq = len(self.freq)
        self.freq_local = self.freq["centre"]
        self.ls = self.nfreq

        self.ha_side = self.timetrack / dt
        self.nha = 2 * int(self.ha_side) + 1

        # polarisation of each stack entry
        tel = self.telescope
        ps = data.prodstack
        pol_names = np.asarray(tel.polarisation)
        pol_a = pol_names[ps["input_a"].astype(int)]
        pol_b = pol_names[ps["input_b"].astype(int)]
        polpair = np.char.add(pol_a, pol_b)
        fullpol = ["XX", "XY", "YX", "YY"]
        polmap = np.array([fullpol.index(p) if p in fullpol else -1 for p in polpair])

        # baseline vectors in metres per stack entry
        bvec_m = (tel.feedpositions[ps["input_a"].astype(int)] - tel.feedpositions[ps["input_b"].astype(int)]).T

        vis_all = data.vis[:]
        weight_all = data.weight[:]
        dev = vis_all.device
        redundancy = None
        if self.weight != "inverse_variance":
            redundancy = self._redundancy(data)  # [nstack, nra] float32

        self.vis, self.visweight, self.bvec, self.sumweight = [], [], [], []
        for pol in self.process_pol:
            pidx = np.flatnonzero(polmap == fullpol.index(pol))
            sel = torch.as_tensor(pidx, device=dev)
            # [freq, ra, nprod], product-contiguous
            self.vis.append(vis_all.index_select(1, sel).to(torch.complex64).transpose(1, 2).contiguous())
            vw = weight_all.index_select(1, sel).to(torch.float32).transpose(1, 2).contiguous()
            self.visweight.append(vw)
            self.bvec.append(bvec_m[:, np.newaxis, pidx] * self.freq_local[np.newaxis, :, np.newaxis] * 1e6 / C)
            if self.weight == "inverse_variance":
                self.sumweight.append(vw)
            else:
                sw = (vw > 0.0).to(torch.float32) * redundancy.index_select(0, sel).T[None]
                if self.weight == "uniform":
                    sw = (sw > 0.0).to(torch.float32)
                self.sumweight.append(sw.contiguous())
        # the baseline components in wavelengths, on the device, per polarisation
        self._uv = [
            tuple(torch.as_tensor(bv[i], dtype=torch.float32, device=dev).contiguous() for i in (0, 1))
            for bv in self.bvec
        ]

    def _redundancy(self, data):
        """Per-stack redundancy [nstack, nra] from the input flags, counted a
        block of time samples at a time (the full product triangle times
        every sample would not fit on the card)."""
        flags = data.input_flags[:]
        prod = data.index_map["prod"][:]
        stack_index = data.reverse_map["stack"]["stack"][:]
        nstack = data.vis.shape[1]
        index = tools.redundancy_index(prod, stack_index, nstack, flags.shape[0], flags.device)
        # flags that are zero at every sample count as all ones: decide once for the whole set
        if not bool(flags.any()):
            flags = torch.ones(flags.shape, dtype=torch.float32, device=flags.device)
        nt = flags.shape[1]
        out = torch.empty(nstack, nt, dtype=torch.float32, device=flags.device)
        for t0, t1 in tools.axis_blocks(nt, len(index[0]), _REDUNDANCY_BLOCK):
            out[:, t0:t1] = tools.calculate_redundancy(flags, prod, stack_index, nstack, slice(t0, t1), index)
        return out

    def _process_catalog(self, catalog):
        if "position" not in catalog:
            raise ValueError("The catalog carries no position table.")
        if not hasattr(self, "epoch"):
            self.log.warning("No epoch on the catalog positions; proceeding without precession.")
            self.data_available = False
            return
        pos = np.asarray(catalog["position"][:])
        already_cirs = catalog.attrs.get("coordinates", None) == "CIRS"
        self.sra, self.sdec = (
            (pos["ra"], pos["dec"]) if already_cirs else icrs_to_cirs(pos["ra"], pos["dec"], self.epoch)
        )
        if self.freqside is not None:
            if "redshift" not in catalog:
                raise ValueError("The catalog carries no redshift table, which this mode needs.")
            self.sfreq = NU21 / (np.asarray(catalog["redshift"][:]["z"]) + 1.0)
        self.source_cat = catalog
        self.nsource = len(self.sra)
        self.tag_catalog = catalog.attrs.get("tag")

    # -- beam model ------------------------------------------------------------
    def _initialize_beam_with_data(self):
        if not self.no_beam_model:
            # nearest telescope channel for each local frequency
            gap = np.abs(self.freq_local[:, np.newaxis] - self.telescope.frequencies[np.newaxis, :])
            self.freq_local_telescope_index = gap.argmin(axis=1)

    def _beamfunc(self, pol, dec, ha):
        """Primary beam power vs (freq, ha) at the source declination.

        (reference beamform.py:473-513)
        """
        return self._beamfunc_many(pol, [dec], [ha])[0]

    def _beamfunc_many(self, pol, decs, has, cache=None):
        """:meth:`_beamfunc` of several sources, one ``beam_at`` call per
        (feed, frequency) for all their hour angles together: a list of
        [freq, len(ha)] arrays, the same numbers source by source.  A
        ``cache`` dict shared by the calls for one set of sources keeps each
        (feed, frequency) beam for the other polarisations."""
        sizes = [len(ha) for ha in has]
        if self.no_beam_model:
            return [np.ones((self.freq_local.size, n), dtype=np.float64) for n in sizes]
        ha_all = np.concatenate([np.asarray(ha, dtype=np.float64) for ha in has])
        theta = np.concatenate([(0.5 * np.pi - dec) * np.ones(n) for dec, n in zip(decs, sizes)])
        angpos = np.stack([theta, ha_all], axis=-1)
        tel = self.telescope
        # map_pol_feed values are FEED indices (the first feed of each
        # polarisation, telescope.polarisation order): the representative
        # feed for beam_at
        fa_ind = int(self.map_pol_feed.get(pol[0], 0))
        fb_ind = int(self.map_pol_feed.get(pol[1], 0))
        cache = {} if cache is None else cache

        def beam(feed, fi):
            if (feed, fi) not in cache:
                cache[(feed, fi)] = np.atleast_2d(tel.beam_at(feed, fi, angpos))
            return cache[(feed, fi)]

        primary_beam = np.zeros((self.freq_local.size, ha_all.size), dtype=np.float64)
        for ff, fi in enumerate(self.freq_local_telescope_index):
            bii = beam(fa_ind, fi)
            bjj = beam(fb_ind, fi) if pol[0] != pol[1] else bii
            if bii.ndim == 2 and bii.shape[-1] == 2:
                primary_beam[ff] = np.sum(bii * bjj.conj(), axis=-1).real
            else:
                primary_beam[ff] = (bii * bjj.conj()).real.reshape(-1)
        return np.split(primary_beam, np.cumsum(sizes)[:-1], axis=1)

    def _ha_array(self, ra, source_ra_index, source_ra, ha_side, is_sstream=True):
        """HA array + RA indices for one source (reference beamform.py:399)."""
        window = np.arange(source_ra_index - ha_side, source_ra_index + ha_side + 1, dtype=np.int32)
        nra = len(ra)
        if is_sstream:
            # sidereal data wraps around the RA circle
            window %= nra
            ha_mask = np.ones(window.size, dtype=bool)
        else:
            # timestream data clips at the observation edges
            ha_mask = (window >= 0) & (window < nra)
            window = window[ha_mask]
        hour_angle = np.deg2rad(ra[window] - source_ra)
        hour_angle = (hour_angle + np.pi) % (2.0 * np.pi) - np.pi
        return hour_angle, window, ha_mask

    def _transit_index(self, source_ra):
        """Nearest RA sample to a source transit, or None when outside the
        observation (timestream inputs only)."""
        if self.is_sstream:
            return np.searchsorted(self.ra, source_ra) % len(self.ra)
        gap = abs(self.ra - source_ra)
        best = np.argmin(gap)
        cadence = self.ra[1] - self.ra[0]
        return None if gap[best] > 1.5 * abs(cadence) else best

    def _source_freq_mask(self, src):
        """Frequency flag mask around a source's 21cm line (freqside mode)."""
        centre = np.argmin(abs(self.freq["centre"] - self.sfreq[src]))
        flag = np.ones(self.nfreq, dtype=bool)
        lo = max(0, centre - self.freqside)
        hi = min(self.nfreq, centre + self.freqside + 1)
        flag[lo:hi] = False
        return flag

    # -- main loop -----------------------------------------------------------
    def _new_output(self):
        """FormedBeam(HA) container annotated from the catalog, on the data's device."""
        kwargs = dict(
            freq=self.freq,
            object_id=self.source_cat.index_map["object_id"],
            pol=np.array(self.return_pol),
            device=self.vis[0].device,
        )
        if self.collapse_ha:
            fb = containers.FormedBeam(**kwargs)
        else:
            fb = containers.FormedBeamHA(ha=np.arange(self.nha, dtype=np.int64), **kwargs)
        tags = [t for t in (self.tag_data, self.tag_catalog) if t is not None]
        fb.attrs["tag"] = "_".join(tags)
        fb["position"][:] = self.source_cat["position"][:]
        if "redshift" in self.source_cat:
            fb.add_dataset("redshift")
            fb["redshift"][:] = self.source_cat["redshift"][:]
        return fb

    def process(self):
        """Beamform every catalog source (reference beamform.py:139-385)."""
        self._initialize_beam_with_data()
        formed_beam = self._new_output()

        if self.source_batch > 1:
            fbb, fbw, fbha = self._process_sources_batched()
        else:
            fbb, fbw, fbha = self._process_sources_one_by_one()
        formed_beam.beam[:] = fbb
        formed_beam.weight[:] = fbw
        if fbha is not None:
            formed_beam.datasets["object_ha"][:] = fbha
        return formed_beam

    def _process_sources_one_by_one(self):
        """The per-source path (reference beamform.py:290-385): one kernel
        call per (source, polarisation), the collapse in torch float32."""
        dev = self.vis[0].device
        npol_out = len(self.return_pol)
        shape = (self.nsource, npol_out, self.ls) + (() if self.collapse_ha else (self.nha,))
        fbb = torch.zeros(shape, dtype=torch.float64, device=dev)
        fbw = torch.zeros(shape, dtype=torch.float64, device=dev)
        fbha = None if self.collapse_ha else np.zeros((self.nsource, self.nha))

        for src in range(self.nsource):
            if src % 1000 == 0:
                self.log.info(f"Beamforming source {src} of {self.nsource}")
            dec = np.radians(self.sdec[src])

            f_mask = np.zeros(self.ls, dtype=bool)
            if self.freqside is not None:
                f_mask = self._source_freq_mask(src)
                if f_mask.all():
                    continue

            sra_index = self._transit_index(self.sra[src])
            if sra_index is None:
                continue

            ha_side = int(self.ha_side / np.cos(dec)) if self.variable_timetrack else int(self.ha_side)
            ha_array, ra_index_range, ha_mask = self._ha_array(
                self.ra, sra_index, self.sra[src], ha_side, self.is_sstream
            )
            ra_sel = torch.as_tensor(ra_index_range.astype(np.int64), device=dev)
            hm = torch.as_tensor(ha_mask, device=dev)

            pshape = (self.npol, self.ls) if self.collapse_ha else (self.npol, self.ls, self.nha)
            formed_beam_full = torch.zeros(pshape, dtype=torch.float32, device=dev)
            weight_full = torch.zeros(pshape, dtype=torch.float32, device=dev)

            for pol, pol_str in enumerate(self.process_pol):
                primary_beam = torch.as_tensor(self._beamfunc(pol_str, dec, ha_array), dtype=torch.float32,
                                               device=dev)

                vis_sel = self.vis[pol].index_select(1, ra_sel)
                sw_sel = self.sumweight[pol].index_select(1, ra_sel)
                vw_sel = self.visweight[pol].index_select(1, ra_sel)

                this_formed_beam = beamform_kernel(
                    vis_sel, sw_sel, dec, self.latitude, np.cos(ha_array), np.sin(ha_array), *self._uv[pol]
                )

                if self.collapse_ha:
                    this_sumweight = (sw_sel.sum(dim=-1) * primary_beam**2).sum(dim=1)
                    formed_beam_full[pol] = (this_formed_beam * primary_beam).sum(dim=1) * invert_no_zero(
                        this_sumweight
                    )
                    if self.weight != "inverse_variance":
                        this_weight2 = ((sw_sel**2 * invert_no_zero(vw_sel)).sum(dim=-1) * primary_beam**2).sum(
                            dim=1
                        )
                        weight_full[pol] = this_sumweight**2 * invert_no_zero(this_weight2)
                    else:
                        weight_full[pol] = this_sumweight
                else:
                    this_sumweight = sw_sel.sum(dim=-1)
                    formed_beam_full[pol][:, hm] = this_formed_beam * invert_no_zero(this_sumweight)
                    if self.weight != "inverse_variance":
                        this_weight2 = (sw_sel**2 * invert_no_zero(vw_sel)).sum(dim=-1)
                        weight_full[pol][:, hm] = this_sumweight**2 * invert_no_zero(this_weight2)
                    else:
                        weight_full[pol][:, hm] = this_sumweight
                weight_full[pol][torch.as_tensor(f_mask, device=dev)] = 0.0

            formed_beam_full, weight_full = formed_beam_full.double(), weight_full.double()
            if self.polarization == "I":
                fsum = (formed_beam_full * weight_full).sum(dim=0) * invert_no_zero(weight_full.sum(dim=0))
                weight_full = weight_full.sum(dim=0, keepdim=True)
                formed_beam_full = fsum[None]

            fbb[src] = formed_beam_full
            # Factor 2: the real component has half the complex variance
            fbw[src] = 2.0 * weight_full
            if fbha is not None:
                if self.is_sstream:
                    fbha[src, :] = ha_array
                else:
                    fbha[src, ha_mask] = ha_array
        return fbb, fbw, fbha

    def _process_sources_batched(self):
        """Beamforming with sources batched on the device.

        Equivalent to the per-source loop (reference beamform.py:290-385)
        but each batch of sources gathers its RA windows and runs every
        (source, freq, ha, product) contraction in one call per
        polarisation (:func:`draco_tpu_torch.ops.interferometry.beamform_sources_batched`
        / ``..._ha``: the CUDA kernel on the card).  Variable-length and
        edge-clipped HA windows are padded and zeroed through the
        primary-beam factor (collapse-HA) or an explicit validity mask
        (HA-resolved).
        """
        dev = self.vis[0].device
        nsrc = self.nsource
        npol_out = len(self.return_pol)
        shape = (nsrc, npol_out, self.ls) + (() if self.collapse_ha else (self.nha,))
        fbb = torch.zeros(shape, dtype=torch.float64, device=dev)
        fbw = torch.zeros(shape, dtype=torch.float64, device=dev)
        fbha = None if self.collapse_ha else np.zeros((nsrc, self.nha))

        # per-source windows and masks (host bookkeeping, small)
        decs = np.radians(self.sdec)
        keep = np.ones(nsrc, dtype=bool)
        f_masks = np.zeros((nsrc, self.nfreq), dtype=bool)
        windows = []
        for src in range(nsrc):
            if self.freqside is not None:
                f_masks[src] = self._source_freq_mask(src)
                if f_masks[src].all():
                    keep[src] = False
                    windows.append(None)
                    continue
            sra_index = self._transit_index(self.sra[src])
            if sra_index is None:
                keep[src] = False
                windows.append(None)
                continue
            ha_side = int(self.ha_side / np.cos(decs[src])) if self.variable_timetrack else int(self.ha_side)
            windows.append(self._ha_array(self.ra, sra_index, self.sra[src], ha_side, self.is_sstream))

        src_ids = np.nonzero(keep)[0]
        if len(src_ids) == 0:
            return fbb, fbw, fbha

        S = int(self.source_batch)
        if dev.type == "cpu":
            # the plain version gathers [freq, S, nha, nprod] windows: a ~2 GB budget
            nprod_max = max(v.shape[-1] for v in self.vis)
            nham_all = max(len(windows[s][0]) for s in src_ids)
            per_src = max(1, nham_all * self.ls * nprod_max * 20)
            S = max(1, min(S, int(2.5e9 // per_src)))

        f_masks_t = torch.as_tensor(f_masks, device=dev)
        if self.collapse_ha:
            # every kept source's primary beam at once: one beam_at call per
            # (feed, frequency) for the whole catalogue, the same numbers
            # source by source as a call per source
            cache = {}
            has = [windows[s][0] for s in src_ids]
            beams = {
                p: dict(zip(src_ids, self._beamfunc_many(p, decs[src_ids], has, cache))) for p in self.process_pol
            }
            del cache
        for b0 in range(0, len(src_ids), S):
            batch = src_ids[b0 : b0 + S]
            nb = len(batch)
            nham = self.nha if not self.collapse_ha else max(len(windows[s][0]) for s in batch)
            ra_idx = np.zeros((nb, nham), np.int32)
            cosha = np.zeros((nb, nham))
            sinha = np.zeros((nb, nham))
            ha_valid = np.zeros((nb, nham), np.float32)
            sels = []
            for k, s_id in enumerate(batch):
                ha_array, ra_index_range, ha_mask = windows[s_id]
                # collapse-HA: packed at the start, the primary-beam factor zeroes the
                # padding; HA-resolved: outputs at their full-grid positions
                # (reference beamform.py:370-380)
                sel = slice(0, len(ha_array)) if self.collapse_ha else ha_mask
                sels.append(sel)
                ra_idx[k][sel] = ra_index_range
                cosha[k][sel] = np.cos(ha_array)
                sinha[k][sel] = np.sin(ha_array)
                ha_valid[k][sel] = 1.0
                if not self.collapse_ha and fbha is not None:
                    fbha[s_id][sel] = ha_array
            if self.collapse_ha:
                pb = np.zeros((self.npol, nb, self.ls, nham))
                for pol, pol_str in enumerate(self.process_pol):
                    for k, s_id in enumerate(batch):
                        pb[pol, k, :, sels[k]] = beams[pol_str][s_id]

            formed, wout = [], []
            for pol in range(self.npol):
                common = (
                    self.vis[pol], self.sumweight[pol], self.visweight[pol], ra_idx, cosha, sinha,
                    np.sin(decs[batch]), np.cos(decs[batch]), self.latitude, *self._uv[pol],
                )
                if self.collapse_ha:
                    f_p, w_p = beamform_sources_batched(*common, pb[pol], self.weight == "inverse_variance")
                else:
                    f_p, w_p = beamform_sources_batched_ha(*common, ha_valid, self.weight == "inverse_variance")
                formed.append(f_p.double())
                wout.append(w_p.double())
            formed = torch.stack(formed)  # [pol, nb, freq(, ha)]
            wout = torch.stack(wout)

            bidx = torch.as_tensor(batch, device=dev)
            fm = f_masks_t.index_select(0, bidx)  # [nb, freq]
            fm = fm[None] if self.collapse_ha else fm[None, :, :, None]
            wout = torch.where(fm, torch.zeros_like(wout), wout)
            if self.polarization == "I":
                wsum = wout.sum(dim=0)
                fsum = (formed * wout).sum(dim=0) * invert_no_zero(wsum)
                fbb[bidx] = fsum[:, None]
                fbw[bidx] = 2.0 * wsum[:, None]
            else:
                fbb[bidx] = formed.transpose(0, 1)
                fbw[bidx] = 2.0 * wout.transpose(0, 1)
        return fbb, fbw, fbha

    def process_finish(self):
        """Release the large cached data arrays."""
        for attr in ["vis", "visweight", "bvec", "sumweight", "_uv"]:
            if hasattr(self, attr):
                delattr(self, attr)
        return None


class BeamForm(BeamFormBase):
    """Single catalog, multiple datasets (reference beamform.py:668)."""

    def setup(self, manager, source_cat):
        super().setup(manager)
        self.catalog = source_cat

    def process(self, data):
        self._process_data(data)
        self._process_catalog(self.catalog)
        return BeamFormBase.process(self) if self.data_available else None


class BeamFormCat(BeamFormBase):
    """Multiple catalogs, single dataset (reference beamform.py:710)."""

    def setup(self, manager, data):
        super().setup(manager)
        self._process_data(data)

    def process(self, source_cat):
        self._process_catalog(source_cat)
        return BeamFormBase.process(self) if self.data_available else None


class BeamFormExternalMixin:
    """Use an external GridBeam model (reference beamform.py:752)."""

    def setup(self, beam, *args):
        super().setup(*args)
        self._initialize_beam(beam)

    def _initialize_beam(self, beam):
        if not isinstance(beam, containers.GridBeam):
            raise ValueError(f"Unsupported beam container {beam.__class__}")
        self._initialize_grid_beam(beam)
        self._beamfunc = self._grid_beam

    def _beamfunc_many(self, pol, decs, has, cache=None):
        return [self._grid_beam(pol, dec, ha) for dec, ha in zip(decs, has)]

    def _initialize_beam_with_data(self):
        if not np.array_equal(self.freq_local, self._beam_freq):
            raise RuntimeError("The external beam disagrees with the data freq axis.")

    def _initialize_grid_beam(self, gbeam):
        import scipy.interpolate

        if gbeam.coords != "celestial":
            raise RuntimeError("GridBeam must be converted to celestial coordinates for beamforming.")
        if len(gbeam.input) > 1:
            raise NotImplementedError("Per-input external beams are not supported.")
        self._beam_freq = gbeam.freq
        pol_list = [p.decode() if isinstance(p, bytes) else str(p) for p in gbeam.pol]
        # decode the fallback the same way: pol_list holds str entries
        process_pol = getattr(self, "process_pol", pol_list)
        ipol = np.array([pol_list.index(p) for p in process_pol])
        self._beam_pol = [pol_list[ip] for ip in ipol]

        weight = np.asarray(gbeam.weight[:])[:, ipol, 0]
        flag = weight > 0.0
        beam = np.where(flag, np.asarray(gbeam.beam[:])[:, ipol, 0].real, 0.0)

        ha = (np.asarray(gbeam.phi) + 180.0) % 360.0 - 180.0
        isort = np.argsort(ha)
        ha = np.radians(ha[isort])
        dec = np.radians(np.asarray(gbeam.theta))

        def spline_table(cube):
            return [[scipy.interpolate.RectBivariateSpline(dec, ha, plane[:, isort]) for plane in rows] for rows in cube]

        self._beam = spline_table(beam)
        self._beam_flag = spline_table(flag.astype(np.float32))
        self.log.info("Grid beam initialized.")

    def _grid_beam(self, pol, dec, ha):
        pp = self._beam_pol.index(pol)
        rows, ok = [], []
        for bspl, fspl in zip(self._beam, self._beam_flag):
            rows.append(bspl[pp](dec, ha)[0])
            ok.append(np.abs(fspl[pp](dec, ha)[0] - 1.0) < 0.01)
        return np.where(ok, rows, 0.0)


class BeamFormExternal(BeamFormExternalMixin, BeamForm):
    """External beam + single catalog (reference beamform.py:901)."""


class BeamFormExternalCat(BeamFormExternalMixin, BeamFormCat):
    """External beam + multiple catalogs (reference beamform.py:908)."""


def _catalog_positions(catalog, tel, attrs):
    """Catalogue (ra, dec), precessed to the epoch of ``attrs["lsd"]`` when it has one."""
    pos = np.asarray(catalog["position"][:])
    if "lsd" in attrs:
        epoch = tel.lsd_to_unix(np.mean(attrs["lsd"]))
        return icrs_to_cirs(pos["ra"], pos["dec"], epoch)
    return pos["ra"], pos["dec"]


class RingMapBeamForm(ContainerTask):
    """Extract source pixels from a RingMap (reference beamform.py:915), on the map's device."""

    def setup(self, telescope, ringmap: containers.RingMap):
        self.telescope = io.get_telescope(telescope)
        self.ringmap = ringmap

    def process(self, catalog: containers.SourceCatalog) -> containers.FormedBeam:
        ringmap = self.ringmap
        tel = self.telescope
        src_ra, src_dec = _catalog_positions(catalog, tel, ringmap.attrs)

        ra = ringmap.ra
        el = np.asarray(ringmap.index_map["el"])

        ra_ind = np.array([np.argmin(np.abs((ra - r + 180) % 360 - 180)) for r in src_ra])
        src_el = np.sin(np.radians(src_dec - tel.latitude))
        el_ind = np.array([np.argmin(np.abs(el - e)) for e in src_el])

        rm_map = ringmap.map[:][0]  # beam 0: [pol, freq, ra, el]
        dev = rm_map.device
        fb = containers.FormedBeam(
            freq=ringmap.index_map["freq"],
            object_id=catalog.index_map["object_id"],
            pol=ringmap.index_map["pol"],
            device=dev,
        )
        fb["position"][:] = catalog["position"][:]
        if "redshift" in catalog:
            fb.add_dataset("redshift")
            fb["redshift"][:] = catalog["redshift"][:]

        rm_w = ringmap.datasets["weight"][:]
        # paired indices select the (ra, el) pixel of each source
        ri = torch.as_tensor(ra_ind, device=dev)
        ei = torch.as_tensor(el_ind, device=dev)
        fb.beam[:] = rm_map[:, :, ri, ei].permute(2, 0, 1)
        fb.weight[:] = rm_w[:, :, ri, ei].permute(2, 0, 1)
        return fb


class RingMapStack2D(RingMapBeamForm):
    """Stack RingMap patches around sources (reference beamform.py:1097).

    The patches accumulate on the map's device in float64.

    Attributes
    ----------
    num_ra, num_dec : int
        Half-widths of the extracted patch in RA/Dec pixels.
    num_freq : int
        Half-width in frequency bins around each source's 21cm frequency.
    freq_width : float
        Width in MHz for the output frequency offset axis.
    weight : 'input' | 'patch' | 'dec'
        Weighting scheme (reference beamform.py:1110-1114): 'input' uses
        the per-pixel map weights, 'patch' the inverse variance of each
        extracted patch, 'dec' the inverse variance of each declination
        strip.
    """

    num_ra = config.int_prop(10)
    num_dec = config.int_prop(10)
    num_freq = config.int_prop(256)
    freq_width = config.float_prop(100.0)
    weight = config.enum(["patch", "dec", "input"], default="input")

    def process(self, catalog: containers.SourceCatalog) -> containers.Stack3D:
        ringmap = self.ringmap
        tel = self.telescope
        pos = np.asarray(catalog["position"][:])
        # precess catalog positions to the map epoch, exactly as the
        # per-source extraction in the parent class does
        src_ra, src_dec = _catalog_positions(catalog, tel, ringmap.attrs)
        if "redshift" not in catalog:
            raise ValueError("Catalog must have redshifts for 3D stacking.")
        zs = np.asarray(catalog["redshift"][:]["z"])
        src_freq = NU21 / (1 + zs)

        freq = ringmap.freq
        ra = ringmap.ra
        el = np.asarray(ringmap.index_map["el"])
        rm = ringmap.map[:][0].to(torch.float64)  # [pol, freq, ra, el]
        rw = ringmap.datasets["weight"][:].to(torch.float64)
        dev = rm.device

        df = np.median(np.abs(np.diff(freq)))
        nf_out = 2 * self.num_freq + 1
        freq_offset = (np.arange(nf_out) - self.num_freq) * df

        npol = rm.shape[0]
        out = containers.Stack3D(
            freq=containers.make_freq_map(freq_offset),
            pol=ringmap.index_map["pol"],
            delta_ra=np.arange(-self.num_ra, self.num_ra + 1),
            delta_dec=np.arange(-self.num_dec, self.num_dec + 1),
            device=dev,
        )
        stack = torch.zeros(out.stack.shape, dtype=torch.float64, device=dev)
        wsum = torch.zeros(out.stack.shape, dtype=torch.float64, device=dev)

        # per-(pol, freq, el) declination-strip variance for weight='dec'
        # (reference beamform.py:1196: strips of variance < 3e-7 masked)
        rmvar = rm.var(dim=2, unbiased=False)
        w_global = invert_no_zero(torch.where(rmvar < 3e-7, torch.zeros_like(rmvar), rmvar))

        def idx(a):
            return torch.as_tensor(a, device=dev)

        for si in range(len(pos)):
            fi0 = np.argmin(np.abs(freq - src_freq[si]))
            ri0 = np.argmin(np.abs((ra - src_ra[si] + 180) % 360 - 180))
            e0 = np.sin(np.radians(src_dec[si] - tel.latitude))
            ei0 = np.argmin(np.abs(el - e0))

            fsl = np.arange(fi0 - self.num_freq, fi0 + self.num_freq + 1)
            rsl = (np.arange(ri0 - self.num_ra, ri0 + self.num_ra + 1)) % len(ra)
            esl = np.arange(ei0 - self.num_dec, ei0 + self.num_dec + 1)
            valid_f = (fsl >= 0) & (fsl < len(freq))
            valid_e = (esl >= 0) & (esl < len(el))
            if not valid_f.any() or not valid_e.any():
                continue
            fs, es = idx(fsl[valid_f]), idx(esl[valid_e])
            patch = rm.index_select(1, fs).index_select(2, idx(rsl)).index_select(3, es)
            wpatch = rw.index_select(1, fs).index_select(2, idx(rsl)).index_select(3, es)
            if self.weight == "patch":
                pvar = patch.var(dim=(2, 3), unbiased=False)
                wpatch = (wpatch != 0) * invert_no_zero(pvar)[:, :, None, None]
            elif self.weight == "dec":
                wpatch = (wpatch != 0) * w_global.index_select(1, fs).index_select(2, es)[:, :, None, :]
            # accumulate into [pol, dra, ddec, freq_offset]
            block = (patch * wpatch).permute(0, 2, 3, 1)
            wblock = wpatch.permute(0, 2, 3, 1)
            de, df_ = idx(np.nonzero(valid_e)[0]), idx(np.nonzero(valid_f)[0])
            sub = (slice(None), slice(None), de[:, None], df_[None, :])
            stack[sub] += block
            wsum[sub] += wblock

        out.stack[:] = stack * invert_no_zero(wsum)
        out.weight[:] = wsum
        return out


class HealpixBeamForm(ContainerTask):
    """Beamform from a HEALPix map by extracting source pixels.

    (reference beamform.py:1676)
    """

    fwhm = config.float_prop(0.0)

    def setup(self, hpmap: containers.Map):
        self.map = hpmap

    def process(self, catalog: containers.SourceCatalog) -> containers.FormedBeam:
        pos = np.asarray(catalog["position"][:])
        nside = self.map.nside
        theta = np.radians(90.0 - pos["dec"])
        phi = np.radians(pos["ra"])
        pix = np.asarray(healpix.ang2pix(nside, theta, phi))

        m = self.map.map[:]  # [freq, pol, pixel]
        dev = m.device
        fb = containers.FormedBeam(
            freq=self.map.index_map["freq"],
            object_id=catalog.index_map["object_id"],
            pol=self.map.index_map["pol"],
            device=dev,
        )
        fb["position"][:] = catalog["position"][:]
        if "redshift" in catalog:
            fb.add_dataset("redshift")
            fb["redshift"][:] = catalog["redshift"][:]
        if self.fwhm:
            # Gaussian harmonic smoothing before extraction (the reference
            # calls healpy.smoothing, beamform.py:1709): the SHT applies
            # b_l = exp(-l(l+1) sigma^2 / 2), in float32 as the JAX package
            from ..ops import sht as sht_mod

            s = sht_mod.get_sht(nside, 3 * nside - 1)
            sigma = np.radians(self.fwhm) / np.sqrt(8.0 * np.log(2.0))
            ell = np.arange(s.lmax + 1)
            bl = np.exp(-0.5 * ell * (ell + 1) * sigma**2)
            alm = s.analysis(m.to(torch.float32))
            alm = alm * torch.as_tensor(bl, dtype=alm.real.dtype, device=dev)[:, None]
            m = s.synthesis(alm)
        fb.beam[:] = m[:, :, torch.as_tensor(pix, device=dev)].permute(2, 1, 0)
        fb.weight[:] = 1.0
        return fb


class HybridVisBeamForm(ContainerTask):
    """Beamform HybridVisStream data onto a source catalog.

    (reference beamform.py:1305-1486).  The reference's per-frequency
    fringestop loop is vectorised over (pol, freq, ew) per source, on the
    data's device in complex128.

    Attributes
    ----------
    window : float
        Hour-angle window half-width in degrees.  Default 5.
    ignore_rot : bool
        Ignore the telescope rotation angle in the EW phases.
    """

    window = config.float_prop(5.0)
    ignore_rot = config.bool_prop(False)

    def setup(self, manager, catalog):
        """Set the observer and the source catalog."""
        self.telescope = io.get_telescope(manager)
        self.latitude = np.radians(self.telescope.latitude)
        self.rot = 0.0
        tilt = getattr(self.telescope, "rotation_angle", 0.0)
        if tilt and not self.ignore_rot:
            self.log.info(f"Compensating the NS phase arising from the telescope's {tilt:0.2f} deg rotation.")
            self.rot = np.radians(tilt)
        self.catalog = catalog

    def _precessed_positions(self, hvis):
        """Catalog (ra, dec) precessed to the data epoch(s)."""
        pos = np.asarray(self.catalog["position"][:])
        ra, dec = pos["ra"].copy(), pos["dec"].copy()
        lsd = hvis.attrs.get("lsd", hvis.attrs.get("csd"))
        if lsd is None:
            return ra, dec
        epochs = np.atleast_1d(self.telescope.lsd_to_unix(lsd))
        moved = [icrs_to_cirs(ra, dec, ep) for ep in epochs]
        return np.mean([m[0] for m in moved], axis=0), np.mean([m[1] for m in moved], axis=0)

    def process(self, hvis):
        """Finish beamforming in the east-west direction."""
        from ..ops.tools import correct_phase_wrap, find_contiguous_slices

        fringestopped = hvis.attrs.get("fringestopped", False)
        src_ra, src_dec = self._precessed_positions(hvis)

        dec = np.degrees(np.arcsin(np.asarray(hvis.index_map["el"])) + self.latitude)
        dec_row = _search_nearest(dec, src_dec)
        dec_step = np.max(np.abs(np.diff(dec)))
        on_grid = np.abs(src_dec - dec[dec_row]) < dec_step
        self.log.info(f"There are {np.sum(on_grid)} catalog sources in this declination range.")

        ra = np.asarray(hvis.ra)
        ha_arr = np.asarray(correct_phase_wrap(ra[np.newaxis, :] - src_ra[:, np.newaxis], deg=True))
        in_window = np.abs(ha_arr) <= self.window

        ra_rad = np.radians(ra)
        lmbda = C / (np.asarray(hvis.freq) * 1e6)
        ew = np.asarray(hvis.index_map["ew"])
        u = ew[np.newaxis, :, np.newaxis] / lmbda[:, np.newaxis, np.newaxis]
        v = np.sin(self.rot) * u

        vis = hvis.vis[:]  # pol, freq, ew, el, ra
        weight = hvis.weight[:]  # pol, freq, ew, ra
        dev = vis.device

        out = containers.FormedBeamHAEW(
            object_id=self.catalog.index_map["object_id"],
            ha=np.arange(in_window.sum(axis=-1).max(), dtype=int),
            axes_from=hvis,
            attrs_from=hvis,
        )
        if "redshift" in self.catalog.datasets:
            out.add_dataset("redshift")
            out["redshift"][:] = self.catalog["redshift"][:]

        opos = np.zeros(len(src_ra), dtype=[("ra", np.float64), ("dec", np.float64)])
        opos["ra"], opos["dec"] = src_ra, src_dec
        out.position[:] = opos

        ofb = torch.zeros(out.beam.shape, dtype=torch.complex128, device=dev)
        owe = torch.zeros(out.weight.shape, dtype=torch.float64, device=dev)
        oha = np.zeros(out.ha.shape, dtype=np.float64)
        u_t = torch.as_tensor(u, device=dev)
        v_t = torch.as_tensor(v, device=dev)

        for si in np.flatnonzero(on_grid):
            row = dec_row[si]
            sdec = np.radians(src_dec[si])
            samples = np.flatnonzero(in_window[si])
            if samples.size == 0:
                continue

            cos_dec = np.cos(np.radians(dec[row]))
            samples = samples[np.argsort(ha_arr[si, samples])]

            filled = 0
            for islc in find_contiguous_slices(samples):
                svis = vis[..., row, islc]  # pol, freq, ew, ha
                nsample = svis.shape[-1]
                oslc = slice(filled, filled + nsample)
                filled += nsample

                oha[si, oslc] = ha_arr[si, islc]
                ha = torch.as_tensor(np.radians(ha_arr[si, islc]), device=dev)

                # vectorised over (freq, ew, ha)
                phi = fringestop_phase(ha[None, None, :], self.latitude, sdec, u_t, v_t)
                if fringestopped:
                    omega = 2.0 * np.pi * cos_dec * ew[np.newaxis, :] / lmbda[:, np.newaxis]
                    arg = torch.as_tensor(omega[..., np.newaxis] * ra_rad[islc], device=dev)
                    phi = phi * torch.polar(torch.ones_like(arg), -arg)

                owe[si, :, :, :, oslc] = weight[..., islc].to(torch.float64)
                ofb[si, :, :, :, oslc] = svis.to(torch.complex128) * phi[None]

        out.beam[:] = ofb
        out.weight[:] = owe
        out.ha[:] = oha
        return out


class FitBeamFormed(BeamFormExternalMixin, ContainerTask):
    """Fit beamformed transits to a primary-beam template.

    (reference beamform.py:1489-1676).  Requires a celestial GridBeam at
    setup; fits (background, beam amplitude) per (source, pol, freq[, ew])
    with batched 2 x 2 solves on the host in float64, as the JAX package.

    Attributes
    ----------
    weight : "uniform" | "inverse_variance"
        Hour-angle weighting during the fit.
    max_ha : float
        Only fit hour angles below this (degrees).
    min_num_background : int
        Minimum off-source samples needed to fit a background.
    min_frac_beam : float
        Minimum fraction of the beam template that must be sampled.
    epsilon : float
        Fit regularisation.
    """

    weight = config.enum(["uniform", "inverse_variance"], default="uniform")
    max_ha = config.float_prop(None)
    min_num_background = config.int_prop(5)
    min_frac_beam = config.float_prop(0.50)
    epsilon = config.float_prop(1.0e-10)

    def process(self, data):
        """Fit the hour-angle transits in a FormedBeamHA(EW) container."""
        container_lookup = {
            containers.FormedBeamHA: containers.FitFormedBeam,
            containers.FormedBeamHAEW: containers.FitFormedBeamEW,
        }

        self.freq_local = np.asarray(data.freq)
        self._initialize_beam_with_data()

        OutputContainer = container_lookup[data.__class__]
        out = OutputContainer(axes_from=data, attrs_from=data)
        out.position[:] = data.position[:]
        if "redshift" in data.datasets:
            out.add_dataset("redshift")
            out["redshift"][:] = data["redshift"][:]

        beam = np.asarray(data.beam[:])
        weight = np.asarray(data.weight[:])

        obeam = np.zeros(out.beam.shape, dtype=np.complex128)
        oweight = np.zeros(out.weight.shape, dtype=np.float64)
        obkg = np.zeros(out.background.shape, dtype=np.complex128)
        oweightbkg = np.zeros(out.weight_background.shape, dtype=np.float64)
        ocorr = np.zeros(out.corr_background_beam.shape, dtype=np.float64)

        pos = np.asarray(data.position[:])
        src_dec = np.radians(pos["dec"])

        src_ha = np.asarray(data.ha[:])
        max_nha = src_ha.shape[1]

        pol_list = [p.decode() if isinstance(p, bytes) else str(p) for p in data.index_map["pol"]]

        for ss, sdec in enumerate(src_dec):
            if not np.any(weight[ss] > 0.0):
                continue

            nz = np.flatnonzero(src_ha[ss, ::-1] != 0.0)
            if nz.size == 0:
                continue
            nhal = max_nha - np.min(nz)
            slc = slice(0, nhal)
            sha = np.radians(src_ha[ss, slc])

            for pp, pol in enumerate(pol_list):
                transit = beam[ss, pp, ..., slc]
                w = weight[ss, pp, ..., slc].astype(np.float64)

                sigma = None
                if self.weight == "uniform":
                    sigma = np.sqrt(invert_no_zero(w))
                    w = (w > 0.0) * 1.0

                flag_ha = np.ones(nhal, dtype=bool)
                if self.max_ha is not None:
                    flag_ha = np.abs(sha) <= np.radians(self.max_ha)
                    w = w * flag_ha

                X = self.get_template(pol, sdec, sha)
                if "ew" in out.index_map:
                    X = X[:, np.newaxis, :, :]
                template = X[..., 1]

                sampled = w > 0
                # enough off-source samples to anchor the background, and
                # enough of the beam template covered to fit its amplitude
                n_off = np.sum(sampled * (template < 0.05), axis=-1)
                covered = np.sum(sampled * template, axis=-1) * invert_no_zero(np.sum(flag_ha * template, axis=-1))
                flag = (n_off > self.min_num_background) & (covered > self.min_frac_beam)
                if not np.any(flag):
                    continue

                XT = np.swapaxes(X, -2, -1)
                A = XT @ (w[..., np.newaxis] * X) + np.eye(2) * self.epsilon
                rhs = np.sum(XT * (w * transit)[..., np.newaxis, :], axis=-1, keepdims=True)
                coeff = np.linalg.solve(A, rhs)[..., 0]
                cov = np.linalg.inv(A)
                if sigma is not None:
                    # propagate the true noise through the uniform fit
                    B = cov @ (XT * (w * sigma)[..., np.newaxis, :])
                    cov = B @ np.swapaxes(B, -2, -1)

                obkg[ss, pp], obeam[ss, pp] = coeff[..., 0], coeff[..., 1]
                oweight[ss, pp] = flag * invert_no_zero(cov[..., 1, 1])
                oweightbkg[ss, pp] = flag * invert_no_zero(cov[..., 0, 0])
                ocorr[ss, pp] = cov[..., 0, 1] * np.sqrt(oweight[ss, pp] * oweightbkg[ss, pp])

        if not out.beam[:].is_complex():
            obeam = obeam.real
        out.beam[:] = obeam
        out.weight[:] = oweight
        out.background[:] = obkg
        out.weight_background[:] = oweightbkg
        out.corr_background_beam[:] = ocorr
        return out

    def get_template(self, pol, dec, ha):
        """Transit template: column 0 = offset, column 1 = beam model."""
        offset = np.ones((self.freq_local.size, ha.size), dtype=float)
        return np.stack([offset, self._beamfunc(pol, dec, ha)], axis=-1)
