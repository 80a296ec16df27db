"""Mock catalog generation tasks (host numpy).

Port of ``draco_tpu.synthesis.mockcatalog``, which re-provides reference ``draco/synthesis/mockcatalog.py``
(SelectionFunctionEstimator:90, ResizeSelectionFunctionMap:205,
PdfGeneratorBase:299, PdfGeneratorUncorrelated:389,
PdfGeneratorWithSelectionFunction:421, PdfGeneratorNoSelectionFunction:457,
MockCatalogGenerator:525, AddGaussianZErrorsToCatalog:751,
AddEBOSSZErrorsToCatalog:821, MapPixelLocationGenerator:1083, and the
helper functions :1177-1306).

Healpy calls are replaced by the native ops.healpix implementations
(ud_grade via NEST averaging, smoothing via the native SHT); the catalog
gridding is a vectorised 2D bincount instead of the reference's
per-pixel scan.  The catalogs are structured host arrays and the draws
come from the task's host ``rng``, so a seed gives the JAX package's
catalogs exactly; maps are made on their input's device.
"""

from __future__ import annotations

import numpy as np

from ..core import config, containers
from ..core.task import ContainerTask, PipelineStopIteration, RandomTask
from ..ops import healpix as hpx

NU21 = 1420.405751768  # MHz
C_LIGHT = 299792458.0


def invert_no_zero(x):
    """Host reciprocal returning exactly zero where ``|x|`` is below 2 / max float."""
    x = np.asarray(x)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        return np.where(np.abs(x) < 2.0 / np.finfo(x.dtype).max, 0.0, 1.0 / x)


class SelectionFunctionEstimator(ContainerTask):
    """Estimate a selection function from a low-rank SVD of a catalog map.

    (reference mockcatalog.py:90-202)

    Attributes
    ----------
    nside, n_z, z_min, z_max, n_modes
        Binning and SVD-rank parameters (defaults tuned for eBOSS QSOs).
    tracer : str
        Optional tracer label stored on the output.
    """

    bcat_path = config.str_prop(None)
    nside = config.int_prop(16)
    n_z = config.int_prop(32)
    z_min = config.float_prop(0.8)
    z_max = config.float_prop(2.5)
    n_modes = config.int_prop(7)
    tracer = config.str_prop(None)

    def process(self, cat=None):
        """SVD the binned catalog and keep the first ``n_modes`` modes.

        ``bcat_path`` (when set) loads the base catalog from disk
        instead of (or in place of) the piped one.
        """
        if self.bcat_path is not None:
            cat = containers.ContainerBase.from_file(self.bcat_path)
        if cat is None:
            raise ValueError(
                "SelectionFunctionEstimator needs a catalog: pipe one in "
                "or set bcat_path."
            )
        edges = np.linspace(self.z_min, self.z_max, self.n_z + 1)
        centres = 0.5 * (edges[1:] + edges[:-1])

        selfunc = containers.Map(
            nside=self.nside,
            polarisation=False,
            freq=_zlims_to_freq(centres, edges),
            attrs_from=cat,
            device=cat.device,
        )

        maps = _cat_to_maps(cat, self.nside, edges)

        u, s, vt = np.linalg.svd(maps, full_matrices=False)
        k = self.n_modes
        rec = (u[:, :k] * s[:k]) @ vt[:k]
        rec[rec < 0.0] = 0.0

        out = np.zeros(selfunc.map.shape)
        out[:, 0, :] = rec
        selfunc.map[:] = out

        _label_tracer(selfunc, self.tracer)
        return selfunc


class ResizeSelectionFunctionMap(ContainerTask):
    """Match a selection function to a source map's resolution/sampling.

    (reference mockcatalog.py:205-296)

    Attributes
    ----------
    smooth : bool
        Smooth the resized map on the original pixel scale (erases the
        imprint of the coarse pixelisation).
    """

    smooth = config.bool_prop(False)

    def process(self, selfunc, source_map):
        """Interpolate in redshift and regrade in angle."""
        from ..ops import regrid

        z_from = _freq_to_z(selfunc.index_map["freq"])
        z_onto = _freq_to_z(source_map.index_map["freq"])

        new_selfunc = containers.Map(
            polarisation=False, axes_from=source_map, attrs_from=source_map
        )

        # bin-width ratio keeps the interpolation density-conserving
        stencil = np.asarray(
            regrid.lanczos_forward_matrix(z_from["centre"], z_onto["centre"])
        )
        interp_m = stencil * np.outer(
            z_onto["width"], 1.0 / z_from["width"]
        )

        # Interpolate the frequency axis, then regrade the pixel axis
        sf = np.asarray(selfunc.map)[:, 0, :]
        sf_newz = interp_m @ sf

        nside = new_selfunc.nside
        resized = hpx.ud_grade(sf_newz, nside)

        if self.smooth:
            fwhm = hpx.nside2resol(selfunc.nside)
            resized = np.array(hpx.smooth_gaussian(resized, fwhm=fwhm, device=new_selfunc.device))

        resized = np.where(resized < 0, 0.0, resized)

        out = np.zeros(new_selfunc.map.shape)
        out[:, 0, :] = resized
        new_selfunc.map[:] = out

        return new_selfunc


class PdfGeneratorBase(ContainerTask):
    """Base class combining a source map and selection function into a PDF.

    (reference mockcatalog.py:299-386)
    """

    tracer = config.str_prop(None)

    def make_pdf_map(self, source_map, z_weights, selfunc=None,
                     uniform=False):
        """Normalised PDF = (1 + delta) * selfunc, weighted per z bin.

        ``uniform=True`` ignores the map values (delta_g = 0) without
        mutating the input container.
        """
        shape = np.asarray(source_map.map)[:, 0, :].shape
        if uniform:
            rho = np.ones(shape)
        else:
            rho = np.asarray(source_map.map)[:, 0, :] + 1.0
        if (rho < 0).any():
            self.log.error("The source map contains negative pixels.")

        rho = rho / np.mean(rho, axis=1)[:, np.newaxis]

        if selfunc is not None:
            sf = np.asarray(selfunc.map)[:, 0, :]
            if (sf < 0).any():
                self.log.error("The selection function contains negative pixels.")
            pdf = rho * sf
        else:
            pdf = rho

        pdf = (
            pdf
            * np.asarray(invert_no_zero(np.sum(pdf, axis=1)))[:, np.newaxis]
            * np.asarray(z_weights)[:, np.newaxis]
        )

        pdf_map = containers.Map(
            nside=source_map.nside,
            polarisation=False,
            freq=source_map.index_map["freq"],
            attrs_from=selfunc if selfunc is not None else source_map,
            device=source_map.device,
        )
        out = np.zeros(pdf_map.map.shape)
        out[:, 0, :] = pdf
        pdf_map.map[:] = out

        _label_tracer(pdf_map, self.tracer)
        return pdf_map

    def process(self):
        """Produce a pdf."""
        raise NotImplementedError(
            f"{self.__class__} is abstract: implement process()."
        )


class PdfGeneratorUncorrelated(PdfGeneratorBase):
    """Uniform PDF for uncorrelated mocks (reference mockcatalog.py:389)."""

    def process(self, source_map):
        """PDF with uniform z weights and delta_g = 0.

        The input container is NOT mutated (it may be shared with other
        pipeline branches).
        """
        gs = source_map.map.shape[0]
        z_weights = np.full(gs, 1.0 / gs)
        return self.make_pdf_map(source_map, z_weights, uniform=True)


class PdfGeneratorWithSelectionFunction(PdfGeneratorBase):
    """PDF including a selection function (reference mockcatalog.py:421)."""

    def process(self, source_map, selfunc):
        """Weight each z bin by the selection function's total."""
        sf = np.asarray(selfunc.map)[:, 0, :]
        z_weights = sf.sum(axis=1)
        z_weights = z_weights / z_weights.sum()
        return self.make_pdf_map(source_map, z_weights, selfunc)


class PdfGeneratorNoSelectionFunction(PdfGeneratorBase):
    """PDF with a trivial selection function (reference mockcatalog.py:457).

    Attributes
    ----------
    use_voxel_volumes : bool
        Weight z bins by their comoving voxel volume.
    """

    use_voxel_volumes = config.bool_prop(False)

    def process(self, source_map):
        """Uniform or volume-weighted z weights."""
        gs = source_map.map.shape[0]

        if not self.use_voxel_volumes:
            z_weights = np.full(gs, 1.0 / gs)
        else:
            from ..ops.cosmology import Cosmology

            cosmo = Cosmology()
            z_weights = np.zeros(gs)
            fmap = source_map.index_map["freq"]
            for fi in range(gs):
                fc, fw = fmap["centre"][fi], fmap["width"][fi]
                z_min = NU21 / (fc + 0.5 * fw) - 1
                z_max = NU21 / (fc - 0.5 * fw) - 1
                z_mean = NU21 / fc - 1
                z_weights[fi] = float(
                    np.asarray(cosmo.comoving_distance(z_mean)) ** 2
                    * (
                        np.asarray(cosmo.comoving_distance(z_max))
                        - np.asarray(cosmo.comoving_distance(z_min))
                    )
                )
            z_weights /= z_weights.sum()

        return self.make_pdf_map(source_map, z_weights)


class MockCatalogGenerator(ContainerTask, RandomTask):
    """Draw mock catalogs from a PDF map (reference mockcatalog.py:525).

    Attributes
    ----------
    nsource : int
        Sources per catalog.
    ncat : int
        Number of catalogs.
    z_at_channel_centers, srcs_at_pixel_centers : bool
        Place sources exactly at bin/pixel centres instead of dithering.
    """

    nsource = config.int_prop()
    ncat = config.int_prop()
    z_at_channel_centers = config.bool_prop(False)
    srcs_at_pixel_centers = config.bool_prop(False)

    def setup(self, pdf_map):
        """Precompute per-z CDFs from the PDF map."""
        self.pdf = pdf_map
        self.nside = self.pdf.nside
        self._ncat_done = 0

        pdf = np.asarray(self.pdf.map)[:, 0, :]
        self.z_weights = np.sum(pdf, axis=1)
        self.z_weights = self.z_weights / self.z_weights.sum()

        cdf = np.cumsum(pdf, axis=1)
        self.cdf = cdf * np.asarray(invert_no_zero(cdf[:, -1]))[:, np.newaxis]

    def process(self):
        """Draw the next mock catalog."""
        # a dedicated counter: ContainerTask.next() increments
        # self._count per output, so reusing it here advanced by 2 per
        # catalog and produced only half the requested number
        if self._ncat_done >= self.ncat:
            raise PipelineStopIteration

        source_numbers = self.rng.multinomial(self.nsource, self.z_weights)

        ang_size = np.rad2deg(hpx.nside2resol(self.nside))
        z_global = _freq_to_z(self.pdf.index_map["freq"][:])

        mock_zs = np.empty(self.nsource)
        mock_ra = np.empty(self.nsource)
        mock_dec = np.empty(self.nsource)

        offset = 0
        for zi, nbin in enumerate(source_numbers):
            if nbin == 0:
                continue
            rnbs = self.rng.uniform(size=nbin)
            pix_idxs = np.digitize(rnbs, self.cdf[zi])

            z_value = z_global["centre"][zi] * np.ones(nbin)
            if not self.z_at_channel_centers:
                z_value += z_global["width"][zi] * (
                    self.rng.uniform(size=nbin) - 0.5
                )

            dec, ra = _pix_to_radec(pix_idxs, self.nside)
            if not self.srcs_at_pixel_centers:
                dec = dec + ang_size * (self.rng.uniform(size=nbin) - 0.5)
                ra = ra + ang_size * (self.rng.uniform(size=nbin) - 0.5)

            sl = slice(offset, offset + nbin)
            mock_zs[sl] = z_value
            mock_ra[sl] = ra
            mock_dec[sl] = dec
            offset += nbin

        mock_catalog = _spectroscopic_catalog(
            mock_ra, mock_dec, mock_zs, attrs_from=self.pdf
        )
        self._ncat_done += 1
        return mock_catalog


class AddGaussianZErrorsToCatalog(ContainerTask, RandomTask):
    """Add Gaussian redshift errors to a catalog, in place.

    (reference mockcatalog.py:751-818)

    Attributes
    ----------
    use_catalog_z_errors : bool
        Use per-source ``z_error`` as the standard deviation.
    sigma : float
        Error scale (see ``sigma_type``).
    sigma_type : "sigma_z" | "sigma_z_over_1plusz"
    """

    use_catalog_z_errors = config.bool_prop(False)
    sigma = config.float_prop()
    sigma_type = config.enum(["sigma_z", "sigma_z_over_1plusz"])

    def process(self, cat):
        """Perturb the catalog redshifts."""
        red = np.asarray(cat["redshift"][:]).copy()
        cat_z = red["z"]

        z_err = self.rng.normal(size=cat_z.shape[0])
        if self.use_catalog_z_errors:
            scale = red["z_error"]
            if not np.any(scale):
                self.log.error(
                    "Warning: no existing z_error information in catalog, "
                    "so no z errors will be added"
                )
            z_err *= scale
        else:
            if self.sigma is None or self.sigma_type is None:
                raise ValueError(
                    "AddGaussianZErrorsToCatalog requires both `sigma` "
                    "and `sigma_type` when use_catalog_z_errors is "
                    "false (an unset sigma_type silently picked the "
                    "(1+z)-scaled model before)."
                )
            if self.sigma_type == "sigma_z":
                z_err *= self.sigma
            else:
                z_err *= self.sigma * (1 + cat_z)

        red["z"] = cat_z + z_err
        cat["redshift"][:] = red
        return cat


class AddEBOSSZErrorsToCatalog(ContainerTask, RandomTask):
    """Add eBOSS-like tracer-specific redshift errors, in place.

    (reference mockcatalog.py:821-1072)

    Attributes
    ----------
    tracer : "QSO" | "ELG" | "LRG" | "QSOalt"
        Error model; auto-detected from the catalog attrs/tag if unset.
    """

    tracer = config.enum(["QSO", "ELG", "LRG", "QSOalt"], default=None)

    def process(self, cat):
        """Perturb the catalog redshifts with the tracer's error model."""
        tracer = self.tracer

        if tracer is None:
            # case-insensitive matching ('QSOalt' is mixed case), and
            # longest key first so 'QSOALT_MOCK' resolves to QSOalt, not
            # its QSO prefix
            norm = {k.upper(): k for k in _velocity_error_function_lookup}
            if "tracer" in cat.attrs:
                t_up = str(cat.attrs["tracer"]).upper()
                if t_up not in norm:
                    raise ValueError(
                        f"Tracer explicitly set to "
                        f"'{cat.attrs['tracer']}' in catalog, "
                        "but value not supported."
                    )
                tracer = norm[t_up]
            else:
                tag_up = str(cat.attrs.get("tag", "")).upper()
                for k_up in sorted(norm, key=len, reverse=True):
                    if k_up in tag_up:
                        tracer = norm[k_up]
                        break
                if tracer is None:
                    raise ValueError(
                        "No eBOSS tracer found: set the config property or put a "
                        "'tracer'/'tag' attribute on the catalog."
                    )

        self.log.info(f"Adding redshift scatter for tracer {tracer}.")

        red = np.asarray(cat["redshift"][:]).copy()
        z = red["z"]
        red["z"] = z + self._generate_z_errors(z, tracer)
        cat["redshift"][:] = red
        return cat

    def _generate_z_errors(self, z, tracer):
        """dz = (1 + z) dv / c (see arXiv:1012.2912 Eq. A1)."""
        err_func = _velocity_error_function_lookup[tracer]
        dv = err_func(z, self.rng)
        return (1.0 + z) * dv / (C_LIGHT * 1e-3)

    @staticmethod
    def qso_velocity_error(z, rng):
        """Two-Gaussian QSO velocity errors (arXiv:2007.09001 Fig. 4)."""
        QSO_SIG1, QSO_SIG2, QSO_F = 150.0, 1000.0, 4.478
        n = len(z)
        dv1 = rng.normal(scale=QSO_SIG1, size=n)
        dv2 = rng.normal(scale=QSO_SIG2, size=n)
        u = rng.uniform(size=n)
        return np.where(u >= (1.0 / (1.0 + QSO_F)), dv1, dv2)

    @staticmethod
    def qsoalt_velocity_error(z, rng):
        """Redshift-dependent two-Gaussian QSO model (reference :960)."""
        QSO_SIG1_highz, QSO_SIG1_lowz, QSO_SIG2 = 150.0, 90.0, 1000.0
        QSO_F_highz, QSO_ztrans, QSO_zwidth = 35.0, 1.0, 0.05

        def smooth_step(z, zt, zw, fl, fh):
            ramp = 0.5 * (1 + np.tanh((z - zt) / zw))
            return fl + ramp * (fh - fl)

        invf = smooth_step(z, QSO_ztrans, QSO_zwidth, 0, 1 / QSO_F_highz)
        sig1 = smooth_step(
            z, QSO_ztrans, QSO_zwidth, QSO_SIG1_lowz, QSO_SIG1_highz
        )
        n = len(z)
        u = rng.uniform(size=n)
        flag = u >= (invf / (1.0 + invf))
        dv1 = rng.standard_normal(n) * sig1
        dv2 = rng.standard_normal(n) * QSO_SIG2
        return np.where(flag, dv1, dv2)

    @staticmethod
    def lrg_velocity_error(z, rng):
        """Gaussian LRG velocity errors (arXiv:2007.09000, 65.6 km/s)."""
        return rng.normal(scale=65.6, size=len(z))

    @staticmethod
    def elg_velocity_error(z, rng):
        """Tukey-lambda ELG velocity errors (arXiv:2007.09007 Sec 2.3)."""
        import scipy.stats

        ELG_SIG, ELG_LAMBDA = 11.877, -0.4028
        return scipy.stats.tukeylambda.rvs(
            ELG_LAMBDA, scale=ELG_SIG, size=len(z), random_state=rng
        )


_velocity_error_function_lookup = {
    "QSO": AddEBOSSZErrorsToCatalog.qso_velocity_error,
    "QSOalt": AddEBOSSZErrorsToCatalog.qsoalt_velocity_error,
    "ELG": AddEBOSSZErrorsToCatalog.elg_velocity_error,
    "LRG": AddEBOSSZErrorsToCatalog.lrg_velocity_error,
}


class MapPixelLocationGenerator(ContainerTask):
    """Catalog of Healpix pixel centres (reference mockcatalog.py:1083).

    Attributes
    ----------
    freq_idx : int
        Frequency channel assigned to every "source".
    """

    freq_idx = config.int_prop()

    def setup(self, in_map):
        """Pre-load map geometry."""
        self.map_ = in_map
        self.npix = len(self.map_.index_map["pixel"])
        self.nside = self.map_.nside
        z_arr = _freq_to_z(self.map_.index_map["freq"])
        self.z = z_arr[self.freq_idx]["centre"]
        self._done = False

    def process(self):
        """Emit the pixel-centre catalog once."""
        if self._done:
            raise PipelineStopIteration

        pix_dec, pix_ra = _pix_to_radec(np.arange(self.npix), self.nside)
        mock_catalog = _spectroscopic_catalog(pix_ra, pix_dec, self.z, device=self.map_.device)
        self._done = True
        return mock_catalog


# ---------------------------------------------------------------------------
# Internal helpers (reference mockcatalog.py:1177-1306)
# ---------------------------------------------------------------------------


def _spectroscopic_catalog(ra, dec, z, attrs_from=None, device=None):
    """SpectroscopicCatalog with filled position/redshift tables, on the
    device of ``attrs_from`` (or ``device``)."""
    n = len(np.atleast_1d(ra))
    cat = containers.SpectroscopicCatalog(
        object_id=np.arange(n, dtype=np.uint64),
        attrs_from=attrs_from,
        device=attrs_from.device if attrs_from is not None else device,
    )
    pos = np.zeros(n, dtype=[("ra", np.float64), ("dec", np.float64)])
    pos["ra"], pos["dec"] = ra, dec
    red = np.zeros(n, dtype=[("z", np.float64), ("z_error", np.float64)])
    red["z"] = z
    cat["position"][:] = pos
    cat["redshift"][:] = red
    return cat


def _label_tracer(cont, tracer):
    """Record the tracer name on a container when one is configured."""
    if tracer is not None:
        cont.attrs["tracer"] = tracer


def _zlims_to_freq(z, zlims):
    """Redshift bins -> structured frequency axis (reference :1177)."""
    edges = NU21 / (np.asarray(zlims) + 1)
    out = np.zeros(len(z), dtype=[("centre", "<f8"), ("width", "<f8")])
    out["centre"] = NU21 / (np.asarray(z) + 1)
    out["width"] = abs(np.diff(edges))
    return out


def _freq_to_z(freq):
    """Structured frequency axis -> redshift bins (reference :1201)."""
    fc = freq["centre"]
    fw = freq["width"]

    direction = np.sign(fc[-1] - fc[0])
    edges = np.append(
        fc - direction * 0.5 * fw, fc[-1] + direction * 0.5 * fw[-1]
    )
    z_edges = NU21 / edges - 1.0

    out = np.zeros(len(fc), dtype=[("centre", "<f8"), ("width", "<f8")])
    out["centre"] = NU21 / fc - 1.0
    out["width"] = abs(np.diff(z_edges))
    return out


def _pix_to_radec(index, nside):
    """RING pixel indices -> (dec, RA) in degrees (reference :1231)."""
    theta, phi = hpx.pix2ang(nside, np.asarray(index))
    return 90.0 - np.degrees(theta), np.degrees(phi)


def _radec_to_pix(ra, dec, nside):
    """(RA, dec) in degrees -> nearest RING pixels (reference :1250)."""
    return hpx.ang2pix(nside, np.radians(-np.asarray(dec) + 90.0), np.radians(ra))


def _cat_to_maps(cat, nside, zlims_selfunc):
    """Grid a catalog into [n_z, n_pix] count maps (reference :1268).

    The reference scans every pixel per z bin (O(n_z * n_pix * nsrc));
    here it is one 2D bincount over (z bin, pixel) pairs.
    """
    n_pix = hpx.npix_of(nside)
    n_z = len(zlims_selfunc) - 1

    red = np.asarray(cat["redshift"][:])
    pos = np.asarray(cat["position"][:])
    idxs = np.digitize(red["z"], zlims_selfunc) - 1
    pixels = np.asarray(_radec_to_pix(pos["ra"], pos["dec"], nside))

    good = (idxs >= 0) & (idxs < n_z)
    flat = idxs[good] * n_pix + pixels[good]
    counts = np.bincount(flat, minlength=n_z * n_pix)
    return counts.reshape(n_z, n_pix).astype(np.float64)
