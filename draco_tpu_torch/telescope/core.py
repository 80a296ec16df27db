"""Transit telescope models.

Native replacement for ``drift.core.telescope.TransitTelescope`` covering
the API surface the reference task library uses (SURVEY.md section 1 L0):
lmax/mmax/nfreq/num_pol_sky/frequencies/feeds/input_index/npairs/
uniquepairs/nbase/redundancy/baselines/latitude/feedmap/feedconj/feedmask/
index_map_prod/index_map_stack/reverse_map_stack, plus Observer time
conversions (unix_to_lsd, lsd_to_unix, unix_to_lsa, lsa).

The geometry convention: the sky is a unit sphere in equatorial-like
coordinates with the telescope zenith at colatitude ``pi/2 - latitude`` and
azimuth 0 at LSA = 0.  Baselines are (EW, NS) metre offsets mapped onto the
local east/north tangent vectors at zenith; the fringe for baseline ``b``
is ``exp(2 pi i (b . n) / lambda)``.
"""

from __future__ import annotations

import numpy as np

from ..core import config
from ..ops import healpix

# Sidereal day in seconds and an arbitrary LSD epoch (unix time).
SIDEREAL_DAY = 86164.0905
LSD_EPOCH = 946684800.0  # 2000-01-01 UTC

C_LIGHT = 299.792458  # m MHz (c in m * MHz units: lambda[m] = C_LIGHT / freq[MHz])


class TransitTelescope(config.Reader):
    """Base class for drift-scan transit telescopes.

    Subclasses provide feed positions/classes and the primary beam model;
    this base derives baselines, redundancy, index maps and band limits.
    """

    latitude = config.float_prop(45.0)
    longitude = config.float_prop(0.0)
    altitude = config.float_prop(0.0)
    # Telescope rotation from true north in degrees (used by the hybrid
    # beamformed deconvolution path, reference analysis/beam.py:119)
    rotation_angle = config.float_prop(0.0)

    freq_lower = config.float_prop(400.0)
    freq_upper = config.float_prop(800.0)
    num_freq = config.int_prop(4)
    freq_mode = config.enum(["centre", "edge"], default="centre")

    auto_correlations = config.bool_prop(False)
    # Band-limit boosts (driftscan's accuracy_boost/l_boost equivalents)
    accuracy_boost = config.float_prop(1.0)
    l_boost = config.float_prop(1.0)
    # Explicit band limits (override the derived values when set)
    force_lmax = config.int_prop(None)
    force_mmax = config.int_prop(None)

    tsys_flat = config.float_prop(50.0)
    ndays = config.float_prop(733.0)

    # Minimum |baseline| to include (metres)
    minlength = config.float_prop(0.0)
    maxlength = config.float_prop(1.0e7)

    def __init__(self, latitude=None, longitude=None, **kwargs):
        if latitude is not None:
            self.latitude = latitude
        if longitude is not None:
            self.longitude = longitude
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._baseline_cache = None

    # -- frequencies ---------------------------------------------------------
    @property
    def frequencies(self) -> np.ndarray:
        """Channel centre frequencies in MHz."""
        if self.freq_mode == "centre":
            return np.linspace(
                self.freq_lower, self.freq_upper, self.num_freq, endpoint=False
            )
        edges = np.linspace(self.freq_lower, self.freq_upper, self.num_freq + 1)
        return 0.5 * (edges[1:] + edges[:-1])

    @property
    def nfreq(self) -> int:
        return len(self.frequencies)

    @property
    def wavelengths(self) -> np.ndarray:
        return C_LIGHT / self.frequencies

    @property
    def freq_start(self) -> float:
        """Band start: the highest frequency in MHz (driftscan convention)."""
        return max(self.freq_lower, self.freq_upper)

    @property
    def freq_end(self) -> float:
        """Band end: the lowest frequency in MHz."""
        return min(self.freq_lower, self.freq_upper)

    # -- feeds (subclass responsibility) ----------------------------------
    @property
    def feedpositions(self) -> np.ndarray:  # pragma: no cover - abstract
        """[nfeed, 2] (EW, NS) positions in metres."""
        raise NotImplementedError

    @property
    def beamclass(self) -> np.ndarray:
        """Beam class of each feed (feeds of equal class are identical)."""
        return np.zeros(self.nfeed, dtype=int)

    @property
    def nfeed(self) -> int:
        return len(self.feedpositions)

    @property
    def feeds(self) -> np.ndarray:
        return self.input_index

    @property
    def input_index(self) -> np.ndarray:
        out = np.zeros(
            self.nfeed,
            dtype=[("chan_id", np.int64), ("correlator_input", "<U32")],
        )
        out["chan_id"] = np.arange(self.nfeed)
        out["correlator_input"] = [f"feed{fi:04d}" for fi in range(self.nfeed)]
        return out

    # -- polarisation ----------------------------------------------------------
    @property
    def num_pol_sky(self) -> int:
        """Number of sky polarisation components (1 = T, 4 = T,Q,U,V)."""
        return 1

    @property
    def polarisation(self) -> np.ndarray:
        """Polarisation label of each feed (single-pol default: 'X')."""
        return np.where(self.beamclass % 2 == 0, "X", "Y")

    # -- band limits --------------------------------------------------------
    @property
    def u_max(self) -> float:
        bl = np.linalg.norm(self.baselines, axis=1).max()
        return bl / self.wavelengths.min()

    @property
    def lmax(self) -> int:
        if self.force_lmax is not None:
            return self.force_lmax
        lm = int(np.ceil(2 * np.pi * self.u_max * self.accuracy_boost + 1))
        return int(np.ceil(lm * self.l_boost))

    @property
    def mmax(self) -> int:
        if self.force_mmax is not None:
            return self.force_mmax
        return self.lmax

    # -- baselines / redundancy ---------------------------------------------
    def _compute_baselines(self):
        """Find unique baselines among all feed pairs.

        Produces feedmap/feedconj/feedmask [nfeed, nfeed], the unique pair
        list, baseline vectors and redundancy counts (the driftscan
        equivalents consumed at reference draco/synthesis/stream.py:150-165,
        draco/util/tools.py:359-414).
        """
        if self._baseline_cache is not None:
            return self._baseline_cache

        pos = np.asarray(self.feedpositions)
        bc = np.asarray(self.beamclass)
        nfeed = self.nfeed

        feedmap = -np.ones((nfeed, nfeed), dtype=int)
        feedconj = np.zeros((nfeed, nfeed), dtype=bool)
        feedmask = np.ones((nfeed, nfeed), dtype=bool)

        # every pair (i <= j) in the order of the reference's double loop
        ii, jj = np.triu_indices(nfeed)
        bl = pos[ii] - pos[jj]
        # canonical orientation: EW > 0, or EW == 0 and NS >= 0
        conj = (bl[:, 0] < -1e-9) | ((np.abs(bl[:, 0]) < 1e-9) & (bl[:, 1] < -1e-9))
        ci = np.where(conj, jj, ii)
        cj = np.where(conj, ii, jj)
        bl = np.where(conj[:, None], -bl, bl)
        auto = ii == jj
        blen = np.hypot(bl[:, 0], bl[:, 1])
        keep = np.where(auto, bool(self.auto_correlations), (self.minlength <= blen) & (blen <= self.maxlength))
        feedmask[ii[~keep], jj[~keep]] = False
        feedmask[jj[~keep & ~auto], ii[~keep & ~auto]] = False
        ii, jj, ci, cj, bl, conj = ii[keep], jj[keep], ci[keep], cj[keep], bl[keep], conj[keep]

        # a pair's key: its beam classes and its baseline rounded as Python's
        # round(x, 6) does (each distinct value rounded once; + 0.0 makes
        # -0.0 the 0.0 that dict keys equate it with), each column coded by
        # its distinct values and the codes combined into one integer
        def codes(x, rounding):
            vals, inv = np.unique(x, return_inverse=True)
            if rounding:
                vals, inv2 = np.unique(np.array([round(float(v), 6) for v in vals]) + 0.0, return_inverse=True)
                inv = inv2[inv]
            return inv.ravel().astype(np.int64), len(vals)

        key = np.zeros(len(ii), dtype=np.int64)
        for col, rounding in ((bc[ci], False), (bc[cj], False), (bl[:, 0], True), (bl[:, 1], True)):
            code, n = codes(col, rounding)
            key = key * n + code
        _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
        # number the unique keys in the order the loop first meets them
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        idx = rank[inverse.ravel()]
        head = first[order]

        feedmap[ii, jj] = idx
        feedmap[jj, ii] = idx
        feedconj[ii, jj] = conj
        feedconj[jj, ii] = np.where(ii != jj, ~conj, False)
        uniquepairs = np.stack([ci[head], cj[head]], axis=1)
        baselines = bl[head]
        redundancy = np.bincount(idx, minlength=len(head))

        self._baseline_cache = {
            "feedmap": feedmap,
            "feedconj": feedconj,
            "feedmask": feedmask,
            "uniquepairs": np.array(uniquepairs, dtype=int).reshape(-1, 2),
            "baselines": np.array(baselines, dtype=float).reshape(-1, 2),
            "redundancy": np.array(redundancy, dtype=int),
        }
        return self._baseline_cache

    @property
    def feedmap(self):
        return self._compute_baselines()["feedmap"]

    @property
    def feedconj(self):
        return self._compute_baselines()["feedconj"]

    @property
    def feedmask(self):
        return self._compute_baselines()["feedmask"]

    @property
    def uniquepairs(self):
        return self._compute_baselines()["uniquepairs"]

    @property
    def baselines(self):
        return self._compute_baselines()["baselines"]

    @property
    def redundancy(self):
        return self._compute_baselines()["redundancy"]

    @property
    def npairs(self) -> int:
        return len(self.uniquepairs)

    @property
    def nbase(self) -> int:
        return self.npairs

    # -- index maps (stacked-container conventions) ----------------------------
    @property
    def index_map_prod(self) -> np.ndarray:
        """Full upper-triangle product map."""
        nfeed = self.nfeed
        prods = [(fi, fj) for fi in range(nfeed) for fj in range(fi, nfeed)]
        out = np.zeros(len(prods), dtype=[("input_a", "<u2"), ("input_b", "<u2")])
        out["input_a"] = [p[0] for p in prods]
        out["input_b"] = [p[1] for p in prods]
        return out

    @property
    def index_map_stack(self) -> np.ndarray:
        """Representative product for each unique baseline."""
        prod = self.index_map_prod
        lookup = {
            (int(a), int(b)): pi
            for pi, (a, b) in enumerate(zip(prod["input_a"], prod["input_b"]))
        }
        out = np.zeros(self.npairs, dtype=[("prod", "<u4"), ("conjugate", "u1")])
        for si, (ci, cj) in enumerate(self.uniquepairs):
            if (int(ci), int(cj)) in lookup:
                out[si] = (lookup[(int(ci), int(cj))], 0)
            else:
                out[si] = (lookup[(int(cj), int(ci))], 1)
        return out

    @property
    def reverse_map_stack(self) -> np.ndarray:
        """Stack index for every product."""
        prod = self.index_map_prod
        out = np.zeros(len(prod), dtype=[("stack", "<u4"), ("conjugate", "u1")])
        fm, fc = self.feedmap, self.feedconj
        for pi, (a, b) in enumerate(zip(prod["input_a"], prod["input_b"])):
            out[pi] = (fm[a, b], fc[a, b])
        return out

    # -- observer time conversions -----------------------------------------------
    def unix_to_lsd(self, time) -> np.ndarray:
        """Local sidereal day (fractional) for unix time."""
        time = np.asarray(time, dtype=np.float64)
        return (time - LSD_EPOCH) / SIDEREAL_DAY + self.longitude / 360.0

    def lsd_to_unix(self, lsd) -> np.ndarray:
        lsd = np.asarray(lsd, dtype=np.float64)
        return (lsd - self.longitude / 360.0) * SIDEREAL_DAY + LSD_EPOCH

    def unix_to_lsa(self, time) -> np.ndarray:
        """Local stellar angle (transiting RA) in degrees."""
        return (self.unix_to_lsd(time) % 1.0) * 360.0

    lsa = unix_to_lsa

    def lsa_to_unix(self, lsa, time0) -> np.ndarray:
        """First unix time after ``time0`` at which the LSA is ``lsa``."""
        lsd0 = self.unix_to_lsd(time0)
        target = np.floor(lsd0) + np.asarray(lsa) / 360.0
        target = np.where(target < lsd0, target + 1.0, target)
        return self.lsd_to_unix(target)

    # -- geometry helpers ---------------------------------------------------
    @property
    def zenith(self) -> np.ndarray:
        """Unit vector of the telescope zenith (LSA = 0)."""
        colat = np.pi / 2 - np.radians(self.latitude)
        return np.array([np.sin(colat), 0.0, np.cos(colat)])

    @property
    def _local_frame(self):
        """(east, north) unit tangent vectors at zenith."""
        colat = np.pi / 2 - np.radians(self.latitude)
        east = np.array([0.0, 1.0, 0.0])
        north = np.array([-np.cos(colat), 0.0, np.sin(colat)])
        return east, north

    def baseline_vectors_3d(self) -> np.ndarray:
        """Unique baselines as 3D vectors in the sky frame [nbase, 3]."""
        east, north = self._local_frame
        bl = self.baselines
        return bl[:, 0:1] * east[None, :] + bl[:, 1:2] * north[None, :]

    def horizon_mask(self, nside: int) -> np.ndarray:
        """1 above the horizon, 0 below, for a healpix grid."""
        vec = healpix.pix2vec(nside)
        return (vec @ self.zenith > 0).astype(np.float64)

    # -- beams (subclass responsibility) --------------------------------------
    def beam_at(self, feed: int, freq_ind: int, angpos: np.ndarray) -> np.ndarray:
        """Evaluate the primary beam at sky positions [n, 2] = (theta, phi).

        Theta is the celestial colatitude (pi/2 - dec), phi the hour angle
        relative to the meridian.  Default implementation samples the beam
        amplitude formula directly (subclasses may override).
        """
        raise NotImplementedError

    def beam(self, feed: int, freq_ind: int, nside: int) -> np.ndarray:
        """Primary beam of ``feed`` at channel ``freq_ind``.

        Unpolarised telescopes return a real/complex amplitude map [npix];
        polarised telescopes return [npix, 2] (E_theta, E_phi) components.
        """
        raise NotImplementedError

    @property
    def prodstack(self) -> np.ndarray:
        """Representative input pairs of the unique baselines (structured)."""
        up = self.uniquepairs
        out = np.zeros(len(up), dtype=[("input_a", "<u2"), ("input_b", "<u2")])
        out["input_a"], out["input_b"] = up[:, 0], up[:, 1]
        return out

    @property
    def stack_type(self) -> str:
        return "redundant"

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)


# ---------------------------------------------------------------------------
# Beam helpers
# ---------------------------------------------------------------------------


def _sphere_basis(nside: int):
    """(n, theta_hat, phi_hat) arrays on the healpix grid."""
    theta, phi = healpix.pix2ang(nside)
    st, ct = np.sin(theta), np.cos(theta)
    sp, cp = np.sin(phi), np.cos(phi)
    n = np.stack([st * cp, st * sp, ct], axis=-1)
    theta_hat = np.stack([ct * cp, ct * sp, -st], axis=-1)
    phi_hat = np.stack([-sp, cp, np.zeros_like(sp)], axis=-1)
    return n, theta_hat, phi_hat


def _angpos_to_vec(angpos: np.ndarray) -> np.ndarray:
    """Convert (theta, phi) sky positions to unit vectors [n, 3]."""
    angpos = np.atleast_2d(angpos)
    st = np.sin(angpos[:, 0])
    return np.stack(
        [st * np.cos(angpos[:, 1]), st * np.sin(angpos[:, 1]), np.cos(angpos[:, 0])],
        axis=-1,
    )


def gaussian_beam_amplitude_vec(
    tel: TransitTelescope, vec: np.ndarray, fwhm: float
) -> np.ndarray:
    """Gaussian amplitude beam evaluated at unit vectors, horizon-masked."""
    cos_sep = np.clip(vec @ tel.zenith, -1.0, 1.0)
    sep = np.arccos(cos_sep)
    sigma2 = (fwhm / (2 * np.sqrt(2 * np.log(2)))) ** 2
    amp = np.exp(-(sep**2) / (4 * sigma2))
    return amp * (vec @ tel.zenith > 0)


def gaussian_beam_amplitude(
    tel: TransitTelescope, nside: int, fwhm: float
) -> np.ndarray:
    """Gaussian power-pattern amplitude around zenith, horizon-masked.

    ``fwhm`` in radians is the FWHM of the *power* beam |A|^2.
    """
    return gaussian_beam_amplitude_vec(tel, healpix.pix2vec(nside), fwhm)


class SimpleUnpolarisedTelescope(TransitTelescope):
    """Unpolarised telescope with a Gaussian primary beam.

    The driftscan ``SimpleUnpolarisedTelescope`` equivalent: single
    beamclass, scalar beams, num_pol_sky = 1.
    """

    dish_width = config.float_prop(5.0)
    fwhm_factor = config.float_prop(1.0)

    @property
    def num_pol_sky(self) -> int:
        return 1

    def beam(self, feed: int, freq_ind: int, nside: int) -> np.ndarray:
        lam = self.wavelengths[freq_ind]
        fwhm = self.fwhm_factor * lam / self.dish_width
        return gaussian_beam_amplitude(self, nside, fwhm)

    def beam_at(self, feed: int, freq_ind: int, angpos: np.ndarray) -> np.ndarray:
        lam = self.wavelengths[freq_ind]
        fwhm = self.fwhm_factor * lam / self.dish_width
        return gaussian_beam_amplitude_vec(self, _angpos_to_vec(angpos), fwhm)


class SimplePolarisedTelescope(TransitTelescope):
    """Dual-pol telescope: X (EW) and Y (NS) feeds with Gaussian envelopes.

    Feeds 0..nfeed/2-1 are X, the rest Y (beamclass 0/1); num_pol_sky = 4.
    """

    dish_width = config.float_prop(5.0)
    fwhm_factor = config.float_prop(1.0)

    @property
    def num_pol_sky(self) -> int:
        return 4

    @property
    def polarisation(self) -> np.ndarray:
        return np.where(self.beamclass == 0, "X", "Y")

    def beam(self, feed: int, freq_ind: int, nside: int) -> np.ndarray:
        lam = self.wavelengths[freq_ind]
        fwhm = self.fwhm_factor * lam / self.dish_width
        amp = gaussian_beam_amplitude(self, nside, fwhm)
        _, theta_hat, phi_hat = _sphere_basis(nside)
        east, north = self._local_frame
        pol_vec = east if self.beamclass[feed] == 0 else north
        Et = amp * (theta_hat @ pol_vec)
        Ep = amp * (phi_hat @ pol_vec)
        return np.stack([Et, Ep], axis=-1)

    def beam_at(self, feed: int, freq_ind: int, angpos: np.ndarray) -> np.ndarray:
        lam = self.wavelengths[freq_ind]
        fwhm = self.fwhm_factor * lam / self.dish_width
        angpos = np.atleast_2d(angpos)
        vec = _angpos_to_vec(angpos)
        amp = gaussian_beam_amplitude_vec(self, vec, fwhm)
        theta, phi = angpos[:, 0], angpos[:, 1]
        st, ct = np.sin(theta), np.cos(theta)
        sp, cp = np.sin(phi), np.cos(phi)
        theta_hat = np.stack([ct * cp, ct * sp, -st], axis=-1)
        phi_hat = np.stack([-sp, cp, np.zeros_like(sp)], axis=-1)
        east, north = self._local_frame
        pol_vec = east if self.beamclass[feed] == 0 else north
        return np.stack(
            [amp * (theta_hat @ pol_vec), amp * (phi_hat @ pol_vec)], axis=-1
        )


class _DishGridMixin:
    """Feed layout on a (jitterable) rectangular dish grid.

    ``jitter`` perturbs each position by a deterministic uniform offset —
    a jittered grid has no redundant baselines, which makes it the
    standard non-redundant benchmark configuration (all n(n+1)/2 pairs
    distinct).
    """

    grid_ew = config.int_prop(4)
    grid_ns = config.int_prop(4)
    spacing_ew = config.float_prop(6.0)
    spacing_ns = config.float_prop(6.0)
    jitter = config.float_prop(0.0)
    jitter_seed = config.int_prop(0)

    @property
    def _single_pol_positions(self) -> np.ndarray:
        ew, ns = np.meshgrid(
            np.arange(self.grid_ew) * self.spacing_ew,
            np.arange(self.grid_ns) * self.spacing_ns,
            indexing="ij",
        )
        pos = np.stack([ew.ravel(), ns.ravel()], axis=-1)
        if self.jitter > 0.0:
            rng = np.random.Generator(np.random.SFC64(self.jitter_seed))
            pos = pos + rng.uniform(-self.jitter, self.jitter, pos.shape)
        return pos


class UnpolarisedDishArray(_DishGridMixin, SimpleUnpolarisedTelescope):
    """A rectangular grid of unpolarised dishes."""

    @property
    def feedpositions(self) -> np.ndarray:
        return self._single_pol_positions


class PolarisedDishArray(_DishGridMixin, SimplePolarisedTelescope):
    """A rectangular grid of dual-pol dishes (X then Y at each position).

    The polarised counterpart of :class:`UnpolarisedDishArray` — smooth
    Gaussian envelopes with the feed polarisation vector projected onto
    the sphere basis, so the (T, Q, U, V) beam products are analytic
    and golden-testable.
    """

    @property
    def feedpositions(self) -> np.ndarray:
        single = self._single_pol_positions
        return np.concatenate([single, single], axis=0)

    @property
    def beamclass(self) -> np.ndarray:
        nsingle = len(self._single_pol_positions)
        return np.concatenate(
            [np.zeros(nsingle, dtype=int), np.ones(nsingle, dtype=int)]
        )


class _CylinderMixin:
    """Feed layout along the focal lines of N-S oriented cylinders."""

    num_cylinders = config.int_prop(2)
    cylinder_width = config.float_prop(20.0)
    cylinder_spacing = config.float_prop(20.0)
    num_feeds = config.int_prop(8)
    feed_spacing = config.float_prop(0.5)

    @property
    def _single_pol_positions(self) -> np.ndarray:
        pos = []
        for ci in range(self.num_cylinders):
            for fi in range(self.num_feeds):
                pos.append([ci * self.cylinder_spacing, fi * self.feed_spacing])
        return np.array(pos)


class UnpolarisedCylinderTelescope(_CylinderMixin, SimpleUnpolarisedTelescope):
    """Cylinder telescope with unpolarised feeds.

    The beam is a separable EW (aperture-diffraction over the cylinder
    width) x NS (wide) envelope, horizon masked.
    """

    @property
    def feedpositions(self) -> np.ndarray:
        return self._single_pol_positions

    def beam(self, feed: int, freq_ind: int, nside: int) -> np.ndarray:
        lam = self.wavelengths[freq_ind]
        vec = healpix.pix2vec(nside)
        east, north = self._local_frame
        z = self.zenith
        # direction cosines in the local frame
        x_e = vec @ east
        x_n = vec @ north
        # EW: sinc envelope of the cylinder aperture; NS: broad Gaussian
        ew_amp = np.sinc(self.cylinder_width / lam * x_e)
        ns_amp = np.exp(-(x_n**2) / (2 * 0.5**2))
        return ew_amp * ns_amp * (vec @ z > 0)


class PolarisedCylinderTelescope(_CylinderMixin, SimplePolarisedTelescope):
    """Cylinder telescope with dual-pol feeds (X then Y on each cylinder).

    Mirrors the driftscan telescope used by the reference's end-to-end test
    products (reference test/products_config.yaml).
    """

    @property
    def feedpositions(self) -> np.ndarray:
        single = self._single_pol_positions
        return np.concatenate([single, single], axis=0)

    @property
    def beamclass(self) -> np.ndarray:
        nsingle = len(self._single_pol_positions)
        return np.concatenate(
            [np.zeros(nsingle, dtype=int), np.ones(nsingle, dtype=int)]
        )

    def beam(self, feed: int, freq_ind: int, nside: int) -> np.ndarray:
        lam = self.wavelengths[freq_ind]
        vec = healpix.pix2vec(nside)
        east, north = self._local_frame
        x_e = vec @ east
        x_n = vec @ north
        ew_amp = np.sinc(self.cylinder_width / lam * x_e)
        ns_amp = np.exp(-(x_n**2) / (2 * 0.5**2))
        amp = ew_amp * ns_amp * (vec @ self.zenith > 0)
        _, theta_hat, phi_hat = _sphere_basis(nside)
        pol_vec = east if self.beamclass[feed] == 0 else north
        Et = amp * (theta_hat @ pol_vec)
        Ep = amp * (phi_hat @ pol_vec)
        return np.stack([Et, Ep], axis=-1)
