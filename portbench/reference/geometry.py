"""HEALPix rings and the telescopes of the benchmark's configurations, in
plain float64 numpy.

Everything here is worked out again from a configuration's numbers: the
RING scheme's ring table and pixel vectors, the feed layout, the table of
unique baselines (the driftscan convention: pairs i <= j in row order, each
baseline turned to point east, or north where it has no east part, and
keyed by its two beam classes and its (EW, NS) offset rounded to a
micrometre, numbered in the order the pairs first meet a key), and the beam
products of each pair of beam classes.
"""

from __future__ import annotations

import numpy as np

C_LIGHT = 299.792458  # m MHz

DISH = "UnpolarisedDishArray"
POL_CYLINDER = "PolarisedCylinderTelescope"


def rings(nside: int):
    """(theta, nphi, phi0, offset), one entry a ring of the RING scheme."""
    i = np.arange(1, 4 * nside)
    north, south = i < nside, i > 3 * nside
    cap = np.where(north, i, 4 * nside - i)
    z = np.where(north, 1 - cap**2 / (3.0 * nside**2), 4.0 / 3.0 - 2.0 * i / (3.0 * nside))
    z = np.where(south, -(1 - cap**2 / (3.0 * nside**2)), z)
    nphi = np.where(north | south, 4 * cap, 4 * nside).astype(np.int64)
    phi0 = np.where(north | south, np.pi / nphi, np.pi / (4 * nside) * ((i - nside + 1) % 2))
    offset = np.concatenate([[0], np.cumsum(nphi)[:-1]])
    return np.arccos(z), nphi, phi0, offset


def pixel_vectors(nside: int) -> np.ndarray:
    """Unit vector of every pixel centre, [npix, 3]."""
    theta, nphi, phi0, _ = rings(nside)
    th = np.repeat(theta, nphi)
    phi = np.concatenate([p + 2 * np.pi * np.arange(n) / n for p, n in zip(phi0, nphi)])
    st = np.sin(th)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(th)], axis=-1)


def pixel_basis(nside: int):
    """(theta_hat, phi_hat) of every pixel centre, each [npix, 3]."""
    theta, nphi, phi0, _ = rings(nside)
    th = np.repeat(theta, nphi)
    phi = np.concatenate([p + 2 * np.pi * np.arange(n) / n for p, n in zip(phi0, nphi)])
    st, ct, sp, cp = np.sin(th), np.cos(th), np.sin(phi), np.cos(phi)
    return np.stack([ct * cp, ct * sp, -st], -1), np.stack([-sp, cp, np.zeros_like(sp)], -1)


class Telescope:
    """A configuration's telescope: feeds, unique baselines and beams."""

    def __init__(self, telescope: dict, band: dict, nside: int, lmax: int, mmax: int):
        self.kind = telescope["class"]
        if self.kind not in (DISH, POL_CYLINDER):
            raise ValueError(f"the reference knows no telescope {self.kind!r}")
        self.p = dict(telescope)
        self.nside, self.lmax, self.mmax = nside, lmax, mmax
        lo, hi, n = band["freq_lower"], band["freq_upper"], band["num_freq"]
        self.frequencies = np.linspace(lo, hi, n, endpoint=False)
        self.wavelengths = C_LIGHT / self.frequencies
        colat = np.pi / 2 - np.radians(self.p["latitude"])
        self.zenith = np.array([np.sin(colat), 0.0, np.cos(colat)])
        self.east = np.array([0.0, 1.0, 0.0])
        self.north = np.array([-np.cos(colat), 0.0, np.sin(colat)])
        self._pairs()

    @property
    def num_pol_sky(self) -> int:
        return 1 if self.kind == DISH else 4

    def _positions(self):
        p = self.p
        if self.kind == DISH:
            ew, ns = np.meshgrid(np.arange(p["grid_ew"]) * p["spacing_ew"], np.arange(p["grid_ns"]) * p["spacing_ns"],
                                 indexing="ij")
            pos = np.stack([ew.ravel(), ns.ravel()], axis=-1)
            if p.get("jitter", 0.0) > 0.0:
                rng = np.random.Generator(np.random.SFC64(p.get("jitter_seed", 0)))
                pos = pos + rng.uniform(-p["jitter"], p["jitter"], pos.shape)
            return pos, np.zeros(len(pos), dtype=np.int64)
        cyl, feed = np.meshgrid(np.arange(p["num_cylinders"]), np.arange(p["num_feeds"]), indexing="ij")
        single = np.stack([cyl.ravel() * p["cylinder_spacing"], feed.ravel() * p["feed_spacing"]], axis=-1)
        classes = np.repeat([0, 1], len(single))
        return np.concatenate([single, single]), classes

    def _pairs(self):
        pos, cls = self._positions()
        ii, jj = np.triu_indices(len(pos))
        bl = pos[ii] - pos[jj]
        flip = (bl[:, 0] < -1e-9) | ((np.abs(bl[:, 0]) < 1e-9) & (bl[:, 1] < -1e-9))
        bl = np.where(flip[:, None], -bl, bl)
        ca, cb = np.where(flip, cls[jj], cls[ii]), np.where(flip, cls[ii], cls[jj])
        keep = (ii != jj) | bool(self.p.get("auto_correlations", False))
        bl, ca, cb = bl[keep], ca[keep], cb[keep]
        cols = [ca, cb]
        for x in (bl[:, 0], bl[:, 1]):
            vals, inv = np.unique(x, return_inverse=True)
            cols.append(np.array([round(float(v), 6) + 0.0 for v in vals])[inv.ravel()])
        keys = np.stack(cols, axis=-1)
        _, first = np.unique(keys, axis=0, return_index=True)
        head = np.sort(first)
        self.baselines = bl[head]  # [nbase, 2] (EW, NS) metres
        self.classes = np.stack([ca[head], cb[head]], axis=-1)  # [nbase, 2]

    @property
    def nbase(self) -> int:
        return len(self.baselines)

    def baselines_3d(self) -> np.ndarray:
        return self.baselines[:, :1] * self.east + self.baselines[:, 1:] * self.north

    def beam_products(self, fi: int) -> dict:
        """{(class_a, class_b): [npol, npix] complex beam product} at channel ``fi``."""
        vec = pixel_vectors(self.nside)
        lam = self.wavelengths[fi]
        above = vec @ self.zenith > 0
        if self.kind == DISH:
            fwhm = self.p.get("fwhm_factor", 1.0) * lam / self.p["dish_width"]
            sigma2 = (fwhm / (2 * np.sqrt(2 * np.log(2)))) ** 2
            sep = np.arccos(np.clip(vec @ self.zenith, -1.0, 1.0))
            amp = np.exp(-(sep**2) / (4 * sigma2)) * above
            return {(0, 0): (amp * amp)[None].astype(np.complex128)}
        amp = np.sinc(self.p["cylinder_width"] / lam * (vec @ self.east)) * np.exp(-((vec @ self.north) ** 2) / 0.5)
        amp = amp * above
        th, ph = pixel_basis(self.nside)
        field = {c: (amp * (th @ v), amp * (ph @ v)) for c, v in ((0, self.east), (1, self.north))}
        out = {}
        for a, b in {tuple(int(c) for c in k) for k in self.classes}:
            (ta, pa), (tb, pb) = field[a], field[b]
            tt, pp, tp, pt = ta * tb, pa * pb, ta * pb, pa * tb
            out[(a, b)] = np.stack([0.5 * (tt + pp), 0.5 * (tt - pp), 0.5 * (tp + pt), 0.5j * (tp - pt)])
        return out
