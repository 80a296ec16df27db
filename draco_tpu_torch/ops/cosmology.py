"""Minimal flat-LCDM cosmology + 21cm survey conversions (host numpy).

Copy of ``draco_tpu.ops.cosmology``: the replacement for the slice of ``cora.util.cosmology`` the reference
uses (reference draco/analysis/powerspec.py:10 and the
delays_to_kpara/u_to_kperp converters at reference
draco/analysis/powerspec.py:1372-1460).
"""

from __future__ import annotations

import numpy as np

F21 = 1420.405751768  # MHz
C_KMS = 299792.458


class Cosmology:
    """Flat LCDM background cosmology (Planck-like defaults)."""

    def __init__(self, H0: float = 67.8, omega_m: float = 0.309, omega_l=None):
        self.H0 = H0
        self.omega_m = omega_m
        self.omega_l = 1.0 - omega_m if omega_l is None else omega_l

    def H(self, z):
        """Hubble parameter in km/s/Mpc."""
        z = np.asarray(z, dtype=np.float64)
        return self.H0 * np.sqrt(self.omega_m * (1 + z) ** 3 + self.omega_l)

    def comoving_distance(self, z, nstep: int = 2048):
        """Comoving distance in Mpc (Simpson integration of c/H)."""
        z = np.asarray(z, dtype=np.float64)
        zmax = float(np.max(z)) if np.ndim(z) else float(z)
        zs = np.linspace(0, max(zmax, 1e-8), nstep + 1)
        integrand = C_KMS / self.H(zs)
        cum = np.concatenate(
            [[0.0], np.cumsum((integrand[1:] + integrand[:-1]) / 2 * np.diff(zs))]
        )
        return np.interp(z, zs, cum)

    def comoving_distance_h(self, z):
        """Comoving distance in Mpc/h."""
        return self.comoving_distance(z) * self.H0 / 100.0

    def growth_factor(self, z):
        """Approximate linear growth factor (Carroll et al. 1992)."""
        z = np.asarray(z, dtype=np.float64)
        a = 1.0 / (1 + z)
        om = self.omega_m / (self.omega_m + self.omega_l * a**3)
        ol = 1 - om
        g = 2.5 * om / (om ** (4.0 / 7) - ol + (1 + om / 2) * (1 + ol / 70))
        return g * a


def freq_to_z(freq):
    """Redshift of the 21cm line at observed frequency [MHz]."""
    return F21 / np.asarray(freq, dtype=np.float64) - 1.0


def z_to_freq(z):
    """Observed 21cm frequency [MHz] at redshift z."""
    return F21 / (1.0 + np.asarray(z, dtype=np.float64))


def delays_to_kpara(delay, z, cosmology: Cosmology | None = None):
    """Convert delay [microseconds] to k_parallel [h/Mpc].

    (reference draco/analysis/powerspec.py:1372 semantics)
    """
    if cosmology is None:
        cosmology = Cosmology()
    z = np.asarray(z, dtype=np.float64)
    # d chi / d nu at redshift z
    Ez = cosmology.H(z) / cosmology.H0
    # k_par = 2 pi tau * (F21 * H0 * E(z)) / (c (1+z)^2), tau in s
    tau_s = np.asarray(delay, dtype=np.float64) * 1e-6
    h = cosmology.H0 / 100.0
    kpara = (
        2
        * np.pi
        * tau_s
        * F21
        * 1e6
        * cosmology.H0
        * Ez
        / (C_KMS * (1 + z) ** 2)
    )
    return kpara / h  # in h/Mpc


def kpara_to_delay(kpara, z, cosmology: Cosmology | None = None):
    """Inverse of :func:`delays_to_kpara`."""
    if cosmology is None:
        cosmology = Cosmology()
    one = delays_to_kpara(1.0, z, cosmology)
    return np.asarray(kpara) / one


def u_to_kperp(u, z, cosmology: Cosmology | None = None):
    """Convert uv distance |u| to k_perp [h/Mpc]."""
    if cosmology is None:
        cosmology = Cosmology()
    chi = cosmology.comoving_distance_h(z)  # Mpc/h
    return 2 * np.pi * np.asarray(u, dtype=np.float64) / chi


def kperp_to_u(kperp, z, cosmology: Cosmology | None = None):
    """Inverse of :func:`u_to_kperp`."""
    if cosmology is None:
        cosmology = Cosmology()
    chi = cosmology.comoving_distance_h(z)
    return np.asarray(kperp) * chi / (2 * np.pi)
