"""Gaussian sky models: the native ``cora-makesky`` equivalent.

Port of ``draco_tpu.synthesis.skymodel``.  The reference stack obtains its
input sky maps from the external *cora* package (``cora-makesky
21cm/synchrotron/...``, reference doc/tutorial.rst:78-119), which draco
then consumes through ``LoadMaps``.  This module draws frequency-correlated
Gaussian realisations of foreground and 21 cm angular power spectra on the
device: each l-block of C_l(nu, nu') is factorised with one batched
``torch.linalg.eigh``, the alm draw is one batched product, and the maps
come from :func:`draco_tpu_torch.ops.sht.sphtrans_inv_sky`.

Foreground spectra follow the Santos, Cooray & Knox (2005;
astro-ph/0408515, Table 1) parametrisation also used by cora::

    C_l(nu1, nu2) = A (l_ref/l)^alpha (nu_ref^2 / (nu1 nu2))^beta
                    exp(-log^2(nu1/nu2) / (2 xi^2))

with ``l_ref = 1000`` and ``nu_ref = 130 MHz``.  The 21 cm signal is a
phenomenological Gaussian field with a power-law angular spectrum and a
finite frequency correlation length.

The draws come from ``torch.Generator``s seeded from ``seed``: a seed gives
the same maps on a device every time, but not the JAX package's maps.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers
from ..core.task import ContainerTask, PipelineStopIteration, RandomTask
from ..device import resolve
from ..ops import sht as sht_ops

__all__ = [
    "FrequencyCorrelatedSky",
    "Synchrotron",
    "ExtragalacticPointSource",
    "ExtragalacticFreeFree",
    "GalacticFreeFree",
    "CombinedForeground",
    "Corr21cm",
    "gaussian_realisation_alm",
    "make_sky",
    "GenerateGaussianSky",
]


def _realisation_block(cl_blk: torch.Tensor, lmax: int, generator) -> torch.Tensor:
    """One l-block of frequency-correlated alm [nfreq, nl, lmax+1]."""
    # factor each C_l via eigh: robust to the rank-deficient, fully
    # frequency-correlated limit where a Cholesky fails
    evals, evecs = torch.linalg.eigh(cl_blk)
    fac = evecs * evals.clamp(min=0.0).sqrt()[..., None, :]

    nl, nfreq = cl_blk.shape[0], cl_blk.shape[1]
    rdt = cl_blk.dtype
    zr = torch.randn(nl, lmax + 1, nfreq, dtype=rdt, generator=generator, device=cl_blk.device)
    zi = torch.randn(nl, lmax + 1, nfreq, dtype=rdt, generator=generator, device=cl_blk.device)
    # m > 0: complex unit variance; m = 0: real unit variance
    z = torch.complex(zr, zi) * np.sqrt(0.5)
    z[:, 0, :] = zr[:, 0, :].to(z.dtype)
    # alm[f, l, m] = sum_g fac[l, f, g] z[l, m, g]
    return torch.einsum("lfg,lmg->flm", fac.to(z.dtype), z)


def gaussian_realisation_alm(cl, generator=None, lblock: int = 256, dtype=torch.float64, device=None):
    """Draw alm of a frequency-correlated Gaussian random field.

    Parameters
    ----------
    cl : array [lmax+1, nfreq, nfreq]
        Angular cross-power spectra between frequencies.
    generator : torch.Generator
        Source of the draws; they run on its device (or ``device``).
    lblock : int
        l-block size bounding the memory of the batched eigh.
    dtype : real dtype of the factorisation and the draws.

    Returns
    -------
    alm : complex tensor [nfreq, lmax+1, lmax+1]
        Dense (l, m) coefficients, m >= 0 (the real-field convention of
        :mod:`draco_tpu_torch.ops.sht`), with E[a_lm(nu1) a_lm(nu2)*] =
        C_l(nu1, nu2); zero for m > l.
    """
    dev = generator.device if generator is not None and device is None else resolve(device)
    cl = torch.as_tensor(np.asarray(cl), dtype=dtype, device=dev)
    lmax = cl.shape[0] - 1
    alm = torch.cat(
        [_realisation_block(cl[l0 : l0 + lblock], lmax, generator) for l0 in range(0, lmax + 1, lblock)], dim=1
    )
    ls = torch.arange(lmax + 1, device=dev)
    return alm * (ls[None, :] <= ls[:, None])


def _synthesis(alm: torch.Tensor, nside: int) -> torch.Tensor:
    """Maps of float64 draws, synthesised in float32: the two-float tables
    that the simulation's own transforms use (float64 tables at nside 256
    would hold another 4.8 GB on the device)."""
    return sht_ops.sphtrans_inv_sky(alm.to(torch.complex64), nside)


def _generators(seed: int, n: int, device) -> list[torch.Generator]:
    """``n`` generators on ``device`` seeded from ``seed`` and their position."""
    states = np.random.SeedSequence(int(seed)).spawn(n)
    return [
        torch.Generator(device=device).manual_seed(int(s.generate_state(1, np.uint64)[0])) for s in states
    ]


class FrequencyCorrelatedSky:
    """Base class: a Gaussian sky defined by C_l(nu1, nu2).

    Subclasses implement :meth:`angular_powerspectrum`.  The equivalent
    role in the reference stack is cora's ``Map3d``/foreground model
    classes behind ``cora-makesky``.
    """

    #: polarisation fraction for Q/U realisations (0 = unpolarised model)
    polarisation_fraction = 0.0
    #: frequency decorrelation (xi) used for the polarised component
    polarisation_xi = 0.5

    def angular_powerspectrum(self, l, nu1, nu2):
        """C_l(nu1, nu2) for broadcastable (l, nu1, nu2) in (MHz, K^2)."""
        raise NotImplementedError

    def _cl_table(self, lmax, freq):
        l = np.arange(lmax + 1)[:, None, None]
        nu1 = np.asarray(freq)[None, :, None]
        nu2 = np.asarray(freq)[None, None, :]
        return np.asarray(self.angular_powerspectrum(l, nu1, nu2))

    def generate_alm(self, lmax, freq, generator, lblock: int = 256):
        """Draw Stokes-I alm [nfreq, lmax+1, lmax+1] at the given frequencies."""
        return gaussian_realisation_alm(self._cl_table(lmax, freq), generator, lblock=lblock)

    def _polarised_cl_table(self, lmax, freq):
        """Q/U spectra: the spatial spectrum scaled by fpol^2, with a shorter
        frequency coherence (Faraday decorrelation).  Composite models hold
        xi on their components, so the swap reaches every object with one."""
        targets = [self, *getattr(self, "components", [])]
        saved = [(t, t.xi) for t in targets if hasattr(t, "xi")]
        try:
            for t, _ in saved:
                t.xi = self.polarisation_xi
            return self._cl_table(lmax, freq) * float(self.polarisation_fraction) ** 2
        finally:
            for t, old in saved:
                t.xi = old

    def generate_map(self, nside, freq, seed=0, pol: bool = False, lmax=None, device=None):
        """Synthesise maps [nfreq, npol, npix] (Stokes I, or IQUV) on ``device``."""
        dev = resolve(device)
        if lmax is None:
            lmax = 3 * nside - 1
        gi, gq, gu = _generators(seed, 3, dev)

        alm = self.generate_alm(lmax, freq, gi)[:, None]  # [f, 1, l, m]
        maps = _synthesis(alm, nside)  # [f, 1, npix]
        if not pol:
            return maps

        out = torch.zeros(len(freq), 4, maps.shape[-1], dtype=maps.dtype, device=dev)
        out[:, 0] = maps[:, 0]
        if float(self.polarisation_fraction) > 0.0:
            clp = self._polarised_cl_table(lmax, freq)
            for pi, gp in ((1, gq), (2, gu)):
                out[:, pi] = _synthesis(gaussian_realisation_alm(clp, gp)[:, None], nside)[:, 0]
        return out


class _SCKForeground(FrequencyCorrelatedSky):
    """Santos-Cooray-Knox (2005) power-law foreground component."""

    #: amplitude at (l_ref, nu_ref) in K^2
    A = 0.0
    alpha = 1.0
    beta = 2.0
    xi = 1.0
    l_ref = 1000.0
    nu_ref = 130.0  # MHz

    def angular_powerspectrum(self, l, nu1, nu2):
        l = np.maximum(np.asarray(l, dtype=np.float64), 1.0)
        nu1 = np.asarray(nu1, dtype=np.float64)
        nu2 = np.asarray(nu2, dtype=np.float64)
        return (
            self.A
            * (self.l_ref / l) ** self.alpha
            * (self.nu_ref**2 / (nu1 * nu2)) ** self.beta
            * np.exp(-np.log(nu1 / nu2) ** 2 / (2 * self.xi**2))
        )


class Synchrotron(_SCKForeground):
    """Galactic synchrotron (SCK Table 1): the dominant foreground."""

    A = 700e-6  # 700 mK^2 -> K^2
    alpha = 2.4
    beta = 2.80
    xi = 4.0
    polarisation_fraction = 0.3
    polarisation_xi = 0.5


class ExtragalacticPointSource(_SCKForeground):
    """Unresolved extragalactic point-source background (SCK Table 1)."""

    A = 57e-6
    alpha = 1.1
    beta = 2.07
    xi = 1.0


class ExtragalacticFreeFree(_SCKForeground):
    """Extragalactic free-free emission (SCK Table 1)."""

    A = 0.014e-6
    alpha = 1.0
    beta = 2.10
    xi = 35.0


class GalacticFreeFree(_SCKForeground):
    """Galactic free-free emission (SCK Table 1)."""

    A = 0.088e-6
    alpha = 3.0
    beta = 2.15
    xi = 35.0


class CombinedForeground(FrequencyCorrelatedSky):
    """Sum of the four SCK components (the ``cora-makesky foreground`` sky)."""

    polarisation_fraction = 0.3
    polarisation_xi = 0.5

    def __init__(self):
        self.components = [Synchrotron(), ExtragalacticPointSource(), ExtragalacticFreeFree(), GalacticFreeFree()]

    def angular_powerspectrum(self, l, nu1, nu2):
        return sum(c.angular_powerspectrum(l, nu1, nu2) for c in self.components)


class Corr21cm(FrequencyCorrelatedSky):
    """Phenomenological Gaussian 21 cm signal.

    Mean brightness temperature T_b(z) = T21 * sqrt((1+z)/2.5) (the
    standard low-z scaling), a power-law angular spectrum, and a Gaussian
    frequency decorrelation of width ``corr_width`` MHz::

        C_l(nu1,nu2) = T_b(nu1) T_b(nu2) (l_ref/(l+1))^alpha
                       exp(-(nu1-nu2)^2 / (2 corr_width^2))
    """

    T21 = 0.3e-3  # K
    alpha = 1.0
    l_ref = 100.0
    corr_width = 0.5  # MHz
    NU21 = 1420.405751  # MHz

    def T_b(self, nu):
        z = self.NU21 / np.asarray(nu, dtype=np.float64) - 1.0
        return self.T21 * np.sqrt(np.maximum(1.0 + z, 0.0) / 2.5)

    def angular_powerspectrum(self, l, nu1, nu2):
        l = np.asarray(l, dtype=np.float64)
        return (
            self.T_b(nu1)
            * self.T_b(nu2)
            * (self.l_ref / (l + 1.0)) ** self.alpha
            * np.exp(-((nu1 - nu2) ** 2) / (2 * self.corr_width**2))
        )


_SKY_MODELS = {
    "synchrotron": Synchrotron,
    "pointsource": ExtragalacticPointSource,
    "freefree": ExtragalacticFreeFree,
    "galacticfreefree": GalacticFreeFree,
    "foreground": CombinedForeground,
    "21cm": Corr21cm,
}


def make_sky(
    model="foreground",
    nside: int = 64,
    freq=None,
    nfreq: int = 32,
    freq_start: float = 400.0,
    freq_end: float = 500.0,
    seed: int = 0,
    pol: bool = False,
    lmax=None,
    device=None,
):
    """Generate a sky :class:`~draco_tpu_torch.core.containers.Map` on ``device``.

    The native equivalent of the ``cora-makesky`` CLI the reference
    tutorial drives (reference doc/tutorial.rst:78-119).  ``model`` is a
    name from {synchrotron, pointsource, freefree, galacticfreefree,
    foreground, 21cm} or a :class:`FrequencyCorrelatedSky` instance.
    """
    if isinstance(model, str):
        try:
            model = _SKY_MODELS[model.lower()]()
        except KeyError:
            raise ValueError(f"Unknown sky model {model!r}; pick from {sorted(_SKY_MODELS)}") from None

    if freq is None:
        freq = np.linspace(freq_start, freq_end, nfreq, endpoint=False)
    freq = np.asarray(freq, dtype=np.float64)

    dev = resolve(device)
    maps = model.generate_map(nside, freq, seed=seed, pol=pol, lmax=lmax, device=dev)
    m = containers.Map(nside=nside, polarisation=bool(pol), freq=freq, device=dev)
    m.map[:] = maps
    m.attrs["tag"] = getattr(model, "tag", type(model).__name__.lower())
    return m


class GenerateGaussianSky(ContainerTask, RandomTask):
    """Pipeline task producing Gaussian sky maps (cora-makesky as a task).

    The map's seed is drawn from the task's host ``rng``, as in the JAX
    package.

    Attributes
    ----------
    model : str
        One of {synchrotron, pointsource, freefree, galacticfreefree,
        foreground, 21cm}.
    nside, freq_start, freq_end, nfreq, polarisation, lmax
        Map geometry and frequency sampling.
    num_realisations : int
        Number of maps to generate before stopping.
    """

    model = config.enum(sorted(_SKY_MODELS), default="foreground")
    nside = config.int_prop(64)
    freq_start = config.float_prop(400.0)
    freq_end = config.float_prop(500.0)
    nfreq = config.int_prop(32)
    polarisation = config.bool_prop(False)
    lmax = config.int_prop(None)
    num_realisations = config.int_prop(1)

    def setup(self):
        # a dedicated counter: ContainerTask.next() also advances
        # self._count per output
        self._nreal_done = 0

    def process(self):
        if self._nreal_done >= self.num_realisations:
            raise PipelineStopIteration
        self._nreal_done += 1
        seed = int(self.rng.integers(0, 2**31 - 1))
        m = make_sky(
            model=self.model,
            nside=self.nside,
            nfreq=self.nfreq,
            freq_start=self.freq_start,
            freq_end=self.freq_end,
            seed=seed,
            pol=self.polarisation,
            lmax=self.lmax,
        )
        m.attrs["tag"] = f"{self.model}_{self._nreal_done - 1}"
        return m
