"""The Gaussian sky models and ``makesky``: draco_tpu_torch against draco_tpu.

The spectra C_l(nu1, nu2) of every model, and every deterministic part of
a sky (geometry, axes, tags, the seed a task draws on the host), are held
exactly to the JAX package.  The draws come from torch generators, so the
maps themselves are held to their statistics, with each bound derived
where it is stated.  The port runs on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from draco_tpu.core.containers import Map as JMap
from draco_tpu.core.pipeline import main as jmain
from draco_tpu.synthesis import skymodel as jsm
from draco_tpu_torch.core import containers
from draco_tpu_torch.core.task import PipelineStopIteration
from draco_tpu_torch.device import default_device
from draco_tpu_torch.synthesis import skymodel as sm

MODELS = ["synchrotron", "pointsource", "freefree", "galacticfreefree", "foreground", "21cm"]


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


def _jax_polarised_cl(model, lmax, freq):
    """The JAX package's Q/U spectra (computed inside its generate_map)."""
    targets = [model, *getattr(model, "components", [])]
    saved = [(t, t.xi) for t in targets if hasattr(t, "xi")]
    for t, _ in saved:
        t.xi = model.polarisation_xi
    clp = model._cl_table(lmax, freq) * float(model.polarisation_fraction) ** 2
    for t, old in saved:
        t.xi = old
    return clp


@pytest.mark.parametrize("name", MODELS)
def test_angular_powerspectra_match_jax(name):
    freq = np.linspace(400.0, 500.0, 5, endpoint=False)
    model, jmodel = sm._SKY_MODELS[name](), jsm._SKY_MODELS[name]()
    assert np.array_equal(model._cl_table(47, freq), jmodel._cl_table(47, freq))
    assert np.array_equal(model._polarised_cl_table(47, freq), _jax_polarised_cl(jmodel, 47, freq))
    assert model.polarisation_fraction == jmodel.polarisation_fraction


def _power(alm):
    """C_l estimates [nfreq, nfreq, lmax+1] of alm [nfreq, l, m] (m >= 0, real-field)."""
    lmax = alm.shape[1] - 1
    w = np.full(lmax + 1, 2.0)
    w[0] = 1.0  # m = 0 counts once, m > 0 twice (a_{l,-m} = conj a_lm)
    cross = np.einsum("alm,blm,m->abl", alm, alm.conj(), w).real
    return cross / (2 * np.arange(lmax + 1) + 1)


def test_realisation_power_against_cl():
    """One frequency, lmax 191, C_l = l^-1.1: each estimate is C_l
    chi^2_{2l+1} / (2l+1), of variance 2 C_l^2 / (2l+1).  The mean over
    l = 1..191 of Ĉ_l / C_l has standard error sqrt(sum 2/(2l+1)) / 191 =
    0.0126; held to 0.063 (5 sigma)."""
    lmax = 191
    cl = (np.maximum(np.arange(lmax + 1), 1.0) ** -1.1)[:, None, None]
    alm = sm.gaussian_realisation_alm(cl, torch.Generator().manual_seed(1), lblock=64).numpy()
    ratio = _power(alm)[0, 0, 1:] / cl[1:, 0, 0]
    sigma = np.sqrt(np.sum(2.0 / (2 * np.arange(1, lmax + 1) + 1))) / lmax
    assert abs(ratio.mean() - 1.0) <= 5 * sigma
    ls, ms = np.arange(lmax + 1)[:, None], np.arange(lmax + 1)[None, :]
    assert np.abs(alm[:, :, 0].imag).max() == 0.0
    assert np.abs(alm * (ms > ls)).max() == 0.0


def test_realisation_frequency_covariance():
    """Four frequencies, C = 0.5 + 0.5 I at every l <= 47, four draws: the
    m > 0 coefficients give 4 x 1128 complex samples, so each covariance
    entry's estimate has standard error <= 1/sqrt(4512) = 0.015; held to
    0.1 (the JAX package's test bound, ~7 sigma)."""
    lmax, nfreq = 47, 4
    cl = np.ones((lmax + 1, nfreq, nfreq)) * 0.5 + 0.5 * np.eye(nfreq)
    ls, ms = np.arange(lmax + 1)[:, None], np.arange(lmax + 1)[None, :]
    valid = (ms <= ls) & (ms > 0)
    acc = np.zeros((nfreq, nfreq))
    for s in range(4):
        a = sm.gaussian_realisation_alm(cl, torch.Generator().manual_seed(s)).numpy()[:, valid]
        acc += (a @ a.conj().T).real / a.shape[1]
    assert np.abs(acc / 4 - cl[0]).max() <= 0.1


def _expected_variance(model, nside, freq):
    """Pixel variance of a band-limited isotropic field, sum (2l+1) C_l / 4 pi,
    and the standard error of a one-map estimate of it,
    sqrt(2 sum (2l+1) C_l^2) / 4 pi."""
    cl = model._cl_table(3 * nside - 1, freq)[:, 0, 0]
    nl = 2 * np.arange(cl.size) + 1
    return np.sum(nl * cl) / (4 * np.pi), np.sqrt(2 * np.sum(nl * cl**2)) / (4 * np.pi)


@pytest.mark.parametrize("pol", [False, True])
def test_make_sky_matches_jax_geometry_and_power(pol):
    """Axes, shape and tag exactly; each frequency's pixel variance within 5
    standard errors of sum (2l+1) C_l / 4 pi."""
    m = sm.make_sky("pointsource", nside=16, nfreq=2, seed=1, pol=pol, device="cpu")
    jm = jsm.make_sky("pointsource", nside=16, nfreq=2, seed=1, pol=pol)
    assert isinstance(m, containers.Map) and m.map.shape == jm.map.shape and m.map.dtype == torch.float64
    for name in ("freq", "pol", "pixel"):
        assert np.array_equal(m.index_map[name], jm.index_map[name]), name
    assert m.attrs["tag"] == jm.attrs["tag"]
    mp = m.map[:].numpy()
    for fi, f in enumerate(m.freq):
        var, err = _expected_variance(sm.ExtragalacticPointSource(), 16, [f])
        assert abs(mp[fi, 0].var() - var) <= 5 * err
    if pol:
        assert np.all(mp[:, 1:] == 0)  # point sources are unpolarised


def test_make_sky_correlations_and_polarisation():
    """Synchrotron (xi = 4) stays correlated across 400-500 MHz; the 21 cm
    field (0.5 MHz correlation width) decorrelates; synchrotron Q/U carry
    about the polarisation fraction 0.3 and V is zero (the JAX package's
    own test bounds)."""
    syn = sm.make_sky("synchrotron", nside=16, nfreq=4, seed=1, device="cpu").map[:].numpy()
    assert np.corrcoef(syn[:, 0])[0, -1] > 0.99
    h21 = sm.make_sky("21cm", nside=16, nfreq=4, seed=1, device="cpu").map[:].numpy()
    assert abs(np.corrcoef(h21[:, 0])[0, -1]) < 0.3
    pol = sm.make_sky("synchrotron", nside=16, nfreq=2, seed=2, pol=True, device="cpu").map[:].numpy()
    assert 0.1 < pol[:, 1].std() / pol[:, 0].std() < 0.6 and np.all(pol[:, 3] == 0)
    again = sm.make_sky("synchrotron", nside=16, nfreq=2, seed=2, pol=True, device="cpu").map[:].numpy()
    assert np.array_equal(pol, again)


def test_generate_gaussian_sky_draws_the_jax_seed(monkeypatch):
    """The task draws each map's seed from its host rng exactly as the JAX
    package's does, tags the maps alike and stops after num_realisations."""
    seeds = {"jax": [], "torch": []}
    for key, mod in (("jax", jsm), ("torch", sm)):
        real = mod.make_sky

        def record(*args, _real=real, _key=key, **kw):
            seeds[_key].append(kw["seed"])
            return _real(*args, **kw)

        monkeypatch.setattr(mod, "make_sky", record)
        task = mod.GenerateGaussianSky()
        task.read_config({"model": "21cm", "nside": 8, "nfreq": 2, "num_realisations": 2, "seed": 7})
        task.setup()
        maps = [task.process(), task.process()]
        assert [m.attrs["tag"] for m in maps] == ["21cm_0", "21cm_1"]
        with pytest.raises(Exception) as err:
            task.process()
        assert type(err.value).__name__ == "PipelineStopIteration"
    assert isinstance(err.value, PipelineStopIteration)
    assert seeds["jax"] == seeds["torch"] and len(seeds["torch"]) == 2


def test_makesky_cli_matches_jax(tmp_path):
    """``python -m draco_tpu_torch --platform cpu makesky`` (in a subprocess)
    writes a map file of the JAX package's geometry, exactly, whose power
    is that of the model (5 standard errors, as above)."""
    args = ["makesky", "pointsource", "--nside", "16", "--nfreq", "2", "--seed", "3"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "draco_tpu_torch", "--platform", "cpu", *args[:2], str(tmp_path / "t.h5"), *args[2:]],
        cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "pointsource map written to" in out.stdout
    assert jmain([*args[:2], str(tmp_path / "j.h5"), *args[2:]]) == 0
    m = containers.ContainerBase.from_file(str(tmp_path / "t.h5"), device="cpu")
    jm = JMap.from_file(str(tmp_path / "j.h5"))
    assert type(m).__name__ == "Map" and m.map.shape == jm.map.shape
    for name in ("freq", "pol", "pixel"):
        assert np.array_equal(m.index_map[name], jm.index_map[name]), name
    assert m.attrs["tag"] == jm.attrs["tag"]
    mp = m.map[:].numpy()
    for fi, f in enumerate(m.freq):
        var, err = _expected_variance(sm.ExtragalacticPointSource(), 16, [f])
        assert abs(mp[fi, 0].var() - var) <= 5 * err
