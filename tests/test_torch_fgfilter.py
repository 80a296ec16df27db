"""The foreground-filter path: draco_tpu_torch against draco_tpu on the same inputs.

One module-scoped fixture at the size of ``tests/test_fgfilter.py`` (2 x 2
dishes, 4 frequencies, lmax 15) serves both packages: the same telescope
configuration, the same numpy m-modes (simulated by the JAX package), the
port on the CPU.  Eigenvectors and singular vectors carry an arbitrary
gauge, so the tests compare invariants: eigenvalues, mode counts, the
projector ``bwd @ fwd``, filtered data, band powers.

The KL parity tests hand BOTH packages the JAX package's beam SVD as
arrays (the port's own SVD is held to JAX's in
``test_torch_beamtransfer.py``), so that the packed SVD basis is one and
the ported modules alone are compared; the JAX side gets them as
complex128, so that with 64-bit types on it solves the pencil in
complex128, as the port does (handed its own complex64 SVD it solves in
complex64).

Tolerances, max|diff| / max|ref| unless stated:

- ``_whitened_eigh``: eigenvalues within 1e-8 of the largest against the
  JAX function and against ``scipy.linalg.eigh(S, N)``; ``V^H N V = I``
  within 1e-8; ``einv @ evecs = I`` within 1e-10;
- KL and DoubleKL eigenvalues within 1e-8 of the largest, kept-mode counts
  equal, the projector on the kept modes and the filtered data within 1e-6;
- ``SVDModeProject`` forward, backward and filter within 2e-5 (complex64
  beam SVD); with the port's own SVD the filter within 1e-4;
- ``q``, Fisher matrix, bias and band powers within 1e-8;
- ``svd_em`` singular values and rank-5 part within 1e-10 (complex128
  input); ``SVDFilter`` and ``SVDSpectrumEstimator`` (complex64 matrices)
  within 2e-5;
- m-chunk invariance: KL eigenvalues and kept modes, ``q``, Fisher matrix
  and bias within 1e-10 (each m is solved on its own; the batched BLAS
  calls block differently with the batch size).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from draco_tpu.analysis import fgfilter as jfgfilter
from draco_tpu.analysis import powerspectrum as jpowerspectrum
from draco_tpu.analysis import svdfilter as jsvdfilter
from draco_tpu.analysis.transform import MModeTransform as JMModeTransform
from draco_tpu.core import containers as jcontainers
from draco_tpu.synthesis.stream import SimulateSidereal as JSimulateSidereal
from draco_tpu.telescope import BeamTransfer as JBeamTransfer
from draco_tpu.telescope import ProductManager as JProductManager
from draco_tpu.telescope import UnpolarisedDishArray as JDishArray
from draco_tpu.telescope import kltransform as jkl
from draco_tpu.telescope.psestimation import PSEstimation as JPSEstimation
from draco_tpu_torch.analysis import fgfilter, powerspectrum, svdfilter
from draco_tpu_torch.core import containers
from draco_tpu_torch.device import default_device
from draco_tpu_torch.telescope import BeamTransfer, UnpolarisedDishArray, kltransform
from draco_tpu_torch.telescope.manager import ProductManager
from draco_tpu_torch.telescope.psestimation import PSEstimation

CONFIG = dict(
    grid_ew=2, grid_ns=2, spacing_ew=6.0, spacing_ns=6.0, latitude=45.0, freq_lower=400.0, freq_upper=440.0,
    num_freq=4, dish_width=6.0, auto_correlations=True, force_lmax=15, force_mmax=15,
)
BANDS = {"bands_kpar": [0.0, 0.5, 1.0], "bands_kperp": [0.0, 0.5]}
# at the default foreground_amp = 100 / noise_amp = 1e-2 the pencil's
# condition number eats eight digits; the JAX package's own tests use this
# milder one where they compare eigen-decompositions
MILD = {"foreground_amp": 2.0, "noise_amp": 0.5}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _run(task_obj, params, setup, *inputs):
    task_obj.read_config(params)
    task_obj.setup(*setup)
    return task_obj.process(*inputs)


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def setup(on_cpu):
    jtel = JDishArray(**CONFIG)
    jbt = JBeamTransfer(telescope=jtel).generate()
    rng = np.random.Generator(np.random.SFC64(3))
    sky = rng.standard_normal((jtel.nfreq, 1, 12 * jbt.beam_nside**2))
    jmap = jcontainers.Map(nside=jbt.beam_nside, polarisation=False, freq=jtel.frequencies)
    jmap.map[:] = sky
    jmm = _run(JMModeTransform(), {}, (), _run(JSimulateSidereal(), {}, (jbt,), jmap))

    tel = UnpolarisedDishArray(**CONFIG)
    bt = BeamTransfer(tel).generate(device="cpu")
    mm = containers.MModes(mmax=jmm.mmax, freq=tel.frequencies, prod=tel.uniquepairs, input=tel.input_index)
    mm.vis[:] = np.asarray(jmm.vis[:])
    mm.weight[:] = np.asarray(jmm.weight[:])

    # one packed SVD basis for both packages: the JAX package's arrays, its
    # own copy as complex128 (so that it solves in complex128 too)
    jbt._ensure_svd()
    svd = {k: np.asarray(v) for k, v in jbt._svd.items()}
    bt_shared = copy.copy(bt)
    bt_shared._svd = {k: torch.from_numpy(v.copy()) for k, v in svd.items()}
    jbt64 = copy.copy(jbt)
    jbt64._svd = {
        k: jnp.asarray(v.astype(np.complex128 if np.iscomplexobj(v) else v.dtype)) if k in ("U", "Vh")
        else jnp.asarray(v.astype(np.float64)) if k == "s" else jnp.asarray(v)
        for k, v in svd.items()
    }
    return dict(jtel=jtel, jbt=jbt, jbt64=jbt64, jmm=jmm, tel=tel, bt=bt, bt_shared=bt_shared, mm=mm)


def _kl_pair(s, cls_name, params):
    jk = getattr(jkl, cls_name).from_config(params, s["jbt64"])
    tk = getattr(kltransform, cls_name).from_config(params, s["bt_shared"])
    return jk, tk


def _jax_modes(jk, threshold=None):
    return tuple(np.asarray(x) for x in jk.modes_all(threshold))


# -- the generalised eigenproblem ------------------------------------------------


def _pencil(rng, B=3, n=12):
    A = rng.standard_normal((B, n, n)) + 1j * rng.standard_normal((B, n, n))
    C = rng.standard_normal((B, n, n)) + 1j * rng.standard_normal((B, n, n))
    return A @ A.conj().swapaxes(-1, -2), C @ C.conj().swapaxes(-1, -2) + 0.1 * np.eye(n)


def test_whitened_eigh_matches_jax_and_scipy():
    S, N = _pencil(np.random.Generator(np.random.SFC64(5)))
    evals, evecs, einv = (_np(x) for x in kltransform._whitened_eigh(torch.from_numpy(S), torch.from_numpy(N)))
    jevals = np.asarray(jkl._whitened_eigh(jnp.asarray(S), jnp.asarray(N))[0])
    n = S.shape[-1]
    for b in range(S.shape[0]):
        ref = np.sort(sla.eigh(S[b], N[b], eigvals_only=True))[::-1]
        assert np.abs(evals[b] - ref).max() <= 1e-8 * ref.max()
        assert np.abs(evals[b] - jevals[b]).max() <= 1e-8 * ref.max()
        assert np.abs(evecs[b].conj().T @ N[b] @ evecs[b] - np.eye(n)).max() <= 1e-8
        assert np.abs(einv[b] @ evecs[b] - np.eye(n)).max() <= 1e-10
    assert (np.diff(evals, axis=-1) <= 0).all()  # descending


def test_whitened_eigh_raises_when_a_factorisation_fails():
    S, N = _pencil(np.random.Generator(np.random.SFC64(6)))
    N[1] -= 5.0 * np.eye(N.shape[-1])  # one of the batch is not positive definite
    with pytest.raises(torch.linalg.LinAlgError, match=r"Cholesky factorisation of N failed for batch entries \[1\]"):
        kltransform._whitened_eigh(torch.from_numpy(S), torch.from_numpy(N))


def test_regularise_matches_jax():
    S, _ = _pencil(np.random.Generator(np.random.SFC64(7)))
    assert _rel(kltransform._regularise(torch.from_numpy(S), 1e-3), np.asarray(jkl._regularise(jnp.asarray(S), 1e-3))) <= 1e-14


# -- KL transforms ---------------------------------------------------------------


def test_svd_covariances_match_jax(setup):
    jk, tk = _kl_pair(setup, "KLTransform", {})
    C = tk._sky_covariances()
    assert _rel(tk._svd_cov_all(C), jk._svd_cov_all(C)) <= 1e-12
    assert _rel(tk._noise_svd_all(), jk._noise_svd_all()) <= 1e-12
    # the per-m forms and a range of m are cuts of the same thing
    assert _rel(tk._svd_cov(3, C[1]), tk._svd_cov_all(C, 3, 4)[0, 1]) == 0.0
    assert _rel(tk._noise_svd(5), tk._noise_svd_all(2, 9)[3]) == 0.0


@pytest.mark.parametrize(
    "cls_name,params",
    [
        ("KLTransform", {"threshold": 1e-4}),
        ("KLTransform", {"threshold": 0.0, "subset": False}),
        ("KLTransform", {"threshold": 1e-3, **MILD}),
        ("DoubleKL", {"threshold": 0.0, "subset": True, "foreground_threshold": 1e-3, **MILD}),
        ("DoubleKL", {"threshold": 0.03, "foreground_threshold": 1e-4, **MILD}),
    ],
    ids=["kl-default", "kl-all-modes", "kl-mild", "doublekl-jax-test", "doublekl-cut"],
)
def test_kl_modes_match_jax(setup, cls_name, params):
    """Eigenvalues, kept-mode counts, and the projector bwd @ fwd on the kept modes."""
    jk, tk = _kl_pair(setup, cls_name, params)
    jevals, jbwd, jfwd, jnmode = _jax_modes(jk)
    evals, bwd, fwd, nmode = (_np(x) for x in tk.modes_all())
    assert evals.dtype == np.float64 and fwd.dtype == np.complex128
    assert np.abs(evals - jevals).max() <= 1e-8 * np.abs(jevals).max()
    assert np.array_equal(nmode, jnmode)
    assert nmode.max() > 0
    for m in np.flatnonzero(nmode):
        k = nmode[m]
        proj = bwd[m][:, :k] @ fwd[m][:k]
        jproj = jbwd[m][:, :k] @ jfwd[m][:k]
        assert np.abs(proj - jproj).max() <= 1e-6 * max(np.abs(jproj).max(), 1.0), m
        assert np.abs(fwd[m][:k] @ bwd[m][:, :k] - np.eye(k)).max() <= 1e-8, m


def test_kl_projection_diagonalises_covariance(setup):
    """cov(fwd x) = diag(evals + 1), the quadratic estimator's premise, and
    the eigenvalues against scipy's generalised solver in float64, at the
    default (ill-conditioned) pencil; N is the regularised one that is solved."""
    _, tk = _kl_pair(setup, "KLTransform", {"threshold": 0.0, "subset": False})
    M = setup["tel"].mmax + 1
    S, F, Nt = tk._pencil(0, M)
    S, N = _np(S), _np(kltransform._regularise(F + Nt))
    for m in (0, 1, 3, M - 1):
        evals, bwd, fwd = (_np(x) for x in tk.modes_m(m))
        cov = fwd @ (S[m] + N[m]) @ fwd.conj().T
        want = np.diag(evals + 1.0)
        assert np.abs(cov - want).max() <= 1e-8 * np.abs(want).max()
        assert np.abs(fwd @ bwd - np.eye(len(evals))).max() <= 1e-8
        ref = np.sort(sla.eigh(S[m], N[m], eigvals_only=True))[::-1]
        assert np.abs(evals - ref).max() <= 1e-8 * ref.max()


@pytest.mark.parametrize("cls_name", ["KLTransform", "DoubleKL"])
def test_kl_modes_do_not_depend_on_the_m_chunk(setup, cls_name):
    params = {"threshold": 0.03, "foreground_threshold": 1e-4, **MILD}
    if cls_name == "KLTransform":
        del params["foreground_threshold"]
    ref = None
    for m_chunk in (None, 1, 5):
        _, tk = _kl_pair(setup, cls_name, {**params, "m_chunk": m_chunk})
        evals, nmode = _np(tk.evals_all()), _np(tk._ensure_modes()[1])
        # what is stored past a chunk's largest count depends on the chunking: compare the kept modes
        got = [evals, nmode] + [_np(x) for m in np.flatnonzero(nmode) for x in tk.modes_m(m)[1:]]
        assert len(tk._modes["chunks"]) == {None: 1, 1: 16, 5: 4}[m_chunk] and nmode.max() > 0
        if ref is None:
            ref = got
            continue
        for a, b in zip(got, ref):
            assert a.shape == b.shape and np.abs(a - b).max() <= 1e-10 * np.abs(b).max()


def test_stored_modes_grow_when_a_lower_threshold_is_asked_for(setup):
    """With ``subset`` the modes are stored up to the configured threshold;
    asking for a lower one solves again and gives what an untruncated
    transform gives."""
    _, tk = _kl_pair(setup, "KLTransform", {"threshold": 1e-3, **MILD})
    _, full = _kl_pair(setup, "KLTransform", {"threshold": 1e-3, "subset": False, **MILD})
    m = 2
    evals, bwd, fwd = tk.modes_m(m)
    stored = tk._modes["chunks"][0][3].shape[1]
    assert 0 < stored < tk._size[1] and len(evals) <= stored
    lo_evals, lo_bwd, lo_fwd = tk.modes_m(m, threshold=1e-5)
    assert len(lo_evals) > stored and tk._modes["threshold"] == 1e-5
    k = len(lo_evals)
    fevals, fbwd, ffwd = full.modes_m(m)
    assert _rel(lo_evals, fevals[:k]) <= 1e-12
    assert _rel(lo_bwd @ lo_fwd, fbwd[:, :k] @ ffwd[:k]) <= 1e-10
    # and the configured threshold still cuts where it did
    assert len(tk.modes_m(m)[0]) == len(evals)


def test_batched_kl_projections_match_per_m_and_jax(setup):
    jk, tk = _kl_pair(setup, "KLTransform", {"threshold": 1e-4})
    rng = np.random.Generator(np.random.SFC64(11))
    M, n = tk._size
    vecs = rng.standard_normal((M, n)) + 1j * rng.standard_normal((M, n))
    out, cnt = tk.project_svd_to_kl(vecs)
    jout, jcnt = jk.project_svd_to_kl(vecs)
    assert np.array_equal(_np(cnt), jcnt)
    back = tk.project_kl_to_svd(out)
    # the KL coefficients carry the eigenvectors' gauge; the round trip does not
    assert _rel(back, jk.project_kl_to_svd(jout)) <= 1e-6
    assert int(cnt[0]) > 0 and int(cnt[M - 1]) == 0
    for mi in (0, M // 4, M - 1):
        ref = tk.project_vector_svd_to_kl(mi, vecs[mi])
        assert len(ref) == int(cnt[mi])
        if len(ref):
            assert _rel(out[mi, : len(ref)], ref) <= 1e-12
        assert (out[mi, len(ref) :] == 0).all()
        per_m = tk.project_vector_kl_to_svd(mi, out[mi, : int(cnt[mi])])
        assert _rel(back[mi], per_m) <= 1e-12 if len(ref) else not back[mi].any() and not per_m.any()


# -- the projection tasks ----------------------------------------------------------


@pytest.mark.parametrize("shared", [True, False], ids=["jax-svd", "own-svd"])
def test_svd_mode_project_matches_jax(setup, shared):
    s = setup
    bt = s["bt_shared"] if shared else s["bt"]
    jfilt = _run(jfgfilter.SVDModeProject(), {"mode": "filter"}, (s["jbt"],), s["jmm"].copy())
    tfilt = _run(fgfilter.SVDModeProject(), {"mode": "filter"}, (bt,), s["mm"].copy())
    assert isinstance(tfilt, containers.MModes)
    assert _rel(tfilt.vis[:], jfilt.vis[:]) <= (2e-5 if shared else 1e-4)
    assert _rel(tfilt.weight[:], jfilt.weight[:]) <= 1e-12
    if not shared:
        return
    jsvd = _run(jfgfilter.SVDModeProject(), {"mode": "forward"}, (s["jbt"],), s["jmm"])
    tsvd = _run(fgfilter.SVDModeProject(), {"mode": "forward"}, (bt,), s["mm"])
    assert isinstance(tsvd, containers.SVDModes) and tsvd.vis.dtype == torch.complex128
    assert _rel(tsvd.vis[:], jsvd.vis[:]) <= 2e-5
    assert np.array_equal(_np(tsvd.nmode[:]), np.asarray(jsvd.nmode[:]))
    assert _rel(tsvd.weight[:], jsvd.weight[:]) <= 1e-12
    jback = _run(jfgfilter.SVDModeProject(), {"mode": "backward"}, (s["jbt"],), jsvd)
    tback = _run(fgfilter.SVDModeProject(), {"mode": "backward"}, (bt,), tsvd)
    assert _rel(tback.vis[:], jback.vis[:]) <= 2e-5
    for name in ("freq", "prod", "stack", "input", "m"):
        assert np.array_equal(tback.index_map[name], jback.index_map[name]), name


@pytest.fixture(scope="module")
def svdmodes(setup):
    s = setup
    jsvd = _run(jfgfilter.SVDModeProject(), {"mode": "forward"}, (s["jbt"],), s["jmm"])
    tsvd = containers.SVDModes(mode=len(jsvd.index_map["mode"]), axes_from=s["mm"], attrs_from=s["mm"])
    for name in ("vis", "vis_weight", "nmode"):
        tsvd[name][:] = np.asarray(jsvd[name][:])
    return jsvd, tsvd


@pytest.mark.parametrize(
    "cls_name,params",
    [
        ("KLTransform", {"threshold": 0.0, "subset": False}),
        ("KLTransform", {"threshold": 1e-3, **MILD}),
        ("DoubleKL", {"threshold": 0.03, "foreground_threshold": 1e-4, **MILD}),
    ],
    ids=["kl-all-modes", "kl-mild-cut", "doublekl-cut"],
)
def test_kl_mode_project_filter_matches_jax(setup, svdmodes, cls_name, params):
    s = setup
    jsvd, tsvd = svdmodes
    jk, tk = _kl_pair(s, cls_name, params)
    jman, man = JProductManager(s["jtel"], s["jbt64"]), ProductManager(s["tel"], s["bt_shared"])
    jman.kltransforms["dk"], man.kltransforms["dk"] = jk, tk
    jfilt = _run(jfgfilter.KLModeProject(), {"mode": "filter", "klname": "dk"}, (jman,), jsvd)
    tfilt = _run(fgfilter.KLModeProject(), {"mode": "filter", "klname": "dk"}, (man,), tsvd)
    assert isinstance(tfilt, containers.SVDModes) and not isinstance(tfilt, containers.KLModes)
    assert _rel(tfilt.vis[:], jfilt.vis[:]) <= 1e-6
    assert np.array_equal(_np(tfilt.nmode[:]), np.asarray(jfilt.nmode[:]))
    assert _rel(tfilt.weight[:], jfilt.weight[:]) <= 1e-12
    tfwd = _run(fgfilter.KLModeProject(), {"mode": "forward", "klname": "dk"}, (man,), tsvd)
    jfwd = _run(jfgfilter.KLModeProject(), {"mode": "forward", "klname": "dk"}, (jman,), jsvd)
    assert isinstance(tfwd, containers.KLModes)
    assert np.array_equal(_np(tfwd.nmode[:]), np.asarray(jfwd.nmode[:]))
    if not params.get("subset", True):
        # every mode kept: the filter is the identity on the valid modes
        assert _rel(tfilt.vis[:], tsvd.vis[:]) <= 1e-8


def test_kl_mode_project_names_a_missing_basis(setup):
    man = ProductManager(setup["tel"], setup["bt"])
    t = fgfilter.KLModeProject()
    t.read_config({"klname": "nope"})
    t.setup(man)
    with pytest.raises(RuntimeError, match="KL basis 'nope' is not defined"):
        t._get_kl()


# -- the quadratic estimator --------------------------------------------------------


@pytest.fixture(scope="module")
def estimators(setup, svdmodes):
    s = setup
    jsvd, tsvd = svdmodes
    jk, tk = _kl_pair(s, "KLTransform", {"threshold": 0.0, "subset": False})
    jman, man = JProductManager(s["jtel"], s["jbt64"]), ProductManager(s["tel"], s["bt_shared"])
    jman.kltransforms["dk"], man.kltransforms["dk"] = jk, tk
    jklm = _run(jfgfilter.KLModeProject(), {"mode": "forward", "klname": "dk"}, (jman,), jsvd)
    # the KL coefficients carry the eigenvectors' gauge, the band powers do
    # not: each estimator gets its own package's projection of one SVD vector
    tklm = _run(fgfilter.KLModeProject(), {"mode": "forward", "klname": "dk"}, (man,), tsvd)
    return jman, man, jklm, tklm


def _new_estimators(s, jman, man, **extra):
    jps = JPSEstimation.from_config(BANDS, s["jbt64"], jman.kltransforms["dk"])
    tps = PSEstimation.from_config({**BANDS, **extra}, s["bt_shared"], man.kltransforms["dk"])
    jman.psestimators["ps"], man.psestimators["ps"] = jps, tps
    return jps, tps


def test_q_fisher_and_bias_match_jax(setup, estimators):
    jman, man, jklm, tklm = estimators
    jps, tps = _new_estimators(setup, jman, man)
    jps.genbands()
    tps.genbands()
    jq = jps.q_estimator_all(np.asarray(jklm.vis[:]), np.asarray(jklm.nmode[:]))
    tq = tps.q_estimator_all(tklm.vis[:], tklm.nmode[:])
    jfisher, jbias = jps.fisher_bias()
    tfisher, tbias = tps.fisher_bias()
    assert tq.dtype == torch.float64 and tfisher.shape == (2, 2)
    assert _rel(tq, jq) <= 1e-8
    assert _rel(tfisher, jfisher) <= 1e-8
    assert _rel(tbias, jbias) <= 1e-8
    # the per-m form sums to the all-m one, and matches JAX's
    per_m = sum(tps.q_estimator(m, tklm.vis[:][m]) for m in range(tklm.vis.shape[0]))
    assert _rel(per_m, tq) <= 1e-10
    assert _rel(tps.q_estimator(3, tklm.vis[:][3]), jps.q_estimator(3, np.asarray(jklm.vis[:])[3])) <= 1e-8
    assert (tps.q_estimator(3, np.zeros(0)) == 0).all()
    cov, evals = tps._band_kl_cov(3, 1)
    jcov, jevals = jps._band_kl_cov(3, 1)
    assert _rel(evals, jevals) <= 1e-8
    assert _rel(np.sort(np.linalg.eigvalsh(_np(cov))), np.sort(np.linalg.eigvalsh(jcov))) <= 1e-6


@pytest.mark.parametrize("pstype", ["unwindowed", "uncorrelated", "minimum_variance"])
def test_quadratic_ps_estimation_matches_jax(setup, estimators, pstype):
    jman, man, jklm, tklm = estimators
    _new_estimators(setup, jman, man)
    jps = _run(jpowerspectrum.QuadraticPSEstimation(), {"psname": "ps", "pstype": pstype}, (jman,), jklm)
    tps = _run(powerspectrum.QuadraticPSEstimation(), {"psname": "ps", "pstype": pstype}, (man,), tklm)
    assert isinstance(tps, containers.Powerspectrum2D)
    assert tps.powerspectrum.shape == (1, 2) and bool(torch.isfinite(tps.powerspectrum[:]).all())
    assert _rel(tps.powerspectrum[:], jps.powerspectrum[:]) <= 1e-8
    assert _rel(tps.C_inv[:], jps.C_inv[:]) <= 1e-8
    for name in ("kperp", "kpar"):
        assert np.array_equal(tps.index_map[name], jps.index_map[name])


def test_quadratic_ps_estimation_needs_kl_modes(setup, estimators, svdmodes):
    _, man, _, _ = estimators
    t = powerspectrum.QuadraticPSEstimation()
    t.read_config({})
    t.setup(man)
    with pytest.raises(ValueError, match="KLModes container is required"):
        t.process(svdmodes[1])


def test_fisher_accumulation_does_not_depend_on_the_m_chunk(setup, estimators):
    jman, man, _, tklm = estimators
    results = []
    for m_chunk in (None, 1, 7):
        _, tps = _new_estimators(setup, jman, man, m_chunk=m_chunk)
        tps.genbands()
        q = tps.q_estimator_all(tklm.vis[:], tklm.nmode[:])
        results.append((q, *tps.fisher_bias()))
    for got in results[1:]:
        for a, b in zip(got, results[0]):
            assert _rel(a, b) <= 1e-10


def test_ps_estimation_on_a_truncated_basis_matches_jax(setup, svdmodes):
    """With ``subset`` the stored modes are cut per chunk; the Fisher matrix
    and bias see only the kept modes, as the JAX package's masked ones do."""
    s = setup
    params = {"threshold": 1e-3, **MILD}
    jk, tk = _kl_pair(s, "KLTransform", {**params, "m_chunk": None})
    tk.m_chunk = 5
    jps = JPSEstimation.from_config(BANDS, s["jbt64"], jk).genbands()
    tps = PSEstimation.from_config(BANDS, s["bt_shared"], tk).genbands()
    for got, ref in zip(tps.fisher_bias(), jps.fisher_bias()):
        assert _rel(got, ref) <= 1e-8


# -- the SVD filter -------------------------------------------------------------------


@pytest.mark.parametrize("nmasked", [0, 7, 8], ids=["no-mask", "odd-count-left", "even-count-left"])
def test_svd_em_matches_jax(nmasked):
    """15 x 9 = 135 entries: 7 masked leave an even count, 8 an odd one, so
    both median conventions are exercised."""
    rng = np.random.Generator(np.random.SFC64(21))
    A = rng.standard_normal((15, 9)) + 1j * rng.standard_normal((15, 9))
    A += 20.0 * np.outer(rng.standard_normal(15), rng.standard_normal(9))
    mask = np.zeros(A.size, bool)
    mask[rng.choice(A.size, nmasked, replace=False)] = True
    mask = mask.reshape(A.shape)
    ju, jsig, jvh = jsvdfilter.svd_em(A, mask, niter=4, rank=5)
    u, sig, vh = svdfilter.svd_em(A, mask, niter=4, rank=5, device="cpu")
    assert _rel(sig, jsig) <= 1e-10
    assert _rel((u[:, :5] * sig[:5]) @ vh[:5], (ju[:, :5] * jsig[:5]) @ jvh[:5]) <= 1e-10


def test_masked_median_is_numpys_nanmedian():
    rng = np.random.Generator(np.random.SFC64(22))
    x = rng.standard_normal((4, 3, 6))
    mask = rng.uniform(size=x.shape) < 0.4
    mask[2] = True  # nothing left: 0
    mask[3] = False
    mask[3, 0, :4] = True  # 14 left: the mean of the two middle values
    want = np.nan_to_num([np.nanmedian(np.where(m, np.nan, v)) for v, m in zip(x, mask)])
    got = svdfilter._masked_median(torch.from_numpy(x), torch.from_numpy(mask))
    assert np.array_equal(_np(got), want)


def _masked_mmodes(cls, seed=23):
    rng = np.random.Generator(np.random.SFC64(seed))
    mm = cls(mmax=4, freq=np.linspace(400, 440, 8), input=3)
    shape = mm.vis.shape
    noise = 0.01 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    fpat = rng.standard_normal(8) + 1j * rng.standard_normal(8)
    bpat = rng.standard_normal((2, shape[3])) + 1j * rng.standard_normal((2, shape[3]))
    mm.vis[:] = noise + 100.0 * np.einsum("f,sb->sfb", fpat, bpat)[None]
    weight = np.ones(shape)
    weight[rng.uniform(size=shape) < 0.1] = 0.0
    # m = 1 with an even count of valid entries, m = 2 with an odd one
    for m, parity in ((1, 0), (2, 1)):
        weight[m, 0, 0, 0] = 1.0
        if int(weight[m].sum()) % 2 != parity:
            weight[m, 0, 0, 0] = 0.0
    mm.weight[:] = weight
    return mm


def test_svd_filter_with_a_mask_matches_jax():
    params = {"local_threshold": 0.1, "global_threshold": 0.1, "niter": 5}
    jmm, tmm = _masked_mmodes(jcontainers.MModes), _masked_mmodes(containers.MModes)
    valid = (np.asarray(jmm.weight[:]) != 0).sum(axis=(1, 2, 3))
    assert valid[1] % 2 == 0 and valid[2] % 2 == 1 and (valid < jmm.vis[0].size).all()
    jout = _run(jsvdfilter.SVDFilter(), params, (), jmm)
    tout = _run(svdfilter.SVDFilter(), params, (), tmm)
    assert tout is tmm and tout.vis.dtype == torch.complex128
    assert _rel(tout.vis[:], jout.vis[:]) <= 2e-5


def test_svd_spectrum_estimator_matches_jax():
    jmm, tmm = _masked_mmodes(jcontainers.MModes, 24), _masked_mmodes(containers.MModes, 24)
    jspec = _run(jsvdfilter.SVDSpectrumEstimator(), {}, (), jmm)
    tspec = _run(svdfilter.SVDSpectrumEstimator(), {}, (), tmm)
    assert isinstance(tspec, containers.SVDSpectrum)
    assert _rel(tspec.spectrum[:], jspec.spectrum[:]) <= 2e-5
    assert (np.diff(_np(tspec.spectrum[:]), axis=-1) <= 1e-10).all()


# -- the beam SVD on the non-zero columns --------------------------------------------


def test_beam_svd_on_the_nonzero_columns_is_the_whole_matrix_svd(setup):
    """B is zero for l < m, and each block of m is factored on its columns
    l >= m0 alone: the singular values are the whole matrix's (2e-6 of the
    largest, complex64), U stays orthonormal where fewer columns than modes
    are left, Vh is zero at l < m0, and U s Vh gives B back (2e-6)."""
    bt = copy.copy(setup["bt"])
    bt._svd = None
    bt._SVD_M_BLOCK = 5
    bt._ensure_svd()
    U, s, Vh = bt._svd["U"], bt._svd["s"], bt._svd["Vh"]
    tel = bt.telescope
    f, M1, ntel, k = U.shape
    assert k == min(bt.ntel, bt.nsky) and Vh.shape == (f, M1, k, bt.nsky)
    B = torch.cat([bt._bp, bt._bm], dim=1).movedim(-1, 1).reshape(f, M1, ntel, bt.nsky)
    whole = torch.linalg.svdvals(B)
    assert (s - whole).abs().max() <= 2e-6 * whole.max()
    assert ((U * s[..., None, :]) @ Vh - B).abs().max() <= 2e-6 * B.abs().max()
    eye = torch.eye(k, dtype=U.dtype)
    assert (U.mH @ U - eye).abs().max() <= 1e-5
    for m0 in range(0, M1, 5):
        assert not Vh[:, m0 : m0 + 5, :, :m0].any()
    # fewer columns than modes are left at the highest m: the null modes carry s = 0
    assert tel.lmax + 1 - (M1 - 1) < k and bool((s[:, -1, tel.lmax + 2 - M1 :] == 0).all())
    assert torch.equal(bt._svd["nmode"], setup["bt"].nmodes())


def test_ml_pseudo_inverse_on_the_nonzero_columns(setup):
    """The ML solve takes the pseudo-inverse of each m-chunk's columns
    l >= m0: the solution is that of the whole matrices (1e-4 of its peak,
    float32 pseudo-inverse against a complex128 one of the same cut)."""
    from draco_tpu_torch.analysis import mapmaker

    s = setup
    tel, bt = s["tel"], s["bt"]
    ml = mapmaker.MaximumLikelihoodMapMaker()
    ml.read_config({"nside": 8, "m_chunk": 3, "rcond": 1e-2})
    ml.setup(bt)
    shape = (tel.mmax + 1, 2, tel.nfreq, tel.npairs)
    vis, weight = s["mm"].vis[:].reshape(shape), s["mm"].weight[:].reshape(shape)
    alm = ml._solve_all_m(vis, weight, list(range(tel.nfreq)), tel.mmax)  # [f, p, L1, M1]
    L1, M1 = alm.shape[-2:]
    below = torch.arange(L1)[:, None] < (torch.arange(M1)[None, :] // 3) * 3
    assert not alm[..., below].any()
    bp, bm = ml._bt_tensors(list(range(tel.nfreq)))
    Bt, vt = mapmaker._chunk_operands(bp, bm, vis, weight, 0, M1)
    ref = torch.einsum("mfst,mft->mfs", mapmaker.pinv_svd(Bt.to(torch.complex128), acond=ml.acond, rcond=ml.rcond),
                       vt.to(torch.complex128))
    ref = ref.reshape(M1, tel.nfreq, 1, L1).movedim(0, -1)
    assert _rel(alm, ref) <= 1e-4
