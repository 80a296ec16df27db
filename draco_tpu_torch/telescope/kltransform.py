"""Karhunen-Loeve foreground/signal transforms.

Port of ``draco_tpu.telescope.kltransform``, the replacement of
``drift.core.kltransform`` (API usage:
``manager.kltransforms[name].project_vector_svd_to_kl/kl_to_svd`` at
reference draco/analysis/fgfilter.py:193,229).

For each m, the signal and noise+foreground covariances are built in the
telescope SVD basis from parametric sky models (power-law angular spectra;
a rapidly frequency-decorrelating 21cm-like signal and smooth spectrum
foregrounds), and the generalised eigenproblem S v = lambda (N+F) v is
solved with batched factorisations on the beam transfer's device.  Modes
with high signal-to-(foreground+noise) lambda are kept.

Where this differs from the JAX package, which solves every m as one
batch [M, n, n] and keeps the modes as host arrays:

* the solve runs in m-chunks sized from a memory budget (``m_chunk``
  overrides it); every m is solved independently, so the modes do not
  depend on the chunk size;
* the pencil is solved in complex128 (the beam SVD stays complex64):
  foregrounds are ~1e7 x the signal, and ``PERF.md`` records what
  complex64 loses on the card;
* the modes stay on the device, and with ``subset`` each chunk's
  ``fwd``/``bwd`` are stored truncated to the chunk's largest kept-mode
  count at the configured threshold; a later call with a lower threshold
  solves again and stores more.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config
from ..device import as_tensor

# bytes of device memory one chunk of the solve may take when m_chunk is unset
CHUNK_BYTES = 6 * 2**30


def _whitened_eigh(S: torch.Tensor, N: torch.Tensor):
    """Batched generalised Hermitian eigenproblem S v = lambda N v.

    Cholesky-whitening formulation: with N = L L^H, the pencil reduces
    to the ordinary Hermitian problem (L^-1 S L^-H) u = lambda u with
    v = L^-H u.  Returns (evals, evecs, einv) ordered descending in
    eigenvalue, with the scipy ``eigh(S, N)`` normalisation v^H N v = I.
    ``einv`` is the batched LU inverse of the COMPUTED eigenvectors (not
    the analytic U^H L^H): for ill-conditioned pencils the forward/backward
    projections must invert each other to machine precision even though
    the whitening solves themselves carry O(eps * cond(L)) error.

    Raises ``torch.linalg.LinAlgError`` when a Cholesky factorisation or an
    inverse of the batch fails; nothing is retried.
    """
    L, info = torch.linalg.cholesky_ex(N)
    if bool((info != 0).any()):
        bad = torch.nonzero(info != 0).flatten().tolist()
        raise torch.linalg.LinAlgError(
            f"_whitened_eigh: the Cholesky factorisation of N failed for batch entries {bad[:8]} "
            f"(leading minor {int(info[bad[0]])} of the first is not positive definite)"
        )
    # A = L^-1 S L^-H via two triangular solves
    X = torch.linalg.solve_triangular(L, S, upper=False)
    A = torch.linalg.solve_triangular(L, X.mH, upper=False).mH
    A = 0.5 * (A + A.mH)
    evals, U = torch.linalg.eigh(A)  # ascending
    evecs = torch.linalg.solve_triangular(L.mH, U, upper=True)
    einv, info = torch.linalg.inv_ex(evecs)
    if bool((info != 0).any()):
        bad = torch.nonzero(info != 0).flatten().tolist()
        raise torch.linalg.LinAlgError(f"_whitened_eigh: the eigenvector matrices of batch entries {bad[:8]} are singular")
    # descending order
    return evals.flip(-1), evecs.flip(-1), einv.flip(-2)


def _regularise(X: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Add a relative-eps diagonal so the Cholesky stays PD."""
    n = X.shape[-1]
    absmax = X.abs().reshape(X.shape[0], -1).max(dim=-1).values.clamp(min=1e-30)
    return X + (eps * absmax)[:, None, None] * torch.eye(n, dtype=X.dtype, device=X.device)


def _pad_rows(vecs: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``vecs`` [M, n_in, ...] cut or zero-padded to n rows, as ``dtype``."""
    v = torch.zeros((vecs.shape[0], n) + tuple(vecs.shape[2:]), dtype=dtype, device=vecs.device)
    ncopy = min(vecs.shape[1], n)
    v[:, :ncopy] = vecs[:, :ncopy]
    return v


def _row_mask(nmode: torch.Tensor, n: int, ndim: int) -> torch.Tensor:
    """[M, n, 1, ...] mask of rows below each m's mode count."""
    mask = torch.arange(n, device=nmode.device)[None, :] < nmode[:, None]
    return mask.reshape(mask.shape + (1,) * (ndim - 2))


class KLTransform(config.Reader):
    """Signal/foreground KL transform over the telescope SVD basis.

    Attributes
    ----------
    subset : bool
        Keep only modes above the threshold.
    threshold : float
        S/(F+N) eigenvalue threshold for keeping modes.
    signal_amp, signal_tilt : float
        Power-law angular spectrum of the signal: A^2 (l/100)^-tilt.
    signal_corr_freq : float
        Frequency decorrelation length of the signal in MHz.
    foreground_amp, foreground_tilt : float
        Power-law angular spectrum of the foregrounds.
    foreground_spec_corr : float
        Spectral correlation of foregrounds (~1 = fully correlated).
    noise_amp : float
        Thermal noise variance in the telescope basis.
    m_chunk : int
        m values per batched solve; unset, it is sized so that one chunk's
        matrices take about ``CHUNK_BYTES`` of device memory.
    """

    subset = config.bool_prop(True)
    threshold = config.float_prop(0.1)
    signal_amp = config.float_prop(1.0)
    signal_tilt = config.float_prop(1.0)
    signal_corr_freq = config.float_prop(2.0)
    foreground_amp = config.float_prop(100.0)
    foreground_tilt = config.float_prop(3.0)
    foreground_spec_corr = config.float_prop(0.999)
    noise_amp = config.float_prop(1e-2)
    m_chunk = config.int_prop(None)

    # the dtype the pencil is built and solved in
    _solve_dtype = torch.complex128

    def __init__(self, bt=None):
        self.beamtransfer = bt
        self._modes = None

    @classmethod
    def from_config(cls, cfg, bt=None):
        self = cls(bt)
        self.read_config(cfg or {})
        return self

    # -- covariance models ---------------------------------------------------
    def _freq_cov_signal(self, freq):
        df = freq[:, None] - freq[None, :]
        return np.exp(-0.5 * (df / self.signal_corr_freq) ** 2)

    def _freq_cov_foreground(self, freq):
        n = len(freq)
        base = np.full((n, n), self.foreground_spec_corr)
        np.fill_diagonal(base, 1.0)
        spec = (freq[:, None] * freq[None, :] / freq.mean() ** 2) ** -2.0
        return base * spec

    def _cl(self, lmax, amp, tilt):
        ell = np.arange(lmax + 1, dtype=np.float64)
        ell[0] = 1.0
        return amp**2 * (ell / 100.0) ** (-tilt)

    def signal(self, lmax, freq):
        """Signal covariance [l, f, f']."""
        cl = self._cl(lmax, self.signal_amp, self.signal_tilt)
        return cl[:, None, None] * self._freq_cov_signal(freq)[None]

    def foreground(self, lmax, freq):
        """Foreground covariance [l, f, f']."""
        cl = self._cl(lmax, self.foreground_amp, self.foreground_tilt)
        return cl[:, None, None] * self._freq_cov_foreground(freq)[None]

    def _sky_covariances(self) -> np.ndarray:
        """[signal, foreground] sky covariances [2, l, f, f'] of the telescope."""
        tel = self.beamtransfer.telescope
        return np.stack([self.signal(tel.lmax, tel.frequencies), self.foreground(tel.lmax, tel.frequencies)])

    # -- SVD-basis covariance construction -------------------------------------
    @property
    def _size(self) -> tuple[int, int]:
        """(number of m, packed SVD dimension n = nfreq * k)."""
        bt = self.beamtransfer
        bt._ensure_svd()
        nfreq, M, k = bt._svd["s"].shape
        return M, nfreq * k

    def _svd_proj_all(self, m0: int = 0, m1: int | None = None) -> torch.Tensor:
        """Projection tensor P [m1 - m0, f, k, npol * L1] of a range of m.

        The packed SVD vector concatenates each frequency's SVD modes
        (reference fgfilter.py:56-58); the mapping from sky alm is
        P[f] = Sigma V^H for that frequency's beam SVD.
        """
        bt = self.beamtransfer
        bt._ensure_svd()
        s = bt._svd["s"][:, m0:m1].movedim(1, 0)  # [mc, f, k]
        Vh = bt._svd["Vh"][:, m0:m1].movedim(1, 0)  # [mc, f, k, nsky]
        # widened before the product, so that P carries the SVD's own rounding only
        return s[..., None].to(self._solve_dtype) * Vh.to(self._solve_dtype)

    def _svd_cov_all(self, C_xlff, m0: int = 0, m1: int | None = None) -> torch.Tensor:
        """Project sky covariances [x, l, f, f'] into the packed SVD basis.

        Returns [m1 - m0, x, n, n] with n = nfreq * k:
        out[m,x,ak,bj] = sum_{p,l} P[m,a,k,p,l] C[x,l,a,b] conj(P[m,b,j,p,l]).
        """
        P = self._svd_proj_all(m0, m1)  # [mc, f, k, q], q = (p, l)
        mc, nfreq, k, nq = P.shape
        C = as_tensor(C_xlff, P.device).to(P.dtype)
        npol = nq // C.shape[1]
        Cq = C.repeat(1, npol, 1, 1)  # [x, q, a, b]
        T = torch.einsum("makq,xqab->mxabkq", P, Cq)
        out = torch.einsum("mxabkq,mbjq->mxakbj", T, P.conj())
        n = nfreq * k
        return out.reshape(mc, C.shape[0], n, n)

    def _noise_svd_all(self, m0: int = 0, m1: int | None = None) -> torch.Tensor:
        """Thermal noise covariance [m1 - m0, n, n] in the packed SVD basis.

        N_tel = noise_amp * I  ->  per-frequency blocks noise_amp U^H U,
        assembled block-diagonally.
        """
        bt = self.beamtransfer
        bt._ensure_svd()
        U = bt._svd["U"][:, m0:m1].movedim(1, 0).to(self._solve_dtype)  # [mc, f, ntel, k]
        mc, nfreq, _, k = U.shape
        G = self.noise_amp * torch.einsum("mfak,mfaj->mfkj", U.conj(), U)
        n = nfreq * k
        out = torch.zeros((mc, n, n), dtype=G.dtype, device=G.device)
        for fi in range(nfreq):
            out[:, fi * k : (fi + 1) * k, fi * k : (fi + 1) * k] = G[:, fi]
        return out

    def _svd_cov(self, m: int, C_lff) -> torch.Tensor:
        """Sky-covariance projection [n, n] of one m."""
        return self._svd_cov_all(np.asarray(C_lff)[None], m, m + 1)[0, 0]

    def _noise_svd(self, m: int) -> torch.Tensor:
        """Noise covariance [n, n] of one m."""
        return self._noise_svd_all(m, m + 1)[0]

    # -- KL modes -------------------------------------------------------------
    def generate(self, regen: bool = False):
        return self

    def _chunk_len(self, ncov: int, nlive: int = 12) -> int:
        """m values per chunk of the batched solve.

        One m of a chunk holds the covariance projection's intermediate
        (``ncov`` sky covariances x nfreq x n x nsky) and about ``nlive``
        n x n matrices.
        """
        if self.m_chunk is not None:
            return self.m_chunk
        bt = self.beamtransfer
        n = self._size[1]
        itemsize = torch.empty((), dtype=self._solve_dtype).element_size()
        per_m = (ncov * bt.nfreq * n * bt.nsky + (ncov + nlive) * n * n) * itemsize
        return max(1, CHUNK_BYTES // per_m)

    def _m_chunks(self, ncov: int):
        """(m0, m1) ranges of the batched solve."""
        M = self._size[0]
        chunk = self._chunk_len(ncov)
        for m0 in range(0, M, chunk):
            yield m0, min(m0 + chunk, M)

    def _pencil(self, m0: int, m1: int):
        """(S, F, N_thermal) [m1 - m0, n, n] of a range of m."""
        SC = self._svd_cov_all(self._sky_covariances(), m0, m1)
        return SC[:, 0], SC[:, 1], self._noise_svd_all(m0, m1)

    def _solve_chunk(self, S, F, Nt):
        """(evals, fwd, bwd) of one chunk of the signal/(foreground+noise) pencil.

        The STATISTICAL convention: the data projection is fwd = V^H (rows =
        KL modes): with v^H N v = I the projected covariance is
        V^H (S+N) V = diag(lambda + 1) EXACTLY, which is what the quadratic
        estimator's diagonal inverse-covariance weighting assumes (driftscan
        convention).  bwd = V^{-H} (columns = KL modes) inverts it:
        fwd @ bwd = I.  (Projecting with V^{-1} instead, a basis change
        that also round-trips, gives a NON-diagonal covariance and
        silently biases the band powers.)
        """
        evals, evecs, einv = _whitened_eigh(S, _regularise(F + Nt))
        return evals, evecs.mH, einv.mH

    def _compute_all_modes(self, store_threshold: float | None = None):
        """Solve the KL pencil for every m, in m-chunks on the device.

        All m share the packed-SVD dimension n = nfreq * k (ragged ranks are
        zero-padded upstream), so the reference's per-m host
        ``scipy.linalg.eigh(S, N)`` loop is a Cholesky-whitened batched
        ``eigh`` per chunk.  With ``subset``, each chunk's fwd/bwd are kept
        up to its largest mode count above ``store_threshold`` (default: the
        configured threshold).
        """
        thr = self.threshold if store_threshold is None else store_threshold
        evals_all, chunks = [], []
        for m0, m1 in self._m_chunks(ncov=2):
            evals, fwd, bwd = self._solve_chunk(*self._pencil(m0, m1))
            evals = evals.real
            keep = int((evals > thr).sum(dim=-1).max()) if self.subset else evals.shape[-1]
            evals_all.append(evals)
            chunks.append((m0, m1, bwd[:, :, :keep].clone(), fwd[:, :keep].clone()))
        self._modes = {"evals": torch.cat(evals_all), "chunks": chunks, "threshold": thr}

    def _ensure_modes(self, threshold: float | None = None):
        """(stored modes, mode counts [M] at ``threshold``)."""
        thr = self.threshold if threshold is None else threshold
        if self._modes is None or (self.subset and thr < self._modes["threshold"]):
            self._compute_all_modes(store_threshold=min(thr, self.threshold))
        evals = self._modes["evals"]
        if self.subset:
            nmode = (evals > thr).sum(dim=-1)
        else:
            nmode = torch.full((evals.shape[0],), evals.shape[1], dtype=torch.long, device=evals.device)
        return self._modes, nmode

    def evals_all(self) -> torch.Tensor:
        """Eigenvalues [M, n] of every m, descending."""
        return self._ensure_modes()[0]["evals"]

    def modes_m(self, m: int, threshold: float | None = None):
        """(evals, bwd, fwd) for one m, high-S/N first.

        ``fwd`` [nmode, n] projects SVD-basis data into the KL basis
        (cov(fwd x) = diag(evals + 1)); ``bwd`` [n, nmode] maps back
        (fwd @ bwd = I on the kept modes).
        """
        modes, nmode = self._ensure_modes(threshold)
        k = int(nmode[m])
        for m0, m1, bwd, fwd in modes["chunks"]:
            if m0 <= m < m1:
                return modes["evals"][m, :k], bwd[m - m0, :, :k], fwd[m - m0, :k]
        raise IndexError(f"m = {m} is outside 0..{modes['evals'].shape[0] - 1}")

    def project_vector_svd_to_kl(self, m: int, vec, threshold=None):
        """SVD-basis vector(s) -> KL basis (truncated)."""
        evals, bwd, fwd = self.modes_m(m, threshold)
        vec = as_tensor(vec, fwd.device)
        return fwd @ _pad_rows(vec[None], fwd.shape[1], fwd.dtype)[0]

    def project_vector_kl_to_svd(self, m: int, vec, threshold=None):
        """KL-basis vector(s) -> SVD basis (zero-padding short input)."""
        evals, bwd, fwd = self.modes_m(m, threshold)
        vec = as_tensor(vec, bwd.device)
        return bwd @ _pad_rows(vec[None], bwd.shape[1], bwd.dtype)[0]

    # -- batched all-m projections -----------------------------------------
    def modes_all(self, threshold=None):
        """Stacked modes over every m: (evals, bwd, fwd, nmode).

        evals [M, n], bwd/fwd [M, n, n] (high-S/N modes first, as in
        :meth:`modes_m`; zero past what is stored), nmode [M] = per-m
        kept-mode count at the threshold.  The stack takes 2 M n^2 complex
        numbers on the device: the projections below go chunk by chunk
        instead.
        """
        modes, nmode = self._ensure_modes(threshold)
        evals = modes["evals"]
        M, n = evals.shape
        dt, dev = modes["chunks"][0][2].dtype, evals.device
        bwd_all = torch.zeros((M, n, n), dtype=dt, device=dev)
        fwd_all = torch.zeros((M, n, n), dtype=dt, device=dev)
        for m0, m1, bwd, fwd in modes["chunks"]:
            bwd_all[m0:m1, :, : bwd.shape[-1]] = bwd
            fwd_all[m0:m1, : fwd.shape[1]] = fwd
        return evals, bwd_all, fwd_all, nmode

    def project_svd_to_kl(self, vecs, threshold=None):
        """Batched SVD->KL over every m.

        vecs [M, n_in, ...] -> (out [M, n, ...] zero-padded past each
        m's kept-mode count, nmode [M]).
        """
        modes, nmode = self._ensure_modes(threshold)
        n = modes["evals"].shape[1]
        dt = modes["chunks"][0][2].dtype
        v = _pad_rows(as_tensor(vecs, modes["evals"].device), n, dt)
        out = torch.zeros_like(v)
        for m0, m1, _, fwd in modes["chunks"]:
            out[m0:m1, : fwd.shape[1]] = torch.einsum("mkn,mn...->mk...", fwd, v[m0:m1])
        return out * _row_mask(nmode, n, out.ndim), nmode

    def project_kl_to_svd(self, vecs, threshold=None):
        """Batched KL->SVD over every m (inverse of the above)."""
        modes, nmode = self._ensure_modes(threshold)
        n = modes["evals"].shape[1]
        dt = modes["chunks"][0][2].dtype
        v = _pad_rows(as_tensor(vecs, modes["evals"].device), n, dt)
        v = v * _row_mask(nmode, n, v.ndim)
        out = torch.zeros_like(v)
        for m0, m1, bwd, _ in modes["chunks"]:
            out[m0:m1] = torch.einsum("mnk,mk...->mn...", bwd, v[m0:m1, : bwd.shape[-1]])
        return out


class DoubleKL(KLTransform):
    """Two-stage KL (driftscan DoubleKL semantics).

    Stage 1 solves the signal/(foreground+noise) pencil and RETAINS only
    modes with S/(F+N) above ``foreground_threshold``: the foreground
    rejection; stage 2 re-solves signal/noise inside that subspace, so
    the final eigenvalues are true S/N ratios.  Batched over m: rejected
    directions are zeroed out of the stage-2 pencil, where they pick up
    ~0 eigenvalues, sort last, and fall to the threshold cut.
    """

    foreground_threshold = config.float_prop(100.0)

    def _solve_chunk(self, S, F, Nt):
        # Stage 1: signal vs foreground(+noise)
        e1, v1, i1 = _whitened_eigh(S, _regularise(F + Nt))
        keep1 = e1.real > self.foreground_threshold
        P1 = torch.where(keep1[..., None], v1.mH, torch.zeros((), dtype=v1.dtype, device=v1.device))
        P1h = P1.mH

        # Stage 2: signal vs noise inside the retained subspace
        e2, v2, i2 = _whitened_eigh(P1 @ S @ P1h, _regularise(P1 @ Nt @ P1h))

        # Combined transforms: data fwd = V2^H P1, backward = its inverse
        return e2, v2.mH @ P1, i1.mH @ i2.mH
