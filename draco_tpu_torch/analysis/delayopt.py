"""Delay power spectrum estimation via ML/MAP optimisation.

Port of ``draco_tpu.analysis.delayopt`` (reference
``draco/analysis/delayopt.py``: OptFunc:12, LogLikePS:61,
GaussianProcessPrior:239, AddFunctions:358,
delay_power_spectrum_maxpost:424): a Newton-CG maximisation of the delay
power spectrum likelihood (NRML), with a Gaussian-process smoothness prior.

The negative log-likelihood for the data covariance X with model
C = F S F^H + N is nsamp * (ln det C + tr(C^-1 X)); gradients and
(Fisher or exact) Hessians are computed analytically in the delay basis.

The per-iteration linear algebra (covariance build, Cholesky, solves, the
A/G Gram matrices) runs in complex128 on the likelihood's device;
``scipy.optimize.minimize`` drives the small log-S parameter vector on the
host, as in the reference.  Where this differs from the JAX package, which
factorises in the working precision (complex64 on an accelerator), retries
on the host in float64 when that goes non-finite, and has the switch
``DRACO_TPU_DELAYOPT_DEVICE``: the port's core is complex128 throughout
(the matrices are at most [nchan, ndelay] = [1024, 2048]), with no retry
and no switch.  A factorisation that fails raises
``numpy.linalg.LinAlgError``, as scipy's does on the host.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as la
import torch
from scipy.optimize import minimize

from ..device import resolve
from ..ops import kernels, tools
from ..ops.delay import fourier_matrix

__all__ = ["OptFunc", "LogLikePS", "GaussianProcessPrior", "AddFunctions", "delay_power_spectrum_maxpost"]


def likelihood_core(MF: torch.Tensor, N: torch.Tensor, X: torch.Tensor, s: torch.Tensor):
    """(ln det C, tr C^-1 X, A = F^H C^-1 F, G = F^H C^-1 X C^-1 F) for C = F diag(s) F^H + diag(N).

    One Cholesky factorisation and two solves on the tensors' device.
    Raises ``numpy.linalg.LinAlgError`` where C is not positive definite and
    ``ValueError`` where it is not finite, as ``scipy.linalg.cho_factor``.
    """
    C = (MF * s.to(MF.dtype)[None, :]) @ MF.conj().T
    C.diagonal().add_(N.to(MF.dtype))
    if not bool(torch.isfinite(torch.view_as_real(C)).all()):
        raise ValueError("the likelihood's covariance is not finite")
    L, info = torch.linalg.cholesky_ex(C)
    if int(info) != 0:
        raise np.linalg.LinAlgError(f"the likelihood's covariance is not positive definite (leading minor {int(info)})")
    CiF = torch.cholesky_solve(MF, L)
    CiX = torch.cholesky_solve(X, L)
    A = MF.conj().T @ CiF
    G = MF.conj().T @ (CiX @ CiF)
    logdet = 2 * torch.log(L.diagonal().real).sum()
    return logdet, torch.diagonal(CiX).sum().real, A, G


class OptFunc:
    """Protocol for a function with value/gradient/hessian."""

    def value(self, logs):
        raise NotImplementedError()

    def gradient(self, logs):
        raise NotImplementedError()

    def hessian(self, logs):
        raise NotImplementedError()


class LogLikePS(OptFunc):
    """Negative log-likelihood of a delay power spectrum (reference delayopt.py:61).

    Parameters are log(S); the factorisation of one x is cached, so
    value/gradient/hessian of one iteration share it.  The data (host
    arrays) go to ``device`` in complex128 once; each iteration reads back
    the two [ndelay, ndelay] Gram matrices.
    """

    def __init__(
        self,
        X: np.ndarray,
        MF: np.ndarray,
        N: np.ndarray,
        nsamp: int,
        fsel=None,
        exact_hessian: bool = True,
        bounds: tuple = (1e-10, 1e10),
        device=None,
    ):
        live = (MF != 0).any(axis=1) if fsel is None else fsel
        self.X = X[live][:, live]
        self.N = np.asarray(N)[live]
        self.MF = MF[live]
        self.MFT = self.MF.T.conj()
        self.nsamp = nsamp
        self.exact_hessian = exact_hessian
        self._logbounds = tuple(sorted(np.log(b) for b in bounds))
        self._s_a = None
        dev = resolve(device)
        self._dev = (
            torch.as_tensor(np.asarray(self.MF, dtype=np.complex128), device=dev),
            torch.as_tensor(np.asarray(self.N, dtype=np.float64), device=dev),
            torch.as_tensor(np.asarray(self.X, dtype=np.complex128), device=dev),
        )

    def _precompute(self, x: np.ndarray) -> None:
        if self._s_a is not None and np.array_equal(x, self._s_a):
            return
        x = np.clip(x, *self._logbounds)
        s = np.exp(x)
        MF, N, X = self._dev
        logdet, trCiX, A, G = likelihood_core(MF, N, X, torch.as_tensor(s, device=MF.device))
        self._s = s
        self._A = A.cpu().numpy()
        self._G = G.cpu().numpy()
        self._logdet = float(logdet)
        self._trCiX = float(trCiX)
        self._s_a = x.copy()

    def value(self, logs):
        self._precompute(logs)
        return self.nsamp * (self._logdet + self._trCiX)

    def gradient(self, logs):
        self._precompute(logs)
        diag_gap = np.diag(self._A).real - np.diag(self._G).real
        return self.nsamp * self._s * diag_gap

    def hessian(self, logs):
        self._precompute(logs)
        ss = np.outer(self._s, self._s)
        fisher = self.nsamp * ss * np.abs(self._A) ** 2
        if not self.exact_hessian:
            return fisher
        extra = self.nsamp * ss * (2 * (self._A * self._G.T).real - np.abs(self._A) ** 2)
        return np.diag(self.gradient(logs)) + extra


class GaussianProcessPrior(OptFunc):
    """Smoothness prior on log S: 0.5 x^T K^-1 x with a GP kernel (reference delayopt.py:239).  Host numpy."""

    def __init__(self, N: int, width: float = 5.0, alpha: float = 1.0, kernel: str = "matern", nu: float = 1.5):
        idx = np.arange(N, dtype=np.float64)
        kw = {"width": width, "alpha": alpha, "epsilon": 1e-8}
        if kernel == "matern":
            kw["nu"] = nu
        K = kernels.get_kernel({"name": kernel, **kw})(idx)
        self.Ki = la.inv(K)

    def value(self, logs):
        centred = logs - logs.mean()
        return 0.5 * float(centred @ self.Ki @ centred)

    def gradient(self, logs):
        g = self.Ki @ (logs - logs.mean())
        return g - g.mean()

    def hessian(self, logs):
        return self.Ki


class AddFunctions(OptFunc):
    """Sum of several OptFuncs (reference delayopt.py:358)."""

    def __init__(self, funcs):
        self.funcs = list(funcs)

    def value(self, logs):
        return sum(f.value(logs) for f in self.funcs)

    def gradient(self, logs):
        return sum(f.gradient(logs) for f in self.funcs)

    def hessian(self, logs):
        return sum(f.hessian(logs) for f in self.funcs)


def _windowed_projection(ndelay, chans, window, data, noise_inv):
    """(Fourier matrix, windowed data) for the likelihood, complex128.

    Applies the apodisation to both the projection matrix and the data
    rows, and zeroes fully-missing channels out of the matrix.
    """
    proj = fourier_matrix(ndelay, chans).astype(np.complex128, copy=False)
    rows = data.astype(proj.dtype, copy=True)
    if window is not None:
        taper = tools.window_generalised(chans / ndelay, window=window).numpy()
        proj = proj * taper[:, np.newaxis]
        rows = rows * taper[np.newaxis, :]
    proj[noise_inv == 0] = 0.0
    return proj, rows


def delay_power_spectrum_maxpost(
    data,
    N,
    Ni,
    initial_S=None,
    window: str = "nuttall",
    fsel=None,
    maxiter: int = 100,
    tol: float = 1e-3,
    bounds: tuple = (1e-15, 1e10),
    device=None,
):
    """Maximum-likelihood delay power spectrum of one baseline (reference delayopt.py:424).

    ``data`` [nsamp, nchan] and ``Ni`` [nchan] are host arrays; the
    likelihood's factorisations run on ``device``.  Returns (list of
    samples including the initial guess, success flag).
    """
    nsamp, nchan = data.shape
    if fsel is None:
        fsel = np.arange(nchan)
    elif len(fsel) != nchan:
        raise ValueError(
            f"The frequency selection ({len(fsel)}) does not cover the data's {data.shape[-1]} channels."
        )

    proj, rows = _windowed_projection(N, fsel, window, data, Ni)

    if initial_S is None:
        initial_S = (rows @ la.pinv(proj.T, rtol=1e-3)).var(axis=0)
    guess = np.maximum(np.abs(initial_S), bounds[0])

    posterior = AddFunctions(
        [
            LogLikePS(
                (rows.T @ rows.conj()) / nsamp,
                proj,
                tools.invert_no_zero(torch.as_tensor(np.asarray(Ni, dtype=np.float64))).numpy(),
                nsamp,
                exact_hessian=True,
                bounds=bounds,
                device=device,
            ),
            GaussianProcessPrior(N, width=5, alpha=1.0, kernel="matern", nu=1.5),
        ]
    )

    samples = [guess]

    def record(xk):
        samples.append(np.exp(xk))

    try:
        fit = minimize(
            posterior.value,
            x0=np.log(guess),
            jac=posterior.gradient,
            hess=posterior.hessian,
            method="Newton-CG",
            options=dict(maxiter=maxiter, xtol=tol),
            callback=record,
        )
        success = fit.success
    except (la.LinAlgError, ValueError):
        success = False
    return samples, success
