"""Delay-spectrum estimation: Fourier matrices, FFT, Wiener and Gibbs estimators.

Port of ``draco_tpu.ops.delay`` (reference ``draco/analysis/delay.py``:
Fourier matrices :1480-1613, delay_power_spectrum_gibbs :1713,
delay_spectrum_gibbs_cross :1907, delay_spectrum_fft :2102,
delay_spectrum_wiener_filter :2132, the axis helpers :2209-2324).

Host numpy, copied from the JAX package so that it stays exact against it
under the same numpy ``Generator``: the Fourier matrices, the input
preparation, the Wiener filter, the per-baseline Gibbs samplers (auto and
cross) and the axis helpers (which here also take tensors).

Device programs, on the device of their input tensors:

* :func:`delay_spectrum_fft`, an inverse FFT;
* :func:`delay_power_spectrum_gibbs_batched`, the Gibbs chains of many
  baselines together: batched ``cholesky_ex`` and ``cholesky_solve`` of
  the [ndelay, ndelay] systems, normals and chi-square draws (as
  ``2 Gamma(df / 2)``) from ``torch.Generator``\\ s;
* :func:`delay_spectrum_gibbs_cross_batched`, the cross-spectrum chains,
  with the per-delay Wishart draw of :func:`.random.complex_wishart`.

Where the batched samplers differ from the JAX package, which draws every
chain from one PRNG key (folded per baseline chunk in the cross sampler):

* each baseline has its own seed and ``torch.Generator``, and every
  device call of the chain runs on a fixed number of baselines (``batch``,
  the tail padded), so a baseline's samples depend on its data, its seed
  and ``batch`` only, not on the other baselines;
* the batches are taken one at a time through the whole chain, so the
  device holds one batch's [ndelay, ndelay] normal matrices and factors;
* a failed factorisation is reported, not hidden: ``cholesky_ex``'s
  ``info`` marks the chain (cuSOLVER does not raise), and the caller masks
  or re-samples it.

The float32 policy of the package (no TF32) keeps every product of the
chain at float32 fidelity: the JAX package pins the same
(``Precision.HIGHEST``) because bf16 products made the high-SNR systems
indefinite.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor
from . import random as drandom
from . import tools

__all__ = [
    "fourier_matrix_r2c",
    "fourier_matrix_c2r",
    "fourier_matrix_c2c",
    "fourier_matrix",
    "delay_spectrum_fft",
    "delay_spectrum_wiener_filter",
    "delay_power_spectrum_gibbs",
    "delay_power_spectrum_gibbs_batched",
    "gibbs_step",
    "delay_spectrum_gibbs_cross",
    "delay_spectrum_gibbs_cross_batched",
    "match_axes",
    "flatten_axes",
]

# baselines in every device call of the batched auto chain: at nd = 2048 a
# step took 2.97, 1.97 and 1.29 ms a baseline at 8, 16 and 32, and the
# batched Cholesky and solve were fastest a matrix at 128
# (scripts/torch_linalg_rates.py --delay on an NVIDIA H100 80GB HBM3 at 700 W)
GIBBS_BATCH = 128
# baselines in every device call of the batched cross chain (the JAX package's default bchunk)
CROSS_BATCH = 32


# ---------------------------------------------------------------------------
# Fourier matrices (reference delay.py:1480-1613)
# ---------------------------------------------------------------------------


def _dft_angles(N: int, fsel, nchan_default: int) -> np.ndarray:
    """Phase table 2*pi*f*t/N, [nsel, N]."""
    chans = np.arange(nchan_default) if fsel is None else np.array(fsel)
    return 2 * np.pi * np.outer(chans, np.arange(N)) / N


def fourier_matrix_r2c(N: int, fsel=None) -> np.ndarray:
    """Real-to-complex FFT matrix, alternating re/im rows (delay.py:1480)."""
    arg = _dft_angles(N, fsel, N // 2 + 1)
    out = np.zeros((2 * arg.shape[0], N), dtype=np.float64)
    out[0::2] = np.cos(arg)
    out[1::2] = -np.sin(arg)
    return out


def fourier_matrix_c2r(N: int, fsel=None) -> np.ndarray:
    """Complex-to-real inverse FFT matrix (delay.py:1513)."""
    chans = np.arange(N // 2 + 1) if fsel is None else np.array(fsel)
    # DC and Nyquist rows carry no doubled conjugate partner
    scale = np.where((chans == 0) | (chans == N // 2), 1.0, 2.0) / N
    arg = _dft_angles(N, fsel, N // 2 + 1).T
    out = np.zeros((N, 2 * chans.shape[0]), dtype=np.float64)
    out[:, 0::2] = np.cos(arg) * scale
    out[:, 1::2] = -np.sin(arg) * scale
    return out


def fourier_matrix_c2c(N: int, fsel=None) -> np.ndarray:
    """Complex-to-complex FFT as a real matrix over alternating re/im (delay.py:1549)."""
    arg = _dft_angles(N, fsel, N)
    c, s = np.cos(arg), np.sin(arg)
    out = np.zeros((2 * arg.shape[0], 2 * N), dtype=np.float64)
    out[0::2, 0::2] = c
    out[0::2, 1::2] = s
    out[1::2, 0::2] = -s
    out[1::2, 1::2] = c
    return out


def fourier_matrix(N: int, fsel=None) -> np.ndarray:
    """Complex Fourier matrix exp(-2 pi i t f / N) (delay.py:1588)."""
    return np.exp(-1.0j * _dft_angles(N, fsel, N))


def _complex_to_alternating_real(array):
    return array.astype(np.complex128, order="C").view(np.float64)


def _alternating_real_to_complex(array):
    return np.ascontiguousarray(array.astype(np.float64)).view(np.complex128)


# ---------------------------------------------------------------------------
# Shared input preparation (reference delay.py:1657-1710)
# ---------------------------------------------------------------------------


def _chan_taper(fsel, total_freq, window):
    """Apodisation over the selected channels, doubled for re/im rows."""
    taper = tools.window_generalised(np.asarray(fsel) / total_freq, window=window).numpy()
    return np.repeat(taper, 2)


def _alternating_noise_inverse(Ni, fsel, N, complex_timedomain):
    """Per-alternating-row inverse noise.

    Purely-real channels (DC/Nyquist of a real transform) put all their
    information in the re row; every other channel splits across re/im
    with doubled weight.  Ni may be [nfreq] or [..., nfreq].
    """
    if complex_timedomain:
        lone_real = np.zeros(fsel.shape, dtype=bool)
    else:
        lone_real = (fsel == 0) | (fsel == N // 2)
    out = np.zeros(Ni.shape[:-1] + (2 * Ni.shape[-1],))
    out[..., 0::2] = np.where(lone_real, Ni, Ni * 2)
    out[..., 1::2] = np.where(lone_real, 0.0, Ni * 2)
    return out


def _compute_delay_spectrum_inputs(data, N, Ni, fsel, window, complex_timedomain):
    """Pre-whitened alternating-real data + noise-weighted Fourier matrices."""
    F, taper, fsel = _design(N, fsel, window, complex_timedomain)
    rows = _complex_to_alternating_real(data).T.copy()
    if taper is not None:
        rows = rows * taper[:, np.newaxis]

    Ni_r = _alternating_noise_inverse(Ni, fsel, N, complex_timedomain)
    root = Ni_r**0.5
    FTNih = F.T * root[np.newaxis, :]
    return rows * root[:, np.newaxis], FTNih, FTNih @ FTNih.T, fsel


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


def delay_spectrum_fft(data, N: int, window="nuttall", device=None) -> torch.Tensor:
    """Delay transform by inverse FFT along the last axis, on the data's device (reference delay.py:2102)."""
    d = as_tensor(data, device)
    if window is None:
        return torch.fft.ifft(d, dim=-1)
    x = torch.arange(N, dtype=torch.float64, device=d.device) / N
    w = tools.window_generalised(x, window=window).to(d.real.dtype)
    return torch.fft.ifft(d * w[None], dim=-1)


def delay_spectrum_wiener_filter(delay_PS, data, N, Ni, window="nuttall", fsel=None, complex_timedomain=False):
    """Wiener-filtered delay spectrum (reference delay.py:2132).  Host numpy.

    See arXiv:2202.01242 Eq. A6.
    """
    data, FTNih, FTNiF, fsel = _compute_delay_spectrum_inputs(data, N, Ni, fsel, window, complex_timedomain)
    Si = _invert_no_zero_np(np.asarray(delay_PS))
    if complex_timedomain:
        Si = 2.0 * np.repeat(Si, 2)
    y_spec = _solve_regularised(FTNiF, Si, FTNih @ data).T
    if complex_timedomain:
        y_spec = _alternating_real_to_complex(y_spec)
    return y_spec


def _invert_no_zero_np(x):
    return tools.invert_no_zero(torch.as_tensor(np.asarray(x))).numpy()


def _solve_regularised(FTNiF, Si_diag, rhs):
    """cho_solve of (FTNiF + diag(Si)) x = rhs (both overwritten)."""
    import scipy.linalg as la

    system = FTNiF.copy()
    system[np.diag_indices_from(system)] += Si_diag
    factor = la.cho_factor(system, check_finite=False, lower=False, overwrite_a=True)
    return la.cho_solve(factor, rhs, check_finite=False, overwrite_b=True)


def delay_power_spectrum_gibbs(
    data,
    N,
    Ni,
    initial_S,
    window="nuttall",
    fsel=None,
    niter=20,
    rng=None,
    complex_timedomain=False,
):
    """Gibbs-sample the delay power spectrum of one baseline (reference delay.py:1713).  Host numpy.

    Alternates a perturbed-Wiener signal draw (frequency- or time-basis
    form depending on dimensions, delay.py:1884-1886) with an inverse-chi^2
    power spectrum draw.  Returns (list of samples, success flag).
    """
    if rng is None:
        rng = np.random.default_rng()

    draws = []
    data, FTNih, FTNiF, fsel = _compute_delay_spectrum_inputs(data, N, Ni, fsel, window, complex_timedomain)
    ndelay_rows = 2 * N if complex_timedomain else N
    nsamp = data.shape[1]

    def _noise():
        return (
            rng.standard_normal((ndelay_rows, nsamp)),
            rng.standard_normal(data.shape),
        )

    def _signal_via_delay_basis(S):
        # "frequency" form of the perturbed-Wiener draw (delay.py:1884):
        # solve in the ndelay x ndelay system, cheap when most channels
        # are retained
        Si = _invert_no_zero_np(S)
        if complex_timedomain:
            Si = 2.0 * np.repeat(Si, 2)
        eps_s, eps_n = _noise()
        rhs = eps_s * (Si**0.5)[:, np.newaxis] + FTNih @ (data + eps_n)
        return _solve_regularised(FTNiF, Si, rhs)

    def _signal_via_chan_basis(S):
        # "time" form: solve in the (smaller) retained-channel system
        Sh = S**0.5
        if complex_timedomain:
            Sh = (0.5**0.5) * np.repeat(Sh, 2)
        eps_s, eps_n = _noise()
        Rt = FTNih * Sh[:, np.newaxis]
        R = Rt.T.conj()
        rhs = eps_n - R @ eps_s + data
        x = _solve_regularised(R @ Rt, np.ones(R.shape[0]), rhs)
        return Sh[:, np.newaxis] * ((Rt @ x) + eps_s)

    def _spectrum_draw(d):
        # inverse-chi^2 draw about the realised sample variance
        S_hat = d.var(axis=-1)
        if complex_timedomain:
            S_hat = S_hat[::2] + S_hat[1::2]
        return S_hat * nsamp / rng.chisquare(nsamp, size=S_hat.shape[0])

    dense = len(fsel) > 0.25 * N
    _signal_draw = _signal_via_delay_basis if dense else _signal_via_chan_basis

    S_samp = initial_S
    for _ in range(niter):
        try:
            d_samp = _signal_draw(S_samp)
        except np.linalg.LinAlgError:
            return draws, False
        S_samp = _spectrum_draw(d_samp)
        draws.append(S_samp)
    return draws, True


def _design(N, fsel, window, complex_timedomain):
    """(F [2 nsel, nd] float64 with the taper folded into its rows, taper [2 nsel] or None, fsel)."""
    total_freq = N if complex_timedomain else N // 2 + 1
    fsel = np.arange(total_freq) if fsel is None else np.asarray(fsel)
    F = fourier_matrix_c2c(N, fsel) if complex_timedomain else fourier_matrix_r2c(N, fsel)
    taper = None
    if window is not None:
        taper = _chan_taper(fsel, total_freq, window)
        F = F * taper[:, np.newaxis]
    return F, taper, fsel


def gibbs_step(FTNiF, Ft, Nih, dw, S, w1, w2, chi2, complex_timedomain=False):
    """One Gibbs iteration of a batch of baselines.

    FTNiF [B, nd, nd]; Ft [nd, 2F] (the tapered Fourier matrix, shared);
    Nih [B, 2F] root inverse noise; dw [B, nsamp, 2F] whitened data; S [B,
    nS] the current spectra; w1 [B, nsamp, nd], w2 [B, nsamp, 2F] standard
    normals and chi2 [B, nS] chi-square draws of nsamp degrees of freedom.
    The perturbed-Wiener draw of :func:`delay_power_spectrum_gibbs`'s
    delay basis, ``(FTNiF + S^-1) x = S^-1/2 w1 + FTNih (dw + w2)``, then
    ``S = var(x) nsamp / chi2``.  Returns (S [B, nS], cholesky info [B]).
    """
    Si = torch.where(S > 0, 1.0 / torch.where(S > 0, S, torch.ones_like(S)), torch.zeros_like(S))
    Si_e = 2.0 * torch.repeat_interleave(Si, 2, dim=-1) if complex_timedomain else Si
    Ci = FTNiF.clone()
    Ci.diagonal(dim1=-2, dim2=-1).add_(Si_e)
    L, info = torch.linalg.cholesky_ex(Ci)
    del Ci
    y = w1 * torch.sqrt(Si_e)[:, None, :] + (Nih[:, None, :] * (dw + w2)) @ Ft.T  # [B, nsamp, nd]
    x = torch.cholesky_solve(y.transpose(1, 2), L)  # [B, nd, nsamp]
    S_hat = x.var(dim=-1, correction=0)
    if complex_timedomain:
        S_hat = S_hat[:, ::2] + S_hat[:, 1::2]
    return S_hat * x.shape[-1] / chi2, info


def _seeds(seeds, n: int) -> list[int]:
    if seeds is None:
        return [int(np.random.SeedSequence([0, i]).generate_state(1, np.uint64)[0]) for i in range(n)]
    if len(seeds) != n:
        raise ValueError(f"{len(seeds)} seeds for {n} baselines")
    return [int(s) for s in seeds]


def gibbs_inputs(data, N, Ni, window, fsel, complex_timedomain, device=None):
    """The batched chain's shared inputs: (data tensor, Ft [nd, 2F], taper
    [2F] or None, Nih [nbase, 2F]) in the data's real type on its device."""
    d = as_tensor(data, device)
    rdt = d.real.dtype
    F, taper, fsel = _design(N, fsel, window, complex_timedomain)
    Ft = torch.as_tensor(F.T.copy(), dtype=rdt, device=d.device)
    taper_t = None if taper is None else torch.as_tensor(taper, dtype=rdt, device=d.device)
    Ni_r = _alternating_noise_inverse(as_tensor(Ni, d.device).double().cpu().numpy(), fsel, N, complex_timedomain)
    return d, Ft, taper_t, torch.as_tensor(np.sqrt(Ni_r), dtype=rdt, device=d.device)


def gibbs_batch_design(d, Ft, taper, Nih):
    """Whitened data [B, nsamp, 2F] and normal matrices ``FTNiF`` [B, nd, nd]
    of a batch: d [B, nsamp, nfreq] complex, Nih [B, 2F]."""
    da = torch.view_as_real(d).flatten(-2).to(Ft.dtype)  # re/im interleaved along the channel axis
    if taper is not None:
        da = da * taper
    return da * Nih[:, None, :], (Ft[None] * (Nih**2)[:, None, :]) @ Ft.T


def delay_power_spectrum_gibbs_batched(
    data,
    N,
    Ni,
    initial_S,
    window="nuttall",
    fsel=None,
    niter=20,
    seeds=None,
    complex_timedomain=False,
    batch: int = GIBBS_BATCH,
    device=None,
):
    """Gibbs chains of many baselines on their device (the delay basis of
    :func:`delay_power_spectrum_gibbs`; reference delay.py:905-931 loops
    baselines on the host).

    Parameters
    ----------
    data : tensor [nbase, nsample, nfreq] complex (host data goes to ``device``)
    N : int
        Number of delays.
    Ni : [nbase, nfreq] inverse noise variance per baseline.
    initial_S : [nbase, nS] initial spectra.
    window, fsel, complex_timedomain
        As in the per-baseline estimator.
    niter : int
        Number of Gibbs iterations.
    seeds : list of nbase ints
        Each baseline's seed (by default from ``SeedSequence([0, i])``).
    batch : int
        Baselines in every device call (the tail is padded); the device
        holds one batch's design products at a time.

    Returns
    -------
    samples : tensor [niter, nbase, nS] in the data's real type
    failed : bool tensor [nbase], a Cholesky factorisation of the chain failed
    """
    d, Ft, taper, Nih_all = gibbs_inputs(data, N, Ni, window, fsel, complex_timedomain, device)
    dev, rdt = d.device, Ft.dtype
    nbase, nsamp = d.shape[0], d.shape[1]
    nd, nrow = Ft.shape
    seeds = _seeds(seeds, nbase)
    S0 = as_tensor(initial_S, dev).to(rdt)
    half_df = torch.full((N,), nsamp / 2.0, dtype=rdt, device=dev)

    samples = torch.empty((niter, nbase, N), dtype=rdt, device=dev)
    failed = torch.zeros(nbase, dtype=torch.bool, device=dev)
    for b0 in range(0, nbase, batch):
        n_in = min(batch, nbase - b0)
        # padded chains: zero data, unit noise and spectra keep their systems well posed; their output is dropped
        idx = torch.as_tensor(list(range(b0, b0 + n_in)) + [b0] * (batch - n_in), device=dev)
        db, Nih, S = d.index_select(0, idx), Nih_all.index_select(0, idx), S0.index_select(0, idx)
        db[n_in:], Nih[n_in:], S[n_in:] = 0.0, 1.0, 1.0
        dw, FTNiF = gibbs_batch_design(db, Ft, taper, Nih)
        gens = [torch.Generator(device=dev).manual_seed(x) for x in seeds[b0 : b0 + n_in] + [0] * (batch - n_in)]
        for it in range(niter):
            w1 = torch.empty((batch, nsamp, nd), dtype=rdt, device=dev)
            w2 = torch.empty((batch, nsamp, nrow), dtype=rdt, device=dev)
            chi2 = torch.empty((batch, N), dtype=rdt, device=dev)
            for k, gk in enumerate(gens):
                w1[k].normal_(generator=gk)
                w2[k].normal_(generator=gk)
                chi2[k] = 2.0 * torch._standard_gamma(half_df, generator=gk)
            S, info = gibbs_step(FTNiF, Ft, Nih, dw, S, w1, w2, chi2, complex_timedomain)
            samples[it, b0 : b0 + n_in] = S[:n_in]
            failed[b0 : b0 + n_in] |= info[:n_in] != 0
        del dw, FTNiF
    return samples, failed


def delay_spectrum_gibbs_cross_batched(
    data,
    N,
    Ni,
    initial_S,
    window="nuttall",
    fsel=None,
    niter=20,
    seeds=None,
    bchunk: int = CROSS_BATCH,
    device=None,
):
    """Cross-spectrum Gibbs chains of many baselines on their device.

    The batched form of :func:`delay_spectrum_gibbs_cross` (reference
    delay.py:1907-2099 loops baselines on the host): the coupled
    ``nd N`` joint signal draw as a batched complex Cholesky and solve over
    ``bchunk`` baselines (the tail padded with identity priors), and the
    per-delay inverse-Wishart draw of :func:`.random.complex_wishart`.

    Parameters
    ----------
    data : tensor [nbase, nd, nsample, nfreq] complex (host data goes to ``device``)
    N : int
        Number of delays.
    Ni : [nbase, nd, nfreq] inverse noise variance.
    initial_S : [nbase, nd, nd, ndelay]
    window, fsel, niter
        As in the host estimator.
    seeds : list of nbase ints
        Each baseline's seed (by default from ``SeedSequence([0, i])``).
    bchunk : int
        Baselines in every device call (bounds the [bchunk, nd N, nd N]
        factorisation).

    Returns
    -------
    samples : complex tensor [niter, nbase, nd, nd, ndelay] in the data's type
    failed : bool tensor [nbase], a factorisation of the chain failed

    Notes
    -----
    The coupled system's condition number is about ``1 + S nfreq Ni``:
    past ~1e7 a complex64 Cholesky breaks down.  The task re-samples such
    chains in complex128 on the same device.
    """
    d = as_tensor(data, device)
    dev, cdt = d.device, d.dtype
    nbase, nd, nsamp, Nf = d.shape
    seeds = _seeds(seeds, nbase)
    bchunk = min(bchunk, nbase)
    if fsel is None:
        fsel = np.arange(Nf)
    else:
        fsel = np.asarray(fsel)
        if len(fsel) != Nf:
            raise ValueError(
                f"The frequency selection does not cover the data channels: {len(fsel)} selected vs {Nf} present"
            )

    F = fourier_matrix(N, fsel)  # [F, N]
    taper = None
    if window is not None:
        taper = tools.window_generalised(fsel * 1.0 / N, window=window).numpy()
        F = F * taper[:, np.newaxis]
    Ft = torch.as_tensor(F.T.copy(), dtype=cdt, device=dev)  # [N, F]
    taper_t = None if taper is None else torch.as_tensor(taper, dtype=d.real.dtype, device=dev)
    Nih_all = as_tensor(Ni, dev).to(d.real.dtype).sqrt()  # [b, nd, F]
    S_all = as_tensor(initial_S, dev).to(cdt)
    ar = torch.arange(N, device=dev)
    eye = torch.eye(nd, dtype=cdt, device=dev)

    samples = torch.empty((niter, nbase, nd, nd, N), dtype=cdt, device=dev)
    failed = torch.zeros(nbase, dtype=torch.bool, device=dev)
    for b0 in range(0, nbase, bchunk):
        n_in = min(bchunk, nbase - b0)
        idx = torch.as_tensor(list(range(b0, b0 + n_in)) + [b0] * (bchunk - n_in), device=dev)
        gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds[b0 : b0 + n_in] + [0] * (bchunk - n_in)]
        dc = d.index_select(0, idx).transpose(-1, -2)  # [B, nd, F, nsamp]
        if taper_t is not None:
            dc = dc * taper_t[None, None, :, None]
        Nih = Nih_all.index_select(0, idx)
        S = S_all.index_select(0, idx)
        if n_in < bchunk:
            # padded chains: identity prior, zero data (an all-zero S is singular); their output is dropped
            dc[n_in:] = 0.0
            Nih[n_in:] = 1.0
            S[n_in:] = eye[None, :, :, None]
        FTNih = Ft[None, None] * Nih[:, :, None, :]  # [B, nd, N, F]
        dc = dc * Nih[..., None]
        # the noise-weighted design blocks are chain-invariant: block-diagonal [nd N, nd N]
        G = FTNih @ FTNih.conj().transpose(-1, -2)
        Ci0 = torch.zeros((bchunk, nd * N, nd * N), dtype=cdt, device=dev)
        for ii in range(nd):
            Ci0[:, ii * N : (ii + 1) * N, ii * N : (ii + 1) * N] = G[:, ii]
        del G
        for it in range(niter):
            Smat = S.movedim(-1, 1)  # [B, N, nd, nd]
            Si = torch.linalg.inv_ex(Smat)[0]
            L, info_s = torch.linalg.cholesky_ex(Smat)
            Ci = Ci0.clone()
            for ii in range(nd):
                for jj in range(nd):
                    Ci[:, ii * N + ar, jj * N + ar] += Si[:, :, ii, jj]
            w1 = torch.empty((bchunk, N, nd, nsamp), dtype=cdt, device=dev)
            w2 = torch.empty_like(dc)
            for k, gk in enumerate(gens):
                w1[k] = drandom.standard_complex_normal((N, nd, nsamp), dtype=cdt, generator=gk)
                w2[k] = drandom.standard_complex_normal(dc.shape[1:], dtype=cdt, generator=gk)
            y = FTNih @ (dc + w2)  # [B, nd, N, ns]
            # x = L^-H w1 has covariance S^-1 (the perturbation term)
            w1s = torch.linalg.solve_triangular(L.conj().transpose(-1, -2), w1, upper=True)
            y = y + w1s.movedim(1, 2)
            Lc, info_c = torch.linalg.cholesky_ex(Ci)
            del Ci
            x = torch.cholesky_solve(y.reshape(bchunk, nd * N, nsamp), Lc).reshape(bchunk, nd, N, nsamp)
            del Lc
            # per-delay sample covariance (biased, np.cov with bias=True in the host estimator)
            X = x.movedim(2, 1)  # [B, N, nd, ns]
            Xc = X - X.mean(dim=-1, keepdim=True)
            Scov = (Xc @ Xc.conj().transpose(-1, -2)) / nsamp
            Wi = torch.empty_like(Scov)
            scatter, info_w = torch.linalg.inv_ex(Scov)
            bad = (info_s != 0).any(-1) | (info_c != 0) | (info_w != 0).any(-1)
            for k, gk in enumerate(gens):
                Wi[k] = _wishart_or_nan(scatter[k], nsamp, gk)
            S = torch.linalg.inv_ex(Wi / nsamp)[0].movedim(1, -1)
            samples[it, b0 : b0 + n_in] = S[:n_in]
            failed[b0 : b0 + n_in] |= bad[:n_in]
    failed |= ~torch.isfinite(torch.view_as_real(samples)).flatten(2).all(-1).all(0)
    return samples, failed


def _wishart_or_nan(C, n, generator):
    """:func:`.random.complex_wishart` of ``C`` [N, nd, nd], or NaNs where ``C`` is
    not positive definite (a failed chain), drawn with ``generator``."""
    try:
        return drandom.complex_wishart(C, n, generator=generator)
    except torch.linalg.LinAlgError:
        return torch.full_like(C, float("nan"))


def delay_spectrum_gibbs_cross(data, N, Ni, initial_S, window="nuttall", fsel=None, niter=20, rng=None):
    """Gibbs sampling of the delay *cross*-power spectrum of one baseline.  Host numpy.

    (reference delay.py:1907-2099): multi-dataset joint signal draw with a
    per-delay inverse-Wishart power spectrum draw.
    """
    import scipy.linalg as la

    if rng is None:
        rng = np.random.default_rng()

    nd, nsamp, nchan = data.shape
    if nd == 0:
        raise ValueError("At least one dataset is required")
    if fsel is None:
        fsel = np.arange(nchan)
    elif len(fsel) != nchan:
        raise ValueError(
            f"The frequency selection does not cover the data channels: "
            f"{len(fsel)} selected vs {data.shape[-1]} present"
        )

    F = fourier_matrix(N, fsel)
    rows = data.transpose(0, 2, 1)
    if window is not None:
        taper = tools.window_generalised(fsel * 1.0 / N, window=window).numpy()
        F = F * taper[:, np.newaxis]
        rows = rows * taper[:, np.newaxis]

    # block-diagonal design products, one block per dataset
    FTNih = F.T[np.newaxis, :, :] * Ni[:, np.newaxis, :] ** 0.5
    FTNiF = np.zeros((nd, N, nd, N), dtype=np.complex128)
    for di in range(nd):
        FTNiF[di, :, di] = FTNih[di] @ FTNih[di].T.conj()
    rows = rows * Ni[:, :, np.newaxis] ** 0.5

    def _joint_signal_draw(S):
        # perturbed-Wiener draw over the coupled (dataset x delay) system
        Si = np.empty_like(S)
        Sh = np.empty((N, nd, nd), dtype=S.dtype)
        for di in range(N):
            Si[:, :, di] = la.inv(S[:, :, di])
            Sh[di] = la.cholesky(S[:, :, di], lower=False)
        coupled = FTNiF.copy()
        for a in range(nd):
            for b in range(nd):
                coupled[a, :, b] += np.diag(Si[a, b])
        eps_s = drandom.complex_normal_np(size=(N, nd, nsamp), rng=rng)
        eps_n = drandom.complex_normal_np(size=rows.shape, rng=rng)
        y = FTNih @ (rows + eps_n)
        for di in range(N):
            y[:, di] += la.solve_triangular(Sh[di], eps_s[di], overwrite_b=True, lower=False, check_finite=False)
        factor = la.cho_factor(coupled.reshape(nd * N, nd * N), overwrite_a=True, check_finite=False)
        flat = la.cho_solve(factor, y.reshape(nd * N, nsamp), overwrite_b=True, check_finite=False)
        return flat.reshape(nd, N, nsamp)

    def _wishart_ps_draw(d):
        # per-delay inverse-Wishart draw about the realised covariance
        S = np.empty((nd, nd, N), dtype=np.complex128)
        for di in range(N):
            S[:, :, di] = np.cov(d[:, di], bias=True)
        for di in range(N):
            scatter = la.inv(S[:, :, di])
            draw = drandom.complex_wishart_np(scatter, nsamp, rng=rng)
            S[:, :, di] = la.inv(draw / nsamp)
        return S

    draws = []
    S_samp = initial_S
    try:
        for _ in range(niter):
            d_samp = _joint_signal_draw(S_samp)
            S_samp = _wishart_ps_draw(d_samp)
            draws.append(S_samp)
    except la.LinAlgError as e:
        raise RuntimeError("Stopping the chain early: singular system") from e
    return draws


# ---------------------------------------------------------------------------
# Array manipulation helpers (reference delay.py:2209-2324); numpy arrays or tensors
# ---------------------------------------------------------------------------


def _moveaxis(arr, src, dst):
    return torch.movedim(arr, src, dst) if isinstance(arr, torch.Tensor) else np.moveaxis(arr, src, dst)


def match_axes(dset1, dset2):
    """dset2's array, broadcastable against dset1 (reference delay.py:2209)."""
    have = set(tuple(dset2.attrs["axis"]))
    expand = tuple(slice(None) if ax in have else None for ax in dset1.attrs["axis"])
    arr = dset2[:]
    return (arr if isinstance(arr, torch.Tensor) else np.asarray(arr))[expand]


def flatten_axes(dset, axes_to_keep, match_dset=None):
    """Move named axes to the back and flatten the rest (reference delay.py:2238-2302).

    Returns (array, flattened axis names); a tensor dataset gives a tensor on its device.
    """
    names = list(dset.attrs["axis"])
    missing = [ax for ax in axes_to_keep if ax not in names]
    if missing:
        raise ValueError(f"No axis called {missing[0]} in this dataset.")

    arr = dset[:]
    if match_dset is not None and tuple(names) != tuple(match_dset.attrs["axis"]):
        # broadcast up to the reference dataset's full layout first
        arr = match_axes(match_dset, dset)
        if isinstance(arr, torch.Tensor):
            arr = arr.expand(match_dset.shape)
        else:
            arr = np.broadcast_to(arr, match_dset.shape)
        names = list(match_dset.attrs["axis"])

    back = [names.index(ax) for ax in axes_to_keep]
    front = [i for i in range(len(names)) if i not in back]
    if isinstance(arr, torch.Tensor):
        arr = arr.permute(front + back).reshape((-1,) + tuple(arr.shape[i] for i in back))
    else:
        arr = np.asarray(arr).transpose(front + back)
        arr = arr.reshape((-1,) + arr.shape[len(front) :])
    return arr, [names[i] for i in front]


def _move_front(arr, axis, shape: tuple):
    """Move axis (or axes) to the front and flatten to 2D (delay.py:2305)."""
    if not isinstance(axis, tuple):
        return _moveaxis(arr, axis, 0).reshape(shape[axis], -1)
    lead = int(np.prod([shape[a] for a in axis]))
    return _moveaxis(arr, axis, tuple(range(len(axis)))).reshape(lead, -1)


def _inv_move_front(arr, axis, shape: tuple):
    """Inverse of :func:`_move_front` (delay.py:2311)."""
    shape = tuple(shape)
    if not isinstance(axis, tuple):
        interim = (shape[axis], *shape[:axis], *shape[axis + 1 :])
        return _moveaxis(arr.reshape(interim), 0, axis).reshape(shape)
    lead = tuple(shape[a] for a in axis)
    norm = {a % len(shape) for a in axis}
    rest = tuple(s for i, s in enumerate(shape) if i not in norm)
    stacked = arr.reshape((*lead, *rest))
    return _moveaxis(stacked, tuple(range(len(axis))), axis).reshape(shape)


def _take_view(arr, ind: int, axis: int):
    sl = (slice(None),) * axis
    return arr[(*sl, ind)]
