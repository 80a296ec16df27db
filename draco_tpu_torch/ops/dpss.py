"""DPSS (Slepian-sequence) inpainting primitives.

Port of ``draco_tpu.ops.dpss`` (reference ``draco/util/dpss.py``:
make_covariance:9, get_basis:67, project:121, solve:154,
accumulate_variance:254, flag_above_cutoff:307, filter:359, inpaint:407).

* The covariance and its eigendecomposition run in float64 on the device
  (the JAX package takes both to host numpy): a basis of 4096 samples is a
  4096 x 4096 ``eigh``.
* The JAX package solves every row on its own (a ``vmap`` of one Gram
  matrix, Cholesky factor and variance diagonal per row).  Rows that share
  their inverse-variance weights share all three, so here each unique
  weight row is factorised once (batched ``cholesky_ex``), and the rows
  that use it are solved together as the right-hand sides of one
  ``cholesky_solve``.  The variance diagonal never forms the [nsamp, nsamp]
  operator: with ``K = A^H diag(Ni) A`` and ``Ci = K + Si I`` it is
  ``einsum("sk,kl,sl->s", A, Ci^-1 K Ci^-H, conj(A))``.
* A weight row whose factorisation fails (``cholesky_ex``'s ``info``; the
  JAX package returns NaN there) gives its rows zero data and zero weight,
  and :func:`solve_batched` reports how many rows that was.
* ``accumulate_variance``'s PCHIP interpolation (scipy's, a Python loop
  over rows in the JAX package) runs for every row at once on the device,
  with scipy's slopes, end conditions and extrapolation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor, resolve
from .tools import invert_no_zero

__all__ = [
    "make_covariance",
    "get_basis",
    "get_bases",
    "project",
    "solve_batched",
    "filter_batched",
    "inpaint_batched",
    "accumulate_variance",
    "flag_above_cutoff",
    "atleast_Nd",
    "solve",
    "filter",
    "inpaint",
    "pchip_rows",
]

# bytes of one chunk of Gram matrices and Cholesky factors
SOLVE_CHUNK_BYTES = 1 << 30
# a weight row used by at least this many data rows is solved with them as the
# right-hand sides of one call; rarer ones are solved a row at a time, batched
SHARED_ROWS = 16


def _real_of(dtype: torch.dtype) -> torch.dtype:
    return {torch.complex64: torch.float32, torch.complex128: torch.float64}.get(dtype, dtype)


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    return {torch.float32: torch.complex64, torch.float64: torch.complex128}.get(dtype, dtype)


# ---------------------------------------------------------------------------
# Basis construction (float64 on the device)
# ---------------------------------------------------------------------------


def make_covariance(samples, halfwidths, centres, device=None) -> torch.Tensor:
    """Signal covariance: sum of Fourier-space top-hats (reference dpss.py:9).

    ``cov[i, j] = sum_k exp(-2 pi i c_k (s_i - s_j)) sinc(2 w_k (s_i - s_j))``,
    in complex128 on ``device`` (:func:`resolve`); float64 when its imaginary
    part is exactly zero (every centre zero).
    """
    if np.isscalar(halfwidths):
        halfwidths = [halfwidths]
    if np.isscalar(centres):
        centres = [centres]
    if len(centres) != len(halfwidths):
        raise ValueError(f"One centre is needed per halfwidth. halfwidths={halfwidths} vs centres={centres}")

    s = torch.as_tensor(np.asarray(samples, dtype=np.float64), device=resolve(device))
    ds = s[:, None] - s[None, :]
    cov = torch.zeros(ds.shape, dtype=torch.complex128, device=s.device)
    for ct, hw in zip(centres, halfwidths):
        cov += torch.polar(torch.ones_like(ds), -2.0 * np.pi * float(ct) * ds) * torch.sinc(2.0 * float(hw) * ds)
    if not bool((cov.imag != 0).any()):
        cov = cov.real.contiguous()
    return cov


def get_basis(cov, threshold: float = 1e-12, dtype=np.float32) -> torch.Tensor:
    """Slepian basis: eigenvectors above ``threshold * max(eval)`` (reference dpss.py:67-118).

    The ``eigh`` runs in float64 (complex128) on ``cov``'s device; the
    basis comes back in ``dtype``'s precision (complex when ``cov`` is), in
    decreasing eigenvalue order.
    """
    return get_bases([cov], threshold, dtype)[0]


def get_bases(covs, threshold: float = 1e-12, dtype=np.float32) -> list:
    """:func:`get_basis` of each covariance of ``covs`` (same shape), their ``eigh`` calls batched."""
    covs = [as_tensor(c) for c in covs]
    if not covs:
        return []
    wide = torch.complex128 if any(c.is_complex() for c in covs) else torch.float64
    n = covs[0].shape[-1]
    step = max(1, SOLVE_CHUNK_BYTES // (n * n * 16))
    real_out = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}[
        np.dtype(np.dtype(dtype).type(0).real.dtype)]
    out = []
    for i0 in range(0, len(covs), step):
        evals, evecs = torch.linalg.eigh(torch.stack([c.to(wide) for c in covs[i0 : i0 + step]]))
        evals, evecs = evals.flip(-1), evecs.flip(-1)
        for k in range(evals.shape[0]):
            nmodes = int((evals[k] > threshold * evals[k].max()).sum())
            A = evecs[k, :, :nmodes]
            out.append(A.to(_complex_of(real_out) if A.is_complex() else real_out).contiguous())
        del evals, evecs
    return out


# ---------------------------------------------------------------------------
# Batched Wiener solve (device)
# ---------------------------------------------------------------------------


def project(x, Ni, A):
    """Noise-weighted projection into the basis: ``A^H (Ni * x)`` (reference dpss.py:121-151).

    ``x, Ni`` have samples on the LAST axis; ``A`` is ``[nsamp, nmodes]``.
    """
    x = as_tensor(x)
    A = as_tensor(A, x.device)
    Ni = as_tensor(Ni, x.device)
    dt = torch.promote_types(A.dtype, x.dtype)
    return torch.einsum("sm,...s->...m", A.conj().to(dt), (Ni * x).to(dt))


def _factor(Nu: torch.Tensor, A: torch.Tensor, Si: float):
    """Gram matrices, Cholesky factors and variance weights of unique weight rows ``Nu`` [u, s].

    Returns (L [u, m, m] lower, ok [u] bool (factor succeeded), winp [u, s]).
    """
    cdt = A.dtype
    m = A.shape[1]
    AH = A.conj().T
    K = (AH[None] * Nu.to(cdt)[:, None, :]) @ A  # [u, m, m]
    Ci = K + Si * torch.eye(m, dtype=cdt, device=A.device)
    L, info = torch.linalg.cholesky_ex(Ci)
    ok = info == 0
    L = torch.where(ok[:, None, None], L, torch.eye(m, dtype=cdt, device=A.device))
    CiK = torch.cholesky_solve(K, L)  # Ci^-1 K
    C = torch.cholesky_solve(CiK.conj().transpose(-1, -2), L).conj().transpose(-1, -2)  # Ci^-1 K Ci^-H
    var = torch.einsum("sk,ukl,sl->us", A, C, A.conj()).real
    winp = invert_no_zero(var)
    return L, ok, winp


def _solve_rows(xp: torch.Tensor, Ni: torch.Tensor, A: torch.Tensor, Si: float):
    """Solve rows given their projections ``xp`` [r, m] and weights ``Ni`` [r, s].

    Returns (xfilt [r, s], winp [r, s], number of rows whose factor failed).
    """
    dev = A.device
    r, s = Ni.shape
    m = A.shape[1]
    xfilt = torch.zeros((r, s), dtype=A.dtype, device=dev)
    winp = torch.zeros((r, s), dtype=_real_of(A.dtype), device=dev)
    uk, inv = torch.unique(Ni, dim=0, return_inverse=True)
    counts = torch.bincount(inv, minlength=uk.shape[0])
    order = torch.argsort(inv, stable=True)
    start = torch.cumsum(counts, 0) - counts
    counts_h, start_h = counts.tolist(), start.tolist()
    nfail = 0
    step = max(1, SOLVE_CHUNK_BYTES // (4 * m * m * A.element_size() + 1))
    for u0 in range(0, uk.shape[0], step):
        u1 = min(u0 + step, uk.shape[0])
        L, ok, wu = _factor(uk[u0:u1], A, Si)
        live = uk[u0:u1].gt(0).any(dim=1) & ok
        nfail += int(sum(counts_h[u0 + k] for k in torch.nonzero(~ok).squeeze(1).tolist()))
        rows = order[start_h[u0] : start_h[u1 - 1] + counts_h[u1 - 1]]
        loc = inv[rows] - u0
        keep = live[loc]
        winp[rows] = torch.where(keep[:, None], wu[loc], torch.zeros((), dtype=winp.dtype, device=dev))
        # shared weight rows: one multi-RHS solve each
        small = []
        for k in range(u1 - u0):
            c = counts_h[u0 + k]
            if c >= SHARED_ROWS:
                rk = order[start_h[u0 + k] : start_h[u0 + k] + c]
                if bool(live[k]):
                    b = torch.cholesky_solve(xp[rk].T, L[k])
                    xfilt[rk] = (A @ b).T
            elif c:
                small.append(order[start_h[u0 + k] : start_h[u0 + k] + c])
        if small:
            rs = torch.cat(small)
            for i0 in range(0, rs.numel(), step):
                rb = rs[i0 : i0 + step]
                lb = inv[rb] - u0
                b = torch.cholesky_solve(xp[rb][:, :, None], L[lb])[:, :, 0]
                xfilt[rb] = torch.where(live[lb][:, None], b @ A.T, torch.zeros((), dtype=A.dtype, device=dev))
        del L, wu
    return xfilt, winp, nfail


def solve_batched(x, Ni, A, Si: float = 1e-3, return_failed: bool = False):
    """Apply the inpainting operator to a batch of rows (reference dpss.py:154-251).

    Parameters
    ----------
    x : [..., nsamp] data (real or complex)
    Ni : [..., nsamp] inverse-variance weights (0 = flagged)
    A : [nsamp, nmodes] basis from :func:`get_basis`
    Si : scalar regulariser (expected inverse signal variance)

    Returns
    -------
    xfilt, winp : same shape as ``x`` / ``Ni`` (and, with ``return_failed``,
        the number of rows whose factorisation failed: zero data and weight).
    """
    x = as_tensor(x)
    dev = x.device
    A = as_tensor(A, dev)
    Ni = as_tensor(Ni, dev)
    if x.is_complex() and not A.is_complex():
        A = A.to(torch.promote_types(_complex_of(A.dtype), x.dtype))
    shape = x.shape
    n = shape[-1]
    Ni2 = Ni.broadcast_to(shape).reshape(-1, n)
    xp = (Ni2.to(A.dtype) * x.reshape(-1, n).to(A.dtype)) @ A.conj()  # [r, m]
    xf, wf, nfail = _solve_rows(xp, Ni2, A, Si)
    out = (xf.reshape(shape), wf.reshape(shape))
    return (*out, nfail) if return_failed else out


def filter_batched(x, Ni, A, W, Si: float = 1e-3):
    """DPSS-filter rows: mean-subtract, solve, re-add (reference dpss.py:359).

    The variance accumulation step (interpolating the original weights over
    the gaps) is separate: apply :func:`accumulate_variance` to the
    returned weights.
    """
    x = as_tensor(x)
    W = as_tensor(W, x.device)
    Wf = W.to(_real_of(x.dtype))
    nvalid = Wf.sum(dim=-1, keepdim=True)
    xhat = (x * Wf).sum(dim=-1, keepdim=True) * invert_no_zero(nvalid)
    xfilt, wfilt = solve_batched(x - xhat, Ni, A, Si)
    return xfilt + xhat, wfilt


def inpaint_batched(x, Ni, A, W, Si: float = 1e-3):
    """Inpaint rows: filtered values only where flagged (reference dpss.py:407).

    Samples where ``W`` is True keep the input data and weights.
    """
    x = as_tensor(x)
    Ni = as_tensor(Ni, x.device)
    W = as_tensor(W, x.device).to(torch.bool)
    xf, wf = filter_batched(x, Ni, A, W, Si)
    return torch.where(W, x.to(xf.dtype), xf), torch.where(W, Ni.to(wf.dtype), wf)


# ---------------------------------------------------------------------------
# Weight post-processing (device)
# ---------------------------------------------------------------------------


def _prev_next(W: torch.Tensor):
    """Index of the valid sample at or before / at or after each sample (-1 / n where none)."""
    n = W.shape[-1]
    idx = torch.arange(n, device=W.device).expand_as(W)
    pv = torch.cummax(torch.where(W, idx, torch.full_like(idx, -1)), dim=-1).values
    nv = torch.cummin(torch.where(W, idx, torch.full_like(idx, n)).flip(-1), dim=-1).values.flip(-1)
    return pv, nv


def _edge_case(h0, h1, m0, m1):
    """scipy's one-sided three-point end slope (``PchipInterpolator._edge_case``)."""
    d = ((2 * h0 + h1) * m0 - h0 * m1) / (h0 + h1)
    mask = torch.sign(d) != torch.sign(m0)
    mask2 = (torch.sign(m0) != torch.sign(m1)) & (d.abs() > 3.0 * m0.abs())
    d = torch.where(mask, torch.zeros_like(d), d)
    return torch.where(~mask & mask2, 3.0 * m0, d)


def pchip_rows(y: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """scipy's ``PchipInterpolator(x[W], y[W], extrapolate=True)(x)`` for every row at once.

    ``y`` [r, n] float64 at samples ``x = arange(n)``; ``W`` [r, n] bool
    marks the knots.  Rows with fewer than two knots give NaN.
    """
    r, n = y.shape
    dev = y.device
    W = W.to(torch.bool)
    pv, nv = _prev_next(W)
    nk = W.sum(dim=-1)
    first = nv[:, 0].clamp(max=n - 1)
    last = pv[:, -1].clamp(min=0)

    # neighbouring knots of every knot j: p(j) strictly before, q(j) strictly after
    sentinel_lo = torch.full((r, 1), -1, dtype=pv.dtype, device=dev)
    sentinel_hi = torch.full((r, 1), n, dtype=nv.dtype, device=dev)
    p = torch.cat([sentinel_lo, pv[:, :-1]], dim=1)
    q = torch.cat([nv[:, 1:], sentinel_hi], dim=1)
    idx = torch.arange(n, device=dev, dtype=torch.float64).expand(r, n)

    def take(t, i):
        return torch.gather(t, 1, i.clamp(0, n - 1))

    yp, yq = take(y, p), take(y, q)
    hL = idx - p.to(torch.float64)
    hR = q.to(torch.float64) - idx
    mL = (y - yp) / hL
    mR = (yq - y) / hR

    # interior slopes (scipy's weighted harmonic mean)
    cond = (torch.sign(mR) != torch.sign(mL)) | (mR == 0) | (mL == 0)
    w1 = 2 * hR + hL
    w2 = hR + 2 * hL
    whmean = (w1 / mL + w2 / mR) / (w1 + w2)
    d = torch.where(cond, torch.zeros_like(y), 1.0 / whmean)

    # end knots
    f, lst = first[:, None], last[:, None]
    qf = take(q, f)
    d_first = _edge_case(take(hR, f), take(hR, qf), take(mR, f), take(mR, qf))
    pl = take(p, lst)
    d_last = _edge_case(take(hL, lst), take(hL, pl), take(mL, lst), take(mL, pl))
    two = (nk == 2)[:, None]
    d_first = torch.where(two, take(mR, f), d_first)
    d_last = torch.where(two, take(mL, lst), d_last)
    d = d.scatter(1, f, d_first).scatter(1, lst, d_last)

    # evaluation: the interval's left knot a (scipy's find_interval with extrapolation)
    a = torch.where(pv < 0, f.expand(r, n), pv)
    a = torch.where(a >= lst, take(p, lst).expand(r, n), a)
    b = take(q, a)
    ya, yb, da, db = take(y, a), take(y, b), take(d, a), take(d, b)
    h = (b - a).to(torch.float64)
    slope = (yb - ya) / h
    t = (da + db - 2 * slope) / h
    c0 = t / h
    c1 = (slope - da) / h - t
    s = idx - a.to(torch.float64)
    val = ya + s * (da + s * (c1 + s * c0))
    return torch.where((nk >= 2)[:, None], val, torch.full_like(val, float("nan")))


def accumulate_variance(wo, wi, W) -> torch.Tensor:
    """PCHIP-interpolate original variances over gaps and accumulate (reference dpss.py:254-304).

    Samples are on the LAST axis.  ``wo`` are the original inverse-variance
    weights, ``wi`` the inpainted weights from :func:`solve_batched`, ``W``
    the keep-mask.  Rows with fewer than two kept samples are left as
    ``wi``.  Runs on ``wi``'s device (host data: :func:`resolve`).
    """
    wi = as_tensor(wi)
    dev = wi.device
    wo = as_tensor(wo, dev)
    W = as_tensor(W, dev).to(torch.bool)
    vo = invert_no_zero(wo)
    vi = invert_no_zero(wi).clone()
    n = vo.shape[-1]
    vo2 = vo.broadcast_to(vi.shape).reshape(-1, n)
    vi2 = vi.reshape(-1, n)
    W2 = W.broadcast_to(vi.shape).reshape(-1, n)
    step = max(1, (1 << 26) // n)
    for r0 in range(0, vi2.shape[0], step):
        wk = W2[r0 : r0 + step]
        ok = wk.sum(dim=-1) >= 2
        wint = pchip_rows(vo2[r0 : r0 + step].to(torch.float64), wk).clamp(min=0)
        vi2[r0 : r0 + step] += torch.where(ok[:, None], wint, torch.zeros_like(wint)).to(vi2.dtype)
    return invert_no_zero(vi2.reshape(vi.shape))


# ---------------------------------------------------------------------------
# Reference-layout API (samples on the FIRST axis, matching reference
# dpss.py:121-489; the batched functions above take samples LAST)
# ---------------------------------------------------------------------------


def atleast_Nd(x, N: int, lax: int = -1):
    """Expand to at least N dims, new axes grouped after ``lax`` (reference dpss.py:446-489).

    Returns (expanded, inverse-indexer).
    """
    if x.ndim >= N:
        return x, (slice(None),) * x.ndim
    newdims = (None,) * (N - x.ndim)
    if lax == -1:
        lax = x.ndim
    slobj = (slice(None),) * max(x.ndim - lax, 0)
    return x[(..., *newdims, *slobj)], (..., *(0 for _ in newdims), *slobj)


def solve(xp, Ni, A, Si: float = 1e-3):
    """Apply the inpainting operator to projected data (reference dpss.py:154).

    ``xp`` is the reference-layout projection (modes on axis 0); ``Ni``
    has samples on axis 0.  Returns (xfilt, winp) with samples on axis 0.
    """
    xp = as_tensor(xp)
    dev = xp.device
    A = as_tensor(A, dev)
    Ni = as_tensor(Ni, dev)
    nsamp, nmodes = A.shape
    if xp.shape[0] != nmodes:
        raise ValueError(f"xp must have modes on axis 0 (expected {nmodes}, got shape {tuple(xp.shape)})")
    if Ni.shape[0] != nsamp:
        raise ValueError(f"Ni must have samples on axis 0 (expected {nsamp}, got shape {tuple(Ni.shape)})")
    xp2 = torch.movedim(xp, 0, -1)
    Ni2 = torch.movedim(Ni, 0, -1).broadcast_to(xp2.shape[:-1] + (nsamp,)).reshape(-1, nsamp)
    xf, wf, _ = _solve_rows(xp2.reshape(-1, nmodes).to(A.dtype), Ni2, A, Si)
    shape = xp2.shape[:-1] + (nsamp,)
    return torch.movedim(xf.reshape(shape), -1, 0), torch.movedim(wf.reshape(shape), -1, 0)


def filter(x, Ni, A, W, Si: float = 1e-3):  # noqa: A001 - reference name
    """Reference-layout DPSS filter (samples first; reference dpss.py:359).

    ``Ni``/``W`` expand with TRAILING axes (atleast_Nd) before
    broadcasting, so a 1-D Ni[nsamp] aligns with the sample axis of
    x[nsamp, nbatch].
    """
    x = as_tensor(x)
    Ni_b, _ = atleast_Nd(as_tensor(Ni, x.device), x.ndim)
    W_b, _ = atleast_Nd(as_tensor(W, x.device), x.ndim)
    x2 = torch.movedim(x, 0, -1)
    Ni2 = torch.movedim(Ni_b.broadcast_to(x.shape), 0, -1)
    W2 = torch.movedim(W_b.broadcast_to(x.shape), 0, -1)
    xf, wf = filter_batched(x2, Ni2, A, W2, Si)
    wf = accumulate_variance(Ni2, wf, W2)
    return torch.movedim(xf, -1, 0), torch.movedim(wf, -1, 0)


def inpaint(x, Ni, A, W, Si: float = 1e-3):
    """Reference-layout DPSS inpainting (reference dpss.py:407)."""
    xinp, winp = filter(x, Ni, A, W, Si)
    x = as_tensor(x, xinp.device).broadcast_to(xinp.shape)
    Ni_b, _ = atleast_Nd(as_tensor(Ni, xinp.device), winp.ndim)
    W_b, _ = atleast_Nd(as_tensor(W, xinp.device).to(torch.bool), xinp.ndim)
    Wb = W_b.broadcast_to(xinp.shape)
    return torch.where(Wb, x.to(xinp.dtype), xinp), torch.where(Wb, Ni_b.broadcast_to(winp.shape).to(winp.dtype), winp)


def flag_above_cutoff(W, fc=None):
    """Mask gaps wider than ``fc`` samples (reference dpss.py:307-356).

    Samples on the LAST axis.  The run widths come from two running-extrema
    passes (previous and next valid index of each sample); edge regions
    outside the first/last valid sample are always flagged.
    """
    if fc is None:
        return W
    W = as_tensor(W).to(torch.bool)
    n = W.shape[-1]
    pv, nv = _prev_next(W)
    dist = (nv - pv - 2).to(torch.float64)
    dist = torch.where(W, torch.zeros_like(dist), dist)
    dist = torch.where((pv < 0) | (nv >= n), torch.full_like(dist, 2.0 * fc), dist)
    return dist < fc
