"""Batched banded Hermitian linear algebra (port of draco_tpu.ops.banded).

The banded covariance build and the banded Cholesky solve of the Wiener
regridder.  Band storage is *lower* form: ``ab[..., d, j] = A[j+d, j]``
for d = 0..bw.  Every function is batched over leading axes; the
column recurrences of the factorisation and the two triangular solves
are Python loops over columns, each step one batched tensor update.

:func:`banded_covariance` here is the plain reference of the CUDA kernel
in :mod:`draco_tpu_torch.ops.cuda_kernels`.
"""

from __future__ import annotations

import torch

__all__ = [
    "banded_covariance",
    "banded_cholesky",
    "banded_cholesky_solve",
    "solveh_banded_lower",
]


def banded_covariance(R: torch.Tensor, Ni: torch.Tensor, bw: int) -> torch.Tensor:
    """Lower band of ``R diag(Ni) R^T``: ``C[..., d, j] = sum_t R[j+d,t] Ni[...,t] R[j,t]``.

    R [m, n]; Ni [..., n].  Returns [..., bw+1, m], exactly zero past the
    band end (j > m-1-d).  Each diagonal is one product
    ``(R[d:] * R[:m-d]) @ Ni^T``.
    """
    m = R.shape[0]
    lead = Ni.shape[:-1]
    Ni2 = Ni.reshape(-1, Ni.shape[-1])
    out = torch.zeros(Ni2.shape[0], bw + 1, m, dtype=R.dtype, device=R.device)
    for d in range(min(bw, m - 1) + 1):
        out[:, d, : m - d] = ((R[d:] * R[: m - d]) @ Ni2.T).T
    return out.reshape(*lead, bw + 1, m)


def banded_cholesky(ab: torch.Tensor, bw: int) -> torch.Tensor:
    """Cholesky factor L of banded HPD matrices, in the same lower band form,
    written into ``ab`` and returned.

    ab [..., bw+1, m].  Column j of ``ab`` is read only before column j of
    L is written, so the factor needs no copy of the band's size.  A
    non-positive pivot gives NaN in that column and the ones after it, so a
    singular band is detectable downstream.
    """
    m = ab.shape[-1]
    lead = ab.shape[:-2]
    dev = ab.device
    # picked[t-1, d] = L[j+d, j-t] = H[t-1, d+t] where d+t <= bw
    t_idx = torch.arange(1, bw + 1, device=dev)
    d_idx = torch.arange(bw + 1, device=dev)
    tot = d_idx[None, :] + t_idx[:, None]  # [bw, bw+1]
    gather = tot.clamp(max=bw).expand(*lead, bw, bw + 1)
    valid = (tot <= bw).to(ab.dtype)
    rows = torch.arange(bw, device=dev)

    L = ab
    H = torch.zeros(*lead, bw, bw + 1, dtype=ab.dtype, device=dev)
    nan = torch.tensor(float("nan"), dtype=ab.real.dtype, device=dev)
    for j in range(m):
        picked = torch.gather(H, -1, gather)
        mult = torch.conj(H[..., rows, rows + 1])[..., None]  # conj(L[j, j-t])
        s = (picked * valid * mult).sum(dim=-2)
        c = ab[..., j] - s
        c0 = c[..., 0].real
        diag = torch.sqrt(torch.where(c0 > 0, c0, nan)).to(ab.dtype)
        lcol = torch.cat([diag[..., None], c[..., 1:] / diag[..., None]], dim=-1)
        L[..., j] = lcol
        H = torch.cat([lcol[..., None, :], H[..., :-1, :]], dim=-2)
    return L


def _solve_lower(lb: torch.Tensor, b: torch.Tensor, bw: int) -> torch.Tensor:
    """Solve L y = b with L in lower band form [..., bw+1, m]; b [..., m]."""
    m = b.shape[-1]
    # row j couples y[j-t] through L[j, j-t] = lb[..., t, j-t], t = 1..min(j, bw),
    # which lies at offset j + t (m - 1) of the flattened band: a strided
    # view a row, where a shifted copy of L would double its memory
    flat = lb.reshape(*lb.shape[:-2], (bw + 1) * m)
    # broadcast_tensors, not broadcast_shapes: the latter's first call
    # imports torch's symbolic-shape machinery, seconds of host time
    shape = torch.broadcast_tensors(b, lb[..., 0, :])[0].shape
    y = torch.empty(shape, dtype=torch.result_type(b, lb), device=b.device)
    hist = torch.zeros(*y.shape[:-1], bw, dtype=y.dtype, device=b.device)
    for j in range(m):
        n = min(j, bw)
        coeffs = flat[..., j + m - 1 : j + n * (m - 1) + 1 : m - 1] if n else flat[..., :0]
        s = (coeffs * hist[..., :n]).sum(dim=-1)
        yj = (b[..., j] - s) / lb[..., 0, j]
        y[..., j] = yj
        hist = torch.cat([yj[..., None], hist[..., :-1]], dim=-1)
    return y


def _solve_upper(lb: torch.Tensor, y: torch.Tensor, bw: int) -> torch.Tensor:
    """Solve L^H x = y by backward substitution."""
    m = y.shape[-1]
    # row j couples x[j+t] through conj(L[j+t, j]) = conj(lb[..., t, j])
    coeffs = torch.conj(lb[..., 1:, :])  # [..., bw, m]
    x = torch.empty_like(y)
    hist = torch.zeros(*y.shape[:-1], bw, dtype=y.dtype, device=y.device)
    for j in range(m - 1, -1, -1):
        s = (coeffs[..., j] * hist).sum(dim=-1)
        xj = (y[..., j] - s) / torch.conj(lb[..., 0, j])
        x[..., j] = xj
        hist = torch.cat([xj[..., None], hist[..., :-1]], dim=-1)
    return x


def banded_cholesky_solve(lb: torch.Tensor, b: torch.Tensor, bw: int) -> torch.Tensor:
    """Solve A x = b given the banded Cholesky factor of A."""
    return _solve_upper(lb, _solve_lower(lb, b, bw), bw)


def solveh_banded_lower(ab: torch.Tensor, b: torch.Tensor, bw: int | None = None) -> torch.Tensor:
    """Solve the banded HPD systems A x = b.

    ab [..., bw+1, m] lower band form; b [..., m], broadcast against the
    leading axes of ``ab``.  The Cholesky factor replaces ``ab``.
    """
    if bw is None:
        bw = ab.shape[-2] - 1
    if bw == 0:
        d = ab[..., 0, :].real
        d = torch.where(d > 0, d, torch.full_like(d, float("nan")))
        return b / d.to(ab.dtype)
    lb = banded_cholesky(ab, bw)
    return banded_cholesky_solve(lb, b, bw)
