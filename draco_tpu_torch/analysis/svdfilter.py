"""Per-m SVD filtering of m-modes.

Port of ``draco_tpu.analysis.svdfilter`` (reference
``draco/analysis/svdfilter.py``: SVDSpectrumEstimator:11, SVDFilter:60,
svd_em:148): a global per-m SVD across (freq x msign*baseline) finds and
removes bright correlated modes, with EM infilling of masked entries.

Every m shares the [nfreq, 2*nstack] matrix shape, so the reference's
per-m host loop is one batched ``torch.linalg.svd`` over the leading m
axis on the m-modes' device, inside a Python loop over the EM iterations.
The matrices are complex64, the JAX package's device precision; the
functions follow the dtype of the matrices they are given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers
from ..core.task import ContainerTask
from ..device import as_tensor

__all__ = ["svd_em", "SVDSpectrumEstimator", "SVDFilter"]


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-batch median of the unmasked entries of real ``x`` [B, ...] (0 if
    none): numpy's ``nanmedian`` convention, the mean of the two middle
    values of an even count (``torch.nanmedian`` returns the lower one)."""
    B = x.shape[0]
    xs = torch.where(mask, torch.inf, x).reshape(B, -1).sort(dim=-1).values
    count = (~mask).reshape(B, -1).sum(dim=-1)
    lo = ((count - 1) // 2).clamp(min=0)[:, None]
    hi = (count // 2).clamp(max=xs.shape[-1] - 1)[:, None]
    med = 0.5 * (xs.gather(1, lo) + xs.gather(1, hi))[:, 0]
    return torch.where(count > 0, med, torch.zeros_like(med))


def _svd_em_batched(A: torch.Tensor, mask: torch.Tensor, *, niter: int, rank: int):
    """EM-infilled SVD of a batch of equally-shaped matrices.

    A : [B, n, p] (real or complex); mask : [B, n, p] bool (True = missing).
    Returns ``(u, sig, vh)`` of the final EM iterate, batched over B.
    """
    if A.is_complex():
        fill = torch.complex(_masked_median(A.real, mask), _masked_median(A.imag, mask))
    else:
        fill = _masked_median(A, mask)
    A = torch.where(mask, fill[:, None, None], A)
    for _ in range(max(niter, 1)):
        u, sig, vh = torch.linalg.svd(A, full_matrices=False)
        low_rank = (u[:, :, :rank] * sig[:, None, :rank].to(u.dtype)) @ vh[:, :rank]
        A = torch.where(mask, low_rank, A)
    return u, sig, vh


def svd_em(A, mask, niter: int = 5, rank: int = 5, full_matrices: bool = False, device=None):
    """SVD with missing entries via EM infilling (reference svdfilter.py:148).

    Single-matrix form over the batched one.  ``full_matrices`` is accepted
    for API parity but only the economy form is computed.  Host arrays go
    to ``device``; tensors stay where they are.
    """
    del full_matrices
    A = as_tensor(A, device)
    mask = as_tensor(mask, A.device).bool()
    u, sig, vh = _svd_em_batched(A[None], mask[None], niter=niter, rank=rank)
    return u[0], sig[0], vh[0]


def _mmode_matrices(mmodes, dtype=torch.complex64):
    """The MModes vis and mask as per-m matrices on their device.

    vis [m, 2, f, b] -> A [m, f, 2b]; mask True where weight == 0.
    """
    vis = mmodes.vis[:].to(dtype)
    M, _, F, B = vis.shape
    A = vis.permute(0, 2, 1, 3).reshape(M, F, 2 * B)
    mask = (mmodes.weight[:] == 0.0).permute(0, 2, 1, 3).reshape(M, F, 2 * B)
    return A, mask


class SVDSpectrumEstimator(ContainerTask):
    """Calculate the per-m SVD spectrum of m-modes (reference svdfilter.py:11)."""

    niter = config.int_prop(5)

    def process(self, mmodes):
        mmodes.redistribute("m")
        A, mask = _mmode_matrices(mmodes)
        nmode = min(A.shape[1], A.shape[2])

        spec = containers.SVDSpectrum(singularvalue=np.arange(nmode), axes_from=mmodes)
        _, sig, _ = _svd_em_batched(A, mask, niter=self.niter, rank=5)
        spec.spectrum[:] = sig[:, :nmode]
        return spec


def _svd_filter_device(A, mask, *, niter, global_threshold, local_threshold):
    """EM SVD + bright-mode cut + reconstruction."""
    u, sig, vh = _svd_em_batched(A, mask, niter=niter, rank=5)
    sv_max = sig.max()
    # per-m cut: modes above either threshold (counts of a sorted-descending
    # spectrum, so a rank mask by index is equivalent to the count cut)
    global_cut = (sig > global_threshold * sv_max).sum(dim=-1)
    local_cut = (sig > local_threshold * sig[:, :1]).sum(dim=-1)
    cut = torch.maximum(global_cut, local_cut)
    idx = torch.arange(sig.shape[-1], device=sig.device)
    sig_cut = torch.where(idx[None] < cut[:, None], torch.zeros_like(sig), sig)
    filtered = (u * sig_cut[:, None, :].to(u.dtype)) @ vh
    return filtered, sv_max


class SVDFilter(ContainerTask):
    """Remove the most correlated SVD modes per m (reference svdfilter.py:60).

    Attributes
    ----------
    niter : int
        EM iterations for masked values.
    local_threshold, global_threshold : float
        Cut modes above these fractions of the per-m / global maximum
        singular value.
    """

    niter = config.int_prop(5)
    global_threshold = config.float_prop(1e-3)
    local_threshold = config.float_prop(1e-2)

    def process(self, mmodes):
        mmodes.redistribute("m")
        A, mask = _mmode_matrices(mmodes)
        M, F, B2 = A.shape

        filtered, sv_max = _svd_filter_device(
            A,
            mask,
            niter=self.niter,
            global_threshold=self.global_threshold,
            local_threshold=self.local_threshold,
        )
        self.log.debug("Largest singular value across all m: %.2g", float(sv_max))
        mmodes.vis[:] = filtered.reshape(M, F, 2, B2 // 2).permute(0, 2, 1, 3)
        return mmodes
