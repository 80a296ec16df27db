"""Random sampling: complex normals and complex Wishart matrices.

Port of ``draco_tpu.ops.random`` (reference ``draco/util/random.py``).  The
device draws take a ``torch.Generator`` (``generator=``) and run on its
device; the Bartlett decomposition of the Wishart draw (reference
random.py:106-137) is vectorised over batch dimensions.  The numpy twins
(``rng=``) are copied from the JAX package, so host draws match it exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve

__all__ = [
    "complex_normal",
    "standard_complex_normal",
    "standard_complex_wishart_factor",
    "standard_complex_wishart",
    "complex_wishart",
    "complex_normal_np",
    "standard_complex_wishart_np",
    "complex_wishart_np",
]


def _generator_device(generator, device):
    return generator.device if generator is not None and device is None else resolve(device)


def complex_normal(size=(), loc=0.0, scale=1.0, dtype=torch.complex64, generator=None, device=None):
    """Complex normal variates with E|x - loc|^2 = scale^2 (reference random.py:7).

    Drawn on ``generator``'s device (or ``device``).
    """
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    z = torch.randn(*tuple(size), 2, dtype=rdt, generator=generator, device=_generator_device(generator, device))
    return torch.view_as_complex(z) * (scale / np.sqrt(2)) + loc


def standard_complex_normal(shape, dtype=torch.complex64, generator=None, device=None):
    """Standard complex normal (unit total variance) (reference random.py:86)."""
    return complex_normal(size=shape, dtype=dtype, generator=generator, device=device)


def standard_complex_wishart_factor(m: int, n, batch_shape=(), dtype=torch.complex64, generator=None, device=None):
    """The Bartlett factor ``T`` of a standard complex Wishart draw ``T T^H``.

    ``T`` is lower triangular: the strict lower triangle CN(0, 1), the
    diagonal ``sqrt(Gamma(n - i))`` (reference random.py:126-137).  ``n``
    may be a tensor broadcasting against ``batch_shape`` (per-draw degrees
    of freedom).
    """
    dev = _generator_device(generator, device)
    T = torch.tril(complex_normal((*batch_shape, m, m), dtype=dtype, generator=generator, device=dev), diagonal=-1)
    rdt = T.real.dtype
    alpha = torch.as_tensor(n, dtype=rdt, device=dev)[..., None] - torch.arange(m, dtype=rdt, device=dev)
    g = torch._standard_gamma(alpha.expand(*batch_shape, m).contiguous(), generator=generator)
    return T + torch.diag_embed(g.sqrt().to(T.dtype))


def standard_complex_wishart(m: int, n, batch_shape=(), dtype=torch.complex64, generator=None, device=None):
    """Standard complex Wishart draws ``T T^H`` via the Bartlett decomposition
    (:func:`standard_complex_wishart_factor`)."""
    T = standard_complex_wishart_factor(m, n, batch_shape, dtype, generator, device)
    return T @ T.conj().transpose(-1, -2)


def complex_wishart(C, n, batch_shape=(), generator=None):
    """Complex Wishart draws with mean ``n C`` (reference random.py:140).

    ``C`` may carry batch dims; one independent draw is made per batch
    element (by default), coloured by the Cholesky factor of ``C``.
    """
    C = torch.as_tensor(C)
    if batch_shape == ():
        # independent draws per batch element of C: one draw broadcast over
        # the batch would make every sample perfectly correlated
        batch_shape = tuple(C.shape[:-2])
    L = torch.linalg.cholesky(C)
    A = standard_complex_wishart(C.shape[-1], n, batch_shape, dtype=C.dtype, generator=generator, device=C.device)
    return L @ A @ L.conj().transpose(-1, -2)


# ---------------------------------------------------------------------------
# numpy twins (host-side parity with the reference API)
# ---------------------------------------------------------------------------


def complex_normal_np(loc=0.0, scale=1.0, size=None, dtype=np.complex128, rng=None):
    if rng is None:
        rng = np.random.default_rng()
    if size is None:
        size = (1,)
    rtype = np.float32 if dtype == np.complex64 else np.float64
    z = rng.standard_normal((*tuple(size), 2)).astype(rtype)
    out = (z[..., 0] + 1j * z[..., 1]).astype(dtype) * (scale / np.sqrt(2))
    return out + loc


def standard_complex_wishart_np(m, n, rng=None):
    if rng is None:
        rng = np.random.default_rng()
    T = np.zeros((m, m), dtype=np.complex128)
    ntri = m * (m - 1) // 2
    T[np.tril_indices(m, k=-1)] = (rng.standard_normal(ntri) + 1j * rng.standard_normal(ntri)) / np.sqrt(2)
    for i in range(m):
        T[i, i] = rng.gamma(n - i) ** 0.5
    return T @ T.conj().T


def complex_wishart_np(C, n, rng=None):
    import scipy.linalg as la

    L = la.cholesky(np.asarray(C), lower=True)
    A = standard_complex_wishart_np(C.shape[0], n, rng=rng)
    return L @ A @ L.conj().T
