"""m-mode pack/unpack transforms (port of ``draco_tpu.ops.mmode``).

FFT a periodic sidereal (RA) axis and pack positive/negative harmonic
orders into the ``[m, msign, ...]`` layout; semantics of the reference
``_make_marray``/``_unpack_marray`` (reference
draco/analysis/transform.py:644-705 and 820-851), batched over leading
axes.
"""

from __future__ import annotations

import torch

__all__ = [
    "make_marray",
    "unpack_marray",
    "mmodes_to_sidereal",
    "default_mmax",
    "fast_fft_size",
]


def fast_fft_size(n: int) -> int:
    """Smallest 5-smooth size >= n (``draco_tpu.ops.mmode.fast_fft_size``).

    A sidereal axis of this length keeps the same m-modes as the natural
    minimal length 2*mmax + 1 (1535 = 5 x 307 for mmax 767), and its FFT
    has only small prime factors.
    """
    best = 1
    while best < n:
        best *= 2
    m = best  # power of two >= n is always a candidate
    p3 = 1
    while p3 <= m:
        p35 = p3
        while p35 <= m:
            # smallest power of 2 lifting p35 over n
            p = p35
            while p < n:
                p *= 2
            m = min(m, p)
            p35 *= 5
        p3 *= 3
    return m


def default_mmax(nra: int) -> int:
    """The natural mmax for an RA axis of length nra."""
    return nra // 2


def make_marray(ts: torch.Tensor, mmax: int | None = None) -> torch.Tensor:
    """Pack a sidereal stream [..., nra] into m-modes [mmax+1, 2, ...].

    ``out[m, 0] = V_m`` and ``out[m, 1] = conj(V_{-m})`` with FFT
    normalisation 1/nra.
    """
    N = ts.shape[-1]
    if mmax is None:
        mmax = default_mmax(N)
    mlim = min(N // 2, mmax)
    mlim_neg = N // 2 - 1 + N % 2 if mmax >= N // 2 else mmax

    m_fft = torch.fft.fft(ts, dim=-1) / N
    m_fft = torch.movedim(m_fft, -1, 0)  # [nra, ...]
    out = torch.zeros((mmax + 1, 2, *ts.shape[:-1]), dtype=m_fft.dtype, device=ts.device)
    out[: mlim + 1, 0] = m_fft[: mlim + 1]
    # negative modes: frequencies N-1, N-2, ... map to m = -1, -2, ...
    if mlim_neg > 0:
        out[1 : mlim_neg + 1, 1] = torch.conj(torch.flip(m_fft[N - mlim_neg :], dims=[0]))
    return out


def unpack_marray(mmodes: torch.Tensor, n: int | None = None, oddra: bool | None = None) -> torch.Tensor:
    """Unpack [m, msign, ...] m-modes into a full FFT spectrum [..., ntime]."""
    mmax_plus = mmodes.shape[0] - 1
    if oddra is None:
        # ambiguous when the m = -mmax mode is exactly zero in odd-RA data;
        # callers that know the grid pass ``oddra``
        oddra = bool(torch.any(mmodes[mmax_plus, 1] != 0))
    mmax_minus = mmax_plus if oddra else mmax_plus - 1
    if n is None:
        ntimes = mmax_plus + mmax_minus + 1
    else:
        ntimes = n
        mmax_plus = min(ntimes // 2, mmax_plus)
        mmax_minus = min((ntimes - 1) // 2, mmax_minus)

    marray = torch.zeros((*mmodes.shape[2:], ntimes), dtype=mmodes.dtype, device=mmodes.device)
    pos = torch.movedim(mmodes[:, 0], 0, -1)
    neg = torch.conj(torch.movedim(mmodes[:, 1], 0, -1))
    marray[..., : mmax_plus + 1] = pos[..., : mmax_plus + 1]
    if mmax_minus > 0:
        marray[..., ntimes - mmax_minus :] = torch.flip(neg[..., 1 : mmax_minus + 1], dims=[-1])
    return marray


def mmodes_to_sidereal(mmodes: torch.Tensor, n: int | None = None, oddra: bool | None = None) -> torch.Tensor:
    """Inverse m-mode transform: [m, msign, ...] -> sidereal [..., ntime]."""
    marray = unpack_marray(mmodes, n=n, oddra=oddra)
    return torch.fft.ifft(marray * marray.shape[-1], dim=-1)
