"""The cells' inputs, drawn on the device from ``--seed``.

Every draw has its own stream: a ``torch.Generator`` on the device seeded
from (seed, what, index) through numpy's ``SeedSequence``, so a seed of any
size gives the same inputs in every run, the program's and the
reference's alike, and drawing one call's inputs again after the window
gives the same tensors.
"""

from __future__ import annotations

import numpy as np
import torch

SKY, WEIGHT, SAMPLE = 1, 2, 4


def _entropy(*ints: int) -> list[int]:
    """Whole numbers of any sign and size as the non-negative words ``SeedSequence`` takes."""
    return [2 * n if n >= 0 else -2 * n - 1 for n in map(int, ints)]


def generator(device, seed: int, *key: int) -> torch.Generator:
    state = np.random.SeedSequence(_entropy(seed, *key)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) % 2**63)


def sky(device, seed: int, call: int, shape) -> torch.Tensor:
    """A Gaussian sky of unit variance [nfreq, npol, npix], float32."""
    return torch.randn(shape, generator=generator(device, seed, SKY, call), device=device)


def mmode_weight(device, seed: int, call: int, shape, low: float, high: float, zero_share: float,
                 zero_rows: float) -> torch.Tensor:
    """m-mode weights [mmax+1, 2, nfreq, nbase], float32: uniform in [low, high),
    each weight zero with probability ``zero_share`` and each (freq, baseline)
    row zero with probability ``zero_rows`` (data flagged whole)."""
    g = generator(device, seed, WEIGHT, call)
    w = low + (high - low) * torch.rand(shape, generator=g, device=device)
    w = w * (torch.rand(shape, generator=g, device=device) >= zero_share)
    rows = torch.rand(shape[2:], generator=g, device=device) >= zero_rows
    return w * rows


def reservoir(seed: int, keep: int):
    """A reservoir sample of ``keep`` calls drawn from the seed: ``slot(k)``
    says where call k goes (None: not kept); every call is kept with the
    same chance whatever the number of calls."""
    rng = np.random.default_rng(_entropy(seed, SAMPLE))

    def slot(k: int):
        if k < keep:
            return k
        j = int(rng.integers(0, k + 1))
        return j if j < keep else None

    return slot
