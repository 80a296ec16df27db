"""The device an entry point runs on when its caller names none.

Entry points that build tensors from host data take ``device=``.  Left
out, it means the first CUDA card; the CPU is used only when asked for.
Functions that take tensors follow their tensors' device instead.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve", "as_tensor"]


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda:0``.

    Raises RuntimeError for None when no CUDA device is available: there
    is no silent fall back to the CPU, which a caller asks for with
    ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available: pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda", 0)


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor stays where it is unless ``device`` is named; host data
    goes to :func:`resolve` ``(device)``."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(torch.device(device))
    return torch.as_tensor(np.asarray(x), device=resolve(device))
