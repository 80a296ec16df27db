"""The device an entry point runs on when its caller names none.

Entry points that build tensors from host data take ``device=``.  Left
out, it means the first CUDA card, unless the caller named another for a
block of code with :func:`default_device` (the CLI's ``--platform cpu``
does).  The CPU is used only when asked for.
Functions that take tensors follow their tensors' device instead.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["resolve", "as_tensor", "default_device"]

# the device resolve(None) names inside default_device(); None means cuda:0
_default: torch.device | None = None


@contextlib.contextmanager
def default_device(device):
    """Make ``device`` what :func:`resolve` gives for None in the body of a
    ``with`` block (None: the first CUDA card)."""
    global _default
    before, _default = _default, None if device is None else torch.device(device)
    try:
        yield
    finally:
        _default = before


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the default set by
    :func:`default_device`.

    With no default set, None means ``cuda:0`` and raises RuntimeError
    when no CUDA device is available: there is no silent fall back to the
    CPU, which a caller asks for with ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if _default is not None:
        return _default
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
