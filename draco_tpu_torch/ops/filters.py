"""Moving-median filter of masked data (host numpy).

Port of ``draco_tpu.ops.filters.medfilt`` (reference
``draco/util/filters.py:99-130``), the filter the MAD flagger runs.  The
weighted convolution and Fourier null-space filters of that module arrive
with the flagging tasks that use them.
"""

from __future__ import annotations

import numpy as np

from . import median

__all__ = ["medfilt"]


def medfilt(x, mask, size, method: str = "split"):
    """Moving median of masked data (reference filters.py:99-130).

    Masked samples carry zero weight in the moving weighted median.
    ``method`` selects the tie convention; only the "split" convention
    (average of the two straddling values) is provided.
    """
    if method != "split":
        raise ValueError(f"medfilt: unsupported tie method {method!r}; only 'split' is available.")
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return medfilt(x.real, mask, size, method=method) + 1.0j * medfilt(x.imag, mask, size, method=method)
    xc = np.ascontiguousarray(x.astype(np.float64))
    wc = np.ascontiguousarray((~np.asarray(mask, dtype=bool)).astype(np.float64))
    return median.moving_weighted_median(xc, wc, size)
