"""Profiler spans that cost one flag check when no profiler records.

:func:`span` is ``torch.profiler.record_function(name)`` while a
``torch.profiler`` profile is recording (``pipeline.profile: <dir>``, or a
traced benchmark run), so each span lands in the profiler's own event list,
on the clock of the device work launched inside it.  Otherwise it is one
shared no-op context: a bare ``record_function`` costs microseconds a call
even when nothing records.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

__all__ = ["span"]

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records the host span ``name`` when a profiler is on."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NULL
