"""The measured window of a closed loop: whole calls until the time is up."""

from __future__ import annotations

import time


def whole_calls(step, seconds: float, on_start, on_end) -> tuple[int, int, list[float]]:
    """Call ``step(k)`` for k = 0, 1, ... while fewer than ``seconds`` have passed
    since ``on_start()``; the window ends with the last call, at ``on_end()``.
    Returns (calls, units, each call's seconds), units being what the calls'
    ``step`` returned, summed."""
    on_start()
    t0 = time.perf_counter()
    calls = units = 0
    call_s = []
    while time.perf_counter() - t0 < seconds:
        a = time.perf_counter()
        units += step(calls)
        call_s.append(time.perf_counter() - a)
        calls += 1
    on_end()
    return calls, units, call_s
