"""Reduction of a ``torch.profiler`` trace of the measured window.

The window is the host span ``portbench.window`` that the harness opens
around its calls.  Device activity is every kernel, copy and set on the
card (the profiler's CUDA events that are not user annotations); the
device is busy where the union of their intervals covers the window, so
kernels that overlap on several streams count once.  A span's device time
is the time of the kernels launched inside its host ranges (what
``chip_smoke.py::profile_split`` reads as a host event's
``device_time_total``), found here from the profiler's raw events.
Times are seconds from the start of the window.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

WINDOW = "portbench.window"


@dataclass
class Trace:
    window: tuple[float, float]  # host span of the window, seconds on the trace's clock
    device: list  # [(start, end, name)] seconds, clipped to the window
    host: list  # [(start, end, name)] host ops and spans inside the window, seconds
    span_device_s: dict = field(default_factory=dict)  # host span name -> device s of the kernels it launched
    span_count: dict = field(default_factory=dict)  # host span name -> occurrences

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def union(intervals) -> list[tuple[float, float]]:
    """Merged [start, end) intervals, sorted."""
    out: list[list[float]] = []
    for a, b in sorted((a, b) for a, b, *_ in intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in union(tr.device))


def idle_share(tr: Trace) -> float:
    return 1.0 - busy_s(tr) / tr.window_s


def gaps(tr: Trace) -> list[tuple[float, float]]:
    """Idle stretches of the device inside the window, in time order."""
    out, t = [], tr.window[0]
    for a, b in union(tr.device):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if tr.window[1] > t:
        out.append((t, tr.window[1]))
    return out


def host_at(tr: Trace, times) -> list[str]:
    """The innermost host op or span running at each of ``times`` (``idle`` where none)."""
    if not tr.host:
        return ["idle" for _ in times]
    ab = np.array([(a, b) for a, b, _ in tr.host])
    out = []
    for t in times:
        inside = np.nonzero((ab[:, 0] <= t) & (t <= ab[:, 1]))[0]
        out.append(tr.host[inside[np.argmin(ab[inside, 1] - ab[inside, 0])]][2] if len(inside) else "idle")
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by what the host was doing at their middle."""
    per_op: dict[str, float] = {}
    for a, b, name in tr.device:
        per_op[name] = per_op.get(name, 0.0) + (b - a)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps(tr), key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[name, s] for name, s in ops],
        "idle_gaps": [[name, b - a] for name, (a, b) in zip(host_at(tr, [0.5 * (a + b) for a, b in longest]), longest)],
    }


def from_profile(prof, spans=()) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile``, with the
    device seconds of the kernels launched inside each host span of ``spans``.

    A kernel belongs to the span whose host range holds the start of the
    host op that launched it (the profiler links the two by correlation id).
    """
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    win = [e for e in cpu if e.name() == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} host spans {WINDOW!r}, not one")
    base = win[0].start_ns()

    def sec(ns: int) -> float:
        return (ns - base) * 1e-9

    w0, w1 = 0.0, sec(win[0].end_ns())
    launched_at = {e.correlation_id(): sec(e.start_ns()) for e in cpu}
    host = [(sec(e.start_ns()), sec(e.end_ns()), e.name()) for e in cpu
            if sec(e.end_ns()) > w0 and sec(e.start_ns()) < w1 and e.name() != WINDOW]
    ranges = {name: sorted((sec(e.start_ns()), sec(e.end_ns())) for e in cpu if e.name() == name) for name in spans}
    device, span_s = [], dict.fromkeys(spans, 0.0)
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        a, b = sec(e.start_ns()), sec(e.end_ns())
        if b <= w0 or a >= w1:
            continue
        device.append((max(a, w0), min(b, w1), e.name()))
        t = launched_at.get(e.linked_correlation_id())
        if t is None:
            continue
        for name, rs in ranges.items():
            i = bisect.bisect_right(rs, (t, float("inf"))) - 1
            if i >= 0 and rs[i][0] <= t <= rs[i][1]:
                span_s[name] += b - a
    tr = Trace((w0, w1), device, host)
    tr.span_device_s = span_s
    tr.span_count = {name: len(rs) for name, rs in ranges.items()}
    return tr
