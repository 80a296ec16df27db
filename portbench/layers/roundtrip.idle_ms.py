"""roundtrip.idle_ms: ms a call in which the card was idle while the host was
inside the program's call: the device's idle gaps over the traced window
intersected with the host ranges of the program's ``roundtrip.call`` spans.

Over the window, ``device.idle_share`` x the window less this x the calls is
the idle time between calls: the harness's synchronise and its input draws.
"""

from portbench import trace

CALL = "roundtrip.call"


def overlap_s(xs, ys) -> float:
    """Seconds that two sorted lists of disjoint [start, end) intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device or not ctx["calls"]:
        return None
    calls = trace.union((a, b) for a, b, name in tr.host if name == CALL)
    if not calls:
        return None
    return 1e3 * overlap_s(trace.gaps(tr), calls) / ctx["calls"]
