"""fullsphere.ring_analysis_ms: device ms a call of the kernels launched inside
the program's ``fullsphere.ring_analysis`` spans (the ring DFTs of each
baseline chunk's fringe x beam maps in the full-sphere round trip)."""

SPAN = "fullsphere.ring_analysis"
SPANS = (SPAN,)  # the host spans whose kernels the harness sums


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.span_count.get(SPAN) or not ctx["calls"]:
        return None
    return 1e3 * tr.span_device_s[SPAN] / ctx["calls"]
