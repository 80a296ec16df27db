"""fullsphere.fringe_build_ms: device ms a call of the kernels launched inside
the program's ``fullsphere.fringe_build`` spans (the fringe x beam planes of
each baseline chunk of the full-sphere round trip)."""

SPAN = "fullsphere.fringe_build"
SPANS = (SPAN,)  # the host spans whose kernels the harness sums


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.span_count.get(SPAN) or not ctx["calls"]:
        return None
    return 1e3 * tr.span_device_s[SPAN] / ctx["calls"]
