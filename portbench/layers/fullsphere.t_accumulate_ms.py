"""fullsphere.t_accumulate_ms: device ms a call of the kernels launched inside the
program's ``fullsphere.t_accumulate`` spans (the T accumulation of each
baseline chunk of the full-sphere round trip)."""

SPAN = "fullsphere.t_accumulate"
SPANS = (SPAN,)  # the host spans whose kernels the harness sums


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.span_count.get(SPAN) or not ctx["calls"]:
        return None
    return 1e3 * tr.span_device_s[SPAN] / ctx["calls"]
