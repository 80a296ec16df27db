"""fullsphere.uv_contraction_ms: device ms a call of the kernels launched inside
the program's ``fullsphere.uv_contraction`` spans (the U/V contraction of each
baseline chunk's ring coefficients against the sky sections in the full-sphere
round trip)."""

SPAN = "fullsphere.uv_contraction"
SPANS = (SPAN,)  # the host spans whose kernels the harness sums


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.span_count.get(SPAN) or not ctx["calls"]:
        return None
    return 1e3 * tr.span_device_s[SPAN] / ctx["calls"]
