"""fullsphere.sky_sections_ms: device ms a call of the kernels launched inside the
program's ``fullsphere.sky_sections`` spans (the SHT analysis of the sky and
its Legendre sections, with the padded weights and the zeroed T, once a call of
the full-sphere round trip)."""

SPAN = "fullsphere.sky_sections"
SPANS = (SPAN,)  # the host spans whose kernels the harness sums


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.span_count.get(SPAN) or not ctx["calls"]:
        return None
    return 1e3 * tr.span_device_s[SPAN] / ctx["calls"]
