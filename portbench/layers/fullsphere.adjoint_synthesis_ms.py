"""fullsphere.adjoint_synthesis_ms: device ms a call of the kernels launched
inside the program's ``fullsphere.adjoint_synthesis`` spans (the Legendre
adjoint and SHT synthesis that end each call of the full-sphere round trip)."""

SPAN = "fullsphere.adjoint_synthesis"
SPANS = (SPAN,)  # the host spans whose kernels the harness sums


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.span_count.get(SPAN) or not ctx["calls"]:
        return None
    return 1e3 * tr.span_device_s[SPAN] / ctx["calls"]
