"""windowed.sky_transform_ms: device ms a call of the kernels launched inside the
program's ``windowed.sky_transform`` spans (the SHT analysis of the sky, its
band projection and the per-pixel DFT factors, with the padded weights and the
zeroed accumulators, once a call of the windowed round trip)."""

SPAN = "windowed.sky_transform"
SPANS = (SPAN,)  # the host spans whose kernels the harness sums


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.span_count.get(SPAN) or not ctx["calls"]:
        return None
    return 1e3 * tr.span_device_s[SPAN] / ctx["calls"]
