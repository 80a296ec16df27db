"""device.idle_share: the share of the traced window, in percent, in which no
kernel, copy or set ran on the card (1 - the union of their intervals over
the window)."""

from portbench import trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    return 100.0 * trace.idle_share(tr)
