"""Share of the traced slice of a fit loop in which no kernel, copy or set
runs on the card."""

from kernelnames import steps


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not steps(ctx["window"]):
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
