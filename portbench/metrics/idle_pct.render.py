"""Share of the traced slice of a render loop in which no kernel, copy or
set runs on the card."""

from kernelnames import renders


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not renders(ctx["window"]):
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
