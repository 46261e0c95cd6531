"""Milliseconds a fit job of the traced slice spends in optim.fit's span
fit.setup: the target tensor, the parameters, the optimizer and the PRB
trainer's plan and tables, from the call to its first step."""

from kernelnames import steps
from programspans import seconds


def read(ctx):
    tr, w = ctx["trace"], ctx["window"]
    if tr is None or not steps(w):
        return None
    s = seconds(tr, "fit.setup")
    return None if s is None else s / w.attempted * 1e3
