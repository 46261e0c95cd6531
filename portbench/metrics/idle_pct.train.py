"""Share of the traced slice of a fit loop in which no kernel, copy or set
runs on the card."""

from devtrace import idle_pct
from kernelnames import steps


def read(ctx):
    return idle_pct(ctx, steps)
