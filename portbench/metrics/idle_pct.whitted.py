"""Share of the traced slice of the Whitted render loop in which no
kernel, copy or set runs on the card: what the host's path of a short
render (the wrapper's checks and allocations, the launch, the image's
copy) leaves the card idle."""

from devtrace import idle_pct
from kernelnames import renders


def read(ctx):
    return idle_pct(ctx, renders)
