"""Host seconds of the route's build (the megakernel renderer's tables or
the big route's own tree) and, for a fit, the target render: a span around
the calls in the benchmark."""


def read(ctx):
    return ctx["spans"].get("route")
