"""Primary path samples (W x H x spp) of every render in the window over
the window's whole time (host clock)."""

import windowstats


def read(ctx):
    w = ctx["window"]
    if not hasattr(w, "samples_per_unit"):
        return None
    return windowstats.rate([w.samples_per_unit] * w.attempted, w.window_s)
