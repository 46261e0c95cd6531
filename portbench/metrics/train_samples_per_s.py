"""Forward+backward primary samples (W x H x spp a step) of every step of
the window over its whole time, each fit job's own set-up included (host
clock)."""

import windowstats


def read(ctx):
    w = ctx["window"]
    if not hasattr(w, "samples_per_step"):
        return None
    return windowstats.rate([w.samples_per_step * n for n in w.steps],
                            w.window_s)
