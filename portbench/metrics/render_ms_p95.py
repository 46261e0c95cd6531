"""95th percentile, over every render of the window, of the host time from
the render's call to its image on the host as a NumPy array (host clock)."""

import windowstats


def read(ctx):
    w = ctx["window"]
    if not hasattr(w, "samples_per_unit"):
        return None
    return windowstats.percentile([t * 1e3 for t in w.times], 95)
