"""Process start to the first timed unit: import, kernel load from the
compile cache, scene files, engine.prepare, the route's build and the
warm-up at the cell's own shapes (host clock)."""


def read(ctx):
    return ctx["setup_s"]
