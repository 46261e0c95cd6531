"""Mean over the slice's fit jobs of the time from the call of optim.fit to
its first callback: the job's own set-up and its first step."""


def read(ctx):
    w = ctx["window"]
    if not hasattr(w, "first_step"):
        return None
    return sum(w.first_step) / len(w.first_step) * 1e3
