"""Shared by the readers of the program's own spans: while a profiler
records, every span of orion_tpu_torch/profiling.py is a record_function
range of its name, so a traced run's slice holds them as host events
(user_annotation) on the profiler's clock. A program without such spans
gives no event, and the readers then return None."""

from __future__ import annotations

from kernelnames import steps


def seconds(trace, name: str):
    """Summed seconds of the slice's spans called `name`, or None when the
    slice holds none."""
    durs = [dur for n, _, dur in trace.host if n == name]
    return sum(durs) * 1e-6 if durs else None


def per_step_ms(ctx, name: str):
    """Milliseconds of the spans `name` a train step of the slice."""
    tr, n = ctx["trace"], steps(ctx["window"])
    if tr is None or not n:
        return None
    s = seconds(tr, name)
    return None if s is None else s / n * 1e3
