"""Spans, counters and the Chrome-trace exporter of the port.

The reference's only instrumentation is a per-scanline tqdm bar, a triangle
count and (commented-out) intersection counters (raytracer.cpp:66-68,
305-310, avx/sbvh.cpp:7-12). Here one registry, process-wide:

  - `span(name)`: a context manager that times a block on the host clock.
    Names are hierarchical by their dots (`fit.step.grad` runs inside
    `fit.step`). A span's self time is its duration less the time its
    child spans cover. Each thread keeps its own stack of open spans:
    autograd runs a CUDA backward on a thread of its own, so a span opened
    there (a kernel's first launch in a backward pass) is nobody's child.
  - `count(name, n=1)`: a counter.
  - `enable()`, `disable()`, `enabled()`, `recording()`, `reset()` and
    `totals()` switch and read them. The registry keeps running totals a
    name (count, total, self and longest seconds), so its memory stays
    bounded however long it records.
  - `trace(profile_dir)`: a `torch.profiler` trace of the host and, where
    there is one, the CUDA device, written as a Chrome trace into
    `profile_dir` (chrome://tracing or Perfetto), with the registry on.

Off is the default, and off costs next to nothing: `span()` reads the
registry's flag and the profiler's, and with both down returns one shared
object that does nothing (no clock read, no allocation); `count()` returns
at once. While a `torch.profiler` profile records, every span also opens a
`record_function` range of its name, whether the registry is on or not, so
the program's spans sit in the profiler's trace on its clock, beside the
kernels and copies they issue.

Where the program opens spans and counters:

  prepare                     engine.prepare; children prepare.load_scene,
                              prepare.validate, prepare.camera,
                              prepare.accel (backend selection, its tree)
  kernel.build                one nvcc batch (ops/cuda_build.build) or the
                              g++ build of the native library
  kernel.load                 a library's dlopen and symbol lookup
  kernel.first_launch         the first launch of each CUDA kernel in the
                              process (CUDA loads its module there)
  route.fused_path            make_fused_path_renderer's tables
  route.big_path              make_big_path_renderer's candidates
  render.fused                one call of the fused path renderer
  fit                         one optim.fit call; children fit.setup and,
                              a step, fit.step with fit.step.grad,
                              fit.step.update and fit.step.loss_read
  prb.table                   the PRB pair's table repacked from the
                              materials (FusedPathPRB.forward)
  counters kernel.built       libraries compiled
           kernel.loaded      libraries loaded
           prb.id_check       reads of the PRB replay's material ids
                              (ops/prb._emitter_column): one a plan, or
                              one a replay called without a plan's
           fit.loss_event     fit steps whose loss was read from its own
                              host copy, not by waiting for the whole step
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

_on = False
_lock = threading.Lock()
_spans: Dict[str, list] = {}        # name -> [n, total_s, self_s, max_s]
_counts: Dict[str, int] = {}
_local = threading.local()


class _Off:
    """The span of a registry that is off while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "t0", "children", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = record_function(self.name)
            self.range.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.children = 0.0
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].children += dt
        if self.range is not None:
            self.range.__exit__(*exc)
        own = dt - self.children
        with _lock:
            s = _spans.get(self.name)
            if s is None:
                _spans[self.name] = [1, dt, own, dt]
            else:
                s[0] += 1
                s[1] += dt
                s[2] += own
                s[3] = max(s[3], dt)
        return None


def span(name: str):
    """A context manager timing its block under `name` (see the module
    docstring); a shared no-op while spans are off and no profiler
    records."""
    if _on:
        return _Span(name)
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while spans are on."""
    if not _on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans open now still record when they close."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Spans and counters on for the block; the state before it is
    restored after."""
    was = _on
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


def reset() -> None:
    """Forget every total and counter (spans open now record when they
    close)."""
    with _lock:
        _spans.clear()
        _counts.clear()


def totals() -> Dict[str, dict]:
    """{name: {"n", "total_s", "self_s", "max_s"}} for each span name and
    {name: {"count"}} for each counter, since the last reset."""
    with _lock:
        out = {k: {"n": s[0], "total_s": s[1], "self_s": s[2], "max_s": s[3]}
               for k, s in _spans.items()}
        for k, c in _counts.items():
            out.setdefault(k, {})["count"] = c
    return out


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    """A torch.profiler trace (CPU, and CUDA where available) written to
    `profile_dir`/trace.json, with the registry on, when profile_dir is
    set; no-op otherwise."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    with recording(), profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
