"""Profiling and observability helpers.

The PyTorch counterpart of `orion_tpu.profiling`. The reference's only
instrumentation is a per-scanline tqdm bar, a triangle count and
(commented-out) intersection counters (raytracer.cpp:66-68, 305-310,
avx/sbvh.cpp:7-12). Here:

  - `phase_timer`: wall-clock per named phase with a summary (scene load,
    BVH build, render, save);
  - `trace`: a `torch.profiler` trace of the host and, where there is
    one, the CUDA device, written as a Chrome trace into `profile_dir`
    (open it in chrome://tracing or Perfetto);
  - `traversal_counters`: the BVH work counters, the tree-quality metric
    the reference compared split strategies by (benchmarks.md:16-32),
    from the batched plain walk (ops/bvh_traverse.py);
  - `progress`: a tqdm-like progress bar for chunked renders.
"""

from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, Optional


class phase_timer:
    """Accumulate named phase wall-times; print or export a summary."""

    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        return {k: round(v, 4) for k, v in self.phases.items()}

    def report(self, file=sys.stderr) -> None:
        total = sum(self.phases.values())
        for name, t in self.phases.items():
            pct = 100.0 * t / total if total else 0.0
            print(f"  {name:<24s} {t:8.3f}s  {pct:5.1f}%", file=file)


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    """A torch.profiler trace (CPU, and CUDA where available) written to
    `profile_dir`/trace.json when profile_dir is set; no-op otherwise."""
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
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


def traversal_counters(scene, bvh, orig, dirs) -> Dict[str, float]:
    """Ray-AABB and ray-triangle test counts of a ray batch over a BVH
    (the benchmarks.md:22-32 metric), in one call; `bvh` on the rays'
    device. `scene` is accepted as the JAX package's signature has it."""
    from orion_tpu_torch.ops.bvh_traverse import traverse

    del scene
    _, _, st = traverse(bvh, orig, dirs, with_stats=True)
    n = orig.shape[0]
    return {
        "rays": float(n),
        "box_tests": float(st.box_tests),
        "tri_tests": float(st.tri_tests),
        "box_tests_per_ray": float(st.box_tests) / n,
        "tri_tests_per_ray": float(st.tri_tests) / n,
        "max_steps": float(st.steps),
    }


def progress(iterable, total: Optional[int] = None, desc: str = "",
             file=sys.stderr):
    """A minimal tqdm-alike (the reference vendors tqdm.cpp for its
    scanline bar, raytracer.cpp:66-68)."""
    total = total if total is not None else len(iterable)
    t0 = time.perf_counter()
    for i, item in enumerate(iterable):
        yield item
        done = i + 1
        dt = time.perf_counter() - t0
        rate = done / dt if dt > 0 else 0.0
        eta = (total - done) / rate if rate > 0 else 0.0
        bar = "#" * int(30 * done / total)
        print(f"\r{desc}[{bar:<30s}] {done}/{total} "
              f"({rate:.2f}/s, eta {eta:.0f}s)", end="", file=file)
    print(file=file)
