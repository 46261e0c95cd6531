"""The device trace of a traced run: torch.profiler over a steady slice.

`profiled(fn, tmpdir)` runs fn under torch.profiler (CPU and, on a card,
CUDA activity) inside a record_function range that marks the slice,
exports the Chrome trace into `tmpdir`, reads it and deletes it. The
result, `DeviceTrace`, holds the slice's length, every device operation
(kernels, copies, sets) inside it, and the host operations, from which
the busy time, the time by operation name and the idle gaps by what the
host was doing are worked out.
"""

from __future__ import annotations

import heapq
import json
import os
from pathlib import Path

SLICE = "portbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


class DeviceTrace:
    def __init__(self, events: list):
        sl = [e for e in events if e.get("name") == SLICE
              and e.get("cat") == "user_annotation"]
        if not sl:
            raise RuntimeError("the profiler's trace lacks the slice range")
        self.t0 = float(sl[0]["ts"])
        self.t1 = self.t0 + float(sl[0]["dur"])
        inside = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.ops = [(e["name"], float(e["ts"]), float(e["dur"]))
                    for e in inside if e.get("cat") in DEVICE_CATS
                    and self.t0 <= float(e["ts"]) < self.t1]
        self.host = [(e["name"], float(e["ts"]), float(e["dur"]))
                     for e in inside if e.get("cat") in HOST_CATS
                     and e["name"] != SLICE
                     and float(e["ts"]) < self.t1
                     and float(e["ts"]) + float(e["dur"]) > self.t0]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _merged(self):
        iv = sorted((ts, min(ts + dur, self.t1)) for _, ts, dur in self.ops)
        out = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in self._merged()) * 1e-6

    def seconds_by_name(self) -> dict:
        out = {}
        for name, _, dur in self.ops:
            out[name] = out.get(name, 0.0) + dur * 1e-6
        return out

    def seconds_where(self, pred) -> float:
        """Device seconds of the operations whose name passes `pred`."""
        return sum(dur for name, _, dur in self.ops if pred(name)) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        by = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])
        return [[name, s] for name, s in by[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time of the slice grouped by the innermost host
        operation running at each gap's middle (the least (duration,
        name) among those whose [start, end] holds it), longest first.

        One sweep: the gaps' middles rise, so the host operations are
        taken in order of start as the sweep reaches them, and a heap
        keyed by (duration, name) drops an operation once a middle lies
        past its end, which no later middle can lie before."""
        merged = self._merged()
        edges = [self.t0] + [x for ab in merged for x in ab] + [self.t1]
        host = sorted((ts, ts + dur, dur, name) for name, ts, dur
                      in self.host)
        heap, nxt = [], 0
        by = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            while nxt < len(host) and host[nxt][0] <= mid:
                ts, end, dur, name = host[nxt]
                heapq.heappush(heap, (dur, name, end))
                nxt += 1
            while heap and heap[0][2] < mid:
                heapq.heappop(heap)
            label = heap[0][1] if heap else "host (no traced call)"
            by[label] = by.get(label, 0.0) + (b - a) * 1e-6
        gaps = sorted(by.items(), key=lambda kv: -kv[1])
        return [[name, s] for name, s in gaps[:n]]


def idle_pct(ctx, units):
    """The idle_pct.* readers' one reading: the share (%) of the traced
    slice in which nothing ran on the card, or None without a trace or
    where `units(window)` finds no unit of the reader's loop."""
    tr = ctx["trace"]
    if tr is None or not units(ctx["window"]):
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def profiled(fn, tmpdir, cuda: bool):
    """(fn's result, DeviceTrace) of one call of fn under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(SLICE):
            if cuda:
                torch.cuda.synchronize()
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    path = Path(tmpdir) / "portbench_trace.json"
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, DeviceTrace(events)
