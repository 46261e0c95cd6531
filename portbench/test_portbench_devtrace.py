"""CPU tests of the device trace's idle gaps (pytest portbench/): the one
sorted sweep gives what the scan of every host event for every gap gave,
label for label and second for second."""

from __future__ import annotations

import random
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import devtrace  # noqa: E402


def scan_idle_gaps(tr: devtrace.DeviceTrace, n: int = 10) -> list:
    """The oracle: each gap's middle tested against every host event (the
    algorithm the sweep replaced)."""
    merged = tr._merged()
    edges = [tr.t0] + [x for ab in merged for x in ab] + [tr.t1]
    by = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        cover = [(dur, name) for name, ts, dur in tr.host
                 if ts <= mid <= ts + dur]
        label = min(cover)[1] if cover else "host (no traced call)"
        by[label] = by.get(label, 0.0) + (b - a) * 1e-6
    gaps = sorted(by.items(), key=lambda kv: -kv[1])
    return [[name, s] for name, s in gaps[:n]]


def synthetic(seed: int) -> list:
    """A slice of kernels with idle gaps between them, and host events
    nested, tied (equal durations, equal names, an end or start exactly on
    a gap's middle) and absent over some gaps."""
    rng = random.Random(seed)
    length = 10000.0
    ev = [{"name": devtrace.SLICE, "cat": "user_annotation", "ph": "X",
           "ts": 0.0, "dur": length}]
    t = rng.choice([0.0, 5.0])
    mids = []
    while t < length:
        dur = rng.choice([3.0, 10.0, 25.0, 40.0])
        gap = rng.choice([0.0, 1.0, 4.0, 12.0, 30.0])
        ev.append({"name": rng.choice(["k1", "k2", "copy"]),
                   "cat": rng.choice(["kernel", "gpu_memcpy"]), "ph": "X",
                   "ts": t, "dur": dur})
        mids.append(t + dur + 0.5 * gap)
        t += dur + gap
    names = ["aten::empty", "aten::copy_", "cudaLaunchKernel", "render.fused",
             "fit.step", "b", "a"]
    cats = ["cpu_op", "cuda_runtime", "user_annotation", "python_function"]
    for _ in range(rng.randint(0, 400)):
        ts = rng.uniform(-50.0, length + 50.0)
        if rng.random() < 0.2 and mids:
            m = rng.choice(mids)                  # an edge on a middle
            ts = m if rng.random() < 0.5 else m - rng.choice([2.0, 6.0])
        dur = rng.choice([2.0, 6.0, 6.0, 50.0, 300.0, 2000.0])
        ev.append({"name": rng.choice(names), "cat": rng.choice(cats),
                   "ph": "X", "ts": ts, "dur": dur})
        if rng.random() < 0.3:                    # a nested child
            ev.append({"name": rng.choice(names), "cat": rng.choice(cats),
                       "ph": "X", "ts": ts + rng.uniform(0.0, dur / 2),
                       "dur": rng.choice([dur / 4, dur / 2])})
    return ev


@pytest.mark.parametrize("seed", range(40))
def test_sweep_equals_the_scan(seed):
    tr = devtrace.DeviceTrace(synthetic(seed))
    for n in (3, 10, 1000):
        assert tr.idle_gaps(n) == scan_idle_gaps(tr, n)


def test_no_host_event_and_no_kernel():
    bare = [{"name": devtrace.SLICE, "cat": "user_annotation", "ph": "X",
             "ts": 0.0, "dur": 100.0}]
    tr = devtrace.DeviceTrace(bare)
    assert tr.idle_gaps() == [["host (no traced call)",
                                pytest.approx(100e-6)]]
    assert tr.idle_gaps() == scan_idle_gaps(tr)
