"""CPU tests of the readers of the program's own spans (pytest portbench/):
a traced run reports them, an untraced one leaves the program's registry
off, and the device trace labels an idle gap with the span around it."""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import devtrace  # noqa: E402
import harness  # noqa: E402
from test_portbench_harness import TINY  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m for m in BENCH["per_layer"]
                if m["name"].startswith("span.")]
SPAN_CELLS = sorted({w for m in SPAN_METRICS for w in m["workloads"]})


def _run(cell: str, trace: bool) -> dict:
    loop = harness.Cell(cell).traffic["loop"]
    return harness.run_cell(cell, 2**31 + 4242, 0.05, trace, device="cpu",
                            traffic_overrides=TINY[loop])


@pytest.mark.parametrize("cell", SPAN_CELLS)
def test_a_traced_run_reports_the_span_metrics(cell):
    from orion_tpu_torch import profiling

    res = _run(cell, True)
    assert res["correct"], res["checks"]
    for m in SPAN_METRICS:
        if cell in m["workloads"]:
            assert res["metrics"][m["name"]]["value"] >= 0, m["name"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    if "span.fit_issue_ms" in got:
        # issue and wait split each step's span
        assert got["span.fit_issue_ms"] > 0 and got["span.fit_wait_ms"] > 0
    # the profiler's ranges alone: the registry stayed off
    assert not profiling.enabled() and profiling.totals() == {}


@pytest.mark.parametrize("cell", SPAN_CELLS)
def test_an_untraced_run_leaves_the_spans_off(cell):
    from orion_tpu_torch import profiling

    res = _run(cell, False)
    assert res["correct"], res["checks"]
    assert not profiling.enabled() and profiling.totals() == {}
    assert not any(k.startswith("span.") for k in res["metrics"])


def _trace(host):
    ev = [{"name": devtrace.SLICE, "cat": "user_annotation", "ph": "X",
           "ts": 0.0, "dur": 1000.0},
          {"name": "k", "cat": "kernel", "ph": "X", "ts": 0.0, "dur": 300.0},
          {"name": "k", "cat": "kernel", "ph": "X", "ts": 600.0,
           "dur": 400.0}]
    return devtrace.DeviceTrace(ev + [
        {"name": n, "cat": c, "ph": "X", "ts": ts, "dur": dur}
        for n, c, ts, dur in host])


def test_an_idle_gap_takes_the_name_of_the_span_around_it():
    tr = _trace([("fit.step", "user_annotation", 100.0, 800.0),
                 ("fit.step.update", "user_annotation", 250.0, 200.0),
                 ("aten::add", "cpu_op", 500.0, 50.0)])
    gaps = dict(tr.idle_gaps())
    # the gap [300, 600]: its middle, 450, lies in fit.step.update (the
    # innermost range there), not in aten::add
    assert gaps == {"fit.step.update": pytest.approx(300e-6)}


def test_the_readers_divide_by_steps_and_jobs():
    import harness as h

    tr = _trace([("fit.setup", "user_annotation", 0.0, 50.0),
                 ("fit.step", "user_annotation", 100.0, 400.0),
                 ("fit.step.loss_read", "user_annotation", 300.0, 150.0),
                 ("prb.table", "user_annotation", 120.0, 20.0),
                 ("fit.step", "user_annotation", 520.0, 400.0),
                 ("fit.step.loss_read", "user_annotation", 700.0, 250.0),
                 ("prb.table", "user_annotation", 540.0, 40.0)])
    win = types.SimpleNamespace(samples_per_step=1, steps=[2], attempted=1)
    ctx = {"trace": tr, "window": win}
    read = {m["name"]: h.load_module(HERE / "metrics" / f"{m['name']}.py",
                                     "metric").read(ctx)
            for m in SPAN_METRICS}
    assert read["span.fit_setup_ms"] == pytest.approx(0.05)
    assert read["span.fit_wait_ms"] == pytest.approx(0.2)
    assert read["span.fit_issue_ms"] == pytest.approx(0.2)
    assert read["span.prb_table_ms"] == pytest.approx(0.03)
    # a program without the spans, or a render window: nothing to read
    bare = {"trace": _trace([]), "window": win}
    render = {"trace": tr, "window": types.SimpleNamespace(attempted=3)}
    for m in SPAN_METRICS:
        mod = h.load_module(HERE / "metrics" / f"{m['name']}.py", "metric")
        assert mod.read(bare) is None and mod.read(render) is None
        assert mod.read({"trace": None, "window": win}) is None
