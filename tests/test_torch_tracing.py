"""The span and counter registry of profiling.py, on the CPU: off by
default and free when off, self time and per-thread stacks, the spans in a
torch.profiler trace, the spans of optim.fit (which change no loss), the
kernel-load counters and the CLI's --stats."""

import contextlib
import dataclasses
import io
import json
import threading
import time
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_port_util  # noqa: F401  (one intra-op thread a worker)
from cornell_scenes import write_cornell
from orion_tpu_torch import cli, profiling
from orion_tpu_torch.engine import prepare
from orion_tpu_torch.ops import cuda_build
from orion_tpu_torch.ops.fused_path import make_fused_path_renderer
from orion_tpu_torch.optim import _read_loss, fit

FIT = dict(samples=2, max_depth=3, light_samples=2)


@pytest.fixture(autouse=True)
def registry_off():
    """Each test starts and ends with the registry off and empty."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def test_spans_off_share_one_object_and_record_nothing():
    assert not profiling.enabled()
    a, b = profiling.span("a"), profiling.span("b.c")
    assert a is b
    with a:
        profiling.count("n", 3)
    # no allocation a call: the loop's peak is no higher than that of a
    # loop over a context manager made once (a span of a registry that is
    # on, made a call, raises it)
    shared = contextlib.nullcontext()

    def baseline(name):
        return shared

    def peak(make, calls):
        tracemalloc.start()
        try:
            tracemalloc.reset_peak()
            before = tracemalloc.get_traced_memory()[0]
            for _ in range(calls):
                with make("loop"):
                    pass
                profiling.count("loop")
            return tracemalloc.get_traced_memory()[1] - before
        finally:
            tracemalloc.stop()

    assert peak(profiling.span, 10_000) <= peak(baseline, 10_000)
    assert profiling.totals() == {}
    profiling.enable()
    assert peak(profiling.span, 10_000) > peak(baseline, 10_000)


def test_self_time_and_per_thread_stacks():
    profiling.enable()
    with profiling.span("outer"):
        time.sleep(0.01)
        with profiling.span("outer.inner"):
            time.sleep(0.02)
    profiling.count("things", 2)
    profiling.count("things")
    t = profiling.totals()
    out, inner = t["outer"], t["outer.inner"]
    assert out["n"] == inner["n"] == 1
    assert inner["total_s"] >= 0.02 and out["total_s"] >= 0.03
    assert out["self_s"] == pytest.approx(out["total_s"] - inner["total_s"],
                                          abs=1e-12)
    assert inner["self_s"] == inner["total_s"] == inner["max_s"]
    assert t["things"] == {"count": 3}

    # thread A holds "a" open while thread B opens and closes "b": with
    # one shared stack "b" would count as a child of "a"
    profiling.reset()
    opened, closed = threading.Event(), threading.Event()

    def thread_a():
        with profiling.span("a"):
            opened.set()
            assert closed.wait(10)

    def thread_b():
        assert opened.wait(10)
        with profiling.span("b"):
            time.sleep(0.02)
        closed.set()

    ta, tb = threading.Thread(target=thread_a), threading.Thread(
        target=thread_b)
    ta.start()
    tb.start()
    ta.join(10)
    tb.join(10)
    assert not ta.is_alive() and not tb.is_alive()
    t = profiling.totals()
    assert t["b"]["total_s"] >= 0.02
    assert t["a"]["total_s"] >= t["b"]["total_s"]
    assert t["a"]["self_s"] == t["a"]["total_s"]


@pytest.mark.parametrize("on", [True, False], ids=["registry_on",
                                                   "registry_off"])
def test_span_is_a_user_annotation_in_the_profiler_trace(tmp_path, on):
    if on:
        profiling.enable()
    x = torch.ones(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("tracing.test"):
            x.sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = [e for e in events if e.get("name") == "tracing.test"
           and e.get("cat") == "user_annotation"]
    assert len(ann) == 1
    t0, t1 = ann[0]["ts"], ann[0]["ts"] + ann[0]["dur"]
    ops = [e for e in events if e.get("name") == "aten::sum"
           and e.get("cat") == "cpu_op"]
    assert ops and all(t0 <= e["ts"] and e["ts"] + e["dur"] <= t1
                       for e in ops)
    # the registry records only while on
    assert ("tracing.test" in profiling.totals()) == on


def test_trace_records_spans_while_it_runs(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        assert profiling.enabled()
        with profiling.span("traced"):
            torch.ones(64).sum()
    assert not profiling.enabled()
    assert profiling.totals()["traced"]["n"] == 1
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())[
        "traceEvents"]
    assert any(e.get("name") == "traced"
               and e.get("cat") == "user_annotation" for e in events)


@pytest.fixture(scope="module")
def fit_problem(tmp_path_factory):
    rtc = write_cornell(tmp_path_factory.mktemp("tr"), xres=16, yres=12,
                        depth=3)
    ps = prepare(rtc, device="cpu")
    target = make_fused_path_renderer(ps.scene, ps.camera, **FIT)(5)
    ps = dataclasses.replace(ps, scene=dataclasses.replace(
        ps.scene, mat_diffuse=ps.scene.mat_diffuse * 0.8))
    return ps, target


def _fit(problem, steps=3):
    ps, target = problem
    return fit(ps, target, params=("mat_diffuse",), steps=steps, seed=11,
               **FIT)


def test_fit_spans_once_a_call_and_once_a_step(fit_problem):
    profiling.enable()
    _fit(fit_problem, steps=3)
    t = profiling.totals()
    assert t["fit"]["n"] == 1 and t["fit.setup"]["n"] == 1
    for name in ("fit.step", "fit.step.grad", "fit.step.update",
                 "fit.step.loss_read", "prb.table"):
        assert t[name]["n"] == 3, name
    step = t["fit.step"]
    parts = sum(t[f"fit.step.{k}"]["total_s"]
                for k in ("grad", "update", "loss_read"))
    assert step["self_s"] == pytest.approx(step["total_s"] - parts,
                                           abs=1e-9)
    assert t["fit"]["total_s"] >= t["fit.setup"]["total_s"] + \
        step["total_s"]


def test_fit_losses_are_the_same_with_spans_on_and_off(fit_problem):
    off = _fit(fit_problem).losses
    profiling.enable()
    on = _fit(fit_problem).losses
    assert on == off
    assert profiling.totals()["fit.step"]["n"] == 3


def test_fit_counts_one_id_check_a_job(fit_problem):
    profiling.enable()
    _fit(fit_problem, steps=3)
    t = profiling.totals()
    assert t["prb.id_check"] == {"count": 1}
    assert t["fit.step"]["n"] == 3
    # the CPU's plain versions give no early reading of the loss
    assert "fit.loss_event" not in t


class _Event:
    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


def test_fit_reads_a_loss_from_its_own_host_copy():
    """A loss that carries `host_copy` (a CUDA PRB step's) is read from
    that copy after its event, and counted; any other by float."""
    profiling.enable()
    value, done = torch.tensor(0.0), _Event()
    value.host_copy = (torch.tensor(1.5), done)
    assert _read_loss(value) == 1.5 and done.waits == 1
    assert _read_loss(torch.tensor(2.5)) == 2.5
    assert profiling.totals()["fit.loss_event"] == {"count": 1}


class _FakeLib:
    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append(name)
            return 0
        return fn


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["built", "cached"])
def test_kernel_load_counts(monkeypatch, compiled):
    built = []

    def fake_build(names):
        built.append(list(names))
        return {n: (1.0, "") for n in names} if compiled else {}

    calls = []
    monkeypatch.setattr(cuda_build, "build", fake_build)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL",
                        lambda path: _FakeLib(calls))
    k = cuda_build.CudaKernel("prb", "prb_fwd_ls_launch", [])
    profiling.enable()
    k.launch()
    k.launch()
    k._load()
    assert built == [["prb"]] and calls == ["prb_fwd_ls_launch"] * 2
    assert k.launches == 2
    t = profiling.totals()
    assert t["kernel.loaded"] == {"count": 1}
    assert t["kernel.load"]["n"] == 1
    assert t["kernel.first_launch"]["n"] == 1
    if compiled:
        assert t["kernel.built"] == {"count": 1}
    else:
        assert "kernel.built" not in t


def test_cli_stats_report_the_run_spans(tmp_path):
    rtc = write_cornell(tmp_path, xres=12, yres=8, depth=2)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main([str(rtc), "-o", str(tmp_path / "o.hdr"), "-p", "1",
                         "-l", "1", "--device", "cpu", "--stats"]) == 0
    rep = json.loads(err.getvalue().splitlines()[-1])
    assert rep["backend"] == "fused-kernel"
    spans = rep["spans"]
    for name in ("prepare", "prepare.load_scene", "prepare.accel",
                 "route.fused_path", "render.fused"):
        assert spans[name]["n"] == 1, name
    assert spans["prepare"]["total_s"] >= spans["prepare.accel"]["total_s"]
    # spans go off again after the run
    assert not profiling.enabled()
