"""CPU tests of the benchmark harness (pytest portbench/).

Each cell runs here at a tiny size through the program's CPU paths (the
kernels' plain versions); the arithmetic of the end-to-end and per-layer
metrics is checked on made-up windows and traces.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import tempfile
import sys
import time
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
import roofline  # noqa: E402
import windowstats  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# cells held back from BENCHMARK.json (portbench/held/<cell>.json)
HELD = sorted(p.stem for p in (HERE / "held").glob("*.json"))

# tiny shapes per loop: every cell's generator, route, loop and check run
TINY = {
    "render": dict(xres=16, yres=12, samples=2, max_depth=3,
                   check={"pixels": 48, "renders": 2}, profile_seconds=0.2),
    "fit": dict(xres=16, yres=12, samples=2, max_depth=3, steps=4,
                check={"steps": 3, "chunk_pixels": 64}, profile_seconds=0.2),
}


def tiny(cell: str) -> dict:
    return TINY[harness.Cell(cell).traffic["loop"]]


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


@pytest.mark.parametrize("cell", CELLS + HELD)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_tiny_on_cpu(cell, trace):
    res = harness.run_cell(cell, 2**31 + 12345, 0.05, trace, device="cpu",
                           traffic_overrides=tiny(cell))
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    want = {m["name"] for m in harness.Cell(cell).metrics(trace)}
    got = set(res["metrics"])
    assert got <= want
    if not trace:
        assert got == want            # every end-to-end metric is read
        assert res["metrics"]["setup_s"]["value"] > 0
    else:
        assert {"setup.prepare_s", "setup.route_s"} <= got
        assert res["device"]["window_s"] > 0
        assert "breakdown" in res


def test_every_listed_file_exists():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (HERE / f"{cfg['generator']['module']}.py").exists()
    for cell in CELLS:
        harness.Cell(cell)                # traffic, loop and limits found
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
        for w in m.get("workloads", []):
            assert w in CELLS


@pytest.mark.parametrize("cell", HELD)
def test_a_held_cell_is_out_of_the_benchmark(cell):
    # its entries are found beside BENCHMARK.json, not in it, and name
    # files that are there
    held = json.loads((HERE / "held" / f"{cell}.json").read_text())
    for group, entries in held.items():
        names = {e["name"] for e in BENCH[group]}
        assert not names & {e["name"] for e in entries}, group
    c = harness.Cell(cell)
    assert c.entry["name"] == cell and c.limits
    for cfg in held.get("configs", []):
        assert json.loads((ROOT / cfg["file"]).read_text())["name"] \
            == cfg["name"]
    for m in held.get("end_to_end", []) + held.get("per_layer", []):
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert m in c.metrics(m in held.get("per_layer", []))


def test_rate_keeps_a_stalled_unit():
    # nine renders of 0.1 s and one stalled for 2 s: the window is 2.9 s
    times = [0.1] * 9 + [2.0]
    assert windowstats.rate([10] * 10, sum(times)) == pytest.approx(
        100 / 2.9)


def test_roofline_arithmetic():
    counts = {"nearest": {"segments": 10, "box": 0, "tri": 10 * 36},
              "shadow": {"segments": 5, "box": 0, "tri": 5 * 36}}
    flops = 15 * 36 * 39
    assert roofline.megakernel_bound_s(counts, 0, 0) == pytest.approx(
        flops / 67e12)
    # bytes bound when they dominate
    assert roofline.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
    # a tree's slab tests count beside its triangle tests
    tree = {"nearest": {"segments": 4, "box": 100, "tri": 8},
            "shadow": {"segments": 2, "box": 50, "tri": 4}}
    assert roofline.megakernel_bound_s(tree, 0, 0) == pytest.approx(
        (150 * 12 + 12 * 39) / 67e12)
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(1.0, 0.0) is None


def test_device_trace_busy_and_gaps():
    ev = [{"name": devtrace.SLICE, "cat": "user_annotation", "ph": "X",
           "ts": 0.0, "dur": 1000.0},
          {"name": "k", "cat": "kernel", "ph": "X", "ts": 100.0, "dur": 200.0},
          {"name": "k", "cat": "kernel", "ph": "X", "ts": 250.0, "dur": 150.0},
          {"name": "copy", "cat": "gpu_memcpy", "ph": "X", "ts": 700.0,
           "dur": 100.0},
          {"name": "aten::sort", "cat": "cpu_op", "ph": "X", "ts": 450.0,
           "dur": 200.0}]
    tr = devtrace.DeviceTrace(ev)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(400e-6)     # [100, 400] + [700, 800]
    assert tr.top_ops()[0] == ["k", pytest.approx(350e-6)]
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::sort"] == pytest.approx(300e-6)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "orion_tpu_torch_fake",
                        types.ModuleType("orion_tpu_torch_fake"))
    monkeypatch.setitem(sys.modules, "jaxtyping_fake",
                        types.ModuleType("jaxtyping_fake"))
    base = set(harness.forbidden_modules())
    assert "orion_tpu" not in base or "orion_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "orion_tpu.engine",
                        types.ModuleType("orion_tpu.engine"))
    assert "orion_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness\n"
        "harness.run_cell('cornell.render-2048spp', 7, 0.0, False, "
        "device='cpu', traffic_overrides=%r)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(ROOT), str(HERE), TINY["render"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "orion_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "orion_tpu"}


LATE_IMPORT = ("import sys, types\n"
               "sys.modules.setdefault('jax', types.ModuleType('jax'))\n")


@pytest.mark.parametrize("where", ["metric_reader", "after_run_cell"])
def test_a_late_jax_import_exits_4(tmp_path, where):
    # a run that loads jax after the window's first look (in a metric
    # reader, or anywhere before the result is printed) exits 4 and prints
    # no result; run.py is driven with the card's checks answered yes and
    # the cell at a tiny size on the CPU
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if where == "metric_reader":
        (root / "portbench" / "metrics" / "late_import.py").write_text(
            LATE_IMPORT + "\n\ndef read(ctx):\n    return 1.0\n")
        bench["end_to_end"].append({
            "name": "late_import", "unit": "1", "better": "higher",
            "bound": 0.05, "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 1\n"
        "import harness, run\n"
        "orig = harness.run_cell\n"
        "def tiny(*a, **k):\n"
        "    out = orig(*a, **dict(k, device='cpu', traffic_overrides=%r))\n"
        "    if %r:\n"
        "        exec(%r)\n"
        "    return out\n"
        "harness.run_cell = tiny\n"
        "sys.exit(run.main(['--workload', 'cornell.render-2048spp', "
        "'--seed', '5', '--seconds', '0', '--trace', '0']))\n"
    ) % (str(ROOT), str(root / "portbench"), TINY["render"],
         where == "after_run_cell", LATE_IMPORT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 4, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "jax" in out.stderr.strip().splitlines()[-1]


def test_build_seconds_are_reported_apart(monkeypatch):
    import orion_tpu_torch.ops.cuda_build as cb

    def slow_build(names):
        time.sleep(0.05)
        return {n: (0.05, "") for n in names}

    monkeypatch.setattr(cb, "build", slow_build)
    clock = harness.BuildClock()
    clock.install()
    try:
        cb.build(["fused_path"])
        cb.build([])                      # nothing compiled: not counted
    finally:
        clock.uninstall()
    assert cb.build is slow_build
    assert clock.compiled == ["fused_path"]
    assert clock.seconds >= 0.05
    res = harness.run_cell("cornell.render-2048spp", 6, 0.0, False,
                           device="cpu", traffic_overrides=TINY["render"])
    assert list(res)[-2:] == ["build", "checks"]
    assert res["build"]["seconds"] <= res["metrics"]["setup_s"]["value"]


def test_new_files_are_found_without_editing_code(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "cornell.json").read_text())
    cfg.update(name="cornell-l1", triangles=34 * 4 + 2)
    cfg["generator"]["args"] = {"levels": 1}
    cfg["reference_accel"] = "tree"
    (pb / "configs" / "cornell-l1.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "render-tiny.json").write_text(json.dumps(dict(
        loop="render", light_samples=2, warmup_samples=None,
        **TINY["render"])))
    (pb / "cells" / "cornell-l1.render-tiny.json").write_text(
        json.dumps({"limits": {"bad_px": 0.05}}))
    (pb / "metrics" / "renders_done.py").write_text(
        "def read(ctx):\n    return ctx['window'].attempted\n")
    bench["configs"].append({"name": "cornell-l1", "source": "x",
                             "file": "portbench/configs/cornell-l1.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "cornell-l1.render-tiny",
                               "config": "cornell-l1",
                               "traffic": "render-tiny", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "renders_done", "unit": "renders",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["cornell-l1.render-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = harness.run_cell("cornell-l1.render-tiny", 3, 0.05, False,
                           device="cpu", root=root)
    assert res["correct"], res["checks"]
    assert res["metrics"]["renders_done"]["value"] == res["attempted"]
    assert "render_samples_per_s" not in res["metrics"]   # not listed there


def test_no_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cornell.render-2048spp", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # a checkout of the benchmark's files alone has no program to run
    only = tmp_path / "only"
    shutil.copytree(HERE, only / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", only)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cornell.render-2048spp", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=only)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_runs_on_the_card(cuda_device):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cornell.fit-1080p", "--seed", str(2**31 + 99), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_percentile_is_the_nearest_rank():
    xs = list(range(1, 101))                  # 1..100
    assert windowstats.percentile(xs, 95) == 95.0
    assert windowstats.percentile(reversed(xs), 50) == 50.0
    assert windowstats.percentile([3.0], 95) == 3.0
    assert windowstats.percentile([1.0, 2.0], 95) == 2.0


def test_reservoir_keeps_the_least_keys():
    import numpy as np

    loop = harness.load_module(HERE / "loops" / "render.py", "loop")
    n_units = 12305
    res = loop.Reservoir(2**31 + 99, 2)
    for u in range(n_units):
        res.offer(u, f"img{u}")
    keys = np.random.default_rng([2**31 + 99, 2]).random(n_units)
    want = sorted(np.argsort(keys)[:2].tolist())
    assert sorted(res.kept) == want
    assert {u: img for u, (_, img) in res.kept.items()} == {
        u: f"img{u}" for u in want}


def _render_window(cell, seed, seconds, online=False):
    light = dict(TINY["render"], xres=8, yres=6, samples=1, max_depth=1,
                 check={"pixels": 48, "renders": 2, "online": online})
    ctx = harness.Context(harness.Cell(cell), dict(
        harness.Cell(cell).traffic, **light), seed, "cpu",
        Path(tempfile.mkdtemp(prefix="portbench-test-")))
    loop = harness.load_module(ctx.cell.loop_path, "loop").Loop(ctx)
    loop.setup()
    return loop.run(seconds)


def test_render_loop_checks_the_renders_it_always_did():
    # without check.online the renders are drawn once the window has
    # closed, from the seed's stream [seed, 1], as they always were
    import numpy as np

    seed = 2**31 + 77
    win = _render_window("cornell.render-2048spp", seed, 0.5)
    assert win.attempted >= 3
    want = sorted(np.random.default_rng([seed, 1]).choice(
        win.attempted, 2, replace=False).tolist())
    assert sorted(win.chosen) == want


def test_online_render_loop_keeps_two_images():
    seed = 2**31 + 78
    win = _render_window("cornell.render-2048spp", seed, 0.5,
                         online=True)
    assert win.attempted >= 3 and len(win.chosen) == 2
    assert all(v.shape == (48, 3) for v in win.chosen.values())
    assert win.check()["numbers"]["bad_px"] == 0.0


def test_whitted_readers_on_a_made_up_trace():
    ev = [{"name": devtrace.SLICE, "cat": "user_annotation", "ph": "X",
           "ts": 0.0, "dur": 1000.0},
          {"name": "whitted_kernel(WhittedParams, int, int*)",
           "cat": "kernel", "ph": "X", "ts": 100.0, "dur": 20.0},
          {"name": "whitted_kernel(WhittedParams, int, int*)",
           "cat": "kernel", "ph": "X", "ts": 600.0, "dur": 20.0},
          {"name": "bvh_whitted_kernel(P)", "cat": "kernel", "ph": "X",
           "ts": 300.0, "dur": 100.0},
          {"name": "Memcpy DtoH", "cat": "gpu_memcpy", "ph": "X",
           "ts": 120.0, "dur": 80.0}]
    tr = devtrace.DeviceTrace(ev)
    win = types.SimpleNamespace(samples_per_unit=1, attempted=2,
                                times=[1e-3, 2e-3])
    counts = {"nearest": {"segments": 10, "box": 0, "tri": 360},
              "shadow": {"segments": 4, "box": 0, "tri": 30}}
    ctx = {"trace": tr, "window": win, "counts": counts,
           "sizes": {"input_bytes": 0, "output_bytes": 0}}

    def read(name):
        return harness.load_module(HERE / "metrics" / f"{name}.py",
                                   "metric").read(ctx)

    # 2 renders of 390 tests each over kernel 4's 40 us
    assert read("k4_roofline") == pytest.approx(
        100 * 2 * 390 * 39 / 67e12 / 40e-6)
    assert read("idle_pct.whitted") == pytest.approx(100 * (1 - 220 / 1000))
    assert read("idle_pct.render") == read("idle_pct.whitted")
    assert read("render_ms_p95") == pytest.approx(2.0)
    fit = {"trace": tr, "window": types.SimpleNamespace(
        attempted=1, steps=[3], samples_per_step=1)}
    for name in ("k4_roofline", "idle_pct.whitted", "render_ms_p95"):
        mod = harness.load_module(HERE / "metrics" / f"{name}.py", "metric")
        assert mod.read(fit) is None
    train = harness.load_module(HERE / "metrics" / "idle_pct.train.py",
                                "metric")
    assert train.read(fit) == pytest.approx(100 * (1 - 220 / 1000))
    assert train.read(ctx) is None
