"""One run of one cell: set-up, the measured window (or the traced slice),
the check against the plain reference, and the result.

Everything that belongs to one configuration, traffic mix, loop or
metric is a file found by its name:
  - BENCHMARK.json (at the checkout's root) lists the cells and metrics;
  - a configuration is the JSON file its entry names (scene generator and
    its arguments, the reference's nearest-hit search);
  - a traffic mix is portbench/traffic/<traffic>.json (render or fit
    settings, the loop that drives them, what the check samples);
  - a loop is portbench/loops/<loop>.py (class Loop);
  - a cell's limits are portbench/cells/<cell>.json;
  - a metric is portbench/metrics/<name>.py (read(ctx) -> number | None);
  - a cell held back from BENCHMARK.json keeps its entries (configs,
    workloads, metrics) in portbench/held/<cell>.json: it runs by hand
    and in the tests, and no check of the benchmark runs it.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import devtrace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "orion_tpu")


class ForbiddenModules(RuntimeError):
    """A module of JAX or of the JAX package is loaded in this process."""


def load_module(path: Path, prefix: str):
    """Import the Python file at `path` under a name of its own."""
    name = f"_portbench_{prefix}_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def assert_no_forbidden(when: str):
    """Raise ForbiddenModules if a forbidden module is loaded."""
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(f"loaded {when}: " + ", ".join(bad))


class BuildClock:
    """Host seconds the program spends compiling its kernels in this run,
    and what it compiled: its nvcc builds (ops/cuda_build.build) and its
    g++ build of the native library (native._try_build) are timed where
    the program calls them. Only a checkout's first run of a cell compiles;
    the seconds are inside setup_s as well, reported apart beside it."""

    HOOKS = (("orion_tpu_torch.ops.cuda_build", "build"),
             ("orion_tpu_torch.native", "_try_build"))

    def __init__(self):
        self.seconds = 0.0
        self.compiled = []
        self.watched = []
        self._restore = []

    def install(self):
        for modname, attr in self.HOOKS:
            try:
                mod = importlib.import_module(modname)
                orig = getattr(mod, attr)
            except (ImportError, AttributeError):
                continue
            setattr(mod, attr, self._timed(orig, modname, attr))
            self._restore.append((mod, attr, orig))
            self.watched.append(f"{modname}.{attr}")

    def uninstall(self):
        for mod, attr, orig in self._restore:
            setattr(mod, attr, orig)
        self._restore = []

    def _timed(self, orig, modname, attr):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            dt = time.perf_counter() - t0
            if attr == "build":
                built = sorted(out)          # {name: ...} of what compiled
            else:
                built = ["native"] if out else []
            if built:
                self.seconds += dt
                self.compiled += built
            return out
        return timed

    def report(self) -> dict:
        return {"seconds": self.seconds, "compiled": self.compiled}


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """A workload of BENCHMARK.json, or one held back from it, with its
    configuration, traffic and limits, read from the files under `root`."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        held = self.root / "portbench" / "held" / f"{name}.json"
        if name not in cells and held.is_file():
            for group, entries in json.loads(held.read_text()).items():
                self.bench[group] = self.bench[group] + entries
            cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        cfg = {c["name"]: c for c in self.bench["configs"]}[
            self.entry["config"]]
        self.config = json.loads((self.root / cfg["file"]).read_text())
        pb = self.root / "portbench"
        self.traffic = json.loads(
            (pb / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads(
            (pb / "cells" / f"{name}.json").read_text())["limits"]
        self.loop_path = pb / "loops" / f"{self.traffic['loop']}.py"
        self.metrics_dir = pb / "metrics"
        self.chips = int(self.entry["chips"])

    def metrics(self, trace: bool) -> list:
        group = self.bench["per_layer"] if trace else self.bench["end_to_end"]
        return [m for m in group if applies(m, self.name)]


class Context:
    """What a loop is handed: the cell's files, the run's seed, device and
    scratch directory, and the set-up spans it records."""

    def __init__(self, cell: Cell, traffic: dict, seed: int, device: str,
                 tmp: Path):
        self.cell, self.config, self.traffic = cell, cell.config, traffic
        self.seed = int(seed)
        self.device = device
        self.tmp = tmp
        self.spans = {}

    @contextlib.contextmanager
    def span(self, name: str):
        """Host seconds of a block, synchronised with the device at both
        ends, added under `name`."""
        self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.spans[name] = (self.spans.get(name, 0.0)
                                + time.perf_counter() - t0)

    def sync(self):
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def write_scene(self, **settings) -> Path:
        """The configuration's scene files, written by its generator into
        the run's scratch directory with the traffic's render settings;
        returns the .rtc path."""
        gen = self.config["generator"]
        mod = load_module(self.cell.root / "portbench" / f"{gen['module']}.py",
                          "gen")
        args = dict(gen.get("args", {}), **settings)
        return getattr(mod, gen["function"])(self.tmp / "scene", **args)

    def log(self, msg: str):
        print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def route(ps, *, samples: int, max_depth: int, light_samples: int | None):
    """(fn(seed) -> [H, W, 3], backend) of a scene, picked as cli.main
    picks its megakernel route (a copy of its two branches): for a scene
    with rtc point lights the Whitted megakernels in
    engine.make_whitted_megakernel's order; else the fused path kernel
    inside its gate, then the big-path chain. Raises ValueError for a
    scene outside every megakernel gate."""
    from orion_tpu_torch.engine import (make_big_path_renderer,
                                        make_whitted_megakernel)
    from orion_tpu_torch.ops.fused_path import (fused_path_supported,
                                                make_fused_path_renderer)

    if ps.scene.num_lights > 0:
        return make_whitted_megakernel(ps.scene, ps.camera, samples=samples,
                                       max_depth=max_depth,
                                       strategy=ps.strategy,
                                       order_signs=ps.order_signs)
    if fused_path_supported(ps.scene):
        return (make_fused_path_renderer(ps.scene, ps.camera, samples=samples,
                                         max_depth=max_depth,
                                         light_samples=light_samples),
                "fused-kernel")
    return make_big_path_renderer(ps.scene, ps.camera, samples=samples,
                                  max_depth=max_depth,
                                  light_samples=light_samples,
                                  strategy=ps.strategy,
                                  order_signs=ps.order_signs)


def read_metrics(cell: Cell, trace: bool, ctx: dict) -> dict:
    out = {}
    for m in cell.metrics(trace):
        mod = load_module(cell.metrics_dir / f"{m['name']}.py", "metric")
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: Path = ROOT,
             traffic_overrides: dict | None = None,
             t_start: float | None = None) -> dict:
    """One run of the cell `name`. Returns the result line as a dict, with
    "checks" ({name: {"value", "limit"}}) last and "build" (the set-up's
    compile seconds) before it. Raises ForbiddenModules when a module of
    JAX or the JAX package is loaded once the window has closed, or by the
    check or a metric reader."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(name, root)
    traffic = dict(cell.traffic, **(traffic_overrides or {}))
    cuda = device == "cuda"
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        ctx = Context(cell, traffic, seed, device, tmp)
        builds = BuildClock()
        builds.install()
        loop = load_module(cell.loop_path, "loop").Loop(ctx)
        t_loop = time.perf_counter()
        try:
            loop.setup()
        finally:
            builds.uninstall()
        ctx.sync()
        setup_s = time.perf_counter() - t_start
        ctx.log(f"set-up {setup_s:.3f} s: before the loop's set-up "
                f"{t_loop - t_start:.3f} s, spans " + ", ".join(
                    f"{k} {v:.3f} s" for k, v in ctx.spans.items()))
        ctx.log(f"build {builds.seconds:.3f} s of the set-up, compiled: "
                f"{', '.join(builds.compiled) or 'nothing'} (timed at "
                f"{', '.join(builds.watched) or 'no hook found'})")
        dtrace = None
        # the interpreter's cyclic collector stays off in the window, as
        # timeit keeps it: a collection lands in one render or another
        gc.collect()
        gc.disable()
        try:
            if trace:
                win, dtrace = devtrace.profiled(
                    lambda: loop.run(min(seconds, traffic["profile_seconds"])),
                    tmp, cuda)
            else:
                win = loop.run(seconds)
        finally:
            gc.enable()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        assert_no_forbidden("once the window closed")
        for k, v in win.summary().items():
            ctx.log(f"{k}: {v}")
        loop.free()
        del loop
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        check = win.check()
        ctx.log(f"check took {time.perf_counter() - t_check:.3f} s")
        mctx = dict(window=win, setup_s=setup_s, spans=ctx.spans,
                    trace=dtrace, counts=check["counts_per_unit"],
                    sizes=check["sizes"], traffic=traffic)
        metrics = read_metrics(cell, trace, mctx)
        checks = {k: {"value": float(v), "limit": float(cell.limits[k])}
                  for k, v in check["numbers"].items()}
        correct = (win.failed == 0
                   and all(c["value"] <= c["limit"] for c in checks.values()))
        if cuda:
            dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
        else:
            dev = {"platform": "cpu", "kind": "cpu", "count": 1,
                   "memory_peak_bytes": 0}
        result = {"correct": bool(correct), "attempted": win.attempted,
                  "failed": win.failed, "metrics": metrics, "device": dev}
        if trace:
            dev["busy_s"] = dtrace.busy_s
            dev["window_s"] = dtrace.window_s
            result["breakdown"] = {"device_ops": dtrace.top_ops(),
                                   "idle_gaps": dtrace.idle_gaps()}
        result["build"] = builds.report()
        result["checks"] = checks
        # the check and the metric readers ran after the first look
        assert_no_forbidden("by the check or a metric reader")
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
