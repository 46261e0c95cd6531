"""The bounce pipeline's walk and shade kernels (6a, 6c) measured on the card.

    python3 tools/bounce_probe.py [--sweep] [--no-train]
    python3 tools/bounce_probe.py --phase11 [--checks]
    python3 tools/bounce_probe.py --vis [--sweep] [--root CHECKOUT]

At chip_smoke.py phase 11's shapes (the levels-5 subdivided Cornell box,
`write_cornell(levels=5)`, 34,818 triangles; 1920x1080, 16 spp, depth 8,
2 light samples; seed 0) the probe prints:

- the resources of every kernel of `csrc/bounce.cu` as the port builds it
  (ops/cuda_build.NVCC_FLAGS): ptxas's registers, spill and stack lines,
  and what the built kernel reports (`bounce_info`: cudaFuncGetAttributes
  and the resident blocks of 128 threads an SM);
- per bounce, the live lanes and the CUDA-event times of 6a and 6c
  (the median over REPS renders after a warm-up) and their sums;
- the counters of a second build made with -DORION_BOUNCE_COUNTERS
  (never made by the port's build), read after every launch of one
  render: for 6a the rays, node steps and Woop tests a ray and the node
  loop's SIMT efficiency (active lanes per warp iteration / 32); for 6c
  the split of a thread's clock64() cycles among the frame and light
  draws, the shadow walk and the rest, the share of lanes whose two light
  draws need a
  shadow walk, the active lanes of a warp where it enters the walk, and
  the shadow walk's SIMT efficiency, node steps and Woop tests a pair,
  and the render's bounds of 6a, 6b and 6c summed over its bounces;
- the closed-form bounce train step (`make_bounce_train_step`) at phase 11
  (c)'s shapes (1920x1080, 4 spp, depth 8, red wall x 0.6, seed 3): its
  CUDA-event time split into the forward with dumps, the adjoints and the
  rest (--no-train skips it);
- with --sweep, 6a's and 6c's summed times a render of builds of copies
  of `csrc/bounce.cu` in which one of SWEEP's constants is set to each of
  its values (the resident blocks an SM each kernel is built for, the
  active lanes below which a warp refills, the node steps between two
  refill votes), the others at the source's values.

--vis probes the visibility kernel (6b) instead, at the same shapes on
the `split_vis` pipeline: its resources; per bounce the lanes and the
CUDA-event times of 6b and of 6c given its planes, beside the fused 6c's
(the default pipeline's), with their sums and depth 0; the shadow-walk
counters of the instrumented build read after every 6b launch (the share
of lanes that walk a shadow pair, the active lanes of a warp where it
enters the walk, the walk loop's SIMT efficiency, node steps and Woop
tests a pair) and 6b's bounds a bounce; with --sweep, builds of copies
with VIS_SWEEP's constants (those the source defines) set to each value.
--root CHECKOUT probes another checkout's package and kernels (first on
sys.path; the harness is this tree's chip_smoke.py).

--phase11 runs chip_smoke.py's phase 11 alone instead (--checks first runs
phase 3's 64x64 checks of the three kernels). The card's name and power
limit and its SM clock come first. The instrumented kernels are slower
than the port's (clock64() and atomics): their counters give shares and
ratios, their times are not the kernels'.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402,F401  (this tree's harness, also with --root)
from cornell_scenes import write_cornell  # noqa: E402
from tools.ab_turns import (TRAIN_SEED, card,  # noqa: E402
                             red_wall_problem, with_constant)

SEED = 0
REPS = 5
# constexpr ints of csrc/bounce.cu and the values --sweep builds
SWEEP = {"kWalkBlocks": (10, 12),
         "kWalkRefill": (8, 16, 24),
         "kWalkSteps": (16, 32, 64),
         "kShadeBlocks": (8, 10, 12)}
# constexpr ints of csrc/bounce.cu's vis kernel and the values --vis
# --sweep builds (a constant the source does not define is left out)
VIS_SWEEP = {"kVisBlocks": (7, 8, 9, 10, 12),
             "kVisRefill": (8, 12, 16, 24),
             "kVisSteps": (16, 32, 64)}
# bounce_info's kernels: (which, name, a string of the mangled name)
KERNELS = ((0, "6a walk", "bounce_walk_kernel", ()),
           (1, "6c shade <aux 0, vis 0>", "bounce_shade_kernel", ("Lb0ELb0E",)),
           (2, "6c shade <aux 0, vis 1>", "bounce_shade_kernel", ("Lb0ELb1E",)),
           (3, "6c shade <aux 1, vis 0>", "bounce_shade_kernel", ("Lb1ELb0E",)),
           (4, "6c shade <aux 1, vis 1>", "bounce_shade_kernel", ("Lb1ELb1E",)),
           (5, "6b vis", "bounce_vis_kernel", ()),
           (6, "6b draw", "bounce_draw_kernel", ()))
# g_bounce_counters, in csrc/bounce.cu's order
COUNTERS = ("walk_rays", "walk_steps", "walk_tests", "walk_iters",
            "walk_iter_lanes", "walk_warps", "shade_lanes", "shade_cycles",
            "draw_cycles",
            "shadow_cycles", "shadow_rays", "shadow_entries",
            "shadow_entry_lanes", "shadow_iters", "shadow_iter_lanes",
            "shadow_steps", "shadow_tests", "shade_warps")
FWD_STAGES = ("primaries", "walk", "texels", "vis", "shade", "sort")


# ---------------------------------------------------------------------------
# the host arithmetic (tests/test_torch_bounce_probe.py)
# ---------------------------------------------------------------------------

def _ratio(a, b) -> float:
    return a / b if b else 0.0


def walk_report(c: dict) -> dict:
    """6a's counters as a ray's mean node steps and Woop tests and the
    node loop's SIMT efficiency: active lanes summed over the warp's loop
    iterations / (32 x iterations)."""
    return dict(rays=c["walk_rays"],
                steps=_ratio(c["walk_steps"], c["walk_rays"]),
                tests=_ratio(c["walk_tests"], c["walk_rays"]),
                simt=_ratio(c["walk_iter_lanes"], 32 * c["walk_iters"]))


def shade_report(c: dict) -> dict:
    """6c's counters as shares of a thread's cycles (frame and light draws,
    shadow walk, the rest), the share of lanes with a shadow walk, the
    active lanes of a warp's entry into the walk / 32, the walk loop's SIMT
    efficiency, and a pair's node steps and Woop tests."""
    cyc = c["shade_cycles"]
    draw = _ratio(c["draw_cycles"], cyc)
    shadow = _ratio(c["shadow_cycles"], cyc)
    return dict(lanes=c["shade_lanes"], draw=draw, shadow=shadow,
                rest=1.0 - draw - shadow if cyc else 0.0,
                walked=_ratio(c["shadow_rays"], c["shade_lanes"]),
                entry=_ratio(c["shadow_entry_lanes"],
                             32 * c["shadow_entries"]),
                simt=_ratio(c["shadow_iter_lanes"], 32 * c["shadow_iters"]),
                steps=_ratio(c["shadow_steps"], c["shadow_rays"]),
                tests=_ratio(c["shadow_tests"], c["shadow_rays"]))


def vis_report(c: dict, lanes: int) -> dict:
    """6b's shadow-walk counters over `lanes` lanes as the share of lanes
    that walk a pair, the active lanes of a warp's entry into the walk /
    32, the walk loop's SIMT efficiency, and a pair's node steps and Woop
    tests."""
    return dict(lanes=lanes, walked=_ratio(c["shadow_rays"], lanes),
                entry=_ratio(c["shadow_entry_lanes"],
                             32 * c["shadow_entries"]),
                simt=_ratio(c["shadow_iter_lanes"], 32 * c["shadow_iters"]),
                steps=_ratio(c["shadow_steps"], c["shadow_rays"]),
                tests=_ratio(c["shadow_tests"], c["shadow_rays"]))


def vis_bounds(rows, lanes, tree_bytes: int) -> list:
    """6b's bound a bounce in ms (chip_smoke.bound_ms): its pairs' node
    steps (12 operations each) and Woop tests (39) from the counters,
    against the state rows read (9), the hitdata rows read (5) and the
    planes written (8) a lane, and the tree and the table once."""
    from chip_smoke import SLAB_TEST_FLOPS, WOOP_TEST_FLOPS, bound_ms

    return [bound_ms(c["shadow_steps"] * SLAB_TEST_FLOPS
                     + c["shadow_tests"] * WOOP_TEST_FLOPS,
                     n * (9 + 5 + 8) * 4 + tree_bytes)[0]
            for c, n in zip(rows, lanes)]


def vis_lines(split: dict, fused: dict) -> list:
    """A table of lanes, 6b, 6c given its planes and the fused 6c's ms per
    depth, then their sums and vis + shade-given-vis against the fused
    shade, a render and at depth 0."""
    depths = sorted(d for (s, d) in split if s == "vis")
    lines = ["depth | lanes | 6b vis ms | 6c given vis ms | fused 6c ms"]
    tot = [0.0, 0.0, 0.0]
    for d in depths:
        row = (split[("vis", d)][1], split[("shade", d)][1],
               fused[("shade", d)][1])
        tot = [a + b for a, b in zip(tot, row)]
        lines.append(f"{d} | {split[('vis', d)][0]} | "
                     + " | ".join(f"{x:.3f}" for x in row))
    lanes = sum(split[("vis", d)][0] for d in depths)
    lines.append(f"sum | {lanes} | " + " | ".join(f"{x:.3f}" for x in tot))
    d0 = (split[("vis", 0)][1] + split[("shade", 0)][1],
          fused[("shade", 0)][1])
    lines.append(f"vis + shade given vis {tot[0] + tot[1]:.3f} ms against "
                 f"the fused shade {tot[2]:.3f} a render; depth 0 "
                 f"{d0[0]:.3f} against {d0[1]:.3f}")
    return lines


def add_counters(rows) -> dict:
    """The sum of per-launch counter dicts."""
    out = dict.fromkeys(COUNTERS, 0)
    for c in rows:
        for k in COUNTERS:
            out[k] += c[k]
    return out


def stage_medians(runs) -> dict:
    """{(stage, depth): (lanes, median ms)} over runs of a pipeline's
    timing records, each a list of (stage, depth, lanes, ms)."""
    acc = {}
    for run in runs:
        for stage, depth, n, ms in run:
            acc.setdefault((stage, depth), (n, []))[1].append(ms)
    return {k: (n, statistics.median(v)) for k, (n, v) in acc.items()}


def per_bounce_lines(stages: dict) -> list:
    """A table of lanes, 6a and 6c ms per depth, then their sums."""
    depths = sorted(d for (s, d) in stages if s == "walk")
    lines = ["depth | lanes | 6a walk ms | 6c shade ms"]
    tw = ts = 0.0
    for d in depths:
        n, w = stages[("walk", d)]
        s = stages[("shade", d)][1]
        tw, ts = tw + w, ts + s
        lines.append(f"{d} | {n} | {w:.3f} | {s:.3f}")
    lanes = sum(stages[("walk", d)][0] for d in depths)
    lines.append(f"sum | {lanes} | {tw:.3f} | {ts:.3f}")
    return lines


def step_split(stages: dict, step_ms: float) -> dict:
    """A train step's time as the forward with dumps (the pipeline's
    stages), the adjoints and the rest (cotangent, table, realignment)."""
    fwd = sum(ms for (s, _), (_, ms) in stages.items() if s in FWD_STAGES)
    adj = sum(ms for (s, _), (_, ms) in stages.items() if s == "adjoints")
    return dict(step=step_ms, forward=fwd, adjoints=adj,
                rest=step_ms - fwd - adj)


def render_bounds(walks, shades, lanes, tree_bytes: int) -> dict:
    """The least time a render's launches of 6a, 6b and 6c could take, in
    ms, summed over the bounces: per launch the larger of its bytes over
    the card's memory rate and its operations over its FP32 rate
    (chip_smoke.bound_ms). Bytes as chip_smoke.py phase 11 counts them for
    depth 0 (state and hitdata rows a lane, the tree and the table once);
    operations from the counters of the instrumented build: a node step
    12 (one slab test; a pair's second is not counted) and a Woop test 39.
    6b walks 6c's shadow pairs."""
    from chip_smoke import SLAB_TEST_FLOPS, WOOP_TEST_FLOPS, bound_ms

    out = dict(walk=0.0, vis=0.0, shade=0.0)
    for w, sh, n in zip(walks, shades, lanes):
        shadow = (sh["shadow_steps"] * SLAB_TEST_FLOPS
                  + sh["shadow_tests"] * WOOP_TEST_FLOPS)
        out["walk"] += bound_ms(w["walk_steps"] * SLAB_TEST_FLOPS
                                + w["walk_tests"] * WOOP_TEST_FLOPS,
                                n * (7 + 8) * 4 + tree_bytes)[0]
        out["vis"] += bound_ms(shadow, n * (9 + 5 + 8) * 4 + tree_bytes)[0]
        out["shade"] += bound_ms(shadow, n * (16 + 14 + 5) * 4
                                 + tree_bytes)[0]
    return out


def _fmt(d: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in d.items())


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _builds(tmp: Path, sweep: bool, constants=None) -> dict:
    """{tag: (library path, nvcc's report)}: the port's source and flags,
    the counters, and with `sweep` copies of the source with the values
    of `constants` (SWEEP's by default; a constant the source does not
    define is left out); one nvcc each, all together. The source is the
    package's that `orion_tpu_torch` imports from (--root's)."""
    from orion_tpu_torch.ops import cuda_build
    from tools.path_probe import _nvcc

    src = (cuda_build.CSRC / "bounce.cu").read_text()
    jobs = {"port": ("bounce", ()),
            "counters": ("bounce", ("-DORION_BOUNCE_COUNTERS",))}
    if sweep:
        for name, values in (SWEEP if constants is None
                             else constants).items():
            if f"constexpr int {name} = " not in src:
                continue
            for v in values:
                cu = tmp / f"bounce_{name}_{v}.cu"
                cu.write_text(with_constant(src, name, v))
                jobs[f"{name}={v}"] = (cu, ())
    out = {}

    def one(item):
        tag, (cu, defines) = item
        so = tmp / f"bounce_{tag.replace('=', '_')}.so"
        return tag, so, _nvcc(cu, so, defines)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for tag, so, log in pool.map(one, jobs.items()):
            out[tag] = (so, log)
    return out


class _Swap:
    """The pipeline's kernels of `kinds` ("walk", "vis", "shade") launched
    from another build of bounce.cu (same launch counts); `after(kind)`
    runs after each launch, once the card is done with it."""

    def __init__(self, lib, after=None, kinds=("walk", "shade")):
        self.lib, self.after, self.kinds = lib, after, kinds

    def _kernels(self):
        from orion_tpu_torch.ops import bounce as bo

        return {"walk": bo.WALK_KERNEL, "vis": bo.VIS_KERNEL,
                "shade": bo.SHADE_KERNEL}

    def __enter__(self):
        import torch

        ks = self._kernels()
        self.real = {kind: ks[kind]._fn for kind in self.kinds}
        for kind in self.kinds:
            k = ks[kind]
            k._load()
            fn = getattr(self.lib, k.symbol)
            fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
            if self.after is None:
                k._fn = fn
                continue

            def hooked(*args, fn=fn, kind=kind):
                rc = fn(*args)
                torch.cuda.synchronize()
                self.after(kind)
                return rc

            k._fn = hooked
        return self

    def __exit__(self, *exc):
        ks = self._kernels()
        for kind, fn in self.real.items():
            ks[kind]._fn = fn


def _render_stages(fn, reps: int = REPS) -> tuple:
    """({(stage, depth): (lanes, median ms)}, [whole render ms]) over
    `reps` renders of seed SEED after one warm-up."""
    import torch

    fn(SEED)
    runs, whole = [], []
    for _ in range(reps):
        timings = []
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(SEED, timings=timings)
        b.record()
        torch.cuda.synchronize()
        whole.append(a.elapsed_time(b))
        runs.append([(s, d, n, x.elapsed_time(y))
                     for s, d, n, x, y in timings])
    return stage_medians(runs), whole


def _resources(builds: dict) -> None:
    from tools.path_probe import _ptxas_lines

    so, log = builds["port"]
    lib = ctypes.CDLL(str(so))
    for which, name, kernel, also in KERNELS:
        for line in _ptxas_lines(log, kernel, *also):
            print(f"[{name}] ptxas: {line}")
        out = (ctypes.c_int * 4)()
        rc = lib.bounce_info(which, out)
        print(f"[{name}] built kernel: {out[1]} registers, {out[2]} B local "
              f"(spill and stack) a thread, {out[3]} B static shared; "
              f"{out[0]} resident blocks of 128 threads an SM (rc {rc})")


def _counters(fn, so: Path, lanes) -> None:
    """One render on the instrumented build, its counters read after
    every walk and shade launch; with the lanes of each bounce, the
    render's bounds."""
    lib = ctypes.CDLL(str(so))
    if lib.bounce_counters_reset() != 0:
        raise RuntimeError("bounce_counters_reset failed")
    rows = {"walk": [], "shade": []}

    def after(kind):
        buf = (ctypes.c_ulonglong * len(COUNTERS))()
        if lib.bounce_counters_read(buf) != 0:
            raise RuntimeError("bounce_counters_read failed")
        rows[kind].append(dict(zip(COUNTERS, buf)))
        lib.bounce_counters_reset()

    with _Swap(lib, after):
        fn(SEED)
    for d, (w, s) in enumerate(zip(rows["walk"], rows["shade"])):
        print(f"[counters depth {d}] 6a: {_fmt(walk_report(w))}")
        print(f"[counters depth {d}] 6c: {_fmt(shade_report(s))}")
    print(f"[counters render] 6a: "
          f"{_fmt(walk_report(add_counters(rows['walk'])))}")
    print(f"[counters render] 6c: "
          f"{_fmt(shade_report(add_counters(rows['shade'])))}")
    print(f"[counters render] raw 6a {add_counters(rows['walk'])}")
    print(f"[counters render] raw 6c {add_counters(rows['shade'])}")
    data = fn.ctx["data"]
    tree_bytes = (data.nodes.numel() + data.tab.numel()) * 4
    b = render_bounds(rows["walk"], rows["shade"], lanes, tree_bytes)
    b0 = render_bounds(rows["walk"][:1], rows["shade"][:1], lanes[:1],
                       tree_bytes)
    print(f"[bounds] a render: 6a {b['walk']:.4f} ms, 6b {b['vis']:.4f}, "
          f"6c {b['shade']:.4f}; depth 0: 6a {b0['walk']:.4f}, 6b "
          f"{b0['vis']:.4f}, 6c {b0['shade']:.4f}")


def _sweep(fn, builds: dict) -> None:
    from tools.path_probe import _ptxas_lines

    for tag, (so, log) in builds.items():
        if tag in ("port", "counters"):
            continue
        with _Swap(ctypes.CDLL(str(so))):
            stages, whole = _render_stages(fn)
        w = sum(ms for (s, _), (_, ms) in stages.items() if s == "walk")
        sh = sum(ms for (s, _), (_, ms) in stages.items() if s == "shade")
        regs = [f"{name}: {' / '.join(_ptxas_lines(log, kernel, *also)[1:])}"
                for which, name, kernel, also in KERNELS[:2]]
        print(f"[sweep {tag}] 6a {w:.3f} ms, 6c {sh:.3f} ms a render; "
              f"depth 0 6a {stages[('walk', 0)][1]:.3f}, 6c "
              f"{stages[('shade', 0)][1]:.3f} ms; render "
              f"{statistics.median(whole):.3f} ms; ptxas {'; '.join(regs)}",
              flush=True)


def _train(tmp: Path, dev, lv5_rtc: Path) -> None:
    import torch

    from chip_smoke import TRAIN, event_ms
    from orion_tpu_torch.ops import bounce as bo
    from orion_tpu_torch.ops import bounce_prb as bpr

    pr = red_wall_problem(lv5_rtc, dev, bo.make_bounce_path_renderer,
                          TRAIN_SEED)
    kd = pr["kd"]
    step = bpr.make_bounce_train_step(pr["scene"], pr["ps"].camera,
                                      pr["target"], dynamic_params=True,
                                      **pr["cfg"])
    params = {"mat_diffuse": kd}
    ms, times, _ = event_ms(lambda: step(params, TRAIN_SEED), REPS)
    runs = []
    for _ in range(REPS):
        timings = []
        step(params, TRAIN_SEED, timings=timings)
        torch.cuda.synchronize()
        runs.append([(s, d, n, x.elapsed_time(y))
                     for s, d, n, x, y in timings])
    stages = stage_medians(runs)
    print(f"[train step] {TRAIN}: {ms:.3f} ms (runs "
          f"{', '.join(f'{t:.3f}' for t in times)}); "
          f"{_fmt(step_split(stages, ms))}")
    for line in per_bounce_lines(stages):
        print(f"[train step] {line}")


def _vis(tmp: Path, dev, sweep: bool) -> None:
    """--vis: 6b on the split_vis pipeline at phase 11's shapes."""
    import chip_smoke as cs
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import bounce as bo
    from orion_tpu_torch.scene import load_scene
    from tools.path_probe import _ptxas_lines

    builds = _builds(tmp, sweep, VIS_SWEEP)
    so, log = builds["port"]
    for line in _ptxas_lines(log, "bounce_vis_kernel"):
        print(f"[6b vis] ptxas: {line}")
    out = (ctypes.c_int * 4)()
    rc = ctypes.CDLL(str(so)).bounce_info(5, out)
    print(f"[6b vis] built kernel: {out[1]} registers, {out[2]} B local, "
          f"{out[0]} resident blocks of 128 threads an SM (rc {rc})")
    rtc = write_cornell(tmp / "big", xres=cs.MAIN["xres"],
                        yres=cs.MAIN["yres"], depth=cs.MAIN["depth"],
                        levels=cs.BIG_LEVELS)
    lv5, _ = load_scene(rtc, device=dev)
    cam = camera_from_rtc(cs._resized(parse_rtc(rtc), cs.MAIN), device=dev)
    cfg = dict(samples=cs.MAIN["samples"], max_depth=cs.MAIN["depth"],
               light_samples=cs.MAIN["light_samples"])
    fn_f = bo.make_bounce_path_renderer(lv5, cam, **cfg)
    fn_s = bo.make_bounce_path_renderer(lv5, cam, split_vis=True, **cfg)
    fused, whole_f = _render_stages(fn_f)
    del fn_f
    split, whole_s = _render_stages(fn_s)
    print(f"[6b render] {cs.MAIN} on {lv5.num_triangles} triangles: "
          f"split_vis {statistics.median(whole_s):.3f} ms, fused "
          f"{statistics.median(whole_f):.3f} ms a render (medians of "
          f"{REPS}); per bounce:", flush=True)
    for line in vis_lines(split, fused):
        print(f"[6b render] {line}")
    lanes = [split[("vis", d)][0] for d in range(cs.MAIN["depth"] + 1)
             if ("vis", d) in split]
    lib = ctypes.CDLL(str(builds["counters"][0]))
    if lib.bounce_counters_reset() != 0:
        raise RuntimeError("bounce_counters_reset failed")
    rows = []

    def after(kind):
        buf = (ctypes.c_ulonglong * len(COUNTERS))()
        if lib.bounce_counters_read(buf) != 0:
            raise RuntimeError("bounce_counters_read failed")
        rows.append(dict(zip(COUNTERS, buf)))
        lib.bounce_counters_reset()

    with _Swap(lib, after, kinds=("vis",)):
        fn_s(SEED)
    for d, (c, n) in enumerate(zip(rows, lanes)):
        print(f"[6b counters depth {d}] {_fmt(vis_report(c, n))}")
    print(f"[6b counters render] "
          f"{_fmt(vis_report(add_counters(rows), sum(lanes)))}; raw "
          f"{add_counters(rows)}")
    data = fn_s.ctx["data"]
    b = vis_bounds(rows, lanes, (data.nodes.numel() + data.tab.numel()) * 4)
    print(f"[6b bounds] a render {sum(b):.4f} ms, depth 0 {b[0]:.4f} ms; "
          f"per bounce {', '.join(f'{x:.4f}' for x in b)}", flush=True)
    for tag, (so, log) in builds.items():
        if tag in ("port", "counters"):
            continue
        with _Swap(ctypes.CDLL(str(so)), kinds=("vis",)):
            st, whole = _render_stages(fn_s)
        v = sum(ms for (s, _), (_, ms) in st.items() if s == "vis")
        regs = " / ".join(_ptxas_lines(log, "bounce_vis_kernel")[1:])
        print(f"[6b sweep {tag}] 6b {v:.3f} ms a render, depth 0 "
              f"{st[('vis', 0)][1]:.3f} ms; ptxas {regs}", flush=True)


def _phase11(checks: bool, dev, card_line: str) -> int:
    import chip_smoke as cs
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.scene import load_scene, subdivide_scene

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        errs = [0.0, 0.0, 0.0]
        if checks:
            rtc = write_cornell(tmp, xres=64, yres=64, depth=4)
            cornell, r = load_scene(rtc, device=dev)
            errs = cs._phase_bounce_checks(
                (("cornell", cornell),
                 ("levels-2", subdivide_scene(cornell, levels=2))),
                camera_from_rtc(r, device=dev))
        big = write_cornell(tmp / "big", xres=64, yres=64, depth=4,
                            levels=cs.BIG_LEVELS)
        lv5, _ = load_scene(big, device=dev)
        records = cs._phase_bounce(tmp, dev, card_line, lv5, errs)
    for name, rec in records.items():
        print(name, rec)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time builds for other launch bounds and refills")
    ap.add_argument("--no-train", action="store_true",
                    help="skip the train step")
    ap.add_argument("--phase11", action="store_true",
                    help="run chip_smoke.py's phase 11 alone instead")
    ap.add_argument("--checks", action="store_true",
                    help="with --phase11: the 64x64 kernel checks first")
    ap.add_argument("--vis", action="store_true",
                    help="probe the vis kernel (6b) instead")
    ap.add_argument("--root", type=Path, default=None,
                    help="with --vis: probe this checkout")
    args = ap.parse_args(argv)
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        print("error: bounce_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    line = card()
    print(line)
    print(f"SM clock {card('clocks.sm')}, max {card('clocks.max.sm')}",
          flush=True)
    dev = torch.device("cuda", 0)
    if args.phase11:
        return _phase11(args.checks, dev, line)
    if args.vis:
        with tempfile.TemporaryDirectory() as tmp:
            _vis(Path(tmp), dev, args.sweep)
        return 0

    import chip_smoke as cs
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import bounce as bo
    from orion_tpu_torch.scene import load_scene

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        builds = _builds(tmp, args.sweep)
        _resources(builds)
        rtc = write_cornell(tmp / "big", xres=cs.MAIN["xres"],
                            yres=cs.MAIN["yres"], depth=cs.MAIN["depth"],
                            levels=cs.BIG_LEVELS)
        lv5, _ = load_scene(rtc, device=dev)
        cam = camera_from_rtc(cs._resized(parse_rtc(rtc), cs.MAIN),
                              device=dev)
        fn = bo.make_bounce_path_renderer(
            lv5, cam, samples=cs.MAIN["samples"], max_depth=cs.MAIN["depth"],
            light_samples=cs.MAIN["light_samples"])
        stages, whole = _render_stages(fn)
        print(f"[render] {cs.MAIN} on {lv5.num_triangles} triangles: "
              f"{statistics.median(whole):.3f} ms (runs "
              f"{', '.join(f'{t:.3f}' for t in whole)}); per bounce, the "
              f"median of {REPS}:", flush=True)
        for line in per_bounce_lines(stages):
            print(f"[render] {line}")
        lanes = [stages[("walk", d)][0] for d in range(cs.MAIN["depth"] + 1)
                 if ("walk", d) in stages]
        _counters(fn, builds["counters"][0], lanes)
        if args.sweep:
            _sweep(fn, builds)
        del fn
        if not args.no_train:
            _train(tmp, dev, rtc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
