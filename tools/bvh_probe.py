"""The BVH kernels on the card: kernel 5's walk probe, times by leaf size.

    python3 tools/bvh_probe.py --walk [--sweep] [--set NAME=V[,NAME=V]]...
    python3 tools/bvh_probe.py --walk --root CHECKOUT
    python3 tools/bvh_probe.py [--levels 5] [--leaves 2,4,8,16,128]
    python3 tools/bvh_probe.py --leaves "" --full-plain

--walk probes kernel 5 (`csrc/bvh_intersect.cu`) on the sweeps it is
ranked on: every sweep (orig, dirs, alive) that one wavefront sample of
`render` hands to the intersect on the levels-5 subdivided Cornell box
(34,818 triangles, the engine's leaf-2 tree, chip_smoke.SECOND's depth 4
and 2 light samples), (a) at 256x256 (chip_smoke.py phase 10: a launch
fills a quarter of the card's threads) and (b) at 1920x1080 (the card
full). For each set it prints the rays and live rays; kernel 5's
CUDA-event time a launch by CUDA-graph replay, nearest and any-hit; the
kernel against the plain walk (ids and t equal bit for bit, any-hit
masks equal); the plain walk's node visits and Woop tests a live ray and
the bound they give (chip_smoke.walk_bound); what one thread a ray (the
kernel before PR 11) makes of these rays, from each ray's node visits in
the plain walk: a warp is 32 consecutive rays and runs as many loop
iterations as its longest ray, so SIMT efficiency = node visits / (32 x
the warps' iterations), and its tail = the share of a warp's iterations
in which fewer than half its lanes walk. Then the kernel's resources
(ptxas's lines; the resident blocks, registers and local bytes of the
built kernel, `bvh_intersect_info`, where the source has it) and, where
the source has the counters (-DORION_WALK_COUNTERS, an instrumented
build into a temporary directory), a ray's node visits, Woop tests and
window loads and the window loop's SIMT efficiency and tail, over each
set. --sweep times builds of copies of the source with one of
WALK_SWEEP's constants set to each of its values, and each --set
NAME=V[,NAME=V] a copy with those set together. --root CHECKOUT probes
another checkout's kernel and package (first on sys.path; the harness,
chip_smoke.py's sweep recorder and graph timing, is this tree's, and so
is cornell_scenes.py's writer where the checkout has none).

--g8 probes G8 (kernel 11, `csrc/bvh_g8.cu`) on the leaf-128 tree of the
same box, on two sets: (a) the 256x256 sweeps above (chip_smoke.py phase
10's), and the 1080p depth-1 bounce wavefront (chip_smoke.py phase 13
(d)'s: the state of depth 1 of the binned renderer at 1920x1080, 4 spp,
depth 8, 2 light samples, seed 0). For each set it prints the rays and
live rays; G8 against the plain walk (`bvh_walk_plain`, leaf 128): the
rays whose nearest (t, row) differ and the any-hit masks and rows that
differ; the plain walk's node visits and leaf visits a live ray; G8's
time a launch by CUDA-graph replay, nearest and any-hit, beside kernel 5
on the same tree, and the plain walk's; then G8's resources (ptxas's
lines; registers, local bytes and resident blocks of the built kernel,
`bvh_g8_info`, where the source has it), the loops of its SASS (the
shortest first: the leaf's row test among them), and, where the source
has the counters (-DORION_G8_COUNTERS), each set's live lanes a group of
rays behind one pointer, the pointer's node steps and leaves a group, the
lanes whose own slab test passed at a leaf, the Woop tests the threads
run a live ray, and the share of a group's cycles spent in leaves.
--sweep times builds of copies of the source with one of G8_SWEEP's
constants (those the source defines) set to each of its values, --set a
copy with several set; --root CHECKOUT probes another checkout's G8.

Builds the two BVH kernels (`csrc/bvh_intersect.cu`, `csrc/bvh_path.cu`),
writes the subdivided Cornell box (`cornell_scenes.write_cornell(levels=)`,
levels 5 = 34,818 triangles) and, for each leaf size:

  - kernel 5 (the walk) on 2^18 random rays from inside the box, nearest
    and any-hit: held against the plain walk (ids equal, t relative
    error), box and triangle tests per live ray from the plain walk's
    counters, CUDA-event median of 7 launches after a warm-up;
  - kernel 8 (the BVH path megakernel): a 64x64, 4 spp, depth 4 image held
    against the plain version (pixels off by more than 1e-4 + 1e-3*|ref|,
    relative difference of the means), then the time of the 1920x1080,
    16 spp, depth 8, 2 light samples render (median of 3 after a warm-up),
    with one and with eight per-octant flattenings of the tree.

It also prints the BVH build time of the native and the NumPy builder.
--full-plain runs kernel 8's plain version over the whole 1920x1080 image
at the renderer's own leaf width (minutes) and prints its exact box and
Woop test counts, for the kernel's bound, and the pixels off against the
kernel's image.
The first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# this tree's harness, also where --root puts another checkout's package
# first on sys.path
import chip_smoke  # noqa: E402,F401

# constexpr ints of csrc/bvh_intersect.cu and the values --walk --sweep
# builds
WALK_SWEEP = {"kSpreadBlocks": (8, 10),
              "kSpreadWindow": (1, 2, 3),
              "kCountedBlocks": (10, 12),
              "kCountedWindow": (1, 2),
              "kBvhRefill": (8, 16, 24, 32),
              "kBvhSteps": (8, 16, 32),
              "kChunk": (32, 64, 128)}
# the kernel's instantiations: (label, bvh_intersect_info's `which`, its
# template arguments' mangled string)
WALK_KERNELS = (("nearest spread", 0, "ILb0ELb0E"),
                ("any-hit spread", 1, "ILb1ELb0E"),
                ("nearest counted", 2, "ILb0ELb1E"),
                ("any-hit counted", 3, "ILb1ELb1E"))
# g_walk_counters, in csrc/bvh_intersect.cu's order
WALK_COUNTERS = ("rays", "steps", "tests", "loads", "iters", "iter_lanes",
                 "tail_iters", "warps", "takes")
# CUDA-graph passes and replays of each sweep set: (a) 256x256, (b) 1080p
WALK_SETS = {"a": (dict(xres=256, yres=256), 20, 21),
             "b": (dict(xres=1920, yres=1080), 3, 7)}
# constexpr ints of csrc/bvh_g8.cu and the values --g8 --sweep builds
# (a constant the source does not define is left out)
G8_SWEEP = {"kG8Blocks": (6, 8),
            "kBlockRays": (128, 256)}
# G8's instantiations: (label, bvh_g8_info's `which`, mangled string)
G8_KERNELS = (("nearest", 0, "ILb0E"), ("any-hit", 1, "ILb1E"))
# g_g8_counters, in csrc/bvh_g8.cu's order
G8_COUNTERS = ("groups", "live_lanes", "steps", "leaves", "leaf_lanes",
               "row_tests", "cycles", "leaf_cycles")
# G8's sets: (a) phase 10's sweeps, the 1080p depth-1 bounce wavefront;
# CUDA-graph passes and replays
G8_SETS = {"a": (20, 21), "bounce": (3, 5)}
# the loops of G8's SASS printed, shortest first
G8_SASS_LOOPS = 6


def _median_ms(fn, reps: int):
    import torch

    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), times, out


# ---------------------------------------------------------------------------
# --walk: the host arithmetic (tests/test_torch_walk_probe.py)
# ---------------------------------------------------------------------------

def thread_a_ray(ray_steps) -> dict:
    """What one thread a ray makes of rays whose node visits are
    `ray_steps` ([N] ints, 0 for a dead ray), a warp being 32 consecutive
    rays that runs as many loop iterations as its longest ray: the SIMT
    efficiency (visits / (32 x iterations)), the tail (the share of the
    iterations in which fewer than half the warp's lanes walk), the live
    rays' mean visits and the warps' mean iterations."""
    import numpy as np

    x = np.asarray(ray_steps, np.int64)
    x = np.concatenate([x, np.zeros((-len(x)) % 32, np.int64)])
    w = -np.sort(-x.reshape(-1, 32), axis=1)        # each warp, descending
    w = w[w[:, 0] > 0]
    iters = int(w[:, 0].sum())
    return dict(simt=float(w.sum()) / max(32 * iters, 1),
                tail=float((w[:, 0] - w[:, 15]).sum()) / max(iters, 1),
                steps=float(x[x > 0].mean()) if (x > 0).any() else 0.0,
                warp_iters=float(w[:, 0].mean()) if len(w) else 0.0)


def walk_report(c: dict) -> dict:
    """The instrumented kernel's counters as a ray's node visits, Woop
    tests (leaf rows) and window loads, the window loop's SIMT efficiency
    (active lanes / (32 x warp iterations)), its tail (the share of warp
    iterations with fewer than half the lanes walking), a warp's
    iterations, and the warps' take rounds (atomics on the counter)."""
    def ratio(a, b):
        return a / b if b else 0.0

    return dict(rays=c["rays"], steps=ratio(c["steps"], c["rays"]),
                tests=ratio(c["tests"], c["rays"]),
                loads=ratio(c["loads"], c["rays"]),
                simt=ratio(c["iter_lanes"], 32 * c["iters"]),
                tail=ratio(c["tail_iters"], c["iters"]),
                warp_iters=ratio(c["iters"], c["warps"]), takes=c["takes"])


def g8_report(c: dict) -> dict:
    """G8's counters as a group's live lanes, node steps and opened
    leaves, the lanes whose own slab test passed at an opened leaf, the
    Woop tests the warp's threads run a live lane, and the share of a
    group's cycles spent in leaves."""
    def ratio(a, b):
        return a / b if b else 0.0

    return dict(groups=c["groups"],
                live=ratio(c["live_lanes"], c["groups"]),
                steps=ratio(c["steps"], c["groups"]),
                leaves=ratio(c["leaves"], c["groups"]),
                need=ratio(c["leaf_lanes"], c["leaves"]),
                tests=ratio(c["row_tests"], c["live_lanes"]),
                leaf_share=ratio(c["leaf_cycles"], c["cycles"]))


def resident_blocks(regs: int, threads: int = 128) -> int:
    """Resident blocks of `threads` an SM of an H100 at `regs` registers a
    thread, by registers alone (65,536 an SM, allocated 256 a warp at a
    time; at most 64 warps and 32 blocks an SM)."""
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256
    return min(65536 // (per_warp * warps), 64 // warps, 32)


def parse_set(spec: str) -> dict:
    """{constant: value} of "NAME=V[,NAME=V]"."""
    out = {}
    for item in spec.split(","):
        name, value = item.split("=")
        out[name.strip()] = int(value)
    return out


def walk_sources(src: Path, out: Path, sets=None, sweep=None) -> dict:
    """{tag: path}: copies of `src` (bvh_intersect.cu) in `out`, each with
    one of `sweep`'s constants (WALK_SWEEP's by default) set to one of its
    values, or (`sets`, a list of {constant: value}) with several set
    together. A constant of `sweep` that the source does not define is
    left out."""
    from tools.ab_turns import with_constant

    text = src.read_text()
    out.mkdir(parents=True, exist_ok=True)
    sweep = WALK_SWEEP if sweep is None else sweep
    builds = [{name: v} for name, values in sweep.items()
              if f"constexpr int {name} = " in text
              for v in values] if sets is None else sets
    paths = {}
    for consts in builds:
        tag = ",".join(f"{k}={v}" for k, v in consts.items())
        body = text
        for name, v in consts.items():
            body = with_constant(body, name, v)
        paths[tag] = out / f"{src.stem}_{len(paths)}.cu"
        paths[tag].write_text(body)
    return paths


def _fmt(d: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in d.items())


# ---------------------------------------------------------------------------
# --walk: the card
# ---------------------------------------------------------------------------

def _walk_builds(tmp: Path, sweep: bool, sets) -> dict:
    """{tag: (library, nvcc's report)}: the port's source and flags, the
    counters where the source has them, with `sweep` WALK_SWEEP's copies,
    and the copies of `sets`; one nvcc each, all together."""
    import concurrent.futures

    from orion_tpu_torch.ops import cuda_build
    from tools.path_probe import _nvcc

    src = cuda_build.CSRC / "bvh_intersect.cu"
    jobs = {"port": (src, ())}
    if "ORION_WALK_COUNTERS" in src.read_text():
        jobs["counters"] = (src, ("-DORION_WALK_COUNTERS",))
    if sweep:
        jobs.update({tag: (cu, ()) for tag, cu in
                     walk_sources(src, tmp).items()})
    if sets:
        jobs.update({tag: (cu, ()) for tag, cu in
                     walk_sources(src, tmp / "sets", sets).items()})

    libs = {tag: tmp / f"walk_{i}.so" for i, tag in enumerate(jobs)}

    def one(item):
        tag, (cu, defines) = item
        return tag, libs[tag], _nvcc(cu, libs[tag], defines)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return {tag: (so, log) for tag, so, log in pool.map(one, jobs.items())}


def _walk_sets(tmp: Path, dev):
    """(tree's nodes, table, leaf width, {set: sweeps}) on the levels-5
    box: the engine's `--backend bvh` tree, and one wavefront sample's
    sweeps at each of WALK_SETS' resolutions."""
    from chip_smoke import BIG_LEVELS, SECOND, record_sweeps
    from cornell_scenes import write_cornell
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import bvh_intersect as bx

    rtc = write_cornell(tmp / "box", xres=256, yres=256, depth=4,
                        levels=BIG_LEVELS)
    ps = prepare(rtc, device=dev, force_backend="bvh")
    nodes, tri = bx._bvh_device_layout(ps.bvh, dev)
    sets = {}
    for name, (res, _, _) in WALK_SETS.items():
        r = parse_rtc(rtc)
        r.xres, r.yres = res["xres"], res["yres"]
        sets[name] = record_sweeps(ps.scene, camera_from_rtc(r, device=dev),
                                   ps.intersect, SECOND)
    return nodes, tri, ps.bvh.leaf_width, sets


def _walk_checks(name, sweeps, nodes, tri, leaf) -> dict:
    """Kernel against plain on every sweep, nearest and any-hit; the plain
    walk's counts, each ray's node visits included."""
    import torch

    from orion_tpu_torch.ops import bvh_intersect as bx

    stats, steps, equal, masks = {}, [], 0, 0
    for o, d, a in sweeps:
        stats["ray_box_tests"] = torch.zeros(o.shape[0], dtype=torch.int64,
                                             device=o.device)
        t_p, r_p = bx.bvh_walk_plain(nodes, tri, o, d, a, leaf_width=leaf,
                                     stats=stats)
        steps.append(stats.pop("ray_box_tests").cpu())
        t_k, r_k = bx.bvh_walk(nodes, tri, o, d, a, leaf_width=leaf)
        equal += int(((r_k == r_p) & ((t_k == t_p) | (r_p < 0))).sum())
        _, r_pa = bx.bvh_walk_plain(nodes, tri, o, d, a, leaf_width=leaf,
                                    any_hit=True)
        _, r_ka = bx.bvh_walk(nodes, tri, o, d, a, leaf_width=leaf,
                              any_hit=True)
        masks += int(((r_ka >= 0) == (r_pa >= 0)).sum())
    n = sum(o.shape[0] for o, _, _ in sweeps)
    print(f"[walk {name}] kernel vs plain: (t, row) equal on {equal} of {n} "
          f"rays ({equal / n:.6f}), any-hit masks on {masks} "
          f"({masks / n:.6f})", flush=True)
    return dict(stats=stats, steps=torch.cat(steps).numpy())


def _walk_times(tag, sets, nodes, tri, leaf, any_hit=False) -> str:
    from chip_smoke import graph_ms
    from orion_tpu_torch.ops import bvh_intersect as bx

    out = []
    for name, sweeps in sets.items():
        _, passes, replays = WALK_SETS[name]
        ms, spread = graph_ms(lambda: [
            bx.bvh_walk(nodes, tri, o, d, a, leaf_width=leaf,
                        any_hit=any_hit) for o, d, a in sweeps],
            passes, replays)
        out.append(f"({name}) {ms:.5f} ms a launch (spread {spread:.4f})")
    return (f"[walk {tag}{' any-hit' if any_hit else ''}] "
            + ", ".join(out))


class _Swap:
    """The two counts (KERNEL, ANY_HIT_KERNEL) of `orion_tpu_torch.ops.
    <module>` launching `lib`'s entry point of the same name: kernel 5's
    by default, G8's with module="bvh_g8"."""

    def __init__(self, lib, module: str = "bvh_intersect"):
        import importlib

        self.lib = lib
        self.mod = importlib.import_module(f"orion_tpu_torch.ops.{module}")

    def __enter__(self):
        import ctypes

        ks = (self.mod.KERNEL, self.mod.ANY_HIT_KERNEL)
        self.real = tuple(k._fn for k in ks)
        for k in ks:
            k._load()
            fn = getattr(self.lib, k.symbol)
            fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
            k._fn = fn
        return self

    def __exit__(self, *exc):
        self.mod.KERNEL._fn, self.mod.ANY_HIT_KERNEL._fn = self.real


def _walk(sweep: bool, sets, dev) -> int:
    import ctypes

    import torch

    from chip_smoke import walk_bound
    from tools.path_probe import _ptxas_lines

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        builds = _walk_builds(tmp, sweep, sets)
        so, log = builds["port"]
        lib = ctypes.CDLL(str(so))
        info = hasattr(lib, "bvh_intersect_info")
        # a tree before PR 11 has one instantiation a mode, <any_hit>
        kernels = WALK_KERNELS if info else (("nearest", 0, "ILb0E"),
                                             ("any-hit", 1, "ILb1E"))
        for label, which, args in kernels:
            for line in _ptxas_lines(log, "bvh_intersect_kernel", args):
                print(f"[walk resources {label}] ptxas: {line}")
            if info:
                out = (ctypes.c_int * 4)()
                rc = lib.bvh_intersect_info(which, out)
                print(f"[walk resources {label}] built kernel: {out[1]} "
                      f"registers, {out[2]} B local, {out[0]} resident "
                      f"blocks of 128 an SM (rc {rc})")
        nodes, tri, leaf, sets = _walk_sets(tmp, dev)
        print(f"[walk] tree: {nodes.shape[0]} nodes, {tri.shape[0]} rows, "
              f"leaf {leaf}", flush=True)
        for name, sweeps in sets.items():
            n = sum(o.shape[0] for o, _, _ in sweeps)
            alive = sum(int(a.sum()) for _, _, a in sweeps)
            ck = _walk_checks(name, sweeps, nodes, tri, leaf)
            st = ck["stats"]
            bound, by = walk_bound(st, sweeps, nodes, tri)
            print(f"[walk {name}] {len(sweeps)} sweeps "
                  f"({', '.join(str(o.shape[0]) for o, _, _ in sweeps)} "
                  f"rays), {n} rays, {alive} alive; plain walk: "
                  f"{st['box_tests']} node visits, {st['tests']} Woop tests "
                  f"of real rows ({st['box_tests'] / alive:.2f} and "
                  f"{st['tests'] / alive:.2f} a live ray); bound "
                  f"{bound:.6f} ms a launch ({by})")
            print(f"[walk {name}] one thread a ray: "
                  f"{_fmt(thread_a_ray(ck['steps']))}; the longest ray "
                  f"{int(ck['steps'].max())} node visits", flush=True)
        print(_walk_times("port", sets, nodes, tri, leaf), flush=True)
        print(_walk_times("port", sets, nodes, tri, leaf, any_hit=True),
              flush=True)
        if "counters" in builds:
            clib = ctypes.CDLL(str(builds["counters"][0]))
            from orion_tpu_torch.ops import bvh_intersect as bx

            with _Swap(clib):
                for name, sweeps in sets.items():
                    clib.walk_counters_reset()
                    for o, d, a in sweeps:
                        bx.bvh_walk(nodes, tri, o, d, a, leaf_width=leaf)
                    torch.cuda.synchronize()
                    buf = (ctypes.c_ulonglong * len(WALK_COUNTERS))()
                    clib.walk_counters_read(buf)
                    c = dict(zip(WALK_COUNTERS, buf))
                    print(f"[walk {name} counters] {_fmt(walk_report(c))}; "
                          f"raw {c}", flush=True)
        for tag, (so, log) in builds.items():
            if tag in ("port", "counters"):
                continue
            regs = "; ".join(
                f"{label} " + " / ".join(_ptxas_lines(
                    log, "bvh_intersect_kernel", args)[1:])
                for label, _, args in WALK_KERNELS[::2])
            with _Swap(ctypes.CDLL(str(so))):
                print(_walk_times(tag, sets, nodes, tri, leaf)
                      + f"; ptxas {regs}", flush=True)
                print(_walk_times(tag, sets, nodes, tri, leaf, any_hit=True),
                      flush=True)
    return 0

# ---------------------------------------------------------------------------
# --g8: the card
# ---------------------------------------------------------------------------

def _g8_builds(tmp: Path, sweep: bool, sets) -> dict:
    """{tag: (library, nvcc's report)}: csrc/bvh_g8.cu as the port builds
    it, the counters where the source has them, with `sweep` G8_SWEEP's
    copies, and the copies of `sets`; one nvcc each, all together."""
    import concurrent.futures

    from orion_tpu_torch.ops import cuda_build
    from tools.path_probe import _nvcc

    src = cuda_build.CSRC / "bvh_g8.cu"
    jobs = {"port": (src, ())}
    if "ORION_G8_COUNTERS" in src.read_text():
        jobs["counters"] = (src, ("-DORION_G8_COUNTERS",))
    if sweep:
        jobs.update({tag: (cu, ()) for tag, cu in walk_sources(
            src, tmp / "g8", sweep=G8_SWEEP).items()})
    if sets:
        jobs.update({tag: (cu, ()) for tag, cu in
                     walk_sources(src, tmp / "g8_sets", sets).items()})
    libs = {tag: tmp / f"g8_{i}.so" for i, tag in enumerate(jobs)}

    def one(item):
        tag, (cu, defines) = item
        return tag, libs[tag], _nvcc(cu, libs[tag], defines)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return {tag: (so, log) for tag, so, log in pool.map(one, jobs.items())}


def _g8_sets(tmp: Path, dev):
    """(the leaf-128 tree's nodes and table, {set: sweeps}) on the levels-5
    box: phase 10's 256x256 sweeps (kernel 5's wavefront over the engine's
    tree) and the 1080p depth-1 bounce wavefront of the binned renderer at
    chip_smoke.TRAIN's shapes (phase 13 (d)'s two sets)."""
    from chip_smoke import BIG_LEVELS, SECOND, TRAIN, _resized, record_sweeps
    from cornell_scenes import write_cornell
    from orion_tpu_torch import engine
    from orion_tpu_torch.accel.bvh import build_scene_bvh
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import bvh_g8 as g8
    from orion_tpu_torch.ops import bvh_intersect as bx

    rtc = write_cornell(tmp / "box", xres=256, yres=256, depth=4,
                        levels=BIG_LEVELS)
    ps = engine.prepare(rtc, device=dev, force_backend="bvh")
    sets = {"a": record_sweeps(ps.scene, camera_from_rtc(
        _resized(parse_rtc(rtc), WALK_SETS["a"][0]), device=dev),
        ps.intersect, SECOND)}
    cam = camera_from_rtc(_resized(parse_rtc(rtc), TRAIN), device=dev)
    fn, _ = engine.make_big_path_renderer(
        ps.scene, cam, order=("binned",), samples=TRAIN["samples"],
        max_depth=TRAIN["depth"], light_samples=TRAIN["light_samples"])
    rec = []
    fn(0, record=lambda depth, n, st, hd, kd, vis: rec.append(
        st[:, :n].clone()) if depth == 1 else None)
    st1 = rec[0]
    sets["bounce"] = [(st1[0:3].t().contiguous(), st1[3:6].t().contiguous(),
                       st1[9] > 0.0)]
    del fn, rec, st1
    bvh, _ = build_scene_bvh(ps.scene, leaf_size=g8.LEAF_WIDTH)
    nodes, tri = bx._bvh_device_layout(bvh, dev)
    return nodes, tri, sets


def _g8_checks(name, sweeps, nodes, tri) -> dict:
    """G8 against the plain walk on every sweep of a set, nearest and any
    hit; the plain walk's counts and time."""
    import torch

    from orion_tpu_torch.ops import bvh_g8 as g8
    from orion_tpu_torch.ops import bvh_intersect as bx

    stats, off, masks, rows, plain_ms = {}, 0, 0, 0, 0.0
    for o, d, a in sweeps:
        a_ev = torch.cuda.Event(enable_timing=True)
        b_ev = torch.cuda.Event(enable_timing=True)
        a_ev.record()
        t_p, r_p = bx.bvh_walk_plain(nodes, tri, o, d, a,
                                     leaf_width=g8.LEAF_WIDTH, stats=stats)
        b_ev.record()
        torch.cuda.synchronize()
        plain_ms += a_ev.elapsed_time(b_ev)
        t_k, r_k = g8.bvh_g8(nodes, tri, o, d, a)
        off += int((~((r_k == r_p) & ((t_k == t_p) | (r_p < 0)))).sum())
        _, r_pa = bx.bvh_walk_plain(nodes, tri, o, d, a,
                                    leaf_width=g8.LEAF_WIDTH, any_hit=True)
        _, r_ka = g8.bvh_g8(nodes, tri, o, d, a, any_hit=True)
        masks += int(((r_ka >= 0) != (r_pa >= 0)).sum())
        rows += int((r_ka != r_pa).sum())
    n = sum(o.shape[0] for o, _, _ in sweeps)
    alive = sum(int(a.sum()) for _, _, a in sweeps)
    print(f"[g8 {name}] {len(sweeps)} sweeps, {n} rays, {alive} alive; G8 "
          f"vs plain: nearest (t, row) differ on {off} rays; any hit: masks "
          f"differ on {masks}, rows on {rows}; plain walk (leaf 128): "
          f"{stats['box_tests'] / alive:.3f} node visits, "
          f"{stats['leaf_visits'] / alive:.4f} leaf visits, "
          f"{stats['tests'] / alive:.2f} Woop tests of real rows a live ray; "
          f"{plain_ms / len(sweeps):.3f} ms a launch", flush=True)
    return dict(stats=stats, alive=alive, plain_ms=plain_ms / len(sweeps))


def _g8_times(tag, sets, nodes, tri, kernel5: bool = False) -> str:
    from chip_smoke import graph_ms
    from orion_tpu_torch.ops import bvh_g8 as g8
    from orion_tpu_torch.ops import bvh_intersect as bx

    out = []
    for name, sweeps in sets.items():
        passes, replays = G8_SETS[name]
        t = []
        for any_hit in (False, True):
            ms, spread = graph_ms(lambda: [
                g8.bvh_g8(nodes, tri, o, d, a, any_hit=any_hit)
                for o, d, a in sweeps], passes, replays)
            t.append(f"{ms:.5f}")
        line = f"({name}) {t[0]} / {t[1]} ms a launch"
        if kernel5:
            ms, _ = graph_ms(lambda: [
                bx.bvh_walk(nodes, tri, o, d, a, leaf_width=g8.LEAF_WIDTH)
                for o, d, a in sweeps], passes, replays)
            line += f", kernel 5 on this tree {ms:.5f}"
        out.append(line)
    return (f"[g8 {tag}] nearest / any-hit: " + "; ".join(out))


def _g8(sweep: bool, sets, dev) -> int:
    import ctypes

    import torch

    from chip_smoke import walk_bound
    from orion_tpu_torch.ops import bvh_g8 as g8
    from tools.path_probe import _cuobjdump, _ptxas_lines, sass_loops

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        builds = _g8_builds(tmp, sweep, sets)
        so, log = builds["port"]
        lib = ctypes.CDLL(str(so))
        for label, which, args in G8_KERNELS:
            for line in _ptxas_lines(log, "bvh_g8_kernel", args):
                print(f"[g8 resources {label}] ptxas: {line}")
            if hasattr(lib, "bvh_g8_info"):
                out = (ctypes.c_int * 4)()
                rc = lib.bvh_g8_info(which, out)
                print(f"[g8 resources {label}] built kernel: {out[1]} "
                      f"registers, {out[2]} B local, {out[3]} B static "
                      f"shared, {out[0]} resident blocks of 128 an SM "
                      f"(rc {rc})")
        sass = _cuobjdump(so)
        for label, _, args in G8_KERNELS:
            for first, last, n, ops in sass_loops(
                    sass, "bvh_g8_kernel", args)[:G8_SASS_LOOPS]:
                print(f"[g8 sass {label}] loop {first:#x}-{last:#x}: {n} "
                      f"instructions {ops}")
        nodes, tri, ray_sets = _g8_sets(tmp, dev)
        print(f"[g8] leaf-128 tree: {nodes.shape[0]} nodes, {tri.shape[0]} "
              f"rows", flush=True)
        for name, sweeps in ray_sets.items():
            ck = _g8_checks(name, sweeps, nodes, tri)
            bound, by = walk_bound(ck["stats"], sweeps, nodes, tri)
            print(f"[g8 {name}] bound {bound:.6f} ms a launch ({by})",
                  flush=True)
        print(_g8_times("port", ray_sets, nodes, tri, kernel5=True),
              flush=True)
        if "counters" in builds:
            clib = ctypes.CDLL(str(builds["counters"][0]))
            with _Swap(clib, "bvh_g8"):
                for name, sweeps in ray_sets.items():
                    for any_hit in (False, True):
                        clib.g8_counters_reset()
                        for o, d, a in sweeps:
                            g8.bvh_g8(nodes, tri, o, d, a, any_hit=any_hit)
                        torch.cuda.synchronize()
                        buf = (ctypes.c_ulonglong * len(G8_COUNTERS))()
                        clib.g8_counters_read(buf)
                        c = dict(zip(G8_COUNTERS, buf))
                        print(f"[g8 {name} counters"
                              f"{' any-hit' if any_hit else ''}] "
                              f"{_fmt(g8_report(c))}; raw {c}", flush=True)
        for tag, (so, log) in builds.items():
            if tag in ("port", "counters"):
                continue
            regs = " / ".join(_ptxas_lines(log, "bvh_g8_kernel", "ILb0E")[1:])
            with _Swap(ctypes.CDLL(str(so)), "bvh_g8"):
                print(_g8_times(tag, ray_sets, nodes, tri)
                      + f"; ptxas nearest {regs}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--leaves", default="2,4,8,16,128")
    ap.add_argument("--skip-numpy-build", action="store_true")
    ap.add_argument("--full-plain", action="store_true")
    ap.add_argument("--walk", action="store_true",
                    help="kernel 5 on the 256x256 and 1080p sweeps")
    ap.add_argument("--g8", action="store_true",
                    help="G8 (kernel 11) on phase 10's sweeps and the 1080p "
                    "bounce wavefront")
    ap.add_argument("--sweep", action="store_true",
                    help="with --walk / --g8: builds of WALK_SWEEP's / "
                    "G8_SWEEP's values")
    ap.add_argument("--root", type=Path, default=None,
                    help="with --walk / --g8: probe this checkout")
    ap.add_argument("--set", action="append", default=[], type=parse_set,
                    help="with --walk / --g8: a build with NAME=V[,NAME=V] "
                    "set")
    args = ap.parse_args(argv)
    leaves = [int(x) for x in args.leaves.split(",") if x]
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))

    import numpy as np
    import torch

    from cornell_scenes import random_rays, write_cornell
    from orion_tpu_torch import native
    from orion_tpu_torch.accel.bvh import build_scene_bvh
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import bvh_intersect as bx
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.ops import cuda_build
    from orion_tpu_torch.scene import load_scene

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    if args.walk:
        return _walk(args.sweep, args.set, dev)
    if args.g8:
        return _g8(args.sweep, args.set, dev)
    t0 = time.perf_counter()
    built = cuda_build.build(["bvh_intersect", "bvh_path"])
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        rtc_path = write_cornell(tmp, xres=64, yres=64, depth=4,
                                 levels=args.levels)
        t0 = time.perf_counter()
        scene, rtc = load_scene(rtc_path, device=dev)
        print(f"levels-{args.levels}: {scene.num_triangles} triangles, "
              f"loaded in {time.perf_counter() - t0:.3f} s (native library "
              f"{'built' if native.native_available() else 'unavailable'})")
        rtc_hd = parse_rtc(rtc_path)
    rtc_hd.xres, rtc_hd.yres = 1920, 1080
    cam64 = camera_from_rtc(rtc, device=dev)
    cam_hd = camera_from_rtc(rtc_hd, device=dev)

    for builder in ("native", "numpy"):
        if builder == "numpy" and args.skip_numpy_build:
            continue
        if builder == "native" and not native.native_available():
            continue
        t0 = time.perf_counter()
        _, st = build_scene_bvh(scene, leaf_size=8, builder=builder)
        print(f"build ({builder}, SAH, leaf 8): "
              f"{time.perf_counter() - t0:.3f} s, {st.nodes} nodes, depth "
              f"{st.max_depth}, {st.padded_tris} bundled rows")

    o, d, alive = random_rays(1 << 18, 1, dev)
    n_live = int(alive.sum())
    for leaf in leaves:
        bvh, st = build_scene_bvh(scene, leaf_size=leaf)
        nodes, tri = bx._bvh_device_layout(bvh, dev)
        for any_hit in (False, True):
            ms, times, (t_k, r_k) = _median_ms(
                lambda: bx.bvh_walk(nodes, tri, o, d, alive, leaf_width=leaf,
                                    any_hit=any_hit), 7)
            stats = {}
            t0 = time.perf_counter()
            t_p, r_p = bx.bvh_walk_plain(nodes, tri, o, d, alive,
                                         leaf_width=leaf, any_hit=any_hit,
                                         stats=stats)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            if any_hit:
                same = float(((r_k >= 0) == (r_p >= 0)).float().mean())
                rel = 0.0
            else:
                same = float((r_k == r_p).float().mean())
                both = (r_k == r_p) & (r_p >= 0)
                rel = float(((t_k - t_p).abs()[both]
                             / t_p[both].abs()).max())
            print(f"kernel 5 leaf {leaf:3d} "
                  f"{'any-hit' if any_hit else 'nearest'}: {ms:.4f} ms (runs "
                  f"{', '.join(f'{x:.4f}' for x in times)}), plain "
                  f"{plain_s * 1e3:.1f} ms in {stats['steps']} steps; "
                  f"{stats['box_tests'] / n_live:.1f} box tests, "
                  f"{stats['tests'] / n_live:.1f} real triangle tests, "
                  f"{stats['leaf_visits'] / n_live:.2f} leaf visits a live "
                  f"ray; {'masks' if any_hit else 'ids'} equal {same:.6f}, "
                  f"max rel t {rel:.3g}; {st.nodes} nodes", flush=True)

        if leaf % 2:
            continue
        for octants in (1, 8):
            fn64 = bp.make_bvh_path_renderer(scene, cam64, samples=4,
                                             max_depth=4, light_samples=2,
                                             leaf_width=leaf, octants=octants)
            k = fn64(1234).reshape(-1, 3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dd = fn64.data
            p = bp.bvh_path_plain(dd["nodes"], dd["tab"], dd["em"], dd["cam"],
                                  1234, 64, 64, 4, 4, 2, leaf_width=leaf,
                                  copies=octants)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            kn, pn = k.cpu().numpy(), p.cpu().numpy()
            off = (np.abs(kn - pn) > 1e-4 + 1e-3 * np.abs(pn)).any(1).mean()
            mrel = abs(kn.mean() - pn.mean()) / pn.mean()
            fn = bp.make_bvh_path_renderer(scene, cam_hd, samples=16,
                                           max_depth=8, light_samples=2,
                                           leaf_width=leaf, octants=octants)
            ms, times, img = _median_ms(lambda: fn(0), 3)
            print(f"kernel 8 leaf {leaf:3d} octants {octants}: 1080p 16 spp "
                  f"depth 8 {ms:.2f} ms (runs "
                  f"{', '.join(f'{x:.2f}' for x in times)}), image mean "
                  f"{float(img.mean()):.6g}; 64x64 vs plain ({plain_s:.1f} "
                  f"s): pixels off {off:.5f}, mean rel {mrel:.3g}, max abs "
                  f"{np.abs(kn - pn).max():.3g}; "
                  f"{dd['nodes'].shape[0]} node rows", flush=True)
    if args.full_plain:
        fn = bp.make_bvh_path_renderer(scene, cam_hd, samples=16, max_depth=8,
                                       light_samples=2)
        k = fn(0).reshape(-1, 3)
        dd, stats = fn.data, {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = bp.bvh_path_plain(dd["nodes"], dd["tab"], dd["em"], dd["cam"], 0,
                              1920, 1080, 16, 8, 2,
                              leaf_width=dd["leaf_width"], stats=stats)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        off = ((k - p).abs() > 1e-4 + 1e-3 * p.abs()).any(1).float().mean()
        flops = stats["box_tests"] * 12 + stats["tests"] * 39
        print(f"kernel 8 plain, whole 1080p image, 16 spp depth 8, leaf "
              f"{dd['leaf_width']}: {plain_s:.1f} s; {stats['box_tests']:.6g} "
              f"box tests, {stats['tests']:.6g} Woop tests of real rows, "
              f"{stats['leaf_visits']:.6g} leaf visits in {stats['steps']} "
              f"walk steps; {flops / 67e12 * 1e3:.4f} ms at 67 TFLOP/s; "
              f"pixels off vs the kernel {float(off):.6f}, means "
              f"{float(k.mean()):.6g} / {float(p.mean()):.6g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
