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
chip_smoke.py's scene writer, sweep recorder and graph timing, is this
tree's).

Builds the two BVH kernels (`csrc/bvh_intersect.cu`, `csrc/bvh_path.cu`),
writes the subdivided Cornell box (`chip_smoke.write_cornell(levels=)`,
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


def walk_sources(src: Path, out: Path, sets=None) -> dict:
    """{tag: path}: copies of `src` (bvh_intersect.cu) in `out`, each with
    one of WALK_SWEEP's constants set to one of its values, or (`sets`, a
    list of {constant: value}) with several set together."""
    from tools.ab_turns import with_constant

    text = src.read_text()
    out.mkdir(parents=True, exist_ok=True)
    builds = [{name: v} for name, values in WALK_SWEEP.items()
              for v in values] if sets is None else sets
    paths = {}
    for consts in builds:
        tag = ",".join(f"{k}={v}" for k, v in consts.items())
        body = text
        for name, v in consts.items():
            body = with_constant(body, name, v)
        paths[tag] = out / f"bvh_intersect_{len(paths)}.cu"
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
    from chip_smoke import BIG_LEVELS, SECOND, record_sweeps, write_cornell
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
    """Kernel 5's two counts launching `lib`'s bvh_intersect_launch."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        import ctypes

        from orion_tpu_torch.ops import bvh_intersect as bx

        self.real = (bx.KERNEL._fn, bx.ANY_HIT_KERNEL._fn)
        for k in (bx.KERNEL, bx.ANY_HIT_KERNEL):
            k._load()
            fn = getattr(self.lib, "bvh_intersect_launch")
            fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
            k._fn = fn
        return self

    def __exit__(self, *exc):
        from orion_tpu_torch.ops import bvh_intersect as bx

        bx.KERNEL._fn, bx.ANY_HIT_KERNEL._fn = self.real


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--leaves", default="2,4,8,16,128")
    ap.add_argument("--skip-numpy-build", action="store_true")
    ap.add_argument("--full-plain", action="store_true")
    ap.add_argument("--walk", action="store_true",
                    help="kernel 5 on the 256x256 and 1080p sweeps")
    ap.add_argument("--sweep", action="store_true",
                    help="with --walk: builds of WALK_SWEEP's values")
    ap.add_argument("--root", type=Path, default=None,
                    help="with --walk: probe this checkout")
    ap.add_argument("--set", action="append", default=[], type=parse_set,
                    help="with --walk: a build with NAME=V[,NAME=V] set")
    args = ap.parse_args(argv)
    leaves = [int(x) for x in args.leaves.split(",") if x]
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))

    import numpy as np
    import torch

    from chip_smoke import random_rays, write_cornell
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
