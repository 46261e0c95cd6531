"""Resources, occupancy and lane-loop counters of the path megakernels.

    python3 tools/path_probe.py [1] [8] [9]

Kernel 1 (csrc/fused_path.cu) runs on the Cornell box and kernel 8
(csrc/bvh_path.cu) on the 34,818-triangle subdivided box, both at the main
path's 1920x1080, 16 spp, depth 8, 2 light samples (chip_smoke.py phases
6 and 9); the BVH path-replay pair (csrc/prb.cu over a tree: 9a the
training forward, 9b the replay) on the same box at chip_smoke.py phase
12 (c)'s 1920x1080, 4 spp, depth 8, 2 light samples, red wall x 0.6,
together with the whole `make_bvh_train_step`. With no argument the probe
runs all three. For each kernel it prints:

- ptxas's registers, shared memory and spill lines of the port's build
  (ops/cuda_build.NVCC_FLAGS), and what the built kernel reports
  (`*_info`: cudaFuncGetAttributes and
  cudaOccupancyMaxActiveBlocksPerMultiprocessor);
- the kernel's time: CUDA events, one warm-up launch, median of 5;
- the lane-loop counters of a second build made with -DORION_PATH_COUNTERS
  into a temporary directory (render_lane.cuh): the split of a thread's
  cycles among nearest-hit queries, NEE and the rest (shading, RNG, the
  bounce), the SIMT efficiency of the loop (active lanes per warp
  iteration / 32) and of NEE's entries, the cycles from a warp's (and a
  block's) first lane running out of pixels to its last;
- for 9b, the replay's share of cycles in its adjoint accumulation and
  the collisions there: a warp entry's active lanes, its distinct
  materials, the collision degree (the mean over lanes of the lanes on
  the lane's material) and the largest group of an entry; and the atomic
  instructions of the replay in the built library's SASS (`cuobjdump
  -sass`): a shared double add compiled to a compare-and-swap loop shows
  as ATOMS.CAST.SPIN.64 or ATOMS.CAS.64;
- for 9a and 9b, the registers, spills and time of builds for 5 to 12
  resident blocks an SM (TRAIN_BLOCKS; prb.cu's -DORION_PRB_BLOCKS), and
  the train step's time;
- for kernel 8, the nodes and leaves a walk of the plain version
  (`bvh_path_plain`, the skip-pointer walk) visits at 256x256, 16 spp,
  depth 8, the yardstick of the walk's work.

The card's name and power limit and its SM clock are printed first. The
instrumented kernels are slower than the port's (clock64() and atomics):
their counters give shares and ratios, their times are not the kernels'.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

RES, SAMPLES, DEPTH, LIGHT_SAMPLES = (1920, 1080), 16, 8, 2
PLAIN_RES = (256, 256)
REPS = 5
TRAIN_SEED = 3
# the pair's kernels in prb.cu's ptxas report and SASS: the names and a
# string their mangled names contain
TRAIN_KERNELS = ("bvh_prb_fwd_kernel", "bvh_prb_replay_kernel")
TRAIN_ALSO = ()
# the resident blocks an SM that the pair is built for in the sweep
# (prb.cu's -DORION_PRB_BLOCKS)
TRAIN_BLOCKS = (5, 6, 7, 8, 9, 10, 12)
COUNTERS = ("lane_cycles", "nearest_cycles", "nee_cycles", "iters",
            "iter_lanes", "nee_iters", "nee_lanes", "warp_tail", "warps",
            "block_tail", "blocks", "lanes", "acc_cycles", "acc_entries",
            "acc_lanes", "acc_groups", "acc_peers", "acc_max")


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_LOGS: dict = {}


def _nvcc(src: str, out: Path, defines=()) -> str:
    """Build csrc/<src>.cu into `out` (once per output path); nvcc's
    report."""
    from orion_tpu_torch.ops import cuda_build

    if out in _LOGS:
        return _LOGS[out]
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *defines, "-o",
           str(out), str(cuda_build.CSRC / f"{src}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src} {defines}: {res.stdout}{res.stderr}")
    _LOGS[out] = res.stdout + res.stderr
    return _LOGS[out]


def _ptxas_lines(log: str, kernel: str, *also: str):
    """ptxas's lines about `kernel` (its mangled name contains it and
    every string of `also`)."""
    lines = log.splitlines()
    keep = []
    for i, line in enumerate(lines):
        if ("Compiling entry function" in line and kernel in line
                and all(a in line for a in also)):
            keep += [l.strip() for l in lines[i + 1:i + 4]
                     if "Compiling" not in l]
    return keep


def _sass_atomics(sass: str, kernel: str, *also: str) -> dict:
    """{opcode: count} of the atomic and reduction instructions (ATOM*,
    RED*) in the SASS of the functions whose names contain `kernel` and
    every string of `also` (cuobjdump -sass's text)."""
    counts = collections.Counter()
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if kernel in name and all(a in name for a in also):
            counts.update(re.findall(r"\b((?:ATOM|RED)[A-Z]*(?:\.[A-Z0-9_]+)*)",
                                     part))
    return dict(counts)


def _cuobjdump(so: Path) -> str:
    from orion_tpu_torch.ops import cuda_build

    tool = Path(cuda_build._nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump {so}: {res.stderr}")
    return res.stdout


def _median_ms(fn) -> tuple:
    import torch

    out = fn()                                # warm-up
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), times, out


def _report_counters(name: str, c: dict) -> None:
    lanes = max(c["lanes"], 1)
    cyc = max(c["lane_cycles"], 1)
    print(f"[{name}] counters: {c}")
    if not c["lanes"]:
        return
    split = c["nearest_cycles"] + c["nee_cycles"] + c["acc_cycles"]
    print(f"[{name}] a thread: {c['lane_cycles'] / lanes:.6g} cycles; "
          f"nearest-hit queries {c['nearest_cycles'] / cyc:.4f}, NEE "
          f"{c['nee_cycles'] / cyc:.4f}, the rest (shading, RNG, bounce, "
          f"loop) {1 - split / cyc:.4f}")
    print(f"[{name}] SIMT efficiency: loop "
          f"{c['iter_lanes'] / max(32 * c['iters'], 1):.4f} over "
          f"{c['iters']} warp iterations ({c['iters'] / max(c['warps'], 1):.1f}"
          f" a warp), NEE entries "
          f"{c['nee_lanes'] / max(32 * c['nee_iters'], 1):.4f}")
    wt = c["warp_tail"] / max(c["warps"], 1)
    bt = c["block_tail"] / max(c["blocks"], 1)
    per_lane = c["lane_cycles"] / lanes
    print(f"[{name}] tail: first to last lane finishing {wt:.6g} cycles a "
          f"warp ({wt / per_lane:.4f} of a thread's cycles), {bt:.6g} a "
          f"block ({bt / per_lane:.4f})")
    if c["acc_entries"]:
        e = c["acc_entries"]
        print(f"[{name}] adjoint accumulation: {c['acc_cycles'] / cyc:.4f} "
              f"of a thread's cycles; a warp entry: "
              f"{c['acc_lanes'] / e:.4f} active lanes, "
              f"{c['acc_groups'] / e:.4f} distinct materials, collision "
              f"degree {c['acc_peers'] / max(c['acc_lanes'], 1):.4f}, "
              f"largest group {c['acc_max'] / e:.4f} ({e} entries)")


def _same(a, b) -> str:
    """'equal', or the largest difference as a share of b's largest
    entry (a replay's atomic sums vary in their last bits)."""
    import torch

    if torch.equal(a, b):
        return "equal"
    err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    return f"NOT equal (largest difference {err:.3g} of the largest entry)"


@contextlib.contextmanager
def _swapped(mod, attr: str, lib, symbol: str):
    """`mod.<attr>` (a CudaKernel) launching `symbol` of `lib` instead of
    the port's build, with the same launch count."""
    from orion_tpu_torch.ops import cuda_build

    real = getattr(mod, attr)
    k = cuda_build.CudaKernel(real.source, symbol, [])
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = real.argtypes, ctypes.c_int
    k._fn = fn
    setattr(mod, attr, k)
    try:
        yield
    finally:
        setattr(mod, attr, real)


def _run(name, src, symbol, kernel_name, info, launch, tmp: Path,
         attr: str = "KERNEL", also=()) -> None:
    """Time `launch()` on the port's build, then run it once on the
    instrumented build of `src` (the kernel of `launch.module` named
    `attr` swapped for the instrumented library's `symbol`) and print the
    counters. `kernel_name` and `also` pick the kernel's ptxas lines."""
    so = tmp / f"{src}.so"
    log = _nvcc(src, so)
    for line in _ptxas_lines(log, kernel_name, *also):
        print(f"[{name}] ptxas: {line}")
    lib = ctypes.CDLL(str(so))
    out = (ctypes.c_int * 4)()
    rc = info(lib, out)
    print(f"[{name}] built kernel: {out[1]} registers, {out[2]} B local "
          f"(spill) a thread, {out[3]} B static shared; {out[0]} resident "
          f"blocks of {128} threads an SM (rc {rc})")

    ms, times, img = _median_ms(launch)
    print(f"[{name}] kernel {ms:.3f} ms (runs "
          f"{', '.join(f'{t:.3f}' for t in times)}), output mean "
          f"{float(img.mean()):.9g}", flush=True)

    pc_so = tmp / f"{src}_counters.so"
    log = _nvcc(src, pc_so, ("-DORION_PATH_COUNTERS",))
    pc = ctypes.CDLL(str(pc_so))
    import torch

    with _swapped(sys.modules[launch.module], attr, pc, symbol):
        if pc.path_counters_reset() != 0:
            raise RuntimeError("path_counters_reset failed")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        img_c = launch()
        b.record()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * len(COUNTERS))()
        if pc.path_counters_read(buf) != 0:
            raise RuntimeError("path_counters_read failed")
    print(f"[{name}] instrumented kernel {a.elapsed_time(b):.3f} ms, output "
          f"{_same(img_c, img)} to the port's build")
    _report_counters(name, dict(zip(COUNTERS, buf)))


def _probe_path_kernels(tmp: Path, dev) -> None:
    """Kernels 1 and 8 at the render main path's shapes."""
    import torch

    from chip_smoke import BIG_LEVELS, write_cornell
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.ops import fused_path as fp
    from orion_tpu_torch.scene import load_scene

    W, H = RES
    cfg = (W, H, SAMPLES, DEPTH, LIGHT_SAMPLES)
    cornell, rtc = load_scene(write_cornell(tmp / "c", xres=W, yres=H,
                                            depth=DEPTH), device=dev)
    cam = camera_from_rtc(rtc, device=dev)
    args = fp.fused_args(cornell, cam)
    t_pad = int(args[0].shape[0])

    def fused():
        return fp.fused_path(*args, 0, *cfg)

    fused.module = fp.__name__
    _run("kernel 1", "fused_path", "fused_path_launch", "fused_path_kernel",
         lambda lib, out: lib.fused_path_info(t_pad, out), fused, tmp)

    big, _ = load_scene(write_cornell(tmp / "b", xres=64, yres=64, depth=4,
                                      levels=BIG_LEVELS), device=dev)
    fn = bp.make_bvh_path_renderer(big, cam, samples=SAMPLES,
                                   max_depth=DEPTH,
                                   light_samples=LIGHT_SAMPLES)

    def bvh():
        return fn(0)

    bvh.module = bp.__name__
    _run("kernel 8", "bvh_path", "bvh_path_launch", "bvh_path_kernel",
         lambda lib, out: lib.bvh_path_info(out), bvh, tmp)

    # the plain version's walk at PLAIN_RES: rays walked, nodes and
    # leaves visited
    walks = [0]
    real_nearest = bp.TreeData.nearest

    def counted(self, woop, orig, dirs, cap, stats, any_hit=False):
        walks[0] += int(orig.shape[0])
        return real_nearest(self, woop, orig, dirs, cap, stats, any_hit)

    bp.TreeData.nearest = counted
    try:
        dd = fn.data
        stats = {}
        pw, ph = PLAIN_RES
        bp.bvh_path_plain(dd["nodes"], dd["tab"], dd["em"], dd["cam"], 0,
                          pw, ph, SAMPLES, DEPTH, LIGHT_SAMPLES,
                          leaf_width=dd["leaf_width"], copies=dd["copies"],
                          stats=stats)
    finally:
        bp.TreeData.nearest = real_nearest
    print(f"[kernel 8] plain skip-pointer walk at {pw}x{ph}: {walks[0]} "
          f"walks, nodes a walk {stats['box_tests'] / walks[0]:.3f}, leaves "
          f"a walk {stats['leaf_visits'] / walks[0]:.3f}, Woop tests of real "
          f"rows a walk {stats['tests'] / walks[0]:.3f}")


def _probe_train_pair(tmp: Path, dev) -> None:
    """Kernels 9a and 9b, and the train step, at phase 12 (c)'s shapes."""
    import dataclasses

    import torch

    from chip_smoke import BIG_LEVELS, TRAIN, write_cornell
    from orion_tpu_torch import engine
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.ops import bvh_prb as bvp

    W, H, S = TRAIN["xres"], TRAIN["yres"], TRAIN["samples"]
    tcfg = dict(samples=S, max_depth=TRAIN["depth"],
                light_samples=TRAIN["light_samples"])
    ps = engine.prepare(write_cornell(tmp / "t", xres=W, yres=H,
                                      depth=TRAIN["depth"],
                                      levels=BIG_LEVELS), device=dev)
    target = bp.make_bvh_path_renderer(ps.scene, ps.camera,
                                       **tcfg)(TRAIN_SEED)
    kd = ps.scene.mat_diffuse.clone()
    red = int(torch.argmax(kd[:, 0] - kd[:, 1]))
    kd[red] *= 0.6
    pert = dataclasses.replace(ps.scene, mat_diffuse=kd)
    params = {"mat_diffuse": kd, "mat_emissive": pert.mat_emissive}
    step = bvp.make_bvh_train_step(pert, ps.camera, target,
                                   order_signs=ps.order_signs,
                                   dynamic_params=True, **tcfg)
    plan = step.plan
    tab = plan.table(kd, pert.mat_emissive)
    # every build of prb.cu that the probe loads, one nvcc each, together
    builds = [("prb", tmp / "prb.so", ()),
              ("prb", tmp / "prb_counters.so", ("-DORION_PATH_COUNTERS",))]
    builds += [("prb", tmp / f"prb_{b}.so", (f"-DORION_PRB_BLOCKS={b}",))
               for b in TRAIN_BLOCKS]
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: _nvcc(*b), builds))

    def fwd():
        return plan.forward(tab, TRAIN_SEED)[0]

    img, ls = plan.forward(tab, TRAIN_SEED)
    w = ((img.reshape(H, W, 3) - target) * (2.0 / (H * W * 3 * S))
         ).reshape(-1, 3).contiguous()

    def replay():
        return plan.replay(tab, TRAIN_SEED, w, ls)

    fwd.module = replay.module = bvp.__name__
    for name, fn, attr, symbol, kernel, which in (
            ("9a", fwd, "FWD_KERNEL", "bvh_prb_fwd_ls_launch",
             TRAIN_KERNELS[0], 0),
            ("9b", replay, "REPLAY_KERNEL", "bvh_prb_replay_launch",
             TRAIN_KERNELS[1], 1)):
        _run(f"kernel {name}", "prb", symbol, kernel,
             lambda lib, out, which=which: lib.bvh_prb_info(which, out), fn,
             tmp, attr=attr, also=TRAIN_ALSO)
    atoms = _sass_atomics(_cuobjdump(tmp / "prb.so"), TRAIN_KERNELS[1],
                          *TRAIN_ALSO)
    print(f"[kernel 9b] SASS atomics of the replay: {atoms}")
    mod = sys.modules[bvp.__name__]
    for blocks in TRAIN_BLOCKS:
        so = tmp / f"prb_{blocks}.so"
        log = _nvcc("prb", so, (f"-DORION_PRB_BLOCKS={blocks}",))
        lib = ctypes.CDLL(str(so))
        for name, fn, attr, symbol, kernel, which in (
                ("9a", fwd, "FWD_KERNEL", "bvh_prb_fwd_ls_launch",
                 TRAIN_KERNELS[0], 0),
                ("9b", replay, "REPLAY_KERNEL", "bvh_prb_replay_launch",
                 TRAIN_KERNELS[1], 1)):
            out = (ctypes.c_int * 4)()
            lib.bvh_prb_info(which, out)
            spill = " ".join(_ptxas_lines(log, kernel, *TRAIN_ALSO)[1:2])
            with _swapped(mod, attr, lib, symbol):
                ms, times, _ = _median_ms(fn)
            print(f"[kernel {name}] built for {blocks} blocks: {out[1]} "
                  f"registers, {out[0]} resident ({spill}); {ms:.3f} ms "
                  f"(runs {', '.join(f'{t:.3f}' for t in times)})",
                  flush=True)
    ms, times, _ = _median_ms(lambda: step(params, TRAIN_SEED)[0])
    print(f"[train step] fwd + replay + loss + table: {ms:.3f} ms (runs "
          f"{', '.join(f'{t:.3f}' for t in times)})")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: path_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    which = set(argv) or {"1", "8", "9"}
    print(_smi("name,power.limit"))
    print(f"SM clock {_smi('clocks.sm')}, max {_smi('clocks.max.sm')}")
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if which & {"1", "8"}:
            _probe_path_kernels(tmp, dev)
        if "9" in which:
            _probe_train_pair(tmp, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
