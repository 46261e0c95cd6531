"""Resources, occupancy and lane-loop counters of the path megakernels
and of the BVH Whitted kernels.

    python3 tools/path_probe.py [1] [8] [9] [3] [w] [--root CHECKOUT]

Kernel 1 (csrc/fused_path.cu) runs on the Cornell box and kernel 8
(csrc/bvh_path.cu) on the 34,818-triangle subdivided box, both at the main
path's 1920x1080, 16 spp, depth 8, 2 light samples (chip_smoke.py phases
6 and 9); the BVH path-replay pair (`9`: csrc/prb.cu over a tree, 9a the
training forward, 9b the replay) on the same box at chip_smoke.py phase
12 (c)'s 1920x1080, 4 spp, depth 8, 2 light samples, red wall x 0.6,
together with the whole `make_bvh_train_step`; the path-replay pair over
the swept table (`3`: 3a, 3b) on the Cornell box at phase 7's same
shapes, with the whole `make_fused_train_step`; the BVH Whitted kernels
(`w`: csrc/bvh_whitted.cu, 7a untextured and 7b with its checker) on the
levels-5 point-light box at chip_smoke.py phase 12's 1920x1080, 4 spp,
depth 4, one light, and with them the Whitted kernel over the swept table
(kernel 4, csrc/whitted.cu) on the point-light Cornell box at phase 8's
same shapes. With no argument the probe runs all five. `--root CHECKOUT` probes another checkout's package
and kernel sources (its `orion_tpu_torch` and `chip_smoke` come first on
sys.path): a checkout whose 3a/3b still run fused_common.cuh's
one-thread-a-pixel `path_lane`, which has no counter hooks, is built
from copies of its sources with the hooks put in (`hook_path_lane`) and
a `prb_info` added; its port build is the same code, the hooks being
macros of the instrumented build; a checkout whose 7a/7b still run
whitted_common.cuh's one-thread-a-pixel `whitted_lane` gets the hooks the
same way (`hook_whitted_lane`), and so does one whose kernel 4 runs it
(`hook_whitted4`). For each kernel it prints:

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
- for kernel 1, its paired shadow sweeps (two light samples a sweep):
  their warp entries per NEE entry, their SIMT efficiency, and the shares
  of their lanes that need both samples' winners and that need one (the
  other draw's geometry term is <= 0);
- for 3b and 9b, the replay's share of cycles in its adjoint accumulation and
  the collisions there: a warp entry's active lanes, its distinct
  materials, the collision degree (the mean over lanes of the lanes on
  the lane's material) and the largest group of an entry; and the atomic
  instructions of the replay in the built library's SASS (`cuobjdump
  -sass`): a shared double add compiled to a compare-and-swap loop shows
  as ATOMS.CAST.SPIN.64 or ATOMS.CAS.64;
- for each training pair, the registers, spills and time of builds for
  6 to 12 resident blocks an SM (TRAIN_BLOCKS): copies of csrc/prb.cu
  with the pair's `constexpr int` (BLOCKS_CONSTANT: kTableBlocks,
  kTreeBlocks) rewritten (`with_constant`), one nvcc each, all started
  together; and the train step's time;
- for 7a and 7b (persistent lanes), builds of copies of
  csrc/bvh_whitted.cu with its `kWhittedBlocks` rewritten
  (WHITTED_BUILDS), both kernels timed in each build (median of
  WHITTED_REPS); their counters' "NEE" is the Whitted lane's shadow
  walks and light terms;
- for kernel 4, its image's digest, the loops of its SASS (`sass_loops`:
  each backward branch's body, its instructions and their opcodes; the
  row loops of the nearest and shadow sweeps are the short ones), and,
  where it runs persistent lanes, builds of copies of csrc/whitted.cu
  with `kTableWhittedBlocks` rewritten (TABLE_WHITTED_BUILDS);
- for kernel 8, the nodes and leaves a walk of the plain version
  (`bvh_path_plain`, the skip-pointer walk) visits at 256x256, 16 spp,
  depth 8, the yardstick of the walk's work.

The card's name and power limit and its SM clock are printed first. The
instrumented kernels are slower than the port's (clock64() and atomics):
their counters give shares and ratios, their times are not the kernels'.
"""

from __future__ import annotations

import argparse
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
from tools.ab_turns import (card, red_wall_problem, train_case,  # noqa: E402
                            with_constant)

RES, SAMPLES, DEPTH, LIGHT_SAMPLES = (1920, 1080), 16, 8, 2
PLAIN_RES = (256, 256)
REPS = 5
TRAIN_SEED = 3
KERNELS = ("1", "8", "9", "3", "w")
# each pair's kernels in prb.cu's ptxas report and SASS: the names and the
# strings their mangled names contain (the table pair's parameters are
# PathParamsT<RGeo>, or <Geo> in a checkout of path_lane; the tree pair's
# PathParamsT<Tree>)
TREE_KERNELS = ("bvh_prb_fwd_kernel", "bvh_prb_replay_kernel")
TREE_ALSO = ()
TABLE_KERNELS = ("prb_fwd_ls_kernel", "prb_replay_kernel")
TABLE_ALSO = ("Geo",)
# the resident blocks an SM that each pair is built for in the sweep
# (prb.cu's constexpr BLOCKS_CONSTANT[pair])
BLOCKS_CONSTANT = {"3": "kTableBlocks", "9": "kTreeBlocks"}
TRAIN_BLOCKS = (6, 7, 8, 9, 10, 11, 12)
# the copies of csrc/bvh_whitted.cu that the Whitted sweep builds (its
# resident blocks), and the median of WHITTED_REPS launches each (a
# Whitted render's times spread by ~10% from launch to launch)
WHITTED_BUILDS = [{"kWhittedBlocks": b} for b in TRAIN_BLOCKS]
WHITTED_REPS = 11
# the copies of csrc/whitted.cu that kernel 4's sweep builds
TABLE_WHITTED_BUILDS = [{"kTableWhittedBlocks": b} for b in (6, 7, 8, 9, 10)]
# loops of kernel 4's SASS printed, shortest first
SASS_LOOPS = 8
COUNTERS = ("lane_cycles", "nearest_cycles", "nee_cycles", "iters",
            "iter_lanes", "nee_iters", "nee_lanes", "warp_tail", "warps",
            "block_tail", "blocks", "lanes", "acc_cycles", "acc_entries",
            "acc_lanes", "acc_groups", "acc_peers", "acc_max", "pair_iters",
            "pair_lanes", "pair_both", "pair_one")


_LOGS: dict = {}


def _nvcc(src, out: Path, defines=()) -> str:
    """Build csrc/<src>.cu, or the source file `src` (a Path, its
    includes found in csrc/), into `out` (once per output path); nvcc's
    report."""
    from orion_tpu_torch.ops import cuda_build

    if out in _LOGS:
        return _LOGS[out]
    cu = src if isinstance(src, Path) else cuda_build.CSRC / f"{src}.cu"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *defines,
           "-I", str(cuda_build.CSRC), "-o", str(out), str(cu)]
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


def _median_ms(fn, reps: int = REPS) -> tuple:
    import torch

    out = fn()                                # warm-up
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


def _report_counters(name: str, c: dict, nee: str = "NEE") -> None:
    lanes = max(c["lanes"], 1)
    cyc = max(c["lane_cycles"], 1)
    print(f"[{name}] counters: {c}")
    if not c["lanes"]:
        return
    split = c["nearest_cycles"] + c["nee_cycles"] + c["acc_cycles"]
    print(f"[{name}] a thread: {c['lane_cycles'] / lanes:.6g} cycles; "
          f"nearest-hit queries {c['nearest_cycles'] / cyc:.4f}, {nee} "
          f"{c['nee_cycles'] / cyc:.4f}, the rest (shading, RNG, bounce, "
          f"loop) {1 - split / cyc:.4f}")
    print(f"[{name}] SIMT efficiency: loop "
          f"{c['iter_lanes'] / max(32 * c['iters'], 1):.4f} over "
          f"{c['iters']} warp iterations ({c['iters'] / max(c['warps'], 1):.1f}"
          f" a warp), {nee} entries "
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
    if c["pair_iters"]:
        e, n = c["pair_iters"], max(c["pair_lanes"], 1)
        print(f"[{name}] paired shadow sweeps: {e} warp entries "
              f"({e / max(c['nee_iters'], 1):.4f} a {nee} entry), SIMT "
              f"{c['pair_lanes'] / (32 * e):.4f}; of their lanes "
              f"{c['pair_both'] / n:.4f} need both samples' winners, "
              f"{c['pair_one'] / n:.4f} one")


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
         attr: str = "KERNEL", also=(), tag: str | None = None,
         nee: str = "NEE") -> None:
    """Time `launch()` on the port's build, then run it once on the
    instrumented build of `src` (the kernel of `launch.module` named
    `attr` swapped for the instrumented library's `symbol`) and print the
    counters. `kernel_name` and `also` pick the kernel's ptxas lines;
    the builds are tmp/<tag>.so and tmp/<tag>_counters.so (tag: src)."""
    tag = tag or src
    so = tmp / f"{tag}.so"
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

    pc_so = tmp / f"{tag}_counters.so"
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
    _report_counters(name, dict(zip(COUNTERS, buf)), nee)


def _probe_path_kernels(tmp: Path, dev, kernels) -> None:
    """Kernels 1 and 8 (those of `kernels`) at the render main path's
    shapes."""
    import torch

    from chip_smoke import BIG_LEVELS
    from cornell_scenes import write_cornell
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
    if "1" in kernels:
        _run("kernel 1", "fused_path", "fused_path_launch",
             "fused_path_kernel",
             lambda lib, out: lib.fused_path_info(t_pad, out), fused, tmp)
    if "8" not in kernels:
        return

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


# ---------------------------------------------------------------------------
# the training pairs
# ---------------------------------------------------------------------------

# A checkout whose 3a/3b run fused_common.cuh's one-thread-a-pixel
# `path_lane` has no counter hooks in it. hook_path_lane moves path_lane
# (from PATH_LANE_START to fused_common.cuh's last NAMESPACE_END) to the
# end of render_lane.cuh's namespace (before RENDER_LANE_END), where the
# counters are declared, and puts in the hooks of render_lanes: each
# (text, replacement) of LANE_HOOKS in path_lane and of KERNEL_HOOKS in
# prb.cu, each text found exactly once; prb.cu gains PRB_INFO. The
# uninstrumented build of the copy is the checkout's own code.
PATH_LANE_START = "// One pixel lane, until its sample index reaches p.samples."
NAMESPACE_END = "}  // namespace orion"
RENDER_LANE_END = "}  // namespace orion\n\n#ifdef ORION_PATH_COUNTERS\n"
LANE_HOOKS = (
    ("double* sacc, float ek[3]) {",
     "double* sacc, float ek[3] ORION_PC_ARG) {"),
    ("  while (samp < p.samples) {\n    float t;\n"
     "    const int row = nearest<kCols>(p.geo, sgeo, r, kBig, t);\n",
     "  while (samp < p.samples) {\n"
     "    ORION_PC(pc_warp_vote(pc.iters, pc.iter_lanes);\n"
     "             const long long pc0 = clock64();)\n    float t;\n"
     "    const int row = nearest<kCols>(p.geo, sgeo, r, kBig, t);\n"
     "    ORION_PC(pc.nearest += clock64() - pc0;)\n"),
    ("      nee<kLegacy>(p, sgeo, upix, site_sd, hx, hy, hz, gnx, gny, gnz, "
     "snx,\n                   sny, snz, A, sum_scale);\n",
     "      ORION_PC(pc_warp_vote(pc.nee_iters, pc.nee_lanes);\n"
     "               const long long pc1 = clock64();)\n"
     "      nee<kLegacy>(p, sgeo, upix, site_sd, hx, hy, hz, gnx, gny, gnz, "
     "snx,\n                   sny, snz, A, sum_scale);\n"
     "      ORION_PC(pc.nee += clock64() - pc1;)\n"),
    ("        if (kMode == kReplay) {\n          // closed-form adjoints",
     "        if (kMode == kReplay) {\n"
     "          ORION_PC(const long long pc2 = clock64();)\n"
     "          // closed-form adjoints"),
    ("          const int mat = static_cast<int>(__ldg(g + C_MESH));\n",
     "          const int mat = static_cast<int>(__ldg(g + C_MESH));\n"
     "          ORION_PC(pc_acc_vote(pc, mat);)\n"),
    ("            ek[ch] += wT * kd[ch] * sum_scale;\n          }\n",
     "            ek[ch] += wT * kd[ch] * sum_scale;\n          }\n"
     "          ORION_PC(pc.acc += clock64() - pc2;)\n"),
    ("  if (kMode != kReplay) {\n    const float inv_s",
     "  ORION_PC(pc.t_done = clock64();)\n"
     "  if (kMode != kReplay) {\n    const float inv_s"),
)
KERNEL_HOOKS = (
    ("  if (pix >= p.W * p.H) return;\n"
     "  path_lane<true, kForwardLs>(p, sgeo, pix, nullptr, nullptr);\n",
     "#ifdef ORION_PATH_COUNTERS\n"
     "  LaneCounters pc;\n  pc.t_start = pc.t_done = clock64();\n"
     "  if (pix < p.W * p.H)\n"
     "    path_lane<true, kForwardLs>(p, sgeo, pix, nullptr, nullptr, pc);\n"
     "  pc_flush(pc);\n  __syncwarp();\n  pc_exit(pc.t_done);\n#else\n"
     "  if (pix >= p.W * p.H) return;\n"
     "  path_lane<true, kForwardLs>(p, sgeo, pix, nullptr, nullptr);\n"
     "#endif\n"),
    ("  if (pix < p.W * p.H) path_lane<true, kReplay>(p, sgeo, pix, sacc, "
     "ek);\n",
     "  ORION_PC(LaneCounters pc; pc.t_start = pc.t_done = clock64();)\n"
     "  if (pix < p.W * p.H)\n"
     "    path_lane<true, kReplay>(p, sgeo, pix, sacc, ek ORION_PC(, pc));\n"
     "  ORION_PC(pc_flush(pc); __syncwarp(); pc_exit(pc.t_done);)\n"),
)
PRB_INFO = """
// out = render_lane.cuh's kernel_info of 3a (which 0) or 3b (which 1) at
// the shared memory of a resident table of T_pad rows (path_probe.py)
extern "C" int prb_info(int which, int T_pad, int* out) {
  const size_t smem = T_pad <= kChunk ? sizeof(float) * T_pad * kGeo : 0;
  return which == 0 ? kernel_info(prb_fwd_ls_kernel<Geo>, smem, out)
                    : kernel_info(prb_replay_kernel<Geo>, smem, out);
}
"""


def _sub_once(text: str, old: str, new: str, where: str) -> str:
    n = text.count(old)
    if n != 1:
        raise ValueError(f"{where}: {n} matches of "
                         f"{old.strip().splitlines()[0]!r}")
    return text.replace(old, new)


def hook_path_lane(files: dict) -> dict:
    """{name: text} of fused_common.cuh, render_lane.cuh and prb.cu of a
    checkout whose 3a/3b run `path_lane`, rewritten with the counter
    hooks (see LANE_HOOKS); ValueError where a text to replace is not
    found exactly once."""
    fc = files["fused_common.cuh"]
    a, b = fc.find(PATH_LANE_START), fc.rfind(NAMESPACE_END)
    if a < 0 or b < a:
        raise ValueError("fused_common.cuh: no path_lane")
    lane = fc[a:b]
    for old, new in LANE_HOOKS:
        lane = _sub_once(lane, old, new, "path_lane")
    prb = files["prb.cu"]
    for old, new in KERNEL_HOOKS:
        prb = _sub_once(prb, old, new, "prb.cu")
    return {"fused_common.cuh": fc[:a] + fc[b:],
            "render_lane.cuh": _sub_once(files["render_lane.cuh"],
                                         RENDER_LANE_END,
                                         lane + RENDER_LANE_END,
                                         "render_lane.cuh"),
            "prb.cu": prb + PRB_INFO}


def prb_sources(csrc: Path, out: Path) -> bool:
    """Copy `csrc`'s prb.cu and headers into `out`, the copies rewritten
    by hook_path_lane where prb.cu runs `path_lane` (then True)."""
    out.mkdir(parents=True, exist_ok=True)
    files = {f.name: f.read_text()
             for f in [csrc / "prb.cu", *sorted(csrc.glob("*.cuh"))]}
    path_lane = "path_lane<" in files["prb.cu"]
    if path_lane:
        files.update(hook_path_lane(files))
    for name, text in files.items():
        (out / name).write_text(text)
    return path_lane


def sweep_sources(src: Path, pair: str) -> dict:
    """{blocks: path} of copies of src/prb.cu beside it, each with the
    pair's BLOCKS_CONSTANT set to one value of TRAIN_BLOCKS."""
    text = (src / "prb.cu").read_text()
    out = {}
    for b in TRAIN_BLOCKS:
        out[b] = src / f"prb_blocks_{b}.cu"
        out[b].write_text(with_constant(text, BLOCKS_CONSTANT[pair], b))
    return out


def _probe_pair(pair: str, tmp: Path, dev) -> None:
    """Kernels 3a and 3b (pair "3", the Cornell box at phase 7's shapes)
    or 9a and 9b (pair "9", the subdivided box at phase 12 (c)'s), the
    sweep of their resident blocks, and the train step."""
    from chip_smoke import BIG_LEVELS, TRAIN
    from cornell_scenes import write_cornell
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.ops import bvh_prb as bvp
    from orion_tpu_torch.ops import cuda_build
    from orion_tpu_torch.ops import fused_path as fp
    from orion_tpu_torch.ops import prb

    W, H = TRAIN["xres"], TRAIN["yres"]
    if pair == "3":
        rtc = write_cornell(tmp / "c3", xres=W, yres=H, depth=TRAIN["depth"])
        case = train_case(red_wall_problem(rtc, dev,
                                           fp.make_fused_path_renderer),
                          prb.make_fused_train_step)
        t_pad = int(case["tab"].shape[0])
        mod, kernels, also = prb, TABLE_KERNELS, TABLE_ALSO
        names = ("3a", "3b")
        symbols = ("prb_fwd_ls_launch", "prb_replay_launch")

        def info(lib, which, out):
            return lib.prb_info(which, t_pad, out)
    else:
        rtc = write_cornell(tmp / "t9", xres=W, yres=H, depth=TRAIN["depth"],
                            levels=BIG_LEVELS)
        pr = red_wall_problem(rtc, dev, bp.make_bvh_path_renderer)
        case = train_case(pr, bvp.make_bvh_train_step,
                          order_signs=pr["ps"].order_signs)
        mod, kernels, also = bvp, TREE_KERNELS, TREE_ALSO
        names = ("9a", "9b")
        symbols = ("bvh_prb_fwd_ls_launch", "bvh_prb_replay_launch")

        def info(lib, which, out):
            return lib.bvh_prb_info(which, out)
    src = tmp / f"prb_{pair}_src"
    path_lane = prb_sources(cuda_build.CSRC, src)
    tag = f"prb_{pair}"
    sweep = {} if path_lane else sweep_sources(src, pair)
    # every build that the probe loads, one nvcc each, together
    builds = [(src / "prb.cu", tmp / f"{tag}.so", ()),
              (src / "prb.cu", tmp / f"{tag}_counters.so",
               ("-DORION_PATH_COUNTERS",))]
    builds += [(cu, tmp / f"{tag}_blocks_{b}.so", ())
               for b, cu in sweep.items()]
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: _nvcc(*b), builds))

    plan, tab, w, ls = case["plan"], case["tab"], case["w"], case["ls"]

    def fwd():
        return plan.forward(tab, TRAIN_SEED)[0]

    def replay():
        return plan.replay(tab, TRAIN_SEED, w, ls)

    fwd.module = replay.module = mod.__name__
    runs = ((names[0], fwd, "FWD_KERNEL", symbols[0], kernels[0], 0),
            (names[1], replay, "REPLAY_KERNEL", symbols[1], kernels[1], 1))
    if path_lane:
        print(f"[kernels {'/'.join(names)}] path_lane: counter hooks put "
              f"into a copy of the sources")
    for name, fn, attr, symbol, kernel, which in runs:
        _run(f"kernel {name}", src / "prb.cu", symbol, kernel,
             lambda lib, out, which=which: info(lib, which, out), fn, tmp,
             attr=attr, also=also, tag=tag)
    atoms = _sass_atomics(_cuobjdump(tmp / f"{tag}.so"), kernels[1], *also)
    print(f"[kernel {names[1]}] SASS atomics of the replay: {atoms}")
    for blocks, cu in sweep.items():
        so = tmp / f"{tag}_blocks_{blocks}.so"
        log = _nvcc(cu, so)
        lib = ctypes.CDLL(str(so))
        for name, fn, attr, symbol, kernel, which in runs:
            out = (ctypes.c_int * 4)()
            info(lib, which, out)
            spill = " ".join(_ptxas_lines(log, kernel, *also)[1:2])
            with _swapped(sys.modules[mod.__name__], attr, lib, symbol):
                ms, times, _ = _median_ms(fn)
            print(f"[kernel {name}] built for {blocks} blocks: {out[1]} "
                  f"registers, {out[0]} resident ({spill}); {ms:.3f} ms "
                  f"(runs {', '.join(f'{t:.3f}' for t in times)})",
                  flush=True)
    step, params = case["step"], case["params"]
    ms, times, _ = _median_ms(lambda: step(params, TRAIN_SEED)[0])
    print(f"[train step {'/'.join(names)}] fwd + replay + loss + table: "
          f"{ms:.3f} ms (runs {', '.join(f'{t:.3f}' for t in times)})")


# ---------------------------------------------------------------------------
# the BVH Whitted kernels
# ---------------------------------------------------------------------------

# A checkout whose 7a/7b run whitted_common.cuh's one-thread-a-pixel
# `whitted_lane` has no counter hooks in it.
# hook_whitted_lane includes render_lane.cuh (the counters) in
# whitted_common.cuh, puts the hooks of whitted_lanes into whitted_lane
# (from WHITTED_LANE_START to the end of the function), each text of
# WHITTED_LANE_HOOKS found there exactly once, and the kernel hooks of
# WHITTED_KERNEL_HOOKS into bvh_whitted.cu, which gains WHITTED_INFO. The
# uninstrumented build of the copy is the checkout's own code.
WHITTED_LANE_START = ("// One pixel lane, until its sample index reaches "
                      "p.samples; writes the")
WHITTED_INCLUDE = ('#include "fused_common.cuh"\n',
                   '#include "render_lane.cuh"\n')
WHITTED_LANE_HOOKS = (
    ("                                             const Tex& tex = Tex()) {\n",
     "                                             const Tex& tex = Tex()\n"
     "                                 ORION_PC(, LaneCounters* pcp = "
     "nullptr)) {\n  ORION_PC(LaneCounters& pc = *pcp;)\n"),
    ("  while (samp < p.samples) {\n    float t;\n"
     "    const int row = nearest<kStride>(p.geo, sgeo, r, kBig, t);\n",
     "  while (samp < p.samples) {\n"
     "    ORION_PC(pc_warp_vote(pc.iters, pc.iter_lanes);\n"
     "             const long long pc0 = clock64();)\n    float t;\n"
     "    const int row = nearest<kStride>(p.geo, sgeo, r, kBig, t);\n"
     "    ORION_PC(pc.nearest += clock64() - pc0;)\n"),
    ("      for (int li = 0; li < p.n_lights; ++li) {\n",
     "      ORION_PC(pc_warp_vote(pc.nee_iters, pc.nee_lanes);\n"
     "               const long long pc1 = clock64();)\n"
     "      for (int li = 0; li < p.n_lights; ++li) {\n"),
    ("      }\n#pragma unroll\n"
     "      for (int ch = 0; ch < 3; ++ch) acc[ch] += T[ch] * r3[ch];\n",
     "      }\n      ORION_PC(pc.nee += clock64() - pc1;)\n#pragma unroll\n"
     "      for (int ch = 0; ch < 3; ++ch) acc[ch] += T[ch] * r3[ch];\n"),
    ("  const float inv_s = static_cast<float>(1.0 / p.samples);\n",
     "  ORION_PC(pc.t_done = clock64();)\n"
     "  const float inv_s = static_cast<float>(1.0 / p.samples);\n"),
)
_OLD_GUARD = "  if (lane >= n_lanes || pix >= p.W * p.H) return;\n"


def _whitted_kernel_hook(call: str, counted: str) -> tuple:
    """(text, replacement) of a kernel body that runs `call` per pixel:
    the instrumented build runs `counted` in every thread instead."""
    return (_OLD_GUARD + call,
            "#ifdef ORION_PATH_COUNTERS\n"
            "  LaneCounters pc;\n  pc.t_start = pc.t_done = clock64();\n"
            "  if (lane < n_lanes && pix < p.W * p.H)\n" + counted
            + "  pc_flush(pc);\n  __syncwarp();\n  pc_exit(pc.t_done);\n"
            "#else\n" + _OLD_GUARD + call + "#endif\n")


WHITTED_KERNEL_HOOKS = (
    _whitted_kernel_hook(
        "  whitted_lane(p, nullptr, pix);\n",
        "    whitted_lane(p, nullptr, pix, NoTexel(), &pc);\n"),
    _whitted_kernel_hook(
        "  whitted_lane<Tree, kDCols>(p, nullptr, pix, tex);\n",
        "    whitted_lane<Tree, kDCols>(p, nullptr, pix, tex, &pc);\n"),
)
WHITTED_INFO = """
// out = render_lane.cuh's kernel_info of 7a (which 0) or 7b (which 1)
// (path_probe.py)
extern "C" int bvh_whitted_info(int which, int* out) {
  return which == 0 ? kernel_info(bvh_whitted_kernel, 0, out)
                    : kernel_info(bvh_whitted_textured_kernel, 0, out);
}
"""


def hook_whitted_lane(files: dict) -> dict:
    """{name: text} of whitted_common.cuh and bvh_whitted.cu of a checkout
    whose 7a/7b run `whitted_lane`, rewritten with the counter hooks (see
    WHITTED_LANE_HOOKS); ValueError where a text to replace is not found
    exactly once."""
    wc = files["whitted_common.cuh"]
    a = wc.find(WHITTED_LANE_START)
    b = wc.find("\n}\n", a)
    if a < 0 or b < 0:
        raise ValueError("whitted_common.cuh: no whitted_lane")
    lane = wc[a:b + 3]
    for old, new in WHITTED_LANE_HOOKS:
        lane = _sub_once(lane, old, new, "whitted_lane")
    wc = _sub_once(wc[:a] + lane + wc[b + 3:], *WHITTED_INCLUDE,
                   "whitted_common.cuh")
    bw = files["bvh_whitted.cu"]
    for old, new in WHITTED_KERNEL_HOOKS:
        bw = _sub_once(bw, old, new, "bvh_whitted.cu")
    return {"whitted_common.cuh": wc, "bvh_whitted.cu": bw + WHITTED_INFO}


def whitted_sources(csrc: Path, out: Path) -> bool:
    """Copy `csrc`'s bvh_whitted.cu and headers into `out`, the copies
    rewritten by hook_whitted_lane where 7a/7b run `whitted_lane` (then
    True)."""
    out.mkdir(parents=True, exist_ok=True)
    files = {f.name: f.read_text()
             for f in [csrc / "bvh_whitted.cu", *sorted(csrc.glob("*.cuh"))]}
    per_pixel = "whitted_lanes<" not in files["bvh_whitted.cu"]
    if per_pixel:
        files.update(hook_whitted_lane(files))
    for name, text in files.items():
        (out / name).write_text(text)
    return per_pixel


def whitted_sweep_sources(src: Path) -> dict:
    """{tag: path} of copies of src/bvh_whitted.cu beside it, one for each
    set of constants of WHITTED_BUILDS."""
    text = (src / "bvh_whitted.cu").read_text()
    out = {}
    for consts in WHITTED_BUILDS:
        tag = ",".join(f"{k}={v}" for k, v in consts.items())
        body = text
        for name, v in consts.items():
            body = with_constant(body, name, v)
        out[tag] = src / f"bvh_whitted_sweep_{len(out)}.cu"
        out[tag].write_text(body)
    return out


def _probe_whitted(tmp: Path, dev) -> None:
    """Kernels 7a and 7b at chip_smoke.py phase 12's shapes, and the sweep
    of their resident blocks."""
    from chip_smoke import BIG_LEVELS, WHITTED
    from cornell_scenes import write_cornell_whitted
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import octant_signs
    from orion_tpu_torch.ops import bvh_whitted as bw
    from orion_tpu_torch.ops import cuda_build
    from orion_tpu_torch.scene import load_scene

    W, H, S, D = (WHITTED["xres"], WHITTED["yres"], WHITTED["samples"],
                  WHITTED["depth"])
    src = tmp / "whitted_src"
    per_pixel = whitted_sources(cuda_build.CSRC, src)
    sweep = {} if per_pixel else whitted_sweep_sources(src)
    builds = [(src / "bvh_whitted.cu", tmp / "bw.so", ()),
              (src / "bvh_whitted.cu", tmp / "bw_counters.so",
               ("-DORION_PATH_COUNTERS",))]
    builds += [(cu, tmp / f"bw_sweep_{k}.so", ())
               for k, cu in enumerate(sweep.values())]
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: _nvcc(*b), builds))
    if per_pixel:
        print("[kernels 7a/7b] whitted_lane: counter hooks put into a copy "
              "of the sources")

    renders = {}
    for textured in (False, True):
        rtc = write_cornell_whitted(tmp / f"w{int(textured)}", xres=W,
                                    yres=H, depth=D, levels=BIG_LEVELS,
                                    checker=textured)
        scene, r = load_scene(rtc, device=dev)
        cam = camera_from_rtc(r, device=dev)
        make = (bw.make_bvh_whitted_deferred if textured
                else bw.make_bvh_whitted_renderer)
        renders[textured] = make(scene, cam, samples=S, max_depth=D,
                                 order_signs=octant_signs(cam.front))
    runs = []
    for textured, name, attr, symbol, kernel, which in (
            (False, "7a", "KERNEL", "bvh_whitted_launch",
             "bvh_whitted_kernel", 0),
            (True, "7b", "DEFERRED_KERNEL", "bvh_whitted_textured_launch",
             "bvh_whitted_textured_kernel", 1)):
        fn = renders[textured]

        def launch(fn=fn):
            return fn(0)

        launch.module = bw.__name__
        runs.append((name, launch, attr, symbol, kernel, which))
        _run(f"kernel {name}", src / "bvh_whitted.cu", symbol, kernel,
             lambda lib, out, which=which: lib.bvh_whitted_info(which, out),
             launch, tmp, attr=attr, tag="bw", nee="shadow walks")
    for k, (tag, cu) in enumerate(sweep.items()):
        so = tmp / f"bw_sweep_{k}.so"
        log = _nvcc(cu, so)
        lib = ctypes.CDLL(str(so))
        for name, fn, attr, symbol, kernel, which in runs:
            out = (ctypes.c_int * 4)()
            lib.bvh_whitted_info(which, out)
            spill = " ".join(_ptxas_lines(log, kernel)[1:2])
            with _swapped(bw, attr, lib, symbol):
                ms, times, _ = _median_ms(fn, WHITTED_REPS)
            print(f"[kernel {name}] built with {tag}: {out[1]} "
                  f"registers, {out[0]} resident ({spill}); {ms:.3f} ms "
                  f"(runs {', '.join(f'{t:.3f}' for t in times)})",
                  flush=True)


# ---------------------------------------------------------------------------
# kernel 4, the Whitted kernel over a swept table
# ---------------------------------------------------------------------------

# A checkout whose kernel 4 runs whitted_common.cuh's one-thread-a-pixel
# `whitted_lane` (its vertex the ORION_WHITTED_VERTEX macro, its counters
# never flushed) gets whitted_lanes' counters in a copy: hook_whitted4 puts
# each (text, replacement) of WHITTED4_LANE_HOOKS into whitted_lane (from
# WHITTED_LANE_START to the end of the function) and WHITTED4_KERNEL_HOOK
# into whitted.cu, which gains WHITTED4_INFO. The uninstrumented build of
# the copy is the checkout's own code.
WHITTED4_LANE_HOOKS = (
    ("                                             const Tex& tex = Tex()) {\n"
     "  ORION_PC(LaneCounters pc;)  // counted only by whitted_lanes\n",
     "                                             const Tex& tex = Tex()\n"
     "                                 ORION_PC(, LaneCounters* pcp = "
     "nullptr)) {\n  ORION_PC(LaneCounters& pc = *pcp;)\n"),
    ("  while (samp < p.samples) {\n    ORION_WHITTED_VERTEX(\n",
     "  while (samp < p.samples) {\n"
     "    ORION_PC(pc_warp_vote(pc.iters, pc.iter_lanes);)\n"
     "    ORION_WHITTED_VERTEX(\n"),
    ("  const float inv_s = static_cast<float>(1.0 / p.samples);\n"
     "  float* out = p.out + 3 * (pix - p.pix_base);\n",
     "  ORION_PC(pc.t_done = clock64();)\n"
     "  const float inv_s = static_cast<float>(1.0 / p.samples);\n"
     "  float* out = p.out + 3 * (pix - p.pix_base);\n"),
)
WHITTED4_KERNEL_HOOK = (
    "  if (pix >= p.W * p.H) return;\n  whitted_lane(p, sgeo, pix);\n",
    "#ifdef ORION_PATH_COUNTERS\n"
    "  LaneCounters pc;\n  pc.t_start = pc.t_done = clock64();\n"
    "  if (pix < p.W * p.H) {\n"
    "    whitted_lane(p, sgeo, pix, NoTexel(), &pc);\n"
    "    pc_flush(pc);\n  }\n"
    "  __syncwarp();\n  pc_exit(pc.t_done);\n"
    "#else\n"
    "  if (pix >= p.W * p.H) return;\n  whitted_lane(p, sgeo, pix);\n"
    "#endif\n")
WHITTED4_INFO = """
// out = render_lane.cuh's kernel_info of the kernel at the shared memory of
// a resident table of T_pad rows (path_probe.py)
extern "C" int whitted_info(int T_pad, int* out) {
  return orion::kernel_info(whitted_kernel,
                            sizeof(float) * T_pad * orion::kGeo, out);
}
"""


def hook_whitted4(files: dict) -> dict:
    """{name: text} of whitted_common.cuh and whitted.cu of a checkout
    whose kernel 4 runs `whitted_lane`, rewritten with the counter hooks
    (see WHITTED4_LANE_HOOKS); ValueError where a text to replace is not
    found exactly once."""
    wc = files["whitted_common.cuh"]
    a = wc.find(WHITTED_LANE_START)
    b = wc.find("\n}\n", a)
    if a < 0 or b < 0:
        raise ValueError("whitted_common.cuh: no whitted_lane")
    lane = wc[a:b + 3]
    for old, new in WHITTED4_LANE_HOOKS:
        lane = _sub_once(lane, old, new, "whitted_lane")
    wt = _sub_once(files["whitted.cu"], *WHITTED4_KERNEL_HOOK, "whitted.cu")
    return {"whitted_common.cuh": wc[:a] + lane + wc[b + 3:],
            "whitted.cu": wt + WHITTED4_INFO}


def whitted4_sources(csrc: Path, out: Path) -> bool:
    """Copy `csrc`'s whitted.cu and headers into `out`, the copies
    rewritten by hook_whitted4 where kernel 4 runs `whitted_lane` (then
    True)."""
    out.mkdir(parents=True, exist_ok=True)
    files = {f.name: f.read_text()
             for f in [csrc / "whitted.cu", *sorted(csrc.glob("*.cuh"))]}
    per_pixel = "whitted_lanes<" not in files["whitted.cu"]
    if per_pixel:
        files.update(hook_whitted4(files))
    for name, text in files.items():
        (out / name).write_text(text)
    return per_pixel


def table_whitted_sweep_sources(src: Path) -> dict:
    """{tag: path} of copies of src/whitted.cu beside it, one for each set
    of constants of TABLE_WHITTED_BUILDS."""
    text = (src / "whitted.cu").read_text()
    out = {}
    for consts in TABLE_WHITTED_BUILDS:
        tag = ",".join(f"{k}={v}" for k, v in consts.items())
        body = text
        for name, v in consts.items():
            body = with_constant(body, name, v)
        out[tag] = src / f"whitted_sweep_{len(out)}.cu"
        out[tag].write_text(body)
    return out


def _opcode(text: str) -> str:
    """The opcode of one SASS instruction, its predicate and modifiers
    dropped ('@!P0 LDS.128 R4, [R2]' -> 'LDS')."""
    return re.sub(r"^@!?U?P[T0-9]+\s+", "", text.strip()).split()[0] \
        .split(".")[0]


def sass_loops(sass: str, kernel: str, *also: str) -> list:
    """The loops of a kernel's SASS (cuobjdump -sass's text): for each
    backward branch, (first address, last address, instructions,
    {opcode: count}) of the instructions from its target to the branch,
    shortest first."""
    body = None
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if kernel in name and all(a in name for a in also):
            body = part
            break
    if body is None:
        return []
    ins = []
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            ins.append((int(m[1], 16), m[2]))
    loops = []
    for addr, text in ins:
        m = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", text)
        if m and int(m[1], 16) <= addr:
            first = int(m[1], 16)
            ops = [_opcode(t) for a, t in ins if first <= a <= addr]
            loops.append((first, addr, len(ops),
                          dict(collections.Counter(ops).most_common())))
    return sorted(loops, key=lambda lp: lp[2])


def _probe_whitted4(tmp: Path, dev) -> None:
    """Kernel 4 at chip_smoke.py phase 8's shapes, the loops of its SASS,
    and (persistent lanes) the sweep of its resident blocks."""
    from chip_smoke import WHITTED
    from cornell_scenes import write_cornell_whitted
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.ops import cuda_build
    from orion_tpu_torch.ops import whitted as wh
    from orion_tpu_torch.scene import load_scene
    from tools.walk_ab import digest

    W, H, S, D = (WHITTED["xres"], WHITTED["yres"], WHITTED["samples"],
                  WHITTED["depth"])
    src = tmp / "whitted4_src"
    per_pixel = whitted4_sources(cuda_build.CSRC, src)
    sweep = {} if per_pixel else table_whitted_sweep_sources(src)
    builds = [(src / "whitted.cu", tmp / "wh.so", ()),
              (src / "whitted.cu", tmp / "wh_counters.so",
               ("-DORION_PATH_COUNTERS",))]
    builds += [(cu, tmp / f"wh_sweep_{k}.so", ())
               for k, cu in enumerate(sweep.values())]
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: _nvcc(*b), builds))
    if per_pixel:
        print("[kernel 4] whitted_lane: counter hooks put into a copy of "
              "the sources")
    rtc = write_cornell_whitted(tmp / "w4", xres=W, yres=H, depth=D)
    scene, r = load_scene(rtc, device=dev)
    args = wh.whitted_args(scene, camera_from_rtc(r, device=dev))
    cfg = (W, H, S, D, scene.num_emissive > 0)
    T_pad = args[0].shape[0]

    def launch():
        return wh.fused_whitted(*args, 0, *cfg)

    launch.module = wh.__name__
    _run("kernel 4", src / "whitted.cu", "whitted_launch", "whitted_kernel",
         lambda lib, out: lib.whitted_info(T_pad, out), launch, tmp,
         tag="wh", nee="shadow sweeps")
    with _swapped(wh, "KERNEL", ctypes.CDLL(str(tmp / "wh.so")),
                  "whitted_launch"):
        img = launch()
    print(f"[kernel 4] {T_pad} table rows; image digest {digest(img)}, mean "
          f"{float(img.double().mean()):.9g}")
    for first, last, n, ops in sass_loops(_cuobjdump(tmp / "wh.so"),
                                          "whitted_kernel")[:SASS_LOOPS]:
        print(f"[kernel 4] SASS loop {first:#x}-{last:#x}: {n} "
              f"instructions, {ops}")
    for k, (tag, cu) in enumerate(sweep.items()):
        so = tmp / f"wh_sweep_{k}.so"
        log = _nvcc(cu, so)
        lib = ctypes.CDLL(str(so))
        out = (ctypes.c_int * 4)()
        lib.whitted_info(T_pad, out)
        spill = " ".join(_ptxas_lines(log, "whitted_kernel")[1:2])
        with _swapped(wh, "KERNEL", lib, "whitted_launch"):
            ms, times, _ = _median_ms(launch, WHITTED_REPS)
        print(f"[kernel 4] built with {tag}: {out[1]} registers, {out[0]} "
              f"resident ({spill}); {ms:.3f} ms (runs "
              f"{', '.join(f'{t:.3f}' for t in times)})", flush=True)


def parse_args(argv) -> argparse.Namespace:
    """`kernels`: the set of KERNELS named (all when none is), `root`:
    the checkout to probe (None: this one)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*", choices=KERNELS)
    ap.add_argument("--root", type=Path, default=None)
    args = ap.parse_args(argv)
    args.kernels = set(args.kernels) or set(KERNELS)
    return args


def main(argv) -> int:
    args = parse_args(argv)
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("error: path_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    print(card())
    print(f"SM clock {card('clocks.sm')}, max {card('clocks.max.sm')}")
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if args.kernels & {"1", "8"}:
            _probe_path_kernels(tmp, dev, args.kernels)
        for pair in ("9", "3"):
            if pair in args.kernels:
                _probe_pair(pair, tmp, dev)
        if "w" in args.kernels:
            _probe_whitted4(tmp, dev)
            _probe_whitted(tmp, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
