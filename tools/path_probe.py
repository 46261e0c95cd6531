"""Resources, occupancy and lane-loop counters of the two path megakernels.

    python3 tools/path_probe.py

Kernel 1 (csrc/fused_path.cu) runs on the Cornell box and kernel 8
(csrc/bvh_path.cu) on the 34,818-triangle subdivided box, both at the main
path's 1920x1080, 16 spp, depth 8, 2 light samples (chip_smoke.py phases
6 and 9). For each kernel the probe prints:

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
- for kernel 8, the nodes and leaves a walk of the plain version
  (`bvh_path_plain`, the skip-pointer walk) visits at 256x256, 16 spp,
  depth 8, the yardstick of the walk's work.

The card's name and power limit and its SM clock are printed first. The
instrumented kernels are slower than the port's (clock64() and atomics):
their counters give shares and ratios, their times are not the kernels'.
"""

from __future__ import annotations

import ctypes
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
COUNTERS = ("lane_cycles", "nearest_cycles", "nee_cycles", "iters",
            "iter_lanes", "nee_iters", "nee_lanes", "warp_tail", "warps",
            "block_tail", "blocks", "lanes")


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _nvcc(src: str, out: Path, defines=()) -> str:
    from orion_tpu_torch.ops import cuda_build

    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *defines, "-o",
           str(out), str(cuda_build.CSRC / f"{src}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src} {defines}: {res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def _ptxas_lines(log: str, kernel: str):
    """ptxas's lines about `kernel` (its mangled name contains it)."""
    lines = log.splitlines()
    keep = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            keep += [l.strip() for l in lines[i + 1:i + 4]
                     if "Compiling" not in l]
    return keep


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
    print(f"[{name}] a thread: {c['lane_cycles'] / lanes:.6g} cycles; "
          f"nearest-hit queries {c['nearest_cycles'] / cyc:.4f}, NEE "
          f"{c['nee_cycles'] / cyc:.4f}, the rest (shading, RNG, bounce, "
          f"loop) {1 - (c['nearest_cycles'] + c['nee_cycles']) / cyc:.4f}")
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


def _run(name, src, symbol, kernel_name, info, launch, tmp: Path) -> None:
    """Time `launch()` on the port's build, then run it once on the
    instrumented build of `src` and print the counters."""
    from orion_tpu_torch.ops import cuda_build

    log = _nvcc(src, tmp / f"{src}.so")
    for line in _ptxas_lines(log, kernel_name):
        print(f"[{name}] ptxas: {line}")
    lib = ctypes.CDLL(str(tmp / f"{src}.so"))
    out = (ctypes.c_int * 4)()
    rc = info(lib, out)
    print(f"[{name}] built kernel: {out[1]} registers, {out[2]} B local "
          f"(spill) a thread, {out[3]} B static shared; {out[0]} resident "
          f"blocks of {128} threads an SM (rc {rc})")

    ms, times, img = _median_ms(launch)
    print(f"[{name}] kernel {ms:.3f} ms (runs "
          f"{', '.join(f'{t:.3f}' for t in times)}), image mean "
          f"{float(img.mean()):.6g}", flush=True)

    pc_so = tmp / f"{src}_counters.so"
    log = _nvcc(src, pc_so, ("-DORION_PATH_COUNTERS",))
    for line in _ptxas_lines(log, kernel_name):
        print(f"[{name}] ptxas (counters build): {line}")
    pc = ctypes.CDLL(str(pc_so))
    k = cuda_build.CudaKernel(src, symbol, [])
    mod = sys.modules[launch.module]
    real = mod.KERNEL
    fn = getattr(pc, symbol)
    fn.argtypes, fn.restype = real.argtypes, ctypes.c_int
    k._fn = fn
    mod.KERNEL = k
    try:
        import torch

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
    finally:
        mod.KERNEL = real
    print(f"[{name}] instrumented kernel {a.elapsed_time(b):.3f} ms, image "
          f"{'equal' if torch.equal(img_c, img) else 'NOT equal'} to the "
          f"port's build")
    _report_counters(name, dict(zip(COUNTERS, buf)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: path_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import BIG_LEVELS, write_cornell
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.ops import fused_path as fp
    from orion_tpu_torch.scene import load_scene

    print(_smi("name,power.limit"))
    print(f"SM clock {_smi('clocks.sm')}, max {_smi('clocks.max.sm')}")
    dev = torch.device("cuda", 0)
    W, H = RES
    cfg = (W, H, SAMPLES, DEPTH, LIGHT_SAMPLES)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cornell, rtc = load_scene(write_cornell(tmp / "c", xres=W, yres=H,
                                                depth=DEPTH), device=dev)
        cam = camera_from_rtc(rtc, device=dev)
        args = fp.fused_args(cornell, cam)
        t_pad = int(args[0].shape[0])

        def fused():
            return fp.fused_path(*args, 0, *cfg)

        fused.module = fp.__name__
        _run("kernel 1", "fused_path", "fused_path_launch",
             "fused_path_kernel",
             lambda lib, out: lib.fused_path_info(t_pad, out), fused, tmp)

        big, _ = load_scene(write_cornell(tmp / "b", xres=64, yres=64,
                                          depth=4, levels=BIG_LEVELS),
                            device=dev)
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
                              leaf_width=dd["leaf_width"],
                              copies=dd["copies"], stats=stats)
        finally:
            bp.TreeData.nearest = real_nearest
        print(f"[kernel 8] plain skip-pointer walk at {pw}x{ph}: "
              f"{walks[0]} walks, nodes a walk "
              f"{stats['box_tests'] / walks[0]:.3f}, leaves a walk "
              f"{stats['leaf_visits'] / walks[0]:.3f}, Woop tests of real "
              f"rows a walk {stats['tests'] / walks[0]:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
