"""Which leaf size suits the BVH kernels on the card: times and work counts.

    python3 tools/bvh_probe.py [--levels 5] [--leaves 2,4,8,16,128]
    python3 tools/bvh_probe.py --leaves "" --full-plain

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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--leaves", default="2,4,8,16,128")
    ap.add_argument("--skip-numpy-build", action="store_true")
    ap.add_argument("--full-plain", action="store_true")
    args = ap.parse_args(argv)
    leaves = [int(x) for x in args.leaves.split(",") if x]

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
