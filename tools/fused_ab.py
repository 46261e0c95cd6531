"""Compare the two path megakernels of two checkouts on one card in one call.

    git archive <old commit> | tar -x -C _archive/old
    python3 tools/fused_ab.py _archive/old .

Times kernel 1 (the fused path kernel) at the render main path's shapes
(Cornell box, 1920x1080, 16 spp, depth 8, 2 light samples, seed 0) and
kernel 8 (the BVH path kernel) at chip_smoke.py phase 9's (the
34,818-triangle box at the same shapes, through
`make_bvh_path_renderer`), then both at phase 11's small image (256x256,
16 spp, depth 4), by CUDA events: one warm-up launch, then 7 timed
launches, median. The checkouts run in the order old, new, new,
old, so a drift of the card's clock shows as a gap between the two runs
of one version. Each run is a process of its own that imports
`orion_tpu_torch` and `cornell_scenes.write_cornell` from its checkout and
builds the kernels there. The image mean is printed with each run: two
versions that compute the same image print the same mean, two that
differ only in rounding print means a few ulps apart.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools.ab_turns import ab_main, events, runs  # noqa: E402

RES, SAMPLES, DEPTH, LIGHT_SAMPLES = (1920, 1080), 16, 8, 2
SMALL_RES, SMALL_DEPTH = (256, 256), 4
REPS = 7


def _timed(label: str, what: str, fn, res=RES, depth=DEPTH) -> None:
    ms, times = events(fn, REPS)
    W, H = res
    print(f"{label}: {what} {W}x{H} {SAMPLES}spp depth {depth}: median "
          f"{ms:.3f} ms, runs {runs(times)}, mean {float(fn().mean()):.9g}",
          flush=True)


def _time_one(root: str, label: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from chip_smoke import BIG_LEVELS
    from cornell_scenes import write_cornell
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.ops import fused_path as fp
    from orion_tpu_torch.scene import load_scene

    dev = torch.device("cuda", 0)
    W, H = RES
    with tempfile.TemporaryDirectory() as tmp:
        scene, rtc = load_scene(write_cornell(tmp, xres=W, yres=H,
                                              depth=DEPTH), device=dev)
        big, _ = load_scene(write_cornell(Path(tmp) / "big", xres=W,
                                          yres=H, depth=DEPTH,
                                          levels=BIG_LEVELS), device=dev)
    cam = camera_from_rtc(rtc, device=dev)
    args = fp.fused_args(scene, cam)
    cfg = (W, H, SAMPLES, DEPTH, LIGHT_SAMPLES)
    _timed(label, "fused", lambda: fp.fused_path(*args, 0, *cfg))
    fn = bp.make_bvh_path_renderer(big, cam, samples=SAMPLES,
                                   max_depth=DEPTH,
                                   light_samples=LIGHT_SAMPLES)
    _timed(label, f"bvh path ({big.num_triangles} triangles)",
           lambda: fn(0))
    # the small image, where a thread renders one pixel at most
    w, h = SMALL_RES
    with tempfile.TemporaryDirectory() as tmp:
        _, rtc_s = load_scene(write_cornell(tmp, xres=w, yres=h,
                                            depth=SMALL_DEPTH), device=dev)
    cam_s = camera_from_rtc(rtc_s, device=dev)
    args_s = fp.fused_args(scene, cam_s)
    cfg_s = (w, h, SAMPLES, SMALL_DEPTH, LIGHT_SAMPLES)
    _timed(label, "fused", lambda: fp.fused_path(*args_s, 0, *cfg_s),
           SMALL_RES, SMALL_DEPTH)
    fn_s = bp.make_bvh_path_renderer(big, cam_s, samples=SAMPLES,
                                     max_depth=SMALL_DEPTH,
                                     light_samples=LIGHT_SAMPLES)
    _timed(label, f"bvh path ({big.num_triangles} triangles)",
           lambda: fn_s(0), SMALL_RES, SMALL_DEPTH)


def main(argv) -> int:
    return ab_main(argv, __doc__, __file__, _time_one)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
