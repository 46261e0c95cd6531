"""The binned sweep (kernel 10) and G8 (kernel 11) alone on the card:
chip_smoke.py's phase 13.

    python3 tools/binned_probe.py [--checks]

Builds `csrc/binned.cu`, `csrc/bvh_g8.cu`, `csrc/bounce.cu` and
`csrc/bvh_intersect.cu` (printing ptxas's register and spill lines),
writes the Cornell box and its levels-5 subdivision (34,818 triangles),
records one 256x256, 16 spp, depth 4 wavefront sample's sweeps over kernel
5 (as phase 3 does) and runs phase 13 (b)-(d): the binned renderer at
1920x1080, 4 spp, depth 8 against the bounce pipeline, kernel 10 per
launch against its plain version on a 256x256 render's rounds, the binned
train step and fit, and G8 against kernel 5 on one leaf-128 tree.
--checks first runs phase 13 (a), the 64x64 checks on Cornell, levels-2
and levels-5. The first line is the card's name and power limit; the last
the two kernels' records.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checks", action="store_true",
                    help="run the 64x64 kernel checks first")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from orion_tpu_torch.accel.bvh import build_scene_bvh
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import GPU_LEAF_SIZE
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import bvh_intersect as bx
    from orion_tpu_torch.ops import cuda_build
    from orion_tpu_torch.scene import load_scene, subdivide_scene

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    built = cuda_build.build(["binned", "bvh_g8", "bounce", "bvh_intersect"])
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print(f"{name}: {line.strip()}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rtc = cs.write_cornell(tmp, xres=64, yres=64, depth=4)
        cornell, r = load_scene(rtc, device=dev)
        big = cs.write_cornell(tmp / "big", xres=64, yres=64, depth=4,
                               levels=cs.BIG_LEVELS)
        lv5, _ = load_scene(big, device=dev)
        cam_w = camera_from_rtc(cs._resized(parse_rtc(rtc), cs.SECOND),
                                device=dev)
        bvh5, _ = build_scene_bvh(lv5, leaf_size=GPU_LEAF_SIZE)
        sweeps = cs.record_sweeps(lv5, cam_w,
                                  bx.make_bvh_intersect_kernel(bvh5, lv5),
                                  cs.SECOND)
        errs = {"10": 0.0, "11": 0.0}
        if args.checks:
            errs = cs._phase_binned_checks(
                dev, cornell, subdivide_scene(cornell, levels=2), lv5,
                camera_from_rtc(r, device=dev), sweeps)
        records = cs._phase_binned(tmp, dev, card, lv5, big, sweeps, errs)
    print(json.dumps(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
