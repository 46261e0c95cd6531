"""The bounce pipeline alone on the card: its checks and its full-width phase.

    python3 tools/bounce_probe.py [--checks]

Builds `csrc/bounce.cu` and `csrc/bvh_path.cu` (printing ptxas's register
and spill lines), writes the levels-5 subdivided Cornell box
(`chip_smoke.write_cornell(levels=5)`, 34,818 triangles) and runs
chip_smoke.py's phase 11 on it: the 1920x1080, 16 spp, depth 8 render
through the bounce pipeline with per-bounce kernel and sort times, the same
render on the BVH path kernel (both candidates of engine.BIG_PATH_ORDER
timed in turns), each bounce kernel against its plain version on the
recorded state of three bounces, the textured render through the CLI, and
the closed-form train step and fit at 1920x1080, 4 spp. --checks first
runs phase 3's 64x64 checks of the three kernels on Cornell and levels-2.
The first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
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
    from orion_tpu_torch.camera import camera_from_rtc
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
    built = cuda_build.build(["bounce", "bvh_path"])
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print(f"{name}: {line.strip()}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        errs = [0.0, 0.0, 0.0]
        if args.checks:
            rtc = cs.write_cornell(tmp, xres=64, yres=64, depth=4)
            cornell, r = load_scene(rtc, device=dev)
            errs = cs._phase_bounce_checks(
                (("cornell", cornell),
                 ("levels-2", subdivide_scene(cornell, levels=2))),
                camera_from_rtc(r, device=dev))
        big = cs.write_cornell(tmp / "big", xres=64, yres=64, depth=4,
                               levels=cs.BIG_LEVELS)
        lv5, _ = load_scene(big, device=dev)
        records = cs._phase_bounce(tmp, dev, card, lv5, errs)
    for name, rec in records.items():
        print(name, rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
