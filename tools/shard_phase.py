"""Run chip_smoke.py's phase 15 (ray sharding) by itself on one card.

    python3 tools/shard_phase.py

Builds the kernels, writes the Cornell box and the levels-5 box as
chip_smoke.py's phase 2 does, and calls `chip_smoke._phase_shard`: kernel
1, 3a and 3b on pixel tiles, a world of one on NCCL, and two ranks
spawned on the one card over gloo (~20 s after the build). Exits non-zero
if any check fails, a rank's included.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    import chip_smoke as cs
    from cornell_scenes import write_cornell
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.ops import cuda_build
    from orion_tpu_torch.scene import load_scene

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    cuda_build.build(["fused_path", "brute_intersect", "prb", "bvh_intersect",
                      "bvh_path", "bounce", "bvh_whitted"])
    print(f"built in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rtc_path = write_cornell(tmp, xres=64, yres=64, depth=4)
        cornell, rtc = load_scene(rtc_path, device=dev)
        big_rtc = write_cornell(tmp / "big", xres=64, yres=64, depth=4,
                                levels=cs.BIG_LEVELS)
        t0 = time.perf_counter()
        cs._phase_shard(tmp, dev, card, cornell, rtc_path, big_rtc,
                        camera_from_rtc(rtc, device=dev))
        print(f"[phase 15] {time.perf_counter() - t0:.1f} s wall")
    return 0


if __name__ == "__main__":
    sys.exit(main())
