"""Run chip_smoke.py's phase 16 (primitive sharding, treelets, the viewer,
render_multihost, the example ports) by itself on one card.

    python3 tools/slice17_phase.py

Builds the kernels, writes the Cornell box, its Whitted variant and the
levels-5 box as chip_smoke.py's phase 2 does, and calls
`chip_smoke._phase_slice17`. Exits non-zero if any check fails, a rank's
or an example's included.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    import chip_smoke as cs
    from cornell_scenes import write_cornell, write_cornell_whitted
    from orion_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    cuda_build.build(["fused_path", "brute_intersect", "whitted",
                      "bvh_intersect", "bvh_path", "bvh_whitted"])
    print(f"built in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rtc_path = write_cornell(tmp, xres=64, yres=64, depth=4)
        wrtc = write_cornell_whitted(tmp / "whitted64", xres=64, yres=64,
                                     depth=4)
        big_rtc = write_cornell(tmp / "big", xres=64, yres=64, depth=4,
                                levels=cs.BIG_LEVELS)
        t0 = time.perf_counter()
        launches = cs._phase_slice17(tmp, dev, card, rtc_path, big_rtc, wrtc)
        print(f"[phase 16] {time.perf_counter() - t0:.1f} s wall")
        print(json.dumps({"phase16_launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
