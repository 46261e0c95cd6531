"""Compare the fused path kernel of two checkouts on one card in one call.

    git archive <old commit> | tar -x -C _archive/old
    python3 tools/fused_ab.py _archive/old .

Times the kernel at the render main path's shapes (Cornell box, 1920x1080,
16 spp, depth 8, 2 light samples, seed 0) by CUDA events: one warm-up
launch, then 7 timed launches, median. The checkouts run in the order
old, new, new, old, so a drift of the card's clock shows as a gap between
the two runs of one version. Each run is a process of its own that
imports `orion_tpu_torch` and `chip_smoke.write_cornell` from its checkout
and builds the kernel there. The image mean is printed with each run: two
versions that compute the same image print the same mean.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

RES, SAMPLES, DEPTH, LIGHT_SAMPLES = (1920, 1080), 16, 8, 2
REPS = 7


def _time_one(root: str, label: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from chip_smoke import write_cornell
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.ops import fused_path as fp
    from orion_tpu_torch.scene import load_scene

    dev = torch.device("cuda", 0)
    W, H = RES
    with tempfile.TemporaryDirectory() as tmp:
        scene, rtc = load_scene(write_cornell(tmp, xres=W, yres=H,
                                              depth=DEPTH), device=dev)
    cam = camera_from_rtc(rtc, device=dev)
    lo, hi = fp.fused_chunk_bounds(scene)
    args = (torch.as_tensor(fp.pack_fused_tri_table(scene), device=dev),
            torch.as_tensor(lo, device=dev).contiguous(),
            torch.as_tensor(hi, device=dev).contiguous(),
            torch.as_tensor(fp.pack_emitters(scene), device=dev),
            fp.camera_vec(cam).to(dev))
    cfg = (W, H, SAMPLES, DEPTH, LIGHT_SAMPLES)
    img = fp.fused_path(*args, 0, *cfg)          # builds, loads, warms up
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        img = fp.fused_path(*args, 0, *cfg)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    print(f"{label}: fused {W}x{H} {SAMPLES}spp depth {DEPTH}: median "
          f"{statistics.median(times):.3f} ms, runs "
          f"{', '.join(f'{t:.3f}' for t in times)}, mean "
          f"{float(img.mean()):.6g}", flush=True)


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        _time_one(argv[1], argv[2])
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = argv
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for root, label in ((old, "old-1"), (new, "new-1"), (new, "new-2"),
                        (old, "old-2")):
        subprocess.run([sys.executable, __file__, "--one", root, label],
                       check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
