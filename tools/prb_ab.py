"""Compare the BVH path-replay pair of two checkouts on one card in one call.

    git archive <old commit> | tar -x -C _archive/old
    python3 tools/prb_ab.py _archive/old .

Times kernel 9a (the training forward), kernel 9b (the replay) and the
whole `make_bvh_train_step` (forward, replay, loss and the table's
material columns) at chip_smoke.py phase 12 (c)'s shapes: the
34,818-triangle box at 1920x1080, 4 spp, depth 8, 2 light samples, the
red wall's albedo x 0.6 against kernel 8's render of the true box, seed
3; by CUDA events, one warm-up launch, then 7 timed launches, median. The
checkouts run in the order old, new, new, old, so a drift of the card's
clock shows as a gap between the two runs of one version. Each run is a
process of its own that imports `orion_tpu_torch` and `chip_smoke` from
its checkout and builds the kernels there. Each run also prints the
forward image's mean, the step's loss, and the sum and largest |entry|
of each gradient, to 9 digits: two versions that compute the same step
print the same loss and gradients up to the replay's double sums, whose
order of additions varies from run to run.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

SEED = 3
REPS = 7


def _timed(label: str, what: str, fn) -> None:
    import torch

    fn()                                         # builds, loads, warms up
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    print(f"{label}: {what}: median {statistics.median(times):.3f} ms, runs "
          f"{', '.join(f'{t:.3f}' for t in times)}", flush=True)


def _time_one(root: str, label: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import dataclasses

    import torch

    from chip_smoke import BIG_LEVELS, TRAIN, write_cornell
    from orion_tpu_torch import engine
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.ops import bvh_prb as bvp

    dev = torch.device("cuda", 0)
    W, H, S = TRAIN["xres"], TRAIN["yres"], TRAIN["samples"]
    tcfg = dict(samples=S, max_depth=TRAIN["depth"],
                light_samples=TRAIN["light_samples"])
    with tempfile.TemporaryDirectory() as tmp:
        ps = engine.prepare(write_cornell(tmp, xres=W, yres=H,
                                          depth=TRAIN["depth"],
                                          levels=BIG_LEVELS), device=dev)
    target = bp.make_bvh_path_renderer(ps.scene, ps.camera, **tcfg)(SEED)
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
    img, ls = plan.forward(tab, SEED)
    w = ((img.reshape(H, W, 3) - target) * (2.0 / (H * W * 3 * S))
         ).reshape(-1, 3).contiguous()
    shapes = f"{W}x{H} {S}spp depth {TRAIN['depth']}"
    _timed(label, f"9a forward {shapes}", lambda: plan.forward(tab, SEED))
    _timed(label, f"9b replay {shapes}",
           lambda: plan.replay(tab, SEED, w, ls))
    _timed(label, f"train step {shapes}", lambda: step(params, SEED))
    loss, grads = step(params, SEED)
    digest = ", ".join(
        f"{k} sum {float(g.double().sum()):.9g} max |.| "
        f"{float(g.abs().max()):.9g}" for k, g in sorted(grads.items()))
    print(f"{label}: image mean {float(img.double().mean()):.9g}, loss "
          f"{float(loss):.9g}, {digest}", flush=True)


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
