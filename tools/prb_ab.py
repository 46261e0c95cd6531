"""Compare the two path-replay pairs of two checkouts on one card in one call.

    git archive <old commit> | tar -x -C _archive/old
    python3 tools/prb_ab.py _archive/old .

Times, for each training pair, its forward, its replay and the whole
train step (forward, replay, loss and the table's material columns),
each on the red wall problem (the red wall's albedo x 0.6 against the
pair's own renderer's image of the true box, seed 3) at chip_smoke.py's
TRAIN shapes, 1920x1080, 4 spp, depth 8, 2 light samples:

- the Cornell pair, kernels 3a and 3b, and `make_fused_train_step` on the
  Cornell box (chip_smoke.py phase 7);
- the BVH pair, kernels 9a and 9b, and `make_bvh_train_step` on the
  34,818-triangle box (phase 12 (c)).

By CUDA events, one warm-up launch, then 7 timed launches, median. The
checkouts run in the order old, new, new, old, so a drift of the card's
clock shows as a gap between the two runs of one version. Each run is a
process of its own that imports `orion_tpu_torch` and `chip_smoke` from
its checkout and builds the kernels there. Each run also prints, for each
pair, the forward image's mean, the step's loss, and the sum and largest
|entry| of each gradient, to 9 digits: two versions that compute the same
step print the same loss and gradients up to the replay's double sums,
whose order of additions varies from run to run.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools.ab_turns import (TRAIN_SEED, ab_main, events,  # noqa: E402
                            red_wall_problem, runs, train_case)

SEED = TRAIN_SEED
REPS = 7


def cornell_case(tmp, device, shapes: dict | None = None) -> dict:
    """ab_turns.train_case of the Cornell pair (3a/3b): the red wall
    problem on `write_cornell`'s box, its target from the fused render
    kernel (`shapes` overrides chip_smoke.TRAIN's)."""
    from chip_smoke import TRAIN
    from cornell_scenes import write_cornell
    from orion_tpu_torch.ops import fused_path as fp
    from orion_tpu_torch.ops import prb

    sh = {**TRAIN, **(shapes or {})}
    rtc = write_cornell(tmp, xres=sh["xres"], yres=sh["yres"],
                        depth=sh["depth"])
    pr = red_wall_problem(rtc, device, fp.make_fused_path_renderer, SEED,
                          shapes=shapes)
    return train_case(pr, prb.make_fused_train_step, SEED)


def bvh_case(tmp, device, shapes: dict | None = None) -> dict:
    """ab_turns.train_case of the BVH pair (9a/9b): the red wall problem
    on the subdivided box, its target from the BVH path kernel."""
    from chip_smoke import BIG_LEVELS, TRAIN
    from cornell_scenes import write_cornell
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.ops import bvh_prb as bvp

    sh = {**TRAIN, **(shapes or {})}
    rtc = write_cornell(tmp, xres=sh["xres"], yres=sh["yres"],
                        depth=sh["depth"], levels=BIG_LEVELS)
    pr = red_wall_problem(rtc, device, bp.make_bvh_path_renderer, SEED,
                          shapes=shapes)
    return train_case(pr, bvp.make_bvh_train_step, SEED,
                      order_signs=pr["ps"].order_signs)


PAIRS = (("3a", "3b", cornell_case), ("9a", "9b", bvh_case))


def _timed(label: str, what: str, fn) -> None:
    ms, times = events(fn, REPS)
    print(f"{label}: {what}: median {ms:.3f} ms, runs {runs(times)}",
          flush=True)


def _time_one(root: str, label: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from chip_smoke import TRAIN

    dev = torch.device("cuda", 0)
    shapes = (f"{TRAIN['xres']}x{TRAIN['yres']} {TRAIN['samples']}spp "
              f"depth {TRAIN['depth']}")
    for fwd, rep, make in PAIRS:
        with tempfile.TemporaryDirectory() as tmp:
            c = make(tmp, dev)
        plan, tab, w, ls = c["plan"], c["tab"], c["w"], c["ls"]
        step, params = c["step"], c["params"]
        _timed(label, f"{fwd} forward {shapes}",
               lambda: plan.forward(tab, SEED))
        _timed(label, f"{rep} replay {shapes}",
               lambda: plan.replay(tab, SEED, w, ls))
        _timed(label, f"{fwd}/{rep} train step {shapes}",
               lambda: step(params, SEED))
        loss, grads = step(params, SEED)
        digest = ", ".join(
            f"{k} sum {float(g.double().sum()):.9g} max |.| "
            f"{float(g.abs().max()):.9g}" for k, g in sorted(grads.items()))
        print(f"{label}: {fwd}/{rep} image mean "
              f"{float(c['img'].double().mean()):.9g}, loss "
              f"{float(loss):.9g}, {digest}", flush=True)
        del c, plan, tab, w, ls, step, params


def main(argv) -> int:
    return ab_main(argv, __doc__, __file__, _time_one)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
