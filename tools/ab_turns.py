"""What the A/B tools and probes of `tools/` share.

- `card()`: the card's line from nvidia-smi (name and power limit by
  default), printed before every number a tool keeps;
- `events(fn, reps)`: the median and the runs of fn() by CUDA events after
  one warm-up call;
- `ab_main(...)`: the main() of an A/B tool (`fused_ab.py`, `prb_ab.py`,
  `bounce_ab.py`): given OLD and NEW checkouts it runs the tool's
  `--one ROOT LABEL` in the order old, new, new, old, each in a process of
  its own, so a drift of the card's clock shows as a gap between the two
  runs of one version;
- `red_wall(scene)` and `red_wall_problem(...)`: the train problem of
  chip_smoke.py phases 7 (b), 11 (c) and 12 (c): the scene prepared at
  chip_smoke.TRAIN's shapes, its target rendered with the true albedos,
  and the red wall's albedo x 0.6.

`chip_smoke` and `orion_tpu_torch` are imported inside the functions, so
an A/B run uses the checkout its `--one` put first on sys.path.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

TRAIN_SEED = 3
RED_WALL_SCALE = 0.6


def card(query: str = "name,power.limit") -> str:
    """The first card's line of `nvidia-smi --query-gpu=<query>`."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def events(fn, reps: int) -> tuple:
    """(median ms, [ms]) of `reps` calls of fn() by CUDA events, after
    one warm-up call (which builds, loads and warms up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), times


def runs(times) -> str:
    return ", ".join(f"{t:.3f}" for t in times)


def turns(old: str, new: str) -> tuple:
    """(root, label) of the four runs, in the order they run."""
    return ((old, "old-1"), (new, "new-1"), (new, "new-2"), (old, "old-2"))


def ab_main(argv, doc: str, script: str, time_one, keep=None,
            timeout: int = 900) -> int:
    """`--one ROOT LABEL [DIR]` calls time_one(ROOT, LABEL[, DIR]);
    `OLD NEW` prints the card's line and runs `script --one` for each of
    `turns(OLD, NEW)`. With `keep`, the first run of each version is also
    handed a temporary directory, and keep(directory) is called once all
    four have run (a comparison of what they kept). Anything else prints
    `doc` and returns 2."""
    if len(argv) in (3, 4) and argv[0] == "--one":
        time_one(*argv[1:])
        return 0
    if len(argv) != 2:
        print(doc, file=sys.stderr)
        return 2
    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for root, label in turns(*argv):
            extra = [tmp] if keep and label.endswith("-1") else []
            subprocess.run([sys.executable, script, "--one", root, label,
                            *extra], check=True, timeout=timeout)
        if keep:
            keep(Path(tmp))
    return 0


def red_wall(scene) -> tuple:
    """(kd, scene): a copy of the diffuse albedos with the reddest mesh's
    (the red wall) scaled by RED_WALL_SCALE, and the scene holding it."""
    import dataclasses

    import torch

    kd = scene.mat_diffuse.clone()
    red = int(torch.argmax(kd[:, 0] - kd[:, 1]))
    kd[red] *= RED_WALL_SCALE
    return kd, dataclasses.replace(scene, mat_diffuse=kd)


def red_wall_problem(rtc, device, render, seed: int = TRAIN_SEED) -> dict:
    """The scene of `rtc` prepared on `device` at chip_smoke.TRAIN's
    resolution, and: `cfg` (samples, max_depth, light_samples of TRAIN),
    `target` = render(scene, camera, **cfg)(seed) of the true scene, and
    `kd`, `scene` of red_wall."""
    from chip_smoke import TRAIN
    from orion_tpu_torch import engine

    cfg = dict(samples=TRAIN["samples"], max_depth=TRAIN["depth"],
               light_samples=TRAIN["light_samples"])
    ps = engine.prepare(rtc, device=device, xres=TRAIN["xres"],
                        yres=TRAIN["yres"])
    target = render(ps.scene, ps.camera, **cfg)(seed)
    kd, scene = red_wall(ps.scene)
    return dict(ps=ps, cfg=cfg, target=target, kd=kd, scene=scene)
