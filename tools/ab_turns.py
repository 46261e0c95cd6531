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
  and the red wall's albedo x 0.6; `train_case(...)`: a training pair's
  step over that problem with what its kernels are timed on;
- `with_constant(src, name, value)`: a source's text with one
  `constexpr int` set to another value (the probes' sweeps build such
  rewritten copies).

`chip_smoke` and `orion_tpu_torch` are imported inside the functions, so
an A/B run uses the checkout its `--one` put first on sys.path.
"""

from __future__ import annotations

import re
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


def red_wall_problem(rtc, device, render, seed: int = TRAIN_SEED,
                     shapes: dict | None = None) -> dict:
    """The scene of `rtc` prepared on `device` at chip_smoke.TRAIN's
    resolution, and: `cfg` (samples, max_depth, light_samples of TRAIN),
    `target` = render(scene, camera, **cfg)(seed) of the true scene, and
    `kd`, `scene` of red_wall. `shapes` overrides entries of TRAIN (the
    CPU tests' small problems)."""
    from chip_smoke import TRAIN

    from orion_tpu_torch import engine

    sh = {**TRAIN, **(shapes or {})}
    cfg = dict(samples=sh["samples"], max_depth=sh["depth"],
               light_samples=sh["light_samples"])
    ps = engine.prepare(rtc, device=device, xres=sh["xres"], yres=sh["yres"])
    target = render(ps.scene, ps.camera, **cfg)(seed)
    kd, scene = red_wall(ps.scene)
    return dict(ps=ps, cfg=cfg, target=target, kd=kd, scene=scene)


def train_case(pr: dict, make_step, seed: int = TRAIN_SEED, **kw) -> dict:
    """A training pair's step over red_wall_problem's `pr`:
    make_step(scene, camera, target, dynamic_params=True, **cfg, **kw)
    (ops/prb.make_fused_train_step for 3a/3b, ops/bvh_prb.
    make_bvh_train_step for 9a/9b) and what its kernels are timed on:
    `step`, `params` (the perturbed albedos, the emission), the step's
    `plan`, its table `tab`, the forward's `img` and `ls` of `seed`, and
    `w`, the MSE cotangent of that image a lane (2 (img - target) /
    (H W 3 S))."""
    kd, pert, target = pr["kd"], pr["scene"], pr["target"]
    step = make_step(pert, pr["ps"].camera, target, dynamic_params=True,
                     **pr["cfg"], **kw)
    plan = step.plan
    tab = plan.table(kd, pert.mat_emissive)
    img, ls = plan.forward(tab, seed)
    W, H, S = plan.W, plan.H, plan.samples
    w = ((img.reshape(H, W, 3) - target) * (2.0 / (H * W * 3 * S))
         ).reshape(-1, 3).contiguous()
    return dict(step=step, plan=plan, tab=tab, img=img, ls=ls, w=w,
                params={"mat_diffuse": kd, "mat_emissive": pert.mat_emissive})


def with_constant(src: str, name: str, value: int) -> str:
    """The source text with `constexpr int <name> = <int>;` set to
    `value`; ValueError unless the source defines it exactly once."""
    pat = re.compile(rf"(constexpr int {re.escape(name)} = )-?\d+;")
    out, n = pat.subn(rf"\g<1>{int(value)};", src)
    if n != 1:
        raise ValueError(f"{name}: {n} definitions as a constexpr int")
    return out
