"""Break down the one-time host cost of `optim.fit`'s first PRB step.

    python3 tools/fit_first_step.py

In a fresh process on one card, at the training cell of chip_smoke.py
(Cornell 1920x1080, 4 spp, depth 8, 2 light samples, red wall's albedo
x 0.6), times on the host clock, each after a device sync and in this
order: the kernels' build, scene setup, the train step's construction and
its first and second call (the PRB kernels' first and later launches),
the first and second construction + step of torch.optim.Adam on CUDA
parameters, and then a 5-step `fit`: its first step and its later ones.
Whether `torch._dynamo` was imported before and after the first Adam step
is printed beside it.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools.ab_turns import TRAIN_SEED, card, red_wall  # noqa: E402


def main() -> int:
    import torch

    from chip_smoke import TRAIN
    from cornell_scenes import write_cornell
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.ops import cuda_build
    from orion_tpu_torch.ops import fused_path as fp
    from orion_tpu_torch.ops import prb
    from orion_tpu_torch.optim import fit

    print(card())
    dev = torch.device("cuda", 0)
    W, H = TRAIN["xres"], TRAIN["yres"]
    S, D, LS = TRAIN["samples"], TRAIN["depth"], TRAIN["light_samples"]

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f} ms",
              flush=True)
        return out

    timed("build kernels", lambda: cuda_build.build(
        ["fused_path", "brute_intersect", "prb", "whitted"]))
    with tempfile.TemporaryDirectory() as tmp:
        ps = timed("prepare (scene setup)", lambda: prepare(
            write_cornell(Path(tmp), xres=W, yres=H, depth=D), device=dev))
    target = timed("target render (fused kernel, first launch)",
                   lambda: fp.make_fused_path_renderer(
                       ps.scene, ps.camera, samples=S, max_depth=D,
                       light_samples=LS)(TRAIN_SEED))
    kd, scene = red_wall(ps.scene)
    ps = dataclasses.replace(ps, scene=scene)
    step = timed("make_fused_train_step", lambda: prb.make_fused_train_step(
        ps.scene, ps.camera, target, samples=S, max_depth=D,
        light_samples=LS, dynamic_params=True))
    for i in (1, 2):
        timed(f"train step, call {i}",
              lambda: step({"mat_diffuse": kd}, TRAIN_SEED))
    for i in (1, 2):
        before = "torch._dynamo" in sys.modules
        p = kd.clone().requires_grad_(True)
        opt = timed(f"torch.optim.Adam construction {i}",
                    lambda: torch.optim.Adam([p], lr=0.05))
        p.grad = torch.ones_like(p)
        timed(f"torch.optim.Adam first step of instance {i} (torch._dynamo "
              f"imported before: {before})", opt.step)
        print(f"  torch._dynamo imported after: "
              f"{'torch._dynamo' in sys.modules}")
    stamps = [time.perf_counter()]
    res = fit(ps, target, params=("mat_diffuse",), steps=5,
              learning_rate=0.05, samples=S, max_depth=D, light_samples=LS,
              seed=TRAIN_SEED, resample_keys=False, use_prb=True,
              callback=lambda i, loss: stamps.append(time.perf_counter()))
    per = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    print(f"fit: first step {per[0]:.1f} ms, later steps "
          f"{', '.join(f'{x:.1f}' for x in per[1:])} ms (median "
          f"{statistics.median(per[1:]):.1f}); losses "
          f"{', '.join(f'{x:.6g}' for x in res.losses)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
