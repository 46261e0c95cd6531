"""Inverse rendering demo on the port: recover wall colours from a target.

Writes the Cornell box with cornell_scenes.write_cornell, renders a target
image, replaces every diffuse albedo with a random one, and fits them back
with Adam through the differentiable path tracer (orion_tpu_torch.fit).

Usage: python examples/torch_inverse_rendering.py [--small]
                                                  [--device cuda|cpu]
"""

import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from cornell_scenes import write_cornell
from orion_tpu_torch import fit, prepare
from orion_tpu_torch.render import render


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--small", action="store_true",
                   help="32x24, 12 steps (a quick smoke run)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("--device cuda, but no CUDA device is available")
    xres, yres, steps = (32, 24, 12) if args.small else (64, 48, 120)
    with tempfile.TemporaryDirectory() as tmp:
        ps = prepare(write_cornell(tmp, xres=xres, yres=yres,
                                   depth=3), device=args.device)
    g = torch.Generator(device=ps.scene.device)
    g.manual_seed(0)
    with torch.no_grad():
        target = render(ps.scene, ps.camera, g, samples=4, max_depth=3,
                        light_samples=2, mode="path", intersect=ps.intersect)

    rng = np.random.default_rng(7)
    noise = torch.tensor(rng.uniform(0.1, 0.9, ps.scene.mat_diffuse.shape),
                         dtype=torch.float32, device=ps.scene.device)
    ps_p = dataclasses.replace(ps, scene=dataclasses.replace(
        ps.scene, mat_diffuse=noise))
    true_kd = ps.scene.mat_diffuse.cpu().numpy()
    err0 = np.abs(noise.cpu().numpy() - true_kd).mean()
    print(f"initial albedo error: {err0:.4f}")

    result = fit(ps_p, target, params=("mat_diffuse",), steps=steps,
                 learning_rate=0.05, samples=4, max_depth=3,
                 light_samples=2, mode="path",
                 callback=lambda i, l: (i % 20 == 0) and print(
                     f"  step {i:3d}  loss {l:.6f}"))
    rec = result.params["mat_diffuse"].detach().cpu().numpy()
    err = np.abs(rec - true_kd).mean()
    print(f"final loss: {result.losses[-1]:.6f}")
    print(f"recovered albedo error: {err:.4f}")
    if not (np.isfinite(result.losses).all() and err < err0):
        print("error: the fit did not reduce the albedo error",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
