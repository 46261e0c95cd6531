"""Render the port's demo scenes (smoke demo of orion_tpu_torch).

Writes four scenes with cornell_scenes' writers (the Cornell box path
traced, the Cornell box with a point light (Whitted), the 34,818-triangle
levels-5 box, and the box with an 8x8 checker texture), renders each with
the wavefront over the engine's intersect on the device, and saves PNGs.

Usage: python examples/torch_render_scenes.py [outdir] [--small]
                                              [--device cuda|cpu]
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

from cornell_scenes import write_cornell, write_cornell_whitted
from orion_tpu_torch import prepare
from orion_tpu_torch.io.image import save_image
from orion_tpu_torch.render import render

# name: (writer, keyword arguments, spp, depth)
SCENES = {
    "cornell-path": (write_cornell, {}, 16, 6),
    "cornell-whitted": (write_cornell_whitted, {}, 4, 4),
    "box-levels5": (write_cornell, {"levels": 5}, 4, 4),
    "box-textured": (write_cornell, {"checker": True}, 8, 4),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("outdir", nargs="?", default="renders")
    p.add_argument("--small", action="store_true",
                   help="96x54 at 1 spp, depth <= 2 (a quick smoke run)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("--device cuda, but no CUDA device is available")
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    xres, yres = (96, 54) if args.small else (640, 360)
    with tempfile.TemporaryDirectory() as tmp:
        for name, (write, kw, spp, depth) in SCENES.items():
            rtc = write(Path(tmp) / name, xres=xres, yres=yres, depth=depth,
                        **kw)
            ps = prepare(rtc, device=args.device)
            if args.small:
                spp, depth = 1, min(depth, 2)
            g = torch.Generator(device=ps.scene.device)
            g.manual_seed(0)
            t0 = time.perf_counter()
            with torch.no_grad():
                img = render(ps.scene, ps.camera, g, samples=spp,
                             max_depth=depth, light_samples=2,
                             intersect=ps.intersect,
                             shadow_intersect=ps.shadow_intersect)
                img = img.cpu().numpy()
            dt = time.perf_counter() - t0
            out = outdir / f"{name}.png"
            save_image(out, img)
            print(f"{name:16s} [{ps.backend:12s}] {xres}x{yres} @{spp}spp "
                  f"depth{depth} in {dt:.2f}s -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
