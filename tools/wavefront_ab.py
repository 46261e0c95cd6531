"""Compare the wavefront routes of two checkouts on one card in one call.

    git archive <old commit> | tar -x -C _archive/old
    python3 tools/wavefront_ab.py _archive/old .

Times the eager wavefront renders that chip_smoke.py phases 5 and 10
drive, whose time is mostly the host's: the Cornell box through
`render` over kernel 2 (256x256, 16 spp, depth 4, 2 light samples), the
34,818-triangle box through `render` over kernel 5 (the same shapes),
through `render_regen` (depth 8), and the point-light box through the
Whitted wavefront over kernel 5 and its any-hit walk (512x512, 4 spp,
depth 4). Each is timed by CUDA events around one whole render: one
warm-up render, then 5 timed ones, median. The checkouts run in the
order old, new, new, old, each in a process of its own, so a drift of
the host or the card shows as a gap between the two runs of one
version. The image mean is printed with each run: the same sample
stream gives the same mean.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools.ab_turns import ab_main, events, runs  # noqa: E402

SMALL = dict(xres=256, yres=256, samples=16, light_samples=2, depth=4)
WHITTED = dict(xres=512, yres=512, samples=4, light_samples=1, depth=4)
REGEN_DEPTH = 8
REPS = 5


def _time_one(root: str, label: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from chip_smoke import BIG_LEVELS
    from cornell_scenes import write_cornell, write_cornell_whitted
    from orion_tpu_torch import engine
    from orion_tpu_torch.regen import render_regen
    from orion_tpu_torch.render import render

    dev = torch.device("cuda", 0)

    def case(what, ps, cfg, fn):
        def run():
            g = torch.Generator(device=dev)
            g.manual_seed(0)
            with torch.no_grad():
                return fn(ps, g, cfg)
        ms, times = events(run, REPS)
        print(f"{label}: {what} {cfg['xres']}x{cfg['yres']} "
              f"{cfg['samples']}spp depth {cfg['depth']} ({ps.backend}): "
              f"median {ms:.2f} ms, runs {runs(times)}, mean "
              f"{float(run().mean()):.9g}", flush=True)

    def wavefront(ps, g, cfg):
        return render(ps.scene, ps.camera, g, samples=cfg["samples"],
                      max_depth=cfg["depth"],
                      light_samples=cfg["light_samples"],
                      intersect=ps.intersect,
                      shadow_intersect=ps.shadow_intersect)

    def regen(ps, g, cfg):
        return render_regen(ps.scene, ps.camera, g, samples=cfg["samples"],
                            max_depth=cfg["depth"],
                            light_samples=cfg["light_samples"],
                            intersect=ps.intersect)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        size = dict(xres=SMALL["xres"], yres=SMALL["yres"])
        ps = engine.prepare(write_cornell(tmp / "c", depth=SMALL["depth"]),
                            device=dev, force_backend="brute", **size)
        case("brute wavefront", ps, SMALL, wavefront)
        big = write_cornell(tmp / "big", depth=SMALL["depth"],
                            levels=BIG_LEVELS)
        ps = engine.prepare(big, device=dev, force_backend="bvh", **size)
        case("BVH wavefront", ps, SMALL, wavefront)
        case("regen", ps, dict(SMALL, depth=REGEN_DEPTH), regen)
        w = write_cornell_whitted(tmp / "w", depth=WHITTED["depth"],
                                  levels=BIG_LEVELS)
        ps = engine.prepare(w, device=dev, force_backend="bvh",
                            xres=WHITTED["xres"], yres=WHITTED["yres"])
        case("Whitted BVH wavefront", ps, WHITTED, wavefront)


if __name__ == "__main__":
    sys.exit(ab_main(sys.argv[1:], __doc__, __file__, _time_one))
