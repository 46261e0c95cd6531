"""Compare kernel 2 and the BVH Whitted kernels 7a and 7b of two
checkouts on one card in one call.

    git archive <old commit> | tar -x -C _archive/old
    python3 tools/whitted_ab.py _archive/old .

Each run times:

- kernel 2 (the brute sweep) a launch by CUDA-graph replay of one
  wavefront sample's sweeps of the Cornell box (tools/brute_probe.py's
  SETS: chip_smoke.SECOND's depth 4 and 2 light samples, (a) at 256x256,
  (b) at 1920x1080), against the box's 36-row table at (a) and (b) and
  its levels-2 subdivision's 546 rows at (a), and prints a digest of the
  kernel's (t, id) over every sweep;
- the untextured (7a) and the textured (7b) big-Whitted renders of
  chip_smoke.py phase 12 (the levels-5 point-light box, tall box a mirror,
  1920x1080, 4 spp, depth 4, seed 0; 7b with the 8x8 checker) through
  `make_bvh_whitted_renderer` and `make_bvh_whitted_deferred`, by CUDA
  events (median of REPS after a warm-up), with each image's mean and
  digest.

The checkouts run in the order old, new, new, old, each in a process of
its own with its checkout's `orion_tpu_torch` first on sys.path (the
kernels built there); the harness (`chip_smoke`'s scene writers, sweep
recorder and graph timing) is this tree's. The first old and new runs
keep the two images, and the comparison prints their pixels off by more
than 1e-4 + 1e-3 |ref|, the means and the largest difference.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (this tree's harness)
from tools.ab_turns import ab_main, events, runs  # noqa: E402
from tools.brute_probe import SETS  # noqa: E402
from tools.walk_ab import digest, pixels_off  # noqa: E402

SEED = 0
REPS = 5
# the (set, subdivision levels) pairs kernel 2 is timed on
BRUTE_CASES = (("a", 0), ("a", 2), ("b", 0))


def _time_one(root: str, label: str, keep: str | None = None) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import octant_signs
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import brute_intersect as bi
    from orion_tpu_torch.ops import bvh_whitted as bw
    from orion_tpu_torch.scene import load_scene, subdivide_scene

    dev = torch.device("cuda", 0)
    cs = chip_smoke
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rtc = cs.write_cornell(tmp / "box", xres=256, yres=256, depth=4)
        cornell, _ = load_scene(rtc, device=dev)
        for name in ("a", "b"):
            res, passes, replays, _ = SETS[name]
            sweeps = cs.record_sweeps(
                cornell, camera_from_rtc(cs._resized(parse_rtc(rtc), res),
                                         device=dev),
                bi.intersect_brute_kernel, cs.SECOND)
            for set_name, levels in BRUTE_CASES:
                if set_name != name:
                    continue
                sc = subdivide_scene(cornell, levels=levels) if levels \
                    else cornell
                tab = bi.pack_tri_rows16(sc)

                def run():
                    return [bi.brute_sweep(tab, o, d, a)
                            for o, d, a in sweeps]

                ms, spread = cs.graph_ms(run, passes, replays)
                hits = run()
                print(f"{label}: kernel 2 a launch over the {len(sweeps)} "
                      f"sweeps of a {res['xres']}x{res['yres']} sample, "
                      f"T={tab.shape[0]}: {ms:.6f} ms (spread "
                      f"{spread:.4f}), digest "
                      f"{digest(*(x for h in hits for x in h))}", flush=True)
            del sweeps

        W = cs.WHITTED
        for textured, tag in ((False, "7a"), (True, "7b")):
            rtc_w = cs.write_cornell_whitted(
                tmp / f"w{tag}", xres=W["xres"], yres=W["yres"],
                depth=W["depth"], levels=cs.BIG_LEVELS, checker=textured)
            scene, r = load_scene(rtc_w, device=dev)
            cam = camera_from_rtc(cs._resized(r, W), device=dev)
            make = (bw.make_bvh_whitted_deferred if textured
                    else bw.make_bvh_whitted_renderer)
            fn = make(scene, cam, samples=W["samples"], max_depth=W["depth"],
                      order_signs=octant_signs(cam.front))
            ms, times = events(lambda: fn(SEED), REPS)
            img = fn(SEED)
            torch.cuda.synchronize()
            print(f"{label}: {tag} big-Whitted render median {ms:.3f} ms "
                  f"(runs {runs(times)}); image mean "
                  f"{float(img.double().mean()):.9g}, digest {digest(img)}",
                  flush=True)
            if keep:
                torch.save(img.cpu(), Path(keep) / f"{label}_{tag}.pt")


def _compare(keep: Path) -> None:
    import torch

    for tag in ("7a", "7b"):
        old, new = (torch.load(keep / f"{k}_{tag}.pt")
                    for k in ("old-1", "new-1"))
        print(f"{tag} image: pixels off {pixels_off(new, old):.6f}, means "
              f"{float(old.double().mean()):.9g} / "
              f"{float(new.double().mean()):.9g}, largest |difference| "
              f"{float((new - old).abs().max()):.6g}")


def main(argv) -> int:
    return ab_main(argv, __doc__, __file__, _time_one, keep=_compare)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
