"""Compare kernel 2, the Whitted kernels 4, 7a and 7b and the binned
round (kernel 10) of two checkouts on one card in one call.

    git archive <old commit> | tar -x -C _archive/old
    python3 tools/whitted_ab.py _archive/old . [--cases 2,7,4,10]

`--cases` names what each run times (all four by default):

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
  digest (case 7);
- kernel 4 (the Whitted kernel over the swept table) on chip_smoke.py
  phase 8's render: the point-light Cornell box, 1920x1080, 4 spp, depth
  4, seed 0, through `fused_whitted`, by CUDA events (median of
  WHITTED4_REPS), with the image's mean and digest (case 4);
- kernel 10 (case 10) a launch by CUDA-graph replay of the recorded
  rounds of the levels-5 box's binned renders at chip_smoke.TRAIN's
  spp and depth: every round of a 256x256 render, and the rounds of the
  nearest sweep of a 1920x1080 render's depth-1 rays (phase 13's sets),
  each with a digest of the kernel's (t, row) over its rounds; and the
  1080p render's kernel-10 ms (its rounds' CUDA events, summed) beside
  the render's own time and its image's digest.

The checkouts run in the order old, new, new, old, each in a process of
its own with its checkout's `orion_tpu_torch` first on sys.path (the
kernels built there); the harness (`cornell_scenes`' writers,
`chip_smoke`'s sweep recorder and graph timing) is this tree's. The first old and new runs
keep the two images, and the comparison prints their pixels off by more
than 1e-4 + 1e-3 |ref|, the means and the largest difference.
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (this tree's harness)
from cornell_scenes import write_cornell, write_cornell_whitted  # noqa: E402
from tools.ab_turns import ab_main, events, runs  # noqa: E402
from tools.brute_probe import SETS  # noqa: E402
from tools.walk_ab import digest, pixels_off  # noqa: E402

SEED = 0
REPS = 5
WHITTED4_REPS = 11
# (CUDA-graph passes, replays) of the 256x256 and the 1080p round sets
GRAPH_256, GRAPH_HD = (5, 11), (3, 7)
CASES = ("2", "7", "4", "10")
# the cases a run times (`--cases` sets it for the four runs)
CASES_ENV = "WHITTED_AB_CASES"
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
    cases = os.environ.get(CASES_ENV, ",".join(CASES)).split(",")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rtc = write_cornell(tmp / "box", xres=256, yres=256, depth=4)
        cornell, _ = load_scene(rtc, device=dev)
        if "4" in cases:
            _kernel4(tmp, dev, label, keep)
        if "10" in cases:
            _kernel10(tmp, dev, label)
        for name in ("a", "b") if "2" in cases else ():
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
        for textured, tag in ((False, "7a"), (True, "7b")) \
                if "7" in cases else ():
            rtc_w = write_cornell_whitted(
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


def _kernel4(tmp: Path, dev, label: str, keep: str | None) -> None:
    """Case 4: kernel 4's 1080p render (chip_smoke.py phase 8's)."""
    import torch

    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.ops import whitted as wh
    from orion_tpu_torch.scene import load_scene

    W = chip_smoke.WHITTED
    rtc = write_cornell_whitted(tmp / "w4", xres=W["xres"],
                                yres=W["yres"], depth=W["depth"])
    scene, r = load_scene(rtc, device=dev)
    args = wh.whitted_args(scene, camera_from_rtc(r, device=dev))
    cfg = (W["xres"], W["yres"], W["samples"], W["depth"],
           scene.num_emissive > 0)
    ms, times = events(lambda: wh.fused_whitted(*args, SEED, *cfg),
                       WHITTED4_REPS)
    img = wh.fused_whitted(*args, SEED, *cfg)
    torch.cuda.synchronize()
    print(f"{label}: kernel 4 render median {ms:.4f} ms (runs "
          f"{runs(times)}); image mean {float(img.double().mean()):.9g}, "
          f"digest {digest(img)}", flush=True)
    if keep:
        torch.save(img.cpu(), Path(keep) / f"{label}_4.pt")


def _kernel10(tmp: Path, dev, label: str) -> None:
    """Case 10: kernel 10 on phase 13's rounds, and the 1080p render."""
    import torch

    from orion_tpu_torch import engine
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import binned as bn
    from orion_tpu_torch.scene import load_scene

    cs = chip_smoke
    T = cs.TRAIN
    cfg = dict(samples=T["samples"], max_depth=T["depth"],
               light_samples=T["light_samples"])
    big = write_cornell(tmp / "big", xres=64, yres=64, depth=4,
                        levels=cs.BIG_LEVELS)
    lv5, _ = load_scene(big, device=dev)
    rtc = parse_rtc(big)
    fn_q = bn.make_binned_path_renderer(
        lv5, camera_from_rtc(cs._resized(rtc, dict(xres=256, yres=256)),
                             device=dev), **cfg)
    fn_q.sweep.record = []
    fn_q(SEED)
    sets = [("256x256 render's", fn_q.sweep, fn_q.sweep.record, GRAPH_256)]
    fn_q.sweep.record = None
    fn, _ = engine.make_big_path_renderer(
        lv5, camera_from_rtc(cs._resized(rtc, T), device=dev),
        order=("binned",), **cfg)
    rec1 = []
    fn(SEED, record=lambda depth, n, st, hd, kd, vis: rec1.append(
        st[:, :n].clone()) if depth == 1 else None)
    st1 = rec1.pop()
    fn.sweep.record = []
    fn.sweep.closest((st1[0], st1[1], st1[2]), (st1[3], st1[4], st1[5]),
                     st1[9] > 0.0)
    sets.append(("1080p depth-1 sweep's", fn.sweep, fn.sweep.record,
                 GRAPH_HD))
    fn.sweep.record = None
    del st1
    for name, sweep, rounds, (passes, replays) in sets:
        def run(sweep=sweep, rounds=rounds):
            return [bn.binned_round(st, key, sweep.row0, sweep.nb, sweep.tab)
                    for st, key in rounds]

        ms, spread = cs.graph_ms(run, passes, replays)
        outs = run()
        torch.cuda.synchronize()
        print(f"{label}: kernel 10 a launch over the {len(rounds)} rounds "
              f"of the {name} ({sum(k.numel() for _, k in rounds)} lanes): "
              f"{ms:.6f} ms (spread {spread:.4f}), digest {digest(*outs)}",
              flush=True)
    del sets, fn_q
    fn(SEED)                                # warm-up of the timed render
    fn.sweep.timings = []
    r_ms, img = cs.once_ms(lambda: fn(SEED))
    k_ms = sum(a.elapsed_time(b) for a, b in fn.sweep.timings)
    print(f"{label}: 1080p binned render {r_ms:.3f} ms, kernel 10 "
          f"{k_ms:.3f} ms of it over {len(fn.sweep.timings)} rounds; image "
          f"digest {digest(img)}", flush=True)
    fn.sweep.timings = None


def _compare(keep: Path) -> None:
    import torch

    for tag in ("7a", "7b", "4"):
        if not (keep / f"old-1_{tag}.pt").exists():
            continue
        old, new = (torch.load(keep / f"{k}_{tag}.pt")
                    for k in ("old-1", "new-1"))
        print(f"{tag} image: pixels off {pixels_off(new, old):.6f}, means "
              f"{float(old.double().mean()):.9g} / "
              f"{float(new.double().mean()):.9g}, largest |difference| "
              f"{float((new - old).abs().max()):.6g}")


def main(argv) -> int:
    argv = list(argv)
    if "--cases" in argv:
        i = argv.index("--cases")
        cases = argv[i + 1].split(",") if i + 1 < len(argv) else []
        if not cases or set(cases) - set(CASES):
            print(__doc__, file=sys.stderr)
            return 2
        os.environ[CASES_ENV] = ",".join(cases)
        del argv[i:i + 2]
    return ab_main(argv, __doc__, __file__, _time_one, keep=_compare)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
