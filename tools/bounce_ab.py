"""Compare the bounce pipeline of two checkouts on one card in one call.

    git archive <old commit> | tar -x -C _archive/old
    python3 tools/bounce_ab.py _archive/old . [--cases pipeline,vis]

At chip_smoke.py phase 11's shapes (the 34,818-triangle box at 1920x1080,
16 spp, depth 8, 2 light samples, seed 0) each run times, by CUDA events
after one warm-up, the median of REPS (`--cases` names what, both by
default; case pipeline):

- kernels 6a (walk) and 6c (shade) summed over a render, and at depth 0;
- the whole `order=("bounce",)` render, and kernel 8's render (the other
  candidate of engine.BIG_PATH_ORDER) beside it in the order bounce,
  walk, bounce;
- the textured box (an 8x8 checker on every wall) through the CLI (its
  --stats render seconds, twice) and its renderer alone;
- the closed-form bounce train step at phase 11 (c)'s shapes (1920x1080,
  4 spp, depth 8, red wall x 0.6, seed 3).

and prints, to 9 digits, the image's mean and a digest of its bytes, the
train step's loss and the sum and largest |entry| of each gradient, and
a digest of depth 0's hitdata [8, n]. Case vis times the split_vis
render (the standalone vis kernel, 6b, before each shade): 6b and 6c
given its planes summed over a render and at depth 0, beside the fused
6c of the same run, and prints the digest of 6b's planes over every
bounce and the largest difference of the split image from the fused
one. The checkouts run in the order old, new, new, old, each in a
process of its own that imports `orion_tpu_torch` and `chip_smoke` from
its checkout and builds the kernels there, so a drift of the card's
clock shows as a gap between the two runs of one version. The first old
and new runs keep depth 0's hitdata and 6b's planes of every bounce, and
the comparison counts the lanes where they differ.
"""

from __future__ import annotations

import hashlib
import os
import statistics
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools.ab_turns import (TRAIN_SEED, ab_main, events,  # noqa: E402
                            red_wall_problem, runs)

SEED = 0
REPS = 7
HD_ROWS = ("t", "u", "v", "row", "hit")
CASES = ("pipeline", "vis")
# the cases a run times (`--cases` sets it for the four runs)
CASES_ENV = "BOUNCE_AB_CASES"


def _digest(x) -> str:
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def _time_one(root: str, label: str, keep: str | None = None) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from chip_smoke import BIG_LEVELS, MAIN, _resized, run_cli
    from cornell_scenes import write_cornell
    from orion_tpu_torch import engine
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import bounce as bo
    from orion_tpu_torch.ops import bounce_prb as bpr
    from orion_tpu_torch.scene import load_scene

    dev = torch.device("cuda", 0)
    cfg = dict(samples=MAIN["samples"], max_depth=MAIN["depth"],
               light_samples=MAIN["light_samples"])
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rtc = write_cornell(tmp / "box", xres=MAIN["xres"],
                            yres=MAIN["yres"], depth=MAIN["depth"],
                            levels=BIG_LEVELS)
        lv5, _ = load_scene(rtc, device=dev)
        cam = camera_from_rtc(_resized(parse_rtc(rtc), MAIN), device=dev)
        cases = os.environ.get(CASES_ENV, ",".join(CASES)).split(",")
        if "vis" in cases:
            _time_vis(lv5, cam, cfg, label, keep)
        if "pipeline" not in cases:
            return
        fn, name = engine.make_big_path_renderer(lv5, cam, order=("bounce",),
                                                 **cfg)
        assert name == "bounce-kernel", name

        # the kernels' times over renders
        fn(SEED)
        renders = []
        for _ in range(REPS):
            timings = []
            fn(SEED, timings=timings)
            torch.cuda.synchronize()
            renders.append({(s, d): a.elapsed_time(b)
                         for s, d, n, a, b in timings})
        sums = {k: statistics.median(sum(v for (s, _), v in r.items()
                                         if s == k) for r in renders)
                for k in ("walk", "shade", "sort")}
        d0 = {k: statistics.median(r[(k, 0)] for r in renders)
              for k in ("walk", "shade")}
        print(f"{label}: 6a {sums['walk']:.3f} ms, 6c {sums['shade']:.3f} "
              f"ms a render (sort {sums['sort']:.3f}); depth 0: 6a "
              f"{d0['walk']:.3f}, 6c {d0['shade']:.3f} ms", flush=True)

        # the whole render, against kernel 8's in turns
        fn_w, name_w = engine.make_big_path_renderer(
            lv5, cam, order=("walk",),
            order_signs=engine.octant_signs(cam.front), **cfg)
        _, t1 = events(lambda: fn(SEED), 4)
        w, tw = events(lambda: fn_w(SEED), 4)
        _, t2 = events(lambda: fn(SEED), 4)
        b_ms = statistics.median(t1 + t2)
        print(f"{label}: bounce render median {b_ms:.3f} ms (runs "
              f"{runs(t1 + t2)}); {name_w} {w:.3f} ms (runs {runs(tw)}); "
              f"bounce - walk {b_ms - w:+.3f} ms", flush=True)
        del fn_w

        # the images and depth 0's hitdata
        hd0 = []

        def record(depth, n, st, hd, kd, vis):
            if depth == 0:
                hd0.append(hd[:5].clone())

        img = fn(SEED, record=record)
        torch.cuda.synchronize()
        print(f"{label}: image mean {float(img.double().mean()):.9g}, "
              f"digest {_digest(img)}; depth 0 hitdata digest "
              f"{_digest(hd0[0])} over {hd0[0].shape[1]} lanes, hits "
              f"{int((hd0[0][4] > 0).sum())}", flush=True)
        if keep:
            torch.save(hd0[0].cpu(), Path(keep) / f"{label}.pt")
        del fn, hd0

        # the textured box through the CLI, and its renderer alone
        rtc_t = write_cornell(tmp / "tex", xres=MAIN["xres"],
                              yres=MAIN["yres"], depth=MAIN["depth"],
                              levels=BIG_LEVELS, checker=True)
        secs = []
        for k in range(2):
            img_t, report = run_cli(rtc_t, tmp / f"tex{k}.hdr", MAIN,
                                    report=True)
            secs.append(report["render_seconds"])
        ps_t = engine.prepare(rtc_t, device=dev)
        fn_t, name_t = engine.make_big_path_renderer(ps_t.scene, ps_t.camera,
                                                     **cfg)
        t_ms, t_times = events(lambda: fn_t(SEED), REPS)
        print(f"{label}: textured CLI render {report['backend']} "
              f"{', '.join(f'{s:.4f}' for s in secs)} s, image mean "
              f"{float(img_t.mean()):.9g}; its renderer {name_t} median "
              f"{t_ms:.3f} ms (runs {runs(t_times)})", flush=True)
        del fn_t, ps_t

        # the bounce train step
        pr = red_wall_problem(rtc, dev, bo.make_bounce_path_renderer,
                              TRAIN_SEED)
    kd = pr["kd"]
    step = bpr.make_bounce_train_step(pr["scene"], pr["ps"].camera,
                                      pr["target"], dynamic_params=True,
                                      **pr["cfg"])
    params = {"mat_diffuse": kd}
    s_ms, s_times = events(lambda: step(params, TRAIN_SEED), REPS)
    loss, grads = step(params, TRAIN_SEED)
    digest = ", ".join(
        f"{k} sum {float(g.double().sum()):.9g} max |.| "
        f"{float(g.abs().max()):.9g}" for k, g in sorted(grads.items()))
    print(f"{label}: train step median {s_ms:.3f} ms (runs "
          f"{runs(s_times)}); loss {float(loss):.9g}, {digest}", flush=True)


def _time_vis(lv5, cam, cfg: dict, label: str, keep) -> None:
    """Case vis: the split_vis render's 6b and 6c-given-vis times beside
    the fused 6c's, the digest of 6b's planes, the split image against the
    fused one."""
    import torch

    from orion_tpu_torch.ops import bounce as bo

    fn_f = bo.make_bounce_path_renderer(lv5, cam, **cfg)
    fn_s = bo.make_bounce_path_renderer(lv5, cam, split_vis=True, **cfg)

    def stage_sums(fn):
        fn(SEED)
        out = []
        for _ in range(REPS):
            timings = []
            fn(SEED, timings=timings)
            torch.cuda.synchronize()
            out.append({(s, d): a.elapsed_time(b)
                        for s, d, n, a, b in timings})
        return out

    split, fused = stage_sums(fn_s), stage_sums(fn_f)

    def med(runs, stage, depth=None):
        return statistics.median(
            sum(v for (s, d), v in r.items()
                if s == stage and depth in (None, d)) for r in runs)

    vis, given, f6c = (med(split, "vis"), med(split, "shade"),
                       med(fused, "shade"))
    vis0, given0, f6c0 = (med(split, "vis", 0), med(split, "shade", 0),
                          med(fused, "shade", 0))
    planes = []
    img_s = fn_s(SEED, record=lambda depth, n, st, hd, kd, v: planes.append(
        v[:2].clone()))
    img_f = fn_f(SEED)
    torch.cuda.synchronize()
    print(f"{label}: 6b {vis:.3f} ms a render, {vis0:.3f} at depth 0; 6c "
          f"given vis {given:.3f} ({given0:.3f}); vis + shade given vis "
          f"{vis + given:.3f} ms against the fused 6c {f6c:.3f} a render, "
          f"{vis0 + given0:.3f} against {f6c0:.3f} at depth 0; 6b planes "
          f"digest {_digest(torch.cat(planes, dim=1))} over "
          f"{sum(p.shape[1] for p in planes)} lanes in {len(planes)} "
          f"bounces; split image - fused image largest |difference| "
          f"{float((img_s - img_f).abs().max()):.6g}, allclose(rtol 1e-6, "
          f"atol 1e-7) {bool(torch.allclose(img_s, img_f, rtol=1e-6, atol=1e-7))}",
          flush=True)
    if keep:
        torch.save([p.cpu() for p in planes], Path(keep) / f"{label}_vis.pt")


def compare_vis(a, b) -> list:
    """Lines saying where two runs' 6b planes ([2, n] a bounce) differ."""
    if len(a) != len(b):
        return [f"6b planes: {len(a)} / {len(b)} bounces"]
    lines = []
    for d, (x, y) in enumerate(zip(a, b)):
        n = -1 if x.shape != y.shape else int((x != y).any(dim=0).sum())
        lines.append(f"6b planes depth {d}: {n} of {y.shape[1]} lanes "
                     f"differ")
    return lines


def compare_hitdata(a, b) -> list:
    """Lines saying where two depth-0 hitdata [5, n] differ: the lanes
    that differ in any row, and per row the lanes and the largest
    difference."""
    if a.shape != b.shape:
        return [f"hitdata shapes differ: {tuple(a.shape)} / {tuple(b.shape)}"]
    diff = a != b
    lines = [f"depth 0 hitdata: {int(diff.any(dim=0).sum())} of "
             f"{a.shape[1]} lanes differ"]
    for k, name in enumerate(HD_ROWS):
        n = int(diff[k].sum())
        if n:
            big = float((a[k] - b[k]).abs().max())
            lines.append(f"  {name}: {n} lanes, largest |difference| "
                         f"{big:.6g}")
    both = (a[4] > 0) & (b[4] > 0)
    lines.append(f"  hit in both {int(both.sum())}, in one only "
                 f"{int(((a[4] > 0) != (b[4] > 0)).sum())}, winners differ "
                 f"where both hit {int((both & (a[3] != b[3])).sum())}")
    return lines


def _compare(keep: Path) -> None:
    import torch

    if (keep / "old-1.pt").exists():
        print("\n".join(compare_hitdata(torch.load(keep / "old-1.pt"),
                                         torch.load(keep / "new-1.pt"))))
    if (keep / "old-1_vis.pt").exists():
        print("\n".join(compare_vis(torch.load(keep / "old-1_vis.pt"),
                                     torch.load(keep / "new-1_vis.pt"))))


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
