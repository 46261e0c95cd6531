"""Compare kernels 5, 7b and 11 of two checkouts on one card in one call.

    git archive <old commit> | tar -x -C _archive/old
    python3 tools/walk_ab.py _archive/old . [--cases 5,7b,g8]

`--cases` names what each run times (all three by default), on the
levels-5 subdivided Cornell box (34,818 triangles):

- kernel 5 (the BVH walk) a launch, nearest and any-hit, by CUDA-graph
  replay of one wavefront sample's sweeps over the engine's leaf-2 tree,
  at 256x256 and at 1920x1080 (tools/bvh_probe.py's WALK_SETS: the sweep
  sets, their passes and replays), with a digest of its (t, row) over
  every sweep (case 5);
- the textured big-Whitted render (chip_smoke.py phase 12 (b): the
  point-light box with the 8x8 checker, 1920x1080, 4 spp, depth 4,
  seed 0) through `make_bvh_whitted_deferred`, by CUDA events (median of
  REPS after a warm-up), and through the CLI (its --stats render
  seconds, twice), with the image's mean and digest (case 7b);
- G8 (kernel 11) a launch, nearest and any-hit, by CUDA-graph replay on
  the leaf-128 tree, over phase 10's 256x256 sweeps and the 1080p
  depth-1 bounce wavefront (tools/bvh_probe.py's G8_SETS), with a digest
  of its (t, row) over each set (case g8). The checkouts run in the order old,
new, new, old, each in a process of its own with its checkout's
`orion_tpu_torch` first on sys.path (the kernels built there); the
harness (`cornell_scenes`' writers, `chip_smoke`'s sweep recorder and
graph timing) is this tree's. The first old and new runs keep the textured image, and the
comparison prints its pixels off by more than 1e-4 + 1e-3 |ref| and the
means.
"""

from __future__ import annotations

import hashlib
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (this tree's harness)
from cornell_scenes import write_cornell, write_cornell_whitted  # noqa: E402
from tools.ab_turns import ab_main, events, runs  # noqa: E402
from tools.bvh_probe import G8_SETS, WALK_SETS, _g8_sets  # noqa: E402

SEED = 0
REPS = 5
PIXEL_TOL = (1e-4, 1e-3)     # chip_smoke.fused_agree's, per channel
CASES = ("5", "7b", "g8")
# the cases a run times (`--cases` sets it for the four runs)
CASES_ENV = "WALK_AB_CASES"


def digest(*xs) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    h = hashlib.sha256()
    for x in xs:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def pixels_off(a, b) -> float:
    """The share of pixels of [..., 3] images where a channel of a differs
    from b's by more than PIXEL_TOL[0] + PIXEL_TOL[1] |b|."""
    import numpy as np

    a, b = np.asarray(a).reshape(-1, 3), np.asarray(b).reshape(-1, 3)
    bad = np.abs(a - b) > PIXEL_TOL[0] + PIXEL_TOL[1] * np.abs(b)
    return float(bad.any(axis=1).mean())


def _time_one(root: str, label: str, keep: str | None = None) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import octant_signs, prepare
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import bvh_intersect as bx
    from orion_tpu_torch.ops import bvh_whitted as bw
    from orion_tpu_torch.scene import load_scene

    dev = torch.device("cuda", 0)
    cs = chip_smoke
    cases = os.environ.get(CASES_ENV, ",".join(CASES)).split(",")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if "g8" in cases:
            _time_g8(tmp, dev, label)
        rtc = write_cornell(tmp / "box", xres=256, yres=256, depth=4,
                            levels=cs.BIG_LEVELS)
        ps = prepare(rtc, device=dev, force_backend="bvh")
        nodes, tri = bx._bvh_device_layout(ps.bvh, dev)
        leaf = ps.bvh.leaf_width
        for name, (res, passes, replays) in (WALK_SETS.items()
                                             if "5" in cases else ()):
            sweeps = cs.record_sweeps(
                ps.scene, camera_from_rtc(cs._resized(parse_rtc(rtc), res),
                                          device=dev),
                ps.intersect, cs.SECOND)
            out = []
            for any_hit in (False, True):
                def run():
                    return [bx.bvh_walk(nodes, tri, o, d, a, leaf_width=leaf,
                                        any_hit=any_hit)
                            for o, d, a in sweeps]

                ms, spread = cs.graph_ms(run, passes, replays)
                hits = run()
                out.append(f"{'any-hit' if any_hit else 'nearest'} "
                           f"{ms:.5f} ms (spread {spread:.4f}), digest "
                           f"{digest(*(x for h in hits for x in h))}")
            print(f"{label}: kernel 5 a launch over the {len(sweeps)} sweeps "
                  f"of a {res['xres']}x{res['yres']} sample: "
                  f"{'; '.join(out)}", flush=True)
            del sweeps
        del ps
        if "7b" not in cases:
            return

        W = cs.WHITTED
        rtc_t = write_cornell_whitted(tmp / "tex", xres=W["xres"],
                                      yres=W["yres"], depth=W["depth"],
                                      levels=cs.BIG_LEVELS, checker=True)
        secs = []
        for k in range(2):
            _, report = cs.run_cli(rtc_t, tmp / f"t{k}.hdr", W, report=True)
            secs.append(report["render_seconds"])
        scene, r = load_scene(rtc_t, device=dev)
        cam = camera_from_rtc(cs._resized(r, W), device=dev)
        fd = bw.make_bvh_whitted_deferred(scene, cam, samples=W["samples"],
                                          max_depth=W["depth"],
                                          order_signs=octant_signs(cam.front))
        ms, times = events(lambda: fd(SEED), REPS)
        img = fd(SEED)
        torch.cuda.synchronize()
        print(f"{label}: textured big-Whitted render {report['backend']} "
              f"median {ms:.3f} ms (runs {runs(times)}); CLI render "
              f"{', '.join(f'{s:.4f}' for s in secs)} s; image mean "
              f"{float(img.double().mean()):.9g}, digest {digest(img)}",
              flush=True)
        if keep:
            torch.save(img.cpu(), Path(keep) / f"{label}.pt")


def _time_g8(tmp: Path, dev, label: str) -> None:
    """Case g8: G8 a launch and the digest of its (t, row) on each set."""
    from orion_tpu_torch.ops import bvh_g8 as g8

    nodes, tri, sets = _g8_sets(tmp, dev)
    for name, sweeps in sets.items():
        passes, replays = G8_SETS[name]
        out = []
        for any_hit in (False, True):
            def run():
                return [g8.bvh_g8(nodes, tri, o, d, a, any_hit=any_hit)
                        for o, d, a in sweeps]

            ms, spread = chip_smoke.graph_ms(run, passes, replays)
            hits = run()
            out.append(f"{'any-hit' if any_hit else 'nearest'} {ms:.5f} ms "
                       f"(spread {spread:.4f}), digest "
                       f"{digest(*(x for h in hits for x in h))}")
        print(f"{label}: G8 a launch over the {len(sweeps)} sweep(s) of set "
              f"{name} ({sum(o.shape[0] for o, _, _ in sweeps)} rays): "
              f"{'; '.join(out)}", flush=True)
    del sets


def _compare(keep: Path) -> None:
    import torch

    if not (keep / "old-1.pt").exists():
        return
    old, new = (torch.load(keep / f"{k}.pt") for k in ("old-1", "new-1"))
    print(f"textured image: pixels off {pixels_off(new, old):.6f}, means "
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
