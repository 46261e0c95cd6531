"""The binned sweep (kernel 10) and G8 (kernel 11) alone on the card:
chip_smoke.py's phase 13, or kernel 10's rounds one by one.

    python3 tools/binned_probe.py [--checks]
    python3 tools/binned_probe.py --rounds [--root CHECKOUT]
                                  [--set NAME=V[,NAME=V]]...

Builds `csrc/binned.cu`, `csrc/bvh_g8.cu`, `csrc/bounce.cu` and
`csrc/bvh_intersect.cu` (printing ptxas's register and spill lines),
writes the Cornell box and its levels-5 subdivision (34,818 triangles),
records one 256x256, 16 spp, depth 4 wavefront sample's sweeps over kernel
5 (as phase 3 does) and runs phase 13 (b)-(d): the binned renderer at
1920x1080, 4 spp, depth 8 against the bounce pipeline, kernel 10 per
launch against its plain version on a 256x256 render's rounds, the binned
train step and fit, and G8 against kernel 5 on one leaf-128 tree.
--checks first runs phase 13 (a), the 64x64 checks on Cornell, levels-2
and levels-5. The first line is the card's name and power limit; the last
the two kernels' records.

--rounds probes kernel 10 alone on the levels-5 box (`--root` probes
another checkout's package: its `orion_tpu_torch` first on sys.path):
each recorded round of a 256x256, 4 spp, depth 8 binned render and the
rounds of one 1920x1080 sweep (the nearest sweep of the 4 spp render's
depth-1 rays), one line a round: its lanes, its distinct bins, the bins
that a block of 128 consecutive sorted lanes spans (mean and largest; the
lane-major schedule's blocks), the blocks of this tree's bin-major
schedule (`binned.round_schedule`), the real and the bundled rows its
lanes test, the kernel's ms a launch by CUDA-graph replay, and whether
its (t, row) equal the plain version's bit for bit (with the plain
version's time); then sums over each set, with the bound, and each set's
time a launch on the port's build and on each --set build (a copy of
csrc/binned.cu with those constexpr ints set), with digests. It then
splits the 1920x1080 binned render (chip_smoke.TRAIN's shapes) by the
sweep's events (`BinnedSweep.phases`): `_order`, the per-round glue
(the live filter with its host sync, the key sort, the gather of the 8
planes, the scatters) and kernel 10, against the render's own time.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
from tools import brute_probe  # noqa: E402
from tools.ab_turns import card as card_line  # noqa: E402


LANE_BLOCK = 128        # the lane-major schedule's block (PR 6's kernel)
GRAPH_PASSES, GRAPH_REPLAYS = 5, 5


def _round_lines(tag: str, rounds, sweep) -> None:
    """One line a recorded round (st, key) of `sweep`, then the sums."""
    import torch

    import chip_smoke as cs
    from orion_tpu_torch.ops import binned as bn

    K = sweep.k
    tot = dict(lanes=0, real=0, bundled=0, ms=0.0, plain_ms=0.0, blocks=0,
               equal=0)
    for i, (st, key) in enumerate(rounds):
        k = key.long()
        n = k.numel()
        pad = (-n) % LANE_BLOCK
        blocks = (torch.cat([k, k[-1:].expand(pad)]) if pad else k).view(
            -1, LANE_BLOCK)
        span = ((blocks[:, 1:] != blocks[:, :-1]).sum(1) + 1).float()
        real = int(sweep.real_rows[k].sum())
        bundled = int((sweep.nb.long()[k] * LANE_BLOCK).sum())
        n_blocks = len(_here().round_schedule(key, K))

        def run(st=st, key=key):
            return [bn.binned_round(st, key, sweep.row0, sweep.nb,
                                    sweep.tab)]

        ms, _ = cs.graph_ms(run, GRAPH_PASSES, GRAPH_REPLAYS)
        out = run()[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = bn.binned_round_plain(st, key, sweep.row0, sweep.nb,
                                      sweep.tab)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        equal = bool(torch.equal(out, plain))
        print(f"[{tag} round {i}] {n} lanes, "
              f"{int(torch.unique(k[k < K]).numel())} bins, a 128-lane "
              f"block spans {float(span.mean()):.2f} bins (largest "
              f"{int(span.max())}), {n_blocks} bin-major blocks; rows "
              f"tested: {real} real, {bundled} bundled; {ms:.5f} ms a "
              f"launch; equal to plain {equal} (plain {p_ms:.1f} ms)",
              flush=True)
        tot["lanes"] += n
        tot["real"] += real
        tot["bundled"] += bundled
        tot["ms"] += ms
        tot["plain_ms"] += p_ms
        tot["blocks"] += n_blocks
        tot["equal"] += equal
    flops, nbytes = cs._round_bound(rounds, sweep)
    n = max(len(rounds), 1)
    bound, by = cs.bound_ms(flops / n, nbytes / n)
    print(f"[{tag}] {len(rounds)} rounds, {tot['lanes']} lanes, "
          f"{tot['blocks']} bin-major blocks, rows tested {tot['real']} real "
          f"/ {tot['bundled']} bundled; kernel {tot['ms']:.4f} ms summed, "
          f"{tot['ms'] / n:.5f} ms a launch (bound {bound:.5f} ms, {by}); "
          f"{tot['equal']} of {len(rounds)} rounds equal to plain bit for "
          f"bit (plain {tot['plain_ms'] / n:.1f} ms a round)", flush=True)


def set_builds(sets, out: Path) -> dict:
    """{tag: library} of copies of csrc/binned.cu in `out`, one for each
    {constant: value} of `sets` (its constexpr ints set,
    tools/ab_turns.with_constant), built together."""
    import concurrent.futures
    import ctypes

    from orion_tpu_torch.ops import cuda_build
    from tools.ab_turns import with_constant
    from tools.path_probe import _nvcc

    text = (cuda_build.CSRC / "binned.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for k, consts in enumerate(sets):
        body = text
        for name, v in consts.items():
            body = with_constant(body, name, v)
        cu = out / f"binned_set_{k}.cu"
        cu.write_text(body)
        tag = ",".join(f"{n}={v}" for n, v in consts.items())
        jobs[tag] = (cu, out / f"binned_set_{k}.so")
    with concurrent.futures.ThreadPoolExecutor(max(len(jobs), 1)) as pool:
        list(pool.map(lambda j: _nvcc(*j), jobs.values()))
    return {tag: ctypes.CDLL(str(so)) for tag, (_, so) in jobs.items()}


def _split(events) -> dict:
    """{step: ms} of BinnedSweep.phases' (name, event) list: the time
    from each event to the next, named by the later one, summed."""
    out = collections.Counter()
    for (_, a), (name, b) in zip(events, events[1:]):
        if name != "start":
            out[name] += a.elapsed_time(b)
    return dict(out)


@functools.cache
def _here():
    """This tree's ops/binned.py as a module of its own (another checkout
    may be first on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        "_binned_here", HERE / "orion_tpu_torch" / "ops" / "binned.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _with_laps(bn) -> None:
    """Give a probed checkout's BinnedSweep, from before its event laps,
    this tree's `_lap` and `closest` (its loop with the laps added, the
    same steps otherwise)."""
    if not hasattr(bn.BinnedSweep, "_lap"):
        bn.BinnedSweep._lap = _here().BinnedSweep._lap
        bn.BinnedSweep.closest = _here().BinnedSweep.closest


def _constant_builds(sets, builds: dict) -> None:
    """Each build {tag: library} of a copy of binned.cu with constants set
    (--set) timed a launch on each round set, with the digest of its
    (t, row) beside the port build's."""
    import torch

    import chip_smoke as cs
    from orion_tpu_torch.ops import binned as bn
    from tools.path_probe import _swapped
    from tools.walk_ab import digest

    def run(rounds, sweep):
        return [bn.binned_round(st, key, sweep.row0, sweep.nb, sweep.tab)
                for st, key in rounds]

    for tag, lib in [("port build", None), *builds.items()]:
        for name, rounds, sweep in sets:
            with (_swapped(bn, "KERNEL", lib, "binned_round_launch") if lib
                  else contextlib.nullcontext()):
                ms, _ = cs.graph_ms(lambda: run(rounds, sweep), 3, 5)
                dg = digest(*run(rounds, sweep))
            torch.cuda.synchronize()
            print(f"[{tag}] {name} rounds: {ms:.6f} ms a launch, digest "
                  f"{dg}", flush=True)


def _rounds(dev, card: str, builds: dict) -> None:
    """--rounds: kernel 10 on the levels-5 box's rounds at 256x256 and on
    one 1080p sweep's, each build of `builds` on both, and the 1080p
    render's split."""
    import torch

    import chip_smoke as cs
    from cornell_scenes import write_cornell
    from orion_tpu_torch import engine
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import binned as bn
    from orion_tpu_torch.scene import load_scene

    T = cs.TRAIN
    cfg = dict(samples=T["samples"], max_depth=T["depth"],
               light_samples=T["light_samples"])
    with tempfile.TemporaryDirectory() as tmp:
        big = write_cornell(Path(tmp), xres=64, yres=64, depth=4,
                            levels=cs.BIG_LEVELS)
        lv5, _ = load_scene(big, device=dev)
        rtc = parse_rtc(big)
    cam_q = camera_from_rtc(cs._resized(rtc, dict(xres=256, yres=256)),
                            device=dev)
    fn_q = bn.make_binned_path_renderer(lv5, cam_q, **cfg)
    fn_q.sweep.record = []
    fn_q(0)
    rounds = fn_q.sweep.record
    fn_q.sweep.record = None
    print(f"{card}: {fn_q.sweep.k} bins; 256x256 render {cfg}")
    _round_lines("256x256", rounds, fn_q.sweep)
    sets = [("256x256", rounds, fn_q.sweep)]

    cam = camera_from_rtc(cs._resized(rtc, T), device=dev)
    fn, name = engine.make_big_path_renderer(lv5, cam, order=("binned",),
                                             **cfg)
    fn(1)                                   # warm-up
    rec1 = []
    fn(0, record=lambda depth, n, st, hd, kd, vis: rec1.append(
        st[:, :n].clone()) if depth == 1 else None)
    st1 = rec1[0]
    del rec1
    sweep = fn.sweep
    sweep.record = []
    sweep.closest((st1[0], st1[1], st1[2]), (st1[3], st1[4], st1[5]),
                  st1[9] > 0.0)
    rounds = sweep.record
    sweep.record = None
    del st1
    print(f"{card}: the nearest sweep of the {T['xres']}x{T['yres']} "
          f"render's depth-1 rays ({name})")
    _round_lines("1080p", rounds, sweep)
    sets.append(("1080p", rounds, sweep))
    _constant_builds(sets, builds)
    del rounds, sets

    _with_laps(bn)
    sweep.timings, sweep.phases = [], []
    ms, _ = cs.once_ms(lambda: fn(0))
    split = _split(sweep.phases)
    k10 = sum(a.elapsed_time(b) for a, b in sweep.timings)
    rounds_n = len(sweep.timings)
    sweep.timings = sweep.phases = None
    inside = sum(split.values())
    glue = {k: v for k, v in split.items() if k not in ("order", "kernel")}
    print(f"[1080p render split] {card}: render {ms:.3f} ms, {rounds_n} "
          f"rounds; _order {split.get('order', 0.0):.3f} ms; per-round glue "
          f"{sum(glue.values()):.3f} ms ("
          + ", ".join(f"{k} {v:.3f}" for k, v in glue.items())
          + f"); kernel 10 {k10:.3f} ms by its own events "
          f"({split.get('kernel', 0.0):.3f} ms from the gather's end to "
          f"the round's); outside the sweeps {ms - inside:.3f} ms",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checks", action="store_true",
                    help="run the 64x64 kernel checks first")
    ap.add_argument("--rounds", action="store_true",
                    help="kernel 10's rounds one by one, and the 1080p "
                    "render's split")
    ap.add_argument("--root", type=Path, default=None,
                    help="the checkout whose package --rounds probes")
    ap.add_argument("--set", action="append", default=[],
                    type=brute_probe.parse_set,
                    help="--rounds: also a build of binned.cu with "
                    "NAME=V[,NAME=V] set")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from cornell_scenes import write_cornell
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))
    if args.rounds:
        from orion_tpu_torch.ops import cuda_build

        if not torch.cuda.is_available():
            print("error: no CUDA device", file=sys.stderr)
            return 1
        built = cuda_build.build(["binned", "bounce", "bvh_intersect"])
        for name, (_, log) in built.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"{name}: {line.strip()}")
        with tempfile.TemporaryDirectory() as tmp:
            _rounds(torch.device("cuda", 0), card_line(),
                    set_builds(args.set, Path(tmp)))
        return 0
    from orion_tpu_torch.accel.bvh import build_scene_bvh
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import GPU_LEAF_SIZE
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import bvh_intersect as bx
    from orion_tpu_torch.ops import cuda_build
    from orion_tpu_torch.scene import load_scene, subdivide_scene

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    built = cuda_build.build(["binned", "bvh_g8", "bounce", "bvh_intersect"])
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print(f"{name}: {line.strip()}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rtc = write_cornell(tmp, xres=64, yres=64, depth=4)
        cornell, r = load_scene(rtc, device=dev)
        big = write_cornell(tmp / "big", xres=64, yres=64, depth=4,
                            levels=cs.BIG_LEVELS)
        lv5, _ = load_scene(big, device=dev)
        cam_w = camera_from_rtc(cs._resized(parse_rtc(rtc), cs.SECOND),
                                device=dev)
        bvh5, _ = build_scene_bvh(lv5, leaf_size=GPU_LEAF_SIZE)
        sweeps = cs.record_sweeps(lv5, cam_w,
                                  bx.make_bvh_intersect_kernel(bvh5, lv5),
                                  cs.SECOND)
        errs = {"10": 0.0, "11": 0.0}
        if args.checks:
            errs = cs._phase_binned_checks(
                dev, cornell, subdivide_scene(cornell, levels=2), lv5,
                camera_from_rtc(r, device=dev), sweeps)
        records = cs._phase_binned(tmp, dev, card, lv5, big, sweeps, errs)
    print(json.dumps(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
