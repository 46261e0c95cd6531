"""Kernel 2 (the brute nearest-hit sweep) on the card: resources, times a
launch, the launch floor, the table pack.

    python3 tools/brute_probe.py [--sweep] [--set NAME=V[,NAME=V]]...
    python3 tools/brute_probe.py --root CHECKOUT

Probes `csrc/brute_intersect.cu` on the sweeps it is ranked on: every
sweep (orig, dirs, alive) that one wavefront sample of `render` hands to
the intersect on the Cornell box (chip_smoke.SECOND's depth 4 and 2 light
samples), recorded by chip_smoke.record_sweeps (a) at 256x256 (65,536
rays a sweep: chip_smoke.py phases 5 and 6) and (b) at 1920x1080
(2,073,600 rays a sweep, ~0.5 GB of recorded rays). The rays are swept
against the box's table (36 rows), its levels-2 subdivision's (546, inside
the brute gate) and, at (a), its levels-4 subdivision's (8,706 rows,
reached only through `--backend brute`): the same box, so the recorded
rays are the rays those scenes' wavefronts make. For each set and table
it prints:

- the rays and the fraction alive of each sweep;
- the kernel against `brute_sweep_plain` on every sweep ((t, id) equal
  bit for bit) and a digest of the kernel's (t, id);
- the kernel's CUDA-event time a launch by CUDA-graph replay (SETS' passes
  and replays), and the time of an empty kernel launched over the
  same grids inside the same kind of graph: the launch floor;
- the bound (chip_smoke.py phase 6's: live rays x rows x 39 FP32
  operations over 67 TFLOP/s against 33 bytes a live ray, 9 a dead one
  and the table once over 3.35 TB/s);
- what the renderer pays besides the kernel: `pack_tri_rows16` (the
  table repacked on every sweep by `intersect_brute_kernel`) and the whole
  `intersect_brute_kernel` call, launched eagerly (CUDA events over one
  pass of the sweeps, median of REPS).

Before that, the kernel's resources: ptxas's lines and, where the source
has `brute_intersect_info`, the registers, local bytes and resident
blocks of each instantiation (1 to kMaxSplit lanes a ray) at each table
size, and which one the sweeps' sizes take. --sweep times builds of
copies of the source with one of BRUTE_SWEEP's constants set to each of
its values (`tools/ab_turns.with_constant`), each --set NAME=V[,NAME=V]
one copy with those set together; they run on the 36- and 546-row
tables. --root CHECKOUT probes another checkout's kernel and package
(first on sys.path; the harness is this tree's). The first line is the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (this tree's harness)

# constexpr ints of csrc/brute_intersect.cu and the values --sweep builds
BRUTE_SWEEP = {"kTile": (128, 512),
               "kMaxSplit": (1, 4, 8),
               "kUnroll": (1, 2, 8),
               "kBruteBlocks": (8,)}
# (resolution, CUDA-graph passes, replays, subdivision levels of the
# tables) of each sweep set
SETS = {"a": (dict(xres=256, yres=256), 20, 21, (0, 2, 4)),
        "b": (dict(xres=1920, yres=1080), 3, 7, (0, 2))}
SWEEP_LEVELS = (0, 2)       # the tables the --sweep builds run on
REPS = 7
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, int smem,
                            void* stream) {
  empty_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
THREADS = 256               # the kernel's block (the per-ray design's too)


def digest(*xs) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    h = hashlib.sha256()
    for x in xs:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def sweep_bound(n_rays: int, n_alive: int, rows: int, n_sweeps: int):
    """(ms, 'operations' | 'bytes') of one launch on average over sweeps
    of n_rays rays in all, n_alive live: chip_smoke.py phase 6's bound."""
    return chip_smoke.brute_bound_ms(n_rays, n_alive, rows, n_sweeps)


def grid_blocks(n: int, lanes: int) -> int:
    """Blocks of THREADS threads that a sweep of n rays launches at
    `lanes` lanes a ray."""
    rays = THREADS // lanes
    return (n + rays - 1) // rays


def parse_set(spec: str) -> dict:
    """{constant: value} of "NAME=V[,NAME=V]"."""
    out = {}
    for item in spec.split(","):
        name, value = item.split("=")
        out[name.strip()] = int(value)
    return out


def sweep_sources(src: Path, out: Path, sets=None) -> dict:
    """{tag: path}: copies of `src` (brute_intersect.cu) in `out`, each with
    one of BRUTE_SWEEP's constants set to one of its values, or (`sets`, a
    list of {constant: value}) with several set together."""
    from tools.ab_turns import with_constant

    text = src.read_text()
    out.mkdir(parents=True, exist_ok=True)
    builds = [{name: v} for name, values in BRUTE_SWEEP.items()
              for v in values] if sets is None else sets
    paths = {}
    for consts in builds:
        tag = ",".join(f"{k}={v}" for k, v in consts.items())
        body = text
        for name, v in consts.items():
            body = with_constant(body, name, v)
        paths[tag] = out / f"brute_{len(paths)}.cu"
        paths[tag].write_text(body)
    return paths


def _builds(tmp: Path, sweep: bool, sets) -> dict:
    """{tag: (library, nvcc's report)}: the port's source, the empty
    kernel, and the copies of --sweep / --set; one nvcc each, together."""
    import concurrent.futures

    from orion_tpu_torch.ops import cuda_build
    from tools.path_probe import _nvcc

    src = cuda_build.CSRC / "brute_intersect.cu"
    (tmp / "empty.cu").write_text(EMPTY_SRC)
    jobs = {"port": src, "empty": tmp / "empty.cu"}
    if sweep:
        jobs.update(sweep_sources(src, tmp / "sweep"))
    if sets:
        jobs.update(sweep_sources(src, tmp / "sets", sets))
    libs = {tag: tmp / f"brute_{i}.so" for i, tag in enumerate(jobs)}

    def one(item):
        tag, cu = item
        return tag, libs[tag], _nvcc(cu, libs[tag])

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return {tag: (so, log) for tag, so, log in pool.map(one, jobs.items())}


class _Swap:
    """Kernel 2's wrapper launching `lib`'s brute_intersect_launch."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from orion_tpu_torch.ops import brute_intersect as bi

        self.real = bi.KERNEL._fn
        bi.KERNEL._load()
        fn = self.lib.brute_intersect_launch
        fn.argtypes, fn.restype = bi.KERNEL.argtypes, ctypes.c_int
        bi.KERNEL._fn = fn
        return self

    def __exit__(self, *exc):
        from orion_tpu_torch.ops import brute_intersect as bi

        bi.KERNEL._fn = self.real


def _lanes(lib, n: int) -> int:
    """Lanes a ray of the instantiation a sweep of n rays takes (1 where
    the source has one instantiation, as the one-thread-a-ray design)."""
    if not hasattr(lib, "brute_intersect_which"):
        return 1
    out = (ctypes.c_int * 5)()
    lib.brute_intersect_info(lib.brute_intersect_which(n), 36, out)
    return out[4]


def _scenes(tmp: Path, dev):
    """(the Cornell scene, {levels: scene}, {set: sweeps})."""
    from chip_smoke import SECOND, record_sweeps
    from cornell_scenes import write_cornell
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import brute_intersect as bi
    from orion_tpu_torch.scene import load_scene, subdivide_scene

    rtc = write_cornell(tmp / "box", xres=256, yres=256, depth=4)
    cornell, _ = load_scene(rtc, device=dev)
    scenes = {lv: subdivide_scene(cornell, levels=lv) if lv else cornell
              for lv in (0, 2, 4)}
    sets = {}
    for name, (res, _, _, _) in SETS.items():
        r = parse_rtc(rtc)
        r.xres, r.yres = res["xres"], res["yres"]
        sets[name] = record_sweeps(cornell, camera_from_rtc(r, device=dev),
                                   bi.intersect_brute_kernel, SECOND)
    return cornell, scenes, sets


def _events(fn, reps: int = REPS) -> float:
    from tools.ab_turns import events

    return events(fn, reps)[0]


def _probe_set(name, sweeps, tables, lib, empty, levels, plain) -> None:
    import torch

    from chip_smoke import graph_ms
    from orion_tpu_torch.ops import brute_intersect as bi

    _, passes, replays, _ = SETS[name]
    n = sum(o.shape[0] for o, _, _ in sweeps)
    alive = sum(int(a.sum()) for _, _, a in sweeps)
    print(f"[brute {name}] {len(sweeps)} sweeps, {n} rays, {alive} alive "
          f"({alive / n:.4f}); alive a sweep: "
          + ", ".join(f"{int(a.sum())}/{o.shape[0]} "
                      f"({float(a.float().mean()):.3f})"
                      for o, _, a in sweeps), flush=True)
    grids = [grid_blocks(o.shape[0], _lanes(lib, o.shape[0]))
             for o, _, _ in sweeps]
    for lv in levels:
        scene, tab = tables[lv]
        rows = tab.shape[0]
        equal = 0
        outs = []
        plain[name, lv] = []
        for o, d, a in sweeps:
            t_k, id_k = bi.brute_sweep(tab, o, d, a)
            t_p, id_p = bi.brute_sweep_plain(tab, o, d, a)
            equal += int(torch.equal(t_k, t_p) and torch.equal(id_k, id_p))
            outs += [t_k, id_k]
            plain[name, lv].append((t_p, id_p))
        ms, spread = graph_ms(lambda: [bi.brute_sweep(tab, o, d, a)
                                       for o, d, a in sweeps],
                              passes, replays)
        smem = 64 * min(rows, 256)
        e_ms, e_spread = graph_ms(lambda: [
            empty.empty_launch(g, THREADS, smem, ctypes.c_void_p(
                torch.cuda.current_stream().cuda_stream)) for g in grids],
            passes, replays)
        bound, by = sweep_bound(n, alive, rows, len(sweeps))
        pack_ms = _events(lambda: bi.pack_tri_rows16(scene))
        wrap_ms = _events(lambda: [bi.intersect_brute_kernel(scene, o, d,
                                                             alive=a)
                                   for o, d, a in sweeps]) / len(sweeps)
        print(f"[brute {name} T={rows}] kernel {ms:.6f} ms a launch (graph "
              f"replay, spread {spread:.4f}); empty kernel over the same "
              f"grids {e_ms:.6f} ms (spread {e_spread:.4f}); bound "
              f"{bound:.6f} ms ({by}), {bound / ms:.4f} of the kernel's "
              f"time; kernel == plain on {equal} of {len(sweeps)} sweeps; "
              f"digest {digest(*outs)}", flush=True)
        print(f"[brute {name} T={rows}] pack_tri_rows16 {pack_ms:.5f} ms "
              f"(eager); intersect_brute_kernel {wrap_ms:.5f} ms a sweep "
              f"(eager: the pack, the kernel and the masks)", flush=True)


def _resources(lib, log, rows_list) -> None:
    from tools.path_probe import _ptxas_lines

    for line in _ptxas_lines(log, "brute_intersect_kernel"):
        print(f"[brute resources] ptxas: {line}")
    if not hasattr(lib, "brute_intersect_info"):
        return
    # a one-ray sweep takes the most lanes a ray: the last instantiation
    for which in range(lib.brute_intersect_which(1) + 1):
        for rows in rows_list:
            out = (ctypes.c_int * 5)()
            rc = lib.brute_intersect_info(which, rows, out)
            print(f"[brute resources {which}] {out[4]} lanes a ray, "
                  f"{out[1]} registers, {out[2]} B local, {out[3]} B static "
                  f"shared, {out[0]} resident blocks of {THREADS} an SM at "
                  f"T={rows} (rc {rc})")
    for n in (65536, 131072, 2073600, 4147200):
        print(f"[brute resources] a sweep of {n} rays takes instantiation "
              f"{lib.brute_intersect_which(n)}")


def run(sweep: bool, sets, dev) -> int:
    from orion_tpu_torch.ops import brute_intersect as bi

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        builds = _builds(tmp, sweep, sets)
        so, log = builds["port"]
        lib = ctypes.CDLL(str(so))
        empty = ctypes.CDLL(str(builds["empty"][0]))
        empty.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
        _resources(lib, log, (36, 576, 9216))
        cornell, scenes, recorded = _scenes(tmp, dev)
        tables = {lv: (sc, bi.pack_tri_rows16(sc)) for lv, sc in
                  scenes.items()}
        plain = {}
        with _Swap(lib):
            for name, sweeps in recorded.items():
                _probe_set(name, sweeps, tables, lib, empty, SETS[name][3],
                           plain)
        for tag, (so, log) in builds.items():
            if tag in ("port", "empty"):
                continue
            clib = ctypes.CDLL(str(so))
            from tools.path_probe import _ptxas_lines

            regs = " / ".join(_ptxas_lines(log, "brute_intersect_kernel"))
            print(f"[brute build {tag}] ptxas {regs}", flush=True)
            with _Swap(clib):
                for name, sweeps in recorded.items():
                    levels = [lv for lv in SETS[name][3]
                              if lv in SWEEP_LEVELS]
                    _times_only(tag, name, sweeps, tables, levels, plain)
    return 0


def _times_only(tag, name, sweeps, tables, levels, plain) -> None:
    import torch

    from chip_smoke import graph_ms
    from orion_tpu_torch.ops import brute_intersect as bi

    _, passes, replays, _ = SETS[name]
    out = []
    for lv in levels:
        _, tab = tables[lv]
        same = all(torch.equal(x, y)
                   for (o, d, a), p in zip(sweeps, plain[name, lv])
                   for x, y in zip(bi.brute_sweep(tab, o, d, a), p))
        ms, spread = graph_ms(lambda: [bi.brute_sweep(tab, o, d, a)
                                       for o, d, a in sweeps],
                              passes, replays)
        out.append(f"T={tab.shape[0]} {ms:.6f} ms (spread {spread:.4f}"
                   f"{'' if same else ', NOT equal to plain'})")
    print(f"[brute build {tag} {name}] " + "; ".join(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true",
                    help="builds of BRUTE_SWEEP's values")
    ap.add_argument("--set", action="append", default=[], type=parse_set,
                    help="a build with NAME=V[,NAME=V] set")
    ap.add_argument("--root", type=Path, default=None,
                    help="probe this checkout")
    args = ap.parse_args(argv)
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))
    import torch

    from tools.ab_turns import card

    if not torch.cuda.is_available():
        print("error: brute_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    print(card(), flush=True)
    return run(args.sweep, args.set, torch.device("cuda", 0))


if __name__ == "__main__":
    sys.exit(main())
