"""Batched stackless BVH traversal in plain PyTorch.

The PyTorch counterpart of `orion_tpu.ops.bvh_traverse`: every ray carries
a node pointer; one step advances all rays one node, descending into
[ptr+1, ...) on an AABB hit and jumping to node_skip[ptr] on a miss or
after a leaf bundle test. The loop runs until every ray's pointer falls
off the end. This is the CPU backend ("bvh-torch") and the oracle; one
function, `walk_plain`, also serves as the plain version of the two CUDA
walk kernels (ops/bvh_intersect.py, ops/bvh_path.py), which walk the same
flattened trees one thread per ray.

Over the reference traversal (SBVH::innerIntersect, avx/sbvh.cpp:36-83):
t-max pruning (a node whose AABB entry distance exceeds the ray's current
best hit is skipped), and leaves tested as dense [n, W] Woop bundles.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from orion_tpu_torch.accel.bvh import BVH
from orion_tpu_torch.ops.intersect import Hit
from orion_tpu_torch.ops.woop import BIG, woop_rows, woop_t, woop_tuv


class TraversalStats(NamedTuple):
    """Work counters, the BVH-quality metric of benchmarks.md:22-32."""

    box_tests: float
    tri_tests: float
    steps: float


def _slab(orig, inv_dir, lo, hi):
    """Slab test; hit iff tmax >= tmin && tmax > 0.

    The reference uses a strict tmax > tmin (AABB.hpp:79-99), which rejects
    perfectly flat boxes (an axis-aligned quad's leaf AABB has lo == hi on
    one axis and tmin == tmax for any ray through it). `>=` is the
    documented deviation (PARITY.md). fmin/fmax drop a NaN operand, as the
    CUDA kernels' fminf/fmaxf do: a ray lying in the plane of a flat box
    (0 * inf on that axis) is decided by the other two axes.
    Returns (hit, tmin); t is in |dir| units like the rest of the pipeline.
    """
    t0 = (lo - orig) * inv_dir
    t1 = (hi - orig) * inv_dir
    near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
    tmin = torch.fmax(torch.fmax(near[:, 0], near[:, 1]), near[:, 2])
    tmax = torch.fmin(torch.fmin(far[:, 0], far[:, 1]), far[:, 2])
    return (tmax >= tmin) & (tmax > 0.0), tmin


def walk_plain(lo, hi, skip, start, rows13, orig, dirs, *, leaf_width: int,
               alive=None, cap: float = BIG, any_hit: bool = False,
               first=None, count: Optional[int] = None,
               flagged_starts: bool = False, stats: Optional[dict] = None,
               budget: int = 1 << 22):
    """Per-ray skip-pointer walk, batched: (t [N] f32, row [N] int64).

    lo, hi [M, 3], skip, start [M] int32: the flattened tree(s); rows13
    [B, >= 13]: the bundled Woop rows. Each ray walks nodes
    [first, first + count) (default: the whole array; `first` may be a
    per-ray tensor selecting one of several concatenated copies of the
    tree). Winner rule: min t below `cap`; within a leaf ties go to the
    smallest row, across leaves only a strictly smaller t replaces the
    best, in flattened order. Misses and rays with alive == False give
    (BIG, -1). any_hit=True: a ray leaves at its first leaf with a hit
    and reports (1.0, that leaf's nearest row).

    flagged_starts: bit 0 of a leaf's start is a flag, not part of the
    row offset (bvh_path_device_data). stats accumulates "box_tests"
    (nodes visited), "tests" (Woop tests of real rows: |n|^2 > 0),
    "leaf_visits" and "steps"; where it holds "ray_box_tests", an [N]
    int64 tensor, each ray's nodes visited are added to it. Leaf bundles
    are gathered for the rays at a hit leaf only, `budget` ray-row pairs
    at a time.
    """
    N = orig.shape[0]
    dev = orig.device
    M = int(lo.shape[0])
    W = int(leaf_width)
    if count is None:
        count = M
    inv_dir = 1.0 / dirs
    if first is None:
        ptr = torch.zeros((N,), dtype=torch.int64, device=dev)
        end = torch.full((N,), count, dtype=torch.int64, device=dev)
    else:
        ptr = first.to(torch.int64).clone()
        end = ptr + count
    if alive is not None:
        ptr = torch.where(alive, ptr, end)
    t_best = torch.full((N,), cap, dtype=torch.float32, device=dev)
    row_best = torch.full((N,), -1, dtype=torch.int64, device=dev)
    skip = skip.to(torch.int64)
    start = start.to(torch.int64)
    w13 = rows13[:, :13]
    real = (w13[:, 12] > 0.0) if stats is not None else None
    lane = torch.arange(W, device=dev)
    step_rays = max(1, budget // W)
    box_tests = leaf_visits = tests = steps = 0
    ray_box_tests = None if stats is None else stats.get("ray_box_tests")

    while True:
        active = ptr < end
        n_active = int(active.sum())
        if n_active == 0:
            break
        steps += 1
        box_tests += n_active
        if ray_box_tests is not None:
            ray_box_tests += active
        p = torch.clamp(ptr, max=M - 1)
        hit_box, tmin = _slab(orig, inv_dir, lo[p], hi[p])
        hit_box = hit_box & (tmin < t_best) & active
        st = start[p]
        is_leaf = st >= 0
        do_leaf = hit_box & is_leaf
        done = None
        idx_all = torch.nonzero(do_leaf).flatten()
        leaf_visits += idx_all.numel()
        for s in range(0, idx_all.numel(), step_rays):
            idx = idx_all[s:s + step_rays]
            off = st[idx]
            if flagged_starts:
                off = off & -2
            rows = off[:, None] + lane[None, :]              # [n, W]
            g = w13[rows]                                    # [n, W, 13]
            o = tuple(orig[idx, i, None] for i in range(3))
            d = tuple(dirs[idx, i, None] for i in range(3))
            t = woop_t(o, d, tuple(g[:, :, i] for i in range(13)))
            if stats is not None:
                tests += int(real[rows].sum())
            arg = torch.argmin(t, dim=1)                     # first min
            t_leaf = torch.gather(t, 1, arg[:, None])[:, 0]
            upd = (t_leaf < t_best[idx]) & (t_leaf < BIG)
            sel = idx[upd]
            t_best[sel] = t_leaf[upd]
            row_best[sel] = torch.gather(rows, 1, arg[:, None])[:, 0][upd]
            if any_hit:
                done = sel if done is None else torch.cat([done, sel])
        descend = hit_box & ~is_leaf
        ptr = torch.where(active, torch.where(descend, p + 1, skip[p]), ptr)
        if any_hit and done is not None:
            ptr[done] = end[done]
    if any_hit:
        t_best = torch.where(row_best >= 0, torch.ones_like(t_best),
                             torch.full_like(t_best, BIG))
    else:
        t_best = torch.where(row_best >= 0, t_best,
                             torch.full_like(t_best, BIG))
    if stats is not None:
        for k, v in (("box_tests", box_tests), ("tests", tests),
                     ("leaf_visits", leaf_visits), ("steps", steps)):
            stats[k] = stats.get(k, 0) + v
    return t_best, row_best


def lean_plain(lo, hi, skip, start, rows13, orig, dirs, *, leaf_width: int,
               alive=None, cap: float = BIG, first=None,
               count: Optional[int] = None, stats: Optional[dict] = None):
    """The bounce pipeline's nearest-hit walk (the TPU sweep's `lean`):
    (t, hit, u, v, row) per ray, `row` the global bundled row as float32.
    `walk_plain` over flagged leaf starts, then the winner's barycentrics.
    A miss or a ray with alive == False gives (BIG, False, 0, 0, 0)."""
    t, row = walk_plain(lo, hi, skip, start, rows13, orig, dirs,
                        leaf_width=leaf_width, alive=alive, cap=cap,
                        first=first, count=count, flagged_starts=True,
                        stats=stats)
    hit = row >= 0
    g = rows13[torch.clamp(row, min=0), :13]
    _, u, v = woop_tuv(tuple(orig[:, i] for i in range(3)),
                       tuple(dirs[:, i] for i in range(3)),
                       tuple(g[:, i] for i in range(13)))
    zero = torch.zeros_like(t)
    return (t, hit, torch.where(hit, u, zero), torch.where(hit, v, zero),
            torch.where(hit, row, torch.zeros_like(row)).to(torch.float32))


def shadow_em_plain(lo, hi, skip, start, rows13, mesh_col, orig, dirs, alive,
                    em_mesh: float, *, leaf_width: int, cap: float,
                    first=None, count: Optional[int] = None,
                    stats: Optional[dict] = None, budget: int = 1 << 22):
    """NEE visibility walks (the TPU sweep's `shadow_em` and `shadow_em2`):
    for each of the k rays that leave one origin per lane (`dirs` and
    `alive` are k-tuples; k = 2 walks both light samples of a bounce behind
    ONE pointer), does the nearest hit below `cap` lie on mesh `em_mesh`?
    Returns a k-tuple of bool [N].

    Each ray carries (t_best, emitter flag). A node is entered when any of
    the lane's rays slab-hits it inside its own live segment [0, t_best);
    a ray with alive == False starts at t = -BIG and never votes. In a leaf
    every ray tests every row: min t with ties to the smallest row, across
    leaves only a strictly smaller t wins; the flag becomes whether the
    winner's `mesh_col` entry equals em_mesh. Bit 0 of a leaf's start says
    the leaf holds no emitter rows: an improving hit there clears the flag
    without looking at the row. stats as in walk_plain, slab and Woop tests
    counted per live ray."""
    k = len(dirs)
    N = orig.shape[0]
    dev = orig.device
    M = int(lo.shape[0])
    W = int(leaf_width)
    if count is None:
        count = M
    inv = [1.0 / d for d in dirs]
    if first is None:
        ptr = torch.zeros((N,), dtype=torch.int64, device=dev)
    else:
        ptr = first.to(torch.int64).clone()
    end = ptr + count
    any_alive = alive[0]
    for a in alive[1:]:
        any_alive = any_alive | a
    ptr = torch.where(any_alive, ptr, end)
    t_best = [torch.where(a, torch.full((N,), cap, dtype=torch.float32,
                                        device=dev),
                          torch.full((N,), -BIG, dtype=torch.float32,
                                     device=dev)) for a in alive]
    em_f = [torch.zeros((N,), dtype=torch.bool, device=dev) for _ in range(k)]
    skip = skip.to(torch.int64)
    start = start.to(torch.int64)
    w13 = rows13[:, :13]
    is_em = mesh_col == float(em_mesh)
    real = (w13[:, 12] > 0.0) if stats is not None else None
    lane = torch.arange(W, device=dev)
    step_rays = max(1, budget // (W * k))
    box_tests = leaf_visits = tests = steps = 0

    while True:
        active = ptr < end
        n_active = int(active.sum())
        if n_active == 0:
            break
        steps += 1
        p = torch.clamp(ptr, max=M - 1)
        hit_box = torch.zeros((N,), dtype=torch.bool, device=dev)
        for j in range(k):
            hb, tmin = _slab(orig, inv[j], lo[p], hi[p])
            hit_box = hit_box | (hb & (tmin < t_best[j]))
            if stats is not None:
                box_tests += int((active & alive[j]).sum())
        hit_box = hit_box & active
        st = start[p]
        is_leaf = st >= 0
        idx_all = torch.nonzero(hit_box & is_leaf).flatten()
        leaf_visits += idx_all.numel()
        for s in range(0, idx_all.numel(), step_rays):
            idx = idx_all[s:s + step_rays]
            off = st[idx] & -2
            no_em = (st[idx] & 1) > 0
            rows = off[:, None] + lane[None, :]              # [n, W]
            g = w13[rows]                                    # [n, W, 13]
            w = tuple(g[:, :, i] for i in range(13))
            o = tuple(orig[idx, i, None] for i in range(3))
            for j in range(k):
                d = tuple(dirs[j][idx, i, None] for i in range(3))
                t = woop_t(o, d, w)
                if stats is not None:
                    tests += int(real[rows][alive[j][idx]].sum())
                arg = torch.argmin(t, dim=1)                 # first min
                t_leaf = torch.gather(t, 1, arg[:, None])[:, 0]
                upd = (t_leaf < t_best[j][idx]) & (t_leaf < BIG)
                sel = idx[upd]
                t_best[j][sel] = t_leaf[upd]
                win = torch.gather(rows, 1, arg[:, None])[:, 0]
                em_f[j][sel] = (is_em[win] & ~no_em)[upd]
        descend = hit_box & ~is_leaf
        ptr = torch.where(active, torch.where(descend, p + 1, skip[p]), ptr)
    if stats is not None:
        for name, v in (("box_tests", box_tests), ("tests", tests),
                        ("leaf_visits", leaf_visits), ("steps", steps)):
            stats[name] = stats.get(name, 0) + v
    return tuple((t_best[j] < cap) & em_f[j] & alive[j] for j in range(k))


def traverse(bvh: BVH, orig: torch.Tensor, dirs: torch.Tensor,
             with_stats: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[TraversalStats]]:
    """Nearest hit of N rays against the BVH (tensors on the rays' device;
    `bvh.to(device)` first).

    Returns (t [N] with +inf on a miss, bundled_row [N] int32 with -1 =
    miss, stats | None). The bundled Woop rows are computed in float32 on
    the device, as the JAX package's traverse does.
    """
    w_rows = woop_rows(bvh.tri_v0, bvh.tri_e1, bvh.tri_e2)
    stats = {} if with_stats else None
    with torch.no_grad():
        t, row = walk_plain(bvh.node_lo, bvh.node_hi, bvh.node_skip,
                            bvh.node_start, w_rows, orig, dirs,
                            leaf_width=bvh.leaf_width, stats=stats)
    t = torch.where(row >= 0, t, torch.full_like(t, float("inf")))
    out_stats = None
    if with_stats:
        # tri_tests counts every row of a visited bundle, padding included
        out_stats = TraversalStats(
            box_tests=float(stats["box_tests"]),
            tri_tests=float(stats["leaf_visits"] * bvh.leaf_width),
            steps=float(stats["steps"]))
    return t, row.to(torch.int32), out_stats


def make_bvh_intersect(bvh: BVH):
    """Build an IntersectFn closure over a flattened BVH (the batched
    PyTorch walk, on whatever device the rays live on).

    The returned fn maps bundled rows back to *global scene triangle ids*
    via tri_orig, so Hit is interchangeable with the brute-force backends
    (same ids into the scene's SoA tables for hit_attributes).
    """
    cache = {}

    def intersect(scene, orig, dirs, *, alive=None) -> Hit:
        del scene  # geometry lives in the bvh's bundled copies
        del alive  # protocol arg; the oracle walks every ray, as in JAX
        dev = orig.device
        if dev not in cache:
            cache[dev] = bvh.to(dev)
        b = cache[dev]
        t, row, _ = traverse(b, orig.detach().float(), dirs.detach().float())
        tri_id = torch.where(row >= 0,
                             b.tri_orig[torch.clamp(row, min=0).long()],
                             torch.full_like(row, -1))
        return Hit(t=torch.where(tri_id >= 0, t,
                                 torch.full_like(t, float("inf"))),
                   tri_id=tri_id.to(torch.int32))

    return intersect
