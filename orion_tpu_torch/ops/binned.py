"""The binned dense sweep: nearest hits without a tree walk, and the path
renderer built on it. CUDA kernel wrapper + plain version.

Replaces `orion_tpu.ops.pallas_binned` (the Pallas `_make_round_kernel`,
its host side and `make_binned_path_renderer`). The tree walks of the
other backends follow one pointer per ray or per group; incoherent bounce
rays then walk the union of their paths. Here the BVH is cut once into K
spatial BINS (maximal subtrees whose leaves span at most `max_rows`
contiguous rows of the bundled table, `make_bins`) and a sweep of rays is

  1. every ray's slab entry t into every bin's box ([N, K], `bin_entries`),
     sorted per ray (stable: ties by bin id);
  2. rounds until no lane is live: each live lane takes its next bin in
     that order, the lanes are sorted by bin, kernel 10 (`binned_round`)
     tests each lane against every row of its bin, and the winners are
     scattered back. A lane retires when its best t is no more than its
     next bin's entry (a bin's triangles lie inside its box);
  3. one gather of the winning rows and a Woop re-evaluation (ops/woop.py)
     for u, v and the attribute columns.

Winner rule: min t, then min bundled row, the rule of the brute sweep and
of the walks (bundled rows are the tree's leaf order), so the sweep's
answers are theirs and the renderer's image equals the bounce pipeline's
reference up to nearest-hit ties. The JAX package runs steps 1-3 in jnp
around its kernel; here they are PyTorch around the CUDA kernel
(`csrc/binned.cu`), with one host sync a round (the live count), and the
live lanes compacted each round (the per-lane result does not change).

Slab entries use fmin/fmax, as the walks do (ops/bvh_traverse._slab): a
lane with d[a] == 0 in the plane of a bin flat on axis a (0 * inf) is
decided by the other two axes, where the JAX package's NaN-propagating
min/max skips the bin (a measure-zero standing difference, ROADMAP.md).

`binned_round` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses

import numpy as np
import torch

from orion_tpu_torch.accel.bvh import BVH, SAH, build_bvh
from orion_tpu_torch.ops.bvh_path import (LEAF_WIDTH, _b_pad,
                                          bvh_path_supported,
                                          pack_bvh_path_table)
from orion_tpu_torch.ops.cuda_build import (CudaKernel, check_inputs,
                                            stream_ptr)
from orion_tpu_torch.ops.fused_path import _C_MESH, NEE_T_CAP
from orion_tpu_torch.ops.woop import BIG, woop_t, woop_tuv
from orion_tpu_torch.scene import Scene

MAX_ROWS = 512                  # bin size: 4 bundles
NO_ROW = float(1 << 22)         # winner-row sentinel (exact in float32)
ROUND_ROWS = 8                  # the round's lane rows: o, d, t, row
ROUND_THREADS = 128             # kernel 10's block (csrc/binned.cu kLanes)
ROUND_MAX_SPLIT = 32            # threads a lane at most (kMaxSplit)
ROUND_FILL = 1 << 17            # lane threads a round aims at (kFillThreads)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("binned", "binned_round_launch",
                    [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P])


@dataclasses.dataclass
class Bins:
    """K spatial bins over the bundled table, plus a sentinel bin K of
    zero bundles (the key of a lane with nothing left to test)."""

    lo: np.ndarray          # [K, 3] float32
    hi: np.ndarray          # [K, 3] float32
    row0: np.ndarray        # [K+1] int32, first bundled row (128-aligned)
    n_bundles: np.ndarray   # [K+1] int32, bundles per bin (0: sentinel)

    @property
    def k(self) -> int:
        return self.lo.shape[0]


def make_bins(bvh: BVH, max_rows: int = MAX_ROWS) -> Bins:
    """Cut the flattened tree into maximal subtrees spanning <= max_rows
    bundled rows (a leaf is a bin whatever its size). A DFS flattening
    makes subtree i the nodes [i, skip(i)) and its leaf rows contiguous."""
    lo, hi = bvh.numpy("node_lo"), bvh.numpy("node_hi")
    skip, start = bvh.numpy("node_skip"), bvh.numpy("node_start")
    count = bvh.numpy("node_count")
    n = int(bvh.num_nodes)
    out_lo, out_hi, out_r0, out_rows = [], [], [], []
    stack = [0]
    while stack:            # depth first, left subtree first
        i = stack.pop()
        end = int(skip[i]) if skip[i] >= 0 else n
        leaves = [j for j in range(i, end) if start[j] >= 0]
        rows = int(sum(count[j] for j in leaves))
        if rows <= max_rows or int(start[i]) >= 0:
            r0 = int(min(start[j] for j in leaves))
            r1 = int(max(start[j] + count[j] for j in leaves))
            if r1 - r0 != rows:
                raise ValueError("a subtree's rows are not contiguous")
            out_lo.append(lo[i])
            out_hi.append(hi[i])
            out_r0.append(r0)
            out_rows.append(rows)
            continue
        left = i + 1
        right = int(skip[left]) if skip[left] >= 0 else n
        if right < end:
            stack.append(right)
        stack.append(left)
    row0 = np.array(out_r0 + [0], np.int32)
    nb = np.array([r // LEAF_WIDTH for r in out_rows] + [0], np.int32)
    return Bins(np.stack(out_lo).astype(np.float32),
                np.stack(out_hi).astype(np.float32), row0, nb)


def binned_device_data(scene: Scene, *, strategy: str = SAH,
                       max_rows: int = MAX_ROWS, bvh: BVH | None = None):
    """(bins, tab [B_pad, 32] on the scene's device, bvh): the SAH tree of
    leaf width 128 (or `bvh`, a tree of that width, e.g. the JAX package's
    through bvh_from_numpy), its bins and its bundled table (the walks'
    `pack_bvh_path_table`, so attribute columns mean the same everywhere).

    Raises ValueError for a table of 2^22 rows or more: winner rows ride
    the round as float32 beside the 2^22 sentinel, and a router then takes
    another candidate."""
    if bvh is None:
        bvh, _ = build_bvh(scene.numpy("tri_v0"), scene.numpy("tri_e1"),
                           scene.numpy("tri_e2"), scene.numpy("tri_valid"),
                           strategy=strategy, leaf_size=LEAF_WIDTH,
                           leaf_width=LEAF_WIDTH)
    elif bvh.leaf_width != LEAF_WIDTH:
        raise ValueError(f"binned sweep needs leaf_width={LEAF_WIDTH}, got "
                         f"{bvh.leaf_width}")
    if _b_pad(bvh.num_bundled) >= int(NO_ROW):
        raise ValueError(
            f"bundled table has {_b_pad(bvh.num_bundled)} rows >= the "
            f"float32 winner-row sentinel {int(NO_ROW)}; the binned backend "
            f"cannot encode winners for a scene this large")
    tab = torch.as_tensor(pack_bvh_path_table(bvh, scene),
                          device=scene.device)
    return make_bins(bvh, max_rows), tab, bvh


def bin_entries(o, d, lo, hi) -> torch.Tensor:
    """Slab entry t of rays (o, d: tuples of [N] planes) into boxes lo, hi
    [K, 3]: [N, K], +inf where a ray misses a box or leaves it behind its
    origin. fmin/fmax drop a NaN operand (0 * inf on an axis the ray does
    not move along), as the walks' slab test does."""
    tn = tf = None
    for a in range(3):
        inv = (1.0 / d[a])[:, None]
        t0 = (lo[None, :, a] - o[a][:, None]) * inv
        t1 = (hi[None, :, a] - o[a][:, None]) * inv
        near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
        tn = near if tn is None else torch.fmax(tn, near)
        tf = far if tf is None else torch.fmin(tf, far)
    ok = (tf >= tn) & (tf > 0.0)
    return torch.where(ok, torch.clamp(tn, min=0.0),
                       torch.full_like(tn, float("inf")))


# ---------------------------------------------------------------------------
# the round: plain version and kernel wrapper
# ---------------------------------------------------------------------------

def binned_round_plain(st, key, row0, nb, tab, budget: int = 1 << 24):
    """One round in PyTorch: [2, n], the best t and winner row (float32) of
    each lane after testing every row of bin key[i] against its ray (st
    rows 0-5) from its running (t, row) (rows 6-7). A row wins when t <
    BIG and (t, row) is lexicographically smaller. key[i] == K tests
    nothing. Lanes of one bin are tested `budget` lane-row pairs at a
    time."""
    K = row0.shape[0] - 1
    t, row = st[6].clone(), st[7].clone()
    o, d = st[0:3], st[3:6]
    for b in torch.unique(key).tolist():
        if b >= K:
            continue
        lanes = torch.nonzero(key == b).flatten()
        r0, count = int(row0[b]), int(nb[b]) * LEAF_WIDTH
        if count == 0:
            continue
        w = tab[r0:r0 + count, :13]
        wc = tuple(w[None, :, c] for c in range(13))
        step = max(1, budget // count)
        for s in range(0, lanes.numel(), step):
            ln = lanes[s:s + step]
            tt = woop_t(tuple(o[c, ln, None] for c in range(3)),
                        tuple(d[c, ln, None] for c in range(3)), wc)
            arg = torch.argmin(tt, dim=1)                     # first min
            t_min = torch.gather(tt, 1, arg[:, None])[:, 0]
            r_min = (arg + r0).to(torch.float32)
            tb, rb = t[ln], row[ln]
            better = (((t_min < tb) | ((t_min == tb) & (r_min < rb)))
                      & (t_min < BIG))
            t[ln] = torch.where(better, t_min, tb)
            row[ln] = torch.where(better, r_min, rb)
    return torch.stack([t, row])


def round_split(c: int, n: int, fill: int = ROUND_FILL) -> int:
    """Threads that share a lane of a bin of c > 0 lanes in a round of n
    lanes in kernel 10: the most, up to ROUND_MAX_SPLIT, whose lanes fit
    one block, and no fewer than the most (up to ROUND_MAX_SPLIT) that keep
    n x split <= fill."""
    s = ROUND_MAX_SPLIT
    while s > 1 and c * s > ROUND_THREADS:
        s >>= 1
    least = 1
    while least < ROUND_MAX_SPLIT and 2 * least * n <= fill:
        least <<= 1
    return max(s, least)


def round_schedule(key, K: int, fill: int = ROUND_FILL) -> list:
    """Kernel 10's blocks for one round's sorted keys, in block order:
    (bin, first lane, lanes, threads a lane). Bin by bin, each present
    bin's lanes are cut into tiles of ROUND_THREADS // split lanes; lanes
    keyed K belong to no block (the kernel copies their (t, row)
    through). `fill`: the kernel's kFillThreads (another value models a
    build with another)."""
    k = np.asarray(key.cpu() if torch.is_tensor(key) else key)
    starts = np.searchsorted(k, np.arange(K + 1), side="left")
    blocks = []
    for b in range(K):
        lo, hi = int(starts[b]), int(starts[b + 1])
        if hi == lo:
            continue
        split = round_split(hi - lo, len(k), fill)
        per = ROUND_THREADS // split
        blocks += [(b, s, min(per, hi - s), split)
                   for s in range(lo, hi, per)]
    return blocks


def binned_round(st, key, row0, nb, tab) -> torch.Tensor:
    """One round of the sweep (binned_round_plain's contract): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. The
    kernel's blocks are bin-major (`round_schedule` models them): it finds
    each bin's lanes in the sorted keys itself, in 2K + 2 int32 of
    scratch."""
    n = st.shape[1] if st.dim() == 2 else -1
    dev = st.device
    check_inputs("binned_round", dev,
                 (("st", st, (ROUND_ROWS, n), torch.float32),
                  ("key", key, (n,), torch.int32),
                  ("row0", row0, (row0.shape[0],), torch.int32),
                  ("nb", nb, (row0.shape[0],), torch.int32),
                  ("tab", tab, (tab.shape[0], 32), torch.float32)))
    if dev.type == "cpu":
        return binned_round_plain(st, key, row0, nb, tab)
    if dev.type != "cuda":
        raise ValueError(f"binned_round: unsupported device {dev}")
    K = row0.shape[0] - 1
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    sched = torch.empty((2 * K + 2,), dtype=torch.int32, device=dev)
    KERNEL.launch(st.data_ptr(), key.data_ptr(), row0.data_ptr(),
                  nb.data_ptr(), tab.data_ptr(), K, n, out.data_ptr(),
                  sched.data_ptr(), stream_ptr(dev))
    return out


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

class BinnedSweep:
    """A sweep with the JAX package's `_make_geom` contract over the bins
    of one table:

        sweep(o, d, attr_cols, alive=None, t_init=None)
            -> (t, hit, u, v, {col: plane})
        sweep.any_hit(o, d, alive=None) -> hit
        sweep.closest(o, d, alive=None, cap=BIG) -> (t, row)

    o, d are tuples of three [N] float32 planes. `closest` gives each
    lane's best t below `cap` (cap itself where nothing is nearer, -BIG for
    a lane that is not alive) and its winner row as float32 (NO_ROW where
    none). `counts` (shared with the sweeps of `with_tab`): "sweeps",
    "rounds" (kernel launches on the card, plain rounds on the CPU),
    "lanes" (summed over rounds) and "tests" (Woop tests of real rows, a
    device tensor). When `timings` is
    a list on a CUDA table, each round appends its CUDA-event pair; when
    `phases` is a list on a CUDA table, `closest` appends (name, event)
    at the end of each of its steps ("start", "order", then a round's
    "select" (the live filter and its host sync), "key sort", "gather",
    "kernel", "scatter", and "finish"): the time between an event and
    the one before it is that step's; when
    `record` is a list, each round appends its inputs (st, key).
    `round_fn` replaces kernel 10's wrapper by a function of its signature:
    a check on the card passes binned_round_plain; no entry point does."""

    def __init__(self, bins: Bins, tab, budget: int = 1 << 26,
                 round_fn=None):
        dev = tab.device
        self.bins = bins
        self.k = bins.k
        self.tab = tab
        self.lo = torch.as_tensor(bins.lo, device=dev)
        self.hi = torch.as_tensor(bins.hi, device=dev)
        self.row0 = torch.as_tensor(bins.row0, device=dev)
        self.nb = torch.as_tensor(bins.n_bundles, device=dev)
        real = torch.cumsum(torch.cat([
            torch.zeros(1, dtype=torch.int64, device=dev),
            (tab[:, 12] > 0.0).to(torch.int64)]), 0)
        r0 = self.row0.to(torch.int64)
        r1 = torch.clamp(r0 + self.nb.to(torch.int64) * LEAF_WIDTH,
                         max=tab.shape[0])
        self.real_rows = real[r1] - real[r0]          # [K+1], 0 for K
        self.budget = budget
        self.round_fn = round_fn or binned_round
        self.counts = dict(sweeps=0, rounds=0, lanes=0, tests=torch.zeros(
            (), dtype=torch.int64, device=dev))
        self.timings = self.record = self.phases = None

    def with_tab(self, tab) -> "BinnedSweep":
        """The same bins over a table with other material columns (the
        Woop columns, and so the bins and the real rows, unchanged)."""
        out = copy.copy(self)
        out.tab = tab
        return out

    def _order(self, o, d, cap):
        """(entry [n, K] float32, bin [n, K]) of each ray's bins sorted by
        entry t (stable: ties by bin id), +inf past the bins it enters
        below `cap`; `budget` entries at a time."""
        n, K = o[0].shape[0], self.k
        dev = o[0].device
        e_s = torch.empty((n, K), dtype=torch.float32, device=dev)
        ord_s = torch.empty((n, K), dtype=torch.int16 if K < 2**15
                            else torch.int32, device=dev)
        step = max(1, self.budget // max(K, 1))
        for s in range(0, n, step):
            e = bin_entries(tuple(x[s:s + step] for x in o),
                            tuple(x[s:s + step] for x in d), self.lo,
                            self.hi)
            e = torch.where(e >= cap, torch.full_like(e, float("inf")), e)
            vals, idx = torch.sort(e, dim=1, stable=True)
            e_s[s:s + step] = vals
            ord_s[s:s + step] = idx.to(ord_s.dtype)
        return e_s, ord_s

    def _lap(self, name: str) -> None:
        if self.phases is not None and self.tab.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.phases.append((name, ev))

    def closest(self, o, d, alive=None, cap: float = BIG):
        dev = o[0].device
        N = o[0].shape[0]
        self._lap("start")
        t = torch.full((N,), cap, dtype=torch.float32, device=dev)
        row = torch.full((N,), NO_ROW, dtype=torch.float32, device=dev)
        self.counts["sweeps"] += 1
        if alive is not None:
            t = torch.where(alive, t, torch.full_like(t, -BIG))
            lanes = torch.nonzero(alive).flatten()
            o = tuple(x[lanes] for x in o)
            d = tuple(x[lanes] for x in d)
        else:
            lanes = None
        n, K = o[0].shape[0], self.k
        if n == 0 or K == 0:
            return t, row
        e_s, ord_s = self._order(o, d, cap)
        self._lap("order")
        tl = torch.full((n,), cap, dtype=torch.float32, device=dev)
        rl = torch.full((n,), NO_ROW, dtype=torch.float32, device=dev)
        done = torch.zeros((n,), dtype=torch.int64, device=dev)
        act = torch.arange(n, device=dev)
        while True:
            nxt_i = done[act]
            nxt = e_s[act, torch.clamp(nxt_i, max=K - 1)]
            act = act[(nxt_i < K) & (nxt < tl[act])]    # one host sync
            self._lap("select")
            if act.numel() == 0:
                break
            key = ord_s[act, done[act]].to(torch.int32)
            key, perm = torch.sort(key, stable=True)
            ln = act[perm]
            self._lap("key sort")
            st = torch.stack([o[0][ln], o[1][ln], o[2][ln], d[0][ln],
                              d[1][ln], d[2][ln], tl[ln], rl[ln]])
            self._lap("gather")
            out = self._round(st, key)
            self._lap("kernel")
            tl[ln], rl[ln] = out[0], out[1]
            done[act] += 1
            self._lap("scatter")
            self.counts["rounds"] += 1
            self.counts["lanes"] += key.numel()
            self.counts["tests"] += self.real_rows[key.to(torch.int64)].sum()
        if lanes is None:
            self._lap("finish")
            return tl, rl
        t[lanes], row[lanes] = tl, rl
        self._lap("finish")
        return t, row

    def _round(self, st, key):
        if self.record is not None:
            self.record.append((st, key))
        if self.timings is None or st.device.type != "cuda":
            return self.round_fn(st, key, self.row0, self.nb, self.tab)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.round_fn(st, key, self.row0, self.nb, self.tab)
        b.record()
        self.timings.append((a, b))
        return out

    def resolve(self, o, d, t, row, alive, cap: float, cols=()):
        """(t, hit, u, v, rows int64, {col: plane}) of a `closest` result:
        a gather of the winning rows' Woop floats and a Woop re-evaluation
        for u, v, and of each attribute column in `cols` (zero on a
        miss)."""
        hit = t < cap
        if alive is not None:
            hit = hit & alive
        rows = torch.clamp(row.to(torch.int64), 0, self.tab.shape[0] - 1)
        w = self.tab[:, :13][rows]
        _, u, v = woop_tuv(o, d, tuple(w[:, c] for c in range(13)))
        hf = hit.to(torch.float32)
        got = {c: self.tab[rows, c] * hf for c in cols}
        return (torch.where(hit, t, torch.full_like(t, BIG)), hit, u * hf,
                v * hf, rows, got)

    def __call__(self, o, d, attr_cols, alive=None, t_init=None):
        cap = BIG if t_init is None else float(t_init)
        t, row = self.closest(o, d, alive, cap)
        t, hit, u, v, _, got = self.resolve(o, d, t, row, alive, cap,
                                            attr_cols)
        return t, hit, u, v, got

    def any_hit(self, o, d, alive=None):
        t, _ = self.closest(o, d, alive, BIG)
        hit = t < BIG
        return hit if alive is None else hit & alive

    def visibility(self, so, sds, needs, em_mesh) -> torch.Tensor:
        """[S, n] 0/1 planes: is the nearest hit below NEE_T_CAP of each
        site's shadow ray (origin so, directions sds[s], asked where
        needs[s]) on that site's emitter mesh em_mesh[s] ([S] float32)?
        All sites in one sweep; ties across meshes go by row, as every
        nearest hit does."""
        S, n = len(sds), so[0].shape[0]
        o = tuple(x.repeat(S) for x in so)
        d = tuple(torch.cat([sd[k] for sd in sds]) for k in range(3))
        need = torch.cat(list(needs))
        _, hit, _, _, got = self(o, d, (_C_MESH,), alive=need,
                                 t_init=NEE_T_CAP)
        mesh = em_mesh.repeat_interleave(n)
        return (hit & (got[_C_MESH] == mesh)).to(torch.float32).reshape(S, n)


# ---------------------------------------------------------------------------
# the renderer
# ---------------------------------------------------------------------------

def binned_steps(sweep: BinnedSweep, light_samples: int):
    """(walk, visible, shade) for ops/bounce.build_forward_pipeline: the
    binned nearest hit as the walk's hitdata, every site's visibility from
    one binned sweep of the shade step's own shadow rays (the vis kernel's
    draw-only mode), and the shade kernel fed those planes."""
    from orion_tpu_torch.ops.bounce import HIT_ROWS, bounce_shade, bounce_vis

    def walk(data, st, n):
        s = st[:, :n]
        o, d, alive = (s[0], s[1], s[2]), (s[3], s[4], s[5]), s[9] > 0.0
        t, row = sweep.closest(o, d, alive)
        t, hit, u, v, rows, _ = sweep.resolve(o, d, t, row, alive, BIG)
        hd = torch.zeros((HIT_ROWS, n), dtype=torch.float32, device=st.device)
        hd[0], hd[1], hd[2] = t, u, v
        hd[3] = torch.where(hit, rows, torch.zeros_like(rows)).float()
        hd[4] = hit.to(torch.float32)
        return hd

    def visible(data, st, hd, seed, depth):
        dr = bounce_vis(data, st, hd, seed, depth, draws=True,
                        light_samples=light_samples)
        S = (dr.shape[0] - 3) // 4
        return sweep.visibility(
            (dr[0], dr[1], dr[2]),
            [(dr[3 + 4 * s], dr[4 + 4 * s], dr[5 + 4 * s]) for s in range(S)],
            [dr[6 + 4 * s] > 0.0 for s in range(S)],
            data.em[:, 0].repeat_interleave(light_samples))

    return walk, visible, bounce_shade


def make_binned_path_renderer(scene: Scene, camera, *, samples: int,
                              max_depth: int, light_samples: int = 2,
                              max_rows: int = MAX_ROWS, strategy: str = SAH,
                              bvh: BVH | None = None, round_fn=None):
    """Build `fn(seed: int) -> [H, W, 3]`: path tracing with the binned
    sweep for every nearest hit and shadow ray, the bounce pipeline's
    estimator (ops/bounce.build_forward_pipeline with `binned_steps`: the
    shade kernel, fast-shadow NEE, the same PCG4D streams). Raises
    ValueError outside the bvh-path gate (textures, emitters) and for a
    table of 2^22 rows or more. `fn.sweep` holds the sweep and its
    counters; `fn.pipeline` / `fn.ctx` the pipeline. round_fn: as
    BinnedSweep's."""
    from orion_tpu_torch.ops.bounce import make_bounce_path_renderer

    if not bvh_path_supported(scene):
        raise ValueError("scene outside the bvh-path gate "
                         "(textures / emitters)")
    bins, tab, bvh = binned_device_data(scene, strategy=strategy,
                                        max_rows=max_rows, bvh=bvh)
    sweep = BinnedSweep(bins, tab, round_fn=round_fn)
    fn = make_bounce_path_renderer(
        scene, camera, samples=samples, max_depth=max_depth,
        light_samples=light_samples, bvh=bvh, leaf_width=LEAF_WIDTH,
        octant_trees=False, split_vis=True,
        steps=binned_steps(sweep, light_samples))
    fn.sweep = sweep
    return fn
