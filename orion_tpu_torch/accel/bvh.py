"""Host-side BVH build (NumPy) + flattened skip-pointer layout.

The PyTorch counterpart of `orion_tpu.accel.bvh`, the same algorithm line
for line, so that the NumPy builder gives arrays equal to the JAX
package's `build_bvh(..., builder="numpy")` on the same input:

  - ONE global BVH over every triangle in the scene (the reference builds
    per-mesh trees behind a linear mesh scan, model.hpp:52-62).
  - The build runs on the host; the flattened tree is a set of arrays
    that `BVH.to(device)` turns into tensors.
  - The reference's three split strategies (avx/sbvh.cpp:115-235): MEDIAN
    (nth_element on centroid), MIDDLE (spatial midpoint partition,
    degenerate -> leaf), SAH (12 bucketed candidates, traverse cost ==
    intersect cost). Splits are on the widest axis of the *centroid*
    bounds.
  - Leaves are padded to a fixed bundle width and their triangles stored
    contiguously in traversal order; padding slots repeat a degenerate
    triangle (e1 = e2 = 0 => no hit).
  - Flattening is depth-first with *skip pointers*: node i's subtree
    occupies [i+1, skip[i]); on a missed AABB (or after a leaf) traversal
    jumps to skip[i]: a stackless walk with t-max pruning.

Node array schema (M = node count; all int32/float32):
  node_lo, node_hi : [M, 3]   world AABB
  node_skip        : [M]      next node index on miss / after leaf
  node_start       : [M]      leaf: first bundled-triangle row; internal: -1
  node_count       : [M]      leaf: bundle row count (multiple of the
                              bundle width); internal: 0
  tri_v0/e1/e2     : [B, 3]   leaf-bundled triangle copies (B = sum of
                              padded leaf sizes)
  tri_orig         : [B]      global scene triangle id per bundled row
                              (-1 on padding rows)

`partition_triangles` cuts a scene into spatial slabs for the treelet
decomposition (engine._make_treelet_intersect): the same masks as the JAX
package's on the same input.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

MEDIAN = "median"
MIDDLE = "middle"
SAH = "sah"

DEFAULT_LEAF = 16
SAH_BUCKETS = 12  # reference default (avx/sbvh.hpp:141)

ARRAY_FIELDS = ("node_lo", "node_hi", "node_skip", "node_start", "node_count",
                "tri_v0", "tri_e1", "tri_e2", "tri_orig")


@dataclasses.dataclass
class BuildStats:
    nodes: int = 0
    leaves: int = 0
    max_depth: int = 0
    padded_tris: int = 0


@dataclasses.dataclass(frozen=True)
class BVH:
    """Flattened BVH; see the module docstring for the schema. A freshly
    built tree holds host NumPy arrays; `to(device)` gives the same tree
    as torch tensors (what the batched walk reads)."""

    node_lo: object
    node_hi: object
    node_skip: object
    node_start: object
    node_count: object
    tri_v0: object
    tri_e1: object
    tri_e2: object
    tri_orig: object

    num_nodes: int = 0
    leaf_width: int = DEFAULT_LEAF

    @property
    def num_bundled(self) -> int:
        return int(self.tri_v0.shape[0])

    def numpy(self, name: str) -> np.ndarray:
        """Host copy of one array field."""
        x = getattr(self, name)
        return x.detach().cpu().numpy() if torch.is_tensor(x) else x

    def to(self, device) -> "BVH":
        """The same tree with every array a tensor on `device`."""
        return dataclasses.replace(self, **{
            n: torch.as_tensor(getattr(self, n), device=device)
            for n in ARRAY_FIELDS})


def bvh_to_numpy(bvh: BVH) -> dict:
    """{array field: host array} plus num_nodes and leaf_width."""
    out = {n: bvh.numpy(n) for n in ARRAY_FIELDS}
    out.update(num_nodes=bvh.num_nodes, leaf_width=bvh.leaf_width)
    return out


def bvh_from_numpy(fields: dict) -> BVH:
    """Build a BVH from host arrays (inverse of bvh_to_numpy): how a tree
    built by another implementation crosses over, so that two walks see
    the identical tree."""
    kw = {n: np.array(fields[n], order="C") for n in ARRAY_FIELDS}
    return BVH(**kw, num_nodes=int(fields["num_nodes"]),
               leaf_width=int(fields["leaf_width"]))


class _Node:
    __slots__ = ("lo", "hi", "left", "right", "tri_ids", "axis")

    def __init__(self):
        self.lo = None
        self.hi = None
        self.left = None
        self.right = None
        self.tri_ids = None  # leaf payload
        self.axis = 0        # split axis (internal nodes)


def _build_recursive(ids: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                     cen: np.ndarray, strategy: str, leaf_size: int,
                     stats: BuildStats, depth: int) -> _Node:
    node = _Node()
    node.lo = lo[ids].min(axis=0)
    node.hi = hi[ids].max(axis=0)
    stats.nodes += 1
    stats.max_depth = max(stats.max_depth, depth)

    if len(ids) <= leaf_size:
        node.tri_ids = ids
        stats.leaves += 1
        return node

    c = cen[ids]
    c_lo, c_hi = c.min(axis=0), c.max(axis=0)
    extent = c_hi - c_lo
    axis = int(np.argmax(extent))

    node.axis = axis
    if extent[axis] <= 0.0:
        # all centroids coincide (reference MIDDLE degenerate case,
        # avx/sbvh.cpp:160-164); an arbitrary even split keeps every leaf
        # within one bundle (traversal relies on count == leaf_width)
        mid = len(ids) // 2
        l_ids, r_ids = ids[:mid], ids[mid:]
        node.left = _build_recursive(l_ids, lo, hi, cen, strategy, leaf_size,
                                     stats, depth + 1)
        node.right = _build_recursive(r_ids, lo, hi, cen, strategy, leaf_size,
                                      stats, depth + 1)
        return node

    if strategy == MEDIAN:
        mid = len(ids) // 2
        part = np.argpartition(c[:, axis], mid)
        l_ids, r_ids = ids[part[:mid]], ids[part[mid:]]
    elif strategy == MIDDLE:
        pivot = 0.5 * (c_lo[axis] + c_hi[axis])
        mask = c[:, axis] < pivot
        l_ids, r_ids = ids[mask], ids[~mask]
        if len(l_ids) == 0 or len(r_ids) == 0:
            mid = len(ids) // 2
            part = np.argpartition(c[:, axis], mid)
            l_ids, r_ids = ids[part[:mid]], ids[part[mid:]]
    elif strategy == SAH:
        l_ids, r_ids = _sah_split(ids, lo, hi, c, axis, c_lo, c_hi, leaf_size)
        if l_ids is not None and (len(l_ids) == 0 or len(r_ids) == 0):
            l_ids = None
        if l_ids is None:
            if len(ids) <= leaf_size:  # split not worth it -> leaf
                node.tri_ids = ids
                stats.leaves += 1
                return node
            mid = len(ids) // 2       # forced even split: leaf must fit a bundle
            part = np.argpartition(c[:, axis], mid)
            l_ids, r_ids = ids[part[:mid]], ids[part[mid:]]
    else:
        raise ValueError(f"unknown BVH strategy {strategy!r}")

    node.left = _build_recursive(l_ids, lo, hi, cen, strategy, leaf_size,
                                 stats, depth + 1)
    node.right = _build_recursive(r_ids, lo, hi, cen, strategy, leaf_size,
                                  stats, depth + 1)
    return node


def _surface_area(lo: np.ndarray, hi: np.ndarray) -> float:
    d = np.maximum(hi - lo, 0.0)
    return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))


def _sah_split(ids, lo, hi, c, axis, c_lo, c_hi, leaf_size):
    """Bucketed SAH sweep (avx/sbvh.cpp:170-232): SAH_BUCKETS candidates,
    traverseCost == intersectCost == 1."""
    n = len(ids)
    t = (c[:, axis] - c_lo[axis]) / (c_hi[axis] - c_lo[axis])
    bucket = np.minimum((t * SAH_BUCKETS).astype(np.int32), SAH_BUCKETS - 1)

    counts = np.zeros(SAH_BUCKETS, np.int64)
    b_lo = np.full((SAH_BUCKETS, 3), np.inf, np.float64)
    b_hi = np.full((SAH_BUCKETS, 3), -np.inf, np.float64)
    for b in range(SAH_BUCKETS):
        m = bucket == b
        counts[b] = m.sum()
        if counts[b]:
            b_lo[b] = lo[ids[m]].min(axis=0)
            b_hi[b] = hi[ids[m]].max(axis=0)

    best_cost, best_split = np.inf, -1
    for split in range(1, SAH_BUCKETS):
        nl = counts[:split].sum()
        nr = counts[split:].sum()
        if nl == 0 or nr == 0:
            continue
        sa_l = _surface_area(b_lo[:split].min(axis=0), b_hi[:split].max(axis=0))
        sa_r = _surface_area(b_lo[split:].min(axis=0), b_hi[split:].max(axis=0))
        cost = 1.0 + (nl * sa_l + nr * sa_r) / max(
            _surface_area(lo[ids].min(axis=0), hi[ids].max(axis=0)), 1e-30)
        if cost < best_cost:
            best_cost, best_split = cost, split

    # falling back to a leaf is only allowed when the leaf fits one bundle
    if best_split < 0 or (best_cost >= n and n <= leaf_size):
        return None, None
    m = bucket < best_split
    return ids[m], ids[~m]


def _flatten(root: _Node, leaf_width: int,
             order_signs=(1.0, 1.0, 1.0)):
    """DFS flatten with skip pointers; leaves padded to leaf_width rows.

    order_signs: per-axis traversal-order hint. Children are emitted
    near-first for rays whose direction signs match (left subtrees hold
    the lower centroids along the split axis, so a +axis ray wants left
    first): fewer triangle tests on coherent batches at no traversal
    cost, since the skip-pointer walk just follows the baked order."""
    node_lo: List[np.ndarray] = []
    node_hi: List[np.ndarray] = []
    node_skip: List[int] = []
    node_start: List[int] = []
    node_count: List[int] = []
    bundled: List[np.ndarray] = []  # leaf triangle id rows (-1 padding)

    def emit(node: _Node) -> int:
        i = len(node_lo)
        node_lo.append(node.lo)
        node_hi.append(node.hi)
        node_skip.append(-1)   # patched below
        if node.tri_ids is not None:
            n = len(node.tri_ids)
            pad = (-n) % leaf_width
            rows = np.concatenate([node.tri_ids,
                                   np.full(pad, -1, np.int64)])
            node_start.append(sum(len(b) for b in bundled))
            node_count.append(len(rows))
            bundled.append(rows)
        else:
            node_start.append(-1)
            node_count.append(0)
            if order_signs[node.axis] >= 0:
                emit(node.left)
                emit(node.right)
            else:
                emit(node.right)
                emit(node.left)
        node_skip[i] = len(node_lo)
        return i

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        emit(root)
    finally:
        sys.setrecursionlimit(old_limit)

    order = np.concatenate(bundled) if bundled else np.zeros(0, np.int64)
    return (np.asarray(node_lo, np.float32), np.asarray(node_hi, np.float32),
            np.asarray(node_skip, np.int32), np.asarray(node_start, np.int32),
            np.asarray(node_count, np.int32), order)


def partition_triangles(tri_v0: np.ndarray, tri_e1: np.ndarray,
                        tri_e2: np.ndarray, valid: Optional[np.ndarray],
                        max_tris: int) -> List[np.ndarray]:
    """Spatial slab partition: valid triangles sorted (stably) by centroid
    along the longest axis of the centroids' bounds, cut into equal parts
    of <= max_tris.

    The treelet decomposition of scenes past engine.RESIDENT_MAX_BUNDLED:
    each part gets its own BVH (global triangle ids kept through the
    `valid` mask), the walks visit the parts in turn, and spatial
    contiguity keeps each part's root box tight, so a ray that misses a
    part leaves its walk at the root.

    Returns a list of boolean masks over the full triangle array.
    """
    tri_v0 = np.asarray(tri_v0, np.float32)
    T = tri_v0.shape[0]
    if valid is None:
        valid = np.ones(T, bool)
    ids = np.nonzero(np.asarray(valid))[0]
    v1 = tri_v0[ids] + np.asarray(tri_e1, np.float32)[ids]
    v2 = tri_v0[ids] + np.asarray(tri_e2, np.float32)[ids]
    lo = np.minimum(np.minimum(tri_v0[ids], v1), v2)
    hi = np.maximum(np.maximum(tri_v0[ids], v1), v2)
    cen = 0.5 * (lo + hi)
    axis = int(np.argmax(cen.max(axis=0) - cen.min(axis=0)))
    order = ids[np.argsort(cen[:, axis], kind="stable")]
    n_parts = -(-len(order) // max_tris)
    per = -(-len(order) // n_parts)
    masks = []
    for p in range(n_parts):
        m = np.zeros(T, bool)
        m[order[p * per:(p + 1) * per]] = True
        if m.any():
            masks.append(m)
    return masks


def build_bvh(tri_v0: np.ndarray, tri_e1: np.ndarray, tri_e2: np.ndarray,
              valid: Optional[np.ndarray] = None, *,
              strategy: str = MEDIAN, leaf_size: int = DEFAULT_LEAF,
              leaf_width: Optional[int] = None,
              builder: str = "auto",
              order_signs=(1.0, 1.0, 1.0)) -> Tuple[BVH, BuildStats]:
    """Build a flattened BVH over (v0, e1, e2) triangles.

    `valid` masks out padding rows of the scene arrays. Returns the BVH
    (host arrays) + build stats. Default MEDIAN matches the reference
    default Strategy (avx/sbvh.hpp:141); leaf geometry is COPIED into
    bundle order so the traversal reads contiguous rows.

    builder: "auto" (native C++ when it builds, else NumPy), "native",
    "numpy". Both builders implement the same algorithm; trees may differ
    only in tie ordering (np.argpartition vs std::nth_element).

    order_signs: dominant ray-direction signs (e.g. the camera front
    vector) baked into child order for near-first traversal.
    """
    if leaf_width is None:
        leaf_width = leaf_size
    assert leaf_size <= leaf_width, "a leaf must fit one bundle"
    tri_v0 = np.asarray(tri_v0, np.float32)
    tri_e1 = np.asarray(tri_e1, np.float32)
    tri_e2 = np.asarray(tri_e2, np.float32)
    T = tri_v0.shape[0]
    if valid is None:
        valid = np.ones(T, bool)

    if builder in ("auto", "native"):
        from orion_tpu_torch.native import bvh_build_native

        out = bvh_build_native(tri_v0, tri_e1, tri_e2, np.asarray(valid),
                               strategy=strategy, leaf_size=leaf_size,
                               leaf_width=leaf_width,
                               order_signs=order_signs)
        if out is not None:
            (n_lo, n_hi, n_skip, n_start, n_count, order,
             max_depth, leaves) = out
            stats = BuildStats(nodes=len(n_lo), leaves=int(leaves),
                               max_depth=int(max_depth),
                               padded_tris=len(order))
            return _assemble(tri_v0, tri_e1, tri_e2, n_lo, n_hi, n_skip,
                             n_start, n_count, order, leaf_width), stats
        if builder == "native":
            raise RuntimeError("native builder requested but the library "
                               "is unavailable (needs g++ and native/)")
    elif builder != "numpy":
        raise ValueError(f"unknown BVH builder {builder!r}")

    ids = np.nonzero(np.asarray(valid))[0]
    if len(ids) == 0:
        raise ValueError("BVH over zero valid triangles")

    v1 = tri_v0 + tri_e1
    v2 = tri_v0 + tri_e2
    lo = np.minimum(np.minimum(tri_v0, v1), v2)
    hi = np.maximum(np.maximum(tri_v0, v1), v2)
    cen = 0.5 * (lo + hi)

    stats = BuildStats()
    root = _build_recursive(ids, lo, hi, cen, strategy, leaf_size, stats, 0)
    n_lo, n_hi, n_skip, n_start, n_count, order = _flatten(root, leaf_width,
                                                           order_signs)

    stats.padded_tris = len(order)
    return _assemble(tri_v0, tri_e1, tri_e2, n_lo, n_hi, n_skip, n_start,
                     n_count, order, leaf_width), stats


def build_scene_bvh(scene, *, strategy: str = SAH,
                    leaf_size: int = DEFAULT_LEAF,
                    leaf_width: Optional[int] = None, builder: str = "auto",
                    order_signs=(1.0, 1.0, 1.0)) -> Tuple[BVH, BuildStats]:
    """build_bvh over a Scene's valid triangles."""
    return build_bvh(scene.numpy("tri_v0"), scene.numpy("tri_e1"),
                     scene.numpy("tri_e2"), scene.numpy("tri_valid"),
                     strategy=strategy, leaf_size=leaf_size,
                     leaf_width=leaf_width, builder=builder,
                     order_signs=order_signs)


def _assemble(tri_v0, tri_e1, tri_e2, n_lo, n_hi, n_skip, n_start, n_count,
              order, leaf_width: int) -> BVH:
    pad_rows = order < 0
    safe = np.where(pad_rows, 0, order)
    b_v0 = tri_v0[safe]
    b_e1 = np.where(pad_rows[:, None], 0.0, tri_e1[safe])  # degenerate pad
    b_e2 = np.where(pad_rows[:, None], 0.0, tri_e2[safe])

    return BVH(
        node_lo=np.asarray(n_lo, np.float32),
        node_hi=np.asarray(n_hi, np.float32),
        node_skip=np.asarray(n_skip, np.int32),
        node_start=np.asarray(n_start, np.int32),
        node_count=np.asarray(n_count, np.int32),
        tri_v0=b_v0.astype(np.float32), tri_e1=b_e1.astype(np.float32),
        tri_e2=b_e2.astype(np.float32),
        tri_orig=np.where(pad_rows, -1, order).astype(np.int32),
        num_nodes=len(n_lo), leaf_width=leaf_width,
    )
