"""Fixed-topology BVH refit: per-step tree updates for moving geometry.

The PyTorch counterpart of `orion_tpu.accel.refit`. A geometry fit
(optim.fit over tri_v0 / tri_e1 / tri_e2 on a BVH backend) moves the
vertices every step; a rebuild would change the node count and leaf
layout. A refit keeps the built topology (node structure, leaf membership,
bundled row order) and recomputes only the values: the node boxes, bottom
up, and the bundled rows' Woop transforms. The tree's quality degrades as
vertices drift far from the build positions; a caller can build a new plan
every K steps if a fit moves geometry wholesale.

`RefitPlan(bvh).refit(v0, e1, e2)` returns the walk kernel's own device
layout (ops/bvh_intersect._bvh_device_layout: nodes [M, 8], rows
[B_pad, 16]), computed on the host in float64 and cast to float32 as the
JAX package casts it. At the build vertices it equals the layout of the
built tree bit for bit: the sum of two float32 values is exact in float64,
so its rounding to float32 is the float32 sum the build takes, and min /
max commute with that rounding. The bottom-up pass runs one vectorised
step per tree level instead of one Python step per node; min and max are
exact, so the values are the JAX loop's.
"""

from __future__ import annotations

import numpy as np
import torch

from orion_tpu_torch.accel.bvh import BVH


def _host64(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


class RefitPlan:
    """Static topology of a built (binary, uncollapsed) tree and its
    vectorised refit."""

    def __init__(self, bvh: BVH):
        self.n = int(bvh.num_nodes)
        self.leaf_width = int(bvh.leaf_width)
        self.skip = bvh.numpy("node_skip").astype(np.int32)
        self.start = bvh.numpy("node_start").astype(np.int32)
        self.count = bvh.numpy("node_count").astype(np.int64)
        row_orig = bvh.numpy("tri_orig")
        self.pad_rows = row_orig < 0
        self.safe = np.where(self.pad_rows, 0, row_orig)
        # children of internal node i: i + 1 and, when it lies inside i's
        # subtree, skip[i + 1]
        n = self.n
        self.is_leaf = self.start >= 0
        end = np.where(self.skip >= 0, self.skip, n)
        left = np.arange(n) + 1
        right = np.where(left < n, end[np.minimum(left, n - 1)], n)
        self.right_valid = (~self.is_leaf) & (right < end)
        self.left = np.where(self.is_leaf, 0, left)
        self.right = np.where(self.right_valid, right, self.left)
        # depth of every node (a child's index exceeds its parent's)
        depth = np.zeros(n, np.int64)
        for i in np.nonzero(~self.is_leaf)[0]:
            depth[self.left[i]] = depth[i] + 1
            if self.right_valid[i]:
                depth[self.right[i]] = depth[i] + 1
        self.levels = [np.nonzero((depth == d) & ~self.is_leaf)[0]
                       for d in range(int(depth.max()) + 1)]
        # leaves own contiguous row ranges that tile the bundled rows in
        # order, so a leaf's box is one reduceat segment
        leaves = np.nonzero(self.is_leaf)[0]
        order = np.argsort(self.start[leaves], kind="stable")
        self.leaves = leaves[order]
        seg = self.start[self.leaves].astype(np.int64)
        assert (seg[1:] == seg[:-1] + self.count[self.leaves][:-1]).all() \
            and seg[0] == 0, "leaves must tile the bundled rows"
        self.seg = seg

    def refit(self, tri_v0, tri_e1, tri_e2, device="cpu"):
        """(nodes [M, 8], tri [B_pad, 16]) float32 tensors on `device` from
        the current scene-order vertex arrays (tensors or host arrays)."""
        from orion_tpu_torch.ops.bvh_intersect import (pack_nodes,
                                                       pack_tri_comps16)

        v0, e1, e2 = _host64(tri_v0), _host64(tri_e1), _host64(tri_e2)
        b_v0 = v0[self.safe]
        b_e1 = np.where(self.pad_rows[:, None], 0.0, e1[self.safe])
        b_e2 = np.where(self.pad_rows[:, None], 0.0, e2[self.safe])
        # per-row AABB (+-inf on padding rows, so the reductions skip them)
        p1, p2 = b_v0 + b_e1, b_v0 + b_e2
        row_lo = np.minimum(np.minimum(b_v0, p1), p2)
        row_hi = np.maximum(np.maximum(b_v0, p1), p2)
        row_lo[self.pad_rows] = np.inf
        row_hi[self.pad_rows] = -np.inf

        lo = np.empty((self.n, 3), np.float64)
        hi = np.empty((self.n, 3), np.float64)
        lo[self.leaves] = np.minimum.reduceat(row_lo, self.seg, axis=0)
        hi[self.leaves] = np.maximum.reduceat(row_hi, self.seg, axis=0)
        for idx in reversed(self.levels):
            lo[idx] = np.minimum(lo[self.left[idx]], lo[self.right[idx]])
            hi[idx] = np.maximum(hi[self.left[idx]], hi[self.right[idx]])

        nodes = pack_nodes(lo.astype(np.float32), hi.astype(np.float32),
                           self.skip, self.start)
        tri = pack_tri_comps16(b_v0.astype(np.float32),
                               b_e1.astype(np.float32),
                               b_e2.astype(np.float32))
        return (torch.as_tensor(nodes, device=device),
                torch.as_tensor(tri, device=device))
