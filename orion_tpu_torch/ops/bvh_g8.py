"""Grouped-pointer BVH walk (G8): CUDA kernel wrapper + plain version.

Replaces `orion_tpu.ops.pallas_bvh_g8` (the Pallas `_make_kernel(M,
any_hit)` and `make_bvh_intersect_g8`): an IntersectFn with the contract
of the walk kernel (ops/bvh_intersect.py, kernel 5) over a tree of
128-row leaves, which schedules the walk differently: a warp of 32 lanes
shares one node pointer and walks the union of its lanes' paths, each
lane on exactly its own path inside it, and the warp's threads split a
leaf's 128 rows for each lane that needs the leaf (`csrc/bvh_g8.cu`).
The JAX package keeps it as a measured negative result on its TPU and
reaches it by name only; so does the port (pass
`make_bvh_intersect_g8(...)` as a wavefront's `intersect`).

The nearest hit is the same function as kernel 5's, so the plain version
is kernel 5's: `bvh_walk_plain` on the same leaf-128 tree, whose (t, row)
the kernel gives bit for bit, any hit's too (the first leaf with a hit).
`bvh_g8` takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from orion_tpu_torch.accel.bvh import BVH
from orion_tpu_torch.ops.bvh_intersect import (NODE_COLS, TRI_COLS,
                                               _bvh_device_layout,
                                               bvh_walk_plain, rows_to_hits)
from orion_tpu_torch.ops.cuda_build import (CudaKernel, check_inputs,
                                            stream_ptr)

LEAF_WIDTH = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P]
# one entry point, two counts: nearest-hit and any-hit launches
KERNEL = CudaKernel("bvh_g8", "bvh_g8_launch", _ARGS)
ANY_HIT_KERNEL = CudaKernel("bvh_g8", "bvh_g8_launch", _ARGS)


def bvh_g8(nodes, tri, orig, dirs, alive, *, any_hit: bool = False):
    """The grouped-pointer walk of rays (orig, dirs [N, 3], alive [N])
    through a packed leaf-128 tree: (t [N] f32, row [N] i32), kernel 5's
    contract. The CUDA kernel for CUDA tensors, the plain version (kernel
    5's plain walk) for CPU tensors."""
    if orig.device.type == "cpu":
        return bvh_walk_plain(nodes, tri, orig, dirs, alive,
                              leaf_width=LEAF_WIDTH, any_hit=any_hit)
    if orig.device.type != "cuda":
        raise ValueError(f"bvh_g8: unsupported device {orig.device}")
    N = orig.shape[0]
    check_inputs("bvh_g8", orig.device,
                 (("nodes", nodes, (nodes.shape[0], NODE_COLS),
                   torch.float32),
                  ("tri", tri, (tri.shape[0], TRI_COLS), torch.float32),
                  ("orig", orig, (N, 3), torch.float32),
                  ("dirs", dirs, (N, 3), torch.float32),
                  ("alive", alive, (N,), torch.bool)))
    if tri.shape[0] % LEAF_WIDTH:
        raise ValueError(f"bvh_g8: {tri.shape[0]} rows, not whole leaves of "
                         f"{LEAF_WIDTH}")
    t = torch.empty((N,), dtype=torch.float32, device=orig.device)
    row = torch.empty((N,), dtype=torch.int32, device=orig.device)
    (ANY_HIT_KERNEL if any_hit else KERNEL).launch(
        orig.data_ptr(), dirs.data_ptr(), alive.data_ptr(), nodes.data_ptr(),
        tri.data_ptr(), nodes.shape[0], N, int(any_hit), t.data_ptr(),
        row.data_ptr(), stream_ptr(orig.device))
    return t, row


def make_bvh_intersect_g8(bvh: BVH, scene, *, any_hit: bool = False,
                          layout=None):
    """IntersectFn closure: the grouped-pointer walk over `bvh` (leaf width
    128, else ValueError, as in the JAX package) on the scene's device;
    make_bvh_intersect_kernel's Hit contract (any_hit=True: occlusion
    only, t = 1.0 on a hit). `layout` shares the node and row tensors of
    `_bvh_device_layout(bvh, device)` with other walks of the same tree
    (kernel 5's)."""
    if bvh.leaf_width != LEAF_WIDTH:
        raise ValueError(f"G8 traversal needs leaf_width={LEAF_WIDTH}, got "
                         f"{bvh.leaf_width}")
    nodes, tri = (layout if layout is not None
                  else _bvh_device_layout(bvh, scene.device))
    return rows_to_hits(bvh, scene, lambda orig, dirs, alive: bvh_g8(
        nodes, tri, orig, dirs, alive, any_hit=any_hit))
