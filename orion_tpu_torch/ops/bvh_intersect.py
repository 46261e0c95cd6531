"""BVH walk (nearest hit and any hit): CUDA kernel wrapper + plain version.

Replaces `orion_tpu.ops.pallas_bvh` (the Pallas packet-traversal
`_make_kernel`): the wavefront renderer's intersect for scenes past the
brute sweep's gate, and its occlusion-only variant for Whitted shadow
rays. The kernel is `csrc/bvh_intersect.cu`: resident threads, each
walking one ray at a time through windows of consecutive node rows,
refilling a warp's idle lanes from a lane counter where the rays
outnumber the threads; `bvh_walk_plain` is the same per-ray walk batched
in PyTorch (ops/bvh_traverse.walk_plain over the kernel's own tables).

`bvh_walk` takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.

Device layout (`_bvh_device_layout`, shared by both variants):
  nodes [M, 8] float32: lo xyz, hi xyz, then skip and start as int32 bits
  tri   [B_pad, 16] float32, row-major: the 13 Woop floats of each bundled
        row, precomputed in float64 on the host; padding rows always miss
The TPU kernel holds the same data as eight node vectors and a
[16, B_pad] component-row array; a thread reads a node or a row as
contiguous float4s instead. Any leaf width is accepted (the TPU kernel
pins 128, its lane width).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from orion_tpu_torch.accel.bvh import BVH
from orion_tpu_torch.ops.bvh_traverse import walk_plain
from orion_tpu_torch.ops.cuda_build import (CudaKernel, check_inputs,
                                            stream_ptr)
from orion_tpu_torch.ops.intersect import Hit
from orion_tpu_torch.ops.woop import woop_rows_np

TRI_COLS = 16
NODE_COLS = 8
LANE_MULT = 128    # row padding granularity (the JAX package's)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
# one entry point, two counts: nearest-hit and any-hit launches
KERNEL = CudaKernel("bvh_intersect", "bvh_intersect_launch", _ARGS)
ANY_HIT_KERNEL = CudaKernel("bvh_intersect", "bvh_intersect_launch", _ARGS)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_tri_comps16(tri_v0, tri_e1, tri_e2,
                     lane_mult: int = LANE_MULT) -> np.ndarray:
    """[B,3]x3 -> [B_pad, 16] rows (the 13 Woop transform floats in columns
    0..12), padding rows always-miss (c_w = 1, d'_w = 0). The bundled
    geometry is host NumPy, so the transform is precomputed in float64.
    The transpose of the JAX package's [16, B_pad] array."""
    B = tri_v0.shape[0]
    B_pad = _round_up(max(B, lane_mult), lane_mult)
    data = np.zeros((B_pad, TRI_COLS), np.float32)
    data[:B, 0:13] = woop_rows_np(tri_v0, tri_e1, tri_e2)
    data[B:, 11] = 1.0
    return data


def pack_nodes(lo, hi, skip, start) -> np.ndarray:
    """[M, 8] float32 node rows: lo xyz, hi xyz, skip and start as int32
    bits."""
    M = lo.shape[0]
    nodes = np.zeros((M, NODE_COLS), np.float32)
    nodes[:, 0:3] = lo
    nodes[:, 3:6] = hi
    nodes.view(np.int32)[:, 6] = skip
    nodes.view(np.int32)[:, 7] = start
    return nodes


def unpack_nodes(nodes: torch.Tensor):
    """(lo [M,3], hi [M,3], skip [M] i32, start [M] i32) of packed rows."""
    ints = nodes[:, 6:8].contiguous().view(torch.int32)
    return nodes[:, 0:3], nodes[:, 3:6], ints[:, 0], ints[:, 1]


def _bvh_device_layout(bvh: BVH, device):
    """Kernel-ready tensors on `device`: (nodes [M, 8], tri [B_pad, 16])."""
    nodes = pack_nodes(bvh.numpy("node_lo"), bvh.numpy("node_hi"),
                       bvh.numpy("node_skip"), bvh.numpy("node_start"))
    tri = pack_tri_comps16(bvh.numpy("tri_v0"), bvh.numpy("tri_e1"),
                           bvh.numpy("tri_e2"))
    return (torch.as_tensor(nodes, device=device),
            torch.as_tensor(tri, device=device))


def bvh_walk_plain(nodes, tri, orig, dirs, alive, *, leaf_width: int,
                   any_hit: bool = False, stats: dict | None = None):
    """The kernel's function in PyTorch: (t [N] f32, row [N] i32); dead
    rays and misses give (+inf, -1); any_hit gives t = 1.0 on a hit."""
    lo, hi, skip, start = unpack_nodes(nodes)
    t, row = walk_plain(lo, hi, skip, start, tri, orig, dirs,
                        leaf_width=leaf_width, alive=alive, any_hit=any_hit,
                        stats=stats)
    t = torch.where(row >= 0, t, torch.full_like(t, float("inf")))
    return t, row.to(torch.int32)


def bvh_walk(nodes, tri, orig, dirs, alive, *, leaf_width: int,
             any_hit: bool = False):
    """Walk of rays through the packed tree: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if orig.device.type == "cpu":
        return bvh_walk_plain(nodes, tri, orig, dirs, alive,
                              leaf_width=leaf_width, any_hit=any_hit)
    if orig.device.type != "cuda":
        raise ValueError(f"bvh_walk: unsupported device {orig.device}")
    N = orig.shape[0]
    check_inputs("bvh_walk", orig.device,
                 (("nodes", nodes, (nodes.shape[0], NODE_COLS),
                   torch.float32),
                  ("tri", tri, (tri.shape[0], TRI_COLS), torch.float32),
                  ("orig", orig, (N, 3), torch.float32),
                  ("dirs", dirs, (N, 3), torch.float32),
                  ("alive", alive, (N,), torch.bool)))
    if leaf_width < 1:
        raise ValueError(f"bvh_walk: leaf_width {leaf_width}")
    t = torch.empty((N,), dtype=torch.float32, device=orig.device)
    row = torch.empty((N,), dtype=torch.int32, device=orig.device)
    # the lane counter; the launch zeroes it on the stream where it uses it
    nxt = torch.empty((1,), dtype=torch.int32, device=orig.device)
    (ANY_HIT_KERNEL if any_hit else KERNEL).launch(
        orig.data_ptr(), dirs.data_ptr(), alive.data_ptr(), nodes.data_ptr(),
        tri.data_ptr(), nodes.shape[0], int(leaf_width), N, int(any_hit),
        t.data_ptr(), row.data_ptr(), nxt.data_ptr(), stream_ptr(orig.device))
    return t, row


def make_bvh_intersect_kernel(bvh: BVH, scene, *, any_hit: bool = False,
                              layout=None):
    """IntersectFn closure over a flattened BVH on the scene's device: the
    CUDA walk kernel there (the plain walk for a CPU scene).

    Maps bundled rows to global scene triangle ids (tri_orig), matching
    the other backends' Hit contract: -1 and +inf on a miss.

    any_hit=True returns occlusion-only Hits (mask/tri_id of SOME hit,
    t = 1.0, not the nearest): a ray retires on its first intersection.
    Only valid where callers use hit.mask alone (Whitted shadow rays,
    render.py `shadow_intersect`).

    layout: a `_bvh_device_layout(bvh, device)` result to share the node
    and triangle tensors between variants built from the same tree.
    """
    dev = scene.device
    nodes, tri = layout if layout is not None else _bvh_device_layout(bvh,
                                                                      dev)
    leaf_width = bvh.leaf_width
    return rows_to_hits(bvh, scene, lambda orig, dirs, alive: bvh_walk(
        nodes, tri, orig, dirs, alive, leaf_width=leaf_width,
        any_hit=any_hit))


def rows_to_hits(bvh: BVH, scene, walk):
    """IntersectFn over `walk(orig, dirs, alive) -> (t, row)`, a walk of
    the tree's bundled rows: maps rows to global scene triangle ids
    (tri_orig), -1 and +inf on a miss and on a padding row."""
    dev = scene.device
    tri_orig = torch.as_tensor(bvh.numpy("tri_orig"), device=dev)
    num_triangles = scene.num_triangles
    n_rows = tri_orig.shape[0]

    def intersect(scene, orig, dirs, *, alive=None) -> Hit:
        del scene  # geometry lives in the tree's bundled copies
        N = orig.shape[0]
        if alive is None:
            alive = torch.ones((N,), dtype=torch.bool, device=orig.device)
        with torch.no_grad():
            t, row = walk(orig.detach().float().contiguous(),
                          dirs.detach().float().contiguous(),
                          alive.contiguous())
            safe = torch.clamp(row, min=0, max=n_rows - 1).long()
            tri_id = torch.where(row >= 0, tri_orig[safe],
                                 torch.full_like(row, -1))
            tri_id = torch.where(tri_id < num_triangles, tri_id,
                                 torch.full_like(tri_id, -1))
        return Hit(t=torch.where(tri_id >= 0, t,
                                 torch.full_like(t, float("inf"))),
                   tri_id=tri_id)

    return intersect
