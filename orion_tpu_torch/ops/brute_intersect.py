"""Brute-force nearest-hit sweep: CUDA kernel wrapper + its plain version.

Replaces `orion_tpu.ops.pallas_intersect` (the Pallas `_brute_kernel`):
alive-masked nearest hit (min t, ties -> min row) of rays against every
Woop row. The kernel is `csrc/brute_intersect.cu`; `brute_sweep_plain`
computes the same function in PyTorch.

`brute_sweep` takes the plain version only for CPU tensors (the CPU
tests); for CUDA tensors it launches the kernel or raises.

The Woop rows here are computed in float32 on the device, as the JAX
package's `pack_tri_rows16` does with jnp, so the sweep matches its own
oracle (`intersect.intersect_brute`) row for row.
"""

from __future__ import annotations

import ctypes

import torch

from orion_tpu_torch.ops.cuda_build import (CudaKernel, check_inputs,
                                            stream_ptr)
from orion_tpu_torch.ops.intersect import Hit
from orion_tpu_torch.ops.woop import nearest_rows, woop_rows
from orion_tpu_torch.scene import Scene

TRI_COLS = 16

_P = ctypes.c_void_p
KERNEL = CudaKernel("brute_intersect", "brute_intersect_launch",
                    [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P])


def pack_tri_rows16(scene: Scene) -> torch.Tensor:
    """[T, 16] float32 table: the 13 Woop floats of each real triangle in
    columns 0..12 (float32 on the scene's device), zeros after."""
    T = scene.num_triangles
    with torch.no_grad():
        w13 = woop_rows(scene.tri_v0[:T], scene.tri_e1[:T], scene.tri_e2[:T])
    tab = torch.zeros((T, TRI_COLS), dtype=torch.float32, device=w13.device)
    tab[:, :13] = w13
    return tab


def brute_sweep_plain(tri: torch.Tensor, orig: torch.Tensor,
                      dirs: torch.Tensor, alive: torch.Tensor):
    """The kernel's function in PyTorch: (t [N] f32, id [N] i32); dead rays
    and misses give (+inf, -1)."""
    t, row = nearest_rows(tri[:, :13], orig, dirs)
    row = torch.where(alive, row, torch.full_like(row, -1))
    t = torch.where(row >= 0, t, torch.full_like(t, float("inf")))
    return t, row.to(torch.int32)


def brute_sweep(tri: torch.Tensor, orig: torch.Tensor, dirs: torch.Tensor,
                alive: torch.Tensor):
    """Nearest hit of rays against the [T, 16] table: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if orig.device.type == "cpu":
        return brute_sweep_plain(tri, orig, dirs, alive)
    if orig.device.type != "cuda":
        raise ValueError(f"brute_sweep: unsupported device {orig.device}")
    N = orig.shape[0]
    check_inputs("brute_sweep", orig.device,
                 (("tri", tri, (tri.shape[0], TRI_COLS), torch.float32),
                  ("orig", orig, (N, 3), torch.float32),
                  ("dirs", dirs, (N, 3), torch.float32),
                  ("alive", alive, (N,), torch.bool)))
    t = torch.empty((N,), dtype=torch.float32, device=orig.device)
    ids = torch.empty((N,), dtype=torch.int32, device=orig.device)
    KERNEL.launch(orig.data_ptr(), dirs.data_ptr(), alive.data_ptr(),
                  tri.data_ptr(), tri.shape[0], N, t.data_ptr(),
                  ids.data_ptr(), stream_ptr(orig.device))
    return t, ids


def intersect_brute_kernel(scene: Scene, orig: torch.Tensor,
                           dirs: torch.Tensor, *, alive=None) -> Hit:
    """Wavefront IntersectFn over the brute sweep (same Hit contract as
    intersect.intersect_brute). Forward-only: hit ids are discrete, and
    hit_attributes recomputes (t, u, v) differentiably at the fixed id."""
    N = orig.shape[0]
    if alive is None:
        alive = torch.ones((N,), dtype=torch.bool, device=orig.device)
    with torch.no_grad():
        t, ids = brute_sweep(pack_tri_rows16(scene),
                             orig.detach().float().contiguous(),
                             dirs.detach().float().contiguous(),
                             alive.contiguous())
    # ids beyond the true triangle count are padding => miss
    valid = ids < scene.num_triangles
    return Hit(t=torch.where(valid, t, torch.full_like(t, float("inf"))),
               tri_id=torch.where(valid, ids, torch.full_like(ids, -1)))
