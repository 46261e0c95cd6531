"""Primitive (triangle) sharding over torch.distributed: the TP analogue.

The PyTorch counterpart of `orion_tpu.parallel.primitive_sharding`. Ray
sharding (parallel/shardmap_render.py) splits the batch; primitive
sharding splits the scene: each rank intersects its rays against its slab
of the triangle table only, and the nearest hit is merged across the
slab ranks with one all-gather per intersect call.

Layout: a world of n_ray x n_tp ranks (`make_mesh_2d`); rank r sits at
(r // n_tp, r % n_tp). The ranks of one row (one ray index) form the tp
group and trace the same ray tile; the ranks of one column (one tp index)
form the ray mesh, whose tiles cover the image as render_shardmap's do.

  - `make_tp_intersect(tp_group)`: tp rank k sweeps rows [k S, (k + 1) S)
    (S = ceil(T / n_tp)) of `pack_tri_rows16(scene)` with the brute sweep
    (kernel 2, csrc/brute_intersect.cu, on CUDA tensors; its plain version
    on CPU tensors) and reports GLOBAL ids (slab start + local row). The
    slab winners travel in ONE all-gather a call: t's bits and the ids in
    one int32 buffer. The merge keeps the strictly smaller t, so the
    lowest rank (which owns the lowest rows) wins a tie: the merged Hit is
    the whole-table sweep's (min t, ties to the least row) bit for bit.
  - everything downstream of the intersect (shading, NEE, roulette) runs
    replicated over the tp group: every tp rank of a ray tile computes the
    same radiance.
  - shading tables stay replicated: what TP shards is the O(N x T)
    intersection work.

The JAX package's slab test is Möller-Trumbore (`mt_test`) with an argmin;
the port keeps the Woop sweep of its brute kernel, so ids agree with JAX's
except where coplanar faces tie, and t to float rounding.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from orion_tpu_torch.camera import Camera
from orion_tpu_torch.ops.brute_intersect import brute_sweep, pack_tri_rows16
from orion_tpu_torch.ops.intersect import Hit
from orion_tpu_torch.parallel.distributed import all_gather_rows
from orion_tpu_torch.parallel.sharding import Mesh, make_mesh
from orion_tpu_torch.parallel.shardmap_render import render_shardmap
from orion_tpu_torch.render import IntersectFn
from orion_tpu_torch.scene import Scene

def make_mesh_2d(n_ray: int, n_tp: int, device=None) -> tuple[Mesh, Mesh]:
    """(ray mesh, tp group) of this rank in an n_ray x n_tp world.

    The world (the default process group; a world of one without it) must
    hold n_ray * n_tp ranks. Rank r sits at (r // n_tp, r % n_tp). Every
    rank creates every row group and every column group of more than one
    rank with `dist.new_group`, rows first, in one order, and keeps the two
    it belongs to: the ray mesh is its column (rank r // n_tp of n_ray),
    the tp group its row (rank r % n_tp of n_tp), both on `device`
    (make_mesh's default). A one-rank group is a Mesh without a process
    group, which issues no collective."""
    base = make_mesh(device=device)
    if base.world != n_ray * n_tp:
        raise ValueError(f"need {n_ray * n_tp} ranks, have {base.world}")
    r = base.rank
    row, col = r // n_tp, r % n_tp
    ray_group = tp_group = None
    if n_tp > 1:
        for i in range(n_ray):
            g = dist.new_group([i * n_tp + j for j in range(n_tp)])
            if i == row:
                tp_group = g
    if n_ray > 1:
        for j in range(n_tp):
            g = dist.new_group([i * n_tp + j for i in range(n_ray)])
            if j == col:
                ray_group = g
    return (Mesh(ray_group, row, n_ray, base.device),
            Mesh(tp_group, col, n_tp, base.device))


def slab_hit(scene: Scene, orig: torch.Tensor, dirs: torch.Tensor,
             alive: torch.Tensor, k: int, n_tp: int):
    """(t [N] f32, global id [N] i32) of rays against slab k of n_tp of
    `pack_tri_rows16(scene)`: rows [k S, min((k + 1) S, T)), S = ceil(T /
    n_tp), swept by `brute_sweep` (kernel 2 on CUDA tensors); misses, dead
    rays and an empty slab give (+inf, -1)."""
    N, dev = orig.shape[0], orig.device
    T = scene.num_triangles
    S = -(-T // n_tp)
    start = min(k * S, T)
    slab = pack_tri_rows16(scene)[start:min(start + S, T)]
    if slab.shape[0] == 0:
        return (torch.full((N,), float("inf"), dtype=torch.float32,
                           device=dev),
                torch.full((N,), -1, dtype=torch.int32, device=dev))
    t, local = brute_sweep(slab, orig, dirs, alive)
    return t, torch.where(local >= 0, local + start, local)


def merge_slab_hits(ts: torch.Tensor, ids: torch.Tensor) -> Hit:
    """The nearest of n_tp slab winners ([n_tp, N] each), rank by rank,
    keeping the strictly smaller t: the lowest rank wins a tie."""
    t_best, id_best = ts[0], ids[0]
    for r in range(1, ts.shape[0]):
        better = ts[r] < t_best
        t_best = torch.where(better, ts[r], t_best)
        id_best = torch.where(better, ids[r], id_best)
    return Hit(t=torch.where(id_best >= 0, t_best,
                             torch.full_like(t_best, float("inf"))),
               tri_id=id_best)


def make_tp_intersect(tp_group: Mesh) -> IntersectFn:
    """An IntersectFn over this rank's slab of the triangle table, merged
    over `tp_group` (make_mesh_2d's second result): the module docstring's
    contract. Every rank of the group must call it with the same rays (the
    same ray tile), as render_tp's ranks do."""
    k, n_tp = tp_group.rank, tp_group.world

    def intersect(scene: Scene, orig: torch.Tensor, dirs: torch.Tensor, *,
                  alive=None) -> Hit:
        N = orig.shape[0]
        if alive is None:
            alive = torch.ones((N,), dtype=torch.bool, device=orig.device)
        with torch.no_grad():
            t, gid = slab_hit(scene, orig.detach().float().contiguous(),
                              dirs.detach().float().contiguous(),
                              alive.contiguous(), k, n_tp)
            # t's bits and the ids in one int32 buffer: ONE all-gather
            buf = torch.stack([t.view(torch.int32), gid], dim=1)   # [N, 2]
            every = all_gather_rows(buf, N * n_tp, tp_group).reshape(
                n_tp, N, 2)
            return merge_slab_hits(
                every[:, :, 0].contiguous().view(torch.float32),
                every[:, :, 1])

    return intersect


def render_tp(scene: Scene, camera: Camera, generator: torch.Generator, *,
              mesh: Optional[tuple[Mesh, Mesh]] = None,
              n_tp: Optional[int] = None, samples: int = 1,
              max_depth: int = 1, light_samples: int = 2,
              mode: Optional[str] = None) -> torch.Tensor:
    """[H, W, 3] with rays tiled over the ray mesh and triangles over the
    tp group: render_shardmap over `mesh`'s ray mesh with the intersect
    `make_tp_intersect(mesh[1])`.

    mesh: make_mesh_2d's (ray mesh, tp group); default make_mesh_2d(world
    // n_tp, n_tp) with n_tp the whole world (pure primitive sharding). The
    ranks of a tp group share their ray index, so they trace the same
    stream (render_shardmap folds the ray index alone into it). So (n_ray,
    n_tp) renders render_shardmap's image on n_ray ranks over the brute
    sweep bit for bit, and (1, n_tp) renders
    `render(..., intersect=intersect_brute_kernel)`'s. Every rank passes an
    identical `generator` and gets the whole image."""
    if mesh is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        n_tp = n_tp or world
        mesh = make_mesh_2d(world // n_tp, n_tp, device=scene.device)
    ray, tp = mesh
    return render_shardmap(scene, camera, generator, mesh=ray,
                           samples=samples, max_depth=max_depth,
                           light_samples=light_samples, mode=mode,
                           intersect=make_tp_intersect(tp))
