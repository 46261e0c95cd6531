"""Ray-triangle intersection: the plain brute oracle + hit attribute recompute.

The PyTorch counterpart of `orion_tpu.ops.intersect`. Semantics match the
reference test exactly (geometry.hpp:80-136): two-sided, eps = 1e-6 on
the determinant, u in [0,1], v >= 0, u+v <= 1, t >= 0, nearest hit wins.

Differentiability contract (the PARITY policy): selection returns an
integer `tri_id` with no gradient; `hit_attributes` recomputes (t, u, v)
and the shading attributes differentiably at that fixed id, so every
intersection backend is differentiable through autograd for free.
"""

from __future__ import annotations

import dataclasses

import torch

from orion_tpu_torch.ops.woop import nearest_rows, woop_rows
from orion_tpu_torch.scene import Scene

MT_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class Hit:
    """Per-ray nearest-hit record. tri_id == -1 on miss; t == +inf on miss."""

    t: torch.Tensor       # [N] float32
    tri_id: torch.Tensor  # [N] int32

    @property
    def mask(self) -> torch.Tensor:
        return self.tri_id >= 0


def intersect_brute(scene: Scene, orig: torch.Tensor, dirs: torch.Tensor,
                    *, alive=None) -> Hit:
    """Brute-force nearest intersection of N rays against ALL triangles:
    the plain oracle every other backend is held against.

    alive is accepted and ignored (the dense sweep computes every ray),
    as in the JAX oracle.
    """
    del alive
    with torch.no_grad():
        w13 = woop_rows(scene.tri_v0, scene.tri_e1, scene.tri_e2,
                        scene.tri_valid)
        t, row = nearest_rows(w13, orig.detach(), dirs.detach())
    hit = row >= 0
    return Hit(t=torch.where(hit, t, torch.full_like(t, float("inf"))),
               tri_id=row.to(torch.int32))


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a [T, C] (or [T]) table and [N] integer indices: an
    index gather (differentiable w.r.t. the table; no matmul, so TF32
    never touches the values)."""
    return table[idx.long()]


@dataclasses.dataclass(frozen=True)
class HitAttrs:
    """Differentiable per-ray hit attributes (garbage where hit.mask is False)."""

    t: torch.Tensor        # [N]
    u: torch.Tensor        # [N]
    v: torch.Tensor        # [N]
    point: torch.Tensor    # [N,3] origin + t*dir
    g_normal: torch.Tensor  # [N,3] geometric normal cross(e1,e2), normalized
    s_normal: torch.Tensor  # [N,3] smooth interpolated vertex normal, normalized
    uv: torch.Tensor       # [N,2] interpolated texture coordinates
    mat_id: torch.Tensor   # [N] int64 (0 where miss — callers mask via hit.mask)
    mesh_id: torch.Tensor  # [N] int64


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-20)


def hit_attributes(scene: Scene, orig: torch.Tensor, dirs: torch.Tensor,
                   hit: Hit) -> HitAttrs:
    """Recompute (t,u,v) + shading attributes differentiably at fixed tri ids.

    Gradient flows from these outputs to scene.tri_v0/e1/e2, the corner
    normals/uvs and (through the interpolants) to the ray — with the
    discrete tri_id held fixed.
    """
    idx = torch.clamp(hit.tri_id.detach(), min=0).long()
    v0, e1, e2 = scene.tri_v0[idx], scene.tri_e1[idx], scene.tri_e2[idx]
    rn0, rn1, rn2 = scene.n0[idx], scene.n1[idx], scene.n2[idx]
    ruv0, ruv1, ruv2 = scene.uv0[idx], scene.uv1[idx], scene.uv2[idx]
    mat_id = scene.tri_mat[idx].long()

    pvec = torch.linalg.cross(dirs, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    safe_det = torch.where(torch.abs(det) > MT_EPS, det,
                           torch.ones_like(det))
    inv_det = 1.0 / safe_det
    tvec = orig - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    v = torch.sum(dirs * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det

    point = orig + t[:, None] * dirs
    g_n = _normalize(torch.linalg.cross(e1, e2))
    w = (1.0 - u - v)[:, None]
    s_n = _normalize(w * rn0 + u[:, None] * rn1 + v[:, None] * rn2)
    uv = w * ruv0 + u[:, None] * ruv1 + v[:, None] * ruv2

    return HitAttrs(t=t, u=u, v=v, point=point, g_normal=g_n, s_normal=s_n,
                    uv=uv, mat_id=mat_id, mesh_id=mat_id)

