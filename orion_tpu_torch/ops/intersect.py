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


def mt_test(orig: torch.Tensor, dirs: torch.Tensor, v0: torch.Tensor,
            e1: torch.Tensor, e2: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """Dense Möller-Trumbore: rays [N,3] against triangles [T,3].

    Returns t [N,T] with +inf where there is no (valid) intersection: the
    independent formulation of the test that the Woop sweeps are held
    against. Every intermediate is an [N, T] plane of [N, 1] ray and
    [1, T] triangle components, in the JAX package's order.
    """
    ox, oy, oz = (orig[:, i, None] for i in range(3))
    dx, dy, dz = (dirs[:, i, None] for i in range(3))
    v0x, v0y, v0z = (v0[None, :, i] for i in range(3))
    e1x, e1y, e1z = (e1[None, :, i] for i in range(3))
    e2x, e2y, e2z = (e2[None, :, i] for i in range(3))

    # pvec = cross(d, e2)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / det
    # tvec = o - v0
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = cross(tvec, e1)
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det

    ok = ((torch.abs(det) > MT_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= 0.0) & valid.bool()[None, :])
    return torch.where(ok, t, torch.full_like(t, float("inf")))


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


def tangent_frame(scene: Scene, hit: Hit):
    """Per-hit UV-space tangent and bitangent [N, 3] for normal mapping.

    T = (e1 dv2 - e2 dv1) / det, B = (e2 du1 - e1 du2) / det with
    det = du1 dv2 - du2 dv1 (Assimp's CalcTangentSpace); where
    |det| <= 1e-12 (a degenerate UV mapping) the frame falls back to
    (e1, e2).
    """
    idx = torch.clamp(hit.tri_id.detach(), min=0).long()
    e1, e2 = scene.tri_e1[idx], scene.tri_e2[idx]
    uv0, uv1, uv2 = scene.uv0[idx], scene.uv1[idx], scene.uv2[idx]
    du1 = (uv1 - uv0)[:, 0]
    dv1 = (uv1 - uv0)[:, 1]
    du2 = (uv2 - uv0)[:, 0]
    dv2 = (uv2 - uv0)[:, 1]
    det = du1 * dv2 - du2 * dv1
    ok = torch.abs(det) > 1e-12
    inv = (1.0 / torch.where(ok, det, torch.ones_like(det)))[:, None]
    tangent = (e1 * dv2[:, None] - e2 * dv1[:, None]) * inv
    bitangent = (e2 * du1[:, None] - e1 * du2[:, None]) * inv
    return (torch.where(ok[:, None], tangent, e1),
            torch.where(ok[:, None], bitangent, e2))
