"""Shading: texture sampling, Phong, BRDF-NEE term, sampling routines.

The PyTorch counterpart of `orion_tpu.ops.shade` for the path and Whitted
modes. Reproduces the reference shading model (orion/material.hpp):
  - `phong_eval`         <- Material::color (material.hpp:72-93), from
                            pre-sampled material terms
  - `brdf_eval`          <- Material::colorBRDF (material.hpp:95-105),
                            with its 1/(1+d^2) falloff and two-cosine
                            geometry factor
  - `reflect`            <- math.hpp:321-323
  - `cosine_sample`      <- raytracer.cpp:173-192, tangent frame normalized
                            (documented deviation, PARITY.md)
Normal mapping (`perturb_normal`) is not ported yet.
"""

from __future__ import annotations

import math

import torch

from orion_tpu_torch.ops.intersect import take_rows
from orion_tpu_torch.scene import Scene


def _dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """r = v - 2*dot(v,n)*n, rowwise over [..., 3]."""
    return v - 2.0 * _dot(v, n, keepdim=True) * n


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=eps)


def _mat_tex_table(scene: Scene, map_per_mat: torch.Tensor) -> torch.Tensor:
    """[M, 5] float rows (has_map, h, w, off_y, off_x) for one texture
    slot; dims/offsets are exact in f32 (atlas extents << 2^24)."""
    img = torch.clamp(map_per_mat, min=0).long()
    return torch.cat(
        [(map_per_mat >= 0)[:, None].to(torch.float32),
         scene.tex_hw[img].to(torch.float32),
         scene.tex_off[img].to(torch.float32)], dim=1)


def _sample_texture_mat(scene: Scene, map_per_mat: torch.Tensor,
                        mat_id: torch.Tensor, uv: torch.Tensor,
                        solid: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour texel lookup with floored-modulo wrap on both
    axes (texture.hpp:72-86, with the reference's negative-v wrap bug
    fixed; PARITY.md); materials without a map keep `solid`."""
    rows = take_rows(_mat_tex_table(scene, map_per_mat), mat_id)  # [N,5]
    has = rows[:, 0] > 0.5
    h = rows[:, 1].to(torch.int64)
    w = rows[:, 2].to(torch.int64)
    ui = torch.remainder(torch.floor(uv[:, 0] * rows[:, 2]).to(torch.int64), w)
    vi = torch.remainder(torch.floor(uv[:, 1] * rows[:, 1]).to(torch.int64), h)
    oy = rows[:, 3].to(torch.int64)
    ox = rows[:, 4].to(torch.int64)
    texel = scene.tex_atlas[oy + vi, ox + ui]  # [N, 3]
    return torch.where(has[:, None], texel, solid)


def diffuse_color(scene: Scene, mat_id, uv) -> torch.Tensor:
    return _sample_texture_mat(scene, scene.mat_map_diffuse, mat_id, uv,
                               take_rows(scene.mat_diffuse, mat_id))


def specular_color(scene: Scene, mat_id, uv) -> torch.Tensor:
    return _sample_texture_mat(scene, scene.mat_map_specular, mat_id, uv,
                               take_rows(scene.mat_specular, mat_id))


def ambient_color(scene: Scene, mat_id, uv) -> torch.Tensor:
    # the reference never installs an ambient image (model.cpp:153 loads it
    # into a dead variable), so ambient is always the solid Ka
    del uv
    return take_rows(scene.mat_ambient, mat_id)


def emissive_color(scene: Scene, mat_id, uv) -> torch.Tensor:
    # likewise emissive is always the solid Ke
    del uv
    return take_rows(scene.mat_emissive, mat_id)


def phong_eval(ka, kd, ks, shininess, ray_dir, normal, hit_point,
               light_pos, light_color, light_intensity) -> torch.Tensor:
    """Phong: light.color*(ambient + diff*Kd + spec*Ks)*intensity/d^2
    from pre-sampled material terms; `normal` must be normalized."""
    to_light = light_pos - hit_point
    d2 = _dot(to_light, to_light)
    light_dir = normalize(to_light)

    ndotl = torch.clamp(_dot(normal, light_dir), min=0.0)
    diffuse = ndotl[:, None] * kd

    view_dir = normalize(-ray_dir)
    reflect_dir = reflect(-light_dir, normal)
    spec_cos = torch.clamp(_dot(view_dir, reflect_dir), min=0.0)
    # pow(0, 0) == 1, like C++ powf
    spec = 0.5 * torch.pow(spec_cos, shininess)
    specular = spec[:, None] * ks

    return (light_color * (ka + diffuse + specular)
            * (light_intensity / torch.clamp(d2, min=1e-20))[:, None])


def brdf_eval(kd, normal, hit_point, light_pos, light_color,
              light_intensity, light_normal) -> torch.Tensor:
    """NEE diffuse term Ke * Kd * max(cos_s * cos_l, 0) * intensity /
    (1+d^2) from a pre-sampled Kd: the reference's non-physical but
    self-consistent falloff, with the clamp on the cosine *product*."""
    to_light = light_pos - hit_point
    d2 = _dot(to_light, to_light)
    light_dir = normalize(to_light)
    cos_s = _dot(normal, light_dir)
    cos_l = _dot(light_normal, -light_dir)
    geom = torch.clamp(cos_s * cos_l, min=0.0)
    return light_color * kd * (geom * light_intensity / (1.0 + d2))[:, None]


def cosine_sample(normal: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor,
                  reference_frame: bool = False) -> torch.Tensor:
    """Cosine-weighted hemisphere sample around `normal` (normalized [N,3]).

    sin_theta = sqrt(u1), psi = 2*pi*u2 (raytracer.cpp:173-192). Tangent =
    cross(n, (0,1,0)), falling back to cross(n, (0,0,1)) when degenerate;
    normalized unless reference_frame=True (the reference's squashed frame).
    """
    sin_theta = torch.sqrt(u1)
    cos_theta = torch.sqrt(torch.clamp(1.0 - sin_theta * sin_theta, min=0.0))
    psi = u2 * (2.0 * math.pi)

    up_y = torch.tensor([0.0, 1.0, 0.0], dtype=normal.dtype,
                        device=normal.device).expand_as(normal)
    up_z = torch.tensor([0.0, 0.0, 1.0], dtype=normal.dtype,
                        device=normal.device).expand_as(normal)
    tangent = torch.linalg.cross(normal, up_y)
    degenerate = _dot(tangent, tangent, keepdim=True) == 0.0
    tangent = torch.where(degenerate, torch.linalg.cross(normal, up_z),
                          tangent)
    bitangent = torch.linalg.cross(normal, tangent)
    if not reference_frame:
        tangent = normalize(tangent)
        bitangent = normalize(bitangent)

    a = (sin_theta * torch.cos(psi))[:, None]
    b = (sin_theta * torch.sin(psi))[:, None]
    c = cos_theta[:, None]
    return a * tangent + b * bitangent + c * normal


def sample_mesh_point(scene: Scene, mesh_id: int, u_tri: torch.Tensor,
                      u_a: torch.Tensor, u_b: torch.Tensor):
    """Uniform-by-count random point on mesh `mesh_id` (python int).

    Mirrors TracedMesh::randomPointOnSurface (mesh.hpp:178-184) +
    Triangle::randomPointOnSurface (geometry.hpp:159-171): pick a triangle
    uniformly by index, fold the parallelogram sample, and return the
    point, the light-sample weight (triArea * triCount, raytracer.cpp:
    150-155) and the sampled triangle's global id.
    """
    start = scene.mesh_tri_start[mesh_id]
    count = scene.mesh_tri_count[mesh_id]
    tri_local = torch.minimum((u_tri * count.to(u_tri.dtype)).to(torch.int32),
                              count - 1)
    tri = (start + tri_local).long()

    v0 = scene.tri_v0[tri]
    e1 = scene.tri_e1[tri]
    e2 = scene.tri_e2[tri]

    flip = (u_a + u_b) > 1.0
    a = torch.where(flip, 1.0 - u_a, u_a)[:, None]
    b = torch.where(flip, 1.0 - u_b, u_b)[:, None]
    point = v0 + a * e1 + b * e2

    tri_area = 0.5 * torch.linalg.norm(torch.linalg.cross(e1, e2), dim=-1)
    weight = tri_area * count.to(tri_area.dtype)
    return point, weight, tri
