"""Closed-form Whitted-mode material trainer.

The PyTorch counterpart of `orion_tpu.ops.prb_whitted`. The Whitted
estimator (render.py `_whitted_bounce`; the reference's point-light branch,
raytracer.cpp:195-207 and material.hpp:72-93) is a finite product chain
with no sampling beyond the primary jitter:

    L_c = sum_d T_{d,c} r_{d,c},   T_{d+1,c} = T_{d,c} * ks_{d,c}
    r_{d,c} = ke_c E_d + ka_c K_{d,c} + kd_c D_{d,c} + ks_c S_{d,c}

with per-bounce, per-lane coefficients over the point lights l:

    K_c = sum_l lit_l lc_{l,c} I_l / d_l^2            (ambient)
    D_c = sum_l lit_l lc_{l,c} ndotl_l I_l / d_l^2    (diffuse)
    S_c = sum_l lit_l lc_{l,c} spec_l I_l / d_l^2     (specular)
    E   = meshArea * cos at depth 0                    (emissive quirk)

None of them depends on the material colors, so the forward dumps
(K, D, S, E, material, r, T, ks) per bounce and the backward is arithmetic
over the dumps plus a scatter-add by material id (`index_add_`):

    d kd[m,c] += w_c T_{d,c} D_{d,c}          where material_d == m
    d ka[m,c] += w_c T_{d,c} K_{d,c}
    d ke[m,c] += w_c T_{d,c} E_d
    d ks[m,c] += w_c T_{d,c} (S_{d,c} + V_{d+1,c})

V_{d+1} is the suffix radiance at unit throughput after bounce d
(V_d = r_d + ks_d V_{d+1}, built back to front): division-free, and exact
at ks = 0, where the chain is still traced (no zero-throughput pruning).

Intersections go through the scene's intersect function (the brute sweep
kernel on the card). The primary jitter of sample k is the k-th pair of
uniforms a `torch.Generator` seeded with the step's seed draws, the same
draws `render(mode="whitted")` makes with that generator; a step may be
handed an explicit [samples, 2] `jitter` instead, so a caller can feed it
another package's draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orion_tpu_torch.camera import primary_rays
from orion_tpu_torch.ops import shade
from orion_tpu_torch.ops.intersect import hit_attributes, take_rows
from orion_tpu_torch.render import BIAS
from orion_tpu_torch.scene import Scene

WHITTED_PARAMS = ("mat_diffuse", "mat_specular", "mat_ambient",
                  "mat_emissive")


def whitted_train_supported(scene: Scene) -> bool:
    """Gate: point lights present, solid materials (the dumped
    coefficients pair with table colors, not texture samples)."""
    if int(scene.num_lights) < 1:
        return False
    maps = np.concatenate([scene.numpy("mat_map_diffuse"),
                           scene.numpy("mat_map_specular"),
                           scene.numpy("mat_map_bump")])
    return bool((maps < 0).all())


def whitted_jitter(seed: int, samples: int, device) -> torch.Tensor:
    """[samples, 2] sub-pixel jitter uniforms: the draws render() makes,
    one pair per sample, from a generator seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.stack([torch.rand((2,), generator=gen, device=device,
                                   dtype=torch.float32)
                        for _ in range(samples)])


def make_whitted_train_step(scene: Scene, camera, target, *, samples: int,
                            max_depth: int, intersect, shadow_intersect=None):
    """`step(params, seed, jitter=None) -> (loss, grads)`: MSE against
    `target` [H, W, 3] with closed-form gradients for any subset of
    {mat_diffuse, mat_specular, mat_ambient, mat_emissive}. `seed` seeds
    the jitter generator; `jitter` ([samples, 2] uniforms) overrides it.

    The forward runs the bounce chain once (the walks of one render); the
    backward is elementwise math over the per-bounce dumps."""
    if not whitted_train_supported(scene):
        raise ValueError("scene outside the closed-form Whitted gate "
                         "(lights / textures)")
    dev = scene.device
    H, W = camera.yres, camera.xres
    n_pix = H * W
    N = n_pix * samples
    L = int(scene.num_lights)
    M = int(scene.mat_diffuse.shape[0])
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=dev).reshape(n_pix, 3)
    px, py = 2.0 / W, 2.0 / H
    s_fn = shadow_intersect if shadow_intersect is not None else intersect
    lane_pix = torch.arange(n_pix, device=dev).repeat(samples)

    def _primaries(jit):
        os_, ds_ = [], []
        for k in range(samples):
            o, d = primary_rays(camera, jit[k, 0] * px, jit[k, 1] * py)
            os_.append(o)
            ds_.append(d)
        return torch.cat(os_), torch.cat(ds_)

    @torch.no_grad()
    def _impl(params, jit):
        s = dataclasses.replace(scene, **params)
        orig, dirs = _primaries(jit)
        T = torch.ones((N, 3), dtype=torch.float32, device=dev)
        alive = torch.ones((N,), dtype=torch.bool, device=dev)
        dumps = []          # (K, D, S, E, mesh, r, T, ks) per depth
        acc = torch.zeros((N, 3), dtype=torch.float32, device=dev)
        zero = torch.zeros((N,), dtype=torch.float32, device=dev)

        for depth in range(max_depth + 1):
            hit = intersect(s, orig, dirs, alive=alive)
            attrs = hit_attributes(s, orig, dirs, hit)
            hm = alive & hit.mask
            mesh = torch.where(hm, attrs.mat_id, torch.zeros_like(
                attrs.mat_id))
            hmf = hm.to(torch.float32)

            # depth-0 emissive coefficient (raytracer.cpp:127-128)
            if depth == 0:
                area = s.mesh_area[attrs.mesh_id]
                cosv = torch.sum(shade.normalize(dirs) * (-attrs.s_normal),
                                 dim=-1)
                E = (area * cosv) * hmf
            else:
                E = zero

            # per-light coefficients (phong_eval's pieces); any
            # intersection blocks (raytracer.cpp:196-201 quirk)
            shadow_origin = attrs.point + BIAS * attrs.g_normal
            lpos = s.light_pos[:L].repeat_interleave(N, dim=0)
            point_all = attrs.point.repeat(L, 1)
            to_light = lpos - point_all
            s_hit = s_fn(s, shadow_origin.repeat(L, 1), to_light,
                         alive=hm.repeat(L))
            lit = (hm.repeat(L) & ~s_hit.mask).to(torch.float32)

            d2 = torch.sum(to_light * to_light, dim=-1)
            ldir = shade.normalize(to_light)
            n_all = attrs.s_normal.repeat(L, 1)
            ndotl = torch.clamp(torch.sum(n_all * ldir, dim=-1), min=0.0)
            vdir = shade.normalize(-dirs.repeat(L, 1))
            rdir = shade.reflect(-ldir, n_all)
            spec_cos = torch.clamp(torch.sum(vdir * rdir, dim=-1), min=0.0)
            shin = take_rows(s.mat_shininess, mesh).repeat(L)
            spec = 0.5 * torch.pow(spec_cos, shin)
            base = (s.light_color[:L].repeat_interleave(N, dim=0)
                    * (lit * s.light_intensity[:L].repeat_interleave(N)
                       / torch.clamp(d2, min=1e-20))[:, None])
            K = torch.sum(base.reshape(L, N, 3), dim=0)
            D = torch.sum((base * ndotl[:, None]).reshape(L, N, 3), dim=0)
            S = torch.sum((base * spec[:, None]).reshape(L, N, 3), dim=0)

            kd = take_rows(s.mat_diffuse, mesh)
            ks = take_rows(s.mat_specular, mesh)
            ka = take_rows(s.mat_ambient, mesh)
            ke = take_rows(s.mat_emissive, mesh)
            r = (ke * E[:, None] + ka * K + kd * D + ks * S) * hmf[:, None]
            acc = acc + T * r
            dumps.append((K, D, S, E, mesh, r, T, ks))

            # mirror continuation; the chain keeps its shape at ks = 0
            cont = hm & (depth < max_depth)
            T = torch.where(cont[:, None], T * ks, torch.zeros_like(T))
            new_dir = shade.reflect(dirs, attrs.s_normal)
            new_orig = attrs.point + attrs.s_normal * BIAS
            orig = torch.where(cont[:, None], new_orig, orig)
            dirs = torch.where(cont[:, None], new_dir, dirs)
            alive = cont

        # image, loss and the per-lane cotangent
        img = torch.zeros((n_pix, 3), dtype=torch.float32,
                          device=dev).index_add_(0, lane_pix, acc)
        img = img / float(samples)
        diff = img - target
        loss = torch.mean(diff * diff)
        w3 = (diff * np.float32(2.0 / (n_pix * 3 * samples)))[lane_pix]

        # backward: suffix radiance V and the per-bounce adjoints
        g = {k: torch.zeros((M, 3), dtype=torch.float32, device=dev)
             for k in WHITTED_PARAMS}
        V = torch.zeros((N, 3), dtype=torch.float32, device=dev)
        for (K, D, S, E, mesh, r, Td, ks) in reversed(dumps):
            # V == V_{d+1}: suffix radiance at unit throughput
            wT = w3 * Td
            g["mat_diffuse"].index_add_(0, mesh, wT * D)
            g["mat_ambient"].index_add_(0, mesh, wT * K)
            g["mat_emissive"].index_add_(0, mesh, wT * E[:, None])
            g["mat_specular"].index_add_(0, mesh, wT * (S + V))
            V = r + ks * V
        return loss, g

    def step(params, seed: int, jitter=None):
        bad = set(params) - set(WHITTED_PARAMS)
        if bad:
            raise ValueError(f"closed-form Whitted differentiates material "
                             f"tables; got {sorted(bad)}")
        jit = (whitted_jitter(seed, samples, dev) if jitter is None
               else torch.as_tensor(jitter, dtype=torch.float32,
                                    device=dev).reshape(samples, 2))
        params = {k: torch.as_tensor(v).detach().to(dev, torch.float32)
                  for k, v in params.items()}
        loss, g = _impl(params, jit)
        return loss, {k: g[k] for k in params}

    return step
