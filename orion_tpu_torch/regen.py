"""Regenerative wavefront path tracing: dead rays restart as the next
sample immediately.

The PyTorch counterpart of `orion_tpu.regen` (single device). The standard
renderer (render.py) loops over bounce depth: every depth step processes
all H*W rays even though Russian roulette has killed most of them. Here
each ray slot is pinned to one pixel and carries (sample_idx, depth): when
its path terminates (RR, miss, depth cap), the slot regenerates as the
SAME pixel's next sample's primary ray. The wavefront stays full of live
rays, and the loop runs until every slot has finished its samples: about
samples * (mean path length + 1) steps instead of samples * (depth cap + 1).

Estimator: identical to render(..., shared_jitter=False): each (pixel,
sample) contributes one full path with NEE at every bounce and the
reference's RR / depth-cap termination. Every uniform comes from one
`torch.Generator` passed by the caller; images agree with the standard
renderer statistically, not bitwise.

Forward-only (`torch.no_grad`); use the standard renderer for training.
`render_regen_shardmap` runs the loop on each rank's pixel tile.
"""

from __future__ import annotations

from typing import Optional

import torch

from orion_tpu_torch.camera import Camera
from orion_tpu_torch.ops import shade
from orion_tpu_torch.ops.intersect import hit_attributes
from orion_tpu_torch.render import (BIAS, IntersectFn, _nee, _rand,
                                    default_intersect)


def _primary_for_slots(camera: Camera, u: torch.Tensor, pix: torch.Tensor):
    """Per-slot primary rays: slot i <-> pixel pix[i] (row-major), jittered
    by the [n, 2] uniforms `u`. Camera math mirrors camera.primary_rays."""
    H, W = camera.yres, camera.xres
    row = torch.div(pix, W, rounding_mode="floor").to(torch.float32)
    col = (pix % W).to(torch.float32)
    x = 2.0 * (col / W) - 1.0 + u[:, 0] * (2.0 / W)
    y = -(2.0 * (row / H) - 1.0 + u[:, 1] * (2.0 / H))
    dirs = (camera.front[None, :] + x[:, None] * camera.right[None, :]
            + y[:, None] * camera.up[None, :])
    orig = camera.origin.expand(pix.shape[0], 3)
    return orig, dirs


def _regen_loop(scene, camera: Camera, generator: torch.Generator,
                pix: torch.Tensor, *, samples: int, max_depth: int,
                light_samples: int, intersect: IntersectFn,
                max_steps: Optional[int]) -> torch.Tensor:
    """Run the regenerative wavefront over the pixel tile `pix` ([n] int64
    row-major pixel ids; ids >= H*W are padding and render nothing).
    Returns per-slot accumulated radiance [n, 3] (sum over samples)."""
    H, W = camera.yres, camera.xres
    N = pix.shape[0]
    dev = pix.device
    cap = max_steps if max_steps is not None else samples * (max_depth + 1)
    done = pix >= H * W
    pix = torch.clamp(pix, max=max(H * W - 1, 0))

    orig, dirs = _primary_for_slots(camera, _rand(generator, (N, 2), dev),
                                    pix)
    throughput = torch.ones((N, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros((N,), dtype=torch.int64, device=dev)
    sample_idx = torch.zeros((N,), dtype=torch.int64, device=dev)
    acc = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    zero3 = torch.zeros((), dtype=torch.float32, device=dev)

    step = 0
    while step < cap and not bool(done.all()):   # one host sync per step
        live = ~done
        hit = intersect(scene, orig, dirs, alive=live)
        attrs = hit_attributes(scene, orig, dirs, hit)
        hit_mask = live & hit.mask

        # emissive term only at a path's first hit (raytracer.cpp:127-128)
        ke = shade.emissive_color(scene, attrs.mat_id, attrs.uv)
        area = scene.mesh_area[attrs.mesh_id]
        cosv = torch.sum(shade.normalize(dirs) * (-attrs.s_normal), dim=-1)
        em = ke * (area * cosv)[:, None]
        radiance = torch.where((hit_mask & (depth == 0))[:, None], em, zero3)

        # one diffuse sample per step: NEE and Russian roulette share it
        kd = shade.diffuse_color(scene, attrs.mat_id, attrs.uv)
        if scene.num_emissive > 0:
            u_nee = _rand(generator,
                          (scene.num_emissive * light_samples, 3, N), dev)
            radiance = radiance + _nee(scene, attrs, kd, hit_mask, u_nee,
                                       light_samples, intersect)
        acc = acc + radiance * throughput

        # Russian roulette + depth cap (raytracer.cpp:161-170)
        p_continue = torch.max(kd, dim=-1).values
        u_rr = _rand(generator, (N,), dev)
        cont = hit_mask & (depth < max_depth) & (u_rr <= p_continue)
        positive = p_continue > 0.0
        rr_scale = torch.where(
            positive, 1.0 / torch.where(positive, p_continue,
                                        torch.ones_like(p_continue)),
            torch.zeros_like(p_continue))

        u = _rand(generator, (2, N), dev)
        bounce_dir = shade.cosine_sample(attrs.s_normal, u[0], u[1])
        bounce_orig = attrs.point + attrs.s_normal * BIAS

        # terminated paths: regenerate as the next sample, or finish
        terminated = live & ~cont
        next_sample = sample_idx + 1
        regen = terminated & (next_sample < samples)
        done = done | (terminated & (next_sample >= samples))

        # slot-addressed jitter: regenerated samples draw fresh uniforms
        r_orig, r_dirs = _primary_for_slots(
            camera, _rand(generator, (N, 2), dev), pix)

        sel, rg = cont[:, None], regen[:, None]
        orig = torch.where(sel, bounce_orig, torch.where(rg, r_orig, orig))
        dirs = torch.where(sel, bounce_dir, torch.where(rg, r_dirs, dirs))
        throughput = torch.where(
            sel, throughput * kd * rr_scale[:, None],
            torch.where(rg, torch.ones_like(throughput), throughput))
        depth = torch.where(cont, depth + 1,
                            torch.where(regen, torch.zeros_like(depth),
                                        depth))
        sample_idx = torch.where(regen, next_sample, sample_idx)
        step += 1
    return acc


def render_regen(scene, camera: Camera, generator: torch.Generator, *,
                 samples: int, max_depth: int, light_samples: int = 2,
                 intersect: Optional[IntersectFn] = None,
                 max_steps: Optional[int] = None) -> torch.Tensor:
    """Path-traced [H, W, 3] render with path regeneration (see the module
    docstring). Scenes without emissive meshes get no NEE term (matching
    render.py's path mode). `generator` lives on the camera's device."""
    if intersect is None:
        intersect = default_intersect()
    H, W = camera.yres, camera.xres
    with torch.no_grad():
        acc = _regen_loop(scene, camera, generator,
                          torch.arange(H * W, dtype=torch.int64,
                                       device=camera.device),
                          samples=samples, max_depth=max_depth,
                          light_samples=light_samples, intersect=intersect,
                          max_steps=max_steps)
    return acc.reshape(H, W, 3) / float(samples)


def render_regen_shardmap(scene, camera: Camera, generator: torch.Generator,
                          *, mesh=None, samples: int, max_depth: int,
                          light_samples: int = 2,
                          intersect: Optional[IntersectFn] = None,
                          max_steps: Optional[int] = None) -> torch.Tensor:
    """Multi-device regenerative path tracing: [H, W, 3] on every rank.

    Each rank of `mesh` (default: parallel.sharding.make_mesh()) runs the
    regenerative loop to completion over its own pixel tile, with no
    per-step sync (a rank whose paths are short finishes early), then one
    all-gather assembles the image. RNG folds the rank as
    parallel/shardmap_render.py does: in a world of W > 1 ranks one draw
    from the caller's `generator` seeds each rank's stream
    (`rank_generator`), so the image is deterministic per (generator
    state, world size); a world of one runs on `generator` itself and
    equals `render_regen`."""
    from orion_tpu_torch.parallel.distributed import all_gather_rows
    from orion_tpu_torch.parallel.sharding import check_placement, make_mesh
    from orion_tpu_torch.parallel.shardmap_render import rank_generator

    if intersect is None:
        intersect = default_intersect()
    if mesh is None:
        mesh = make_mesh()
    check_placement("render_regen_shardmap", mesh, scene)
    H, W = camera.yres, camera.xres
    lo, hi = mesh.tile(H * W)
    gen = generator if mesh.world == 1 else rank_generator(generator, mesh)
    with torch.no_grad():
        acc = _regen_loop(scene, camera, gen,
                          torch.arange(lo, hi, dtype=torch.int64,
                                       device=camera.device),
                          samples=samples, max_depth=max_depth,
                          light_samples=light_samples, intersect=intersect,
                          max_steps=max_steps)
    img = all_gather_rows(acc, H * W, mesh)
    return img.reshape(H, W, 3) / float(samples)
