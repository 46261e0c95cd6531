"""The wavefront renderer: Whitted ray tracing and BRDF path tracing.

The PyTorch counterpart of `orion_tpu.render` (RayTracer::traceRTC /
RayTracer::trace, raytracer.cpp:19-210): the whole image is one ray
wavefront [N = H*W] and the bounce recursion is a loop over depth carrying
(origin, dir, throughput, alive) per ray. Differentiable through autograd:
intersection returns detached hit ids and `hit_attributes` recomputes the
geometry at them.

Mode selection matches the reference (raytracer.cpp:131): scenes with point
lights render Whitted-style; scenes without render with BRDF path tracing +
next-event estimation on emissive meshes + Russian roulette.

RNG: every uniform comes from one `torch.Generator` passed by the caller
(the JAX package folds threefry keys; the two streams differ, so images
agree statistically, not bitwise).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from orion_tpu_torch.camera import Camera, primary_rays
from orion_tpu_torch.ops import shade
from orion_tpu_torch.ops.intersect import Hit, hit_attributes, take_rows
from orion_tpu_torch.scene import Scene

# bias to move rays off surfaces (raytracer.cpp:118)
BIAS = 1e-3

# IntersectFn protocol: (scene, orig [N,3], dirs [N,3], *, alive=None) -> Hit
IntersectFn = Callable[..., Hit]


def _not_ported(**flags) -> None:
    on = [name for name, value in flags.items() if value]
    if on:
        raise NotImplementedError(
            f"render option(s) {', '.join(on)} not yet ported")


def default_intersect() -> IntersectFn:
    """The brute sweep: its CUDA kernel on CUDA tensors, its plain version
    on CPU tensors (ops/brute_intersect.py)."""
    from orion_tpu_torch.ops.brute_intersect import intersect_brute_kernel

    return intersect_brute_kernel


def _rand(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def _emissive_primary_term(scene: Scene, attrs, dirs, depth: int):
    """depth-0 emitter visibility: Ke * meshArea * dot(normalize(dir), -normal)
    (raytracer.cpp:127-128, kept verbatim including the mesh-area scaling)."""
    ke = shade.emissive_color(scene, attrs.mat_id, attrs.uv)
    area = scene.mesh_area[attrs.mesh_id]
    cosv = torch.sum(shade.normalize(dirs) * (-attrs.s_normal), dim=-1)
    term = ke * (area * cosv)[:, None]
    return term if depth == 0 else torch.zeros_like(term)


def _nee(scene: Scene, attrs, kd, hit_mask, generator, light_samples: int,
         intersect: IntersectFn):
    """Next-event estimation against every emissive mesh (raytracer.cpp:
    133-159): per emissive mesh, `light_samples` area samples; a sample
    contributes iff the shadow ray's *nearest* hit lands on that mesh;
    emitted color/normal are evaluated at the shadow-ray hit point. All
    E x S samples go through ONE stacked intersect."""
    N = attrs.point.shape[0]
    E = scene.num_emissive
    S = light_samples
    ES = E * S
    dev = attrs.point.device
    origin = attrs.point + BIAS * attrs.g_normal

    mesh_ids = [int(m) for m in scene.numpy("emissive_mesh_ids")[:E]]
    mesh_rep = [m for m in mesh_ids for _ in range(S)]

    u = _rand(generator, (ES, 3, N), dev)
    samples = [shade.sample_mesh_point(scene, mid, u[k, 0], u[k, 1], u[k, 2])
               for k, mid in enumerate(mesh_rep)]
    target_all = torch.cat([s[0] for s in samples], dim=0)   # [ES*N, 3]
    weight_all = torch.cat([s[1] for s in samples], dim=0)   # [ES*N]
    origin_all = origin.repeat(ES, 1)
    point_all = attrs.point.repeat(ES, 1)
    shadow_dir_all = target_all - point_all
    hit_all = hit_mask.repeat(ES)
    s_hit = intersect(scene, origin_all, shadow_dir_all, alive=hit_all)
    s_attrs = hit_attributes(scene, origin_all, shadow_dir_all, s_hit)

    mesh_of_sample = torch.tensor(mesh_rep, dtype=torch.int64,
                                  device=dev).repeat_interleave(N)
    visible = s_hit.mask & (s_attrs.mesh_id == mesh_of_sample) & hit_all
    ke = shade.emissive_color(scene, s_attrs.mat_id, s_attrs.uv)
    c = shade.brdf_eval(kd.repeat(ES, 1), attrs.s_normal.repeat(ES, 1),
                        point_all, target_all, ke, weight_all,
                        s_attrs.s_normal)
    c = torch.where(visible[:, None], c, torch.zeros_like(c))
    return torch.sum(c.reshape(ES, N, 3), dim=0) / float(S)


def _path_bounce(scene: Scene, carry, depth: int, generator,
                 light_samples: int, max_depth: int, intersect: IntersectFn,
                 reference_frame: bool):
    """One path-tracing wavefront step (raytracer.cpp:105-194, BRDF branch)."""
    orig, dirs, throughput, alive = carry
    hit = intersect(scene, orig, dirs, alive=alive)
    attrs = hit_attributes(scene, orig, dirs, hit)
    hit_mask = alive & hit.mask
    dev = orig.device

    radiance = torch.zeros_like(throughput)
    em = _emissive_primary_term(scene, attrs, dirs, depth)
    radiance = radiance + torch.where(hit_mask[:, None], em,
                                      torch.zeros_like(em))

    # one diffuse sample per bounce: NEE's BRDF term and Russian roulette
    # read the same surface Kd
    kd = shade.diffuse_color(scene, attrs.mat_id, attrs.uv)
    if scene.num_emissive > 0:
        radiance = radiance + _nee(scene, attrs, kd, hit_mask, generator,
                                   light_samples, intersect)
    radiance = radiance * throughput

    # Russian roulette continuation (raytracer.cpp:161-170)
    p_continue = torch.max(kd, dim=-1).values
    u_rr = _rand(generator, p_continue.shape, dev)
    continue_mask = hit_mask & (depth < max_depth) & (u_rr <= p_continue)
    # double-where so the dead branch contributes a finite gradient
    positive = p_continue > 0.0
    safe_p = torch.where(positive, p_continue, torch.ones_like(p_continue))
    rr_scale = torch.where(positive, 1.0 / safe_p,
                           torch.zeros_like(p_continue))

    # cosine-weighted bounce (raytracer.cpp:173-194)
    u = _rand(generator, (2,) + tuple(p_continue.shape), dev)
    new_dir = shade.cosine_sample(attrs.s_normal, u[0], u[1],
                                  reference_frame=reference_frame)
    new_orig = attrs.point + attrs.s_normal * BIAS

    new_throughput = throughput * kd * rr_scale[:, None]
    cm = continue_mask[:, None]
    new_throughput = torch.where(cm, new_throughput,
                                 torch.zeros_like(new_throughput))
    carry = (torch.where(cm, new_orig, orig), torch.where(cm, new_dir, dirs),
             new_throughput, continue_mask)
    return carry, radiance


def _whitted_bounce(scene: Scene, carry, depth: int, max_depth: int,
                    intersect: IntersectFn,
                    shadow_intersect: Optional[IntersectFn] = None,
                    prune_zero: bool = True):
    """One Whitted wavefront step (raytracer.cpp:195-207).

    prune_zero: retire rays whose reflected throughput is exactly zero
    (value-identical). Training passes False: at refl == 0 the pruned
    subpath still carries d(contribution)/d(refl)."""
    orig, dirs, throughput, alive = carry
    hit = intersect(scene, orig, dirs, alive=alive)
    attrs = hit_attributes(scene, orig, dirs, hit)
    hit_mask = alive & hit.mask

    radiance = torch.zeros_like(throughput)
    em = _emissive_primary_term(scene, attrs, dirs, depth)
    radiance = radiance + torch.where(hit_mask[:, None], em,
                                      torch.zeros_like(em))

    shadow_origin = attrs.point + BIAS * attrs.g_normal
    L = scene.num_lights
    N = attrs.point.shape[0]
    # material samples depend only on the hit point: sample once, tile
    ka = shade.ambient_color(scene, attrs.mat_id, attrs.uv)
    kd = shade.diffuse_color(scene, attrs.mat_id, attrs.uv)
    refl = shade.specular_color(scene, attrs.mat_id, attrs.uv)
    shin = take_rows(scene.mat_shininess, attrs.mat_id)
    if L > 0:
        lpos_all = scene.light_pos[:L].repeat_interleave(N, dim=0)
        point_all = attrs.point.repeat(L, 1)
        to_light_all = lpos_all - point_all
        s_fn = shadow_intersect if shadow_intersect is not None else intersect
        s_hit = s_fn(scene, shadow_origin.repeat(L, 1), to_light_all,
                     alive=hit_mask.repeat(L))
        # reference quirk kept: ANY intersection blocks, even geometry
        # beyond the light (raytracer.cpp:196-201); see PARITY.md
        lit = hit_mask.repeat(L) & ~s_hit.mask
        c = shade.phong_eval(ka.repeat(L, 1), kd.repeat(L, 1),
                             refl.repeat(L, 1), shin.repeat(L),
                             dirs.repeat(L, 1), attrs.s_normal.repeat(L, 1),
                             point_all, lpos_all,
                             scene.light_color[:L].repeat_interleave(N, dim=0),
                             scene.light_intensity[:L].repeat_interleave(N))
        c = torch.where(lit[:, None], c, torch.zeros_like(c))
        radiance = radiance + torch.sum(c.reshape(L, N, 3), dim=0)
    radiance = radiance * throughput

    # perfect mirror continuation scaled by the specular map
    continue_mask = hit_mask & (depth < max_depth)
    if prune_zero:
        continue_mask = continue_mask & torch.any(throughput * refl > 0.0,
                                                  dim=-1)
    cm = continue_mask[:, None]
    new_throughput = torch.where(cm, throughput * refl,
                                 torch.zeros_like(throughput))
    new_dir = shade.reflect(dirs, attrs.s_normal)
    new_orig = attrs.point + attrs.s_normal * BIAS
    carry = (torch.where(cm, new_orig, orig), torch.where(cm, new_dir, dirs),
             new_throughput, continue_mask)
    return carry, radiance


def trace_wavefront(scene: Scene, orig: torch.Tensor, dirs: torch.Tensor,
                    generator: torch.Generator, *, max_depth: int,
                    light_samples: int = 2, mode: Optional[str] = None,
                    intersect: Optional[IntersectFn] = None,
                    reference_frame: bool = False,
                    normal_maps: bool = False, sort_bounces=False,
                    shadow_intersect: Optional[IntersectFn] = None,
                    prune_zero: bool = True, remat=False) -> torch.Tensor:
    """Trace a batch of rays to completion; returns radiance [N, 3].

    mode: "path" | "whitted" | None (auto: whitted iff the scene has point
    lights, matching raytracer.cpp:131). normal_maps and remat are not
    ported yet and raise when set.

    sort_bounces: False | True | "octant" | "morton". After each bounce,
    reorder the wavefront so that neighbouring threads of the walk kernel
    trace coherent secondary rays; radiance is un-permuted at the end.
    "octant" (== True) keys on (dead-last, direction octant); "morton"
    additionally keys on the morton code of the ray origin inside the
    scene AABB (ops/reorder.py). Changes which uniforms each ray draws
    (still a valid, deterministic estimator; images differ from unsorted
    at the noise level). Off by default.
    """
    _not_ported(normal_maps=normal_maps, remat=remat)
    if sort_bounces not in (False, True, "octant", "morton"):
        raise ValueError(f"unknown sort_bounces {sort_bounces!r}")
    if mode is None:
        mode = "whitted" if scene.num_lights > 0 else "path"
    if mode not in ("path", "whitted"):
        raise ValueError(f"unknown mode {mode!r}")
    if intersect is None:
        intersect = default_intersect()
    N = orig.shape[0]
    carry = (orig, dirs,
             torch.ones((N, 3), dtype=torch.float32, device=orig.device),
             torch.ones((N,), dtype=torch.bool, device=orig.device))
    total = torch.zeros((N, 3), dtype=torch.float32, device=orig.device)

    if sort_bounces == "morton":
        from orion_tpu_torch.ops.reorder import coherence_key, scene_bounds

        s_lo, s_hi = scene_bounds(scene)

        def sort_key(orig, dirs, alive):
            return coherence_key(orig, dirs, alive, s_lo, s_hi)
    elif sort_bounces:
        from orion_tpu_torch.ops.reorder import direction_octant

        def sort_key(orig, dirs, alive):
            octant = direction_octant(dirs)
            return torch.where(alive, octant, torch.full_like(octant, 8))

    pix = torch.arange(N, device=orig.device)
    for depth in range(max_depth + 1):
        if mode == "path":
            carry, radiance = _path_bounce(scene, carry, depth, generator,
                                           light_samples, max_depth,
                                           intersect, reference_frame)
        else:
            carry, radiance = _whitted_bounce(scene, carry, depth, max_depth,
                                              intersect, shadow_intersect,
                                              prune_zero)
        total = total + radiance
        if sort_bounces:
            perm = torch.argsort(sort_key(carry[0].detach(),
                                          carry[1].detach(), carry[3]),
                                 stable=True)
            carry = tuple(a[perm] for a in carry)
            pix, total = pix[perm], total[perm]
    if not sort_bounces:
        return total
    return torch.zeros_like(total).index_copy(0, pix, total)


def render(scene: Scene, camera: Camera, generator: torch.Generator, *,
           samples: int = 1, max_depth: int = 1, light_samples: int = 2,
           mode: Optional[str] = None,
           intersect: Optional[IntersectFn] = None,
           reference_frame: bool = False, shared_jitter: bool = True,
           normal_maps: bool = False, sort_bounces=False,
           shadow_intersect: Optional[IntersectFn] = None,
           prune_zero: bool = True, remat=False,
           fold_samples: bool = False) -> torch.Tensor:
    """Render an [H, W, 3] image with `samples` jittered samples per pixel.

    shared_jitter=True replicates the reference's shared sub-pixel pattern
    (one jitter offset per sample index, used by every pixel,
    raytracer.cpp:53-63); False gives every pixel its own jitter.
    `generator` must live on the camera's device.
    """
    _not_ported(normal_maps=normal_maps, remat=remat,
                fold_samples=fold_samples)
    H, W = camera.yres, camera.xres
    dev = camera.device
    px = 2.0 / W
    py = 2.0 / H
    acc = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    for _ in range(samples):
        jit = _rand(generator, (2,) if shared_jitter else (2, H, W), dev)
        orig, dirs = primary_rays(camera, jit[0] * px, jit[1] * py)
        radiance = trace_wavefront(scene, orig, dirs, generator,
                                   max_depth=max_depth,
                                   light_samples=light_samples, mode=mode,
                                   intersect=intersect,
                                   reference_frame=reference_frame,
                                   sort_bounces=sort_bounces,
                                   shadow_intersect=shadow_intersect,
                                   prune_zero=prune_zero)
        acc = acc + radiance.reshape(H, W, 3)
    return acc / float(samples)
