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
agree statistically, not bitwise). A path bounce draws its uniforms before
it shades (`_path_draws`), so that a checkpointed bounce (remat) replays
the very same numbers in the backward pass.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from orion_tpu_torch.camera import Camera, primary_rays
from orion_tpu_torch.ops import shade
from orion_tpu_torch.ops.intersect import (Hit, hit_attributes, take_rows,
                                           tangent_frame)
from orion_tpu_torch.scene import Scene

# bias to move rays off surfaces (raytracer.cpp:118)
BIAS = 1e-3

# IntersectFn protocol: (scene, orig [N,3], dirs [N,3], *, alive=None) -> Hit
IntersectFn = Callable[..., Hit]


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


def _nee(scene: Scene, attrs, kd, hit_mask, u: torch.Tensor,
         light_samples: int, intersect: IntersectFn):
    """Next-event estimation against every emissive mesh (raytracer.cpp:
    133-159): per emissive mesh, `light_samples` area samples drawn from
    the uniforms `u` [E*S, 3, N]; a sample contributes iff the shadow
    ray's *nearest* hit lands on that mesh; emitted color/normal are
    evaluated at the shadow-ray hit point. All E x S samples go through
    ONE stacked intersect."""
    N = attrs.point.shape[0]
    E = scene.num_emissive
    S = light_samples
    ES = E * S
    dev = attrs.point.device
    origin = attrs.point + BIAS * attrs.g_normal

    mesh_ids = [int(m) for m in scene.numpy("emissive_mesh_ids")[:E]]
    mesh_rep = [m for m in mesh_ids for _ in range(S)]

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


def _apply_normal_maps(scene: Scene, attrs, hit: Hit):
    """Opt-in tangent-space normal mapping (PARITY.md: the reference ships
    it disabled; render(..., normal_maps=True) enables it here)."""
    tangent, bitangent = tangent_frame(scene, hit)
    s_n = shade.perturb_normal(scene, attrs.mat_id, attrs.uv,
                               attrs.s_normal, tangent, bitangent)
    return dataclasses.replace(attrs, s_normal=s_n)


def _path_draws(scene: Scene, generator, light_samples: int, n: int, dev,
                tile=None):
    """One path bounce's uniforms, in the order it reads them: NEE's
    [E*S, 3, n] (None without emitters), Russian roulette's [n], the
    cosine bounce's [2, n]. tile=(lo, n_total): the n rays are rays
    [lo, lo + n) of a wavefront of n_total; the draws are the whole
    wavefront's, and the tile keeps its slice of each."""
    lo, width = (0, n) if tile is None else tile
    u_nee = (_rand(generator, (scene.num_emissive * light_samples, 3, width),
                   dev) if scene.num_emissive > 0 else None)
    draws = (u_nee, _rand(generator, (width,), dev),
             _rand(generator, (2, width), dev))
    if tile is None:
        return draws
    return tuple(None if u is None else u[..., lo:lo + n] for u in draws)


def _path_bounce(scene: Scene, carry, hit: Hit, depth: int, draws,
                 light_samples: int, max_depth: int, intersect: IntersectFn,
                 reference_frame: bool, normal_maps: bool = False):
    """One path-tracing wavefront step (raytracer.cpp:105-194, BRDF
    branch) at the carry's hits `hit`, with the uniforms `draws` of
    `_path_draws`; `intersect` traces the NEE shadow rays."""
    orig, dirs, throughput, alive = carry
    u_nee, u_rr, u = draws
    attrs = hit_attributes(scene, orig, dirs, hit)
    if normal_maps:
        attrs = _apply_normal_maps(scene, attrs, hit)
    hit_mask = alive & hit.mask

    radiance = torch.zeros_like(throughput)
    em = _emissive_primary_term(scene, attrs, dirs, depth)
    radiance = radiance + torch.where(hit_mask[:, None], em,
                                      torch.zeros_like(em))

    # one diffuse sample per bounce: NEE's BRDF term and Russian roulette
    # read the same surface Kd
    kd = shade.diffuse_color(scene, attrs.mat_id, attrs.uv)
    if u_nee is not None:
        radiance = radiance + _nee(scene, attrs, kd, hit_mask, u_nee,
                                   light_samples, intersect)
    radiance = radiance * throughput

    # Russian roulette continuation (raytracer.cpp:161-170)
    p_continue = torch.max(kd, dim=-1).values
    continue_mask = hit_mask & (depth < max_depth) & (u_rr <= p_continue)
    # double-where so the dead branch contributes a finite gradient
    positive = p_continue > 0.0
    safe_p = torch.where(positive, p_continue, torch.ones_like(p_continue))
    rr_scale = torch.where(positive, 1.0 / safe_p,
                           torch.zeros_like(p_continue))

    # cosine-weighted bounce (raytracer.cpp:173-194)
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


def _whitted_bounce(scene: Scene, carry, hit: Hit, depth: int,
                    max_depth: int, intersect: IntersectFn,
                    normal_maps: bool = False,
                    shadow_intersect: Optional[IntersectFn] = None,
                    prune_zero: bool = True):
    """One Whitted wavefront step (raytracer.cpp:195-207) at the carry's
    hits `hit`; `shadow_intersect` (else `intersect`) traces the shadow
    rays.

    prune_zero: retire rays whose reflected throughput is exactly zero
    (value-identical). Training passes False: at refl == 0 the pruned
    subpath still carries d(contribution)/d(refl)."""
    orig, dirs, throughput, alive = carry
    attrs = hit_attributes(scene, orig, dirs, hit)
    if normal_maps:
        attrs = _apply_normal_maps(scene, attrs, hit)
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


class _HitTape:
    """The intersects of one checkpointed bounce: its first run records
    each Hit in call order, and a rerun (the recompute of the backward
    pass) gets them back in that order, so no intersect kernel runs
    twice."""

    def __init__(self):
        self.hits = []
        self.pos = 0

    def wrap(self, fn: Optional[IntersectFn]) -> Optional[IntersectFn]:
        if fn is None:
            return None

        def taped(scene, orig, dirs, *, alive=None) -> Hit:
            if self.pos == len(self.hits):
                self.hits.append(fn(scene, orig, dirs, alive=alive))
            self.pos += 1
            return self.hits[self.pos - 1]

        return taped


def trace_wavefront(scene: Scene, orig: torch.Tensor, dirs: torch.Tensor,
                    generator: torch.Generator, *, max_depth: int,
                    light_samples: int = 2, mode: Optional[str] = None,
                    intersect: Optional[IntersectFn] = None,
                    reference_frame: bool = False,
                    normal_maps: bool = False, sort_bounces=False,
                    shadow_intersect: Optional[IntersectFn] = None,
                    prune_zero: bool = True, remat=False,
                    tile=None) -> torch.Tensor:
    """Trace a batch of rays to completion; returns radiance [N, 3].

    mode: "path" | "whitted" | None (auto: whitted iff the scene has point
    lights, matching raytracer.cpp:131). normal_maps enables tangent-space
    bump mapping (off by default, PARITY.md).

    remat: False | True | "hits". Either true value checkpoints each
    bounce's shading (`torch.utils.checkpoint`): the backward pass
    recomputes a bounce's intermediates from its carry instead of keeping
    dozens of [N, 3] tensors per bounce. The bounce's nearest-hit
    intersect runs before the checkpointed region and its (detached) Hit
    is passed in; its shadow intersects are recorded on their first run
    and handed back to the recompute (`_HitTape`). So the backward pass
    launches no intersect for either value: "hits" means what it means in
    the JAX package (the hit records are kept, shading is recomputed),
    and True, which there re-runs the intersects, re-runs only shading
    here. Values and gradients equal remat=False's.

    sort_bounces: False | True | "octant" | "morton". After each bounce,
    reorder the wavefront so that neighbouring threads of the walk kernel
    trace coherent secondary rays; radiance is un-permuted at the end.
    "octant" (== True) keys on (dead-last, direction octant); "morton"
    additionally keys on the morton code of the ray origin inside the
    scene AABB (ops/reorder.py). Changes which uniforms each ray draws
    (still a valid, deterministic estimator; images differ from unsorted
    at the noise level). Off by default.

    tile=(lo, n_total): the N rays are rays [lo, lo + N) of a wavefront of
    n_total rays, and every bounce draws the whole wavefront's uniforms
    and keeps its slice (`_path_draws`), so each ray draws what it draws
    in the whole wavefront: a tile's radiance is the whole trace's rows,
    bit for bit (parallel/sharding.render_sharded). Not with sort_bounces,
    which hands the draws to other rays.
    """
    if sort_bounces not in (False, True, "octant", "morton"):
        raise ValueError(f"unknown sort_bounces {sort_bounces!r}")
    if tile is not None and sort_bounces:
        raise ValueError("a tile keeps the whole wavefront's draws per ray; "
                         "sort_bounces reorders the rays")
    if remat not in (False, True, "hits"):
        raise ValueError(f"unknown remat {remat!r}")
    if mode is None:
        mode = "whitted" if scene.num_lights > 0 else "path"
    if mode not in ("path", "whitted"):
        raise ValueError(f"unknown mode {mode!r}")
    if intersect is None:
        intersect = default_intersect()
    N = orig.shape[0]
    dev = orig.device
    carry = (orig, dirs,
             torch.ones((N, 3), dtype=torch.float32, device=dev),
             torch.ones((N,), dtype=torch.bool, device=dev))
    total = torch.zeros((N, 3), dtype=torch.float32, device=dev)

    def bounce(carry, hit, depth, draws, s_fn, s_shadow):
        if mode == "path":
            return _path_bounce(scene, carry, hit, depth, draws,
                                light_samples, max_depth, s_fn,
                                reference_frame, normal_maps)
        return _whitted_bounce(scene, carry, hit, depth, max_depth, s_fn,
                               normal_maps, s_shadow, prune_zero)

    def checkpointed(carry, hit, depth, draws):
        tape = _HitTape()
        s_fn, s_shadow = tape.wrap(intersect), tape.wrap(shadow_intersect)

        def run(carry, hit, draws):
            tape.pos = 0
            return bounce(carry, hit, depth, draws, s_fn, s_shadow)

        # nothing inside draws a random number: the uniforms come in
        return checkpoint(run, carry, hit, draws, use_reentrant=False,
                          preserve_rng_state=False)

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

    pix = torch.arange(N, device=dev)
    for depth in range(max_depth + 1):
        hit = intersect(scene, carry[0], carry[1], alive=carry[3])
        draws = (_path_draws(scene, generator, light_samples, N, dev, tile)
                 if mode == "path" else None)
        if remat:
            carry, radiance = checkpointed(carry, hit, depth, draws)
        else:
            carry, radiance = bounce(carry, hit, depth, draws, intersect,
                                     shadow_intersect)
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


def skip_samples(scene: Scene, generator: torch.Generator, k: int, H: int,
                 W: int, dev, *, max_depth: int, light_samples: int,
                 mode: Optional[str], shared_jitter: bool = True) -> None:
    """Advance `generator` past k samples of render's per-sample loop over
    an H x W image: each sample's jitter, then for each of the
    max_depth + 1 bounces of a path trace `_path_draws`' three tensors (a
    Whitted trace draws none), in those shapes and that order, dropped.
    trace_wavefront draws them whatever the rays hit (every ray's, live or
    retired, every bounce), so the count depends on no data."""
    if mode is None:
        mode = "whitted" if scene.num_lights > 0 else "path"
    for _ in range(k):
        _rand(generator, (2,) if shared_jitter else (2, H, W), dev)
        if mode == "path":
            for _ in range(max_depth + 1):
                _path_draws(scene, generator, light_samples, H * W, dev)


def render(scene: Scene, camera: Camera, generator: torch.Generator, *,
           samples: int = 1, max_depth: int = 1, light_samples: int = 2,
           mode: Optional[str] = None,
           intersect: Optional[IntersectFn] = None,
           reference_frame: bool = False, shared_jitter: bool = True,
           normal_maps: bool = False, sort_bounces=False,
           shadow_intersect: Optional[IntersectFn] = None,
           prune_zero: bool = True, remat=False,
           fold_samples: bool = False,
           sample_offset: int = 0) -> torch.Tensor:
    """Render an [H, W, 3] image with `samples` jittered samples per pixel.

    shared_jitter=True replicates the reference's shared sub-pixel pattern
    (one jitter offset per sample index, used by every pixel,
    raytracer.cpp:53-63); False gives every pixel its own jitter.
    `generator` must live on the camera's device. The samples draw from
    it one after another, so two calls of n and m samples continue the
    stream of one call of n + m (io/checkpoint.py).

    fold_samples=True traces all `samples` as ONE [S*H*W] wavefront: the
    S jitters first, then one trace_wavefront, then the mean over S.
    S x the rays of each intersect launch, which fills the card at small
    resolutions. The same estimator from another order of the uniforms,
    so images differ from the per-sample loop's at the noise level.
    normal_maps and remat are trace_wavefront's.

    sample_offset=k renders the samples k .. k + samples - 1 of the
    stream `generator` starts: `render(samples=m, sample_offset=k)` is
    those m samples of `render(samples=k + m)` with the same generator
    state (parallel/distributed.render_multihost splits samples so). The
    generator first draws the uniforms of k samples and drops them
    (`skip_samples`). Not with fold_samples, which draws all samples'
    jitters first.
    """
    H, W = camera.yres, camera.xres
    dev = camera.device
    px = 2.0 / W
    py = 2.0 / H
    if sample_offset < 0:
        raise ValueError(f"sample_offset {sample_offset} < 0")
    if fold_samples and sample_offset:
        raise ValueError("fold_samples draws every sample's jitter first; "
                         "sample_offset skips whole samples of the "
                         "per-sample loop")
    skip_samples(scene, generator, sample_offset, H, W, dev,
                 max_depth=max_depth, light_samples=light_samples, mode=mode,
                 shared_jitter=shared_jitter)
    trace = dict(max_depth=max_depth, light_samples=light_samples,
                 mode=mode, intersect=intersect,
                 reference_frame=reference_frame, normal_maps=normal_maps,
                 sort_bounces=sort_bounces,
                 shadow_intersect=shadow_intersect, prune_zero=prune_zero,
                 remat=remat)
    if fold_samples:
        jit = _rand(generator, (samples, 2) if shared_jitter
                    else (samples, 2, H, W), dev)
        rays = [primary_rays(camera, j[0] * px, j[1] * py) for j in jit]
        radiance = trace_wavefront(scene, torch.cat([r[0] for r in rays]),
                                   torch.cat([r[1] for r in rays]),
                                   generator, **trace)
        return torch.mean(radiance.reshape(samples, H, W, 3), dim=0)
    acc = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    for _ in range(samples):
        jit = _rand(generator, (2,) if shared_jitter else (2, H, W), dev)
        orig, dirs = primary_rays(camera, jit[0] * px, jit[1] * py)
        radiance = trace_wavefront(scene, orig, dirs, generator, **trace)
        acc = acc + radiance.reshape(H, W, 3)
    return acc / float(samples)
