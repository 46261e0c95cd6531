"""The megakernels on pixel tiles: one launch a rank, one collective.

The PyTorch counterpart of `orion_tpu.parallel.fused_shard`. Each rank of
a parallel.sharding.Mesh launches its route's kernels on its tile of
pixels [lo, hi) (Mesh.tile), with the scene's tables on its device, and
one all-gather assembles the image. The kernels' PCG4D streams hash the
GLOBAL pixel id (csrc/render_lane.cuh, csrc/whitted_common.cuh), so a
tile launched at pix_base renders exactly the whole image's rows: the
sharded image is the single-device image, bit for bit, at any world
size, with no change to the estimator.

    make_fused_render_sharded   kernel 1 (ops/fused_path.py)
    make_bvh_render_sharded     kernel 8 (mode "path") or 7a ("whitted")
    make_bounce_render_sharded  the bounce pipeline, 6a / 6c (6b under
                                split_vis), on the tile's own wavefront
    make_bounce_train_step_sharded  the same pipeline and its closed-form
                                adjoints; ONE all-reduce of (sse, acc, ek)
    make_fused_train_step_sharded   kernels 3a and 3b on the tile; ONE
                                all-reduce of (sse, the replay's [6,
                                M_LANES] rows)

A train step normalises each tile's error by the whole image's H W 3, so
the all-reduced sums are the whole image's loss and gradients.
"""

from __future__ import annotations

import torch

from orion_tpu_torch.accel.bvh import SAH
from orion_tpu_torch.ops.fused_path import (fused_args, fused_path,
                                            fused_path_supported)
from orion_tpu_torch.ops.prb import (M_LANES, PRBPlan, fused_fwd_ls,
                                     fused_train_supported, prb_replay)
from orion_tpu_torch.parallel.distributed import (all_gather_rows,
                                                  all_reduce_sum)
from orion_tpu_torch.parallel.sharding import (Mesh, check_placement,
                                               make_mesh)
from orion_tpu_torch.scene import Scene


def _setup(name: str, scene: Scene, camera, mesh):
    mesh = make_mesh() if mesh is None else mesh
    check_placement(name, mesh, scene)
    H, W = camera.yres, camera.xres
    lo, hi = mesh.tile(H * W)
    return mesh, H, W, lo, hi


def make_fused_render_sharded(scene: Scene, camera, *, samples: int,
                              max_depth: int, light_samples: int = 2,
                              mesh: Mesh | None = None):
    """`fn(seed: int) -> [H, W, 3]`: kernel 1 on this rank's tile, then
    one all-gather. Bit-identical to make_fused_path_renderer's image."""
    if not fused_path_supported(scene):
        raise ValueError("scene outside the fused-path gate")
    mesh, H, W, lo, hi = _setup("make_fused_render_sharded", scene, camera,
                                mesh)
    args = fused_args(scene, camera)

    def render_sharded(seed: int) -> torch.Tensor:
        tile = fused_path(*args, seed, W, H, samples, max_depth,
                          light_samples, pix_base=lo, n_lanes=hi - lo)
        return all_gather_rows(tile, H * W, mesh).reshape(H, W, 3)

    return render_sharded


def make_bvh_render_sharded(scene: Scene, camera, *, samples: int,
                            max_depth: int, light_samples: int = 2,
                            mode: str | None = None, strategy: str = SAH,
                            order_signs=(1.0, 1.0, 1.0),
                            mesh: Mesh | None = None):
    """`fn(seed: int) -> [H, W, 3]`: one BVH megakernel launch on this
    rank's tile (kernel 8 for mode "path", 7a for "whitted"; default:
    Whitted iff the scene has point lights), then one all-gather. The
    tree and its table replicate on every rank."""
    from orion_tpu_torch.ops.bvh_path import make_bvh_path_renderer
    from orion_tpu_torch.ops.bvh_whitted import make_bvh_whitted_renderer

    if mode is None:
        mode = "whitted" if scene.num_lights > 0 else "path"
    mesh, H, W, lo, hi = _setup("make_bvh_render_sharded", scene, camera,
                                mesh)
    if mode == "path":
        fn = make_bvh_path_renderer(scene, camera, samples=samples,
                                    max_depth=max_depth,
                                    light_samples=light_samples,
                                    strategy=strategy,
                                    order_signs=order_signs)
    elif mode == "whitted":
        fn = make_bvh_whitted_renderer(scene, camera, samples=samples,
                                       max_depth=max_depth,
                                       strategy=strategy,
                                       order_signs=order_signs)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    def render_sharded(seed: int) -> torch.Tensor:
        tile = fn(seed, pix_base=lo, n_lanes=hi - lo)
        return all_gather_rows(tile, H * W, mesh).reshape(H, W, 3)

    return render_sharded


def make_bounce_render_sharded(scene: Scene, camera, *, samples: int,
                               max_depth: int, light_samples: int = 2,
                               sort: bool = True, mesh: Mesh | None = None):
    """`fn(seed: int) -> [H, W, 3]`: the sorted-wavefront bounce pipeline
    (ops/bounce.py) over this rank's tile: its own wavefront, sorts and
    kernels end to end, then one all-gather. Per-ray streams hash global
    pixel ids and each pixel's samples stay on one rank in sample order,
    so the image is the single-device pipeline's rows."""
    from orion_tpu_torch.ops.bounce import build_forward_pipeline, state_image

    mesh, H, W, lo, hi = _setup("make_bounce_render_sharded", scene, camera,
                                mesh)
    pipeline, _ = build_forward_pipeline(
        scene, camera, samples=samples, max_depth=max_depth,
        light_samples=light_samples, sort=sort, pix_count=hi - lo)

    def render_sharded(seed: int) -> torch.Tensor:
        with torch.no_grad():
            st, _ = pipeline(seed, pix_base=lo)
            tile = state_image(st, hi - lo, samples, lo)
        return all_gather_rows(tile, H * W, mesh).reshape(H, W, 3)

    return render_sharded


def make_bounce_train_step_sharded(scene: Scene, camera, target, *,
                                   samples: int, max_depth: int,
                                   light_samples: int = 2, sort: bool = True,
                                   mesh: Mesh | None = None):
    """`step(seed: int) -> (loss, grads)`: the closed-form bounce trainer
    (ops/bounce_prb.py) on this rank's tile and its tile of `target`; the
    one collective is an all-reduce of (sse, the [M_LANES, 8] material
    accumulator, the emitter's ke triple) in one buffer. grads holds
    mat_diffuse and mat_emissive, as make_bounce_train_step's."""
    from orion_tpu_torch.ops.bounce_prb import make_bounce_train_core

    mesh, H, W, lo, hi = _setup("make_bounce_train_step_sharded", scene,
                                camera, mesh)
    core, ctx = make_bounce_train_core(
        scene, camera, samples=samples, max_depth=max_depth,
        light_samples=light_samples, sort=sort, pix_count=hi - lo)
    M = int(scene.num_meshes)
    em_mesh = ctx["em_mesh"]
    tab0 = ctx["data"].tab
    tgt = torch.as_tensor(target, dtype=torch.float32,
                          device=scene.device).reshape(H * W, 3)[lo:hi]

    def step(seed: int):
        sse, acc, ek = core(int(seed), tab0, lo, tgt)
        buf = all_reduce_sum(torch.cat([sse.reshape(1), acc.reshape(-1),
                                        ek]), mesh)
        acc = buf[1:1 + M_LANES * 8].reshape(M_LANES, 8)
        g_ke = acc[:M, 3:6].clone()
        g_ke[em_mesh] += buf[1 + M_LANES * 8:]
        return buf[0] / float(H * W * 3), {"mat_diffuse": acc[:M, 0:3],
                                           "mat_emissive": g_ke}

    return step


def make_fused_train_step_sharded(scene: Scene, camera, target, *,
                                  samples: int, max_depth: int,
                                  light_samples: int = 2,
                                  mesh: Mesh | None = None):
    """`step(params, seed: int) -> (loss, grads)`: kernels 3a and 3b on
    this rank's tile (the training forward with the tile's L_s planes,
    then the replay of the tile's adjoints), then ONE all-reduce of the
    tile's squared error and the replay's [6, M_LANES] rows. params: any
    subset of {mat_diffuse, mat_emissive}; grads holds the same keys."""
    if not fused_train_supported(scene, samples):
        raise ValueError("scene outside the fused-train gate")
    mesh, H, W, lo, hi = _setup("make_fused_train_step_sharded", scene,
                                camera, mesh)
    plan = PRBPlan.build(scene, camera, samples=samples, max_depth=max_depth,
                         light_samples=light_samples)
    M = int(scene.num_meshes)
    n = hi - lo
    tgt = torch.as_tensor(target, dtype=torch.float32,
                          device=scene.device).reshape(H * W, 3)[lo:hi]
    geo = (plan.clo, plan.chi, plan.em, plan.cam)
    cfg = (W, H, samples, max_depth, light_samples)

    def step(params, seed: int):
        bad = set(params) - {"mat_diffuse", "mat_emissive"}
        if bad:
            raise ValueError(f"PRB differentiates material tables only; "
                             f"got {sorted(bad)}")
        with torch.no_grad():
            tab = plan.table(params.get("mat_diffuse"),
                             params.get("mat_emissive"))
            img, ls = fused_fwd_ls(tab, *geo, int(seed), *cfg, pix_base=lo,
                                   n_lanes=n)
            diff = img - tgt
            # lanes sum their samples; the image is the mean
            w = (diff * (2.0 / (H * W * 3 * samples))).contiguous()
            acc = prb_replay(tab, *geo, int(seed), w, ls, *cfg, pix_base=lo,
                             n_lanes=n, em_mesh=plan.em_mesh)
            buf = all_reduce_sum(torch.cat([torch.sum(diff * diff)
                                            .reshape(1), acc.reshape(-1)]),
                                 mesh)
        acc = buf[1:].reshape(6, M_LANES)
        g = {"mat_diffuse": acc[0:3, :M].t(), "mat_emissive": acc[3:6, :M].t()}
        return buf[0] / float(H * W * 3), {k: g[k] for k in params}

    return step
