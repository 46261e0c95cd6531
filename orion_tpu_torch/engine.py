"""Engine: scene preparation, backend selection, render statistics.

The PyTorch counterpart of `orion_tpu.engine` (RayTracer::traceRTC's
setup, raytracer.cpp:19-103): parse the .rtc, load and flatten the scene
onto the device, validate it, build the acceleration structure and pick
the wavefront's intersection backend.

Backend selection:
  - small scenes (<= BRUTE_MAX_TRIS triangles): the brute sweep, its CUDA
    kernel on a CUDA scene ("brute-kernel"). For a 36-triangle Cornell box
    a BVH walk costs more than testing everything.
  - large scenes: a flattened BVH. On a CUDA scene the walk kernel, one
    thread per ray, over leaves of GPU_LEAF_SIZE triangles
    ("bvh-kernel"); on a CPU scene the batched PyTorch walk
    ("bvh-torch"). A CUDA scene never takes "bvh-torch" unless `force`
    names it.

  - past RESIDENT_MAX_BUNDLED bundled rows: spatial treelets
    ("bvh-kernel-treelet", `_make_treelet_intersect`), each its own tree
    and its own walk-kernel closures, visited in turn. The JAX package's
    cap is its kernel's on-chip residency; the card holds any tree in
    device memory, and the port's cap is the walk kernel's int32 indexing
    of the row table instead. No scene the port renders comes near it.

The megakernel routes (make_megakernel_renderer: the fused path kernel,
make_big_path_renderer for path scenes past the fused gate,
make_whitted_megakernel for point-light scenes) do not use this
selection; render_wavefront renders over it.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from orion_tpu_torch.accel.bvh import (DEFAULT_LEAF, SAH, BVH, BuildStats,
                                       build_scene_bvh)
from orion_tpu_torch.camera import Camera, camera_from_rtc
from orion_tpu_torch.io.rtc import RTCData
from orion_tpu_torch.profiling import span
from orion_tpu_torch.render import IntersectFn
from orion_tpu_torch.scene import Scene, load_scene

BRUTE_MAX_TRIS = 1024
# leaf size of the trees built for the walk kernel: a thread tests a
# leaf's rows one after another, so small leaves suit it (PERF.md has the
# measurement; the JAX package builds 128-wide leaves for its lane width)
GPU_LEAF_SIZE = 2
# the most bundled rows one tree of the walk kernel (kernel 5) may hold:
# csrc/bvh_intersect.cu indexes the [B_pad, 16] float32 row table with an
# int row k and reads row k at float4 index 4 k, i.e. float offset 16 k;
# every float offset of the table fits int32 while B_pad * 16 <= 2^31, so
# B_pad <= 2^31 / 16 = 2^27 rows. Past it select_intersect splits the
# scene into treelets.
RESIDENT_MAX_BUNDLED = 2 ** 31 // 16
# partition headroom: bundled rows exceed the triangle count by the leaves'
# padding; a part that still overflows is split again
TREELET_MARGIN = 1.8


@dataclasses.dataclass
class PreparedScene:
    """A scene plus everything needed to render it."""

    scene: Scene
    rtc: RTCData
    camera: Camera
    intersect: IntersectFn
    backend: str                       # "brute-kernel" | "bvh-kernel" | ...
    bvh: Optional[BVH] = None
    bvh_stats: Optional[BuildStats] = None
    build_seconds: float = 0.0
    # occlusion-only (any-hit) intersect for Whitted shadow rays, where
    # only hit.mask is read; None => reuse `intersect` (as on brute)
    shadow_intersect: Optional[IntersectFn] = None
    # how the backend was chosen (for refresh_octant_order rebuilds)
    strategy: str = SAH
    force_backend: Optional[str] = None
    order_signs: tuple = (1.0, 1.0, 1.0)


_FORCE = (None, "brute", "bvh", "bvh-kernel", "bvh-torch")


def select_intersect(scene: Scene, *, strategy: str = SAH,
                     force: Optional[str] = None,
                     order_signs=(1.0, 1.0, 1.0)):
    """Choose (intersect_fn, backend_name, bvh, stats) for a scene.

    force: "brute" | "bvh" overrides the size heuristic; "bvh-kernel" and
    "bvh-torch" also pin the implementation (the walk kernel needs a CUDA
    scene, except that on a CPU scene it runs as its plain version, like
    every kernel wrapper). A walk-kernel tree of more than
    RESIDENT_MAX_BUNDLED rows becomes treelets: ("bvh-kernel-treelet",
    bvh None).
    """
    if force not in _FORCE:
        raise ValueError(f"unknown intersection backend {force!r}")
    want_bvh = (scene.num_triangles > BRUTE_MAX_TRIS
                if force is None else force != "brute")
    if not want_bvh:
        from orion_tpu_torch.ops.brute_intersect import intersect_brute_kernel

        return intersect_brute_kernel, "brute-kernel", None, None

    on_card = scene.device.type == "cuda"
    use_kernel = on_card if force in (None, "bvh") else force == "bvh-kernel"
    if use_kernel:
        from orion_tpu_torch.ops.bvh_intersect import make_bvh_intersect_kernel

        bvh, stats = build_scene_bvh(scene, strategy=strategy,
                                     leaf_size=GPU_LEAF_SIZE,
                                     order_signs=order_signs)
        if bvh.num_bundled > RESIDENT_MAX_BUNDLED:
            fn, stats = _make_treelet_intersect(scene, strategy, order_signs)
            return fn, "bvh-kernel-treelet", None, stats
        return (make_bvh_intersect_kernel(bvh, scene), "bvh-kernel", bvh,
                stats)
    bvh, stats = build_scene_bvh(scene, strategy=strategy,
                                 leaf_size=DEFAULT_LEAF,
                                 order_signs=order_signs)
    from orion_tpu_torch.ops.bvh_traverse import make_bvh_intersect

    return make_bvh_intersect(bvh), "bvh-torch", bvh, stats


def _make_treelet_intersect(scene: Scene, strategy: str, order_signs):
    """(intersect, BuildStats) of a scene cut into spatial treelets.

    The slabs of accel/bvh.partition_triangles (at most
    RESIDENT_MAX_BUNDLED / TREELET_MARGIN triangles each) get their own
    tree at the walk kernel's leaf size, their own device layout and their
    own nearest and any-hit walk-kernel closures; a part whose bundled rows
    still exceed the cap is split again. The intersect walks the parts in
    turn and keeps a hit only where its t is strictly less than the best
    so far, so the earlier part wins a tie. Its `any_hit_variant` chains
    the any-hit walks and narrows `alive` between parts: a ray occluded by
    part k walks no later part. `num_treelets` counts the parts."""
    from orion_tpu_torch.accel.bvh import build_bvh, partition_triangles
    from orion_tpu_torch.ops.bvh_intersect import (_bvh_device_layout,
                                                   make_bvh_intersect_kernel)
    from orion_tpu_torch.ops.intersect import Hit

    v0, e1, e2 = (scene.numpy(f) for f in ("tri_v0", "tri_e1", "tri_e2"))
    valid = scene.numpy("tri_valid")
    queue = partition_triangles(v0, e1, e2, valid,
                                int(RESIDENT_MAX_BUNDLED / TREELET_MARGIN))
    closers, shadow_closers = [], []
    total = BuildStats()
    while queue:
        mask = queue.pop(0)
        bvh, st = build_bvh(v0, e1, e2, mask, strategy=strategy,
                            leaf_size=GPU_LEAF_SIZE, order_signs=order_signs)
        if bvh.num_bundled > RESIDENT_MAX_BUNDLED:
            queue.extend(partition_triangles(v0, e1, e2, mask,
                                             int(mask.sum()) // 2 + 1))
            continue
        layout = _bvh_device_layout(bvh, scene.device)
        closers.append(make_bvh_intersect_kernel(bvh, scene, layout=layout))
        shadow_closers.append(make_bvh_intersect_kernel(
            bvh, scene, any_hit=True, layout=layout))
        total.nodes += st.nodes
        total.leaves += st.leaves
        total.max_depth = max(total.max_depth, st.max_depth)
        total.padded_tris += st.padded_tris

    def intersect(scene, orig, dirs, *, alive=None) -> Hit:
        n, dev = orig.shape[0], orig.device
        t = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
        tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
        for fn in closers:
            h = fn(scene, orig, dirs, alive=alive)
            better = h.t < t
            t = torch.where(better, h.t, t)
            tri = torch.where(better, h.tri_id, tri)
        return Hit(t=t, tri_id=tri)

    def any_hit_intersect(scene, orig, dirs, *, alive=None) -> Hit:
        n, dev = orig.shape[0], orig.device
        occluded = torch.zeros((n,), dtype=torch.bool, device=dev)
        tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
        live = (torch.ones((n,), dtype=torch.bool, device=dev)
                if alive is None else alive.to(torch.bool))
        for fn in shadow_closers:
            h = fn(scene, orig, dirs, alive=live & ~occluded)
            new = h.mask & ~occluded
            tri = torch.where(new, h.tri_id, tri)
            occluded = occluded | (h.mask & live)
        inf = torch.full((n,), float("inf"), dtype=torch.float32,
                         device=dev)
        return Hit(t=torch.where(occluded, torch.ones_like(inf), inf),
                   tri_id=tri)

    intersect.any_hit_variant = any_hit_intersect
    intersect.num_treelets = len(closers)
    return intersect, total


# Megakernel candidates for path scenes past the fused brute gate, in the
# order they are tried: "bounce" the sorted-wavefront pipeline
# (ops/bounce.py, three kernels, a sort and a host sync per bounce over a
# wavefront in device memory), "walk" the BVH path megakernel
# (ops/bvh_path.py, one launch for the image, no state). The faster at
# chip_smoke.py phase 11's shapes goes first, measured on an NVIDIA H100
# 80GB HBM3 at 700 W on the 34,818-triangle box at 1920x1080, 16 spp,
# depth 8, each in turns with the other inside one process
# (tools/bounce_ab.py on the landed kernels, PERF.md): the pipeline took
# 61.621 / 60.378 ms against the walk's 62.961 / 62.202 in the same runs,
# and 59.984 against 62.769 in chip_smoke.py's phase 11; at 256x256, 16
# spp, depth 4, 5.604 against 7.873. Before the walk and shade kernels'
# redesign (6a, 6c) it took 65.4-68.4 ms against the walk's 62.3-63.0,
# and the walk went first. The pipeline holds a state of 64 bytes a lane
# (2.1 GB at that 1080p; ~192 a lane at its peak): past
# bounce.bounce_lanes_check (2^27 lanes, the state's int32 indexing, from
# 1080p at 65 spp or 4K at 17 spp; or half the card's memory) it raises
# ValueError and the walk, which holds no state, takes the render.
# "binned" (ops/binned.py: the binned dense sweep under the bounce
# pipeline's estimator) is reached by name, as in the JAX package, which
# measured it slower on its TPU.
BIG_PATH_ORDER = ("bounce", "walk")
BIG_PATH_CANDIDATES = ("bounce", "walk", "binned")


def make_big_path_renderer(scene: Scene, camera, *, samples: int,
                           max_depth: int, light_samples: int = 2,
                           strategy: str = SAH,
                           order_signs=(1.0, 1.0, 1.0),
                           order: Optional[tuple] = None):
    """Path megakernel for scenes past the fused brute gate: returns
    (fn(seed: int) -> [H, W, 3], backend_name).

    Candidates (BIG_PATH_ORDER; for a textured scene "bounce" alone, the
    only route that resolves texels per bounce) are tried in turn; one that
    raises ValueError (outside its gate) falls through to the next, and
    ValueError is raised when none fits, as in the JAX package, where the
    caller then takes the wavefront. Backend names: "bvh-path-kernel";
    "bounce-kernel" and "binned-kernel" on a CUDA scene, "bounce-torch" and
    "binned-torch" (the kernels' plain versions) on a CPU scene. "binned"
    rejects textured scenes and tables of 2^22 rows or more.
    """
    from orion_tpu_torch.ops.bvh_path import (bounce_textured_supported,
                                              bvh_path_supported,
                                              make_bvh_path_renderer)

    textured = not bvh_path_supported(scene)
    if textured and not bounce_textured_supported(scene):
        raise ValueError("scene outside the bvh-path gate "
                         "(textures / emitters)")
    order = tuple(order or (("bounce",) if textured else BIG_PATH_ORDER))
    for cand in order:
        if cand not in BIG_PATH_CANDIDATES:
            raise ValueError(f"unknown big-path candidate {cand!r}")
    with span("route.big_path"):
        tail = "kernel" if scene.device.type == "cuda" else "torch"
        errs = []
        for cand in order:
            try:
                if cand == "bounce":
                    from orion_tpu_torch.ops.bounce import \
                        make_bounce_path_renderer

                    fn = make_bounce_path_renderer(
                        scene, camera, samples=samples, max_depth=max_depth,
                        light_samples=light_samples, strategy=strategy)
                    return fn, f"bounce-{tail}"
                if cand == "binned":
                    from orion_tpu_torch.ops.binned import \
                        make_binned_path_renderer

                    fn = make_binned_path_renderer(
                        scene, camera, samples=samples, max_depth=max_depth,
                        light_samples=light_samples, strategy=strategy)
                    return fn, f"binned-{tail}"
                fn = make_bvh_path_renderer(scene, camera, samples=samples,
                                            max_depth=max_depth,
                                            light_samples=light_samples,
                                            strategy=strategy,
                                            order_signs=order_signs)
                return fn, "bvh-path-kernel"
            except ValueError as e:
                errs.append(f"{cand}: {e}")
        raise ValueError("no big-path megakernel fits: "
                         + "; ".join(errs))


def make_whitted_megakernel(scene: Scene, camera, *, samples: int,
                            max_depth: int, strategy: str = SAH,
                            order_signs=(1.0, 1.0, 1.0)):
    """Whitted megakernel for a point-light scene: returns (fn(seed: int)
    -> [H, W, 3], backend_name), tried in the JAX package's order
    (cli.py:107-143): the Whitted kernel over the brute sweep inside its
    gate ("fused-whitted-kernel", ops/whitted.py), then the BVH Whitted
    kernel for untextured scenes ("bvh-whitted-kernel",
    ops/bvh_whitted.py), then the deferred-texturing BVH Whitted kernel
    for max_depth <= 4 ("bvh-whitted-deferred-kernel"). On a CPU scene the
    two BVH names end in "-torch" (the kernels' plain versions). Raises
    ValueError when every gate rejects the scene (more than MAX_LIGHTS
    lights, or a textured scene deeper than the deferred chain): the
    caller then takes the wavefront, as in the JAX package."""
    from orion_tpu_torch.ops import bvh_whitted as bw
    from orion_tpu_torch.ops.whitted import (fused_whitted_supported,
                                             make_fused_whitted_renderer)

    if fused_whitted_supported(scene):
        return (make_fused_whitted_renderer(scene, camera, samples=samples,
                                            max_depth=max_depth),
                "fused-whitted-kernel")
    tail = "kernel" if scene.device.type == "cuda" else "torch"
    kw = dict(samples=samples, max_depth=max_depth, strategy=strategy,
              order_signs=order_signs)
    if bw.bvh_whitted_supported(scene):
        return (bw.make_bvh_whitted_renderer(scene, camera, **kw),
                f"bvh-whitted-{tail}")
    if bw.bvh_whitted_deferred_supported(scene, max_depth):
        return (bw.make_bvh_whitted_deferred(scene, camera, **kw),
                f"bvh-whitted-deferred-{tail}")
    raise ValueError("scene outside every Whitted megakernel gate "
                     f"(1..{bw.MAX_LIGHTS} point lights; textured scenes "
                     f"max_depth <= {bw.MAX_DEFERRED_DEPTH})")


def make_megakernel_renderer(ps: PreparedScene, *, mode: Optional[str],
                             samples: int, max_depth: int, light_samples: int,
                             big_path_order: Optional[tuple] = None,
                             camera: Optional[Camera] = None):
    """(fn(seed: int) -> [H, W, 3], backend_name) of a prepared scene's
    megakernel route, as the JAX CLI picks it (cli.py:74-143): Whitted
    mode (mode None: "whitted" when the scene has rtc point lights) ->
    make_whitted_megakernel; path mode -> the fused path kernel inside its
    gate ("fused-kernel", ops/fused_path.py), else make_big_path_renderer
    over `big_path_order` (None: BIG_PATH_ORDER). Trees take ps.strategy
    and ps.order_signs; the kernel is built for `camera` (default
    ps.camera). Raises ValueError outside every gate of the mode: the
    caller then takes the wavefront, as in the JAX package."""
    sc, cam = ps.scene, ps.camera if camera is None else camera
    kw = dict(samples=samples, max_depth=max_depth)
    trees = dict(strategy=ps.strategy, order_signs=ps.order_signs)
    if (mode or ("whitted" if sc.num_lights > 0 else "path")) == "whitted":
        return make_whitted_megakernel(sc, cam, **kw, **trees)
    from orion_tpu_torch.ops.fused_path import (fused_path_supported,
                                                make_fused_path_renderer)

    kw["light_samples"] = light_samples
    if fused_path_supported(sc):
        return make_fused_path_renderer(sc, cam, **kw), "fused-kernel"
    return make_big_path_renderer(sc, cam, **kw, **trees,
                                  order=big_path_order)


def render_wavefront(ps: PreparedScene, generator, *, samples: int,
                     light_samples: int, max_depth: int,
                     mode: Optional[str], regen: bool = False, mesh=None,
                     normal_maps: bool = False) -> torch.Tensor:
    """[H, W, 3] of the forward-only wavefront over ps.intersect:
    render.render, or with `regen=True` regen.render_regen (path mode
    only); with a parallel.sharding.Mesh `mesh`, render_shardmap or
    render_regen_shardmap, every rank getting the whole image. Only
    render.render maps normals."""
    kw = dict(samples=samples, light_samples=light_samples,
              max_depth=max_depth, intersect=ps.intersect)
    with torch.no_grad():
        if regen:
            from orion_tpu_torch.regen import (render_regen,
                                               render_regen_shardmap)

            if mesh is not None:
                return render_regen_shardmap(ps.scene, ps.camera, generator,
                                             mesh=mesh, **kw)
            return render_regen(ps.scene, ps.camera, generator, **kw)
        kw.update(mode=mode, shadow_intersect=ps.shadow_intersect)
        if mesh is not None:
            from orion_tpu_torch.parallel.shardmap_render import \
                render_shardmap

            return render_shardmap(ps.scene, ps.camera, generator,
                                   mesh=mesh, **kw)
        from orion_tpu_torch.render import render

        return render(ps.scene, ps.camera, generator,
                      normal_maps=normal_maps, **kw)


def octant_signs(front) -> tuple:
    """Per-axis direction signs of a dominant ray direction (zeros -> +)."""
    if torch.is_tensor(front):
        front = front.detach().cpu().numpy()
    return tuple(float(s) if s != 0 else 1.0
                 for s in np.sign(np.asarray(front)))


def _select_with_shadow(scene: Scene, strategy: str,
                        force_backend: Optional[str], signs: tuple):
    """select_intersect + the Whitted any-hit shadow variant when useful."""
    fn, backend, bvh, stats = select_intersect(scene, strategy=strategy,
                                               force=force_backend,
                                               order_signs=signs)
    shadow_fn = None
    if backend == "bvh-kernel-treelet" and scene.num_lights > 0:
        shadow_fn = fn.any_hit_variant
    elif backend == "bvh-kernel" and scene.num_lights > 0:
        # Whitted scenes get the any-hit walk for shadow rays; both
        # closures share ONE device layout. Path scenes never read
        # shadow_intersect (NEE needs the nearest hit's mesh).
        from orion_tpu_torch.ops.bvh_intersect import (
            _bvh_device_layout, make_bvh_intersect_kernel)

        layout = _bvh_device_layout(bvh, scene.device)
        fn = make_bvh_intersect_kernel(bvh, scene, layout=layout)
        shadow_fn = make_bvh_intersect_kernel(bvh, scene, any_hit=True,
                                              layout=layout)
    return fn, backend, bvh, stats, shadow_fn


def refresh_octant_order(ps: PreparedScene, front) -> PreparedScene:
    """Re-bake the BVH child order when the camera has moved to a new
    direction octant (a stale hint degrades to default-order traversal).
    No-op for brute backends or when the octant is unchanged."""
    signs = octant_signs(front)
    if ps.bvh is None or signs == tuple(ps.order_signs):
        return ps
    fn, backend, bvh, stats, shadow_fn = _select_with_shadow(
        ps.scene, ps.strategy, ps.force_backend, signs)
    return dataclasses.replace(ps, intersect=fn, backend=backend, bvh=bvh,
                               bvh_stats=stats, shadow_intersect=shadow_fn,
                               order_signs=signs)


def render_prepared(ps: PreparedScene, generator, *, samples: int = 1,
                    light_samples: int = 1,
                    max_depth: Optional[int] = None,
                    mode: Optional[str] = None):
    """Render a PreparedScene with the wavefront; max_depth defaults to
    the rtc recursion level EXACTLY (raytracer.cpp:29,203-206)."""
    from orion_tpu_torch.render import render

    if max_depth is None:
        max_depth = int(ps.rtc.recursion_level)
    return render(ps.scene, ps.camera, generator, samples=samples,
                  max_depth=max_depth, light_samples=light_samples,
                  mode=mode, intersect=ps.intersect,
                  shadow_intersect=ps.shadow_intersect)


def prepare(rtc_path: str | Path, *, device="cuda", strategy: str = SAH,
            force_backend: Optional[str] = None,
            load_textures: bool = True,
            xres: Optional[int] = None,
            yres: Optional[int] = None) -> PreparedScene:
    """Load an .rtc scene onto `device` and select the intersection backend."""
    t0 = time.perf_counter()
    with span("prepare"):
        with span("prepare.load_scene"):
            scene, rtc = load_scene(rtc_path, load_textures=load_textures,
                                    device=device)
        if xres is not None:
            rtc.xres = xres
        if yres is not None:
            rtc.yres = yres
        from orion_tpu_torch.validate import validate_rtc, validate_scene

        with span("prepare.validate"):
            validate_rtc(rtc)
            validate_scene(scene)
        with span("prepare.camera"):
            camera = camera_from_rtc(rtc, device=device)
        # bake near-first child order for the camera's direction octant
        # into the BVH flattening (fewer leaf tests on coherent batches)
        signs = octant_signs(camera.front)
        with span("prepare.accel"):
            fn, backend, bvh, stats, shadow_fn = _select_with_shadow(
                scene, strategy, force_backend, signs)
    return PreparedScene(scene=scene, rtc=rtc, camera=camera, intersect=fn,
                         backend=backend, bvh=bvh, bvh_stats=stats,
                         build_seconds=time.perf_counter() - t0,
                         shadow_intersect=shadow_fn, strategy=strategy,
                         force_backend=force_backend, order_signs=signs)


def render_report(ps: PreparedScene, *, samples: int, light_samples: int,
                  max_depth: int, seconds: float) -> dict:
    """Structured per-render statistics (the reference only prints a
    triangle count, raytracer.cpp:305-310)."""
    H, W = ps.rtc.yres, ps.rtc.xres
    primary = H * W * samples
    shadow_per_hit = (ps.scene.num_lights if ps.scene.num_lights > 0
                      else ps.scene.num_emissive * light_samples)
    dev = ps.scene.device
    return {
        "resolution": [W, H],
        "samples": samples,
        "light_samples": light_samples,
        "max_depth": max_depth,
        "triangles": ps.scene.num_triangles,
        "meshes": ps.scene.num_meshes,
        "backend": ps.backend,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "bvh_nodes": ps.bvh_stats.nodes if ps.bvh_stats else 0,
        "scene_build_seconds": round(ps.build_seconds, 3),
        "render_seconds": round(seconds, 3),
        "primary_rays": primary,
        "primary_rays_per_s": round(primary / max(seconds, 1e-9), 1),
        "est_shadow_rays_per_primary_bounce": shadow_per_hit,
    }
