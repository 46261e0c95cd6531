"""Engine: scene preparation, backend selection, render statistics.

The PyTorch counterpart of `orion_tpu.engine` (RayTracer::traceRTC's
setup, raytracer.cpp:19-103): parse the .rtc, load and flatten the scene
onto the device, validate it and pick the wavefront's intersection
backend.

Backend selection: scenes up to BRUTE_MAX_TRIS triangles (or any size with
force="brute") intersect with the brute sweep (its CUDA kernel on a CUDA
device). Larger scenes would take the BVH backend, which is not ported
yet: the selected intersect function raises if the wavefront reaches it.
The fused megakernel route (cli.py) does not use this selection.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Optional

import torch

from orion_tpu_torch.camera import Camera, camera_from_rtc
from orion_tpu_torch.io.rtc import RTCData
from orion_tpu_torch.render import IntersectFn
from orion_tpu_torch.scene import Scene, load_scene

BRUTE_MAX_TRIS = 1024
BVH_NOT_PORTED = "bvh (not ported)"


@dataclasses.dataclass
class PreparedScene:
    """A scene plus everything needed to render it."""

    scene: Scene
    rtc: RTCData
    camera: Camera
    intersect: IntersectFn
    backend: str                       # "brute-kernel" | BVH_NOT_PORTED | ...
    build_seconds: float = 0.0
    # occlusion-only (any-hit) intersect for Whitted shadow rays, where
    # only hit.mask is read; None => reuse `intersect` (as on brute)
    shadow_intersect: Optional[IntersectFn] = None


def _bvh_not_ported(scene, orig, dirs, *, alive=None):
    raise NotImplementedError(
        f"the BVH intersection backend is not ported yet: a "
        f"{scene.num_triangles}-triangle scene exceeds the brute sweep's "
        f"{BRUTE_MAX_TRIS}-triangle gate (force it with --backend brute)")


def select_intersect(scene: Scene, *, force: Optional[str] = None):
    """Choose (intersect_fn, backend_name) for a scene.

    force: "brute" pins the brute sweep at any size; "bvh" (or a scene past
    BRUTE_MAX_TRIS) selects the BVH backend, which is not ported and
    raises when used.
    """
    if force not in (None, "brute", "bvh"):
        raise ValueError(f"unknown intersection backend {force!r}")
    want_bvh = (scene.num_triangles > BRUTE_MAX_TRIS
                if force is None else force == "bvh")
    if want_bvh:
        return _bvh_not_ported, BVH_NOT_PORTED
    from orion_tpu_torch.ops.brute_intersect import intersect_brute_kernel

    return intersect_brute_kernel, "brute-kernel"


def prepare(rtc_path: str | Path, *, device="cuda",
            force_backend: Optional[str] = None,
            load_textures: bool = True,
            xres: Optional[int] = None,
            yres: Optional[int] = None) -> PreparedScene:
    """Load an .rtc scene onto `device` and select the intersection backend."""
    t0 = time.perf_counter()
    scene, rtc = load_scene(rtc_path, load_textures=load_textures,
                            device=device)
    if xres is not None:
        rtc.xres = xres
    if yres is not None:
        rtc.yres = yres
    from orion_tpu_torch.validate import validate_rtc, validate_scene

    validate_rtc(rtc)
    validate_scene(scene)
    camera = camera_from_rtc(rtc, device=device)
    fn, backend = select_intersect(scene, force=force_backend)
    return PreparedScene(scene=scene, rtc=rtc, camera=camera, intersect=fn,
                         backend=backend,
                         build_seconds=time.perf_counter() - t0)


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
        "scene_build_seconds": round(ps.build_seconds, 3),
        "render_seconds": round(seconds, 3),
        "primary_rays": primary,
        "primary_rays_per_s": round(primary / max(seconds, 1e-9), 1),
        "est_shadow_rays_per_primary_bounce": shadow_per_hit,
    }
