"""The Whitted megakernels over a BVH: CUDA wrappers + plain versions.

Replaces `orion_tpu.ops.pallas_bvh_whitted` (the Pallas `_make_kernel` and
`_make_deferred_kernel`): Whitted scenes past the brute sweep's gate.

- `bvh_whitted` (kernel 7a): the whole Whitted render of an untextured
  scene in one launch: the estimator of ops/whitted.py (PCG4D primaries,
  depth-0 emission, one any-hit shadow query per point light, Phong with
  pow(0, 0) = 1, the Ks mirror chain with zero-throughput pruning,
  regeneration), every nearest hit and shadow query a skip-pointer walk
  over a bundled [B_pad, 40] table. Tiles through `pix_base` / `n_lanes`.
- `bvh_whitted_textured` (kernel 7b): textured Whitted scenes, the same
  estimator with the hit's Kd and Ks read from its material's maps at the
  hit's uv (the nearest texel, floored-modulo wrap, as ops/shade.py), the
  mirror chain folded front to back with the textured throughput and
  pruned where it is zero. The JAX package cannot gather texels in its
  kernel: it writes per (sample, bounce, lane) the record of the
  texture-independent factors (uv, material id, the ambient (+ depth-0
  emission) sum, the diffuse light sum Cd and the specular light sum Cs)
  and resolves and folds them in jnp after the kernel. The plain version
  keeps that split: `bvh_whitted_deferred_plain` writes the records of
  `chunk` samples from `samp_base` (the RNG keys on the global sample
  index, so chunks compose), and `deferred_epilogue` resolves kd(uv) and
  ks(uv) through the atlas and folds the chain back to front, contrib = r
  + Cd kd + ks (Cs + contrib); `fold_front_to_back` is the kernel's order
  over the same records.

The kernels are `csrc/bvh_whitted.cu` (the persistent Whitted lane loop
of `csrc/whitted_common.cuh` over a tree, each launch handed a zeroed
int32 pixel counter; 7b with its texel hook). Their
plain versions are ops/whitted.py's `_whitted_plain`, the one Whitted
estimator of the package, over the walk of ops/bvh_traverse.py (for 7b
its records, then `deferred_epilogue`). The wrappers take the plain
versions only for CPU tensors; for CUDA tensors they launch the kernels
or raise.

Tree data: `bvh_path_device_data`'s nodes (the SAH tree collapsed to a
4-ary skip-pointer layout, one or 8 per-octant copies) with the Whitted
row in bundled order. The JAX package's packed-u24 texel gather (a TPU
gather-traffic device, checked bit-equal to the float atlas) is not
carried over: kernel and epilogue read the float atlas. No residency cap:
device memory holds the whole tree and table.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from orion_tpu_torch.accel.bvh import BVH, SAH
from orion_tpu_torch.ops.bvh_intersect import NODE_COLS
from orion_tpu_torch.ops.bvh_path import (GPU_LEAF_WIDTH, TreeData,
                                          bvh_path_device_data,
                                          pack_bvh_path_table, untextured)
from orion_tpu_torch.ops.cuda_build import (CudaKernel, check_inputs,
                                            stream_ptr)
from orion_tpu_torch.ops.fused_path import (_f32, camera_vec,
                                            override_camera_vec)
from orion_tpu_torch.ops.prb import _seed32
from orion_tpu_torch.ops.shade import diffuse_color, specular_color
from orion_tpu_torch.ops.whitted import (_C_KA, _C_KS, _C_SHIN, _C_UV,
                                         _D_COLS, _W_COLS, LIGHT_COLS,
                                         MAX_LIGHTS, REC_ROWS,
                                         _whitted_plain, pack_lights)
from orion_tpu_torch.scene import Scene

MAX_DEFERRED_DEPTH = 4
# (sample, bounce) record groups per pass of the plain version: the samples
# are cut into chunks of MAX_REC_GROUPS // (max_depth + 1), so one pass's
# records stay bounded (12 floats a group and lane: 2.0 GB at 1920x1080
# for 40 groups), and the buffer is freed before the next chunk
MAX_REC_GROUPS = 64
# per material: the diffuse, then the specular map's (h, w, y0, x0)
TEXEL_COLS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("bvh_whitted", "bvh_whitted_launch",
                    [_P] * 5 + [_I] * 12 + [_P, _P])
DEFERRED_KERNEL = CudaKernel("bvh_whitted", "bvh_whitted_textured_launch",
                             [_P] * 6 + [_I, _P] + [_I] * 12 + [_P, _P])


def bvh_whitted_supported(scene: Scene) -> bool:
    """Gate of kernel 7a: untextured Whitted scene with 1..MAX_LIGHTS
    point lights, any triangle count."""
    return 1 <= int(scene.num_lights) <= MAX_LIGHTS and untextured(scene)


def bvh_whitted_deferred_supported(scene: Scene, max_depth: int) -> bool:
    """Gate of kernel 7b: Whitted scene with 1..MAX_LIGHTS point lights and
    max_depth <= MAX_DEFERRED_DEPTH (textures allowed: that is its point)."""
    return (max_depth <= MAX_DEFERRED_DEPTH
            and 1 <= int(scene.num_lights) <= MAX_LIGHTS)


def pack_bvh_whitted_table(bvh: BVH, scene: Scene,
                           textured: bool = False) -> np.ndarray:
    """[B_pad, 40] Whitted rows in BUNDLED order (ops/whitted.py's column
    map: the path table's 32 columns, then Ka, Ks, shininess), material
    columns resolved through bvh.tri_orig; padding rows never hit and carry
    zero material. textured=True gives [B_pad, 48]: the corner uvs
    follow in columns 40-45, corner-major per axis (u0 u1 u2 v0 v1 v2); the
    material id is column 29 (the path table's mesh column)."""
    base = pack_bvh_path_table(bvh, scene)
    B = bvh.num_bundled
    tab = np.zeros((base.shape[0], _D_COLS if textured else _W_COLS),
                   np.float32)
    tab[:, :base.shape[1]] = base
    T = int(scene.num_triangles)
    raw = bvh.numpy("tri_orig")[:B]
    orig = np.clip(raw, 0, T - 1)
    m = (raw >= 0).astype(np.float32)
    mat = scene.numpy("tri_mat")[orig]
    tab[:B, _C_KA:_C_KA + 3] = scene.numpy("mat_ambient")[mat] * m[:, None]
    tab[:B, _C_KS:_C_KS + 3] = scene.numpy("mat_specular")[mat] * m[:, None]
    tab[:B, _C_SHIN] = scene.numpy("mat_shininess")[mat] * m
    if textured:
        for a in range(2):
            for c, name in enumerate(("uv0", "uv1", "uv2")):
                tab[:B, _C_UV + 3 * a + c] = scene.numpy(name)[orig, a]
    return tab


def bvh_whitted_device_data(scene: Scene, *, textured: bool = False,
                            strategy: str = SAH,
                            order_signs=(1.0, 1.0, 1.0), octants: int = 1,
                            leaf_width: int = GPU_LEAF_WIDTH,
                            builder: str = "auto", bvh: BVH | None = None):
    """(nodes [M_total, 8], tab [B_pad, 40 or 48], num_nodes) on the
    scene's device: `bvh_path_device_data`'s nodes (a tree built here, or
    `bvh` built with leaf_size == leaf_width) and the Whitted table."""
    nodes, _, total, bvh = bvh_path_device_data(
        scene, strategy=strategy, order_signs=order_signs, with_bvh=True,
        octants=octants, leaf_width=leaf_width, builder=builder, bvh=bvh)
    tab = torch.as_tensor(pack_bvh_whitted_table(bvh, scene, textured),
                          device=scene.device)
    return nodes, tab, total


def _check(name, nodes, tab, lights, cam, cols: int, copies: int, W: int,
           H: int, pix_base: int, n_lanes: int):
    check_inputs(name, tab.device,
                 (("nodes", nodes, (nodes.shape[0], NODE_COLS),
                   torch.float32),
                  ("tab", tab, (tab.shape[0], cols), torch.float32),
                  ("lights", lights, (lights.shape[0], LIGHT_COLS),
                   torch.float32),
                  ("cam", cam, (12,), torch.float32)))
    if not 1 <= lights.shape[0] <= MAX_LIGHTS:
        raise ValueError(f"{name}: {lights.shape[0]} lights, need "
                         f"1..{MAX_LIGHTS}")
    if copies not in (1, 8) or nodes.shape[0] % copies:
        raise ValueError(f"{name}: {copies} copies over {nodes.shape[0]} "
                         f"nodes")
    if pix_base < 0 or n_lanes < 0 or pix_base + n_lanes > W * H:
        raise ValueError(f"{name}: lanes [{pix_base}, {pix_base + n_lanes}) "
                         f"outside the {W}x{H} image")


# ---------------------------------------------------------------------------
# kernel 7a
# ---------------------------------------------------------------------------

def bvh_whitted_plain(nodes, tab, lights, cam, seed: int, W: int, H: int,
                      samples: int, max_depth: int, with_emissive: bool, *,
                      leaf_width: int, copies: int = 1, pix_base: int = 0,
                      n_lanes: int | None = None,
                      stats: dict | None = None) -> torch.Tensor:
    """Kernel 7a's function batched over the lanes [pix_base, pix_base +
    n_lanes): [n_lanes, 3] radiance / spp. stats["tests"] /
    stats["box_tests"] count the walks' Woop tests of real rows and
    visited nodes."""
    tree = TreeData.from_nodes(nodes, copies, leaf_width)
    with torch.no_grad():
        return _whitted_plain(tab, lights, cam, seed, W, H, samples,
                              max_depth, with_emissive, tree=tree,
                              pix_base=pix_base, n_lanes=n_lanes,
                              stats=stats)


def bvh_whitted(nodes, tab, lights, cam, seed: int, W: int, H: int,
                samples: int, max_depth: int, with_emissive: bool, *,
                leaf_width: int, copies: int = 1, pix_base: int = 0,
                n_lanes: int | None = None) -> torch.Tensor:
    """[n_lanes, 3] radiance / spp of the lanes [pix_base, pix_base +
    n_lanes): kernel 7a for CUDA tensors, the plain version for CPU
    tensors."""
    if n_lanes is None:
        n_lanes = W * H - pix_base
    if tab.device.type == "cpu":
        _check("bvh_whitted", nodes, tab, lights, cam, _W_COLS, copies, W, H,
               pix_base, n_lanes)
        return bvh_whitted_plain(nodes, tab, lights, cam, seed, W, H,
                                 samples, max_depth, with_emissive,
                                 leaf_width=leaf_width, copies=copies,
                                 pix_base=pix_base, n_lanes=n_lanes)
    if tab.device.type != "cuda":
        raise ValueError(f"bvh_whitted: unsupported device {tab.device}")
    _check("bvh_whitted", nodes, tab, lights, cam, _W_COLS, copies, W, H,
           pix_base, n_lanes)
    out = torch.empty((n_lanes, 3), dtype=torch.float32, device=tab.device)
    nxt = torch.zeros((1,), dtype=torch.int32, device=tab.device)
    KERNEL.launch(cam.data_ptr(), nodes.data_ptr(), tab.data_ptr(),
                  lights.data_ptr(), out.data_ptr(), nodes.shape[0] // copies,
                  int(leaf_width), copies, lights.shape[0], W, H, samples,
                  max_depth, int(bool(with_emissive)), _seed32(seed),
                  pix_base, n_lanes, nxt.data_ptr(), stream_ptr(tab.device))
    return out


def make_bvh_whitted_renderer(scene: Scene, camera, *, samples: int,
                              max_depth: int, strategy: str = SAH,
                              order_signs=(1.0, 1.0, 1.0),
                              leaf_width: int = GPU_LEAF_WIDTH,
                              octants: int = 1, builder: str = "auto",
                              bvh: BVH | None = None):
    """Build `fn(seed: int, pix_base=0, n_lanes=None, camera_override=None)
    -> image`: the whole Whitted render (all samples, bounces and shadow
    walks) as one launch of kernel 7a on the scene's device (the plain
    version on the CPU). The whole image comes back as [H, W, 3], a tile
    as [n_lanes, 3]. `camera_override`, a camera of the same resolution,
    replaces the build camera's vector (the tree and tables stay). Raises
    ValueError outside the gate (textures / lights). `fn.data` holds the
    kernel's tensors."""
    if not bvh_whitted_supported(scene):
        raise ValueError("scene outside the bvh-whitted gate "
                         "(textures / lights)")
    H, W = camera.yres, camera.xres
    nodes, tab, _ = bvh_whitted_device_data(
        scene, strategy=strategy, order_signs=order_signs, octants=octants,
        leaf_width=leaf_width, builder=builder, bvh=bvh)
    lights = torch.as_tensor(pack_lights(scene), device=scene.device)
    cam = camera_vec(camera).to(scene.device)
    with_em = scene.num_emissive > 0

    def render_bvh_whitted(seed: int, pix_base: int = 0, n_lanes=None,
                           camera_override=None):
        cv = (cam if camera_override is None else
              override_camera_vec(camera_override, W, H, scene.device))
        out = bvh_whitted(nodes, tab, lights, cv, seed, W, H, samples,
                          max_depth, with_em, leaf_width=leaf_width,
                          copies=octants, pix_base=pix_base, n_lanes=n_lanes)
        if pix_base == 0 and n_lanes is None:
            return out.reshape(H, W, 3)
        return out

    render_bvh_whitted.data = dict(nodes=nodes, tab=tab, lights=lights,
                                   cam=cam, leaf_width=leaf_width,
                                   copies=octants, with_emissive=with_em)
    return render_bvh_whitted


# ---------------------------------------------------------------------------
# kernel 7b; its plain version: the records and their epilogue
# ---------------------------------------------------------------------------

def pack_texels(scene: Scene):
    """(mat_tex [n_materials, TEXEL_COLS] int32, atlas [AH, AW, 3] float32)
    on the scene's device: per material the diffuse, then the specular
    map's (h, w, y0, x0) in the atlas, h = 0 where the material has no such
    map (its solid colour stays). What 7b's texel hook reads."""
    hw, off = scene.numpy("tex_hw"), scene.numpy("tex_off")
    maps = (scene.numpy("mat_map_diffuse"), scene.numpy("mat_map_specular"))
    out = np.zeros((maps[0].shape[0], TEXEL_COLS), np.int32)
    for k, m in enumerate(maps):
        img = np.clip(m, 0, None)
        ent = np.concatenate([hw[img], off[img]], axis=1)
        out[:, 4 * k:4 * k + 4] = np.where((m >= 0)[:, None], ent, 0)
    return (torch.as_tensor(out, device=scene.device),
            scene.tex_atlas.float().contiguous())


def bvh_whitted_deferred_plain(nodes, tab, lights, cam, seed: int, W: int,
                               H: int, chunk: int, samp_base: int,
                               max_depth: int, with_emissive: bool, *,
                               leaf_width: int, copies: int = 1,
                               pix_base: int = 0, n_lanes: int | None = None,
                               stats: dict | None = None) -> torch.Tensor:
    """The TPU kernel 7b's function: the records [chunk * (max_depth + 1) *
    12, n_lanes] of the samples [samp_base, samp_base + chunk) of the lanes
    [pix_base, pix_base + n_lanes); `stats` as in bvh_whitted_plain (every
    lane walks all max_depth + 1 bounces where it hits: no pruning)."""
    tree = TreeData.from_nodes(nodes, copies, leaf_width)
    with torch.no_grad():
        return _whitted_plain(tab, lights, cam, seed, W, H, chunk,
                              max_depth, with_emissive, tree=tree,
                              pix_base=pix_base, n_lanes=n_lanes,
                              records=(samp_base, chunk), stats=stats)


def _record_bounces(scene: Scene, rec: torch.Tensor, chunk: int,
                    max_depth: int, depths):
    """Per bounce d of `depths`: (r, Cd, Cs, kd(uv), ks(uv)), each [chunk *
    n, 3], of the records `rec` (materials without a map keep their solid
    colours)."""
    n = rec.shape[1]
    r = rec.reshape(chunk, max_depth + 1, REC_ROWS, n)
    for d in depths:
        x = r[:, d].permute(0, 2, 1).reshape(chunk * n, REC_ROWS)
        uv, mat = x[:, 0:2], x[:, 2].to(torch.int64)
        yield (x[:, 3:6], x[:, 6:9], x[:, 9:12],
               diffuse_color(scene, mat, uv), specular_color(scene, mat, uv))


def deferred_epilogue(scene: Scene, rec: torch.Tensor, chunk: int,
                      max_depth: int) -> torch.Tensor:
    """[n, 3]: the sum over the chunk's samples of each lane's radiance
    from its records: per bounce kd(uv) and ks(uv) through the scene's
    atlas (materials without a map keep their solid colors), then the
    mirror chain folded from the deepest bounce up, contrib_d = r_d +
    Cd_d kd_d + ks_d (Cs_d + contrib_{d+1})."""
    n = rec.shape[1]
    contrib = torch.zeros((chunk * n, 3), dtype=torch.float32,
                          device=rec.device)
    for r, cd, cs, kd, ks in _record_bounces(scene, rec, chunk, max_depth,
                                             range(max_depth, -1, -1)):
        contrib = r + cd * kd + ks * (cs + contrib)
    return contrib.reshape(chunk, n, 3).sum(dim=0)


def fold_front_to_back(scene: Scene, rec: torch.Tensor, chunk: int,
                       max_depth: int) -> torch.Tensor:
    """deferred_epilogue's sum in kernel 7b's order: per sample the bounces
    from the first, acc += T (r + Cd kd + Cs ks), then T *= ks(uv) (T = 1
    at the primary hit). The same value as the back-to-front fold up to
    the sums' rounding."""
    n = rec.shape[1]
    acc = torch.zeros((chunk * n, 3), dtype=torch.float32, device=rec.device)
    T = torch.ones_like(acc)
    for r, cd, cs, kd, ks in _record_bounces(scene, rec, chunk, max_depth,
                                             range(max_depth + 1)):
        acc = acc + T * (r + cd * kd + cs * ks)
        T = T * ks
    return acc.reshape(chunk, n, 3).sum(dim=0)


def bvh_whitted_textured_plain(scene: Scene, nodes, tab, lights, cam,
                               seed: int, W: int, H: int, samples: int,
                               max_depth: int, with_emissive: bool, *,
                               leaf_width: int, copies: int = 1,
                               pix_base: int = 0, n_lanes: int | None = None,
                               sample_chunk: int | None = None,
                               stats: dict | None = None) -> torch.Tensor:
    """Kernel 7b's function as the JAX package computes it: the records of
    `sample_chunk` samples at a time (MAX_REC_GROUPS // (max_depth + 1) by
    default), each chunk resolved and folded by deferred_epilogue and its
    records freed before the next: [n_lanes, 3] radiance / spp of the lanes
    [pix_base, pix_base + n_lanes)."""
    n = W * H - pix_base if n_lanes is None else n_lanes
    if sample_chunk is None:
        sample_chunk = max(1, MAX_REC_GROUPS // (max_depth + 1))
    acc = torch.zeros((n, 3), dtype=torch.float32, device=tab.device)
    for samp_base in range(0, samples, sample_chunk):
        chunk = min(sample_chunk, samples - samp_base)
        rec = bvh_whitted_deferred_plain(
            nodes, tab, lights, cam, seed, W, H, chunk, samp_base, max_depth,
            with_emissive, leaf_width=leaf_width, copies=copies,
            pix_base=pix_base, n_lanes=n, stats=stats)
        acc = acc + deferred_epilogue(scene, rec, chunk, max_depth)
        del rec
    return acc * _f32(1.0 / samples, tab.device)


def bvh_whitted_textured(scene: Scene, nodes, tab, lights, cam, seed: int,
                         W: int, H: int, samples: int, max_depth: int,
                         with_emissive: bool, *, leaf_width: int,
                         copies: int = 1, pix_base: int = 0,
                         n_lanes: int | None = None, texels=None,
                         sample_chunk: int | None = None) -> torch.Tensor:
    """[n_lanes, 3] radiance / spp of the lanes [pix_base, pix_base +
    n_lanes) of the textured Whitted render: kernel 7b for CUDA tensors
    (one launch; `texels` = pack_texels(scene), packed here when None), the
    plain version for CPU tensors (`sample_chunk` samples a pass)."""
    if n_lanes is None:
        n_lanes = W * H - pix_base
    _check("bvh_whitted_textured", nodes, tab, lights, cam, _D_COLS, copies,
           W, H, pix_base, n_lanes)
    if samples < 1 or max_depth < 0:
        raise ValueError(f"bvh_whitted_textured: samples {samples}, "
                         f"max_depth {max_depth}")
    if tab.device.type == "cpu":
        return bvh_whitted_textured_plain(
            scene, nodes, tab, lights, cam, seed, W, H, samples, max_depth,
            with_emissive, leaf_width=leaf_width, copies=copies,
            pix_base=pix_base, n_lanes=n_lanes, sample_chunk=sample_chunk)
    if tab.device.type != "cuda":
        raise ValueError(f"bvh_whitted_textured: unsupported device "
                         f"{tab.device}")
    mat_tex, atlas = texels if texels is not None else pack_texels(scene)
    check_inputs("bvh_whitted_textured", tab.device,
                 (("mat_tex", mat_tex, (mat_tex.shape[0], TEXEL_COLS),
                   torch.int32),
                  ("atlas", atlas, (atlas.shape[0], atlas.shape[1], 3),
                   torch.float32)))
    out = torch.empty((n_lanes, 3), dtype=torch.float32, device=tab.device)
    nxt = torch.zeros((1,), dtype=torch.int32, device=tab.device)
    DEFERRED_KERNEL.launch(cam.data_ptr(), nodes.data_ptr(), tab.data_ptr(),
                           lights.data_ptr(), mat_tex.data_ptr(),
                           atlas.data_ptr(), atlas.shape[1], out.data_ptr(),
                           nodes.shape[0] // copies, int(leaf_width), copies,
                           lights.shape[0], W, H, samples, max_depth,
                           int(bool(with_emissive)), _seed32(seed), pix_base,
                           n_lanes, nxt.data_ptr(), stream_ptr(tab.device))
    return out


def make_bvh_whitted_deferred(scene: Scene, camera, *, samples: int,
                              max_depth: int = 0, strategy: str = SAH,
                              order_signs=(1.0, 1.0, 1.0),
                              leaf_width: int = GPU_LEAF_WIDTH,
                              octants: int = 1, builder: str = "auto",
                              bvh: BVH | None = None):
    """Build `fn(seed: int, pix_base=0, n_lanes=None) -> image`: the
    textured Whitted render as one launch of kernel 7b on a CUDA scene, and
    as the plain version's record chunks (MAX_REC_GROUPS // (max_depth + 1)
    samples each) resolved and folded by `deferred_epilogue` on the CPU.
    [H, W, 3] for the whole image, [n_lanes, 3] for a tile.
    `camera_override` (fn's fourth argument), a camera of the same
    resolution, replaces the build camera's vector. Raises
    ValueError outside the gate (depth / lights). `fn.data` holds the
    kernel's tensors and the plain version's chunks."""
    if not bvh_whitted_deferred_supported(scene, max_depth):
        raise ValueError("scene outside the deferred bvh-whitted gate "
                         f"(max_depth <= {MAX_DEFERRED_DEPTH}; "
                         f"1..{MAX_LIGHTS} lights)")
    H, W = camera.yres, camera.xres
    nodes, tab, _ = bvh_whitted_device_data(
        scene, textured=True, strategy=strategy, order_signs=order_signs,
        octants=octants, leaf_width=leaf_width, builder=builder, bvh=bvh)
    lights = torch.as_tensor(pack_lights(scene), device=scene.device)
    cam = camera_vec(camera).to(scene.device)
    with_em = scene.num_emissive > 0
    texels = pack_texels(scene)
    sample_chunk = max(1, MAX_REC_GROUPS // (max_depth + 1))
    chunks = [(c, min(sample_chunk, samples - c))
              for c in range(0, samples, sample_chunk)]

    def render_deferred(seed: int, pix_base: int = 0, n_lanes=None,
                        camera_override=None):
        cv = (cam if camera_override is None else
              override_camera_vec(camera_override, W, H, scene.device))
        out = bvh_whitted_textured(
            scene, nodes, tab, lights, cv, seed, W, H, samples, max_depth,
            with_em, leaf_width=leaf_width, copies=octants,
            pix_base=pix_base, n_lanes=n_lanes, texels=texels,
            sample_chunk=sample_chunk)
        if pix_base == 0 and n_lanes is None:
            return out.reshape(H, W, 3)
        return out

    render_deferred.data = dict(nodes=nodes, tab=tab, lights=lights, cam=cam,
                                leaf_width=leaf_width, copies=octants,
                                with_emissive=with_em, texels=texels,
                                chunks=chunks, max_depth=max_depth)
    return render_deferred
