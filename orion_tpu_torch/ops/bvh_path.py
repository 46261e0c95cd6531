"""The regenerative path-tracing megakernel over a BVH: CUDA wrapper +
plain version.

Replaces `orion_tpu.ops.pallas_bvh_path` (the Pallas `_make_kernel`): path
mode beyond the brute sweep's gate. The whole regenerative estimator of
ops/fused_path.py, with the legacy NEE (the shadow walk carries the
winner's normal and emitted color, as the JAX kernel builds it), but every
sweep is a skip-pointer walk over leaf bundles of a [B_pad, 32] table in
bundled order. The kernel is `csrc/bvh_path.cu`, the persistent lane loop
of `csrc/render_lane.cuh` over `csrc/fused_common.cuh`'s skip-pointer walk
of the tree; `bvh_path_plain` is
`fused_path._regen_steps` with the walk of ops/bvh_traverse.py in place of
the sweep.

`bvh_path` takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.

Tree data (`bvh_path_device_data`): the SAH tree of the scene, collapsed
to a 4-ary skip-pointer layout (`collapse_skip_levels`), optionally as 8
per-octant flattenings of the one tree (`reflatten_octant`); bit 0 of a
leaf's start flags a leaf without emitter rows (read by the bounce
pipeline's shadow walks, masked off here). Nodes are packed as
ops/bvh_intersect.py packs them: [M, 8] rows (lo, hi, skip, start).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from orion_tpu_torch.accel.bvh import BVH, SAH, build_bvh
from orion_tpu_torch.ops.bvh_intersect import (NODE_COLS, pack_nodes,
                                               unpack_nodes)
from orion_tpu_torch.ops.bvh_traverse import walk_plain
from orion_tpu_torch.ops.cuda_build import (CudaKernel, check_inputs,
                                            stream_ptr)
from orion_tpu_torch.ops.fused_path import (_C_AREA, _C_KD, _C_KE, _C_MESH,
                                            _C_N0, _C_WOOP, EM_STRIDE,
                                            FUSED_MAX_EMITTER_TRIS,
                                            FUSED_MAX_EMITTERS, _f32,
                                            _regen_steps, camera_vec,
                                            override_camera_vec,
                                            pack_emitters)
from orion_tpu_torch.ops.reorder import direction_octant
from orion_tpu_torch.ops.woop import BIG, woop_rows_np
from orion_tpu_torch.scene import Scene

LEAF_WIDTH = 128      # the JAX package's bundle width; the table's row
                      # count is padded to a multiple of it at any width
GPU_LEAF_WIDTH = 2    # what the renderer builds for one thread per ray
_COLS = 32            # table row width == fused_path's column map

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("bvh_path", "bvh_path_launch",
                    [_P] * 6 + [_I] * 12 + [_P])


def _b_pad(B: int) -> int:
    return ((max(B, LEAF_WIDTH) + LEAF_WIDTH - 1) // LEAF_WIDTH) * LEAF_WIDTH


def pack_bvh_path_table(bvh: BVH, scene: Scene) -> np.ndarray:
    """[B_pad, 32] rows in BUNDLED (leaf-contiguous) order with
    fused_path's `_C_*` column map, so the shared estimator reads this
    table as it reads the brute one. Padding rows (tri_orig == -1, and the
    tail past the last bundle) never hit and carry zero material. The
    transpose of the JAX package's [32, B_pad] array."""
    B = bvh.num_bundled
    tab = np.zeros((_b_pad(B), _COLS), np.float32)
    tab[:B, _C_WOOP:_C_WOOP + 13] = woop_rows_np(
        bvh.numpy("tri_v0"), bvh.numpy("tri_e1"), bvh.numpy("tri_e2"))
    tab[B:, _C_WOOP + 11] = 1.0   # tail past B: always-miss transform

    T = int(scene.num_triangles)
    raw = bvh.numpy("tri_orig")[:B]
    real = raw >= 0                  # padding rows carry tri_orig == -1
    orig = np.clip(raw, 0, T - 1)
    tab[:B, _C_N0:_C_N0 + 3] = scene.numpy("n0")[orig]
    tab[:B, _C_N0 + 3:_C_N0 + 6] = scene.numpy("n1")[orig]
    tab[:B, _C_N0 + 6:_C_N0 + 9] = scene.numpy("n2")[orig]

    mat = scene.numpy("tri_mat")[orig]
    m = real.astype(np.float32)
    tab[:B, _C_KD:_C_KD + 3] = scene.numpy("mat_diffuse")[mat] * m[:, None]
    tab[:B, _C_KE:_C_KE + 3] = scene.numpy("mat_emissive")[mat] * m[:, None]
    tab[:B, _C_AREA] = scene.numpy("mesh_area")[mat] * m
    tab[:B, _C_MESH] = mat.astype(np.float32) * m
    return tab


def pack_bvh_tex_table(bvh: BVH, scene: Scene) -> np.ndarray:
    """[B_pad, 8] per-bundled-row texture data for the bounce pipeline's
    per-bounce texturing (ops/bounce.py): cols 0-5 = the three corner uvs
    (uv0 uv1 uv2, xy each), 6-7 pad."""
    B = bvh.num_bundled
    out = np.zeros((_b_pad(B), 8), np.float32)
    T = int(scene.num_triangles)
    raw = bvh.numpy("tri_orig")[:B]
    orig = np.clip(raw, 0, T - 1)
    m = (raw >= 0).astype(np.float32)[:, None]
    out[:B, 0:2] = scene.numpy("uv0")[orig] * m
    out[:B, 2:4] = scene.numpy("uv1")[orig] * m
    out[:B, 4:6] = scene.numpy("uv2")[orig] * m
    return out


def tab_updater_from_bvh(bvh: BVH, scene: Scene):
    """`update(mat_diffuse=None, mat_emissive=None) -> tab` for an
    ALREADY-BUILT tree: the bundled [B_pad, 32] table with only its
    material columns (kd, ke) regathered from the given tensors (default:
    the scene's), differentiable with respect to them; geometry columns
    are baked. Used by the trainers over a tree (ops/bounce_prb.py)."""
    dev = scene.device
    base = torch.as_tensor(pack_bvh_path_table(bvh, scene), device=dev)
    B_pad = base.shape[0]
    T = int(scene.num_triangles)
    raw = bvh.numpy("tri_orig")[:bvh.num_bundled]
    real = np.zeros(B_pad, np.float32)
    real[:raw.shape[0]] = (raw >= 0).astype(np.float32)
    mat = np.zeros(B_pad, np.int64)
    mat[:raw.shape[0]] = scene.numpy("tri_mat")[np.clip(raw, 0, T - 1)]
    mat_idx = torch.as_tensor(mat, device=dev)
    realf = torch.as_tensor(real, device=dev)[:, None]

    def update(mat_diffuse=None, mat_emissive=None) -> torch.Tensor:
        kd = scene.mat_diffuse if mat_diffuse is None else mat_diffuse
        ke = scene.mat_emissive if mat_emissive is None else mat_emissive
        return torch.cat([base[:, :_C_KD],
                          kd[mat_idx].to(torch.float32) * realf,
                          ke[mat_idx].to(torch.float32) * realf,
                          base[:, _C_AREA:]], dim=1)

    return update


def _small_emitters(scene: Scene) -> bool:
    if not (1 <= scene.num_emissive <= FUSED_MAX_EMITTERS):
        return False
    counts = scene.numpy("mesh_tri_count")
    return all(int(counts[int(em)]) <= FUSED_MAX_EMITTER_TRIS
               for em in scene.numpy("emissive_mesh_ids")[:scene.num_emissive])


def bounce_textured_supported(scene: Scene) -> bool:
    """The TEXTURED bounce-pipeline gate: path scenes whose estimator
    needs only kd(uv) and solid ke. Diffuse texture maps are allowed on
    any material; emitters still small with solid ke."""
    return _small_emitters(scene)


def untextured(scene: Scene) -> bool:
    """No texture image and no material map (diffuse, specular, bump)."""
    if int(scene.numpy("tex_hw").max()) > 1:
        return False
    maps = np.concatenate([scene.numpy("mat_map_diffuse"),
                           scene.numpy("mat_map_specular"),
                           scene.numpy("mat_map_bump")])
    return bool((maps < 0).all())


def bvh_path_supported(scene: Scene) -> bool:
    """The fused gate without its triangle cap: untextured, 1..8 emissive
    meshes of <= 8 triangles."""
    return _small_emitters(scene) and untextured(scene)


def reflatten_octant(lo, hi, skip, start, signs):
    """Re-emit a flattened skip-pointer tree in a new DFS order: at each
    internal node the child whose centroid is NEARER along the split axis
    for a ray of direction signs `signs` comes first. Structure, AABBs
    and leaf `start` pointers (into the shared bundled table) are
    unchanged; only the visit order moves, which is what near-first
    traversal with t-pruning wants. The split axis is recovered as the
    axis of largest child centroid separation."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    skip, start = np.asarray(skip), np.asarray(start)
    M = lo.shape[0]
    cen = 0.5 * (lo + hi)
    order = np.empty(M, np.int64)     # new position -> old node
    pos = 0
    stack = [0]
    while stack:
        i = stack.pop()
        order[pos] = i
        pos += 1
        if start[i] >= 0:
            continue
        left = i + 1
        right = int(skip[left])
        if right >= int(skip[i]):     # single-child chain: nothing to order
            stack.append(left)
            continue
        diff = cen[left] - cen[right]
        axis = int(np.argmax(np.abs(diff)))
        left_is_near = (diff[axis] <= 0) == (signs[axis] > 0)
        first, second = (left, right) if left_is_near else (right, left)
        stack.append(second)
        stack.append(first)           # LIFO: `first` is emitted first
    # subtree sizes are order-invariant, and DFS subtrees stay
    # contiguous: skip_new[p] = p + (skip_old[i] - i)
    sizes = skip[order] - order
    new_skip = (np.arange(M) + sizes).astype(np.int32)
    return lo[order], hi[order], new_skip, start[order].astype(np.int32)


def collapse_skip_levels(lo, hi, skip, start):
    """Drop every other INTERNAL level from a flattened skip-pointer
    layout (a 4-ary flatten of the same binary tree): fewer node steps
    with identical leaf visits. The walk code is unchanged: arity lives
    entirely in the (skip, start) encoding."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    skip, start = np.asarray(skip), np.asarray(start)
    M = lo.shape[0]
    depth = np.zeros(M, np.int64)
    stack = [(0, 0)]
    while stack:
        i, d = stack.pop()
        depth[i] = d
        if start[i] >= 0:
            continue
        left = i + 1
        right = int(skip[left])
        stack.append((left, d + 1))
        if right < int(skip[i]):
            stack.append((right, d + 1))
    keep = (start >= 0) | (depth % 2 == 0)
    new_idx = np.cumsum(keep) - 1
    Mp = int(keep.sum())
    # next kept node at/after j (Mp past the end)
    nxt = np.full(M + 1, Mp, np.int64)
    nxt[:M] = np.where(keep, new_idx, M + Mp)
    nxt = np.minimum.accumulate(nxt[::-1])[::-1]
    skip2 = nxt[skip[keep]].astype(np.int32)
    return (lo[keep], hi[keep], skip2, start[keep].astype(np.int32))


def bvh_path_device_data(scene: Scene, *, strategy: str = SAH,
                         order_signs=(1.0, 1.0, 1.0), with_bvh: bool = False,
                         octants: int = 1, leaf_width: int = LEAF_WIDTH,
                         builder: str = "auto", bvh: BVH | None = None):
    """(nodes [M_total, 8], tab [B_pad, 32], num_nodes[, bvh]): the
    kernel's tensors on the scene's device (with_bvh additionally returns
    the host-side tree).

    octants=8 emits 8 concatenated per-octant flattenings of the one tree
    (reflatten_octant then collapse_skip_levels per copy, shared bundled
    table); num_nodes is then the TOTAL (8x per-copy) length. `bvh` hands
    in a tree already built with leaf_size == leaf_width (the tests use
    this to walk the identical tree as the JAX package). No residency cap
    is checked: device memory holds the whole table.
    """
    if leaf_width < 2 or leaf_width % 2:
        raise ValueError(f"leaf_width {leaf_width}: leaf starts carry a "
                         f"flag in bit 0, so the width must be even")
    if bvh is None:
        bvh, _ = build_bvh(scene.numpy("tri_v0"), scene.numpy("tri_e1"),
                           scene.numpy("tri_e2"), scene.numpy("tri_valid"),
                           strategy=strategy, leaf_size=leaf_width,
                           leaf_width=leaf_width, order_signs=order_signs,
                           builder=builder)
    elif bvh.leaf_width != leaf_width:
        raise ValueError(f"tree of leaf width {bvh.leaf_width}, asked for "
                         f"{leaf_width}")
    tab_np = pack_bvh_path_table(bvh, scene)
    tree = (bvh.numpy("node_lo"), bvh.numpy("node_hi"),
            bvh.numpy("node_skip"), bvh.numpy("node_start"))
    if octants == 1:
        n_lo, n_hi, n_skip, n_start = collapse_skip_levels(*tree)
    else:
        copies = []
        for o in range(octants):
            signs = tuple(1.0 if (o >> a) & 1 else -1.0 for a in range(3))
            copies.append(collapse_skip_levels(*reflatten_octant(*tree,
                                                                 signs)))
        Mp = copies[0][0].shape[0]
        assert all(c[0].shape[0] == Mp for c in copies), \
            "octant copies must collapse to equal lengths"
        n_lo = np.concatenate([c[0] for c in copies])
        n_hi = np.concatenate([c[1] for c in copies])
        n_skip = np.concatenate(
            [c[2] + np.int32(i * Mp) for i, c in enumerate(copies)])
        n_start = np.concatenate([c[3] for c in copies])
    # bit-0 "no emitter rows" flag on leaf starts (multiples of an even
    # width, so bit 0 is free). Padding rows carry mesh 0; if mesh 0 is
    # emissive they read as emitter rows: conservative (flag stays 0).
    em_ids = sorted(int(m) for m in
                    scene.numpy("emissive_mesh_ids")[:scene.num_emissive])
    is_em_row = np.isin(tab_np[:, _C_MESH].astype(np.int64), em_ids)
    em_before = np.concatenate([[0], np.cumsum(is_em_row)])
    leaf = n_start >= 0
    st0 = np.where(leaf, n_start, 0)
    has_em = em_before[np.minimum(st0 + leaf_width, len(is_em_row))] \
        > em_before[st0]
    n_start = np.where(leaf & ~has_em, n_start | 1, n_start).astype(np.int32)

    dev = scene.device
    nodes = torch.as_tensor(pack_nodes(n_lo, n_hi, n_skip, n_start),
                            device=dev)
    tab = torch.as_tensor(tab_np, device=dev)
    if with_bvh:
        return nodes, tab, int(n_lo.shape[0]), bvh
    return nodes, tab, int(n_lo.shape[0])


@dataclasses.dataclass
class TreeData:
    """The walk's view of `bvh_path_device_data`'s nodes: what
    `_regen_steps` takes as `tree`."""

    lo: torch.Tensor
    hi: torch.Tensor
    skip: torch.Tensor
    start: torch.Tensor
    per_copy: int        # nodes of one flattening
    copies: int          # 1, or 8 per-octant flattenings
    leaf_width: int

    @classmethod
    def from_nodes(cls, nodes, copies: int, leaf_width: int) -> "TreeData":
        lo, hi, skip, start = unpack_nodes(nodes)
        return cls(lo, hi, skip, start, nodes.shape[0] // copies, copies,
                   leaf_width)

    def nearest(self, woop, orig, dirs, cap, stats, any_hit: bool = False):
        """(t, row) of each ray's walk (the ray's own octant's copy)."""
        first = None
        if self.copies == 8:
            first = direction_octant(dirs).to(torch.int64) * self.per_copy
        return walk_plain(self.lo, self.hi, self.skip, self.start, woop,
                          orig, dirs, leaf_width=self.leaf_width, cap=cap,
                          any_hit=any_hit, first=first, count=self.per_copy,
                          flagged_starts=True, stats=stats)

    def any_hit(self, woop, orig, dirs, stats):
        """Does each ray hit any row at any t >= 0 (the Whitted shadow
        query; the walk leaves at its first leaf with a hit)?"""
        return self.nearest(woop, orig, dirs, BIG, stats, any_hit=True)[1] >= 0


def _check_tree(name: str, nodes, tab, em, cam, copies: int, W: int, H: int,
                pix_base: int, n_lanes: int):
    check_inputs(name, tab.device,
                 (("nodes", nodes, (nodes.shape[0], NODE_COLS),
                   torch.float32),
                  ("tab", tab, (tab.shape[0], _COLS), torch.float32),
                  ("em", em, (em.shape[0], EM_STRIDE), torch.float32),
                  ("cam", cam, (12,), torch.float32)))
    if not 1 <= em.shape[0] <= FUSED_MAX_EMITTERS:
        raise ValueError(f"{name}: {em.shape[0]} emitters, need 1.."
                         f"{FUSED_MAX_EMITTERS}")
    if copies not in (1, 8) or nodes.shape[0] % copies:
        raise ValueError(f"{name}: {copies} copies over {nodes.shape[0]} "
                         f"nodes")
    if pix_base < 0 or n_lanes < 0 or pix_base + n_lanes > W * H:
        raise ValueError(f"{name}: lanes [{pix_base}, {pix_base + n_lanes}) "
                         f"outside the {W}x{H} image")


def bvh_path_plain(nodes, tab, em, cam, seed: int, W: int, H: int,
                   samples: int, max_depth: int, light_samples: int, *,
                   leaf_width: int, copies: int = 1, pix_base: int = 0,
                   n_lanes: int | None = None,
                   stats: dict | None = None) -> torch.Tensor:
    """The kernel's estimator batched over the lanes [pix_base, pix_base +
    n_lanes) (default: the whole image): [n_lanes, 3] radiance/spp.
    stats["tests"] / stats["box_tests"] count the walks' Woop tests of
    real rows and visited nodes."""
    tree = TreeData.from_nodes(nodes, copies, leaf_width)
    acc = [0.0, 0.0, 0.0]
    with torch.no_grad():
        for st in _regen_steps(tab, em, cam, seed, W, H, samples, max_depth,
                               light_samples, legacy=True, stats=stats,
                               tree=tree, pix_base=pix_base,
                               n_lanes=n_lanes):
            acc = [acc[k] + st["contrib"][k] for k in range(3)]
    return torch.stack(acc, dim=1) * _f32(1.0 / samples, tab.device)


def bvh_path(nodes, tab, em, cam, seed: int, W: int, H: int, samples: int,
             max_depth: int, light_samples: int, *, leaf_width: int,
             copies: int = 1, pix_base: int = 0,
             n_lanes: int | None = None) -> torch.Tensor:
    """[n_lanes, 3] radiance / spp of the lanes [pix_base, pix_base +
    n_lanes): the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if n_lanes is None:
        n_lanes = W * H - pix_base
    if tab.device.type == "cpu":
        return bvh_path_plain(nodes, tab, em, cam, seed, W, H, samples,
                              max_depth, light_samples,
                              leaf_width=leaf_width, copies=copies,
                              pix_base=pix_base, n_lanes=n_lanes)
    if tab.device.type != "cuda":
        raise ValueError(f"bvh_path: unsupported device {tab.device}")
    _check_tree("bvh_path", nodes, tab, em, cam, copies, W, H, pix_base,
                n_lanes)
    out = torch.empty((n_lanes, 3), dtype=torch.float32, device=tab.device)
    nxt = torch.zeros((1,), dtype=torch.int32, device=tab.device)
    seed32 = (int(seed) + 2**31) % 2**32 - 2**31   # as int32 bits
    KERNEL.launch(cam.data_ptr(), nodes.data_ptr(), tab.data_ptr(),
                  em.data_ptr(), out.data_ptr(), nxt.data_ptr(),
                  nodes.shape[0] // copies, int(leaf_width), copies,
                  em.shape[0], W, H, samples, max_depth, light_samples,
                  seed32, pix_base, n_lanes, stream_ptr(tab.device))
    return out


def make_bvh_path_renderer(scene: Scene, camera, *, samples: int,
                           max_depth: int, light_samples: int = 2,
                           strategy: str = SAH,
                           order_signs=(1.0, 1.0, 1.0),
                           leaf_width: int = GPU_LEAF_WIDTH,
                           octants: int = 1, builder: str = "auto",
                           bvh: BVH | None = None):
    """Build `fn(seed: int, pix_base=0, n_lanes=None, camera_override=None)
    -> image`: the whole path-traced render (all samples, all bounces, all
    NEE shadow walks) as one BVH megakernel launch on the scene's device
    (the plain version on the CPU). The whole image comes back as [H, W,
    3]; a tile (pix_base / n_lanes given) as [n_lanes, 3].
    `camera_override`, a camera of the same resolution, replaces the build
    camera's vector (the tree and tables stay). Raises ValueError outside
    the gate (textures / emitters). `fn.data` holds the kernel's
    tensors."""
    if not bvh_path_supported(scene):
        raise ValueError("scene outside the bvh-path gate "
                         "(textures / emitters)")
    H, W = camera.yres, camera.xres
    nodes, tab, _ = bvh_path_device_data(
        scene, strategy=strategy, order_signs=order_signs, octants=octants,
        leaf_width=leaf_width, builder=builder, bvh=bvh)
    em = torch.as_tensor(pack_emitters(scene), device=scene.device)
    cam = camera_vec(camera).to(scene.device)

    def render_bvh_path(seed: int, pix_base: int = 0, n_lanes=None,
                        camera_override=None):
        cv = (cam if camera_override is None else
              override_camera_vec(camera_override, W, H, scene.device))
        out = bvh_path(nodes, tab, em, cv, seed, W, H, samples, max_depth,
                       light_samples, leaf_width=leaf_width, copies=octants,
                       pix_base=pix_base, n_lanes=n_lanes)
        if pix_base == 0 and n_lanes is None:
            return out.reshape(H, W, 3)
        return out

    render_bvh_path.data = dict(nodes=nodes, tab=tab, em=em, cam=cam,
                                leaf_width=leaf_width, copies=octants)
    return render_bvh_path
