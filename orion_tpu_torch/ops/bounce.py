"""Sorted-wavefront path tracing: three CUDA kernels per bounce over a
wavefront that lives in device memory and is sorted between bounces.

Replaces `orion_tpu.ops.pallas_bounce` (the Pallas `_make_walk_kernel`,
`_make_vis_kernel` and `_make_shade_kernel`): path mode for scenes past
the fused gate, the only route that resolves a diffuse texture at every
bounce. A resident megakernel (ops/bvh_path.py) cannot reorder its rays;
here every lane (one sample of one pixel) is a column of ONE float32
[16, N] state, and each bounce is

  1. a stable sort of the previous live prefix by the coherence key in
     row 13 (dead lanes last, then direction octant, then origin morton:
     ops/reorder.py's key) and a count of the live lanes (`torch.sort` and
     a row gather: the JAX package sorts outside its kernels too);
  2. the WALK kernel over the live prefix: the lean nearest-hit walk
     -> hitdata [8, n] (t, u, v, global winner row, hit flag);
  3. for a textured scene, the texel at the winner's uv (plain PyTorch, as
     in the JAX package) -> kd planes [3, n];
  4. optionally the VIS kernel: both light samples' visibility in one
     dual-carry walk -> [8, n] (`split_vis`; one emitter, 2 light samples),
     or an injected visibility step (the binned renderer's, ops/binned.py,
     which sweeps the shade step's own shadow rays, written by the vis
     kernel's draw-only mode);
  5. the SHADE kernel: depth-0 emission, fast-shadow NEE (its own shadow
     walks unless step 4 ran), Russian roulette, cosine bounce,
     accumulation and the next key, over the state's prefix in place; with
     `with_aux` also the 15 planes per bounce that the closed-form trainer
     (ops/bounce_prb.py) reads.

The kernels are `csrc/bounce.cu`; each has a plain PyTorch version here
(`bounce_walk_plain`, `bounce_vis_plain`, `bounce_shade_plain`), and each
wrapper takes the plain version only for CPU tensors: for CUDA tensors it
launches its kernel or raises.

State rows: 0-2 origin, 3-5 direction, 6-8 throughput, 9 alive, 10-12
accumulated radiance, 13 sort key, 14 pixel id, 15 sample index (the last
three integer-valued and exact in float32: pixel ids stay below 2^24).
Estimator: ops/fused_path.py's fast-shadow one with its PCG4D streams keyed
on (pixel, sample, depth), so a lane's result does not depend on where the
sort puts it, and a render equals `bounce_reference_render` (unsorted, over
a brute sweep of the same bundled table) up to nearest-hit ties.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from orion_tpu_torch.accel.bvh import BVH, SAH, build_bvh
from orion_tpu_torch.ops.bvh_intersect import NODE_COLS
from orion_tpu_torch.ops.bvh_path import (GPU_LEAF_WIDTH, LEAF_WIDTH, _COLS,
                                          TreeData, bounce_textured_supported,
                                          bvh_path_device_data,
                                          bvh_path_supported,
                                          pack_bvh_path_table,
                                          pack_bvh_tex_table)
from orion_tpu_torch.ops.cuda_build import (CudaKernel, check_inputs,
                                            stream_ptr)
from orion_tpu_torch.ops.fused_path import (_C_AREA, _C_KD, _C_KE, _C_MESH,
                                            _C_N0, _C_N1, _C_N2, _M32, BIAS,
                                            EM_STRIDE, FUSED_MAX_EMITTERS,
                                            NEE_T_CAP, _camera_rays,
                                            _cosine_bounce, _f32, _nee_plain,
                                            _norm3, _pcg4d, _pixel_base,
                                            _sample_jitter, _u01, camera_vec,
                                            pack_emitters)
from orion_tpu_torch.ops.reorder import MORTON_BITS
from orion_tpu_torch.ops.woop import BIG, nearest_rows, woop_tuv
from orion_tpu_torch.scene import Scene

DEAD_KEY = 1 << (3 * MORTON_BITS + 3)
ST_ROWS = 16        # the wavefront state
HIT_ROWS = 8        # hitdata and the visibility planes
AUX_ROWS = 16       # 15 replay planes + a zero row
# aux plane rows (the with_aux dump)
A_KD, A_A, A_RAD = 0, 3, 6
A_EMS, A_SUMS, A_MESH, A_HIT, A_CONT, A_INVP = 9, 10, 11, 12, 13, 14
# What a pipeline of N lanes may hold (bounce_lanes_check). The kernels
# index the state's rows as row * N + lane in int32. At its peak, the
# sort, a lane holds its state (64 bytes), the sorted copy (64), the key,
# the permutation and the sort's buffers (~36): LANE_BYTES with room to
# spare. A trainer's dumps add, at each depth a lane runs, its 16 planes
# and an int64 lane id, and its adjoints three [3, N] planes.
LANE_BYTES = 192
DUMP_BYTES = AUX_ROWS * 4 + 8
ADJOINT_BYTES = 36
MEMORY_SHARE = 0.5   # of the card's memory

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
WALK_KERNEL = CudaKernel("bounce", "bounce_walk_launch",
                         [_P] * 5 + [_I] * 5 + [_P])
VIS_KERNEL = CudaKernel("bounce", "bounce_vis_launch",
                        [_P] * 7 + [_I] * 11 + [_P])
SHADE_KERNEL = CudaKernel("bounce", "bounce_shade_launch",
                          [_P] * 8 + [_F] * 6 + [_I] * 11 + [_P])


def _seed32(seed: int) -> int:
    return (int(seed) + 2**31) % 2**32 - 2**31       # as int32 bits


def scene_bounds_np(scene: Scene):
    """(lo, hi) float32 [3] over the valid triangles' vertices: the box
    the sort key quantizes origins in."""
    v0, e1, e2 = (scene.numpy("tri_v0"), scene.numpy("tri_e1"),
                  scene.numpy("tri_e2"))
    valid = scene.numpy("tri_valid").astype(bool)
    pts = np.concatenate([v0[valid], (v0 + e1)[valid], (v0 + e2)[valid]])
    return pts.min(axis=0), pts.max(axis=0)


def key_scales(lo, hi, bits: int = MORTON_BITS):
    """Cells per unit length along each axis, as float32."""
    return [np.float32((1 << bits) / max(hi[a] - lo[a], 1e-20))
            for a in range(3)]


def coherence_key_planes(o, d, alive, lo, scale, bits: int = MORTON_BITS):
    """[n] int64 sort key of rays given as component tuples: dead-last |
    direction octant | origin morton (x fastest). The float -> int cast
    truncates, then clips to the grid; a dead lane gets DEAD_KEY.
    ops/reorder.coherence_key computes the same key from [n, 3] tensors
    with a divide where this multiplies by `scale`."""
    octant = ((d[0] >= 0).to(torch.int64) + 2 * (d[1] >= 0).to(torch.int64)
              + 4 * (d[2] >= 0).to(torch.int64))
    morton = torch.zeros_like(octant)
    for a in range(3):
        q = ((o[a] - float(lo[a])) * float(scale[a])).to(torch.int32)
        q = torch.clamp(q, 0, (1 << bits) - 1).to(torch.int64)
        for i in range(bits):
            morton = morton | (((q >> i) & 1) << (3 * i + a))
    key = (octant << (3 * bits)) | morton
    return torch.where(alive, key, torch.full_like(key, DEAD_KEY))


@dataclasses.dataclass
class BounceData:
    """What the three kernels read besides the wavefront: the tree and the
    bundled table of `bvh_path_device_data`, the emitter records, and the
    sort key's grid."""

    nodes: torch.Tensor        # [copies * M, 8]
    tab: torch.Tensor          # [B_pad, 32]
    em: torch.Tensor           # [n_em, 160]
    leaf_width: int
    copies: int
    lo: tuple                  # scene bounds' low corner, 3 floats
    scale: tuple               # cells per unit length, 3 floats

    @property
    def tree(self) -> TreeData:
        return TreeData.from_nodes(self.nodes, self.copies, self.leaf_width)

    def first(self, d) -> torch.Tensor | None:
        """The first node of each ray's own octant's tree copy."""
        if self.copies != 8:
            return None
        octant = ((d[0] >= 0).to(torch.int64)
                  + 2 * (d[1] >= 0).to(torch.int64)
                  + 4 * (d[2] >= 0).to(torch.int64))
        return octant * (self.nodes.shape[0] // 8)


def _check(name: str, data: BounceData, st, n: int, extra=()):
    """The kernels read raw pointers: hold every tensor to its shape,
    dtype, device and contiguity, on either device."""
    dev = data.tab.device
    N = st.shape[1] if st.dim() == 2 else -1
    check_inputs(name, dev,
                 (("nodes", data.nodes, (data.nodes.shape[0], NODE_COLS),
                   torch.float32),
                  ("tab", data.tab, (data.tab.shape[0], _COLS),
                   torch.float32),
                  ("em", data.em, (data.em.shape[0], EM_STRIDE),
                   torch.float32),
                  ("state", st, (ST_ROWS, N), torch.float32))
                 + tuple((what, x, shape, torch.float32)
                         for what, x, shape in extra))
    if data.copies not in (1, 8) or data.nodes.shape[0] % data.copies:
        raise ValueError(f"{name}: {data.copies} copies over "
                         f"{data.nodes.shape[0]} nodes")
    if not 1 <= data.em.shape[0] <= FUSED_MAX_EMITTERS:
        raise ValueError(f"{name}: {data.em.shape[0]} emitters, need 1.."
                         f"{FUSED_MAX_EMITTERS}")
    if not 0 <= n <= N:
        raise ValueError(f"{name}: a live prefix of {n} lanes in a state "
                         f"of {N}")


def _device_kind(name: str, dev) -> str:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def bounce_walk_plain(data: BounceData, st, n: int,
                      stats: dict | None = None) -> torch.Tensor:
    """hitdata [8, n] of the state's first n lanes: t (BIG on a miss), u, v,
    the global winner row, the hit flag, three zero rows. A lane that is
    not alive never walks."""
    from orion_tpu_torch.ops.bvh_traverse import lean_plain

    tree = data.tree
    s = st[:, :n]
    o = s[0:3].t().contiguous()
    d = s[3:6].t().contiguous()
    t, hit, u, v, row = lean_plain(
        tree.lo, tree.hi, tree.skip, tree.start, data.tab, o, d,
        leaf_width=tree.leaf_width, alive=s[9] > 0.0,
        first=data.first((s[3], s[4], s[5])), count=tree.per_copy,
        stats=stats)
    out = torch.zeros((HIT_ROWS, n), dtype=torch.float32, device=st.device)
    out[0], out[1], out[2], out[3] = t, u, v, row
    out[4] = hit.to(torch.float32)
    return out


def _shadow_fns(data: BounceData, stats):
    """(shadow_vis, shadow_vis2) of `_nee_plain` over the tree."""
    from orion_tpu_torch.ops.bvh_traverse import shadow_em_plain

    tree = data.tree

    def walk(so, sds, needs, mesh):
        return shadow_em_plain(
            tree.lo, tree.hi, tree.skip, tree.start, data.tab,
            data.tab[:, _C_MESH], torch.stack(so, dim=1),
            tuple(torch.stack(sd, dim=1) for sd in sds), needs, float(mesh),
            leaf_width=tree.leaf_width, cap=NEE_T_CAP,
            first=data.first(sds[0]), count=tree.per_copy, stats=stats)

    def shadow_vis(so, sd, need, mesh):
        return walk(so, (sd,), (need,), mesh)[0]

    def shadow_vis2(so, sd0, sd1, need0, need1, mesh):
        return walk(so, (sd0, sd1), (need0, need1), mesh)

    return shadow_vis, shadow_vis2


def _frame(data: BounceData, st, hitdata):
    """The lane values the vis and shade steps share, from the state's
    prefix and the walk's hit: rays, hit point, shading and geometric
    normal, the winner's attribute columns (zero for a lane that missed),
    pixel, sample and the PCG seed plane."""
    n = hitdata.shape[1]
    s = st[:, :n]
    o, d = (s[0], s[1], s[2]), (s[3], s[4], s[5])
    t, u, v, hitf = hitdata[0], hitdata[1], hitdata[2], hitdata[4]
    rows = torch.clamp(hitdata[3].to(torch.int64), 0, data.tab.shape[0] - 1)
    g = data.tab[rows] * hitf[:, None]
    h = tuple(o[k] + t * d[k] for k in range(3))
    w = 1.0 - u - v
    sn = _norm3(*(w * g[:, _C_N0 + k] + u * g[:, _C_N1 + k]
                  + v * g[:, _C_N2 + k] for k in range(3)))
    sq = torch.sqrt(g[:, 12])
    gn = tuple(g[:, 6 + k] * sq for k in range(3))
    so = tuple(h[k] + BIAS * gn[k] for k in range(3))
    return dict(s=s, o=o, d=d, hit=hitf > 0.0, hitf=hitf, g=g, rows=rows,
                h=h, sn=sn, so=so, pix=s[14].to(torch.int64),
                samp=s[15].to(torch.int64))


def bounce_vis_plain(data: BounceData, st, hitdata, seed: int, depth: int,
                     stats: dict | None = None, *, draws: bool = False,
                     light_samples: int = 2) -> torch.Tensor:
    """[8, n]: rows 0-1 the 0/1 visibility of the first emitter's two light
    samples (the draws, the gate and the dual walk of the shade step).

    draws=True walks nothing and returns the shade step's shadow rays of
    every site (site = ls + light_samples * mi) instead: [3 + 4 S, n],
    rows 0-2 the shadow origin, then for site s rows 3 + 4s .. 5 + 4s its
    direction (the sampled light point at t == 1) and row 6 + 4s its need
    flag (the lane hit and the site's geometry term is positive); zeros
    where the lane missed."""
    n = hitdata.shape[1]
    f = _frame(data, st, hitdata)
    seed_t = torch.full((n,), int(seed) & _M32, dtype=torch.int64,
                        device=st.device)
    site_sd = (f["samp"] * 131071 + depth) & _M32
    if draws:
        sites = _nee_plain(data.tab, data.em.cpu().numpy(), f["pix"], site_sd,
                           seed_t, light_samples, f["hit"], f["h"], f["sn"],
                           f["so"], legacy=False, draws_only=True)
        rows = [*f["so"]]
        for sd, need in sites:
            rows += [*sd, need.to(torch.float32)]
        out = torch.stack(rows)
        return torch.where(f["hit"], out, torch.zeros_like(out))
    _, shadow_vis2 = _shadow_fns(data, stats)
    v0, v1 = _nee_plain(data.tab, data.em[:1].cpu().numpy(), f["pix"],
                        site_sd, seed_t, 2, f["hit"], f["h"], f["sn"],
                        f["so"], legacy=False, shadow_vis2=shadow_vis2,
                        vis_only=True)
    out = torch.zeros((HIT_ROWS, n), dtype=torch.float32, device=st.device)
    out[0], out[1] = v0, v1
    return out


def bounce_shade_plain(data: BounceData, st, hitdata, seed: int, depth: int,
                       max_depth: int, light_samples: int, *, kd=None,
                       vis=None, with_aux: bool = False,
                       stats: dict | None = None, shadows=None):
    """One bounce of the estimator over the state's first n lanes:
    (new state prefix [16, n], aux [16, n] or None). `kd` [3, n] replaces
    the table's diffuse columns (a textured scene's texels); `vis` [R, n]
    replaces the shadow walks: row ls + light_samples * mi is the 0/1
    visibility of emitter mi's light sample ls (bounce_vis's planes, or a
    binned sweep's); `shadows`, a
    (shadow_vis, shadow_vis2) pair of `_nee_plain`, replaces the walks
    over the tree (the reference render's brute sweep). aux rows: kd(3),
    A(3), contribution(3), em_scale, sum_scale, winner material, hit,
    continue, 1/p, zero."""
    n = hitdata.shape[1]
    dev = st.device
    f = _frame(data, st, hitdata)
    s, o, d, g, hit, hitf = f["s"], f["o"], f["d"], f["g"], f["hit"], f["hitf"]
    hx, hy, hz = f["h"]
    snx, sny, snz = f["sn"]
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    tr, tg, tb = s[6], s[7], s[8]
    if kd is None:
        kdr, kdg, kdb = g[:, _C_KD], g[:, _C_KD + 1], g[:, _C_KD + 2]
    else:
        kdr, kdg, kdb = kd[0] * hitf, kd[1] * hitf, kd[2] * hitf

    # depth-0 emissive term: Ke * meshArea * dot(norm(d), -s_n)
    ndx, ndy, ndz = _norm3(*d)
    cosv = -(ndx * snx + ndy * sny + ndz * snz)
    em_scale = (torch.where(hit, g[:, _C_AREA] * cosv, zero) if depth == 0
                else zero)
    rr = g[:, _C_KE] * em_scale
    rg = g[:, _C_KE + 1] * em_scale
    rb = g[:, _C_KE + 2] * em_scale

    seed_t = torch.full((n,), int(seed) & _M32, dtype=torch.int64, device=dev)
    site_sd = (f["samp"] * 131071 + depth) & _M32
    shadow_vis, shadow_vis2 = shadows or _shadow_fns(data, stats)
    A, sum_scale = _nee_plain(
        data.tab, data.em.cpu().numpy(), f["pix"], site_sd, seed_t,
        light_samples, hit, f["h"], f["sn"], f["so"], legacy=False,
        shadow_vis=shadow_vis, shadow_vis2=shadow_vis2,
        vis_planes=vis)
    rr = rr + kdr * A[0]
    rg = rg + kdg * A[1]
    rb = rb + kdb * A[2]
    rad = (tr * rr * hitf, tg * rg * hitf, tb * rb * hitf)

    # Russian roulette + cosine bounce (raytracer.cpp:161-194)
    b0, b1, b2, _ = _pcg4d(f["pix"], site_sd,
                           torch.full_like(f["pix"], 0x5EED), seed_t)
    u_rr, u1, u2 = _u01(b0), _u01(b1), _u01(b2)
    p_cont = torch.maximum(torch.maximum(kdr, kdg), kdb)
    cont = hit & (u_rr <= p_cont) if depth < max_depth \
        else torch.zeros_like(hit)
    positive = p_cont > 0.0
    inv_p = torch.where(positive, 1.0 / torch.where(positive, p_cont,
                                                    torch.ones_like(p_cont)),
                        zero)
    bd = _cosine_bounce((snx, sny, snz), u1, u2)
    contf = cont.to(torch.float32)
    new_o = (torch.where(cont, hx + snx * BIAS, o[0]),
             torch.where(cont, hy + sny * BIAS, o[1]),
             torch.where(cont, hz + snz * BIAS, o[2]))
    new_d = tuple(torch.where(cont, bd[k], d[k]) for k in range(3))
    key = coherence_key_planes(new_o, new_d, cont, data.lo, data.scale)
    out = torch.stack([
        *new_o, *new_d,
        tr * kdr * inv_p * contf, tg * kdg * inv_p * contf,
        tb * kdb * inv_p * contf, contf,
        s[10] + rad[0], s[11] + rad[1], s[12] + rad[2],
        key.to(torch.float32), s[14], s[15]])
    if not with_aux:
        return out, None
    aux = torch.stack([kdr, kdg, kdb, A[0], A[1], A[2], rad[0], rad[1],
                       rad[2], em_scale, sum_scale, g[:, _C_MESH], hitf,
                       contf, inv_p, zero])
    return out, aux


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _tree_args(data: BounceData):
    return (data.nodes.shape[0] // data.copies, int(data.leaf_width),
            int(data.copies))


def bounce_walk(data: BounceData, st, n: int) -> torch.Tensor:
    """hitdata [8, n] of the live prefix: the walk kernel for CUDA tensors,
    the plain version for CPU tensors."""
    _check("bounce_walk", data, st, n)
    if _device_kind("bounce_walk", st.device) == "cpu":
        return bounce_walk_plain(data, st, n)
    hd = torch.empty((HIT_ROWS, n), dtype=torch.float32, device=st.device)
    # the persistent walk's lane counter, zero at launch
    nxt = torch.zeros((1,), dtype=torch.int32, device=st.device)
    WALK_KERNEL.launch(data.nodes.data_ptr(), data.tab.data_ptr(),
                       st.data_ptr(), hd.data_ptr(), nxt.data_ptr(),
                       *_tree_args(data), st.shape[1], n,
                       stream_ptr(st.device))
    return hd


def _check_vis(name: str, data: BounceData, light_samples: int, vis=None):
    """Visibility planes hold one row per (emitter, light sample) site; the
    standalone vis kernel (vis=None) answers one emitter's two samples."""
    sites = data.em.shape[0] * light_samples
    if vis is not None:
        if vis.shape[0] < sites:
            raise ValueError(f"{name}: {vis.shape[0]} visibility planes for "
                             f"{sites} sites")
        return
    if light_samples != 2 or data.em.shape[0] != 1:
        raise ValueError(f"{name}: the standalone visibility planes hold "
                         f"one emitter's two light samples, got "
                         f"{data.em.shape[0]} emitter(s) x {light_samples}")


def bounce_vis(data: BounceData, st, hitdata, seed: int, depth: int, *,
               draws: bool = False, light_samples: int = 2) -> torch.Tensor:
    """[8, n] visibility planes (rows 0-1) of the single emitter's two
    light samples, or with draws=True the shadow rays of every site
    ([3 + 4 * n_em * light_samples, n], bounce_vis_plain's layout): the
    vis kernel for CUDA tensors, the plain version for CPU tensors."""
    n = hitdata.shape[1] if hitdata.dim() == 2 else -1
    _check("bounce_vis", data, st, n, (("hitdata", hitdata, (HIT_ROWS, n)),))
    if draws:
        if light_samples < 1:
            raise ValueError(f"bounce_vis: {light_samples} light samples")
    else:
        _check_vis("bounce_vis", data, 2)
    if _device_kind("bounce_vis", st.device) == "cpu":
        return bounce_vis_plain(data, st, hitdata, seed, depth, draws=draws,
                                light_samples=light_samples)
    rows = 3 + 4 * data.em.shape[0] * light_samples if draws else HIT_ROWS
    out = torch.empty((rows, n), dtype=torch.float32, device=st.device)
    # the persistent vis kernel's lane counter, zero at launch (the draws
    # need none)
    nxt = None if draws else torch.zeros((1,), dtype=torch.int32,
                                         device=st.device)
    VIS_KERNEL.launch(data.nodes.data_ptr(), data.tab.data_ptr(),
                      data.em.data_ptr(), st.data_ptr(), hitdata.data_ptr(),
                      out.data_ptr(), None if draws else nxt.data_ptr(),
                      *_tree_args(data), data.tab.shape[0], data.em.shape[0],
                      st.shape[1], n, _seed32(seed), int(depth),
                      int(light_samples if draws else 2),
                      int(draws), stream_ptr(st.device))
    return out


def bounce_shade(data: BounceData, st, hitdata, seed: int, depth: int,
                 max_depth: int, light_samples: int, *, kd=None, vis=None,
                 with_aux: bool = False):
    """One bounce over the state's first n lanes, IN PLACE (lanes past n
    are left as they are); returns the aux dump [16, n] or None. The shade
    kernel for CUDA tensors, the plain version for CPU tensors."""
    n = hitdata.shape[1] if hitdata.dim() == 2 else -1
    extra = [("hitdata", hitdata, (HIT_ROWS, n))]
    if kd is not None:
        extra.append(("kd", kd, (3, n)))
    if vis is not None:
        extra.append(("vis", vis, (vis.shape[0], n)))
        _check_vis("bounce_shade", data, light_samples, vis)
    _check("bounce_shade", data, st, n, extra)
    if light_samples < 1:
        raise ValueError(f"bounce_shade: {light_samples} light samples")
    if _device_kind("bounce_shade", st.device) == "cpu":
        return _shade_plain_in_place(data, st, hitdata, seed, depth,
                                     max_depth, light_samples, kd=kd,
                                     vis=vis, with_aux=with_aux)
    aux = (torch.empty((AUX_ROWS, n), dtype=torch.float32, device=st.device)
           if with_aux else None)
    SHADE_KERNEL.launch(
        data.nodes.data_ptr(), data.tab.data_ptr(), data.em.data_ptr(),
        st.data_ptr(), hitdata.data_ptr(),
        None if kd is None else kd.data_ptr(),
        None if vis is None else vis.data_ptr(),
        None if aux is None else aux.data_ptr(),
        *(float(x) for x in data.lo), *(float(x) for x in data.scale),
        *_tree_args(data), data.tab.shape[0], data.em.shape[0], st.shape[1],
        n, _seed32(seed), int(depth), int(max_depth), int(light_samples),
        stream_ptr(st.device))
    return aux


def _shade_plain_in_place(data: BounceData, st, hitdata, seed: int,
                          depth: int, max_depth: int, light_samples: int,
                          **kw):
    """bounce_shade_plain with bounce_shade's contract: the state's live
    prefix is updated in place and the aux dump (or None) returned."""
    new, aux = bounce_shade_plain(data, st, hitdata, seed, depth, max_depth,
                                  light_samples, **kw)
    st[:, :hitdata.shape[1]] = new
    return aux


# the plain versions under the wrappers' signatures, for
# build_forward_pipeline(steps=...): the pipeline a check on the card holds
# the kernels' pipeline against
PLAIN_STEPS = (bounce_walk_plain, bounce_vis_plain, _shade_plain_in_place)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def wavefront_rays(cam, seed: int, W: int, H: int, samples: int, device, *,
                   pix_count: int | None = None, pix_base: int = 0):
    """The primary wavefront of pix_count pixels from pix_base on (default:
    the whole image), sample-major: (pix [N] int64, samp [N] int64, o, d)
    with o, d tuples of [N] planes, N = pix_count * samples. The path
    kernels' own camera and per-sample jitter streams
    (fused_path._make_primary's arithmetic, bit for bit), with the jitter
    drawn once per sample and the pixel's place once per pixel instead of
    once per lane."""
    pix_count = W * H if pix_count is None else pix_count
    pix1 = torch.arange(pix_count, dtype=torch.int64, device=device) + pix_base
    samp1 = torch.arange(samples, dtype=torch.int64, device=device)
    base_x, base_y = _pixel_base(pix1, W, H)
    jx, jy = _sample_jitter(samp1, seed, W, H)
    x = (base_x[None, :] + jx[:, None]).reshape(-1)
    y = -(base_y[None, :] + jy[:, None]).reshape(-1)
    o, d = _camera_rays([cam[k] for k in range(12)], x, y)
    return pix1.repeat(samples), samp1.repeat_interleave(pix_count), o, d


def _texel_resolver(scene: Scene, bvh: BVH):
    """`resolve(hitdata, tab) -> kd [3, n]`: the diffuse texel at each
    winner's uv where its material has a map and the lane hit, the table's
    solid kd elsewhere (nearest texel, floored-mod wrap on both axes)."""
    from orion_tpu_torch.ops.shade import _mat_tex_table

    dev = scene.device
    tex = torch.as_tensor(pack_bvh_tex_table(bvh, scene), device=dev)
    meta = _mat_tex_table(scene, scene.mat_map_diffuse)       # [M, 5]
    atlas = scene.tex_atlas

    def resolve(hitdata, tab):
        rows = torch.clamp(hitdata[3].to(torch.int64), 0, tab.shape[0] - 1)
        uvs, g = tex[rows], tab[rows]
        u, v = hitdata[1], hitdata[2]
        w = 1.0 - u - v
        uvx = w * uvs[:, 0] + u * uvs[:, 2] + v * uvs[:, 4]
        uvy = w * uvs[:, 1] + u * uvs[:, 3] + v * uvs[:, 5]
        m = meta[g[:, _C_MESH].to(torch.int64)]               # [n, 5]
        has = (m[:, 0] > 0.5) & (hitdata[4] > 0.0)
        w_i = torch.clamp(m[:, 2].to(torch.int64), min=1)
        h_i = torch.clamp(m[:, 1].to(torch.int64), min=1)
        ui = torch.remainder(torch.floor(uvx * m[:, 2]).to(torch.int64), w_i)
        vi = torch.remainder(torch.floor(uvy * m[:, 1]).to(torch.int64), h_i)
        texel = atlas[m[:, 3].to(torch.int64) + vi,
                      m[:, 4].to(torch.int64) + ui]           # [n, 3]
        return torch.where(has[None, :], texel.t(),
                           g[:, _C_KD:_C_KD + 3].t()).contiguous()

    return resolve


def _timed(timings, name: str, depth: int, n: int, fn):
    """fn(), between two CUDA events appended to `timings` as (name,
    depth, lanes, start, end) when a list is given."""
    if timings is None:
        return fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    timings.append((name, depth, n, a, b))
    return out


def bounce_lanes_supported(n_lanes: int, device, **kw) -> bool:
    """Whether bounce_lanes_check passes."""
    try:
        bounce_lanes_check(n_lanes, device, **kw)
    except ValueError:
        return False
    return True


def bounce_lanes_check(n_lanes: int, device, *, with_aux: bool = False,
                       max_depth: int = 0,
                       total_bytes: int | None = None) -> None:
    """Raise ValueError for a pipeline of `n_lanes` lanes that its int32
    indexing or the card's memory cannot hold: ST_ROWS * n_lanes >= 2^31,
    or its bytes (LANE_BYTES a lane; with_aux, a trainer's, adds
    DUMP_BYTES for each of max_depth + 1 depths and ADJOINT_BYTES) over
    MEMORY_SHARE of `total_bytes` (default: the CUDA device's memory; no
    memory limit on the CPU)."""
    if ST_ROWS * n_lanes >= 1 << 31:
        raise ValueError(f"{n_lanes} lanes: the state's int32 indexing "
                         f"holds fewer than 2^31 / {ST_ROWS}")
    dev = torch.device(device)
    if total_bytes is None and dev.type == "cuda":
        total_bytes = torch.cuda.get_device_properties(dev).total_memory
    if total_bytes is None:
        return
    per_lane = LANE_BYTES + (
        (max_depth + 1) * DUMP_BYTES + ADJOINT_BYTES if with_aux else 0)
    if n_lanes * per_lane > MEMORY_SHARE * total_bytes:
        raise ValueError(f"{n_lanes} lanes of {per_lane} bytes: more than "
                         f"{MEMORY_SHARE:g} of the card's {total_bytes} "
                         f"bytes")


def build_forward_pipeline(scene: Scene, camera, *, samples: int,
                           max_depth: int, light_samples: int = 2,
                           sort: bool = True, sort_every: int = 1,
                           with_aux: bool = False, split_vis: bool = False,
                           octant_trees: bool | None = None,
                           leaf_width: int | None = None,
                           pix_count: int | None = None,
                           textured: bool | None = None,
                           strategy: str = SAH, bvh: BVH | None = None,
                           steps: tuple | None = None):
    """The sorted-wavefront forward pass shared by the renderer and the
    closed-form trainer: (pipeline, ctx).

        pipeline(seed, tab=None, pix_base=0, record=None, timings=None)
            -> (state [16, N], dumps)

    dumps is () or, with_aux=True, a list of (aux [16, n_d], lane [n_d]
    int64) per depth: the replay planes of that depth's live prefix in ITS
    lane order, and each lane's canonical index samp * pix_count + (pix -
    pix_base). `tab` replaces the bundled table (a trainer's rebuilt
    material columns).

    sort=False runs every bounce over all lanes, unsorted. sort_every=k
    sorts and recounts only every k-th bounce; the others keep the stale
    prefix, which still covers every live lane (lanes only die).
    split_vis runs a visibility step before each shade step, which then
    walks no shadow ray: the standalone visibility kernel (one emitter, 2
    light samples; ignored otherwise), or the visibility step of `steps`,
    whose planes hold every (emitter, light sample) site (the binned
    renderer's). octant_trees / leaf_width default to one
    tree copy of leaf width 2 on a CUDA scene (what one thread per ray
    wants) and to 8 copies of width 128 on a CPU scene (the JAX package's
    defaults). pix_count builds the pipeline for a tile of that many
    pixels starting at pipeline(..., pix_base=...): per-ray streams hash
    global pixel ids, so a tile equals the whole image ray for ray.
    textured (None: when the scene has a diffuse map) resolves kd from the
    texture at every bounce. record(depth, n, st, hitdata, kd, vis) is
    called before each shade launch; timings collects (stage, depth,
    lanes, start event, end event) per stage on a CUDA scene. steps
    replaces the three wrappers (bounce_walk, bounce_vis, bounce_shade) by
    functions of their signatures: a check on the card passes PLAIN_STEPS
    to hold the kernels' pipeline against; no entry point passes it.
    Raises ValueError outside the scene gates and past bounce_lanes_check
    for pix_count * samples lanes.
    """
    if textured is None:
        textured = bool((scene.numpy("mat_map_diffuse") >= 0).any())
    if textured:
        if not bounce_textured_supported(scene):
            raise ValueError("scene outside the textured bounce gate "
                             "(emitters)")
    elif not bvh_path_supported(scene):
        raise ValueError("scene outside the bvh-path gate "
                         "(textures / emitters)")
    if sort_every < 1:
        raise ValueError(f"sort_every {sort_every}")
    H, W = camera.yres, camera.xres
    n_pix = H * W
    if n_pix >= (1 << 24):
        raise ValueError("pixel ids must stay exact in float32 (< 2^24)")
    pix_count = n_pix if pix_count is None else pix_count
    N = pix_count * samples
    dev = scene.device
    bounce_lanes_check(N, dev, with_aux=with_aux, max_depth=max_depth)
    on_card = dev.type == "cuda"
    if leaf_width is None:
        leaf_width = GPU_LEAF_WIDTH if on_card else LEAF_WIDTH
    if octant_trees is None:
        octant_trees = not on_card
    copies = 8 if octant_trees else 1

    nodes, tab0, _, bvh = bvh_path_device_data(
        scene, strategy=strategy, with_bvh=True, octants=copies,
        leaf_width=leaf_width, bvh=bvh)
    em = torch.as_tensor(pack_emitters(scene), device=dev)
    lo, hi = scene_bounds_np(scene)
    data0 = BounceData(nodes=nodes, tab=tab0, em=em, leaf_width=leaf_width,
                       copies=copies, lo=tuple(float(x) for x in lo),
                       scale=tuple(float(x) for x in key_scales(lo, hi)))
    walk, visible, shade_step = steps or (bounce_walk, bounce_vis,
                                          bounce_shade)
    split_vis = bool(split_vis)
    if visible in (bounce_vis, bounce_vis_plain):
        # the standalone vis kernel answers one emitter's two light samples
        split_vis = split_vis and light_samples == 2 and em.shape[0] == 1
    resolve = _texel_resolver(scene, bvh) if textured else None
    cam = camera_vec(camera).to(dev)

    def stage(timings, name, depth, n, fn):
        return _timed(timings if on_card else None, name, depth, n, fn)

    def shade(data, st, hd, seed, depth, **kw):
        return shade_step(data, st, hd, seed, depth, max_depth,
                          light_samples, **kw)

    def run_bounce(data, st, n, seed, depth, record, timings):
        hd = stage(timings, "walk", depth, n, lambda: walk(data, st, n))
        kd = (stage(timings, "texels", depth, n,
                    lambda: resolve(hd, data.tab)) if textured else None)
        vis = (stage(timings, "vis", depth, n,
                     lambda: visible(data, st, hd, seed, depth))
               if split_vis else None)
        if record is not None:
            record(depth, n, st, hd, kd, vis)
        lane = None
        if with_aux:
            # the riders pass through the shade step unchanged
            lane = (st[15, :n].to(torch.int64) * pix_count
                    + st[14, :n].to(torch.int64))
        aux = stage(timings, "shade", depth, n, lambda: shade(
            data, st, hd, seed, depth, kd=kd, vis=vis, with_aux=with_aux))
        return (aux, lane) if with_aux else None

    def pipeline(seed: int, tab=None, pix_base: int = 0, record=None,
                 timings=None):
        data = data0 if tab is None else dataclasses.replace(data0, tab=tab)

        def primaries():
            pix, samp, o, d = wavefront_rays(cam, seed, W, H, samples, dev,
                                             pix_count=pix_count,
                                             pix_base=pix_base)
            st = torch.zeros((ST_ROWS, N), dtype=torch.float32, device=dev)
            for k in range(3):
                st[k], st[3 + k] = o[k], d[k]
            st[6:10] = 1.0
            st[14], st[15] = pix.to(torch.float32), samp.to(torch.float32)
            return st

        st = stage(timings, "primaries", 0, N, primaries)
        dumps = []

        def bounce(n, depth):
            out = run_bounce(data, st, n, seed, depth, record, timings)
            if with_aux:
                aux, lane = out
                dumps.append((aux, lane - pix_base))

        # depth 0: every lane is live and every key is 0, so no sort
        bounce(N, 0)
        n = N
        for depth in range(1, max_depth + 1):
            if sort and (depth - 1) % sort_every == 0:
                def sort_prefix(n=n):
                    perm = torch.argsort(st[13, :n].to(torch.int32),
                                         stable=True)
                    st[:, :n] = st[:, :n].index_select(1, perm)
                    return int((st[9, :n] > 0.0).sum())
                n = stage(timings, "sort", depth, n, sort_prefix)
            if n == 0:
                break
            bounce(n, depth)
        return st, dumps if with_aux else ()

    ctx = dict(H=H, W=W, n_pix=n_pix, pix_count=pix_count, N=N, data=data0,
               bvh=bvh, cam=cam, split_vis=split_vis, textured=textured,
               samples=samples, max_depth=max_depth,
               light_samples=light_samples)
    return pipeline, ctx


def lane_radiance(st, pix_count: int, pix_base: int = 0) -> torch.Tensor:
    """[3, samples, pix_count]: each lane's accumulated radiance (state
    rows 10-12) at its canonical place samp * pix_count + (pix - pix_base),
    whatever order the sort left the lanes in. Lane ids are unique, so
    this is a permutation and gives the same bits on every run."""
    N = st.shape[1]
    lane = (st[15].to(torch.int64) * pix_count
            + (st[14].to(torch.int64) - pix_base))
    out = torch.empty((3, N), dtype=torch.float32, device=st.device)
    out[:, lane] = st[10:13]
    return out.reshape(3, N // pix_count, pix_count)


def state_image(st, pix_count: int, samples: int,
                pix_base: int = 0) -> torch.Tensor:
    """[pix_count, 3] radiance / spp: each pixel's samples added in sample
    order."""
    planes = lane_radiance(st, pix_count, pix_base)
    img = planes[:, 0].clone()
    for s in range(1, samples):
        img += planes[:, s]
    return (img * _f32(1.0 / samples, st.device)).t().contiguous()


def make_bounce_path_renderer(scene: Scene, camera, *, samples: int,
                              max_depth: int, light_samples: int = 2,
                              **options):
    """Build `fn(seed: int) -> [H, W, 3]`: sorted-wavefront path tracing on
    the scene's device (walk, shade and optionally vis kernel per bounce;
    their plain versions on the CPU). `options` are
    build_forward_pipeline's. Same gate as the BVH path kernel, plus
    diffuse textures; ValueError past bounce_lanes_check (too many lanes
    for the kernels' int32 indexing or the card's memory). `fn.pipeline`
    / `fn.ctx` expose the pipeline."""
    pipeline, ctx = build_forward_pipeline(
        scene, camera, samples=samples, max_depth=max_depth,
        light_samples=light_samples, **options)
    H, W, pc = ctx["H"], ctx["W"], ctx["pix_count"]
    if pc != H * W:
        raise ValueError("a renderer covers the whole image; tiles go "
                         "through build_forward_pipeline")

    def render_bounce(seed: int, **kw) -> torch.Tensor:
        timings = kw.get("timings") if scene.device.type == "cuda" else None
        with torch.no_grad():
            st, _ = pipeline(seed, **kw)
            return _timed(timings, "image", 0, st.shape[1],
                          lambda: state_image(st, pc, samples)
                          ).reshape(H, W, 3)

    render_bounce.pipeline, render_bounce.ctx = pipeline, ctx
    return render_bounce


def bounce_reference_render(scene: Scene, camera, seed: int, *, samples: int,
                            max_depth: int,
                            light_samples: int = 2) -> torch.Tensor:
    """The same estimator in plain PyTorch over a brute sweep of the
    bundled table (SAH tree of leaf width 128), unsorted: [H, W, 3]. A
    lane's result does not depend on its place in the wavefront, so this
    equals the pipeline's image up to nearest-hit ties."""
    H, W = camera.yres, camera.xres
    dev = scene.device
    bvh, _ = build_bvh(scene.numpy("tri_v0"), scene.numpy("tri_e1"),
                       scene.numpy("tri_e2"), scene.numpy("tri_valid"),
                       strategy=SAH, leaf_size=LEAF_WIDTH,
                       leaf_width=LEAF_WIDTH)
    tab = torch.as_tensor(pack_bvh_path_table(bvh, scene), device=dev)
    em = torch.as_tensor(pack_emitters(scene), device=dev)
    lo, hi = scene_bounds_np(scene)
    # a one-node "tree" is never walked: the sweeps below test every row
    data = BounceData(nodes=torch.zeros((1, NODE_COLS), device=dev), tab=tab,
                      em=em, leaf_width=LEAF_WIDTH, copies=1,
                      lo=tuple(float(x) for x in lo),
                      scale=tuple(float(x) for x in key_scales(lo, hi)))
    cam = camera_vec(camera).to(dev)
    pix, samp, o, d = wavefront_rays(cam, seed, W, H, samples, dev)
    N = pix.shape[0]
    st = torch.zeros((ST_ROWS, N), dtype=torch.float32, device=dev)
    for k in range(3):
        st[k], st[3 + k] = o[k], d[k]
    st[6:10] = 1.0
    st[14], st[15] = pix.to(torch.float32), samp.to(torch.float32)
    woop = tab[:, :13]
    mesh_col = tab[:, _C_MESH]

    def sweep_vis(so, sd, need, mesh):
        lanes = torch.nonzero(need).flatten()
        _, row = nearest_rows(woop, torch.stack(so, dim=1)[lanes],
                              torch.stack(sd, dim=1)[lanes], cap=NEE_T_CAP)
        vis = torch.zeros((N,), dtype=torch.bool, device=dev)
        vis[lanes] = (row >= 0) & (mesh_col[torch.clamp(row, min=0)]
                                   == float(mesh))
        return vis

    with torch.no_grad():
        for depth in range(max_depth + 1):
            alive = st[9] > 0.0
            t, row = nearest_rows(woop, st[0:3].t().contiguous(),
                                  st[3:6].t().contiguous())
            hit = (row >= 0) & alive
            hd = torch.zeros((HIT_ROWS, N), dtype=torch.float32, device=dev)
            hd[0] = torch.where(hit, t, torch.full_like(t, BIG))
            hd[3] = torch.where(hit, row, torch.zeros_like(row)).float()
            hd[4] = hit.float()
            g = woop[torch.clamp(row, min=0)]
            _, u, v = woop_tuv((st[0], st[1], st[2]), (st[3], st[4], st[5]),
                               tuple(g[:, k] for k in range(13)))
            hd[1], hd[2] = u * hd[4], v * hd[4]
            st, _ = bounce_shade_plain(data, st, hd, seed, depth, max_depth,
                                       light_samples,
                                       shadows=(sweep_vis, None))
        return state_image(st, H * W, samples).reshape(H, W, 3)
