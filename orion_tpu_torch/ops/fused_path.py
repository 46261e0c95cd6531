"""The regenerative path-tracing megakernel: CUDA wrapper + plain version.

Replaces `orion_tpu.ops.pallas_fused` (the Pallas `_make_kernel`): the
whole path tracer — PCG4D-jittered primary rays, Woop nearest-hit sweeps,
depth-0 emission, fast-shadow next-event estimation over <= 8 emissive
meshes of <= 8 triangles, Russian roulette, cosine bounce and regeneration
onto the next sample — in one launch, persistent threads that each render
one pixel's samples and then take the next pixel. The kernel is
`csrc/fused_path.cu`; `fused_path_plain` computes the same
estimator batched over all lanes in PyTorch, run as a fixed
samples * (max_depth + 1) steps (a lane past its last sample idles).

`fused_path` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.

Estimator: the reference's (raytracer.cpp:105-194) with NEE per PARITY.md,
the fast-shadow form of the TPU kernel (the light normal and emitted color
come from the sampled emitter triangle's constants; visibility asks only
whether the nearest hit below NEE_T_CAP lies on the sampled mesh). The
random numbers are the TPU kernel's PCG4D hashes of (pixel, sample, depth,
site); `seed` is the int32 PCG seed itself (the JAX package derives it
from a threefry key in `seed_scalar`), so one `--seed` gives a different
but equally valid stream in the two packages.

Emitter constants are computed on the host in float32 NumPy exactly as the
JAX package computes them (area = 0.5*|e1 x e2|, weight = area * count) and
passed to the kernel as a small device array, not compiled in.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from orion_tpu_torch.ops.cuda_build import (CudaKernel, check_inputs,
                                            stream_ptr)
from orion_tpu_torch.ops.woop import BIG, nearest_rows, woop_rows_np, woop_tuv
from orion_tpu_torch.profiling import span
from orion_tpu_torch.scene import Scene

FUSED_CHUNK = 512             # rows per chunk of a chunked sweep
FUSED_MAX_TRIS = 16384        # gate: padded table rows (128 B/row, 2 MB)
FUSED_MAX_EMITTER_TRIS = 8    # triangles per emissive mesh
FUSED_MAX_EMITTERS = 8        # emissive meshes
BIAS = 1e-3                   # raytracer.cpp:118
NEE_T_CAP = 1.05              # shadow-segment cap (sample point at t == 1)

# triangle-table column map ([T_pad, 32] rows): 13-float Woop transform,
# corner normals, kd, ke, mesh area, mesh id
_C_WOOP = 0
_C_N0, _C_N1, _C_N2 = 13, 16, 19
_C_KD, _C_KE = 22, 25
_C_AREA, _C_MESH = 28, 29

# emitter record: [mesh, count, ke(3), 0, 0, 0] + per triangle
# v0(3) e1(3) e2(3) weight n0(3) n1(3) n2(3)
EM_HEADER = 8
EM_TRI = 19
EM_STRIDE = EM_HEADER + FUSED_MAX_EMITTER_TRIS * EM_TRI   # 160

MAX_SAMPLES = 32              # per-sample radiance planes (training forward)

_M32 = 0xFFFFFFFF

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("fused_path", "fused_path_launch",
                    [_P] * 7 + [_I] * 11 + [_P])


def _fused_t_pad(T: int) -> int:
    """Table row padding: multiples of 8 while one chunk suffices;
    multiples of FUSED_CHUNK once the sweep is chunked."""
    T_pad = ((max(T, 8) + 7) // 8) * 8
    if T_pad > FUSED_CHUNK:
        T_pad = ((T_pad + FUSED_CHUNK - 1) // FUSED_CHUNK) * FUSED_CHUNK
    return T_pad


def pack_fused_tri_table(scene: Scene) -> np.ndarray:
    """Host-side [T_pad, 32] table: geometry + shading + emitter columns.
    Geometry is the Woop transform precomputed in float64; padding rows
    carry the always-miss transform."""
    T = int(scene.num_triangles)
    T_pad = _fused_t_pad(T)
    tab = np.zeros((T_pad, 32), np.float32)

    v0 = scene.numpy("tri_v0")[:T]
    e1 = scene.numpy("tri_e1")[:T]
    e2 = scene.numpy("tri_e2")[:T]
    tab[:T, _C_WOOP:_C_WOOP + 13] = woop_rows_np(v0, e1, e2)
    tab[T:, _C_WOOP + 11] = 1.0   # padding: c_w = 1, d'_w = 0 => miss
    tab[:T, _C_N0:_C_N0 + 3] = scene.numpy("n0")[:T]
    tab[:T, _C_N1:_C_N1 + 3] = scene.numpy("n1")[:T]
    tab[:T, _C_N2:_C_N2 + 3] = scene.numpy("n2")[:T]

    mat = scene.numpy("tri_mat")[:T]
    tab[:T, _C_KD:_C_KD + 3] = scene.numpy("mat_diffuse")[mat]
    tab[:T, _C_KE:_C_KE + 3] = scene.numpy("mat_emissive")[mat]
    tab[:T, _C_AREA] = scene.numpy("mesh_area")[mat]
    tab[:T, _C_MESH] = mat.astype(np.float32)
    return tab


def fused_chunk_bounds(scene: Scene):
    """Per-FUSED_CHUNK AABBs of the table's row order: (lo, hi [n, 3]).
    Padding rows anchor at the last real vertex so tails stay tight."""
    T = int(scene.num_triangles)
    T_pad = _fused_t_pad(T)
    v0 = scene.numpy("tri_v0")[:T]
    e1 = scene.numpy("tri_e1")[:T]
    e2 = scene.numpy("tri_e2")[:T]
    n = max(T_pad // FUSED_CHUNK, 1)
    pts = np.empty((T_pad, 3, 3), np.float32)
    pts[:T, 0] = v0
    pts[:T, 1] = v0 + e1
    pts[:T, 2] = v0 + e2
    if T_pad > T and T > 0:
        pts[T:] = pts[T - 1, 0]
    pts = pts.reshape(n, -1, 3)
    return (pts.min(axis=1).astype(np.float32),
            pts.max(axis=1).astype(np.float32))


def _emitter_consts(scene: Scene, index: int = 0):
    """Host constants of one emissive mesh's triangles:
    (mesh, count, v0, e1, e2, weight, n0, n1, n2, ke)."""
    em = int(scene.numpy("emissive_mesh_ids")[index])
    start = int(scene.numpy("mesh_tri_start")[em])
    count = int(scene.numpy("mesh_tri_count")[em])
    sl = slice(start, start + count)
    v0 = scene.numpy("tri_v0")[sl]
    e1 = scene.numpy("tri_e1")[sl]
    e2 = scene.numpy("tri_e2")[sl]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    # sample weight == triArea * triCount (mesh.hpp:178-184 importance bias)
    weight = area * count
    return (em, count, v0, e1, e2, weight, scene.numpy("n0")[sl],
            scene.numpy("n1")[sl], scene.numpy("n2")[sl],
            scene.numpy("mat_emissive")[em])


def _emitters_consts(scene: Scene):
    """All emissive meshes' constants (the reference's NEE loops every
    emissive mesh, raytracer.cpp:133-159)."""
    return [_emitter_consts(scene, i) for i in range(scene.num_emissive)]


def pack_emitters(scene: Scene) -> np.ndarray:
    """[n_em, EM_STRIDE] float32 emitter records (layout above)."""
    consts = _emitters_consts(scene)
    out = np.zeros((len(consts), EM_STRIDE), np.float32)
    for i, (em, count, v0, e1, e2, weight, n0, n1, n2, ke) in enumerate(consts):
        out[i, 0] = em
        out[i, 1] = count
        out[i, 2:5] = ke
        tri = np.concatenate([v0, e1, e2, np.asarray(weight)[:, None],
                              n0, n1, n2], axis=1).astype(np.float32)
        out[i, EM_HEADER:EM_HEADER + count * EM_TRI] = tri.reshape(-1)
    return out


def fused_path_supported(scene: Scene) -> bool:
    """Gate: untextured, 1..8 emissive meshes of <= 8 triangles, padded
    table within FUSED_MAX_TRIS."""
    from orion_tpu_torch.ops.bvh_path import bvh_path_supported

    return (_fused_t_pad(int(scene.num_triangles)) <= FUSED_MAX_TRIS
            and bvh_path_supported(scene))


def camera_vec(camera) -> torch.Tensor:
    """[12] float32: origin | front | right | up (the kernel's camera)."""
    return torch.cat([camera.origin, camera.front, camera.right,
                      camera.up]).to(torch.float32).contiguous()


def override_camera_vec(camera_override, W: int, H: int, device):
    """The [12] camera tensor of a renderer's `camera_override` on `device`:
    a camera of the build camera's W x H, or ValueError (the renderer's
    lane count and pixel steps are the build camera's)."""
    if (camera_override.xres, camera_override.yres) != (W, H):
        raise ValueError(f"camera_override is {camera_override.xres}x"
                         f"{camera_override.yres}; the renderer was built "
                         f"for {W}x{H}")
    return camera_vec(camera_override).to(device)


def fused_args(scene: Scene, camera):
    """(tab, clo, chi, em, cam): the path kernels' tensors on the scene's
    device."""
    dev = scene.device
    lo, hi = fused_chunk_bounds(scene)
    return (torch.as_tensor(pack_fused_tri_table(scene), device=dev),
            torch.as_tensor(lo, device=dev).contiguous(),
            torch.as_tensor(hi, device=dev).contiguous(),
            torch.as_tensor(pack_emitters(scene), device=dev),
            camera_vec(camera).to(dev))


def check_tables(name: str, tab, clo, chi, cam, cols: int, extra=()):
    """Raise ValueError unless the kernel inputs are contiguous float32 on
    tab's device with the shapes a kernel reads: tab [T_pad, cols], one
    chunk AABB per FUSED_CHUNK rows of a chunked table, cam [12], and each
    (what, tensor, shape) of `extra`."""
    T_pad, n_chunks = tab.shape[0], clo.shape[0]
    check_inputs(name, tab.device,
                 [(what, x, shape, torch.float32) for what, x, shape in
                  (("tab", tab, (T_pad, cols)), ("clo", clo, (n_chunks, 3)),
                   ("chi", chi, (n_chunks, 3)), ("cam", cam, (12,)))
                  + tuple(extra)])
    if T_pad > FUSED_CHUNK and (T_pad % FUSED_CHUNK
                                or n_chunks != T_pad // FUSED_CHUNK):
        raise ValueError(f"{name}: chunked tables need T_pad a multiple of "
                         f"{FUSED_CHUNK} and one AABB per chunk")


def lane_tile(name: str, W: int, H: int, pix_base: int,
              n_lanes: int | None) -> int:
    """The lanes of a launch over the pixels [pix_base, pix_base +
    n_lanes) (default: to the end of the image); ValueError for a tile
    outside the W x H image."""
    n = W * H - pix_base if n_lanes is None else n_lanes
    if pix_base < 0 or n < 0 or pix_base + n > W * H:
        raise ValueError(f"{name}: lanes [{pix_base}, {pix_base + n}) "
                         f"outside the {W}x{H} image")
    return n


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, y) -> torch.Tensor:
    """(x * y) mod 2^32 for uint32 values held in int64, without int64
    overflow: split x into 16-bit halves."""
    lo = (x & 0xFFFF) * y
    hi = (((x >> 16) * y) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _pcg4d(a, b, c, d):
    """PCG4D hash (Jarzynski & Olano, JCGT 2020) on uint32 values held in
    int64 tensors: wrapping multiplies and adds (masked to 32 bits after
    each) and logical shifts, bit-for-bit the TPU kernel's int32 planes."""
    a, b, c, d = (x & _M32 for x in (a, b, c, d))
    a = (_mul32(a, 1664525) + 1013904223) & _M32
    b = (_mul32(b, 1664525) + 1013904223) & _M32
    c = (_mul32(c, 1664525) + 1013904223) & _M32
    d = (_mul32(d, 1664525) + 1013904223) & _M32
    for shift in (True, False):
        a = (a + _mul32(b, d)) & _M32
        b = (b + _mul32(c, a)) & _M32
        c = (c + _mul32(a, b)) & _M32
        d = (d + _mul32(b, c)) & _M32
        if shift:
            a = a ^ (a >> 16)
            b = b ^ (b >> 16)
            c = c ^ (c >> 16)
            d = d ^ (d >> 16)
    return a, b, c, d


def _u01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (int64-held) -> uniform [0, 1) from the low 24 bits."""
    return (bits & 0xFFFFFF).to(torch.float32) * (1.0 / 16777216.0)


def _norm3(x, y, z):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
    return x * inv, y * inv, z * inv


def _f32(x: float, dev) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=torch.float32, device=dev)


def _sample_jitter(samp, seed: int, W: int, H: int):
    """(jx, jy): the sub-pixel offsets of sample indices `samp`, one PCG4D
    draw per sample shared by every pixel."""
    dev = samp.device
    seed_t = torch.full_like(samp, int(seed) & _M32)
    jb0, jb1, _, _ = _pcg4d(samp, seed_t, torch.full_like(samp, 0x4A17),
                            torch.full_like(samp, 0x7E57))
    return _u01(jb0) * _f32(2.0 / W, dev), _u01(jb1) * _f32(2.0 / H, dev)


def _pixel_base(pix, W: int, H: int):
    """(x, y) of pixels `pix` on the image plane before jitter and before
    y's sign flip: 2 * column / W - 1 and 2 * row / H - 1."""
    dev = pix.device
    pix_f = pix.to(torch.float32)
    inv_w, inv_h = _f32(1.0 / W, dev), _f32(1.0 / H, dev)
    i = torch.floor((pix_f + 0.5) * inv_w)              # image row
    j = pix_f - i * float(W)                            # image column
    return 2.0 * (j * inv_w) - 1.0, 2.0 * (i * inv_h) - 1.0


def _camera_rays(cam, x, y):
    """(o, d) tuples of planes shaped like x: rays through image-plane
    points (x, y) of the 12-float camera `cam`."""
    d = tuple(cam[3 + k] + x * cam[6 + k] + y * cam[9 + k] for k in range(3))
    o = tuple(cam[k].expand(x.shape) for k in range(3))
    return o, d


def _make_primary(cam, seed: int, W: int, H: int, dev, pix=None):
    """`primary(samp) -> (o, d)`: the kernels' camera rays of the lanes
    `pix` (default: all W*H pixels), (x, y, z) tuples of [n] tensors, for
    per-lane sample indices `samp`, one PCG4D jitter per sample shared by
    every pixel."""
    if pix is None:
        pix = torch.arange(W * H, dtype=torch.int64, device=dev)
    cam = [cam[k] for k in range(12)]
    base_x, base_y = _pixel_base(pix, W, H)

    def primary(samp):
        jx, jy = _sample_jitter(samp, seed, W, H)
        return _camera_rays(cam, base_x + jx, -(base_y + jy))

    return primary


def _cosine_bounce(sn, u1, u2):
    """Cosine-weighted direction about the unit normal `sn` from two
    uniforms: tangent frame from cross(n, (0, 1, 0)), falling back to
    cross(n, (0, 0, 1)), normalized (raytracer.cpp:173-192)."""
    snx, sny, snz = sn
    zero = torch.zeros_like(snx)
    two_pi = _f32(2.0 * np.pi, snx.device)
    sin_th = torch.sqrt(u1)
    cos_th = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    psi = u2 * two_pi
    t1x, t1y, t1z = snz, zero, -snx
    deg = (t1x * t1x + t1z * t1z) == 0.0
    t1x = torch.where(deg, -sny, t1x)
    t1y = torch.where(deg, snx, t1y)
    t1x, t1y, t1z = _norm3(t1x, t1y, t1z)
    btx = sny * t1z - snz * t1y
    bty = snz * t1x - snx * t1z
    btz = snx * t1y - sny * t1x
    ca = sin_th * torch.cos(psi)
    cb = sin_th * torch.sin(psi)
    return (ca * t1x + cb * btx + cos_th * snx,
            ca * t1y + cb * bty + cos_th * sny,
            ca * t1z + cb * btz + cos_th * snz)


def _nee_plain(tab, em_np, pix, site_sd, seed_t, light_samples: int, gate,
               h, sn, so, *, legacy: bool, shadow_rows=None, shadow_vis=None,
               shadow_vis2=None, vis_planes=None, vis_only: bool = False,
               draws_only: bool = False):
    """Next-event estimation of every lane at hit point `h` (shading
    normal `sn`, shadow origin `so`): (A, sum_scale), A the NEE radiance
    without the surface kd and sum_scale the sum of the samples' scales.
    Only lanes in `gate` (hit and still running) can contribute.

    legacy=True: `shadow_rows(so, sd, need) -> row` walks every gated lane;
    the light normal and emitted color are the shadow winner's, read from
    `tab`. legacy=False (fast shadow): light normal and emitted color come
    from the sampled emitter triangle, lanes whose geometry term is <= 0
    never walk, and `shadow_vis(so, sd, need, mesh) -> bool` asks whether
    the nearest hit below NEE_T_CAP lies on the sampled mesh. With two
    light samples `shadow_vis2(so, sd0, sd1, need0, need1, mesh)` answers
    both in one walk, or `vis_planes` (0/1 planes computed earlier, one
    per site, indexed by site) replaces the walks; vis_only=True returns
    the first emitter's pair of visibility planes instead (float32 0/1).
    draws_only=True returns each site's shadow ray instead, a list of
    (sd, need) in site order: the direction to the sampled light point
    (unnormalized, the point at t == 1) and whether the lane asks for its
    visibility. A site is ls + light_samples * mi; its PCG4D draws are the
    TPU kernel's: (pixel, sample * 131071 + depth, 0x11 + 0x101 * site,
    seed).
    """
    dev = tab.device
    n = pix.shape[0]
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    inv_ls = _f32(1.0 / light_samples, dev)
    hx, hy, hz = h
    snx, sny, snz = sn
    A = [zero, zero, zero]
    sum_scale = zero
    sites = []
    for mi in range(em_np.shape[0]):
        rec = em_np[mi]
        count = int(rec[1])
        tris = torch.as_tensor(
            rec[EM_HEADER:EM_HEADER + count * EM_TRI].reshape(count, EM_TRI),
            device=dev)
        draws = []
        for ls in range(light_samples):
            site = ls + light_samples * mi
            u0_, u1_, u2_, _ = _pcg4d(pix, site_sd,
                                      torch.full_like(pix,
                                                      0x11 + 0x101 * site),
                                      seed_t)
            ut, ua, ub = _u01(u0_), _u01(u1_), _u01(u2_)
            sel = torch.clamp((ut * float(count)).to(torch.int64),
                              max=count - 1)
            L = tris[sel]
            flip = (ua + ub) > 1.0
            a = torch.where(flip, 1.0 - ua, ua)
            b = torch.where(flip, 1.0 - ub, ub)
            sd = tuple(L[:, k] + a * L[:, 3 + k] + b * L[:, 6 + k] - hk
                       for k, hk in enumerate((hx, hy, hz)))
            ldx, ldy, ldz = _norm3(*sd)
            cos_s = snx * ldx + sny * ldy + snz * ldz
            d2 = sd[0] * sd[0] + sd[1] * sd[1] + sd[2] * sd[2]
            if legacy:
                # the shadow sweep carries the winner's attributes
                srow = shadow_rows(so, sd, gate)
                gs = tab[torch.clamp(srow, min=0)]
                g13 = gs[:, :13].detach()
                _, su, sv = woop_tuv(so, sd, tuple(g13[:, k]
                                                   for k in range(13)))
                sw = 1.0 - su - sv
                lnx, lny, lnz = _norm3(*(sw * gs[:, _C_N0 + k]
                                         + su * gs[:, _C_N1 + k]
                                         + sv * gs[:, _C_N2 + k]
                                         for k in range(3)))
                cos_l = -(lnx * ldx + lny * ldy + lnz * ldz)
                geom = torch.clamp(cos_s * cos_l, min=0.0)
                vis = (srow >= 0) & gate & (gs[:, _C_MESH] == float(rec[0]))
                ske = [gs[:, _C_KE + k] for k in range(3)]
                scale = torch.where(vis, geom * L[:, 9] / (1.0 + d2) * inv_ls,
                                    zero)
                A = [A[k] + ske[k] * scale for k in range(3)]
                sum_scale = sum_scale + scale
                continue
            lw = 1.0 - a - b
            lnx, lny, lnz = _norm3(*(lw * L[:, 10 + k] + a * L[:, 13 + k]
                                     + b * L[:, 16 + k] for k in range(3)))
            cos_l = -(lnx * ldx + lny * ldy + lnz * ldz)
            geom = cos_s * cos_l
            draws.append((sd, gate & (geom > 0.0),
                          geom * L[:, 9] / (1.0 + d2) * inv_ls))
        if legacy:
            continue
        if draws_only:
            sites += [(sd, need) for sd, need, _ in draws]
            continue
        if vis_planes is not None:
            vis2 = [vis_planes[ls + light_samples * mi] > 0.0
                    for ls in range(light_samples)]
        elif light_samples == 2 and shadow_vis2 is not None:
            vis2 = shadow_vis2(so, draws[0][0], draws[1][0], draws[0][1],
                               draws[1][1], rec[0])
            if vis_only:
                return tuple(v.to(torch.float32) for v in vis2)
        else:
            vis2 = [shadow_vis(so, sd, need, rec[0])
                    for sd, need, _ in draws]
        ske = [float(rec[2 + k]) for k in range(3)]
        for (_, _, full), vis in zip(draws, vis2):
            scale = torch.where(vis, full, zero)
            A = [A[k] + ske[k] * scale for k in range(3)]
            sum_scale = sum_scale + scale
    if draws_only:
        return sites
    return A, sum_scale


def _regen_steps(tab, em, cam, seed: int, W: int, H: int, samples: int,
                 max_depth: int, light_samples: int, *, legacy: bool,
                 stats: dict | None = None, tree=None, pix_base: int = 0,
                 n_lanes: int | None = None):
    """The estimator of the path kernels, batched over all W*H lanes and
    run as a fixed samples * (max_depth + 1) steps (a lane past its last
    sample idles with zero throughput).

    A generator: each step yields a dict of that step's values (the lane's
    sample and throughput before the bounce, the hit, the winner's kd and
    material, the NEE sums A and sum(scale), the depth-0 emission scale,
    the contribution T * r added to the lane's radiance, the RR
    probability and decision, the lane's next sample) and then advances
    the lanes. The forward consumers sum `contrib`; the replay consumer
    re-runs the same steps, so both see the identical floats.

    legacy=False is the fast-shadow NEE of the render kernel (light normal
    and emitted color from the sampled emitter triangle; visibility asks
    whether the nearest hit below NEE_T_CAP lies on the sampled mesh).
    legacy=True is the NEE of the training kernels (pallas_fused.py
    `_make_nee` with fast_shadow=False): the shadow sweep runs on every
    hit lane, the light normal is interpolated at the shadow winner's
    (u, v) from the winner's corner normals and the emitted color is the
    winner's ke, both read from `tab`, so d/d(ke) stays live.

    Differentiable with respect to the material columns of `tab` (the
    Woop columns are read detached). stats["tests"] counts the Woop tests
    of the sweeps the kernels run without chunk culling, over lanes still
    inside their samples and real rows only.

    tree: None sweeps every row of `tab`; a `bvh_path.TreeData` replaces
    each sweep by the skip-pointer walk of the BVH path kernel over the
    bundled `tab` (ops/bvh_traverse.walk_plain), and stats then counts the
    walks' own work: "tests" (Woop tests of real rows in visited leaves)
    and "box_tests" (nodes visited). pix_base / n_lanes restrict the run
    to the lanes [pix_base, pix_base + n_lanes): a tile computes the same
    pixels as the whole image.
    """
    dev = tab.device
    n = W * H - pix_base if n_lanes is None else n_lanes
    S = samples
    woop = tab[:, :13].detach()
    em_np = em.detach().cpu().numpy()
    seed_t = torch.full((n,), int(seed) & _M32, dtype=torch.int64, device=dev)
    pix = torch.arange(n, dtype=torch.int64, device=dev) + pix_base
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    primary = _make_primary(cam, seed, W, H, dev, pix)

    def nearest(o, d, cap, lanes=None):
        """(t, row) with row -1 where nothing is hit below cap."""
        oo = torch.stack(o, dim=1)
        dd = torch.stack(d, dim=1)
        if lanes is not None:
            oo, dd = oo[lanes], dd[lanes]
        if tree is None:
            return nearest_rows(woop, oo, dd, cap=cap)
        return tree.nearest(woop, oo, dd, cap, stats)

    def winner_tuv(o, d, row):
        """(t, u, v) of each lane's ray against its winner row."""
        g = woop[torch.clamp(row, min=0)]
        return woop_tuv(o, d, tuple(g[:, k] for k in range(13)))

    def shadow_rows(so, sd, need):
        """Legacy NEE: the shadow segment's winner row of the lanes in
        `need`, -1 elsewhere."""
        nonlocal tests
        lanes = torch.nonzero(need).flatten()
        if tree is None:
            tests += lanes.numel() * n_real
        _, srow_l = nearest(so, sd, NEE_T_CAP, lanes)
        srow = torch.full((n,), -1, dtype=torch.int64, device=dev)
        srow[lanes] = srow_l
        return srow

    def shadow_vis(so, sd, need, mesh):
        """Fast-shadow NEE: does the nearest hit below NEE_T_CAP lie on
        `mesh`? Only the lanes in `need` walk."""
        nonlocal tests
        lanes = torch.nonzero(need).flatten()
        if tree is None:
            tests += lanes.numel() * n_real
        _, srow = nearest(so, sd, NEE_T_CAP, lanes)
        vis_l = (srow >= 0) & (tab[torch.clamp(srow, min=0), _C_MESH]
                               == float(mesh))
        vis = torch.zeros((n,), dtype=torch.bool, device=dev)
        vis[lanes] = vis_l
        return vis

    samp = torch.zeros((n,), dtype=torch.int64, device=dev)
    depth = torch.zeros((n,), dtype=torch.int64, device=dev)
    o, d = primary(samp)
    one = torch.ones((n,), dtype=torch.float32, device=dev)
    tr, tg, tb = one, one, one

    pad_row = torch.zeros((13,), dtype=torch.float32, device=dev)
    pad_row[_C_WOOP + 11] = 1.0
    n_real = int((woop != pad_row).any(dim=1).sum())
    tests = 0
    for _ in range(samples * (max_depth + 1)):
        active = samp < S
        if tree is None:
            if stats is not None:
                tests += int(active.sum()) * n_real
            t, row = nearest(o, d, BIG)
        else:
            # the walk's work depends on the ray: walk the active lanes only
            lanes = torch.nonzero(active).flatten()
            t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
            row = torch.full((n,), -1, dtype=torch.int64, device=dev)
            t[lanes], row[lanes] = nearest(o, d, BIG, lanes)
        hit = row >= 0
        g = tab[torch.clamp(row, min=0)]                    # winner rows
        _, u, v = winner_tuv(o, d, row)
        hx, hy, hz = (o[k] + t * d[k] for k in range(3))
        w = 1.0 - u - v
        snx, sny, snz = _norm3(*(w * g[:, _C_N0 + k] + u * g[:, _C_N1 + k]
                                 + v * g[:, _C_N2 + k] for k in range(3)))
        s = torch.sqrt(g[:, 12].detach())
        gnx, gny, gnz = (g[:, 6 + k].detach() * s for k in range(3))
        kdr, kdg, kdb = g[:, _C_KD], g[:, _C_KD + 1], g[:, _C_KD + 2]

        # depth-0 emissive term: Ke * meshArea * dot(norm(d), -s_n)
        ndx, ndy, ndz = _norm3(*d)
        cosv = -(ndx * snx + ndy * sny + ndz * snz)
        em_scale = torch.where((depth == 0) & hit, g[:, _C_AREA] * cosv, zero)
        rr = g[:, _C_KE] * em_scale
        rg = g[:, _C_KE + 1] * em_scale
        rb = g[:, _C_KE + 2] * em_scale

        # next-event estimation
        so = (hx + BIAS * gnx, hy + BIAS * gny, hz + BIAS * gnz)
        site_sd = (samp * 131071 + depth) & _M32
        A, sum_scale = _nee_plain(
            tab, em_np, pix, site_sd, seed_t, light_samples, hit & active,
            (hx, hy, hz), (snx, sny, snz), so, legacy=legacy,
            shadow_rows=shadow_rows, shadow_vis=shadow_vis)
        rr = rr + kdr * A[0]
        rg = rg + kdg * A[1]
        rb = rb + kdb * A[2]
        contrib = (torch.where(hit, tr * rr, zero),
                   torch.where(hit, tg * rg, zero),
                   torch.where(hit, tb * rb, zero))

        # Russian roulette + cosine bounce (raytracer.cpp:161-194); amax
        # splits the gradient of a tie evenly, as the replay kernel does
        b0, b1, b2, _ = _pcg4d(pix, site_sd, torch.full_like(pix, 0x5EED),
                               seed_t)
        u_rr, u1, u2 = _u01(b0), _u01(b1), _u01(b2)
        p_cont = torch.amax(torch.stack([kdr, kdg, kdb]), dim=0)
        cont = hit & (depth < max_depth) & (u_rr <= p_cont) & active
        positive = p_cont > 0.0
        inv_p = torch.where(positive,
                            1.0 / torch.where(positive, p_cont, one), zero)
        n_samp = torch.where(cont, samp, samp + 1)
        yield dict(samp=samp, T=(tr, tg, tb), hit=hit,
                   mat=g[:, _C_MESH].detach().to(torch.int64),
                   kd=(kdr, kdg, kdb), A=A, sum_scale=sum_scale,
                   em_scale=em_scale, contrib=contrib, p=p_cont,
                   inv_p=inv_p, cont=cont, n_samp=n_samp)

        bd = _cosine_bounce((snx, sny, snz), u1, u2)
        n_o = (hx + snx * BIAS, hy + sny * BIAS, hz + snz * BIAS)
        n_t = (tr * kdr * inv_p, tg * kdg * inv_p, tb * kdb * inv_p)

        # terminate: regenerate as the next sample
        onf = (n_samp < S).to(torch.float32)
        p_o, p_d = primary(n_samp)
        o = tuple(torch.where(cont, n_o[k], p_o[k]).detach()
                  for k in range(3))
        d = tuple(torch.where(cont, bd[k], p_d[k]).detach()
                  for k in range(3))
        tr, tg, tb = (torch.where(cont, n_t[k], onf) for k in range(3))
        depth = torch.where(cont, depth + 1, torch.zeros_like(depth))
        samp = n_samp
    if stats is not None:
        stats["tests"] = stats.get("tests", 0) + tests


def fused_path_plain(tab, clo, chi, em, cam, seed: int, W: int, H: int,
                     samples: int, max_depth: int, light_samples: int,
                     stats: dict | None = None, pix_base: int = 0,
                     n_lanes: int | None = None) -> torch.Tensor:
    """The render kernel's estimator batched over the lanes [pix_base,
    pix_base + n_lanes) (default: the whole image; fast-shadow NEE):
    [n_lanes, 3] radiance/spp.

    clo/chi (chunk AABBs) only let the kernel skip work; the plain version
    sweeps every row, which is value-identical. When `stats` is a dict,
    stats["tests"] counts the ray-triangle tests of the sweeps the kernel
    runs without chunk culling (lanes still inside their samples only,
    real rows only: the always-miss padding rows are no work of the
    function): the work measure of the kernel's roofline bound.
    """
    del clo, chi
    acc = [0.0, 0.0, 0.0]
    for st in _regen_steps(tab, em, cam, seed, W, H, samples, max_depth,
                           light_samples, legacy=False, stats=stats,
                           pix_base=pix_base, n_lanes=n_lanes):
        acc = [acc[k] + st["contrib"][k] for k in range(3)]
    inv_s = _f32(1.0 / samples, tab.device)
    return torch.stack(acc, dim=1) * inv_s


def fused_fwd_ls_plain(tab, clo, chi, em, cam, seed: int, W: int, H: int,
                       samples: int, max_depth: int, light_samples: int,
                       stats: dict | None = None, tree=None,
                       pix_base: int = 0, n_lanes: int | None = None):
    """The training forward (legacy NEE) batched over the lanes
    [pix_base, pix_base + n_lanes) (default: the whole image): (img
    [n_lanes, 3] radiance/spp, ls [n_lanes, 3*samples]), where ls[:, 3s +
    c] is channel c of sample s's radiance L_s (the record the replay
    starts its remaining radiance from). Differentiable with respect to
    `tab`'s material columns. `stats` as in fused_path_plain; `tree` as
    in `_regen_steps` (the forward over a BVH, ops/bvh_prb.py)."""
    del clo, chi
    if samples > MAX_SAMPLES:
        raise ValueError(f"{samples} samples; the per-sample record holds "
                         f"at most {MAX_SAMPLES}")
    dev = tab.device
    n = lane_tile("fused_fwd_ls_plain", W, H, pix_base, n_lanes)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    acc = [0.0, 0.0, 0.0]
    planes = [zero.expand(n)] * (3 * samples)
    for st in _regen_steps(tab, em, cam, seed, W, H, samples, max_depth,
                           light_samples, legacy=True, stats=stats,
                           tree=tree, pix_base=pix_base, n_lanes=n):
        c3 = st["contrib"]
        acc = [acc[k] + c3[k] for k in range(3)]
        for s in range(samples):
            sel = st["samp"] == s
            for k in range(3):
                planes[3 * s + k] = planes[3 * s + k] + torch.where(
                    sel, c3[k], zero)
    inv_s = _f32(1.0 / samples, dev)
    return torch.stack(acc, dim=1) * inv_s, torch.stack(planes, dim=1)


def pack_fused_tri_table_torch(scene: Scene, mat_diffuse=None,
                               mat_emissive=None, base=None) -> torch.Tensor:
    """Differentiable [T_pad, 32] table on the scene's device: geometry
    columns from the float64 host pack (bitwise pack_fused_tri_table's,
    or `base`, that pack already on the device), kd/ke gathered from
    `mat_diffuse`/`mat_emissive` (default: the scene's) by tri_mat, so
    gradients flow from the table to those material tensors."""
    T = int(scene.num_triangles)
    if base is None:
        base = torch.as_tensor(pack_fused_tri_table(scene),
                               device=scene.device)
    kd = scene.mat_diffuse if mat_diffuse is None else mat_diffuse
    ke = scene.mat_emissive if mat_emissive is None else mat_emissive
    mat = scene.tri_mat[:T].long()
    top = torch.cat([base[:T, :_C_KD], kd[mat].to(torch.float32),
                     ke[mat].to(torch.float32), base[:T, _C_AREA:]], dim=1)
    return torch.cat([top, base[T:]], dim=0)


def fused_reference_render(scene: Scene, camera, seed: int, *, samples: int,
                           max_depth: int, light_samples: int = 2,
                           tab=None) -> torch.Tensor:
    """The training estimator (legacy NEE) as plain PyTorch: [H, W, 3],
    differentiable through autograd with respect to the material tensors
    behind `tab` (default: pack_fused_tri_table_torch(scene)). The
    gradient oracle of the path-replay kernels (ops/prb.py)."""
    if tab is None:
        tab = pack_fused_tri_table_torch(scene)
    em = torch.as_tensor(pack_emitters(scene), device=tab.device)
    cam = camera_vec(camera).to(tab.device)
    H, W = camera.yres, camera.xres
    img, _ = fused_fwd_ls_plain(tab, None, None, em, cam, seed, W, H,
                                samples, max_depth, light_samples)
    return img.reshape(H, W, 3)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def fused_path(tab, clo, chi, em, cam, seed: int, W: int, H: int,
               samples: int, max_depth: int, light_samples: int,
               pix_base: int = 0, n_lanes: int | None = None) -> torch.Tensor:
    """[n_lanes, 3] radiance / spp of the pixels [pix_base, pix_base +
    n_lanes) (default: the whole image, [W*H, 3]): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. A tile's rows are the
    whole image's, bit for bit (the PCG4D draws hash global pixel ids)."""
    n = lane_tile("fused_path", W, H, pix_base, n_lanes)
    if tab.device.type == "cpu":
        return fused_path_plain(tab, clo, chi, em, cam, seed, W, H, samples,
                                max_depth, light_samples, pix_base=pix_base,
                                n_lanes=n)
    if tab.device.type != "cuda":
        raise ValueError(f"fused_path: unsupported device {tab.device}")
    check_tables("fused_path", tab, clo, chi, cam, 32,
                 (("em", em, (em.shape[0], EM_STRIDE)),))
    if not 1 <= em.shape[0] <= FUSED_MAX_EMITTERS:
        raise ValueError(f"fused_path: {em.shape[0]} emitters, need 1.."
                         f"{FUSED_MAX_EMITTERS}")
    out = torch.empty((n, 3), dtype=torch.float32, device=tab.device)
    nxt = torch.zeros((1,), dtype=torch.int32, device=tab.device)
    seed32 = (int(seed) + 2**31) % 2**32 - 2**31   # as int32 bits
    KERNEL.launch(cam.data_ptr(), tab.data_ptr(), clo.data_ptr(),
                  chi.data_ptr(), em.data_ptr(), out.data_ptr(),
                  nxt.data_ptr(), tab.shape[0], clo.shape[0], em.shape[0],
                  W, H, samples, max_depth, light_samples, seed32, pix_base,
                  n, stream_ptr(tab.device))
    return out


def make_fused_path_renderer(scene: Scene, camera, *, samples: int,
                             max_depth: int, light_samples: int = 2):
    """Build `fn(seed: int) -> [H, W, 3]` rendering the scene with the
    megakernel on the scene's device (the plain version on the CPU).

    The tables are built once here; `seed` is the int32 PCG seed, so calls
    with different seeds give independent estimates. `camera_override` (a
    camera of the same resolution) flies the camera without rebuilding a
    table: its vector replaces the build camera's (the viewer). `tab`
    replaces the triangle table (pack_fused_tri_table_torch of a scene
    with other materials), so an optimisation loop re-renders updated
    materials with the same renderer; the chunk bounds stay the build
    geometry's, so only material columns may change.
    """
    if not fused_path_supported(scene):
        raise ValueError("scene outside the fused-path gate "
                         "(textures / emitters / size)")
    H, W = camera.yres, camera.xres
    with span("route.fused_path"):
        args = fused_args(scene, camera)

    def render_fused(seed: int, camera_override=None,
                     tab=None) -> torch.Tensor:
        with span("render.fused"):
            tab_, clo, chi, em, cam = args
            if camera_override is not None:
                cam = override_camera_vec(camera_override, W, H, tab_.device)
            if tab is not None:
                tab_ = tab.detach().to(torch.float32).contiguous()
            out = fused_path(tab_, clo, chi, em, cam, seed, W, H, samples,
                             max_depth, light_samples)
            return out.reshape(H, W, 3)

    return render_fused
