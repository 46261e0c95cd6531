"""The Whitted megakernel: CUDA wrapper + plain version.

Replaces `orion_tpu.ops.pallas_whitted` (the Pallas `_make_whitted_kernel`):
the Whitted estimator of the reference's point-light branch
(raytracer.cpp:195-207, material.hpp:72-93) in one launch, persistent
lanes that take pixels from a counter: PCG4D-jittered primary rays, the
chunk-culled nearest sweep over a [T_pad, 40] table, depth-0 emission
(scenes with an emitter only), one any-hit shadow sweep per point light
(<= MAX_LIGHTS), Phong shading with C's pow(0, 0) = 1, the Ks-scaled mirror continuation, pruning of
zero-throughput rays and regeneration onto the lane's next sample. The
kernel is `csrc/whitted.cu` over the lane of `csrc/whitted_common.cuh`;
`fused_whitted_plain` computes the same estimator batched over all lanes, a
fixed samples * (max_depth + 1) steps. `_whitted_plain` is that one
estimator for every Whitted kernel: over a tree it is the plain version of
the BVH Whitted kernels too (ops/bvh_whitted.py).

`fused_whitted` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.

Estimator parity with the wavefront's Whitted bounce (render.py): the
shadow quirk (ANY intersection at any t blocks, even geometry beyond the
light), the depth-0 emission scaled by mesh area, pow(0, 0) = 1. The
sub-pixel jitter is the path kernel's PCG4D draw, another stream than the
wavefront's torch.Generator, so the two agree statistically.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from orion_tpu_torch.ops.cuda_build import CudaKernel, stream_ptr
from orion_tpu_torch.ops.fused_path import (
    BIAS, FUSED_MAX_TRIS, _C_AREA, _C_KD, _C_KE, _C_MESH, _C_N0, _C_N1, _C_N2,
    _C_WOOP, _f32, _fused_t_pad, _make_primary, _norm3, camera_vec,
    check_tables, fused_chunk_bounds, override_camera_vec,
    pack_fused_tri_table)
from orion_tpu_torch.ops.woop import BIG, nearest_rows, woop_tuv
from orion_tpu_torch.scene import Scene

MAX_LIGHTS = 8

# Whitted extension columns ([T_pad, 40] table: 0-29 as the path table)
_C_KA, _C_KS, _C_SHIN = 32, 35, 38
_W_COLS = 40
# the deferred kernel's table adds the corner uvs, corner-major per axis
# (u0 u1 u2 | v0 v1 v2): [B_pad, 48]
_C_UV = 40
_D_COLS = 48
LIGHT_COLS = 8      # light record: position(3) color(3) intensity, 0

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("whitted", "whitted_launch",
                    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _P, _P])


def pack_whitted_tri_table(scene: Scene) -> np.ndarray:
    """[T_pad, 40]: the path table plus solid Ka/Ks/shininess columns."""
    base = pack_fused_tri_table(scene)                    # [T_pad, 32]
    T = int(scene.num_triangles)
    tab = np.zeros((base.shape[0], _W_COLS), np.float32)
    tab[:, :32] = base
    mat = scene.numpy("tri_mat")[:T]
    tab[:T, _C_KA:_C_KA + 3] = scene.numpy("mat_ambient")[mat]
    tab[:T, _C_KS:_C_KS + 3] = scene.numpy("mat_specular")[mat]
    tab[:T, _C_SHIN] = scene.numpy("mat_shininess")[mat]
    return tab


def _lights_consts(scene: Scene):
    """(L, positions [L, 3], colors [L, 3], intensities [L])."""
    L = int(scene.num_lights)
    return (L, scene.numpy("light_pos")[:L], scene.numpy("light_color")[:L],
            scene.numpy("light_intensity")[:L])


def pack_lights(scene: Scene) -> np.ndarray:
    """[L, LIGHT_COLS] float32 light records (the kernel's light array)."""
    L, pos, color, inten = _lights_consts(scene)
    out = np.zeros((L, LIGHT_COLS), np.float32)
    out[:, 0:3] = pos
    out[:, 3:6] = color
    out[:, 6] = inten
    return out


def fused_whitted_supported(scene: Scene) -> bool:
    """Gate: solid-material Whitted scene with few lights, small T (the
    BVH Whitted gate with the brute sweep's triangle cap)."""
    from orion_tpu_torch.ops.bvh_whitted import bvh_whitted_supported

    return (_fused_t_pad(int(scene.num_triangles)) <= FUSED_MAX_TRIS
            and bvh_whitted_supported(scene))


def _pow_like_c(x, e):
    """powf semantics: pow(0, 0) == 1, pow(0, e > 0) == 0."""
    one = torch.ones_like(x)
    px = torch.exp(e * torch.log(torch.where(x > 0.0, x, one)))
    return torch.where(x > 0.0, px, torch.where(e == 0.0, one,
                                                torch.zeros_like(x)))


def _first_hit_rows(rows13, orig, dirs, budget: int = 1 << 24):
    """First row (in table order) each ray hits at any t >= 0, or -1: the
    any-hit answer and, through the row, the tests a sweep that stops at
    the first hit makes."""
    N, T = orig.shape[0], rows13.shape[0]
    out = torch.full((N,), -1, dtype=torch.int64, device=orig.device)
    if T == 0 or N == 0:
        return out
    step = max(1, budget // T)
    w = tuple(rows13[None, :, i] for i in range(13))
    for s in range(0, N, step):
        o = tuple(orig[s:s + step, i, None] for i in range(3))
        d = tuple(dirs[s:s + step, i, None] for i in range(3))
        ok = woop_tuv(o, d, w)[0] < BIG                    # [n, T]
        first = torch.argmax(ok.to(torch.int8), dim=1)
        out[s:s + step] = torch.where(ok.any(dim=1), first,
                                      torch.full_like(first, -1))
    return out


REC_ROWS = 12       # deferred record floats per (sample, bounce, lane)


def _whitted_plain(tab, lights, cam, seed: int, W: int, H: int,
                   samples: int, max_depth: int, with_emissive: bool, *,
                   tree=None, pix_base: int = 0, n_lanes: int | None = None,
                   records: tuple | None = None,
                   stats: dict | None = None) -> torch.Tensor:
    """The Whitted megakernels' estimator batched over the lanes
    [pix_base, pix_base + n_lanes) (default: the whole image), run as a
    fixed samples * (max_depth + 1) regenerative steps (a lane past its last
    sample idles): [n_lanes, 3] radiance / spp.

    tree: None sweeps every row of `tab` (kernel 4); a `bvh_path.TreeData`
    walks the bundled `tab` instead (kernel 7a): the nearest hit by
    `tree.nearest`, each light's shadow query by `tree.any_hit`.

    records=(samp_base, chunk) gives the deferred kernel's function
    (kernel 7b) instead: the lanes run the samples [samp_base, samp_base +
    chunk) with no zero-throughput pruning (the mirror chain goes on
    wherever a bounce hits, since ks(uv) is unknown), and the result is the
    records [chunk * (max_depth + 1) * REC_ROWS, n_lanes] of every (sample,
    bounce): uv, material id, the ambient (+ depth-0 emission) sum, the
    diffuse light sum Cd and the specular light sum Cs; zero where the
    bounce is not reached or misses. `tab` then carries the corner uvs
    (bvh_whitted.pack_bvh_whitted_table(textured=True)).

    When `stats` is a dict it accumulates the work of the kernel's sweeps:
    stats["tests"] the Woop tests (a brute sweep without chunk culling over
    real rows, a shadow sweep up to its first hit; a walk's tests of real
    rows in visited leaves) and, over a tree, stats["box_tests"].
    """
    dev = tab.device
    n = W * H - pix_base if n_lanes is None else n_lanes
    samp0, S = (0, samples) if records is None else (
        records[0], records[0] + records[1])
    D1 = max_depth + 1
    woop = tab[:, :13]
    lt = lights.detach().cpu().numpy()
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    pix = torch.arange(n, dtype=torch.int64, device=dev) + pix_base
    primary = _make_primary(cam, seed, W, H, dev, pix)

    pad_row = torch.zeros((13,), dtype=torch.float32, device=dev)
    pad_row[_C_WOOP + 11] = 1.0
    n_real = int((woop != pad_row).any(dim=1).sum())
    # the rank of each table row among the real rows (tests up to a hit)
    real_rank = torch.cumsum((woop != pad_row).any(dim=1).to(torch.int64), 0)
    tests = 0

    def nearest(o, d, lanes):
        oo, dd = torch.stack(o, 1)[lanes], torch.stack(d, 1)[lanes]
        if tree is None:
            return nearest_rows(woop, oo, dd)
        return tree.nearest(woop, oo, dd, BIG, stats)

    def occluded(so, sd):
        """Any hit at any t >= 0 of each shadow ray."""
        nonlocal tests
        if tree is None:
            first = _first_hit_rows(woop, so, sd)
            tests += int(torch.where(first >= 0,
                                     real_rank[first.clamp(min=0)],
                                     torch.full_like(first, n_real)).sum())
            return first >= 0
        return tree.any_hit(woop, so, sd, stats)

    samp = torch.full((n,), samp0, dtype=torch.int64, device=dev)
    depth = torch.zeros((n,), dtype=torch.int64, device=dev)
    o, d = primary(samp)
    one = torch.ones((n,), dtype=torch.float32, device=dev)
    tr, tg, tb = one, one, one
    acc = [zero, zero, zero]
    rec = (None if records is None else
           torch.zeros((records[1] * D1, n, REC_ROWS), dtype=torch.float32,
                       device=dev))
    for _ in range((S - samp0) * D1):
        active = torch.nonzero(samp < S).flatten()
        if tree is None:
            tests += active.numel() * n_real
        t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
        row = torch.full((n,), -1, dtype=torch.int64, device=dev)
        t[active], row[active] = nearest(o, d, active)
        hit = row >= 0
        g = tab[torch.clamp(row, min=0)]
        _, u, v = woop_tuv(o, d, tuple(g[:, k] for k in range(13)))
        hx, hy, hz = (o[k] + t * d[k] for k in range(3))
        wb = 1.0 - u - v
        sn = _norm3(*(wb * g[:, _C_N0 + k] + u * g[:, _C_N1 + k]
                      + v * g[:, _C_N2 + k] for k in range(3)))
        s = torch.sqrt(g[:, 12])
        gn = tuple(g[:, 6 + k] * s for k in range(3))
        kd = [g[:, _C_KD + c] for c in range(3)]
        ka = [g[:, _C_KA + c] for c in range(3)]
        ks = [g[:, _C_KS + c] for c in range(3)]
        shin = g[:, _C_SHIN]

        r3 = [zero, zero, zero]
        cd = [zero, zero, zero]
        cs = [zero, zero, zero]
        if with_emissive:
            nd = _norm3(*d)
            cosv = -(nd[0] * sn[0] + nd[1] * sn[1] + nd[2] * sn[2])
            em_scale = torch.where((depth == 0) & hit, g[:, _C_AREA] * cosv,
                                   zero)
            r3 = [r3[c] + g[:, _C_KE + c] * em_scale for c in range(3)]

        vd = _norm3(-d[0], -d[1], -d[2])
        so = torch.stack([hx + BIAS * gn[0], hy + BIAS * gn[1],
                          hz + BIAS * gn[2]], 1)
        lanes = torch.nonzero(hit).flatten()
        for li in range(lt.shape[0]):
            tl = (float(lt[li, 0]) - hx, float(lt[li, 1]) - hy,
                  float(lt[li, 2]) - hz)
            d2 = tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2]
            occ = torch.zeros((n,), dtype=torch.bool, device=dev)
            occ[lanes] = occluded(so[lanes], torch.stack(tl, 1)[lanes])
            lit = hit & ~occ
            ldx, ldy, ldz = _norm3(*tl)
            ndotl = torch.clamp(sn[0] * ldx + sn[1] * ldy + sn[2] * ldz,
                                min=0.0)
            dot_ln = -(ldx * sn[0] + ldy * sn[1] + ldz * sn[2])
            rx = -ldx - 2.0 * dot_ln * sn[0]
            ry = -ldy - 2.0 * dot_ln * sn[1]
            rz = -ldz - 2.0 * dot_ln * sn[2]
            spec_cos = torch.clamp(vd[0] * rx + vd[1] * ry + vd[2] * rz,
                                   min=0.0)
            spec = 0.5 * _pow_like_c(spec_cos, shin)
            scale = lit.to(torch.float32) * float(lt[li, 6]) \
                / torch.clamp(d2, min=1e-20)
            lc = [float(lt[li, 3 + c]) for c in range(3)]
            if records is None:
                r3 = [r3[c] + lc[c] * (ka[c] + ndotl * kd[c] + spec * ks[c])
                      * scale for c in range(3)]
            else:
                r3 = [r3[c] + lc[c] * ka[c] * scale for c in range(3)]
                cd = [cd[c] + lc[c] * ndotl * scale for c in range(3)]
                cs = [cs[c] + lc[c] * spec * scale for c in range(3)]

        T3 = (tr, tg, tb)
        if records is None:
            acc = [acc[c] + torch.where(hit, T3[c] * r3[c], zero)
                   for c in range(3)]
            # mirror continuation scaled by Ks; zero-throughput rays retire
            n_t = (tr * ks[0], tg * ks[1], tb * ks[2])
            nonzero = (n_t[0] > 0.0) | (n_t[1] > 0.0) | (n_t[2] > 0.0)
            cont = hit & (depth < max_depth) & nonzero
        else:
            uv = [wb * g[:, _C_UV + 3 * a] + u * g[:, _C_UV + 3 * a + 1]
                  + v * g[:, _C_UV + 3 * a + 2] for a in range(2)]
            vals = torch.stack(uv + [g[:, _C_MESH]] + r3 + cd + cs, 1)
            slot = (samp - samp0) * D1 + depth
            rec[slot[lanes], lanes] = vals[lanes]
            n_t = T3
            cont = hit & (depth < max_depth)
        dot_dn = d[0] * sn[0] + d[1] * sn[1] + d[2] * sn[2]
        bd = tuple(d[k] - 2.0 * dot_dn * sn[k] for k in range(3))
        n_o = (hx + sn[0] * BIAS, hy + sn[1] * BIAS, hz + sn[2] * BIAS)
        n_samp = torch.where(cont, samp, samp + 1)
        onf = (n_samp < S).to(torch.float32)
        p_o, p_d = primary(n_samp)
        o = tuple(torch.where(cont, n_o[k], p_o[k]) for k in range(3))
        d = tuple(torch.where(cont, bd[k], p_d[k]) for k in range(3))
        tr, tg, tb = (torch.where(cont, n_t[k], onf) for k in range(3))
        depth = torch.where(cont, depth + 1, torch.zeros_like(depth))
        samp = n_samp
    if stats is not None:
        stats["tests"] = stats.get("tests", 0) + tests
    if records is not None:
        return rec.permute(0, 2, 1).reshape(-1, n)
    inv_s = _f32(1.0 / samples, dev)
    return torch.stack(acc, dim=1) * inv_s


def fused_whitted_plain(tab, clo, chi, lights, cam, seed: int, W: int,
                        H: int, samples: int, max_depth: int,
                        with_emissive: bool,
                        stats: dict | None = None) -> torch.Tensor:
    """The kernel's estimator batched over all lanes: [W*H, 3] radiance/spp.

    clo/chi only let the kernel skip chunks (value-identical). When
    `stats` is a dict, stats["tests"] counts the Woop tests the kernel's
    sweeps need without chunk culling (lanes inside their samples, real
    rows only; a shadow sweep stops at its first hit).
    """
    del clo, chi
    return _whitted_plain(tab, lights, cam, seed, W, H, samples, max_depth,
                          with_emissive, stats=stats)


def fused_whitted(tab, clo, chi, lights, cam, seed: int, W: int, H: int,
                  samples: int, max_depth: int, with_emissive: bool, *,
                  pix_base: int = 0,
                  n_lanes: int | None = None) -> torch.Tensor:
    """[n_lanes, 3] radiance / spp of the pixels [pix_base, pix_base +
    n_lanes) (default: [W*H, 3], the whole image): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. A tile's pixels are the
    whole image's bit for bit."""
    n = W * H - pix_base if n_lanes is None else n_lanes
    if not (0 <= pix_base and 0 <= n and pix_base + n <= W * H):
        raise ValueError(f"fused_whitted: lanes [{pix_base}, "
                         f"{pix_base + n}) outside the {W}x{H} image")
    if tab.device.type == "cpu":
        return _whitted_plain(tab, lights, cam, seed, W, H, samples,
                              max_depth, with_emissive, pix_base=pix_base,
                              n_lanes=n)
    if tab.device.type != "cuda":
        raise ValueError(f"fused_whitted: unsupported device {tab.device}")
    check_tables("fused_whitted", tab, clo, chi, cam, _W_COLS,
                 (("lights", lights, (lights.shape[0], LIGHT_COLS)),))
    if not 1 <= lights.shape[0] <= MAX_LIGHTS:
        raise ValueError(f"fused_whitted: {lights.shape[0]} lights, need "
                         f"1..{MAX_LIGHTS}")
    out = torch.empty((n, 3), dtype=torch.float32, device=tab.device)
    nxt = torch.zeros((1,), dtype=torch.int32, device=tab.device)
    seed32 = (int(seed) + 2**31) % 2**32 - 2**31
    KERNEL.launch(cam.data_ptr(), tab.data_ptr(), clo.data_ptr(),
                  chi.data_ptr(), lights.data_ptr(), out.data_ptr(),
                  tab.shape[0], clo.shape[0], lights.shape[0], W, H, samples,
                  max_depth, int(bool(with_emissive)), seed32, pix_base, n,
                  nxt.data_ptr(), stream_ptr(tab.device))
    return out


def whitted_args(scene: Scene, camera):
    """(tab, clo, chi, lights, cam) tensors of the kernel on the scene's
    device."""
    dev = scene.device
    lo, hi = fused_chunk_bounds(scene)
    return (torch.as_tensor(pack_whitted_tri_table(scene), device=dev),
            torch.as_tensor(lo, device=dev).contiguous(),
            torch.as_tensor(hi, device=dev).contiguous(),
            torch.as_tensor(pack_lights(scene), device=dev),
            camera_vec(camera).to(dev))


def make_fused_whitted_renderer(scene: Scene, camera, *, samples: int,
                                max_depth: int):
    """Build `fn(seed: int, camera_override=None) -> [H, W, 3]` rendering
    with the Whitted kernel on the scene's device (the plain version on the
    CPU); `seed` is the int32 PCG seed, `camera_override` a camera of the
    same resolution whose vector replaces the build camera's."""
    if not fused_whitted_supported(scene):
        raise ValueError("scene outside the fused-whitted gate "
                         "(textures / lights / size)")
    H, W = camera.yres, camera.xres
    args = whitted_args(scene, camera)
    with_emissive = scene.num_emissive > 0

    def render_whitted_fused(seed: int,
                             camera_override=None) -> torch.Tensor:
        tab, clo, chi, lights, cam = args
        if camera_override is not None:
            cam = override_camera_vec(camera_override, W, H, tab.device)
        out = fused_whitted(tab, clo, chi, lights, cam, seed, W, H, samples,
                            max_depth, with_emissive)
        return out.reshape(H, W, 3)

    return render_whitted_fused
