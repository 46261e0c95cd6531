"""Closed-form material training over the binned dense sweep: a wavefront
forward and a wavefront replay.

Replaces `orion_tpu.ops.prb_wavefront` (`_make_replay_step` and
`make_binned_train_step`). The JAX package writes both passes in jnp
around its binned round kernel; here they are PyTorch over [N] lane planes
(one lane = one sample of one pixel, N = H * W * samples), and every
nearest hit and every shadow ray is a binned sweep, kernel 10
(ops/binned.py) on the card. A step is

  1. the forward: max_depth + 1 bounces of every lane (`_bounce`), each
     lane accumulating its own radiance L;
  2. the loss: the image (each pixel's samples added in sample order,
     / spp), its MSE against the target and each lane's cotangent w =
     dLoss/dL;
  3. the replay: the same bounces again (the same sweeps and the same PCG4D
     draws, so the same floats), the remaining radiance U_{d+1} = U_d -
     contrib_d, and the closed-form adjoints of ops/bounce_prb
     (`closed_form_adjoints`), summed per material in float64.

The NEE is the legacy one (the JAX package's fast_shadow=False): the
shadow sweep runs on every hit lane and carries the winner's normal and
emitted color from the table, so mat_emissive stays a live table value
and both material tables can be dynamic parameters. Gate:
`wavefront_train_supported` (one emitter, <= M_LANES materials,
untextured). The JAX package's `fit` never routes here, and neither does
the port's: the trainer is reached by name.
"""

from __future__ import annotations

import torch

from orion_tpu_torch.accel.bvh import BVH, SAH
from orion_tpu_torch.ops.binned import (MAX_ROWS, BinnedSweep,
                                        binned_device_data)
from orion_tpu_torch.ops.bounce import wavefront_rays
from orion_tpu_torch.ops.bounce_prb import (M_LANES, SPREAD,
                                            closed_form_adjoints,
                                            new_accumulator,
                                            wavefront_train_supported)
from orion_tpu_torch.ops.bvh_path import tab_updater_from_bvh
from orion_tpu_torch.ops.fused_path import (_C_AREA, _C_KD, _C_KE, _C_MESH,
                                            _C_N0, _C_N1, _C_N2, _M32, BIAS,
                                            NEE_T_CAP, _cosine_bounce, _f32,
                                            _nee_plain, _norm3, _pcg4d, _u01,
                                            camera_vec, pack_emitters)
from orion_tpu_torch.scene import Scene

# the winner's columns a bounce reads: normals, kd, ke, area, mesh and the
# Woop w-row with |n|^2 (the geometric normal)
_BOUNCE_COLS = (tuple(range(_C_N0, _C_N0 + 9))
                + tuple(range(_C_KD, _C_MESH + 1)) + (6, 7, 8, 12))


def _bounce(sweep: BinnedSweep, em_np, seed_t, pix, samp, depth: int,
            max_depth: int, light_samples: int, o, d, alive):
    """One bounce of every lane: a dict of the values the forward adds up
    and the replay differentiates (hit, kd, A, sum_scale, em_scale, the
    winner's material, r = ke * em_scale + kd * A, inv_p, the continue
    flag) and the next rays (o, d)."""
    t, hit, u, v, got = sweep(o, d, _BOUNCE_COLS, alive=alive)
    zero = torch.zeros_like(t)
    h = tuple(o[k] + t * d[k] for k in range(3))
    w = 1.0 - u - v
    sn = _norm3(*(w * got[_C_N0 + k] + u * got[_C_N1 + k]
                  + v * got[_C_N2 + k] for k in range(3)))
    s = torch.sqrt(got[12])
    so = tuple(h[k] + BIAS * (got[6 + k] * s) for k in range(3))
    kd = [got[_C_KD + k] for k in range(3)]

    # depth-0 emissive term: Ke * meshArea * dot(norm(d), -s_n)
    nd = _norm3(*d)
    cosv = -(nd[0] * sn[0] + nd[1] * sn[1] + nd[2] * sn[2])
    em_scale = (torch.where(hit, got[_C_AREA] * cosv, zero) if depth == 0
                else zero)

    def shadow_rows(so, sd, need):
        t_s, row = sweep.closest(so, sd, need, NEE_T_CAP)
        found = (t_s < NEE_T_CAP) & need
        return torch.where(found, row.to(torch.int64),
                           torch.full_like(pix, -1))

    site_sd = (samp * 131071 + depth) & _M32
    A, sum_scale = _nee_plain(sweep.tab, em_np, pix, site_sd, seed_t,
                              light_samples, hit, h, sn, so, legacy=True,
                              shadow_rows=shadow_rows)
    r = [got[_C_KE + k] * em_scale + kd[k] * A[k] for k in range(3)]

    # Russian roulette + cosine bounce (raytracer.cpp:161-194)
    b0, b1, b2, _ = _pcg4d(pix, site_sd, torch.full_like(pix, 0x5EED), seed_t)
    u_rr, u1, u2 = _u01(b0), _u01(b1), _u01(b2)
    p_cont = torch.maximum(torch.maximum(kd[0], kd[1]), kd[2])
    cont = (hit & (u_rr <= p_cont) if depth < max_depth
            else torch.zeros_like(hit))
    positive = p_cont > 0.0
    inv_p = torch.where(positive, 1.0 / torch.where(
        positive, p_cont, torch.ones_like(p_cont)), zero)
    bd = _cosine_bounce(sn, u1, u2)
    new_o = tuple(torch.where(cont, h[k] + sn[k] * BIAS, o[k])
                  for k in range(3))
    new_d = tuple(torch.where(cont, bd[k], d[k]) for k in range(3))
    return dict(hitf=hit.to(torch.float32), kd=kd, A=A, sum_scale=sum_scale,
                em_scale=em_scale, mesh=got[_C_MESH], r=r, inv_p=inv_p,
                cont=cont, o=new_o, d=new_d)


def make_binned_train_step(scene: Scene, camera, target, *, samples: int,
                           max_depth: int, light_samples: int = 2,
                           max_rows: int = MAX_ROWS, strategy: str = SAH,
                           dynamic_params: bool = False,
                           bvh: BVH | None = None, round_fn=None):
    """MSE train step against `target` [H, W, 3] over the binned sweep,
    with the gradients of the material tables in closed form.

    dynamic_params=False: `step(seed) -> (loss, grads)` over the scene's
    own materials, grads for mat_diffuse and mat_emissive [M, 3].
    dynamic_params=True: `step(params, seed) -> (loss, grads)` with params
    over {mat_diffuse, mat_emissive} (the table's material columns are
    regathered each call; the tree and the bins are untouched); another
    name raises ValueError. `seed` is the int32 PCG seed. Raises
    ValueError outside `wavefront_train_supported`. `step.sweep` holds the
    sweep and its counters (shared by the sweeps of rebuilt tables);
    round_fn: as BinnedSweep's."""
    if not wavefront_train_supported(scene):
        raise ValueError("scene outside the wavefront-train gate "
                         "(textures / emitters / materials)")
    dev = scene.device
    H, W = camera.yres, camera.xres
    n_pix = H * W
    if n_pix >= (1 << 24):
        raise ValueError("pixel ids must stay exact in float32 (< 2^24)")
    M = int(scene.num_meshes)
    bins, tab0, bvh = binned_device_data(scene, strategy=strategy,
                                         max_rows=max_rows, bvh=bvh)
    update = tab_updater_from_bvh(bvh, scene)
    em_np = pack_emitters(scene)
    em_mesh = int(em_np[0, 0])
    cam = camera_vec(camera).to(dev)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=dev).reshape(n_pix, 3)
    sweep0 = BinnedSweep(bins, tab0, round_fn=round_fn)

    def _impl(seed: int, sweep: BinnedSweep):
        pix, samp, o0, d0 = wavefront_rays(cam, seed, W, H, samples, dev)
        N = pix.shape[0]
        seed_t = torch.full((N,), int(seed) & _M32, dtype=torch.int64,
                            device=dev)

        def bounces():
            """Yield each bounce's values and the throughput it met."""
            o, d = o0, d0
            T = [torch.ones((N,), dtype=torch.float32, device=dev)] * 3
            alive = torch.ones((N,), dtype=torch.bool, device=dev)
            for depth in range(max_depth + 1):
                b = _bounce(sweep, em_np, seed_t, pix, samp, depth,
                            max_depth, light_samples, o, d, alive)
                yield b, T
                contf = b["cont"].to(torch.float32)
                T = [T[c] * b["kd"][c] * b["inv_p"] * contf
                     for c in range(3)]
                o, d, alive = b["o"], b["d"], b["cont"]
                if not bool(alive.any()):
                    break

        # forward: each lane's radiance
        L = [torch.zeros((N,), dtype=torch.float32, device=dev)] * 3
        for b, T in bounces():
            L = [L[c] + T[c] * b["r"][c] * b["hitf"] for c in range(3)]

        # loss and each lane's cotangent
        lane = torch.stack(L, dim=1).reshape(samples, n_pix, 3)
        img = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
        for s in range(samples):
            img = img + lane[s]
        img = img / float(samples)
        diff = img - target
        loss = torch.mean(diff * diff)
        w_pix = diff * _f32(2.0 / (H * W * 3 * samples), dev)
        w3 = w_pix[pix].t()                                   # [3, N]

        # replay: the same bounces, U_{d+1} = U_d - contrib_d
        acc, ek = new_accumulator(dev)
        U = L
        for b, T in bounces():
            U = [U[c] - T[c] * b["r"][c] * b["hitf"] for c in range(3)]
            closed_form_adjoints(acc, ek, w3, T, U, b["kd"], b["A"],
                                 b["em_scale"], b["sum_scale"], b["inv_p"],
                                 b["cont"].to(torch.float32), b["mesh"])
        acc = acc.reshape(SPREAD, M_LANES, 8).sum(dim=0).to(torch.float32)
        g_ke = acc[:M, 3:6].clone()
        g_ke[em_mesh] += ek.to(torch.float32)
        return loss, {"mat_diffuse": acc[:M, 0:3], "mat_emissive": g_ke}

    if not dynamic_params:
        def step(seed: int):
            with torch.no_grad():
                return _impl(seed, sweep0)

        step.sweep = sweep0
        return step

    def step_params(params, seed: int):
        bad = set(params) - {"mat_diffuse", "mat_emissive"}
        if bad:
            raise ValueError(f"the binned trainer differentiates material "
                             f"tables only; got {sorted(bad)}")
        with torch.no_grad():
            tab = update(mat_diffuse=params.get("mat_diffuse"),
                         mat_emissive=params.get("mat_emissive"))
            sweep = sweep0.with_tab(tab)
            loss, g = _impl(seed, sweep)
        return loss, {k: g[k] for k in params}

    step_params.sweep = sweep0
    return step_params
