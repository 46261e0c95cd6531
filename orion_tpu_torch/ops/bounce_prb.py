"""Closed-form material training on the sorted-wavefront bounce pipeline:
the backward pass walks no tree.

Replaces `orion_tpu.ops.pallas_bounce_prb`. The path-replay trainers
(ops/prb.py) trace every path a second time to recompute what their
adjoints need. Here the FORWARD shade kernel (ops/bounce.py, `with_aux`)
dumps those 15 values per lane and bounce (kd, the NEE radiance A, the
contribution, em_scale, sum_scale, the winner's material, the hit and
continue flags, 1/p), and the backward pass is per-lane arithmetic over
the dumps, with no kernel of its own in the JAX package and none here:

    T_{d+1} = T_d kd inv_p cont                (throughput chain)
    U_{d+1} = U_d - contrib_d                  (remaining radiance)
    d kd[m, c] += w_c T_c A_c + w_c U_c / kd_c - share_c inv_p <w, U>
    d ke[m, c] += w_c T_c em_scale             (depth-0 emission)
    d ke[em, c] += w_c T_c kd_c sum_scale      (NEE, one emitter)

Each depth's dump arrives in that depth's own sorted lane order with its
lanes' canonical indices (sample * pix_count + pixel). The JAX package
scatter-adds every dump into zeros of the full width to line the chains
up; here T and U stay in canonical order and each depth gathers and
scatters its own lanes by those indices, which is the same alignment at a
cost in proportion to the lanes the depth ran (a lane it did not run
would add exact zeros). U_0 folds the contributions in depth
order, as the forward accumulated them. p = max(kd) splits a tie's
gradient evenly over the tied channels (share = 1 / #ties), the
convention of every trainer of the package. Per-lane terms are float32;
their scatters per material and the emitter sums are float64 (a grey
material's gradient is a small difference of large per-lane terms).

The forward is `make_bounce_path_renderer`'s pipeline (same kernels,
fast-shadow NEE, same PCG4D streams), so the loss is that renderer's image
MSE. The fast-shadow NEE reads the emitter's ke from the emitter records,
not from the table, so only mat_diffuse can be a dynamic parameter; the
step still returns the closed-form mat_emissive gradient.
"""

from __future__ import annotations

import torch

from orion_tpu_torch.ops.bounce import (A_A, A_CONT, A_EMS, A_INVP, A_KD,
                                        A_MESH, A_RAD, A_SUMS, _timed, build_forward_pipeline,
                                        state_image)
from orion_tpu_torch.ops.bvh_path import (LEAF_WIDTH, bvh_path_supported,
                                          tab_updater_from_bvh)
from orion_tpu_torch.ops.prb import M_LANES
from orion_tpu_torch.scene import Scene


SPREAD = 1024     # private copies of the gradient accumulator


def wavefront_train_supported(scene: Scene) -> bool:
    """Gate: bvh-path scene, <= M_LANES materials, ONE emissive mesh. No
    cap on samples: a lane is a sample."""
    return (bvh_path_supported(scene) and scene.num_meshes <= M_LANES
            and scene.num_emissive == 1)


def new_accumulator(dev):
    """(acc [SPREAD * M_LANES, 8], ek [3]), float64 zeros: what
    closed_form_adjoints adds into; acc.reshape(SPREAD, M_LANES, 8).sum(0)
    is the per-material result."""
    return (torch.zeros((SPREAD * M_LANES, 8), dtype=torch.float64,
                        device=dev),
            torch.zeros((3,), dtype=torch.float64, device=dev))


def closed_form_adjoints(acc, ek, w, T, U, kd, A, em_scale, sum_scale,
                         inv_p, contf, mesh):
    """One bounce's closed-form material adjoints of n lanes, added into
    (acc, ek) of new_accumulator; returns the next throughput T_{d+1} (3
    planes). w, T: the lanes' cotangent and throughput (3 rows each), U
    their remaining radiance AFTER this bounce (U_{d+1}); kd, A: 3 planes;
    em_scale, sum_scale, inv_p, contf, mesh: planes. A lane's terms go to
    its winner's material row in the private copy of its place mod
    SPREAD: the few materials of a scene would otherwise serialise the
    card's atomic adds on a handful of addresses."""
    n = mesh.shape[0]
    dev = mesh.device
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    p_cont = torch.maximum(torch.maximum(kd[0], kd[1]), kd[2])
    ties = [(kd[c] == p_cont).to(torch.float32) for c in range(3)]
    tie_n = ties[0] + ties[1] + ties[2]
    wU = w[0] * U[0] + w[1] * U[1] + w[2] * U[2]
    amax_term = -inv_p * wU / torch.clamp(tie_n, min=1.0)
    g_kd, g_ke, t_new = [], [], []
    for c in range(3):
        wT = w[c] * T[c]
        g_kd.append(wT * A[c]
                    + torch.where(kd[c] > 0.0,
                                  w[c] * U[c] / torch.clamp(kd[c], min=1e-30),
                                  zero)
                    + ties[c] * amax_term)
        g_ke.append(wT * em_scale)
        ek[c] += (wT * kd[c] * sum_scale).double().sum()
        t_new.append(T[c] * kd[c] * inv_p * contf)
    G = torch.stack(g_kd + g_ke + [zero, zero], dim=1).double()
    spread = torch.arange(n, device=dev) % SPREAD * M_LANES
    acc.index_add_(0, mesh.to(torch.int64) + spread, G)
    return t_new


def make_bounce_train_core(scene: Scene, camera, *, samples: int,
                           max_depth: int, light_samples: int = 2,
                           sort: bool = True, pix_count: int | None = None,
                           **options):
    """(core, ctx): the tile-local closed-form train computation,

        core(seed, tab, pix_base, target_local [pix_count, 3])
            -> (sse, acc [M_LANES, 8], ek [3])

    sse the tile's sum of squared pixel errors, acc the per-material
    gradient rows (cols 0-2 kd, 3-5 ke), ek the NEE emitted-color gradient
    of the one emitter. Everything is local to the tile, while the MSE's
    normalisation is the whole image's (H * W * 3 * samples), so tiles'
    results add up to the whole image's. `options` go to
    build_forward_pipeline (tree layout, bvh, steps)."""
    if not wavefront_train_supported(scene):
        raise ValueError("scene outside the wavefront-train gate "
                         "(textures / emitters / materials)")
    pipeline, ctx = build_forward_pipeline(
        scene, camera, samples=samples, max_depth=max_depth,
        light_samples=light_samples, sort=sort, with_aux=True,
        pix_count=pix_count, textured=False, **options)
    H, W = ctx["H"], ctx["W"]
    pc, N, n_pix = ctx["pix_count"], ctx["N"], ctx["n_pix"]
    dev = scene.device

    def cotangent(st, pix_base, target_local):
        """(sse, w3 [3, N]): the tile's squared error and each lane's
        adjoint dLoss/d(lane radiance) in canonical lane order."""
        img = state_image(st, pc, samples, pix_base)
        # a tile may reach past the image: those rows carry no error
        valid = (torch.arange(pc, device=dev) + pix_base
                 < n_pix).to(torch.float32)[:, None]
        diff = (img - target_local) * valid
        w_pix = diff * (2.0 / (H * W * 3 * samples))
        return torch.sum(diff * diff), w_pix.t().repeat(1, samples)

    def adjoints(dumps, w3):
        """(acc [M_LANES, 8], ek [3]) in float64 from the per-depth dumps.
        T and U live in canonical lane order; each depth gathers its
        lanes' entries by the dump's lane ids, does its arithmetic in the
        dump's own order and scatters T and U back, so a depth costs in
        proportion to the lanes it ran. A lane a depth did not run would
        add exact zeros: it is skipped."""
        # U_0: the lane's radiance, folded in depth order (lane ids are
        # unique within a dump: the adds do not race)
        U = torch.zeros((3, N), dtype=torch.float32, device=dev)
        for aux, lane in dumps:
            U.index_add_(1, lane, aux[A_RAD:A_RAD + 3])
        T = torch.ones((3, N), dtype=torch.float32, device=dev)
        acc, ek = new_accumulator(dev)
        while dumps:
            a, lane = dumps.pop(0)
            Ul = U[:, lane] - a[A_RAD:A_RAD + 3]
            t_new = closed_form_adjoints(
                acc, ek, w3[:, lane], T[:, lane], Ul,
                [a[A_KD + c] for c in range(3)],
                [a[A_A + c] for c in range(3)], a[A_EMS], a[A_SUMS],
                a[A_INVP], a[A_CONT], a[A_MESH])
            T[:, lane] = torch.stack(t_new)
            U[:, lane] = Ul
        return acc.reshape(SPREAD, M_LANES, 8).sum(dim=0), ek

    def core(seed: int, tab, pix_base: int, target_local, timings=None):
        if dev.type != "cuda":
            timings = None
        with torch.no_grad():
            st, dumps = pipeline(seed, tab, pix_base=pix_base,
                                 timings=timings)
            sse, w3 = _timed(timings, "cotangent", 0, N, lambda: cotangent(
                st, pix_base, target_local))
            del st
            acc, ek = _timed(timings, "adjoints", 0, N,
                             lambda: adjoints(dumps, w3))
            return sse, acc.to(torch.float32), ek.to(torch.float32)

    ctx = dict(ctx, em_mesh=int(ctx["data"].em[0, 0]), pipeline=pipeline)
    return core, ctx


def make_bounce_train_step(scene: Scene, camera, target, *, samples: int,
                           max_depth: int, light_samples: int = 2,
                           sort: bool = True, dynamic_params: bool = False,
                           **options):
    """MSE train step against `target` [H, W, 3] over the bounce pipeline;
    gradients of the material tables in closed form.

    dynamic_params=False: `step(seed) -> (loss, grads)` over the scene's
    own materials, grads for mat_diffuse and mat_emissive.
    dynamic_params=True: `step(params, seed) -> (loss, grads)` with params
    over {mat_diffuse} only (the table's material columns are regathered
    each call, the tree is untouched); any other name raises ValueError.
    `seed` is the int32 PCG seed. `step.core` / `step.ctx` expose the
    computation."""
    core, ctx = make_bounce_train_core(
        scene, camera, samples=samples, max_depth=max_depth,
        light_samples=light_samples, sort=sort, **options)
    H, W, n_pix = ctx["H"], ctx["W"], ctx["n_pix"]
    M = int(scene.num_meshes)
    em_mesh = ctx["em_mesh"]
    target_flat = torch.as_tensor(target, dtype=torch.float32,
                                  device=scene.device).reshape(n_pix, 3)
    tab0 = ctx["data"].tab

    def _impl(seed: int, tab, timings=None):
        sse, acc, ek = core(int(seed), tab, 0, target_flat, timings=timings)
        loss = sse / float(H * W * 3)
        g_ke = acc[:M, 3:6].clone()
        g_ke[em_mesh] += ek
        return loss, {"mat_diffuse": acc[:M, 0:3], "mat_emissive": g_ke}

    if not dynamic_params:
        def step(seed: int, timings=None):
            return _impl(seed, tab0, timings)

        step.core, step.ctx = core, ctx
        return step

    update = tab_updater_from_bvh(ctx["bvh"], scene)

    def step_params(params, seed: int, timings=None):
        bad = set(params) - {"mat_diffuse"}
        if bad:
            raise ValueError(
                f"bounce-PRB differentiates mat_diffuse dynamically (the "
                f"fast-shadow NEE reads ke from the emitter records); got "
                f"{sorted(bad)}")
        with torch.no_grad():
            tab = update(mat_diffuse=params.get("mat_diffuse"))
        loss, g = _impl(seed, tab, timings)
        return loss, {k: g[k] for k in params}

    step_params.core, step_params.ctx = core, ctx
    return step_params


def bounce_train_reference_grads(scene: Scene, camera, target, seed: int, *,
                                 samples: int, max_depth: int,
                                 light_samples: int = 2):
    """(loss, grads) by torch autograd through the same estimator in plain
    PyTorch (a brute sweep of the same bundled table; LEGACY NEE, equal to
    the fast-shadow forward up to the light normal's rounding, with ke a
    live table value): the gradient oracle of make_bounce_train_step.
    torch.amax splits a tie evenly, like the closed form."""
    from orion_tpu_torch.accel.bvh import SAH, build_bvh
    from orion_tpu_torch.ops.fused_path import fused_reference_render

    bvh, _ = build_bvh(scene.numpy("tri_v0"), scene.numpy("tri_e1"),
                       scene.numpy("tri_e2"), scene.numpy("tri_valid"),
                       strategy=SAH, leaf_size=LEAF_WIDTH,
                       leaf_width=LEAF_WIDTH)
    update = tab_updater_from_bvh(bvh, scene)
    kd = scene.mat_diffuse.detach().clone().requires_grad_(True)
    ke = scene.mat_emissive.detach().clone().requires_grad_(True)
    img = fused_reference_render(scene, camera, seed, samples=samples,
                                 max_depth=max_depth,
                                 light_samples=light_samples,
                                 tab=update(kd, ke))
    diff = img - torch.as_tensor(target, dtype=torch.float32,
                                 device=scene.device)
    loss = torch.mean(diff * diff)
    g_kd, g_ke = torch.autograd.grad(loss, (kd, ke))
    return loss.detach(), {"mat_diffuse": g_kd, "mat_emissive": g_ke}
