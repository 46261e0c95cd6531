"""Inverse rendering: optimize scene parameters against a target image.

The PyTorch counterpart of `orion_tpu.optim`. Pixel-loss gradients flow
through shading, sampling and intersection into material and geometry
tensors, so scene recovery is gradient descent:

    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.optim import fit
    result = fit(ps, target_image, params=("mat_diffuse",), steps=100)
    recovered_scene = result.scene

Gradient routes, as the JAX package chooses them (`_prb_loss_and_grad`,
`fit`):
  - geometry (tri_v0 / tri_e1 / tri_e2) on a BVH backend: wavefront
    autograd through the walk kernel (ops/bvh_intersect.py) over the tree
    refitted to the current vertices every step (`make_refit_loss`,
    accel/refit.py); this takes precedence over the closed forms;
  - point-light (Whitted) scenes, material tables only: the closed-form
    Whitted trainer (ops/prb_whitted.py) over the scene's intersect;
  - path scenes inside the fused-train gate, mat_diffuse / mat_emissive
    only, MSE: the path-replay kernels (ops/prb.py) through the
    autograd.Function `FusedPathPRB`;
  - path scenes past that gate with one small emitter: mat_diffuse only,
    the closed-form trainer over the bounce pipeline (ops/bounce_prb.py);
    with mat_emissive, the path-replay kernels over a BVH (ops/bvh_prb.py);
  - everything else: wavefront autograd through `render`.

Optimizers: `optimizer` is a callable `params -> torch.optim.Optimizer`
over the list of parameter tensors; the default, `torch.optim.Adam` at
`learning_rate`, has the update rule of optax.adam.

Step seeds: with resample_keys=False every step uses `seed`; otherwise a
torch.Generator seeded with `seed` draws one int32 seed per step. The seed
is the PCG seed of the path-replay kernels, seeds the Whitted trainer's
jitter generator, and seeds the wavefront's torch.Generator.

Where the host waits: a step is queued whole (gradients, update,
projection) before its loss is read. A step whose loss carries its own
host copy (the path-replay kernels' steps, ops/prb.train_step_over) is
read as soon as that copy lands, so the host issues the next step while
the card still runs this one's replay and update; any other loss is read
by `float`, which waits for everything queued. `fit` returns once the
card has finished all it queued.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from orion_tpu_torch.profiling import count, span
from orion_tpu_torch.render import IntersectFn, render
from orion_tpu_torch.scene import Scene

# parameters that are physically meaningful in [0, 1]
UNIT_INTERVAL_PARAMS = ("mat_diffuse", "mat_specular", "mat_ambient",
                        "tex_atlas")

DEFAULT_PARAMS = ("mat_diffuse",)

# parameters that move geometry: on a BVH backend fit refits the tree
# every step (make_refit_loss), as the JAX package does
GEOMETRY_PARAMS = ("tri_v0", "tri_e1", "tri_e2")


@dataclasses.dataclass
class FitResult:
    scene: Scene
    params: Dict[str, torch.Tensor]
    losses: list
    steps: int


def _project(params: Dict[str, torch.Tensor]) -> None:
    """Clamp albedos into [0, 1] and emission to >= 0, in place."""
    with torch.no_grad():
        for k, v in params.items():
            if k in UNIT_INTERVAL_PARAMS:
                v.clamp_(0.0, 1.0)
            elif k == "mat_emissive":
                v.clamp_(min=0.0)


def _read_loss(value) -> float:
    """A step's loss as a float: from its own host copy once that copy's
    event has passed (`host_copy`, counter `fit.loss_event`), else
    `float(value)`."""
    early = getattr(value, "host_copy", None)
    if early is None:
        return float(value)
    host, done = early
    done.synchronize()
    count("fit.loss_event")
    return float(host)


def make_loss(scene: Scene, camera, *, samples: int, max_depth: int,
              light_samples: int, mode: Optional[str],
              intersect: Optional[IntersectFn],
              loss_fn: Optional[Callable] = None,
              remat: bool = False,
              fold_samples: bool = False):
    """`loss(params, generator, target)` over a base scene: wavefront
    render of the scene with `params` substituted, then MSE (or
    `loss_fn(img, target)`). Differentiable through autograd; `remat` and
    `fold_samples` are render's (remat trades the backward pass's memory
    for a recompute of each bounce's shading, never of its intersects)."""

    def loss(params, generator, target):
        s = dataclasses.replace(scene, **params)
        # prune_zero=False: zero-valued specular still carries gradient
        # through its (pruned-in-forward-renders) reflection subpath
        img = render(s, camera, generator, samples=samples,
                     max_depth=max_depth, light_samples=light_samples,
                     mode=mode, intersect=intersect, prune_zero=False,
                     remat=remat, fold_samples=fold_samples)
        if loss_fn is not None:
            return loss_fn(img, target)
        return torch.mean((img - target) ** 2)

    return loss


def make_refit_loss(ps, *, samples: int, max_depth: int,
                    light_samples: int, mode: Optional[str],
                    loss_fn: Optional[Callable] = None,
                    remat: bool | str = "hits"):
    """(loss, plan) for geometry fits on a BVH backend.

    loss(params, generator, target, nodes, tri) renders the wavefront with
    `params` substituted into the scene, its intersect the walk kernel
    (ops/bvh_intersect.bvh_walk) over the REFITTED tree `nodes`, `tri`
    that `plan.refit(v0, e1, e2)` (accel/refit.RefitPlan of ps.bvh) gives
    for the current vertices, so vertex motion never stales the tree. Hits
    are detached (ids from the walk); t, u, v and shading are recomputed
    differentiably from the live scene (the contract of ops/intersect.py),
    so gradients reach the vertices. MSE, or `loss_fn(img, target)`.

    remat: render.trace_wavefront's; the default "hits" checkpoints each
    bounce's shading and keeps its walk results, so the backward pass
    recomputes the shading and never re-runs the walk kernel.
    """
    from orion_tpu_torch.accel.refit import RefitPlan
    from orion_tpu_torch.ops.bvh_intersect import make_bvh_intersect_kernel

    bvh = getattr(ps, "bvh", None)
    if bvh is None:
        raise ValueError(f"backend {ps.backend!r} carries no refittable "
                         "tree; use force_backend='brute' for geometry fits")
    plan = RefitPlan(bvh)
    scene, camera = ps.scene, ps.camera

    def loss(params, generator, target, nodes, tri):
        s = dataclasses.replace(scene, **params)
        intersect = make_bvh_intersect_kernel(bvh, scene, layout=(nodes, tri))
        img = render(s, camera, generator, samples=samples,
                     max_depth=max_depth, light_samples=light_samples,
                     mode=mode, intersect=intersect, prune_zero=False,
                     remat=remat)
        if loss_fn is not None:
            return loss_fn(img, target)
        return torch.mean((img - target) ** 2)

    return loss, plan


def _prb_loss_and_grad(ps, target, params, *, samples, max_depth,
                       light_samples, mode, loss_fn):
    """The closed-form trainer for this setup, as `(params, seed) ->
    (loss, grads)`, or None (wavefront autograd)."""
    if loss_fn is not None:
        return None
    scene = ps.scene
    whitted = (mode == "whitted"
               or (mode is None and int(scene.num_lights) > 0))
    if whitted:
        from orion_tpu_torch.ops.prb_whitted import (
            WHITTED_PARAMS, make_whitted_train_step, whitted_train_supported)

        if not set(params) <= set(WHITTED_PARAMS):
            return None
        if not whitted_train_supported(scene):
            return None
        return make_whitted_train_step(
            scene, ps.camera, target, samples=samples, max_depth=max_depth,
            intersect=ps.intersect,
            shadow_intersect=getattr(ps, "shadow_intersect", None))
    if mode not in (None, "path"):
        return None
    if not set(params) <= {"mat_diffuse", "mat_emissive"}:
        return None
    from orion_tpu_torch.ops.prb import (fused_train_supported,
                                         make_fused_train_step)

    if fused_train_supported(scene, samples):
        return make_fused_train_step(scene, ps.camera, target,
                                     samples=samples, max_depth=max_depth,
                                     light_samples=light_samples,
                                     dynamic_params=True)
    # past the fused gate: the closed-form trainer over the bounce
    # pipeline for diffuse-only fits (its fast-shadow NEE reads ke from the
    # emitter records, so mat_emissive fits go to the BVH PRB, as in JAX),
    # unless its wavefront is more than the card holds
    from orion_tpu_torch.ops.bounce import bounce_lanes_supported
    from orion_tpu_torch.ops.bounce_prb import (make_bounce_train_step,
                                                wavefront_train_supported)

    one_emitter = wavefront_train_supported(scene)
    lanes = ps.camera.xres * ps.camera.yres * samples
    if (set(params) <= {"mat_diffuse"} and one_emitter
            and bounce_lanes_supported(lanes, scene.device, with_aux=True,
                                       max_depth=max_depth)):
        return make_bounce_train_step(scene, ps.camera, target,
                                      samples=samples, max_depth=max_depth,
                                      light_samples=light_samples,
                                      dynamic_params=True)
    from orion_tpu_torch.ops.bvh_prb import (bvh_train_supported,
                                             make_bvh_train_step)

    if bvh_train_supported(scene, samples):
        return make_bvh_train_step(
            scene, ps.camera, target, samples=samples, max_depth=max_depth,
            light_samples=light_samples,
            order_signs=getattr(ps, "order_signs", (1.0, 1.0, 1.0)),
            dynamic_params=True)
    return None


def fit(ps, target, *, params: Sequence[str] = DEFAULT_PARAMS,
        steps: int = 100, learning_rate: float = 5e-2,
        optimizer: Optional[Callable] = None,
        samples: int = 1, max_depth: int = 2, light_samples: int = 1,
        mode: Optional[str] = None, seed: int = 0,
        resample_keys: bool = True,
        loss_fn: Optional[Callable] = None,
        use_prb: str | bool = "auto",
        callback: Optional[Callable[[int, float], None]] = None
        ) -> FitResult:
    """Fit `params` of a PreparedScene to a target [H, W, 3] image.

    resample_keys=True draws a fresh seed per step (stochastic gradient
    over the path space); False holds `seed` fixed (a deterministic
    objective). use_prb: "auto" takes a closed-form trainer (path-replay
    kernels or the Whitted closed form) whenever the scene, params and
    loss fit its gate and wavefront autograd otherwise; False forces
    wavefront autograd; True requires a closed-form trainer and raises if
    the gate rejects the setup. The path-replay kernels draw their own
    PCG4D stream, so their losses differ from the wavefront's at the
    noise level.
    """
    with span("fit"):
        with span("fit.setup"):
            theta, opt, value_and_grad = _fit_setup(
                ps, target, params, learning_rate=learning_rate,
                optimizer=optimizer, samples=samples, max_depth=max_depth,
                light_samples=light_samples, mode=mode, loss_fn=loss_fn,
                use_prb=use_prb)
        seeds = torch.Generator()
        seeds.manual_seed(seed)
        losses = []
        for i in range(steps):
            step_seed = (int(torch.randint(0, 2**31 - 1, (1,),
                                           generator=seeds))
                         if resample_keys else seed)
            with span("fit.step"):
                with span("fit.step.grad"):
                    value, grads = value_and_grad(theta, step_seed)
                with span("fit.step.update"):
                    opt.zero_grad(set_to_none=True)
                    for k, v in theta.items():
                        v.grad = grads[k].to(v.dtype)
                    opt.step()
                    _project(theta)
                with span("fit.step.loss_read"):
                    losses.append(_read_loss(value))
            if callback is not None:
                callback(i, losses[-1])
        if ps.scene.device.type == "cuda":
            # the last step's replay and update may still be queued
            torch.cuda.current_stream(ps.scene.device).synchronize()

    out = {k: v.detach() for k, v in theta.items()}
    return FitResult(scene=dataclasses.replace(ps.scene, **out),
                     params=out, losses=losses, steps=steps)


def _fit_setup(ps, target, params, *, learning_rate, optimizer, samples,
               max_depth, light_samples, mode, loss_fn, use_prb):
    """fit's parameters, optimizer and `value_and_grad(theta, step_seed)
    -> (loss, grads)` on the route fit takes (the module docstring)."""
    dev = ps.scene.device
    refit_loss = refit_plan = None
    if (any(p in GEOMETRY_PARAMS for p in params)
            and str(getattr(ps, "backend", "")).startswith("bvh")):
        # moving geometry over a tree backend: refit the tree's values from
        # the current vertices every step (fixed topology)
        refit_loss, refit_plan = make_refit_loss(
            ps, samples=samples, max_depth=max_depth,
            light_samples=light_samples, mode=mode, loss_fn=loss_fn)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    theta = {name: getattr(ps.scene, name).detach().clone()
             .to(torch.float32).requires_grad_(True) for name in params}
    opt = (optimizer if optimizer is not None
           else lambda p: torch.optim.Adam(p, lr=learning_rate))(
               list(theta.values()))

    prb = None
    if use_prb and refit_plan is None:
        prb = _prb_loss_and_grad(ps, target, params, samples=samples,
                                 max_depth=max_depth,
                                 light_samples=light_samples, mode=mode,
                                 loss_fn=loss_fn)
        if prb is None and use_prb is True:
            raise ValueError("use_prb=True but the setup is outside the "
                             "PRB gate (params/mode/loss/scene)")

    def autograd_step(loss, extra=lambda: ()):
        def value_and_grad(theta, step_seed):
            gen = torch.Generator(device=dev)
            gen.manual_seed(step_seed)
            value = loss(theta, gen, target, *extra())
            grads = torch.autograd.grad(value, list(theta.values()),
                                        allow_unused=True)
            return value.detach(), {
                k: torch.zeros_like(v) if g is None else g
                for (k, v), g in zip(theta.items(), grads)}

        return value_and_grad

    if refit_plan is not None:
        def refitted():
            return refit_plan.refit(
                *(theta[n].detach() if n in theta else getattr(ps.scene, n)
                  for n in GEOMETRY_PARAMS), device=dev)

        value_and_grad = autograd_step(refit_loss, refitted)
    elif prb is not None:
        def value_and_grad(theta, step_seed):
            return prb({k: v.detach() for k, v in theta.items()}, step_seed)
    else:
        value_and_grad = autograd_step(make_loss(
            ps.scene, ps.camera, samples=samples, max_depth=max_depth,
            light_samples=light_samples, mode=mode, intersect=ps.intersect,
            loss_fn=loss_fn))

    return theta, opt, value_and_grad
