"""Inverse rendering: optimize scene parameters against a target image.

The PyTorch counterpart of `orion_tpu.optim`. Pixel-loss gradients flow
through shading, sampling and intersection into material and geometry
tensors, so scene recovery is gradient descent:

    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.optim import fit
    result = fit(ps, target_image, params=("mat_diffuse",), steps=100)
    recovered_scene = result.scene

Gradient routes, as the JAX package chooses them (`_prb_loss_and_grad`):
  - point-light (Whitted) scenes, material tables only: the closed-form
    Whitted trainer (ops/prb_whitted.py) over the scene's intersect;
  - path scenes inside the fused-train gate, mat_diffuse / mat_emissive
    only, MSE: the path-replay kernels (ops/prb.py) through the
    autograd.Function `FusedPathPRB`;
  - everything else: wavefront autograd through `render`.
The JAX package's other routes (the bounce-pipeline PRB and the BVH PRB past
the fused gate, and the BVH refit loss for geometry on a BVH backend) are
not ported: `fit` raises NotImplementedError naming the piece rather than
take another route.

Optimizers: `optimizer` is a callable `params -> torch.optim.Optimizer`
over the list of parameter tensors; the default, `torch.optim.Adam` at
`learning_rate`, has the update rule of optax.adam.

Step seeds: with resample_keys=False every step uses `seed`; otherwise a
torch.Generator seeded with `seed` draws one int32 seed per step. The seed
is the PCG seed of the path-replay kernels, seeds the Whitted trainer's
jitter generator, and seeds the wavefront's torch.Generator.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from orion_tpu_torch.render import IntersectFn, render
from orion_tpu_torch.scene import Scene

# parameters that are physically meaningful in [0, 1]
UNIT_INTERVAL_PARAMS = ("mat_diffuse", "mat_specular", "mat_ambient",
                        "tex_atlas")

DEFAULT_PARAMS = ("mat_diffuse",)

# parameters that move geometry: on a BVH backend the JAX package refits
# the tree every step (make_refit_loss)
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


def make_loss(scene: Scene, camera, *, samples: int, max_depth: int,
              light_samples: int, mode: Optional[str],
              intersect: Optional[IntersectFn],
              loss_fn: Optional[Callable] = None,
              remat: bool = False,
              fold_samples: bool = False):
    """`loss(params, generator, target)` over a base scene: wavefront
    render of the scene with `params` substituted, then MSE (or
    `loss_fn(img, target)`). Differentiable through autograd."""

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


def make_refit_loss(ps, **kwargs):
    """Geometry optimization on a BVH backend (the JAX package refits the
    tree's values from the moving vertices every step): not ported."""
    raise NotImplementedError(
        "make_refit_loss (geometry fits over a refitted BVH, "
        "orion_tpu.optim.make_refit_loss) is not ported yet; fit geometry "
        "on the brute backend (prepare(..., force_backend='brute'))")


def _prb_loss_and_grad(ps, target, params, *, samples, max_depth,
                       light_samples, mode, loss_fn):
    """The closed-form trainer for this setup, as `(params, seed) ->
    (loss, grads)`, or None (wavefront autograd). Raises
    NotImplementedError where the JAX package would take a trainer that
    is not ported."""
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
    from orion_tpu_torch.ops.fused_path import bvh_path_supported
    from orion_tpu_torch.ops.prb import (M_LANES, MAX_SAMPLES,
                                         fused_train_supported,
                                         make_fused_train_step)

    if fused_train_supported(scene, samples):
        return make_fused_train_step(scene, ps.camera, target,
                                     samples=samples, max_depth=max_depth,
                                     light_samples=light_samples,
                                     dynamic_params=True)
    # past the fused gate the JAX package trains with the bounce-pipeline
    # PRB (diffuse only) or the BVH PRB; neither is ported
    one_emitter = (bvh_path_supported(scene) and scene.num_meshes <= M_LANES
                   and scene.num_emissive == 1)
    if set(params) <= {"mat_diffuse"} and one_emitter:
        raise NotImplementedError(
            "the bounce-pipeline PRB trainer (orion_tpu.ops.pallas_bounce_prb"
            ") for scenes past the fused-train gate is not ported yet")
    if one_emitter and samples <= MAX_SAMPLES:
        raise NotImplementedError(
            "the BVH PRB trainer (orion_tpu.ops.pallas_bvh_prb) for scenes "
            "past the fused-train gate is not ported yet")
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
    if (any(p in GEOMETRY_PARAMS for p in params)
            and str(getattr(ps, "backend", "")).startswith("bvh")):
        make_refit_loss(ps)
    dev = ps.scene.device
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    theta = {name: getattr(ps.scene, name).detach().clone()
             .to(torch.float32).requires_grad_(True) for name in params}
    opt = (optimizer if optimizer is not None
           else lambda p: torch.optim.Adam(p, lr=learning_rate))(
               list(theta.values()))

    prb = None
    if use_prb:
        prb = _prb_loss_and_grad(ps, target, params, samples=samples,
                                 max_depth=max_depth,
                                 light_samples=light_samples, mode=mode,
                                 loss_fn=loss_fn)
        if prb is None and use_prb is True:
            raise ValueError("use_prb=True but the setup is outside the "
                             "PRB gate (params/mode/loss/scene)")

    if prb is not None:
        def value_and_grad(theta, step_seed):
            return prb({k: v.detach() for k, v in theta.items()}, step_seed)
    else:
        loss = make_loss(ps.scene, ps.camera, samples=samples,
                         max_depth=max_depth, light_samples=light_samples,
                         mode=mode, intersect=ps.intersect, loss_fn=loss_fn)

        def value_and_grad(theta, step_seed):
            gen = torch.Generator(device=dev)
            gen.manual_seed(step_seed)
            value = loss(theta, gen, target)
            grads = torch.autograd.grad(value, list(theta.values()),
                                        allow_unused=True)
            return value.detach(), {
                k: torch.zeros_like(v) if g is None else g
                for (k, v), g in zip(theta.items(), grads)}

    seeds = torch.Generator()
    seeds.manual_seed(seed)
    losses = []
    for i in range(steps):
        step_seed = (int(torch.randint(0, 2**31 - 1, (1,), generator=seeds))
                     if resample_keys else seed)
        value, grads = value_and_grad(theta, step_seed)
        opt.zero_grad(set_to_none=True)
        for k, v in theta.items():
            v.grad = grads[k].to(v.dtype)
        opt.step()
        _project(theta)
        losses.append(float(value))
        if callback is not None:
            callback(i, losses[-1])

    out = {k: v.detach() for k, v in theta.items()}
    return FitResult(scene=dataclasses.replace(ps.scene, **out),
                     params=out, losses=losses, steps=steps)
