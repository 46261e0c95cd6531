"""Ray sharding over a `torch.distributed` process group.

The PyTorch counterpart of `orion_tpu.parallel.sharding`. The reference
fans pixels out over OpenMP threads (raytracer.cpp:69-88); the JAX
package shards the pixel wavefront over a 1-D `rays` mesh of chips. Here
a mesh is a process group with one rank per device (`Mesh`,
`make_mesh`): every rank holds the whole scene on its device, traces its
own tile of the pixel wavefront, and one all-gather
(parallel/distributed.all_gather_rows) gives every rank the whole image.

Tiles: rank r of W traces the row-major pixels [r per, min((r + 1) per,
N)) with per = ceil(N / W) (`Mesh.tile`); tiles are padded to `per` for
the gather and the padding is cut after it.

RNG: `render_sharded` keeps the JAX package's global-stream guarantee.
Every rank holds a copy of the same `torch.Generator` and draws the whole
image's uniforms in the single-device order, keeping its tile's slice
(render.trace_wavefront(tile=)), so its image is bit-identical to one
device's `render` of the same generator, at any world size. Drawing N
uniforms a bounce on every rank is what that costs.

Training: `make_train_step`'s step renders its tile, backpropagates the
tile's squared error (normalised by the whole image's H W 3) locally,
and all-reduces the gradients and the loss as ONE flattened buffer: the
only collective of a step.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from orion_tpu_torch.camera import Camera, primary_rays
from orion_tpu_torch.parallel.distributed import (all_gather_rows,
                                                  all_reduce_sum)
from orion_tpu_torch.render import _rand, render, trace_wavefront
from orion_tpu_torch.scene import Scene

RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks along RAY_AXIS: this process's place in it and
    its device. group None is a world of one with no process group (no
    collective is issued)."""

    group: Optional[object]
    rank: int
    world: int
    device: torch.device

    def per(self, n: int) -> int:
        """Rows of each rank's tile of n: ceil(n / world)."""
        return -(-n // self.world)

    def tile(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's tile of n row-major items."""
        per = self.per(n)
        lo = min(self.rank * per, n)
        return lo, min(lo + per, n)


def make_mesh(device=None, group=None) -> Mesh:
    """This rank's Mesh over `group` (default: the initialised default
    group, else a world of one). `device` defaults to cuda:LOCAL_RANK
    (torchrun's local rank, 0 without it); a device that does not exist
    raises, and nothing moves to the CPU or to another card."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh: {device} asked for, but no CUDA "
                               "device is available")
        index = 0 if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"make_mesh: {device} does not exist "
                               f"({torch.cuda.device_count()} CUDA "
                               "device(s))")
        device = torch.device("cuda", index)
    elif device.type != "cpu":
        raise ValueError(f"make_mesh: unsupported device {device}")
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(None, 0, 1, device)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                device)


def check_placement(name: str, mesh: Mesh, scene: Scene) -> None:
    """Raise ValueError unless the scene lies on the rank's device."""
    if scene.device != mesh.device:
        raise ValueError(f"{name}: the scene is on {scene.device}, this "
                         f"rank's device is {mesh.device}")


def render_tile(scene: Scene, camera: Camera, generator: torch.Generator,
                lo: int, hi: int, *, samples: int = 1, max_depth: int = 1,
                light_samples: int = 2, mode: Optional[str] = None,
                shared_jitter: bool = True, trace_generator=None,
                **trace) -> torch.Tensor:
    """[hi - lo, 3]: rows [lo, hi) of the row-major [H*W, 3] image that
    `render` draws from `generator`, bit for bit: the jitter and the
    primary rays are the whole image's, and every bounce draws the whole
    wavefront's uniforms and keeps the tile's slice.

    trace_generator: None, or `g(generator) -> torch.Generator` called
    once a sample after its jitter; the tile then traces on that
    generator's stream with draws of its own width (the per-rank streams
    of parallel/shardmap_render.py). `trace` goes to trace_wavefront."""
    H, W = camera.yres, camera.xres
    dev = camera.device
    acc = torch.zeros((hi - lo, 3), dtype=torch.float32, device=dev)
    for _ in range(samples):
        jit = _rand(generator, (2,) if shared_jitter else (2, H, W), dev)
        orig, dirs = primary_rays(camera, jit[0] * (2.0 / W),
                                  jit[1] * (2.0 / H))
        if trace_generator is None:
            gen, tile = generator, (lo, H * W)
        else:
            gen, tile = trace_generator(generator), None
        acc = acc + trace_wavefront(scene, orig[lo:hi], dirs[lo:hi], gen,
                                    max_depth=max_depth,
                                    light_samples=light_samples, mode=mode,
                                    tile=tile, **trace)
    return acc / float(samples)


def render_sharded(scene: Scene, camera: Camera,
                   generator: torch.Generator, *,
                   mesh: Optional[Mesh] = None, samples: int = 1,
                   max_depth: int = 1, light_samples: int = 2,
                   mode: Optional[str] = None,
                   shared_jitter: bool = True) -> torch.Tensor:
    """Render [H, W, 3] with the pixel wavefront sharded over `mesh`
    (default: make_mesh()), on the brute sweep (its kernel on the card).
    Every rank passes an identical `generator` (same seed, same state)
    on its device and gets the whole image, bit-identical to `render`'s
    on one device with that generator, at any world size."""
    if mesh is None:
        mesh = make_mesh()
    check_placement("render_sharded", mesh, scene)
    H, W = camera.yres, camera.xres
    lo, hi = mesh.tile(H * W)
    tile = render_tile(scene, camera, generator, lo, hi, samples=samples,
                       max_depth=max_depth, light_samples=light_samples,
                       mode=mode, shared_jitter=shared_jitter)
    return all_gather_rows(tile, H * W, mesh).reshape(H, W, 3)


# ---------------------------------------------------------------------------
# Differentiable training step (inverse rendering)
# ---------------------------------------------------------------------------

# scene fields exposed as trainable parameters
TRAINABLE_FIELDS = ("tri_v0", "tri_e1", "tri_e2",
                    "mat_diffuse", "mat_specular", "mat_emissive",
                    "mat_ambient")


def scene_params(scene: Scene) -> Dict[str, torch.Tensor]:
    """The differentiable parameters of a scene, by field name."""
    return {f: getattr(scene, f) for f in TRAINABLE_FIELDS}


def apply_params(scene: Scene, params: Dict[str, torch.Tensor]) -> Scene:
    return dataclasses.replace(scene, **params)


def sharded_step(params: Dict[str, torch.Tensor], target: torch.Tensor,
                 mesh: Optional[Mesh], lr: float, local_image):
    """One SGD step of pixel MSE. local_image(params) is this rank's tile
    [hi - lo, 3] of the image (the whole image without a mesh); the
    tile's squared error is normalised by the whole image's size and
    backpropagated locally, then gradients and loss cross the ranks as
    ONE flattened all-reduce. Returns (new params, loss)."""
    names = list(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    n = target.numel()
    flat = target.reshape(-1, 3)
    if mesh is None:
        lo, hi = 0, flat.shape[0]
    else:
        lo, hi = mesh.tile(flat.shape[0])
    diff = local_image(leaves) - flat[lo:hi]
    loss = torch.sum(diff * diff) / float(n)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                allow_unused=True)
    grads = [torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(names, grads)]
    buf = torch.cat([g.reshape(-1) for g in grads]
                    + [loss.detach().reshape(1)])
    if mesh is not None:
        buf = all_reduce_sum(buf, mesh)
    out, at = {}, 0
    for k, g in zip(names, grads):
        out[k] = (params[k].detach()
                  - lr * buf[at:at + g.numel()].reshape(g.shape))
        at += g.numel()
    return out, buf[at]


def make_train_step(scene: Scene, camera: Camera, *, samples: int = 1,
                    max_depth: int = 2, light_samples: int = 1,
                    mode: Optional[str] = None, lr: float = 1e-2,
                    mesh: Optional[Mesh] = None):
    """`step(params, generator, target) -> (new params, loss)`: one SGD
    step minimising pixel MSE against `target` [H, W, 3] through the
    differentiable wavefront (loss -> shading -> sampling -> intersection
    -> vertices and materials). With a mesh, each rank traces its tile of
    the global stream (as render_sharded) and the gradients and loss are
    all-reduced in one buffer; without, the step renders the whole image
    (`render`). prune_zero is off, as in the JAX package."""
    if mesh is not None:
        check_placement("make_train_step", mesh, scene)
    H, W = camera.yres, camera.xres
    kw = dict(samples=samples, max_depth=max_depth,
              light_samples=light_samples, mode=mode, prune_zero=False)

    def train_step(params, generator, target):
        def local_image(leaves):
            s = apply_params(scene, leaves)
            if mesh is None:
                return render(s, camera, generator, **kw).reshape(-1, 3)
            lo, hi = mesh.tile(H * W)
            return render_tile(s, camera, generator, lo, hi, **kw)

        return sharded_step(params, target, mesh, lr, local_image)

    return train_step
