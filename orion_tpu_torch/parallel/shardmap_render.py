"""Ray sharding with a stream per rank: every kernel route, any intersect.

The PyTorch counterpart of `orion_tpu.parallel.shardmap_render`. In the
JAX package this is the shard_map path: each chip runs the whole
wavefront, Pallas kernels included, on its ray shard, and folds its mesh
index into the key. Here each rank runs the wavefront over any
IntersectFn (the brute kernel, the BVH walk kernel, G8) on its tile of
the pixel wavefront (parallel/sharding.Mesh.tile), with the scene on its
device, and one all-gather assembles the image.

RNG, the fold: the jitter of a sample is drawn from the caller's
generator, identical on every rank. In a world of W > 1 ranks, each
sample then draws one 63-bit integer k from it too, and rank r traces
its tile on a generator seeded with splitmix64(k + (r + 1) * 0x9E3779B97
F4A7C15) (`rank_generator`), with draws of its tile's width. So ranks
trace independent streams, the shared generator advances alike on every
rank and by the same amount for every sample (a chunked render resumes
sample for sample, io/checkpoint.py), and an image is deterministic per
(generator state, world size) but not equal across world sizes. A world
of one traces on the caller's generator itself: its image is `render`'s
(the JAX CLI's "no-op on one device").

Training: `make_train_step_shardmap` differentiates the tile's trace
with autograd and all-reduces the gradients and loss in one buffer
(parallel/sharding.sharded_step).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from orion_tpu_torch.camera import Camera
from orion_tpu_torch.parallel.distributed import all_gather_rows
from orion_tpu_torch.parallel.sharding import (Mesh, check_placement,
                                               apply_params, make_mesh,
                                               render_tile, sharded_step)
from orion_tpu_torch.render import IntersectFn
from orion_tpu_torch.scene import Scene

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def splitmix64(x: int) -> int:
    """SplitMix64's output function of x (a fixed 64-bit hash)."""
    z = (x + _GOLDEN) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def rank_generator(generator: torch.Generator, mesh: Mesh) -> torch.Generator:
    """This rank's trace generator: one 63-bit draw k from the shared
    `generator`, folded with the rank as the module docstring says."""
    k = int(torch.randint(0, 2**63 - 1, (1,), generator=generator,
                          device=generator.device, dtype=torch.int64))
    g = torch.Generator(device=mesh.device)
    g.manual_seed(splitmix64((k + (mesh.rank + 1) * _GOLDEN) & _M64))
    return g


def shardmap_tile(scene: Scene, camera: Camera, generator: torch.Generator,
                  mesh: Mesh, **kw) -> torch.Tensor:
    """This rank's tile [hi - lo, 3] of render_shardmap's image."""
    H, W = camera.yres, camera.xres
    lo, hi = mesh.tile(H * W)
    fold = None if mesh.world == 1 else (
        lambda g: rank_generator(g, mesh))
    return render_tile(scene, camera, generator, lo, hi,
                       trace_generator=fold, **kw)


def render_shardmap(scene: Scene, camera: Camera,
                    generator: torch.Generator, *,
                    mesh: Optional[Mesh] = None, samples: int = 1,
                    max_depth: int = 1, light_samples: int = 2,
                    mode: Optional[str] = None,
                    intersect: Optional[IntersectFn] = None,
                    shadow_intersect: Optional[IntersectFn] = None
                    ) -> torch.Tensor:
    """[H, W, 3], rays sharded over `mesh` (default: make_mesh()), each
    rank tracing its tile on its own stream (module docstring) over
    `intersect` (default: the brute sweep), `shadow_intersect` for
    Whitted shadow rays. Every rank passes an identical `generator` and
    gets the whole image."""
    if mesh is None:
        mesh = make_mesh()
    check_placement("render_shardmap", mesh, scene)
    H, W = camera.yres, camera.xres
    tile = shardmap_tile(scene, camera, generator, mesh, samples=samples,
                         max_depth=max_depth, light_samples=light_samples,
                         mode=mode, intersect=intersect,
                         shadow_intersect=shadow_intersect)
    return all_gather_rows(tile, H * W, mesh).reshape(H, W, 3)


def make_train_step_shardmap(scene: Scene, camera: Camera, mesh: Mesh, *,
                             samples: int = 1, max_depth: int = 2,
                             light_samples: int = 1,
                             mode: Optional[str] = None, lr: float = 1e-2,
                             intersect: Optional[IntersectFn] = None):
    """`step(params, generator, target) -> (new params, loss)`: SGD on
    pixel MSE with each rank tracing its tile on its own stream over
    `intersect`; gradients and loss all-reduced in one buffer. prune_zero
    is off, as in the JAX package."""
    check_placement("make_train_step_shardmap", mesh, scene)
    kw = dict(samples=samples, max_depth=max_depth,
              light_samples=light_samples, mode=mode, intersect=intersect,
              prune_zero=False)

    def train_step(params: Dict[str, torch.Tensor], generator, target):
        return sharded_step(
            params, target, mesh, lr,
            lambda leaves: shardmap_tile(apply_params(scene, leaves), camera,
                                         generator, mesh, **kw))

    return train_step
