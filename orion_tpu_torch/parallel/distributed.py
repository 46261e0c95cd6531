"""Process groups and the collectives of the ray-sharded paths.

The PyTorch counterpart of `orion_tpu.parallel.distributed`. JAX drives
every chip of a host from one process (`jax.distributed.initialize`
joins the hosts); the PyTorch idiom is one process per device, started by
`torchrun`, with the collectives outside the kernels. So a "mesh" here is
a `torch.distributed` process group with one rank per device
(parallel/sharding.py), and this module brings the group up and issues
the few collectives the sharded paths need:

    torchrun --nproc-per-node 4 -m orion_tpu_torch.cli scene.rtc --shard

Forward rendering needs one all-gather of the image tiles; a train step
one all-reduce of the flattened gradients and loss. Every collective of
the package goes through `all_gather_rows`, `all_reduce_sum` or
`broadcast_object` here, which is what `measure_collective_bytes` counts
(the JAX package reads the compiled HLO instead).

gloo moves host memory: a CUDA tensor handed to a gloo group is staged
through the host (gloo's own CUDA support varies by collective and
build). NCCL refuses two ranks on one device, so a world of several ranks
on one card runs on gloo, and says so.

`render_multihost` splits the samples instead of the pixels: each rank
renders its share of the samples on its device (`render(sample_offset=)`
skips the samples of the ranks before it in the shared stream), and one
all-gather merges the weighted parts.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.distributed as dist

# the collective kinds measure_collective_bytes reports (the JAX
# package's four, plus the checkpoint's broadcast)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute",
         "broadcast")

# the open recorders of measure_collective_bytes / record_collectives
_RECORDERS: list = []


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> dict:
    """Join (or start) the process group, or stay a world of one.

    With explicit `world_size` and `rank` (and an `init_method`, e.g.
    "tcp://localhost:29500" or "file:///tmp/x", default "env://"), or with
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
    LOCAL_RANK), calls `init_process_group`; with neither it initialises
    nothing. A group already initialised is kept. `backend` defaults to
    "nccl" where CUDA is available and "gloo" elsewhere; an NCCL rank
    makes cuda:LOCAL_RANK its current device.

    Returns the JAX package's summary: process_index, process_count,
    local_devices (the devices this process drives: one), global_devices
    (one per rank)."""
    if not dist.is_initialized():
        env = "WORLD_SIZE" in os.environ and "RANK" in os.environ
        if world_size is not None or rank is not None or env:
            if backend is None:
                backend = "nccl" if torch.cuda.is_available() else "gloo"
            if backend == "nccl":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            kw = {}
            if world_size is not None:
                kw["world_size"] = world_size
            if rank is not None:
                kw["rank"] = rank
            dist.init_process_group(backend=backend,
                                    init_method=init_method or "env://",
                                    **kw)
    idx, count = ((dist.get_rank(), dist.get_world_size())
                  if dist.is_initialized() else (0, 1))
    return {"process_index": idx, "process_count": count,
            "local_devices": 1, "global_devices": count}


def _record(kind: str, nbytes: int) -> None:
    for rec in _RECORDERS:
        rec.append((kind, nbytes))


def _on_host(group, t: torch.Tensor) -> bool:
    """Whether `t` is staged through the host: a CUDA tensor in a gloo
    group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_rows(x: torch.Tensor, n_total: int, mesh) -> torch.Tensor:
    """Every rank's tile of rows, in rank order, cut to `n_total` rows.

    `x` is this rank's tile ([n_local, ...], n_local <= mesh.per(n_total));
    it is padded to the common tile size for the gather and the padding
    is dropped after it. A world without a process group returns `x`."""
    if mesh.group is None:
        return x
    per = mesh.per(n_total)
    pad = torch.zeros((per - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    t = torch.cat([x, pad]).contiguous()
    host = _on_host(mesh.group, t)
    src = t.cpu() if host else t
    out = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(out, src, group=mesh.group)
    full = torch.cat(out)[:n_total]
    if host:
        full = full.to(x.device)
    _record("all-gather", t.numel() * t.element_size() * mesh.world)
    return full


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of `x` over the ranks (a new tensor; `x` is untouched). A
    world without a process group returns `x`."""
    if mesh.group is None:
        return x
    t = x.detach().clone().contiguous()
    host = _on_host(mesh.group, t)
    src = t.cpu() if host else t
    dist.all_reduce(src, op=dist.ReduceOp.SUM, group=mesh.group)
    _record("all-reduce", src.numel() * src.element_size())
    return src.to(x.device) if host else src


def broadcast_object(obj, mesh, src: int = 0):
    """Rank `src`'s picklable `obj` on every rank (the checkpoint's
    resume state). A world without a process group returns `obj`."""
    if mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(
        box, src=src, group=mesh.group,
        device=mesh.device if dist.get_backend(mesh.group) == "nccl"
        else None)
    _record("broadcast", 0)
    return box[0]


def barrier(mesh) -> None:
    """Wait for every rank (no bytes move)."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


@contextlib.contextmanager
def record_collectives():
    """Collect (kind, bytes) of every collective this
    process issues through this module inside the block."""
    log: list = []
    _RECORDERS.append(log)
    try:
        yield log
    finally:
        _RECORDERS.remove(log)


def render_multihost(scene, camera, generator, *, samples: int,
                     max_depth: int = 1, light_samples: int = 2,
                     mode=None, intersect=None, shadow_intersect=None
                     ) -> torch.Tensor:
    """Sample-parallel render over the default process group (a world of
    one without it): rank p of n renders the samples [offset, offset +
    mine) of the stream of `generator` (every rank passes an identical
    one, on its device), with mine and offset split as divmod splits
    `samples`, weights its image by mine / samples, and ONE all-gather
    brings every rank's part; every rank sums the parts in rank order, so
    each holds the same [H, W, 3] image bit for bit, and that image is
    `render(samples=samples)`'s up to float summation. A rank without
    samples contributes zeros."""
    from orion_tpu_torch.parallel.sharding import Mesh
    from orion_tpu_torch.render import render

    dev = camera.device
    if dist.is_initialized():
        mesh = Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                    dev)
    else:
        mesh = Mesh(None, 0, 1, dev)
    base, extra = divmod(samples, mesh.world)
    mine = base + (1 if mesh.rank < extra else 0)
    offset = mesh.rank * base + min(mesh.rank, extra)
    H, W = camera.yres, camera.xres
    if mine > 0:
        img = render(scene, camera, generator, samples=mine,
                     max_depth=max_depth, light_samples=light_samples,
                     mode=mode, intersect=intersect,
                     shadow_intersect=shadow_intersect, sample_offset=offset)
        part = img * (mine / samples)
    else:
        part = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    parts = all_gather_rows(part.reshape(1, -1).detach(), mesh.world, mesh)
    out = parts[0]
    for r in range(1, mesh.world):
        out = out + parts[r]
    return out.reshape(H, W, 3)


def measure_collective_bytes(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once and report the collectives it
    issued: {"ops", "bytes_per_call", "by_kind"} as the JAX package's
    (which reads them from compiled HLO). An all-gather counts the bytes
    of its gathered result, an all-reduce those of its buffer, both as one
    rank sees them; a broadcast of a pickled object counts no bytes."""
    with record_collectives() as log:
        fn(*args, **kwargs)
    sizes = {k: 0 for k in KINDS}
    for kind, nbytes in log:
        sizes[kind] += nbytes
    return {"ops": len(log), "bytes_per_call": sum(sizes.values()),
            "by_kind": sizes}


def host_tile(total_rows: int) -> tuple[int, int]:
    """[start, end) image-row range owned by this process under an even
    row-major split, for writing per-process image tiles."""
    p, n = ((dist.get_rank(), dist.get_world_size())
            if dist.is_initialized() else (0, 1))
    per = -(-total_rows // n)
    start = min(p * per, total_rows)
    return start, min(start + per, total_rows)


def scaling_report(seconds_1chip: float, seconds_nchip: float,
                   n_chips: int) -> dict:
    """Scaling efficiency metric (BASELINE.md north star: >= 85%)."""
    speedup = seconds_1chip / max(seconds_nchip, 1e-12)
    return {
        "chips": n_chips,
        "speedup": round(speedup, 3),
        "efficiency": round(speedup / n_chips, 4),
    }
