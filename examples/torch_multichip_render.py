"""Multi-device rendering demo of the port over torch.distributed.

Runs the sharded render paths on every rank of a process group, one rank
per device:

  1. render_sharded (parallel/sharding.py): the global stream, the image
     of one device's `render` bit for bit;
  2. render_shardmap (parallel/shardmap_render.py): a stream per rank;
  3. render_regen_shardmap (regen.py): the regenerative wavefront per rank;
  4. render_tp (parallel/primitive_sharding.py): triangles sharded over
     the ranks, the image of `render` over the brute sweep bit for bit;

then times render_shardmap on one device against the whole world
(scaling_report).

Usage, one rank per card (NCCL):
    torchrun --nproc-per-node 4 examples/torch_multichip_render.py
or, without torchrun, N gloo ranks spawned here (on the CPU with
--device cpu; with --device cuda every rank drives cuda:0, since NCCL
refuses two ranks on one card):
    python examples/torch_multichip_render.py [--ranks 2] [--small]
                                              [--device cuda|cpu]

Ranks that share one card (or one CPU) share its cores: their timing is
no scaling figure, and the script says so.
"""

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch
import torch.distributed as dist


def _gen(dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def run(args, rtc: str, shared: bool) -> None:
    """The demo on this rank of the initialised process group; `shared`:
    the ranks share one device."""
    from orion_tpu_torch import prepare, render, render_regen_shardmap
    from orion_tpu_torch.ops.brute_intersect import intersect_brute_kernel
    from orion_tpu_torch.parallel import (make_mesh, render_sharded,
                                          render_shardmap, render_tp)
    from orion_tpu_torch.parallel.distributed import scaling_report
    from orion_tpu_torch.parallel.sharding import Mesh

    mesh = make_mesh(device="cpu" if args.device == "cpu" else None)
    dev = mesh.device
    xres, yres = (64, 48) if args.small else (320, 240)
    ps = prepare(rtc, device=dev, xres=xres, yres=yres)
    kw = dict(samples=2 if args.small else 4, max_depth=4, light_samples=2)
    lead = mesh.rank == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    say(f"world {mesh.world} ({dist.get_backend()}), rank 0 on {dev}, "
        f"{xres}x{yres}, {kw}")
    with torch.no_grad():
        a = render_sharded(ps.scene, ps.camera, _gen(dev), mesh=mesh,
                           mode="path", **kw)
        b = render(ps.scene, ps.camera, _gen(dev), mode="path", **kw)
        say(f"1. render_sharded == one device's render: "
            f"{bool(torch.equal(a, b))}")
        c = render_shardmap(ps.scene, ps.camera, _gen(dev), mesh=mesh,
                            mode="path", intersect=ps.intersect, **kw)
        say(f"2. render_shardmap mean {float(c.mean()):.5f} (render "
            f"{float(b.mean()):.5f})")
        d = render_regen_shardmap(ps.scene, ps.camera, _gen(dev), mesh=mesh,
                                  intersect=ps.intersect, **kw)
        say(f"3. render_regen_shardmap mean {float(d.mean()):.5f}")
        e = render_tp(ps.scene, ps.camera, _gen(dev), mode="path", **kw)
        f = render(ps.scene, ps.camera, _gen(dev), mode="path",
                   intersect=intersect_brute_kernel, **kw)
        say(f"4. render_tp (1 x {mesh.world}) == render over the brute "
            f"sweep: {bool(torch.equal(e, f))}")

        def timed(m):
            render_shardmap(ps.scene, ps.camera, _gen(dev), mesh=m,
                            intersect=ps.intersect, **kw)      # warm
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()
            t0 = time.perf_counter()
            render_shardmap(ps.scene, ps.camera, _gen(dev), mesh=m,
                            intersect=ps.intersect, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return time.perf_counter() - t0

        t1 = timed(Mesh(None, 0, 1, dev))
        tn = timed(mesh)
    say(f"scaling: {scaling_report(t1, tn, mesh.world)} (one device "
        f"{t1:.3f} s, {mesh.world} ranks {tn:.3f} s)")
    if shared:
        say("note: the ranks share one device's cores, so this is no "
            "multi-device scaling figure")


def _spawned(rank: int, world: int, init: str, args, rtc: str) -> None:
    from datetime import timedelta

    torch.set_num_threads(1)
    if args.device == "cuda":
        os.environ["LOCAL_RANK"] = "0"          # every rank on card 0
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=600))
    try:
        run(args, rtc, shared=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    import torch.multiprocessing as mp

    from cornell_scenes import write_cornell

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2,
                   help="gloo ranks to spawn without torchrun (default 2)")
    p.add_argument("--small", action="store_true",
                   help="64x48 at 2 spp (a quick smoke run)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("--device cuda, but no CUDA device is available")
    with tempfile.TemporaryDirectory() as tmp:
        rtc = str(write_cornell(tmp, depth=4))
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            from orion_tpu_torch.parallel.distributed import init_distributed

            init_distributed(backend="gloo" if args.device == "cpu"
                             else "nccl")
            world = dist.get_world_size()
            try:
                run(args, rtc, shared=args.device == "cpu"
                    or world > torch.cuda.device_count())
            finally:
                dist.destroy_process_group()
            return 0
        ctx = mp.start_processes(_spawned, args=(args.ranks,
                                                 f"{tmp}/gloo.init", args,
                                                 rtc),
                                 nprocs=args.ranks, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + 900
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    print("error: ranks still running after 900 s",
                          file=sys.stderr)
                    return 1
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
