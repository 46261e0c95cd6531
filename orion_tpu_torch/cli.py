"""CLI entry point: render an .rtc scene to an image file on the GPU.

Mirrors the reference launcher's surface (orion/launcher.cpp:15-45) and
`orion_tpu.cli`: positional rtc file; -o/--output; -p pixel samples; -l
shadow-ray (light) samples.

Routing (as in the JAX package, cli.py:74-143; the megakernel chain is
engine.make_megakernel_renderer, the wavefront engine.render_wavefront):
  - path-mode scenes inside the fused gate -> the path megakernel
    (ops/fused_path.py);
  - path-mode scenes past the fused gate -> engine.make_big_path_renderer:
    the sorted-wavefront bounce pipeline (ops/bounce.py, "bounce-kernel")
    or the BVH path megakernel (ops/bvh_path.py, "bvh-path-kernel"), in
    the order of engine.BIG_PATH_ORDER; a scene with a diffuse texture
    takes the bounce pipeline alone, the only route that resolves texels
    at every bounce; outside every gate
    (too many or too large emitters) -> the wavefront over the engine's
    intersect, as the JAX package falls through;
  - Whitted-mode scenes -> engine.make_whitted_megakernel: the Whitted
    megakernel inside its gate (ops/whitted.py, "fused-whitted-kernel"),
    else the BVH Whitted megakernel for untextured scenes
    (ops/bvh_whitted.py, "bvh-whitted-kernel"), else the
    deferred-texturing BVH Whitted megakernel for depth <= 4
    ("bvh-whitted-deferred-kernel"); outside every gate (more than 8
    point lights, or a textured scene deeper than 4) -> the Whitted
    wavefront, as the JAX package falls through. On --device cpu the BVH
    names end in "-torch";
  - --backend fused fails only when every megakernel gate of the scene's
    mode rejects it;
  - --backend brute / --backend bvh -> the wavefront renderer (render.py)
    over the brute sweep kernel (ops/brute_intersect.py) or the BVH walk
    kernel (ops/bvh_intersect.py; any-hit for Whitted shadow rays), path
    or Whitted mode;
  - --normal-maps turns off the automatic megakernel routing, as in JAX
    (cli.py:81-83): the render takes the wavefront over the engine's
    intersect with tangent-space normal mapping; --backend fused
    --normal-maps still pins the megakernel (which maps no normals);
  - --regen -> the regenerative wavefront (regen.py) over the engine's
    intersect, path mode only, and not with --normal-maps;
  - --checkpoint -> io/checkpoint.render_accumulate: the wavefront (or,
    with --regen, the regenerative wavefront) in chunks of
    --checkpoint-every samples, resumed from the checkpoint file when it
    matches;
  - --shard -> the ray-sharded wavefront (parallel/shardmap_render.py)
    over the engine's intersect, one rank per device, as in JAX
    (cli.py:174-198): with --regen the regenerative wavefront on each
    rank's tile (regen.render_regen_shardmap), with --checkpoint
    render_accumulate(mesh=). Under torchrun (`torchrun --nproc-per-node
    N -m orion_tpu_torch.cli scene.rtc --shard`) each rank drives
    cuda:LOCAL_RANK over NCCL (--device cpu: gloo); rank 0 writes the
    image and prints the report, the other ranks print nothing. Without
    torchrun --shard is a world of one, whose image is the route's
    without --shard. Not with --normal-maps (the sharded routes map no
    normals).

--device cuda (the default) requires a CUDA device and fails without one;
--device cpu runs the kernels' plain PyTorch versions.

--seed seeds the render: the megakernels take it as their int32 PCG seed
(the JAX package derives that seed from a threefry key), the wavefront
seeds a torch.Generator with it; the same seed therefore gives a different
but equally valid sample stream than the JAX package.

Usage:
    python -m orion_tpu_torch.cli scene.rtc -o out.hdr -p 16 -l 2
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="orion_tpu_torch",
        description="Differentiable ray tracer on PyTorch and CUDA "
                    "(renders .rtc scene files)")
    p.add_argument("rtc_file", help="Path to an .rtc file")
    p.add_argument("--output", "-o", default="raytracer.png",
                   help="Output image (.png/.ppm/.hdr; default %(default)s)")
    p.add_argument("-p", dest="samples", type=int, default=1,
                   help="Pixel samples (default %(default)s)")
    p.add_argument("-l", dest="light_samples", type=int, default=1,
                   help="Shadow-ray samples per light (default %(default)s)")
    p.add_argument("--depth", type=int, default=None,
                   help="Max bounce depth (default: rtc recursion level)")
    p.add_argument("--mode", choices=["whitted", "path"], default=None,
                   help="Force render mode (default: auto from rtc lights)")
    p.add_argument("--backend", choices=["brute", "bvh", "fused"],
                   default=None,
                   help="Force the backend: 'brute' / 'bvh' = wavefront over "
                        "the brute sweep or the BVH walk kernel, 'fused' = "
                        "path or Whitted megakernel (errors outside its "
                        "gate)")
    p.add_argument("--strategy", choices=["median", "middle", "sah"],
                   default="sah", help="BVH split strategy")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Device (default %(default)s; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--xres", type=int, default=None,
                   help="Override rtc x resolution")
    p.add_argument("--yres", type=int, default=None,
                   help="Override rtc y resolution")
    p.add_argument("--regen", action="store_true",
                   help="Use the regenerative wavefront path tracer "
                        "(orion_tpu_torch.regen): dead rays restart at once "
                        "as the next sample; path mode only, forward-only")
    p.add_argument("--shard", action="store_true",
                   help="Shard rays over the ranks of a torch.distributed "
                        "group (run under torchrun; one rank per device; "
                        "a world of one without it)")
    p.add_argument("--normal-maps", action="store_true",
                   help="Enable tangent-space normal mapping (the reference "
                        "ships this disabled; PARITY.md)")
    p.add_argument("--checkpoint", default=None,
                   help="Checkpoint file for resumable accumulation "
                        "(resumes if it exists; see io/checkpoint.py)")
    p.add_argument("--checkpoint-every", type=int, default=64,
                   help="Samples per checkpoint flush (default %(default)s; "
                        "read with --checkpoint)")
    p.add_argument("--stats", action="store_true",
                   help="Print a JSON render report to stderr, with the "
                        "program's span and counter totals of this run "
                        "under \"spans\" (profiling.py)")
    # the reference launcher's thread count (launcher.cpp), accepted as the
    # JAX package's CLI accepts it and ignored: no host threads to set
    p.add_argument("--threads", "-t", type=int, default=0,
                   help=argparse.SUPPRESS)
    return p


def _fail(msg: str):
    raise SystemExit(f"error: {msg}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.stats:
        return _run(args)
    from orion_tpu_torch import profiling

    # the run's own spans: the totals start empty unless a caller records
    if not profiling.enabled():
        profiling.reset()
    with profiling.recording():
        return _run(args)


def _run(args) -> int:
    import torch

    from orion_tpu_torch.engine import (make_megakernel_renderer, prepare,
                                        render_report, render_wavefront)
    from orion_tpu_torch.io.image import save_image

    if args.device == "cuda" and not torch.cuda.is_available():
        _fail("--device cuda, but no CUDA device is available "
              "(pass --device cpu for the plain PyTorch versions)")
    if args.shard and args.normal_maps:
        _fail("--shard renders without normal maps; drop --normal-maps")

    mesh, device = None, args.device
    if args.shard:
        from orion_tpu_torch.parallel.distributed import init_distributed
        from orion_tpu_torch.parallel.sharding import make_mesh

        init_distributed(backend="gloo" if args.device == "cpu" else "nccl")
        mesh = make_mesh(device="cpu" if args.device == "cpu" else None)
        device = mesh.device

    force = args.backend if args.backend in ("brute", "bvh") else None
    ps = prepare(args.rtc_file, device=device, strategy=args.strategy,
                 force_backend=force, xres=args.xres, yres=args.yres)
    # the reference caps trace() at rtc.recursion_level exactly
    # (raytracer.cpp:29,203-206)
    max_depth = (args.depth if args.depth is not None
                 else int(ps.rtc.recursion_level))
    mode = args.mode or ("whitted" if ps.scene.num_lights > 0 else "path")
    if args.regen and (mode != "path" or args.normal_maps):
        _fail("--regen requires path mode (no rtc point lights / "
              "--mode path) and no --normal-maps")

    fused_fn = None
    # --normal-maps leaves the automatic megakernel routing (as in JAX);
    # --backend fused pins the megakernel all the same
    if ((args.backend == "fused"
         or (args.backend is None and not args.normal_maps))
            and not args.regen and not args.checkpoint and not args.shard):
        try:
            fused_fn, ps.backend = make_megakernel_renderer(
                ps, mode=mode, samples=args.samples, max_depth=max_depth,
                light_samples=args.light_samples)
        except ValueError:
            # outside every gate: the wavefront it is, as in JAX
            if args.backend == "fused":
                _fail("--backend fused, but the scene is outside every "
                      "Whitted megakernel gate (1..8 point lights; textured "
                      "scenes depth <= 4); see ops/bvh_whitted.py"
                      if mode == "whitted" else
                      "--backend fused, but the scene is outside the "
                      "megakernel gate (textures / emitters / triangle "
                      "count); see ops/fused_path.py FUSED_* limits")

    def sync():
        if ps.scene.device.type == "cuda":
            torch.cuda.synchronize(ps.scene.device)

    sync()
    t0 = time.perf_counter()
    if args.checkpoint:
        from orion_tpu_torch.io.checkpoint import render_accumulate

        img = render_accumulate(ps, args.seed, samples=args.samples,
                                light_samples=args.light_samples,
                                max_depth=max_depth, mode=args.mode,
                                path=args.checkpoint,
                                every=args.checkpoint_every,
                                regen=args.regen, mesh=mesh)
    elif fused_fn is not None:
        img = fused_fn(args.seed)
    else:
        gen = torch.Generator(device=ps.scene.device)
        gen.manual_seed(args.seed)
        img = render_wavefront(ps, gen, samples=args.samples,
                               light_samples=args.light_samples,
                               max_depth=max_depth, mode=mode,
                               regen=args.regen, mesh=mesh,
                               normal_maps=args.normal_maps)
    sync()
    dt = time.perf_counter() - t0
    if mesh is not None and mesh.rank != 0:
        return 0

    save_image(args.output,
               img.cpu().numpy() if torch.is_tensor(img) else img)
    report = render_report(ps, samples=args.samples,
                           light_samples=args.light_samples,
                           max_depth=max_depth, seconds=dt)
    print(f"rendered {args.rtc_file} -> {args.output} "
          f"[{report['resolution'][0]}x{report['resolution'][1]}, "
          f"{args.samples} spp, {report['backend']}] in {dt:.2f}s "
          f"({report['primary_rays_per_s']:.0f} primary rays/s)")
    if args.stats:
        from orion_tpu_torch import profiling

        report["spans"] = profiling.totals()
        print(json.dumps(report), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
