"""CLI entry point: render an .rtc scene to an image file on the GPU.

Mirrors the reference launcher's surface (orion/launcher.cpp:15-45) and
`orion_tpu.cli`: positional rtc file; -o/--output; -p pixel samples; -l
shadow-ray (light) samples.

Routing (as in the JAX package, cli.py:74-143):
  - path-mode scenes inside the fused gate -> the path megakernel
    (ops/fused_path.py);
  - Whitted-mode scenes inside the fused-Whitted gate -> the Whitted
    megakernel (ops/whitted.py);
  - --backend brute -> the wavefront renderer (render.py) over the brute
    sweep kernel (ops/brute_intersect.py), path or Whitted mode;
  - everything else (the BVH Whitted megakernels, path megakernels past
    the fused gate, the BVH backend, --regen, --shard, --checkpoint,
    --normal-maps) is not ported yet: the command exits non-zero and names
    the missing piece. It never substitutes another route.

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
                   help="Force the backend: 'brute' = wavefront over the "
                        "brute sweep kernel, 'fused' = path or Whitted "
                        "megakernel (errors outside its gate); 'bvh' is "
                        "not ported")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Device (default %(default)s; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--xres", type=int, default=None,
                   help="Override rtc x resolution")
    p.add_argument("--yres", type=int, default=None,
                   help="Override rtc y resolution")
    for flag in ("--shard", "--regen", "--normal-maps"):
        p.add_argument(flag, action="store_true", help="not ported yet")
    p.add_argument("--checkpoint", default=None, help="not ported yet")
    p.add_argument("--stats", action="store_true",
                   help="Print a JSON render report to stderr")
    return p


def _fail(msg: str):
    raise SystemExit(f"error: {msg}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from orion_tpu_torch.engine import BVH_NOT_PORTED, prepare, render_report
    from orion_tpu_torch.io.image import save_image

    unported = [flag for flag, on in (("--shard", args.shard),
                                      ("--regen", args.regen),
                                      ("--checkpoint", args.checkpoint),
                                      ("--normal-maps", args.normal_maps))
                if on]
    if unported:
        _fail(f"{', '.join(unported)} not ported yet")
    if args.device == "cuda" and not torch.cuda.is_available():
        _fail("--device cuda, but no CUDA device is available "
              "(pass --device cpu for the plain PyTorch versions)")

    force = args.backend if args.backend in ("brute", "bvh") else None
    ps = prepare(args.rtc_file, device=args.device, force_backend=force,
                 xres=args.xres, yres=args.yres)
    # the reference caps trace() at rtc.recursion_level exactly
    # (raytracer.cpp:29,203-206)
    max_depth = (args.depth if args.depth is not None
                 else int(ps.rtc.recursion_level))
    mode = args.mode or ("whitted" if ps.scene.num_lights > 0 else "path")

    fused_fn = None
    if args.backend in (None, "fused") and mode == "whitted":
        from orion_tpu_torch.ops.whitted import (fused_whitted_supported,
                                                 make_fused_whitted_renderer)

        if not fused_whitted_supported(ps.scene):
            if args.backend == "fused":
                _fail("--backend fused, but the scene is outside the Whitted "
                      "megakernel gate (textures / lights / triangle count); "
                      "see ops/whitted.py")
            _fail("the Whitted megakernels past the fused-Whitted gate (BVH "
                  "Whitted, deferred-texturing BVH Whitted) are not ported "
                  "yet (use --backend brute for the Whitted wavefront)")
        fused_fn = make_fused_whitted_renderer(
            ps.scene, ps.camera, samples=args.samples, max_depth=max_depth)
        ps.backend = "fused-whitted-kernel"
    elif args.backend in (None, "fused"):
        from orion_tpu_torch.ops.fused_path import (fused_path_supported,
                                                    make_fused_path_renderer)

        if not fused_path_supported(ps.scene):
            if args.backend == "fused":
                _fail("--backend fused, but the scene is outside the "
                      "megakernel gate (textures / emitters / triangle "
                      "count); see ops/fused_path.py FUSED_* limits")
            _fail("the path megakernels past the fused gate (bounce "
                  "pipeline, BVH path) are not ported yet (use --backend "
                  "brute for the path wavefront)")
        fused_fn = make_fused_path_renderer(
            ps.scene, ps.camera, samples=args.samples, max_depth=max_depth,
            light_samples=args.light_samples)
        ps.backend = "fused-kernel"
    elif ps.backend == BVH_NOT_PORTED:
        _fail("the BVH intersection backend is not ported yet "
              "(use --backend brute)")

    def sync():
        if ps.scene.device.type == "cuda":
            torch.cuda.synchronize(ps.scene.device)

    sync()
    t0 = time.perf_counter()
    if fused_fn is not None:
        img = fused_fn(args.seed)
    else:
        from orion_tpu_torch.render import render

        gen = torch.Generator(device=ps.scene.device)
        gen.manual_seed(args.seed)
        with torch.no_grad():
            img = render(ps.scene, ps.camera, gen, samples=args.samples,
                         light_samples=args.light_samples,
                         max_depth=max_depth, mode=mode,
                         intersect=ps.intersect)
    sync()
    dt = time.perf_counter() - t0

    save_image(args.output, img.cpu().numpy())
    report = render_report(ps, samples=args.samples,
                           light_samples=args.light_samples,
                           max_depth=max_depth, seconds=dt)
    print(f"rendered {args.rtc_file} -> {args.output} "
          f"[{report['resolution'][0]}x{report['resolution'][1]}, "
          f"{args.samples} spp, {report['backend']}] in {dt:.2f}s "
          f"({report['primary_rays_per_s']:.0f} primary rays/s)")
    if args.stats:
        print(json.dumps(report), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
