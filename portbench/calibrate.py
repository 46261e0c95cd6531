"""Readings that set a cell's limits: the program's compared numbers over
many seeds (the lower reading), the control's (the plain reference in
bfloat16 put in the program's place: the upper reading) and the faults:
for a fit cell the program with a fault planted ("half"), for a Whitted
render cell the reference's retrace with one rule broken
(WHITTED_FAULTS) put in the program's place.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--first-seed N] [--faults half | no_mirror,...]

One process: the cell's set-up once, then per seed one unit of its loop
(one render, or one fit job) and its check, at the cell's own sizes. The
benchmark's runs never run this. Prints one JSON line of readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

import reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class NoShadowQuirk(reference.WhittedTracer):
    """A hit beyond the light (t >= 1) no longer blocks a shadow ray."""

    SHADOW_CAP = 1.0


class NoMirror(reference.WhittedTracer):
    """No mirror continuation: every path ends at its first hit."""

    def reflectivity(self, m):
        return torch.zeros_like(self.ks[m])


class PowZeroZero(reference.WhittedTracer):
    """pow(0, 0) = 0 in the specular term."""

    def pow_c(self, x, e):
        return torch.where(x > 0.0, super().pow_c(x, e), torch.zeros_like(x))


class NoFalloff(reference.WhittedTracer):
    """A light's intensity is not divided by the squared distance."""

    def light_distance2(self, d2):
        return torch.ones_like(d2)


WHITTED_FAULTS = {"no_shadow_quirk": NoShadowQuirk, "no_mirror": NoMirror,
                  "pow00_zero": PowZeroZero, "no_falloff": NoFalloff}


def program_readings(loop, ctx, seeds) -> dict:
    out = {}
    for s in seeds:
        ctx.seed = s
        t0 = time.perf_counter()
        win = loop.run(0.0)
        t1 = time.perf_counter()
        out[s] = win.check()["numbers"]
        ctx.log(f"seed {s}: {out[s]} (unit {t1 - t0:.3f} s, check "
                f"{time.perf_counter() - t1:.3f} s)")
    return out


def render_readings(ctx, seeds, loop_mod, make_other) -> dict:
    """bad_px of the tracer `make_other(scene)` against the configuration's
    reference retrace in float32, at the cell's pixels and samples."""
    import numpy as np

    tr = ctx.traffic
    sc = reference.load_scene(ctx.tmp / "scene" / "cornell.rtc")
    cls = reference.TRACERS[ctx.config.get("integrator", "path")]
    f32 = cls(sc, ctx.device, accel=ctx.config["reference_accel"])
    other = make_other(sc)
    out = {}
    for s in seeds:
        rng = np.random.default_rng([s, 0])
        pix = torch.as_tensor(np.sort(rng.choice(
            tr["xres"] * tr["yres"], tr["check"]["pixels"], replace=False)),
            device=ctx.device)
        args = (pix, tr["samples"], tr["max_depth"], tr.get("light_samples"),
                s)
        want = f32.trace(*args).cpu().numpy()
        got = other.trace(*args).cpu().numpy()
        out[s] = {"bad_px": loop_mod.bad_pixel_share(got[None], want[None])}
        ctx.log(f"seed {s}: {out[s]}")
    return out


def render_control(ctx, seeds, loop_mod) -> dict:
    """The configuration's retrace in bfloat16 in the program's place."""
    cls = reference.TRACERS[ctx.config.get("integrator", "path")]
    return render_readings(ctx, seeds, loop_mod, lambda sc: cls(
        sc, ctx.device, dtype=torch.bfloat16,
        accel=ctx.config["reference_accel"]))


def fit_control(ctx, seeds, loop_mod) -> dict:
    tr = ctx.traffic
    sc = reference.load_scene(ctx.tmp / "scene" / "cornell.rtc")
    acc = ctx.config["reference_accel"]
    f32 = reference.Tracer(sc, ctx.device, accel=acc)
    bf16 = reference.Tracer(sc, ctx.device, dtype=torch.bfloat16, accel=acc)
    n = tr["check"]["steps"]
    out = {}
    for s in seeds:
        target_seed = (s + loop_mod.SEED_MOD // 2) % loop_mod.SEED_MOD
        want = loop_mod.fit_reference(f32, tr, s, target_seed, n)
        got = loop_mod.fit_reference(bf16, tr, s, target_seed, n)
        out[s] = {
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(got["losses"], want["losses"])),
            "grad_gap": loop_mod.norm_gap(got["grad1"], want["grad1"]),
            "change_gap": loop_mod.norm_gap(got["change"], want["change"])}
        ctx.log(f"control seed {s}: {out[s]}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=1_000_000_007)
    p.add_argument("--faults", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--override", default="{}",
                   help="JSON of traffic keys to replace (a small rehearsal)")
    args = p.parse_args(argv)
    for path in (str(ROOT), str(HERE)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import tempfile

    import harness

    cell = harness.Cell(args.workload, ROOT)
    tmp = Path(tempfile.mkdtemp(prefix="portbench-cal-"))
    ctx = harness.Context(cell, dict(cell.traffic,
                                     **json.loads(args.override)),
                          args.first_seed,
                          args.device, tmp)
    mod = harness.load_module(cell.loop_path, "loop")
    loop = mod.Loop(ctx)
    loop.setup()
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    cseeds = [args.first_seed + 104729 * (k + 1)
              for k in range(args.control_seeds)]
    out = {"workload": args.workload, "program": program_readings(
        loop, ctx, seeds)}
    faults = list(filter(None, args.faults.split(",")))
    for fault in [f for f in faults if f not in WHITTED_FAULTS]:
        undo = plant(fault)
        try:
            out[f"fault:{fault}"] = program_readings(loop, ctx, cseeds)
        finally:
            undo()
    loop.free()
    for fault in [f for f in faults if f in WHITTED_FAULTS]:
        out[f"fault:{fault}"] = render_readings(
            ctx, cseeds, mod, lambda sc, f=fault: WHITTED_FAULTS[f](
                sc, ctx.device))
    if cell.traffic["loop"] == "fit":
        out["control"] = fit_control(ctx, cseeds, mod)
    else:
        out["control"] = render_control(ctx, cseeds, mod)
    for group in [k for k in out if k != "workload"]:
        names = sorted({n for r in out[group].values() for n in r})
        out[f"{group}:range"] = {n: [min(r[n] for r in out[group].values()),
                                     max(r[n] for r in out[group].values())]
                                 for n in names}
    print(json.dumps(out))
    return 0


def plant(fault: str):
    """Plant a fault in the program's fit path; returns the undo."""
    import orion_tpu_torch.optim as optim

    if fault != "half":
        raise ValueError(f"unknown fault {fault!r}")
    orig = optim._prb_loss_and_grad

    def half(ps, target, params, *, samples, **kw):
        # half of each step's samples left out, the mean over the rest
        return orig(ps, target, params, samples=max(1, samples // 2), **kw)

    optim._prb_loss_and_grad = half

    def undo():
        optim._prb_loss_and_grad = orig

    return undo


if __name__ == "__main__":
    sys.exit(main())
