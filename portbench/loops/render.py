"""Render loop: one client renders back to back, each render on the next
seed, each ending with its image on the host as a NumPy array (what the
CLI hands save_image). The window ends with the first render that ends
after the window's seconds, so no render is cut.

Traffic keys: xres, yres, samples, light_samples, max_depth; warmup_samples
(a smaller warm-up render through the same route, or null for one render
at the cell's own shapes); check.pixels, check.renders (the check's
sample); profile_seconds (the traced slice).
"""

from __future__ import annotations

import time

import numpy as np
import torch

import reference
import windowstats

SEED_MOD = 2 ** 31


class Window:
    """The renders of a window: their times, seeds and the sampled pixels
    of each image."""

    def __init__(self, ctx, pix, seeds, times, kept, window_s, backend):
        self.ctx, self.pix, self.seeds = ctx, pix, seeds
        self.times, self.kept, self.window_s = times, kept, window_s
        self.backend = backend
        tr = ctx.traffic
        self.samples_per_unit = tr["xres"] * tr["yres"] * tr["samples"]
        self.attempted = len(times)
        self.failed = 0
        self.device_ms, self.started_at = [], 0.0

    def summary(self) -> dict:
        q1, q2, q3 = windowstats.quartiles([t * 1e3 for t in self.times])
        return {"backend": self.backend, "renders": self.attempted,
                "window_s": round(self.window_s, 6),
                "render_ms q1/median/q3": f"{q1:.4f} / {q2:.4f} / {q3:.4f}",
                "render_ms in order": " ".join(f"{t * 1e3:.2f}"
                                               for t in self.times),
                "device_ms in order": " ".join(f"{t:.2f}"
                                               for t in self.device_ms),
                "window opened at (unix s)": f"{self.started_at:.3f}"}

    def check(self) -> dict:
        """Reference renders of a sample of the window's renders, drawn
        from the seed, at the sampled pixels; numbers compared and the
        reference's counts a render."""
        ctx, tr = self.ctx, self.ctx.traffic
        sc = reference.load_scene(ctx.tmp / "scene" / "cornell.rtc")
        tracer = reference.Tracer(sc, ctx.device,
                                  accel=ctx.config["reference_accel"])
        rng = np.random.default_rng([ctx.seed, 1])
        n = min(tr["check"]["renders"], self.attempted)
        which = sorted(rng.choice(self.attempted, n, replace=False))
        counts = reference.Counts()
        # the sampled renders' pixels traced together, each on its seed
        P = len(self.pix)
        pix = torch.as_tensor(np.tile(self.pix, n), device=ctx.device)
        seeds = torch.as_tensor(np.repeat([self.seeds[i] for i in which], P),
                                device=ctx.device)
        want = tracer.trace(pix, tr["samples"], tr["max_depth"],
                            tr["light_samples"], seeds, counts=counts)
        got = np.concatenate([self.kept[i] for i in which])
        numbers = {"bad_px": bad_pixel_share(got, want.cpu().numpy())}
        per_render = tr["xres"] * tr["yres"] / (len(self.pix) * n)
        return {"numbers": numbers, "counts_per_unit": counts.scaled(
            per_render), "sizes": scene_sizes(sc, tr)}


def bad_pixel_share(got, want) -> float:
    """Share of pixels with a channel off by more than 1e-4 + 1e-3 |ref|
    (or not finite)."""
    off = ~(np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want))
    return float(np.mean(off.any(axis=-1)))


def scene_sizes(sc, tr) -> dict:
    """Bytes a megakernel must read and write once: the scene's triangles
    (Woop rows, three normals, material: 32 floats a triangle, the
    program's table row) and the image."""
    return {"triangles": sc.num_triangles,
            "input_bytes": sc.num_triangles * 32 * 4,
            "output_bytes": tr["xres"] * tr["yres"] * 3 * 4}


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        self.fn = None

    def _route(self, ps, samples):
        from harness import route

        tr = self.ctx.traffic
        return route(ps, samples=samples, max_depth=tr["max_depth"],
                     light_samples=tr["light_samples"])

    def setup(self):
        from orion_tpu_torch.engine import prepare

        ctx, tr = self.ctx, self.ctx.traffic
        with ctx.span("scene_files"):
            rtc = ctx.write_scene(xres=tr["xres"], yres=tr["yres"],
                                  depth=tr["max_depth"])
        with ctx.span("prepare"):
            ps = prepare(rtc, device=ctx.device)
        with ctx.span("route"):
            self.fn, self.backend = self._route(ps, tr["samples"])
        ctx.log(f"route: {self.backend}")
        warm_seed = (ctx.seed - 1) % SEED_MOD
        ws = tr.get("warmup_samples")
        with ctx.span("warmup"):
            warm = self.fn
            if ws:
                fn_w, backend_w = self._route(ps, ws)
                if backend_w == self.backend:
                    warm = fn_w
            warm(warm_seed).cpu().numpy()
        self.ps = ps

    def run(self, seconds: float) -> Window:
        """Renders from the context's seed until `seconds` have passed;
        the pixels the check samples are drawn from the same seed."""
        tr = self.ctx.traffic
        rng = np.random.default_rng([self.ctx.seed, 0])
        self.pix = np.sort(rng.choice(tr["xres"] * tr["yres"],
                                      tr["check"]["pixels"], replace=False))
        base = self.ctx.seed % SEED_MOD
        seeds, times, kept = [], [], []
        cuda = self.ctx.device == "cuda"
        events = []
        started_at = time.time()
        t0 = time.perf_counter()
        while True:
            s = (base + len(seeds)) % SEED_MOD
            a = time.perf_counter()
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = self.fn(s)
            if cuda:
                ev[1].record()
                events.append(ev)
            img = out.cpu().numpy()
            del out                 # one image on the card at a time
            b = time.perf_counter()
            kept.append(img.reshape(-1, 3)[self.pix])
            seeds.append(s)
            times.append(b - a)
            if b - t0 >= seconds:
                break
        win = Window(self.ctx, self.pix, seeds, times, kept, b - t0,
                     self.backend)
        # the stream's time from each call to its image, beside the host's
        # call-to-host time: a unit slow on the host alone was held there
        win.device_ms = [e0.elapsed_time(e1) for e0, e1 in events]
        win.started_at = started_at
        return win

    def free(self):
        self.fn = self.ps = None
