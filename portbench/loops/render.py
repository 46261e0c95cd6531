"""Render loop: one client renders back to back, each render on the next
seed, each ending with its image on the host as a NumPy array (what the
CLI hands save_image). The window ends with the first render that ends
after the window's seconds, so no render is cut.

Which renders the check retraces is drawn from the seed in one of two
ways. By default every render's sampled pixels are kept and the renders
are drawn once the window has closed (a window of a few long renders).
With `check.online` the renders are chosen as they end (`Reservoir`), so
a window of 10^5 short renders keeps only the chosen renders' images
(and takes the stream's time of one render in EVENT_STRIDE, not of each).

Traffic keys: xres, yres, samples, max_depth, light_samples (path scenes);
warmup_samples (a smaller warm-up render through the same route, or null
for one render at the cell's own shapes); check.pixels, check.renders and
check.online (the check's sample); profile_seconds (the traced slice).
The configuration's `integrator` ("path" by default, or "whitted") picks
the reference's retrace.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import reference
import roofline
import windowstats

SEED_MOD = 2 ** 31
# with check.online, device time is taken of one render in this many
EVENT_STRIDE = 64


class Reservoir:
    """A uniform sample, without replacement, of `n` of a stream's units,
    chosen as they come: each unit draws a key from the seed's stream and
    the `n` least keys are kept, with the unit's image."""

    def __init__(self, seed: int, n: int):
        self.rng = np.random.default_rng([seed, 2])
        self.n = n
        self.kept = {}                    # unit -> (key, image)

    def offer(self, unit: int, img):
        """Unit `unit` (0, 1, 2, ... in turn) ended with image `img`."""
        key = self.rng.random()
        if len(self.kept) < self.n:
            self.kept[unit] = (key, img)
            return
        worst = max(self.kept, key=lambda u: self.kept[u][0])
        if key < self.kept[worst][0]:
            del self.kept[worst]
            self.kept[unit] = (key, img)


class Window:
    """The renders of a window: their host times, and the sampled pixels
    of the renders the check retraces."""

    def __init__(self, ctx, pix, chosen, times, window_s, backend):
        self.ctx, self.pix, self.chosen = ctx, pix, chosen
        self.times, self.window_s = times, window_s
        self.backend = backend
        tr = ctx.traffic
        self.samples_per_unit = tr["xres"] * tr["yres"] * tr["samples"]
        self.attempted = len(times)
        self.failed = 0
        self.device_ms, self.started_at = [], 0.0

    def seed_of(self, unit: int) -> int:
        return (self.ctx.seed % SEED_MOD + unit) % SEED_MOD

    def summary(self) -> dict:
        ms = [t * 1e3 for t in self.times]
        q1, q2, q3 = windowstats.quartiles(ms)
        slowest = sorted(range(len(ms)), key=lambda i: -ms[i])[:5]
        out = {"backend": self.backend, "renders": self.attempted,
               "window_s": round(self.window_s, 6),
               "render_ms q1/median/q3": f"{q1:.4f} / {q2:.4f} / {q3:.4f}",
               "render_ms p95 / max": f"{windowstats.percentile(ms, 95):.4f}"
                                      f" / {max(ms):.4f}",
               "slowest renders (index: ms)": " ".join(
                   f"{i}: {ms[i]:.2f}" for i in slowest),
               "checked renders": " ".join(map(str, sorted(self.chosen))),
               "window opened at (unix s)": f"{self.started_at:.3f}"}
        if self.device_ms:
            d1, d2, d3 = windowstats.quartiles(self.device_ms)
            p95 = windowstats.percentile(self.device_ms, 95)
            out[f"device_ms of {len(self.device_ms)} renders, q1/median/q3"
                f" / p95 / max"] = (f"{d1:.4f} / {d2:.4f} / {d3:.4f} / "
                                    f"{p95:.4f} / {max(self.device_ms):.4f}")
        return out

    def check(self) -> dict:
        """The configuration's reference retrace of the chosen renders at
        the sampled pixels; numbers compared and the reference's counts a
        render."""
        ctx, tr = self.ctx, self.ctx.traffic
        sc = reference.load_scene(ctx.tmp / "scene" / "cornell.rtc")
        integrator = ctx.config.get("integrator", "path")
        tracer = reference.TRACERS[integrator](
            sc, ctx.device, accel=ctx.config["reference_accel"])
        which = sorted(self.chosen)
        n = len(which)
        counts = reference.Counts()
        # the chosen renders' pixels traced together, each on its seed
        P = len(self.pix)
        pix = torch.as_tensor(np.tile(self.pix, n), device=ctx.device)
        seeds = torch.as_tensor(np.repeat([self.seed_of(i) for i in which],
                                          P), device=ctx.device)
        want = tracer.trace(pix, tr["samples"], tr["max_depth"],
                            tr.get("light_samples"), seeds, counts=counts)
        got = np.concatenate([self.chosen[i] for i in which])
        numbers = {"bad_px": bad_pixel_share(got, want.cpu().numpy())}
        per_render = tr["xres"] * tr["yres"] / (len(self.pix) * n)
        return {"numbers": numbers, "counts_per_unit": counts.scaled(
            per_render), "sizes": scene_sizes(sc, tr, integrator)}


def bad_pixel_share(got, want) -> float:
    """Share of pixels with a channel off by more than 1e-4 + 1e-3 |ref|
    (or not finite)."""
    off = ~(np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want))
    return float(np.mean(off.any(axis=-1)))


def scene_sizes(sc, tr, integrator: str = "path") -> dict:
    """Bytes a megakernel must read and write once: the scene's table and
    lights (roofline.table_bytes) and the image."""
    return {"triangles": sc.num_triangles,
            "input_bytes": roofline.table_bytes(integrator, sc.num_triangles,
                                                len(sc.lights)),
            "output_bytes": tr["xres"] * tr["yres"] * 3 * 4}


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        self.fn = None

    def _route(self, ps, samples):
        from harness import route

        tr = self.ctx.traffic
        return route(ps, samples=samples, max_depth=tr["max_depth"],
                     light_samples=tr.get("light_samples"))

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
        ctx, tr = self.ctx, self.ctx.traffic
        chk = tr["check"]
        rng = np.random.default_rng([ctx.seed, 0])
        self.pix = np.sort(rng.choice(tr["xres"] * tr["yres"],
                                      chk["pixels"], replace=False))
        base = ctx.seed % SEED_MOD
        online = Reservoir(ctx.seed, chk["renders"]) if chk.get("online") \
            else None
        times, kept = [], []
        # the stream's time from a call to its kernels' end, beside the
        # host's call-to-host time: every render's where every render is
        # kept anyway, else every EVENT_STRIDE-th render's
        events = [] if ctx.device == "cuda" else None
        stride = 1 if online is None else EVENT_STRIDE
        started_at = time.time()
        t0 = time.perf_counter()
        while True:
            s = (base + len(times)) % SEED_MOD
            a = time.perf_counter()
            timed = events is not None and len(times) % stride == 0
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = self.fn(s)
            if timed:
                ev[1].record()
                events.append(ev)
            img = out.cpu().numpy()
            del out                 # one image on the card at a time
            b = time.perf_counter()
            if online is None:
                kept.append(img.reshape(-1, 3)[self.pix])
            else:
                online.offer(len(times), img)
            times.append(b - a)
            if b - t0 >= seconds:
                break
        if online is None:
            pick = np.random.default_rng([ctx.seed, 1])
            n = min(chk["renders"], len(times))
            chosen = {int(i): kept[i] for i in
                      pick.choice(len(times), n, replace=False)}
        else:
            chosen = {u: img.reshape(-1, 3)[self.pix]
                      for u, (_, img) in online.kept.items()}
        win = Window(ctx, self.pix, chosen, times, b - t0, self.backend)
        if events is not None:
            win.device_ms = [e0.elapsed_time(e1) for e0, e1 in events]
        win.started_at = started_at
        return win

    def free(self):
        self.fn = self.ps = None
