"""Fit loop: one client runs `optim.fit` jobs back to back, each a whole
job of `steps` steps from the same starting scene on the next seed. The
target is rendered once in set-up, through the CLI's route, from the
scene as written; each job starts from that scene with the reddest
material's diffuse albedo scaled by `perturb_scale` (chip_smoke's red-wall
problem). The window ends with the first job that ends after the window's
seconds.

The window's first job is the one checked: a post-step hook on every
optimizer (torch.optim's global hook, so the job runs fit's own optimizer)
reads Adam's first moment after step 1, from which the first gradient as
the optimizer got it follows, and fit's public callback reads each step's
loss and the parameters after step 3. The reference repeats those three
steps from the same start, seeds and target settings.

Traffic keys: xres, yres, samples, light_samples, max_depth, params,
steps, learning_rate, perturb_scale, warmup_steps, check.steps,
check.chunk_pixels, profile_seconds.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

import reference
import windowstats

SEED_MOD = 2 ** 31
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8     # torch.optim.Adam's defaults


def step_seeds(job_seed: int, steps: int) -> list:
    """The per-step seeds optim.fit draws with resample_keys (a copy of
    its rule: a CPU torch.Generator seeded with the job's seed)."""
    gen = torch.Generator()
    gen.manual_seed(job_seed)
    return [int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
            for _ in range(steps)]


def reddest(kd) -> int:
    return int(np.argmax(kd[:, 0] - kd[:, 1]))


class Probe:
    """What the checked job's first steps hand back: losses, the first
    gradient from Adam's state, the parameters after `n` steps."""

    def __init__(self, n: int):
        self.n, self.losses, self.grad1, self.theta_n = n, [], None, None
        self.opt = None

    def hook(self, opt, args, kwargs):
        self.opt = opt
        if self.grad1 is None:
            p = opt.param_groups[0]["params"][0]
            m = opt.state.get(p, {}).get("exp_avg")
            # an optimizer that kept no first moment got no gradient
            self.grad1 = (torch.zeros_like(p) if m is None
                          else m / (1.0 - BETA1)).detach().double().cpu()

    def callback(self, i, loss):
        if i < self.n:
            self.losses.append(float(loss))
        if i == self.n - 1:
            self.theta_n = self.opt.param_groups[0]["params"][0].detach() \
                .double().cpu()


class Window:
    def __init__(self, ctx, jobs, times, first_step, steps, window_s, probe,
                 theta0, target_seed):
        self.ctx, self.jobs, self.times = ctx, jobs, times
        self.first_step, self.steps = first_step, steps
        self.window_s, self.probe = window_s, probe
        self.theta0, self.target_seed = theta0, target_seed
        tr = ctx.traffic
        self.samples_per_step = tr["xres"] * tr["yres"] * tr["samples"]
        self.attempted = len(jobs)
        self.failed = 0

    def summary(self) -> dict:
        q1, q2, q3 = windowstats.quartiles(self.times)
        f1, f2, f3 = windowstats.quartiles([t * 1e3 for t in self.first_step])
        per = [t / s * 1e3 for t, s in zip(self.times, self.steps)]
        s1, s2, s3 = windowstats.quartiles(per)
        return {"jobs": self.attempted, "steps": sum(self.steps),
                "window_s": round(self.window_s, 6),
                "job_s q1/median/q3": f"{q1:.4f} / {q2:.4f} / {q3:.4f}",
                "first_step_ms q1/median/q3": f"{f1:.3f} / {f2:.3f} / {f3:.3f}",
                "ms a step q1/median/q3": f"{s1:.4f} / {s2:.4f} / {s3:.4f}",
                "checked job losses": self.probe.losses}

    def check(self) -> dict:
        ctx, tr = self.ctx, self.ctx.traffic
        sc = reference.load_scene(ctx.tmp / "scene" / "cornell.rtc")
        tracer = reference.Tracer(sc, ctx.device,
                                  accel=ctx.config["reference_accel"])
        ref = fit_reference(tracer, tr, self.jobs[0], self.target_seed,
                            tr["check"]["steps"])
        p = self.probe
        numbers = {
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(p.losses, ref["losses"])),
            "grad_gap": norm_gap(p.grad1, ref["grad1"]),
            "change_gap": norm_gap(p.theta_n - self.theta0, ref["change"]),
        }
        ctx.log(f"reference losses {ref['losses']}")
        n_steps = tr["check"]["steps"]
        return {"numbers": numbers,
                "counts_per_unit": ref["counts"].scaled(1.0 / n_steps),
                "sizes": {"triangles": sc.num_triangles,
                          "input_bytes": sc.num_triangles * 32 * 4,
                          "output_bytes": self.samples_per_step * 12}}


def norm_gap(got, want) -> float:
    """|‖got‖ - ‖want‖| / ‖want‖ of one leaf (a parameter tensor)."""
    w = float(torch.linalg.norm(want))
    return abs(float(torch.linalg.norm(got)) - w) / w


def fit_reference(tracer, tr, job_seed: int, target_seed: int,
                  n: int) -> dict:
    """The first n steps of the job in the reference: its own target, the
    MSE loss and its gradient by autograd through reference.Tracer, Adam
    and the [0, 1] projection, in float64 outside the tracer."""
    dev = tracer.dev
    W, H = tracer.sc.xres, tracer.sc.yres
    S, D, LS = tr["samples"], tr["max_depth"], tr["light_samples"]
    chunk = tr["check"]["chunk_pixels"]
    kd_true = torch.as_tensor(tracer.sc.kd, dtype=torch.float64, device=dev)
    target = torch.empty((W * H, 3), dtype=torch.float64, device=dev)
    with torch.no_grad():
        for s in range(0, W * H, chunk):
            pix = torch.arange(s, min(s + chunk, W * H), device=dev)
            target[s:s + chunk] = tracer.trace(
                pix, S, D, LS, target_seed, kd=kd_true).double()
    theta = kd_true.clone()
    red = reddest(tracer.sc.kd)
    theta[red] = (kd_true[red].float() * tr["perturb_scale"]).double()
    theta0 = theta.clone()
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    counts = reference.Counts()
    losses, grad1 = [], None
    lr = tr["learning_rate"]
    for t, seed in enumerate(step_seeds(job_seed, n), start=1):
        leaf = theta.clone().requires_grad_(True)
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for s in range(0, W * H, chunk):
            pix = torch.arange(s, min(s + chunk, W * H), device=dev)
            img = tracer.trace(pix, S, D, LS, seed, kd=leaf, counts=counts)
            diff = img.double() - target[s:s + chunk]
            loss = (diff * diff).sum() / (W * H * 3)
            loss.backward()
            total += loss.detach()
        g = leaf.grad.detach()
        losses.append(float(total))
        grad1 = g.cpu() if grad1 is None else grad1
        m = BETA1 * m + (1 - BETA1) * g
        v = BETA2 * v + (1 - BETA2) * g * g
        mh = m / (1 - BETA1 ** t)
        vh = v / (1 - BETA2 ** t)
        theta = torch.clamp(theta - lr * mh / (torch.sqrt(vh) + EPS), 0.0, 1.0)
    return {"losses": losses, "grad1": grad1,
            "change": (theta - theta0).cpu(), "counts": counts}


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self):
        from harness import route
        from orion_tpu_torch.engine import prepare
        from orion_tpu_torch.optim import fit

        ctx, tr = self.ctx, self.ctx.traffic
        with ctx.span("scene_files"):
            rtc = ctx.write_scene(xres=tr["xres"], yres=tr["yres"],
                                  depth=tr["max_depth"])
        with ctx.span("prepare"):
            ps = prepare(rtc, device=ctx.device)
        self.target_seed = (ctx.seed + SEED_MOD // 2) % SEED_MOD
        with ctx.span("route"):
            fn, backend = route(ps, samples=tr["samples"],
                                max_depth=tr["max_depth"],
                                light_samples=tr["light_samples"])
            self.target = fn(self.target_seed)
            del fn
        ctx.log(f"target route: {backend}")
        kd = ps.scene.mat_diffuse.detach().clone()
        red = reddest(kd.cpu().numpy())
        kd[red] = kd[red] * tr["perturb_scale"]
        self.theta0 = kd.double().cpu()
        self.ps = dataclasses.replace(
            ps, scene=dataclasses.replace(ps.scene, mat_diffuse=kd))
        self.fit = fit
        with ctx.span("warmup"):
            self._job((ctx.seed - 1) % SEED_MOD, tr["warmup_steps"], None)

    def _job(self, seed, steps, callback):
        tr = self.ctx.traffic
        return self.fit(self.ps, self.target, params=tuple(tr["params"]),
                        steps=steps, learning_rate=tr["learning_rate"],
                        samples=tr["samples"], max_depth=tr["max_depth"],
                        light_samples=tr["light_samples"], seed=seed,
                        callback=callback)

    def run(self, seconds: float) -> Window:
        tr = self.ctx.traffic
        base = self.ctx.seed % SEED_MOD
        jobs, times, first, steps = [], [], [], []
        probe = Probe(tr["check"]["steps"])
        t0 = time.perf_counter()
        while True:
            seed = (base + len(jobs)) % SEED_MOD
            stamp = []

            def callback(i, loss, stamp=stamp):
                if i == 0:
                    stamp.append(time.perf_counter())
                if not jobs:
                    probe.callback(i, loss)

            handle = None
            if not jobs:
                handle = register_optimizer_step_post_hook(probe.hook)
            a = time.perf_counter()
            try:
                res = self._job(seed, tr["steps"], callback)
            finally:
                if handle is not None:
                    handle.remove()
            b = time.perf_counter()
            jobs.append(seed)
            times.append(b - a)
            first.append(stamp[0] - a)
            steps.append(res.steps)
            if b - t0 >= seconds:
                break
        return Window(self.ctx, jobs, times, first, steps, b - t0, probe,
                      self.theta0, self.target_seed)

    def free(self):
        self.ps = self.target = self.fit = None
