"""Drive the PyTorch/CUDA port on one GPU and check it, phase by phase.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device and build: the card's name and power limit; every CUDA source
     built from orion_tpu_torch/csrc/ (one nvcc each, in parallel).
  2. scenes (cornell_scenes.py): a Cornell box written as OBJ/MTL/RTC
     text (36 triangles, one two-triangle emissive quad, no point
     lights), its midpoint subdivisions (levels 2 and 4), a two-emitter
     variant, and a point-light (Whitted) variant whose tall box is a
     glossy mirror.
  3. each kernel against its plain PyTorch version on the card, at 64x64,
     4 spp, depth 4, 2 light samples: the brute sweep on 2^18 random rays
     (some dead), the fused path kernel on the four path scenes, the PRB
     training forward (image and per-sample radiance) and replay
     (material gradients) on Cornell, levels-2 and levels-4, the Whitted
     kernel on the point-light Cornell.
  4. the main path through the CLI: Cornell at 1920x1080, 16 spp, 2 light
     samples, depth 8 on the fused path kernel, written as .hdr.
  5. the second entry point: `--backend brute` wavefront at 256x256,
     16 spp, depth 4, held statistically against the fused kernel.
  6. each kernel against its plain version at the shapes and inputs of
     the path that runs it, with times: the fused kernel at the main
     path's 1920x1080, 16 spp, depth 8; the brute sweep on every sweep
     of one 256x256 wavefront sample and of one 1920x1080 sample
     (recorded from `render`; (t, id) equal to the plain version's bit
     for bit on each, both timed by CUDA-graph replay). CUDA-event
     medians of each kernel and of its plain version, with the roofline
     bound of the same work.
  7. the training path at full width (bench.py's cornell_prb_train_fhd_4spp):
     Cornell 1920x1080, 4 spp, depth 8, 2 light samples, red wall's albedo
     scaled by 0.6 against a target the fused kernel renders at the true
     albedo: (a) one make_fused_train_step(dynamic_params=True) step
     through the autograd.Function, held against the plain versions at
     these shapes; (b) CUDA-event times of the two PRB kernels and of the
     whole step (fwd+bwd primary rays/s), with plain times and bounds;
     (c) a 10-step optim.fit on the PRB route whose loss and red wall's
     albedo error fall.
  8. Whitted: the point-light Cornell through the CLI at 1920x1080, 4 spp,
     depth 4 on the Whitted kernel; its registers, spills and resident
     blocks as built; the kernel against its plain version at those
     shapes, with times and the image's digest; the kernel against the
     wavefront
     render(mode="whitted") at 256x256, 16 spp, depth 2 (means within
     2.5%, error under 3x the wavefront's own seed-to-seed error + 1e-4);
     a 5-step Whitted optim.fit (mat_diffuse, mat_specular) on the brute
     kernel whose loss falls.

  9. big path at full width: the levels-5 subdivided Cornell box (34,818
     triangles, written as OBJ text) through engine.prepare and
     make_big_path_renderer(order=("walk",)) at 1920x1080, 16 spp, depth
     8, 2 light samples (by name: the CLI's default route takes the
     first candidate of engine.BIG_PATH_ORDER, which phase 11 drives
     through the CLI): the backend is
     bvh-path-kernel, the image mean within 2% of phase 4's
     (the same box, a finer mesh); the BVH path kernel's time by CUDA
     events; the kernel against its plain version over the whole image
     (whose box and triangle test counts give the bound) and on 48 tiles
     of 1,024 lanes spread evenly over the image, rendered through
     pix_base; BVH build seconds of the native and the NumPy builder.
 10. BVH wavefront: the same scene through `--backend bvh` at 256x256,
     16 spp, depth 4, against a 256x256 render of the CLI's default route
     (the first candidate's backend; corr > 0.93, mean rel 0.15); the same wavefront with sort_bounces="morton";
     `--regen` at 256x256, 16 spp, depth 8 (mean within 2.5% of the
     depth-8 wavefront); the levels-5 Whitted box through `--backend bvh`
     at 512x512, 4 spp, depth 4 (any-hit launches > 0, mean within 2.5%
     of `--backend brute`); the walk kernel timed by CUDA-graph replay on
     one wavefront sample's recorded sweeps at 256x256 (a quarter of the
     card's threads a launch) and at 1920x1080 (the card full).
 11. the bounce pipeline at full width, on the levels-5 box: (a) a
     1920x1080, 16 spp, depth 8 render through
     make_big_path_renderer(order=("bounce",)): launches
     and CUDA-event times per bounce of the walk and shade kernels and of
     the sort, lanes per bounce; the same render with split_vis=True (the
     vis kernel: its registers and resident blocks, its time a render and
     at depth 0, vis + shade-given-vis against the fused shade); the image
     against the BVH path kernel's of the same seed;
     both candidates timed in turns; the same render through the CLI's
     default route (the first candidate of engine.BIG_PATH_ORDER: its
     backend, its launches, the renderer's image bit for bit once both are
     .hdr files); each of the three kernels against its
     plain version on the recorded state of depth 0 and two later bounces;
     (b) the same box with an 8x8 checker on every material but the
     emitter's through the CLI (backend bounce-kernel), and at 256x256
     against the plain textured pipeline; (c) one make_bounce_train_step
     at 1920x1080, 4 spp, depth 8 with its times, its gradients against
     the plain pipeline's at 256x256, and a 5-step optim.fit of
     mat_diffuse whose loss and red wall's albedo error fall.
 12. this slice's paths at full width on the levels-5 box: (a) the
     point-light box at 1920x1080, 4 spp, depth 4 through cli.main on the
     BVH Whitted kernel (backend bvh-whitted-kernel, launches > 0), the
     kernel's CUDA-event time, the kernel against its plain version over
     the whole image (whose counters give the bound) and on 48 tiles of
     1,024 lanes, against the Whitted kernel over the brute sweep on
     levels-2 at 64x64, and against the `--backend bvh` Whitted wavefront
     at 256x256, 16 spp (means within 2.5%); (b) the same box with the 8x8
     checker through cli.main on the textured kernel (backend
     bvh-whitted-deferred-kernel), the kernel and the renderer timed, the
     image against the plain version's (records and their epilogue) over
     the whole image and on the tiles, the bound from the walks the
     kernel makes, and the render against the textured wavefront at
     256x256; (c) one make_bvh_train_step at 1920x1080, 4
     spp, depth 8 (red wall x 0.6) with the times of the BVH PRB pair and
     of the step, the pair against its plain versions at those shapes and
     the gradients at 256x256, and a 5-step optim.fit of mat_diffuse and
     mat_emissive whose loss and red wall's albedo error fall; (d) a
     3-step optim.fit of tri_v0 over the refitted tree (`--backend bvh`
     tree, 128x128, 1 spp, depth 2): walk launches, finite losses, refit
     milliseconds a step.
 13. the binned dense sweep (kernel 10) and the grouped-pointer walk
     (kernel 11): (a) at 64x64, 4 spp, depth 4 on Cornell, levels-2 and
     levels-5, the binned renderer's sweeps on kernel 10 against the same
     sweeps on plain rounds (every bounce's recorded rays), the vis
     kernel's draw-only mode against its plain version, the image against
     bounce_reference_render, the binned trainer's gradients against the
     plain rounds'; G8 against kernel 5's plain walk of the leaf-128 tree
     on random rays and phase 3's recorded sweeps (the three scenes),
     (t, row) bit for bit, nearest and any hit;
     (b) make_big_path_renderer(order=("binned",)) on the levels-5 box at
     1920x1080, 4 spp, depth 8: backend binned-kernel, kernel-10 launches,
     rounds a sweep, kernel 10's summed CUDA-event time a render and its
     bound, the render's time in turns with the bounce pipeline's and the
     two images held together; kernel 10 per launch over the recorded
     rounds of a 256x256 render and over those of one 1920x1080 sweep (the
     nearest sweep of the render's depth-1 rays), (t, row) bit for bit its
     plain version's on each round, timed by CUDA-graph replay, each set
     with its bound; (c) one binned train step at 1920x1080, 4
     spp, depth 8 (red wall x 0.6), and a 3-step SGD fit of the red wall's
     albedo at 256x256 whose loss and error fall; (d) the 256x256, 16 spp,
     depth 4 wavefront over G8 (launches; the image against kernel 5's on
     the same leaf-128 tree), G8's registers and resident blocks as
     built, G8 against the plain walk bit for bit (nearest and any hit)
     on the 1080p render's depth-1 bounce wavefront (phase 10's sweeps
     are held in (a)), and G8 and kernel 5 timed per launch on that tree
     by CUDA-graph replay of phase 10's recorded sweeps and of that
     wavefront.
 14. every single-device render option and CLI flag, each route on kernel
     2 or 5 (their launches > 0; no fallback): (a) --normal-maps on the
     Cornell box with write_normal_map's map as map_bump on every wall
     and box, through the CLI at 1920x1080, 4 spp, depth 4, 2 light
     samples (backend brute-kernel) and with --backend bvh on the
     levels-5 box at 256x256 (bvh-kernel), each against the same route
     without the map (the image moves), and at 256x256, 2 spp the render
     over kernel 5 against the render over its plain walk, one seed;
     (b) --checkpoint at 1920x1080, 4 spp, depth 4: -p 2 then -p 4 with
     --checkpoint-every 2 (resumed) against -p 4 --checkpoint-every 4
     (the accumulations allclose, rtol 1e-5, atol 1e-6), and --regen
     --checkpoint at 256x256; (c) one make_loss gradient at 256x256, 2
     spp, depth 4 for remat False, True and "hits": values and gradients
     within 1e-6 of the largest entry, kernel 2's launches the same and
     none in the backward pass; (d) fold_samples at 256x256, 16 spp,
     depth 4: the mean within 2.5% of the per-sample loop's, one nearest
     sweep of 1,048,576 rays a bounce, kernel 2 on it bit for bit its
     plain version's and timed by CUDA events.
 15. ray sharding over torch.distributed (parallel/): (a) on the one card,
     kernel 1 on 2- and 3-way pixel tiles of the main path (1920x1080,
     16 spp, depth 8) reassembles bit for bit into its whole image, kernels
     3a/3b's tiles of the 1080p 4 spp train problem equal the whole step's
     rows and planes (3b's tile gradients add up to the whole image's),
     and 64x64 tiles of the three match their plain versions' tiles;
     the cost of render_sharded's global stream is timed (a path
     bounce's uniforms for the whole 1080p wavefront, against a half
     tile's); (c) a world of one on NCCL: render_shardmap and
     make_train_step_shardmap on kernel 2 (one all-gather, one all-reduce;
     the image is render's), render_sharded (render's image too) and
     render_regen_shardmap (render_regen's); (b) two ranks spawned on the
     one card, on gloo over CUDA tensors (NCCL refuses two ranks on one
     device): the sharded kernel-1 main path bit for bit the single-device
     image, the sharded kernel 8 and 7a renders and the bounce pipeline on
     the levels-5 box at 256x256 against their single-device images, the
     --shard CLI on Cornell at 1080p 16 spp through kernel 2, with
     --backend bvh through kernel 5, with --regen and with --checkpoint
     (rank 0 alone writes), render_sharded at 256x256 against one
     device's render, and the sharded 3a/3b, bounce and wavefront
     (make_train_step) train steps (one all-reduce each, its bytes;
     gradients against the single-device step's). Each rank's render ms, the all-gather's ms and
     bytes, and every kernel's launches are printed. Two ranks on one card
     share its SMs: no multi-GPU scaling figure comes from this phase.
 16. the last modules: (a) primitive sharding
     (parallel/primitive_sharding.py) on a (1, 2) mesh of two gloo ranks on
     the one card: render_tp on the point-light Cornell box at 1920x1080,
     1 spp, depth 4, on the Cornell box at 1920x1080, 2 spp, depth 2, and
     on the levels-5 box at 256x256, each bit for bit one device's
     render(intersect=intersect_brute_kernel), kernel 2 launched and one
     all-gather issued for each intersect call; each rank's ms, the
     all-gathers' bytes and one all-gather's ms alone; (b) treelets: the
     engine's cap lowered so that the levels-5 box splits into >= 3 parts,
     its path wavefront at 256x256, 4 spp, depth 4 and its Whitted
     wavefront at 1920x1080, 4 spp, depth 4 on kernel 5 (nearest and any
     hit launches counted) within fused_agree of the one tree's; (c) the
     viewer: fps_probe (8 frames at 192x108) on the five megakernel routes
     (kernels 1, 8, 4, 7a, 7b), their ms a frame and fps, on each an
     overridden frame bit for bit a renderer built for that camera, and a
     scripted run_viewer session that dumps the camera; (d)
     render_multihost in an NCCL world of one (render's image) and on the
     two ranks of (a) at 1920x1080, 16 spp, depth 8 (both images equal,
     within 1e-6 of one device's render); (e) the example ports
     (examples/torch_*.py --small) side by side, their seconds.
Phase 3 also holds the walk kernel (nearest and any-hit) against its plain
version on random rays and on a wavefront's recorded rays for levels-4 and
levels-5 at leaf widths 128 and the engine's, against the brute kernel on
levels-4, the BVH path kernel against its plain version at 64x64 on
levels-2 and levels-5 and against the brute training forward on levels-2,
the three bounce kernels against their plain versions on every bounce
of a 64x64 render of Cornell, levels-2 and levels-5 at leaf widths 2 and
128, with and without the replay dump, and the BVH Whitted kernels
(untextured, textured) and the BVH PRB forward and replay against their
plain versions at 64x64 on Cornell, levels-2 and levels-5 at leaf widths
2 and 128.

Every phase prints its wall seconds on a line of its own ("[phase n]
... s wall"). The line before the last is a JSON object with one record
per kernel (kernels 2 and 10 also carry their 1920x1080 time and bound,
`hd_ms` and `hd_bound_ms`, kernel 2 its time and bound on phase 14's
folded sweep, `fold_ms` and `fold_bound_ms`; kernels 1, 2, 4, 5, 7a, 7b
and 8 their launches in phase 16, `phase16_launches`); the last line is {"ok":
true, "device": {...}}. Without a CUDA device the script fails before
printing either.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from cornell_scenes import (random_rays, two_emitter, write_cornell,
                            write_cornell_whitted)

# H100 SXM peaks (NVIDIA data sheet, dense): FP32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 arithmetic per Woop ray-triangle test (ops/woop.py): origin
# transform 3 x (3 mul + 3 add), direction transform 3 x (3 mul + 2 add),
# one divide, u/v 2 x (mul + add), the eps product; compares not counted
WOOP_TEST_FLOPS = 39
# FP32 arithmetic per slab (ray-box) test of the BVH walks: 6 subtracts and
# 6 multiplies; the 10 min/max and the compares not counted
SLAB_TEST_FLOPS = 12

MAIN = dict(xres=1920, yres=1080, samples=16, light_samples=2, depth=8)
SECOND = dict(xres=256, yres=256, samples=16, light_samples=2, depth=4)
TRAIN = dict(xres=1920, yres=1080, samples=4, light_samples=2, depth=8)
WHITTED = dict(xres=1920, yres=1080, samples=4, light_samples=1, depth=4)
BIG_LEVELS = 5          # 34 * 4**5 + 2 = 34,818 triangles
REGEN = dict(xres=256, yres=256, samples=16, light_samples=2, depth=8)
BIG_WHITTED = dict(xres=512, yres=512, samples=4, light_samples=1, depth=4)
HD = dict(xres=1920, yres=1080)   # kernel 5's sweeps of a 1080p wavefront
TILE_LANES, N_TILES = 1024, 48     # phase 9's tiles through pix_base
# kernel vs plain gradients: max |difference| <= this x the largest entry
GRAD_TOL = 1e-3
# backend name of each big-path candidate on a CUDA scene
BIG_BACKENDS = {"bounce": "bounce-kernel", "walk": "bvh-path-kernel",
                "binned": "binned-kernel"}
# plain gradient steps of phase 13's binned fit of the red wall's albedo
BINNED_FIT_LR = 2.0
# phase 14's shapes: the normal-mapped and the checkpointed Cornell box,
# the small wavefronts (normal maps over the tree, remat, folded samples)
OPTIONS_HD = dict(xres=1920, yres=1080, samples=4, light_samples=2, depth=4)
OPTIONS_SMALL = dict(xres=256, yres=256, samples=4, light_samples=2, depth=4)
REMAT = dict(samples=2, max_depth=4, light_samples=2)
FOLD = dict(samples=16, max_depth=4, light_samples=2)
# phase 15: the ranks of the two-rank world on the one card, the box's
# routes' shapes there, the world-of-one NCCL route's, and the ranks'
# deadline (a rank that fails or hangs fails the phase)
SHARD_WORLD = 2
SHARD_BOX = dict(xres=256, yres=256, samples=16, light_samples=2, depth=8)
SHARD_BOX_TRAIN = dict(xres=256, yres=256, samples=4, light_samples=2,
                       depth=8)
SHARD_WHITTED = dict(xres=256, yres=256, samples=4, light_samples=1, depth=4)
SHARD_ONE = dict(xres=256, yres=256, samples=4, light_samples=2, depth=4)
SHARD_SEED = 0
SHARD_TIMEOUT = 420.0
# phase 16: primitive sharding's (1, 2) renders at full width, the
# levels-5 box on it, treelets (the cap lowered so that the box splits),
# the viewer's probe, render_multihost, and the two ranks' deadline
TP_WHITTED = dict(xres=1920, yres=1080, samples=1, light_samples=1, depth=4)
TP_PATH = dict(xres=1920, yres=1080, samples=2, light_samples=2, depth=2)
TP_BOX = dict(xres=256, yres=256, samples=1, light_samples=2, depth=2)
TREELET_PATH = dict(xres=256, yres=256, samples=4, light_samples=2, depth=4)
TREELET_WHITTED = dict(xres=1920, yres=1080, samples=4, light_samples=1,
                       depth=4)
TREELET_CAP = 20000
VIEWER = dict(xres=192, yres=108, frames=8)
MULTIHOST = dict(xres=1920, yres=1080, samples=16, light_samples=2, depth=8)
SLICE_SEED = 5


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


class PhaseClock:
    """Prints each phase's wall seconds on a line of its own."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"[phase {phase}] {now - self.t:.1f} s wall", flush=True)
        self.t = now


def brute_equal(name: str, kernel, plain) -> None:
    """The brute kernel's (t, id) equal the plain version's bit for bit."""
    import torch

    check(torch.equal(kernel[1], plain[1]) and torch.equal(kernel[0],
                                                           plain[0]),
          f"brute {name}: (t, id) differ from the plain version's")


def corr(a, b) -> float:
    return float((a * b).sum()
                 / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-20))


def event_ms(fn, reps: int, inner: int = 1):
    """CUDA-event times of `fn()` after one warm-up: `reps` event pairs,
    each around `inner` back-to-back calls. Returns (median ms per call,
    [ms per call of each pair], the last call's result)."""
    import torch

    out = fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times)), times, out


def fused_agree(name: str, k, p) -> float:
    """Hold a fused kernel image against its plain version: <= 1% of pixels
    off by more than 1e-4 + 1e-3*|ref|, means within rel 1e-3. Returns the
    largest absolute difference."""
    k, p = k.cpu().numpy(), p.cpu().numpy()
    check(np.isfinite(k).all(), f"fused {name}: non-finite")
    bad = np.abs(k - p) > 1e-4 + 1e-3 * np.abs(p)
    frac_bad = float(bad.any(axis=1).mean())
    mean_rel = abs(k.mean() - p.mean()) / max(abs(p.mean()), 1e-20)
    err = float(np.abs(k - p).max())
    print(f"[fused {name}] pixels off {frac_bad:.5f}, mean {k.mean():.6g} "
          f"vs {p.mean():.6g} (rel {mean_rel:.3g}), max abs {err:.3g}")
    check(frac_bad <= 0.01, f"fused {name}: {frac_bad} pixels off")
    check(mean_rel <= 1e-3, f"fused {name}: mean rel {mean_rel}")
    check(p.mean() > 0, f"fused {name}: black image")
    return err


def grad_agree(name: str, kernel, plain) -> float:
    """Hold gradient tables against the plain version's: max |difference|
    <= GRAD_TOL x the largest |entry|. Returns the max |difference|."""
    k, p = kernel.cpu().numpy(), plain.cpu().numpy()
    check(np.isfinite(k).all(), f"grad {name}: non-finite")
    scale = float(np.abs(p).max())
    err = float(np.abs(k - p).max())
    print(f"[grad {name}] max abs {err:.4g}, largest entry {scale:.4g} "
          f"(rel {err / max(scale, 1e-30):.3g})")
    check(scale > 0, f"grad {name}: all zero")
    check(err <= GRAD_TOL * scale,
          f"grad {name}: {err} > {GRAD_TOL} x {scale}")
    return err


def agreeing_lanes(ls_k, ls_p):
    """[n] bool: lanes whose per-sample radiance (ls [n, 3 samples]) the
    kernel and the plain version agree on to fused_agree's tolerance. A
    nearest hit on a shared edge that the kernel's contracted Woop test
    decides the other way sends a path elsewhere; the replays of such a
    lane follow different paths, so a replay is held against its plain
    version on the agreeing lanes (a zero cotangent elsewhere)."""
    return ~((ls_k - ls_p).abs() > 1e-4 + 1e-3 * ls_p.abs()).any(dim=1)


def once_ms(fn):
    """CUDA-event time of one call of `fn` (no warm-up): (ms, result)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def brute_agree(name: str, kernel, plain) -> float:
    """Hold brute sweep results (t, id) against the plain version's: ids
    equal on >= 99.9% of rays, t within rel 1e-5 where they agree. Returns
    the largest absolute t difference there."""
    (t_k, id_k), (t_p, id_p) = kernel, plain
    same = id_k == id_p
    frac = float(same.float().mean())
    both = same & (id_p >= 0)
    diff = (t_k - t_p).abs()[both]
    rel = float((diff / t_p[both].abs()).max()) if diff.numel() else 0.0
    err = float(diff.max()) if diff.numel() else 0.0
    print(f"[brute {name}] {id_p.numel()} rays, ids equal {frac:.6f}, max "
          f"rel t {rel:.3g}, hits {int((id_p >= 0).sum())}")
    check(frac >= 0.999, f"brute {name}: ids equal on {frac}")
    check(rel <= 1e-5, f"brute {name}: t rel {rel}")
    return err


def mask_agree(name: str, kernel, plain) -> None:
    """Any-hit results (t, row): the hit masks must be equal, t is 1.0 on
    a hit and +inf on a miss."""
    import torch

    (t_k, r_k), (_, r_p) = kernel, plain
    same = float(((r_k >= 0) == (r_p >= 0)).float().mean())
    print(f"[any-hit {name}] {r_p.numel()} rays, masks equal {same:.6f}, "
          f"hits {int((r_p >= 0).sum())}")
    check(same == 1.0, f"any-hit {name}: masks equal on {same}")
    check(bool((t_k[r_k >= 0] == 1.0).all())
          and bool(torch.isinf(t_k[r_k < 0]).all()), f"any-hit {name}: t")


def walk_agree(name: str, k, p) -> float:
    """Hold hitdata [8, n] of the bounce walk kernel against the plain
    version's: hit flag and winner row equal on >= 99.9% of lanes (a tie
    may break the other way); of those that hit, t within rel 1e-5 + 1e-6
    and (u, v) within 1e-4 on >= 99.9%, and within rel 1e-2 / 1e-2 on all
    (the kernel contracts the Woop test's multiply-adds, which moves a
    grazing ray's t = -o_w / d_w most: rel 1.6e-3 on one lane of 6
    million). Returns the largest absolute t difference there."""
    same = (k[4] == p[4]) & (k[3] == p[3])
    frac = float(same.float().mean())
    both = same & (p[4] > 0)
    dt = (k[0] - p[0]).abs()[both]
    t_ref = p[0][both].abs()
    duv = (k[1:3] - p[1:3]).abs()[:, both].amax(dim=0)
    none = dt.numel() == 0
    rel = 0.0 if none else float((dt / t_ref).max())
    uv = 0.0 if none else float(duv.max())
    close = 1.0 if none else float(((dt <= 1e-5 * t_ref + 1e-6)
                                    & (duv <= 1e-4)).float().mean())
    print(f"[walk {name}] {p.shape[1]} lanes, winners equal {frac:.6f}, t "
          f"within rel 1e-5 and uv within 1e-4 on {close:.6f} (max rel "
          f"{rel:.3g}, max |uv| diff {uv:.3g}), hits {int((p[4] > 0).sum())}")
    check(frac >= 0.999, f"walk {name}: winners equal on {frac}")
    check(close >= 0.999 and rel <= 1e-2 and uv <= 1e-2,
          f"walk {name}: close on {close}, max rel t {rel}, max uv {uv}")
    check(not bool(k[5:].any()), f"walk {name}: rows 5-7 not zero")
    return 0.0 if none else float(dt.max())


def vis_agree(name: str, k, p) -> float:
    """Visibility planes [8, n] of the bounce vis kernel against the plain
    version's: both samples' 0/1 flags equal on >= 99.9% of lanes. Returns
    the share of lanes that differ."""
    same = (k[0] == p[0]) & (k[1] == p[1])
    frac = float(same.float().mean())
    print(f"[vis {name}] {p.shape[1]} lanes, planes equal {frac:.6f}, "
          f"visible samples {int(p[:2].sum())}")
    check(frac >= 0.999, f"vis {name}: planes equal on {frac}")
    check(not bool(k[2:].any()) and bool(((k[:2] == 0) | (k[:2] == 1)).all()),
          f"vis {name}: planes not 0/1 or rows 2-7 not zero")
    return 1.0 - frac


def shade_agree(name: str, k, p, rows: int = 13) -> float:
    """Hold a shaded state prefix [16, n] (or an aux dump, rows=15) of the
    bounce shade kernel against the plain version's: a lane is off when
    one of its first `rows` rows differs by more than 1e-4 + 1e-3*|ref|;
    <= 1% of lanes may be (a shadow tie that breaks the other way, a
    cosine an ulp apart). For a state the sort key is equal on >= 99% of
    lanes (an origin on a cell face may land next door) and the riders
    (pixel, sample) everywhere. Returns the largest absolute difference."""
    check(bool(torch_isfinite(k)), f"shade {name}: non-finite")
    bad = (k[:rows] - p[:rows]).abs() > 1e-4 + 1e-3 * p[:rows].abs()
    frac_bad = float(bad.any(dim=0).float().mean())
    err = float((k[:rows] - p[:rows]).abs().max())
    msg = (f"[shade {name}] {p.shape[1]} lanes, lanes off {frac_bad:.5f}, "
           f"max abs {err:.3g}")
    if rows == 13:
        keys = float((k[13] == p[13]).float().mean())
        msg += (f", keys equal {keys:.5f}, continuing "
                f"{int((p[9] > 0).sum())}")
        check(keys >= 0.99, f"shade {name}: keys equal on {keys}")
        check(bool((k[14:] == p[14:]).all()), f"shade {name}: riders moved")
    print(msg)
    check(frac_bad <= 0.01, f"shade {name}: {frac_bad} lanes off")
    return err


def binned_round_agree(name: str, st, key, sweep) -> float:
    """Hold kernel 10 against its plain version on one round's inputs (st
    [8, n], key [n] sorted) over `sweep`'s bins and table: (t, row) bit
    for bit (the kernel's Woop test is written without FMA contraction),
    which implies winner rows equal on >= 99.9% of lanes and t within rel
    1e-5 where they are (checked too). Returns the largest absolute t
    difference there."""
    from orion_tpu_torch.ops import binned as bn

    k = bn.binned_round(st, key, sweep.row0, sweep.nb, sweep.tab)
    p = bn.binned_round_plain(st, key, sweep.row0, sweep.nb, sweep.tab)
    same = k[1] == p[1]
    frac = float(same.float().mean())
    real = same & (p[1] < bn.NO_ROW)
    dt = (k[0] - p[0]).abs()[real]
    rel = float((dt / p[0][real].abs()).max()) if dt.numel() else 0.0
    print(f"[binned round {name}] {key.numel()} lanes, rows equal "
          f"{frac:.6f}, bit for bit {bool((k == p).all())}, max rel t "
          f"{rel:.3g}, winners {int(real.sum())}")
    check(frac >= 0.999, f"binned round {name}: rows equal on {frac}")
    check(rel <= 1e-5, f"binned round {name}: t rel {rel}")
    check(bool((k == p).all()), f"binned round {name}: not bit for bit")
    return float(dt.max()) if dt.numel() else 0.0


def draws_agree(name: str, data, st, hd, seed: int, depth: int,
                light_samples: int) -> None:
    """Hold the vis kernel's draw-only mode against its plain version on
    one bounce's state: every site's need flag equal on >= 99.9% of lanes
    (a geometry term of zero may round either way), and the shadow origin
    and directions within 1e-4 + 1e-3*|ref| on >= 99.9% of the lanes that
    need the site (the kernel contracts the light point's multiply-adds)."""
    import torch

    from orion_tpu_torch.ops import bounce as bo

    k = bo.bounce_vis(data, st, hd, seed, depth, draws=True,
                      light_samples=light_samples)
    p = bo.bounce_vis_plain(data, st, hd, seed, depth, draws=True,
                            light_samples=light_samples)
    S = (p.shape[0] - 3) // 4
    need_k = k[6::4][:S] > 0
    need_p = p[6::4][:S] > 0
    same = float((need_k == need_p).float().mean())
    close = []
    for s in range(S):
        rows = list(range(3)) + [3 + 4 * s + c for c in range(3)]
        ok = ((k[rows] - p[rows]).abs()
              <= 1e-4 + 1e-3 * p[rows].abs()).all(dim=0)
        sel = need_p[s] & need_k[s]
        close.append(float(ok[sel].float().mean()) if bool(sel.any())
                     else 1.0)
    print(f"[draws {name}] {p.shape[1]} lanes x {S} sites, need flags "
          f"equal {same:.6f}, rays close {min(close):.6f}, needed "
          f"{int(need_p.sum())}")
    check(torch_isfinite(k), f"draws {name}: non-finite")
    check(same >= 0.999 and min(close) >= 0.999,
          f"draws {name}: flags {same}, rays {close}")
    check(bool(torch.equal(k[:, hd[4] == 0], torch.zeros_like(
        k[:, hd[4] == 0]))), f"draws {name}: a missed lane drew")


def torch_isfinite(x) -> bool:
    import torch

    return bool(torch.isfinite(x).all())


def bounce_kernels_agree(name: str, fn, seed: int, *, depths=None,
                         with_aux: bool = False, chunk: int = 1 << 22):
    """Render once through `fn` (a make_bounce_path_renderer on the card),
    keep the state and the kernels' outputs of every bounce in `depths`
    (default: all), and hold each of the three kernels against its plain
    version on those inputs, `chunk` lanes at a time. The vis kernel and
    the shade kernel fed its planes are held too where the scene has one
    emitter and the render two light samples.

    Returns {depth: dict(n=lanes, hits=lanes that hit, errs=(walk, vis,
    shade), plain_ms=(walk, vis, shade), stats=(walk, vis, shade))}: the
    plain versions' CUDA-event times and work counters (box_tests, tests).
    """
    import torch

    from orion_tpu_torch.ops import bounce as bo

    ctx = fn.ctx
    data, D, LS = ctx["data"], ctx["max_depth"], ctx["light_samples"]
    pair = LS == 2 and data.em.shape[0] == 1
    rec = []

    def record(depth, n, st, hd, kd, vis):
        if depths is None or depth in depths:
            rec.append((depth, n, st[:, :n].clone(), hd, kd))

    fn(seed, record=record)
    torch.cuda.synchronize()
    out = {}
    for depth, n, st, hd, kd in rec:
        errs, ms = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
        stats = [{}, {}, {}]
        for a in range(0, n, chunk):
            b = min(n, a + chunk)
            tag = f"{name} depth {depth} lanes {a}:{b}"
            st_c = st[:, a:b].contiguous()
            hd_c = hd[:, a:b].contiguous()
            kd_c = None if kd is None else kd[:, a:b].contiguous()
            t, p = once_ms(lambda: bo.bounce_walk_plain(data, st_c, b - a,
                                                       stats[0]))
            ms[0] += t
            errs[0] = max(errs[0], walk_agree(tag, hd_c, p))
            vis_k = None
            if pair:
                vis_k = bo.bounce_vis(data, st_c, hd_c, seed, depth)
                t, p = once_ms(lambda: bo.bounce_vis_plain(
                    data, st_c, hd_c, seed, depth, stats[1]))
                ms[1] += t
                errs[1] = max(errs[1], vis_agree(tag, vis_k, p))
            st_k = st_c.clone()
            aux_k = bo.bounce_shade(data, st_k, hd_c, seed, depth, D, LS,
                                    kd=kd_c, with_aux=with_aux)
            t, (st_p, aux_p) = once_ms(lambda: bo.bounce_shade_plain(
                data, st_c, hd_c, seed, depth, D, LS, kd=kd_c,
                with_aux=with_aux, stats=stats[2]))
            ms[2] += t
            errs[2] = max(errs[2], shade_agree(tag, st_k, st_p))
            if with_aux:
                shade_agree(f"{tag} aux", aux_k, aux_p, rows=15)
            if pair:
                # the shade kernel fed the vis kernel's planes: the same
                # bounce as with its own shadow walks
                st_v = st_c.clone()
                aux_v = bo.bounce_shade(data, st_v, hd_c, seed, depth, D, LS,
                                        kd=kd_c, vis=vis_k,
                                        with_aux=with_aux)
                shade_agree(f"{tag} given vis", st_v, st_k)
                if with_aux:
                    shade_agree(f"{tag} aux given vis", aux_v, aux_k, rows=15)
        out[depth] = dict(n=n, hits=int((hd[4] > 0).sum()), errs=errs,
                          plain_ms=ms, stats=stats)
    return out


def record_sweeps(scene, cam, intersect, cfg: dict, seed: int = 0):
    """Every sweep (orig, dirs, alive) that one wavefront sample of
    `render` hands to its intersect function."""
    import torch

    from orion_tpu_torch.render import render

    calls = []

    def recorder(sc, orig, dirs, *, alive=None):
        a = alive if alive is not None else torch.ones(
            orig.shape[0], dtype=torch.bool, device=orig.device)
        calls.append(tuple(x.detach().contiguous().clone()
                           for x in (orig.float(), dirs.float(), a)))
        return intersect(sc, orig, dirs, alive=alive)

    gen = torch.Generator(device=scene.device)
    gen.manual_seed(seed)
    with torch.no_grad():
        render(scene, cam, gen, samples=1, max_depth=cfg["depth"],
               light_samples=cfg["light_samples"], intersect=recorder)
    return calls


def plain_intersect(ps):
    """The plain PyTorch version of a prepared scene's wavefront intersect,
    on the scene's device: the brute oracle (ops/intersect.py) for
    "brute-kernel", the plain walk of the same packed tree for
    "bvh-kernel"."""
    from orion_tpu_torch.ops import bvh_intersect as bx
    from orion_tpu_torch.ops.intersect import intersect_brute

    if ps.backend == "brute-kernel":
        return intersect_brute
    check(ps.backend == "bvh-kernel", f"no plain intersect for {ps.backend}")
    nodes, tri = bx._bvh_device_layout(ps.bvh, ps.scene.device)
    return bx.rows_to_hits(ps.bvh, ps.scene, lambda o, d, a: bx.bvh_walk_plain(
        nodes, tri, o, d, a, leaf_width=ps.bvh.leaf_width))


def graph_ms(run, passes: int, replays: int):
    """Per launch of `run()` (a list of kernel launches): the CUDA-event
    median over `replays` replays of a CUDA graph of `passes` passes, and
    the spread (max - min) / median of the replays. Eager launches from
    Python leave the card waiting on the host; a graph measures the
    kernels. `run` is called once first, outside the capture."""
    import torch

    n = len(run())
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(passes):
            run()
    ms, times, _ = event_ms(graph.replay, replays)
    del graph
    return (ms / (passes * n),
            (max(times) - min(times)) / float(np.median(times)))


def walk_bound(stats: dict, sweeps, nodes, tri):
    """(ms, 'operations' | 'bytes') of one launch of kernel 5 over `sweeps`,
    on average: the plain walk's node visits (SLAB_TEST_FLOPS each) and Woop
    tests of real rows (WOOP_TEST_FLOPS) in `stats`, against each ray's 33
    bytes (origin, direction, alive in; t, row out) and the tree once."""
    n = len(sweeps)
    n_rays = sum(o.shape[0] for o, _, _ in sweeps)
    return bound_ms(
        (stats["box_tests"] * SLAB_TEST_FLOPS
         + stats["tests"] * WOOP_TEST_FLOPS) / n,
        (n_rays * 33 + n * (nodes.numel() + tri.numel()) * 4) / n)


def bound_ms(flops: float, nbytes: float):
    """(ms, 'operations' | 'bytes'): the larger of the two floors."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def brute_bound_ms(n_rays: int, n_alive: int, rows: int, n_sweeps: int):
    """bound_ms of one brute sweep on average over n_sweeps sweeps of
    n_rays rays in all, n_alive of them live: a Woop test of every live ray
    against every row, against the bytes a launch must move. A live ray
    reads its origin, direction and alive byte and writes (t, id): 33
    bytes. A dead ray reads only its alive byte and writes (t, id): 9
    bytes. The [rows, 16] f32 table is read once."""
    return bound_ms(
        n_alive * rows * WOOP_TEST_FLOPS / n_sweeps,
        (n_alive * 33 + (n_rays - n_alive) * 9) / n_sweeps + rows * 16 * 4)


def run_cli(rtc: Path, out: Path, cfg: dict, backend=None, extra=(),
            report: bool = False):
    """Render through cli.main; the image, or (image, the --stats report)
    with report=True."""
    from orion_tpu_torch import cli
    from orion_tpu_torch.io.image import load_hdr

    argv = [str(rtc), "-o", str(out), "-p", str(cfg["samples"]),
            "-l", str(cfg["light_samples"]), "--depth", str(cfg["depth"]),
            "--xres", str(cfg["xres"]), "--yres", str(cfg["yres"]),
            "--stats", *extra]
    if backend:
        argv += ["--backend", backend]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    sys.stderr.write(err.getvalue())
    check(rc == 0, f"cli exit code {rc}")
    if not report:
        return load_hdr(out)
    stats = [ln for ln in err.getvalue().splitlines() if ln.startswith("{")]
    return load_hdr(out), json.loads(stats[-1])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs on the GPU only",
              file=sys.stderr)
        return 1
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import brute_intersect as bi
    from orion_tpu_torch.ops import cuda_build
    from orion_tpu_torch.ops import fused_path as fp
    from orion_tpu_torch.ops import prb
    from orion_tpu_torch.ops import whitted as wh
    from orion_tpu_torch.scene import load_scene, subdivide_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. device and build ---------------------------------------------------
    clock = PhaseClock()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{kind}")
    t0 = time.perf_counter()
    built = cuda_build.build(["fused_path", "brute_intersect", "prb",
                              "whitted", "bvh_intersect", "bvh_path",
                              "bounce", "bvh_whitted", "binned", "bvh_g8"])
    print(f"[1] built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1] {name}: {line.strip()}")
    clock.lap("1")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 2. scenes ---------------------------------------------------------
        rtc_path = write_cornell(tmp, xres=64, yres=64, depth=4)
        cornell, rtc = load_scene(rtc_path, device=dev)
        lv2 = subdivide_scene(cornell, levels=2)
        lv4 = subdivide_scene(cornell, levels=4)
        em2 = two_emitter(cornell)
        cam64 = camera_from_rtc(rtc, device=dev)
        wrtc64 = write_cornell_whitted(tmp / "whitted64", xres=64, yres=64,
                                       depth=4)
        wsc64, wr64 = load_scene(wrtc64, device=dev)
        big_rtc = write_cornell(tmp / "big", xres=64, yres=64, depth=4,
                                levels=BIG_LEVELS)
        t0 = time.perf_counter()
        lv5, _ = load_scene(big_rtc, device=dev)
        print(f"[2] levels-{BIG_LEVELS} file: {lv5.num_triangles} tris, "
              f"loaded in {time.perf_counter() - t0:.3f} s")
        check(lv5.num_triangles == 34 * 4 ** BIG_LEVELS + 2,
              f"levels-{BIG_LEVELS} triangle count {lv5.num_triangles}")
        print(f"[2] cornell {cornell.num_triangles} tris, levels-2 "
              f"{lv2.num_triangles} (T_pad {fp._fused_t_pad(lv2.num_triangles)}"
              f"), levels-4 {lv4.num_triangles}, two-emitter "
              f"{em2.num_emissive} emitters, Whitted {wsc64.num_lights} "
              f"light(s)")
        clock.lap("2")

        # 3. kernels against their plain versions --------------------------
        brute_err = 0.0
        for name, sc in (("cornell", cornell), ("levels-4", lv4)):
            o, d, alive = random_rays(1 << 18, 1, dev)
            tab = bi.pack_tri_rows16(sc)
            k = bi.brute_sweep(tab, o, d, alive)
            torch.cuda.synchronize()
            brute_err = max(brute_err, brute_agree(
                f"{name} random", k, bi.brute_sweep_plain(tab, o, d, alive)))

        fused_err = 0.0
        for name, sc in (("cornell", cornell), ("levels-2", lv2),
                         ("levels-4", lv4), ("two-emitter", em2)):
            args = fp.fused_args(sc, cam64)
            cfg = (64, 64, 4, 4, 2)
            k = fp.fused_path(*args, 1234, *cfg)
            torch.cuda.synchronize()
            fused_err = max(fused_err, fused_agree(
                f"{name} 64x64", k, fp.fused_path_plain(*args, 1234, *cfg)))

        # the PRB pair (one emitter: the two-emitter scene is outside the
        # training gate), each kernel fed its own forward's record
        fwd_err = replay_err = 0.0
        for name, sc in (("cornell", cornell), ("levels-2", lv2),
                         ("levels-4", lv4)):
            args = fp.fused_args(sc, cam64)
            cfg = (64, 64, 4, 4, 2)
            img_k, ls_k = prb.fused_fwd_ls(*args, 1234, *cfg)
            torch.cuda.synchronize()
            img_p, ls_p = fp.fused_fwd_ls_plain(*args, 1234, *cfg)
            fwd_err = max(fwd_err,
                          fused_agree(f"prb fwd {name} 64x64", img_k, img_p),
                          fused_agree(f"prb fwd L_s {name} 64x64", ls_k, ls_p))
            w = _cotangent(img_p, 4, 7)
            g_k = prb.prb_replay(*args, 1234, w, ls_k, *cfg)
            torch.cuda.synchronize()
            g_p = prb.prb_replay_plain(*args, 1234, w, ls_p, *cfg)
            replay_err = max(replay_err, grad_agree(
                f"prb replay {name} 64x64", g_k, g_p))

        wargs = wh.whitted_args(wsc64, camera_from_rtc(wr64, device=dev))
        cfg = (64, 64, 4, 4, True)
        k = wh.fused_whitted(*wargs, 1234, *cfg)
        torch.cuda.synchronize()
        whitted_err = fused_agree("whitted 64x64", k,
                                  wh.fused_whitted_plain(*wargs, 1234, *cfg))

        walk_err, path_err, walk_sweeps = _phase_bvh_checks(
            dev, rtc_path, lv2, lv4, lv5, cam64)
        bounce_errs = _phase_bounce_checks(
            (("cornell", cornell), ("levels-2", lv2),
             (f"levels-{BIG_LEVELS}", lv5)), cam64)
        slice5_errs = _phase_slice5_checks(tmp, dev, cornell, lv2, lv5, cam64)
        clock.lap("3")

        # 4. main path ------------------------------------------------------
        fp.KERNEL.launches = 0
        bi.KERNEL.launches = 0
        t0 = time.perf_counter()
        img = run_cli(rtc_path, tmp / "main.hdr", MAIN)
        secs = time.perf_counter() - t0
        fused_launches = fp.KERNEL.launches
        rays = MAIN["xres"] * MAIN["yres"] * MAIN["samples"]
        print(f"[4] main path {MAIN}: {secs:.3f} s through the CLI "
              f"({rays / secs:.4g} primary rays/s incl. scene setup), "
              f"fused launches {fused_launches}, brute launches "
              f"{bi.KERNEL.launches}, image mean {img.mean():.6g}")
        check(img.shape == (MAIN["yres"], MAIN["xres"], 3), "main shape")
        check(np.isfinite(img).all() and img.mean() > 0, "main image")
        check(fused_launches > 0, "main path never launched the fused kernel")
        clock.lap("4")

        # 5. second entry point: brute wavefront ---------------------------
        fp.KERNEL.launches = 0
        bi.KERNEL.launches = 0
        img_w = run_cli(rtc_path, tmp / "brute.hdr", SECOND, backend="brute")
        brute_launches = bi.KERNEL.launches
        print(f"[5] brute wavefront {SECOND}: brute launches "
              f"{brute_launches}, fused launches {fp.KERNEL.launches}")
        check(brute_launches > 0, "wavefront never launched the brute kernel")
        img_f = run_cli(rtc_path, tmp / "fused256.hdr", SECOND)
        c = corr(img_f, img_w)
        mrel = abs(img_f.mean() - img_w.mean()) / img_w.mean()
        print(f"[5] fused vs wavefront 256^2: corr {c:.4f}, mean "
              f"{img_f.mean():.6g} vs {img_w.mean():.6g} (rel {mrel:.3g})")
        check(np.isfinite(img_w).all(), "wavefront image non-finite")
        check(c > 0.93, f"corr {c}")
        check(mrel < 0.15, f"mean rel {mrel}")
        clock.lap("5")

        # 6. times at the main-path shapes ----------------------------------
        cam_main = camera_from_rtc(_resized(parse_rtc(rtc_path), MAIN),
                                   device=dev)
        args = fp.fused_args(cornell, cam_main)
        cfg = (MAIN["xres"], MAIN["yres"], MAIN["samples"], MAIN["depth"],
               MAIN["light_samples"])
        f_ms, f_times, k_main = event_ms(
            lambda: fp.fused_path(*args, 0, *cfg), 3)
        stats = {}
        f_plain_ms, p_main = once_ms(
            lambda: fp.fused_path_plain(*args, 0, *cfg, stats=stats))
        fused_err = max(fused_err, fused_agree("main 1080p", k_main, p_main))
        tests = stats["tests"]
        f_bound, f_by = bound_ms(
            tests * WOOP_TEST_FLOPS,
            args[0].numel() * 4 + rays // MAIN["samples"] * 12)
        print(f"[6] fused: {f_ms:.3f} ms kernel (runs "
              f"{', '.join(f'{x:.3f}' for x in f_times)}), {f_plain_ms:.3f} "
              f"ms plain, {tests:.6g} Woop tests, bound {f_bound:.4f} ms "
              f"({f_by})")

        # the brute sweep on the wavefront's own rays: every sweep of one
        # 256x256 sample at depth 4 (primary/bounce and NEE shadow rays)
        cam_w = camera_from_rtc(_resized(parse_rtc(rtc_path), SECOND),
                                device=dev)
        calls = record_sweeps(cornell, cam_w, bi.intersect_brute_kernel,
                              SECOND)
        tab = bi.pack_tri_rows16(cornell)
        for i, (o, d, alive) in enumerate(calls):
            k = bi.brute_sweep(tab, o, d, alive)
            torch.cuda.synchronize()
            brute_equal(f"256x256 wavefront sweep {i}", k,
                        bi.brute_sweep_plain(tab, o, d, alive))

        def sweeps(fn):
            return lambda: [fn(tab, o, d, alive) for o, d, alive in calls]

        # eager launches from Python leave the card waiting on the host, so
        # the kernel's own time is taken from a CUDA graph of 20 passes
        n_calls, passes = len(calls), 20
        b_ms, b_spread = graph_ms(sweeps(bi.brute_sweep), passes, 21)
        b_eager_ms, _, _ = event_ms(sweeps(bi.brute_sweep), 21, inner=passes)
        b_plain_ms, _, _ = event_ms(sweeps(bi.brute_sweep_plain), 5)
        b_eager_ms, b_plain_ms = b_eager_ms / n_calls, b_plain_ms / n_calls
        n_rays = sum(o.shape[0] for o, _, _ in calls)
        n_alive = sum(int(a.sum()) for _, _, a in calls)
        b_bound, b_by = brute_bound_ms(n_rays, n_alive, tab.shape[0],
                                       n_calls)
        print(f"[6] brute, per launch over the {n_calls} sweeps of one "
              f"wavefront sample ({n_rays} rays, {n_alive} alive, x "
              f"{tab.shape[0]} rows): {b_ms:.6f} ms kernel (median of 21 "
              f"replays of a CUDA graph of {passes} passes; spread "
              f"(max-min)/median {b_spread:.4f}), {b_eager_ms:.5f} ms "
              f"launched eagerly, {b_plain_ms:.4f} ms plain, bound "
              f"{b_bound:.6f} ms ({b_by})")
        # and on a 1920x1080 sample's sweeps (2,073,600 rays each: the
        # card full), bit for bit against the plain version on each
        hd = record_sweeps(cornell, camera_from_rtc(
            _resized(parse_rtc(rtc_path), HD), device=dev),
            bi.intersect_brute_kernel, SECOND)
        for i, (o, d, alive) in enumerate(hd):
            brute_equal(f"1080p wavefront sweep {i}",
                        bi.brute_sweep(tab, o, d, alive),
                        bi.brute_sweep_plain(tab, o, d, alive))
        hd_ms, hd_spread = graph_ms(
            lambda: [bi.brute_sweep(tab, o, d, a) for o, d, a in hd], 3, 7)
        hd_rays = sum(o.shape[0] for o, _, _ in hd)
        hd_alive = sum(int(a.sum()) for _, _, a in hd)
        hd_bound, hd_by = brute_bound_ms(hd_rays, hd_alive, tab.shape[0],
                                         len(hd))
        print(f"[6] brute, per launch over the {len(hd)} sweeps of one "
              f"{HD['xres']}x{HD['yres']} wavefront sample ({hd_rays} rays, "
              f"{hd_alive} alive): {hd_ms:.6f} ms kernel (median of 7 "
              f"replays of a CUDA graph of 3 passes; spread {hd_spread:.4f}),"
              f" bound {hd_bound:.6f} ms ({hd_by}); (t, id) equal to the "
              f"plain version's on every sweep at both sizes")
        del hd
        clock.lap("6")

        train = _phase_train(tmp, dev, card, fwd_err, replay_err)
        clock.lap("7")
        whit = _phase_whitted(tmp, dev, whitted_err)
        clock.lap("8")
        big = _phase_big_path(tmp, dev, card, lv5, float(img.mean()),
                              path_err)
        clock.lap("9")
        walk = _phase_bvh_wavefront(tmp, dev, walk_sweeps, walk_err)
        clock.lap("10")
        bounce = _phase_bounce(tmp, dev, card, lv5, bounce_errs)
        clock.lap("11")
        big_whitted = _phase_big_whitted(tmp, dev, card, slice5_errs)
        clock.lap("12 (a, b)")
        bvh_train = _phase_bvh_train(tmp, dev, card, slice5_errs)
        clock.lap("12 (c)")
        walk["launches"] += _phase_refit(tmp, dev)
        clock.lap("12 (d)")
        binned = _phase_binned(
            tmp, dev, card, lv5, big_rtc, walk_sweeps,
            _phase_binned_checks(dev, cornell, lv2, lv5, cam64, walk_sweeps))
        clock.lap("13")
        options = _phase_options(tmp, dev, card)
        clock.lap("14")
        _phase_shard(tmp, dev, card, cornell, rtc_path, big_rtc, cam64)
        clock.lap("15")
        slice17 = _phase_slice17(tmp, dev, card, rtc_path, big_rtc, wrtc64)
        clock.lap("16")

    kernels = [
        {"name": "fused_path", "route": "cuda",
         "source": "orion_tpu_torch/csrc/fused_path.cu",
         "replaces": "orion_tpu/ops/pallas_fused.py:959",
         "phase16_launches": slice17["1"],
         "launches": fused_launches, "max_abs_err": fused_err,
         "ms": f_ms, "plain_ms": f_plain_ms, "bound_ms": f_bound,
         "bound_by": f_by, "library_ms": None},
        {"name": "brute_intersect", "route": "cuda",
         "source": "orion_tpu_torch/csrc/brute_intersect.cu",
         "replaces": "orion_tpu/ops/pallas_intersect.py:87",
         "phase16_launches": slice17["2"],
         "launches": brute_launches, "max_abs_err": brute_err,
         "ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound,
         "bound_by": b_by, "library_ms": None, "hd_ms": hd_ms,
         "hd_bound_ms": hd_bound, "fold_ms": options["fold_ms"],
         "fold_bound_ms": options["fold_bound_ms"]},
        {"name": "prb_fwd_ls", "route": "cuda",
         "source": "orion_tpu_torch/csrc/prb.cu",
         "replaces": "orion_tpu/ops/pallas_prb.py:90", **train["fwd"]},
        {"name": "prb_replay", "route": "cuda",
         "source": "orion_tpu_torch/csrc/prb.cu",
         "replaces": "orion_tpu/ops/pallas_prb.py:282", **train["replay"]},
        {"name": "whitted", "route": "cuda",
         "source": "orion_tpu_torch/csrc/whitted.cu",
         "replaces": "orion_tpu/ops/pallas_whitted.py:101",
         "phase16_launches": slice17["4"], **whit},
        {"name": "bvh_intersect", "route": "cuda",
         "source": "orion_tpu_torch/csrc/bvh_intersect.cu",
         "replaces": "orion_tpu/ops/pallas_bvh.py:62",
         "phase16_launches": slice17["5"] + slice17["5 any-hit"], **walk},
        {"name": "bvh_path", "route": "cuda",
         "source": "orion_tpu_torch/csrc/bvh_path.cu",
         "replaces": "orion_tpu/ops/pallas_bvh_path.py:569",
         "phase16_launches": slice17["8"], **big},
        {"name": "bounce_walk", "route": "cuda",
         "source": "orion_tpu_torch/csrc/bounce.cu",
         "replaces": "orion_tpu/ops/pallas_bounce.py:223", **bounce["walk"]},
        {"name": "bounce_vis", "route": "cuda",
         "source": "orion_tpu_torch/csrc/bounce.cu",
         "replaces": "orion_tpu/ops/pallas_bounce.py:285", **bounce["vis"]},
        {"name": "bounce_shade", "route": "cuda",
         "source": "orion_tpu_torch/csrc/bounce.cu",
         "replaces": "orion_tpu/ops/pallas_bounce.py:359", **bounce["shade"]},
        {"name": "bvh_whitted", "route": "cuda",
         "source": "orion_tpu_torch/csrc/bvh_whitted.cu",
         "replaces": "orion_tpu/ops/pallas_bvh_whitted.py:384",
         "phase16_launches": slice17["7a"], **big_whitted["7a"]},
        {"name": "bvh_whitted_deferred", "route": "cuda",
         "source": "orion_tpu_torch/csrc/bvh_whitted.cu",
         "replaces": "orion_tpu/ops/pallas_bvh_whitted.py:689",
         "phase16_launches": slice17["7b"], **big_whitted["7b"]},
        {"name": "bvh_prb_fwd_ls", "route": "cuda",
         "source": "orion_tpu_torch/csrc/prb.cu",
         "replaces": "orion_tpu/ops/pallas_bvh_prb.py:113", **bvh_train["9a"]},
        {"name": "bvh_prb_replay", "route": "cuda",
         "source": "orion_tpu_torch/csrc/prb.cu",
         "replaces": "orion_tpu/ops/pallas_bvh_prb.py:151", **bvh_train["9b"]},
        {"name": "binned_round", "route": "cuda",
         "source": "orion_tpu_torch/csrc/binned.cu",
         "replaces": "orion_tpu/ops/pallas_binned.py:124", **binned["10"]},
        {"name": "bvh_g8", "route": "cuda",
         "source": "orion_tpu_torch/csrc/bvh_g8.cu",
         "replaces": "orion_tpu/ops/pallas_bvh_g8.py:63", **binned["11"]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _resized(rtc, cfg):
    rtc.xres, rtc.yres = cfg["xres"], cfg["yres"]
    return rtc


def _cotangent(img, samples: int, seed: int):
    """A per-lane adjoint [n, 3] shaped like an MSE cotangent against a
    jittered copy of `img` (mostly positive, so gradient entries do not
    cancel), divided by `samples` as the lanes sum their samples."""
    import torch

    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(-0.5, 1.0, img.shape), dtype=torch.float32,
                        device=img.device)
    return (img * u / (img.shape[0] * 3 * samples)).contiguous()


def _phase_train(tmp: Path, dev, card: str, fwd_err: float,
                 replay_err: float) -> dict:
    """Phase 7: the PRB training path at full width. Returns the kernel
    records of the two PRB kernels."""
    import dataclasses

    import torch

    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.ops import fused_path as fp
    from orion_tpu_torch.ops import prb
    from orion_tpu_torch.optim import fit

    W, H = TRAIN["xres"], TRAIN["yres"]
    S, D, LS = TRAIN["samples"], TRAIN["depth"], TRAIN["light_samples"]
    seed = 3
    ps = prepare(write_cornell(tmp / "train", xres=W, yres=H, depth=D),
                 device=dev)
    target = fp.make_fused_path_renderer(ps.scene, ps.camera, samples=S,
                                         max_depth=D, light_samples=LS)(seed)
    kd_true = ps.scene.mat_diffuse.clone()
    red = int(torch.argmax(kd_true[:, 0] - kd_true[:, 1]))
    kd_pert = kd_true.clone()
    kd_pert[red] *= 0.6
    pert = dataclasses.replace(ps.scene, mat_diffuse=kd_pert)
    params = {"mat_diffuse": kd_pert, "mat_emissive": pert.mat_emissive}
    M = pert.num_meshes

    # (a) one step through the autograd.Function
    step = prb.make_fused_train_step(pert, ps.camera, target, samples=S,
                                     max_depth=D, light_samples=LS,
                                     dynamic_params=True)
    prb.FWD_KERNEL.launches = prb.REPLAY_KERNEL.launches = 0
    loss_k, g_k = step(params, seed)
    torch.cuda.synchronize()
    launches = (prb.FWD_KERNEL.launches, prb.REPLAY_KERNEL.launches)
    print(f"[7] train step {TRAIN}: loss {float(loss_k):.6g}, launches "
          f"(fwd, replay) {launches}")
    check(launches == (1, 1), f"train step launches {launches}")

    args = fp.fused_args(pert, ps.camera)
    cfg = (W, H, S, D, LS)
    f_stats, r_stats = {}, {}
    f_plain_ms, (img_p, ls_p) = once_ms(
        lambda: fp.fused_fwd_ls_plain(*args, seed, *cfg, stats=f_stats))
    diff = img_p.reshape(H, W, 3) - target
    loss_p = float(torch.mean(diff * diff))
    w = (diff * (2.0 / (H * W * 3 * S))).reshape(-1, 3).contiguous()
    r_plain_ms, g_p = once_ms(
        lambda: prb.prb_replay_plain(*args, seed, w, ls_p, *cfg,
                                     stats=r_stats))
    loss_rel = abs(float(loss_k) - loss_p) / loss_p
    print(f"[7] loss kernel {float(loss_k):.7g} vs plain {loss_p:.7g} (rel "
          f"{loss_rel:.3g})")
    check(loss_rel <= 1e-3, f"train loss rel {loss_rel}")
    replay_err = max(replay_err,
                     grad_agree("train mat_diffuse 1080p", g_k["mat_diffuse"],
                                g_p[0:3, :M].t()),
                     grad_agree("train mat_emissive 1080p",
                                g_k["mat_emissive"], g_p[3:6, :M].t()))

    # (b) times at these shapes
    f_ms, f_times, (img_k, ls_k) = event_ms(
        lambda: prb.fused_fwd_ls(*args, seed, *cfg), 3)
    fwd_err = max(fwd_err, fused_agree("prb fwd 1080p", img_k, img_p),
                  fused_agree("prb fwd L_s 1080p", ls_k, ls_p))
    r_ms, r_times, _ = event_ms(
        lambda: prb.prb_replay(*args, seed, w, ls_k, *cfg), 3)
    s_ms, s_times, _ = event_ms(lambda: step(params, seed), 3)
    rays = W * H * S
    tab_bytes, ls_bytes = args[0].numel() * 4, W * H * 12 * S
    f_bound, f_by = bound_ms(f_stats["tests"] * WOOP_TEST_FLOPS,
                             tab_bytes + W * H * 12 + ls_bytes)
    r_bound, r_by = bound_ms(r_stats["tests"] * WOOP_TEST_FLOPS,
                             tab_bytes + W * H * 12 + ls_bytes
                             + 6 * prb.M_LANES * 4)
    print(f"[7] prb fwd: {f_ms:.3f} ms kernel (runs "
          f"{', '.join(f'{x:.3f}' for x in f_times)}), {f_plain_ms:.1f} ms "
          f"plain, {f_stats['tests']:.6g} Woop tests, bound {f_bound:.4f} ms "
          f"({f_by})")
    print(f"[7] prb replay: {r_ms:.3f} ms kernel (runs "
          f"{', '.join(f'{x:.3f}' for x in r_times)}), {r_plain_ms:.1f} ms "
          f"plain, {r_stats['tests']:.6g} Woop tests, bound {r_bound:.4f} ms "
          f"({r_by})")
    print(f"[7] train step (fwd + replay + loss + table): {s_ms:.3f} ms "
          f"(runs {', '.join(f'{x:.3f}' for x in s_times)}) = "
          f"{rays / (s_ms * 1e-3):.4g} fwd+bwd primary rays/s on {card}")

    # (c) the user's entry point: optim.fit on the PRB route
    ps_pert = dataclasses.replace(ps, scene=pert)
    prb.FWD_KERNEL.launches = prb.REPLAY_KERNEL.launches = 0
    stamps = [time.perf_counter()]      # the callback syncs via float(loss)
    res = fit(ps_pert, target, params=("mat_diffuse",), steps=10,
              learning_rate=0.05, samples=S, max_depth=D, light_samples=LS,
              seed=seed, resample_keys=False, use_prb=True,
              callback=lambda i, loss: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    secs = time.perf_counter() - stamps[0]
    per_step = np.diff(stamps[1:]) * 1e3
    launches = (prb.FWD_KERNEL.launches, prb.REPLAY_KERNEL.launches)
    # the red wall's albedo error (sum over its three channels)
    err0 = float((kd_pert[red] - kd_true[red]).abs().sum())
    err1 = float((res.params["mat_diffuse"][red] - kd_true[red]).abs().sum())
    print(f"[7] fit wall time: first step {(stamps[1] - stamps[0]) * 1e3:.1f}"
          f" ms (set-up included), later steps median "
          f"{float(np.median(per_step)):.3f} ms (min {per_step.min():.3f}, "
          f"max {per_step.max():.3f})")
    print(f"[7] fit 10 steps in {secs:.3f} s: losses "
          f"{', '.join(f'{x:.6g}' for x in res.losses)}; red wall albedo "
          f"error {err0:.5f} -> {err1:.5f}; launches (fwd, replay) "
          f"{launches}")
    check(min(launches) > 0, "fit never launched the PRB kernels")
    check(res.losses[-1] < res.losses[0], "fit loss did not fall")
    check(err1 < err0, "fit: the red wall's albedo error did not fall")
    return {
        "fwd": {"launches": launches[0], "max_abs_err": fwd_err, "ms": f_ms,
                "plain_ms": f_plain_ms, "bound_ms": f_bound, "bound_by": f_by,
                "library_ms": None},
        "replay": {"launches": launches[1], "max_abs_err": replay_err,
                   "ms": r_ms, "plain_ms": r_plain_ms, "bound_ms": r_bound,
                   "bound_by": r_by, "library_ms": None},
    }


def _phase_whitted(tmp: Path, dev, whitted_err: float) -> dict:
    """Phase 8: the Whitted render route and the Whitted trainer. Returns
    the Whitted kernel's record."""
    import dataclasses

    import torch

    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import brute_intersect as bi
    from orion_tpu_torch.ops import cuda_build
    from orion_tpu_torch.ops import whitted as wh
    from orion_tpu_torch.optim import fit
    from orion_tpu_torch.render import render
    from orion_tpu_torch.scene import load_scene

    W, H, S, D = (WHITTED["xres"], WHITTED["yres"], WHITTED["samples"],
                  WHITTED["depth"])
    rtc = write_cornell_whitted(tmp / "whitted", xres=W, yres=H, depth=D)
    wh.KERNEL.launches = 0
    img = run_cli(rtc, tmp / "whitted.hdr", WHITTED)
    launches = wh.KERNEL.launches
    print(f"[8] Whitted {WHITTED} through the CLI: Whitted kernel launches "
          f"{launches}, image mean {img.mean():.6g}")
    check(launches > 0, "the CLI never launched the Whitted kernel")
    check(img.shape == (H, W, 3) and np.isfinite(img).all()
          and img.mean() > 0, "Whitted image")

    scene, r = load_scene(rtc, device=dev)
    args = wh.whitted_args(scene, camera_from_rtc(r, device=dev))
    cfg = (W, H, S, D, scene.num_emissive > 0)
    info = (ctypes.c_int * 4)()
    rc = ctypes.CDLL(str(cuda_build.lib_path("whitted"))).whitted_info(
        args[0].shape[0], info)
    check(rc == 0, f"whitted_info failed: CUDA error {rc}")
    print(f"[8] Whitted kernel as built: {info[1]} registers, {info[2]} B "
          f"of local memory (spills) a thread, {info[0]} resident blocks "
          f"of 128 threads an SM ({args[0].shape[0]} table rows staged)")
    ms, times, k = event_ms(lambda: wh.fused_whitted(*args, 0, *cfg), 7)
    stats = {}
    plain_ms, p = once_ms(
        lambda: wh.fused_whitted_plain(*args, 0, *cfg, stats=stats))
    whitted_err = max(whitted_err, fused_agree("whitted 1080p", k, p))
    bound, by = bound_ms(stats["tests"] * WOOP_TEST_FLOPS,
                         args[0].numel() * 4 + W * H * 12)
    digest = hashlib.sha256(k.cpu().numpy().tobytes()).hexdigest()[:16]
    print(f"[8] whitted: {ms:.3f} ms kernel (median of 7; runs "
          f"{', '.join(f'{x:.3f}' for x in times)}), {plain_ms:.1f} ms plain, "
          f"{stats['tests']:.6g} Woop tests, bound {bound:.4f} ms ({by}); "
          f"image digest {digest}")

    # statistically against the wavefront (tests/test_whitted_fused.py)
    cam = camera_from_rtc(_resized(parse_rtc(rtc), dict(xres=256, yres=256)),
                          device=dev)

    def wavefront(seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return render(scene, cam, gen, samples=16, max_depth=2,
                      mode="whitted").cpu().numpy()

    img_f = wh.make_fused_whitted_renderer(scene, cam, samples=16,
                                           max_depth=2)(5).cpu().numpy()
    img_w, img_w2 = wavefront(5), wavefront(77)
    err_fw = float(np.abs(img_f - img_w).mean())
    err_ww = float(np.abs(img_w2 - img_w).mean())
    mrel = abs(img_f.mean() - img_w.mean()) / img_w.mean()
    print(f"[8] Whitted kernel vs wavefront 256^2 16 spp: means "
          f"{img_f.mean():.6g} vs {img_w.mean():.6g} (rel {mrel:.3g}), "
          f"mean |diff| {err_fw:.5g} vs seed-to-seed {err_ww:.5g}")
    check(mrel < 0.025, f"Whitted mean rel {mrel}")
    check(err_fw < 3.0 * err_ww + 1e-4, f"Whitted err {err_fw} vs {err_ww}")

    # the closed-form Whitted trainer through fit, on the brute kernel
    ps = prepare(rtc, device=dev, xres=128, yres=128)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    target = render(ps.scene, ps.camera, gen, samples=2, max_depth=2,
                    mode="whitted")
    kd = torch.clamp(ps.scene.mat_diffuse * 0.5 + 0.2, 0.05, 0.95)
    ps_p = dataclasses.replace(ps, scene=dataclasses.replace(
        ps.scene, mat_diffuse=kd))
    bi.KERNEL.launches = 0
    res = fit(ps_p, target, params=("mat_diffuse", "mat_specular"), steps=5,
              learning_rate=0.02, samples=2, max_depth=2, light_samples=1,
              mode="whitted", seed=0, resample_keys=False)
    print(f"[8] Whitted fit 5 steps at 128x128: losses "
          f"{', '.join(f'{x:.6g}' for x in res.losses)}; brute launches "
          f"{bi.KERNEL.launches}")
    check(bi.KERNEL.launches > 0, "Whitted fit never launched the brute kernel")
    # each step lowers the loss (an overshoot or a gradient of the wrong
    # sign would raise it)
    check(all(b < a for a, b in zip(res.losses, res.losses[1:])),
          "Whitted fit loss did not fall at every step")
    return {"launches": launches, "max_abs_err": whitted_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def _phase_bvh_checks(dev, rtc_path: Path, lv2, lv4, lv5, cam64):
    """Phase 3, the two BVH kernels against their plain versions. Returns
    (walk max |t| error, path max abs error, the recorded sweeps)."""
    import torch

    from orion_tpu_torch.accel.bvh import build_scene_bvh
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import GPU_LEAF_SIZE
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import brute_intersect as bi
    from orion_tpu_torch.ops import bvh_intersect as bx
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.ops import fused_path as fp

    # one wavefront sample's sweeps on the big scene (primary, bounce and
    # stacked NEE shadow rays); levels-4 is the same box, so its trees are
    # held on the same rays
    cam_w = camera_from_rtc(_resized(parse_rtc(rtc_path), SECOND), device=dev)
    bvh5, _ = build_scene_bvh(lv5, leaf_size=GPU_LEAF_SIZE)
    sweeps = record_sweeps(lv5, cam_w, bx.make_bvh_intersect_kernel(bvh5, lv5),
                           SECOND)
    rays = [("random", *random_rays(1 << 18, 1, dev))]
    rays += [(f"wavefront sweep {i}", *c) for i, c in enumerate(sweeps)]
    walk_err = 0.0
    for sname, sc in (("levels-4", lv4), (f"levels-{BIG_LEVELS}", lv5)):
        for leaf in (128, GPU_LEAF_SIZE):
            bvh, st = build_scene_bvh(sc, leaf_size=leaf)
            nodes, tri = bx._bvh_device_layout(bvh, dev)
            print(f"[3] {sname} leaf {leaf}: {st.nodes} nodes, "
                  f"{st.padded_tris} bundled rows")
            for rname, o, d, alive in rays:
                for any_hit in (False, True):
                    k = bx.bvh_walk(nodes, tri, o, d, alive, leaf_width=leaf,
                                    any_hit=any_hit)
                    torch.cuda.synchronize()
                    p = bx.bvh_walk_plain(nodes, tri, o, d, alive,
                                          leaf_width=leaf, any_hit=any_hit)
                    name = f"{sname} leaf {leaf} {rname}"
                    if any_hit:
                        mask_agree(name, k, p)
                    else:
                        walk_err = max(walk_err,
                                       brute_agree(f"walk {name}", k, p))

    # two independent answers: the walk kernel (float64 host Woop rows,
    # bundled order) against the brute kernel (float32 device rows, scene
    # order). Where two coplanar faces tie (box bottoms on the floor,
    # shared edges) either id is the nearest hit, so the rays are held by
    # t (>= 99.9% within rel 1e-5) and the ids to >= 99%.
    bvh4, _ = build_scene_bvh(lv4, leaf_size=GPU_LEAF_SIZE)
    walk4 = bx.make_bvh_intersect_kernel(bvh4, lv4)
    for rname, o, d, alive in rays[:3]:
        h_w = walk4(lv4, o, d, alive=alive)
        h_b = bi.intersect_brute_kernel(lv4, o, d, alive=alive)
        same = float((h_w.tri_id == h_b.tri_id).float().mean())
        both = h_w.mask & h_b.mask
        dt = (h_w.t - h_b.t).abs()
        # the same nearest hit: both miss, or both hit at the same t (the
        # two tables round differently: rel 1e-5 + 1e-6)
        agree = (~h_w.mask & ~h_b.mask) | (
            both & (dt <= 1e-5 * h_b.t.abs() + 1e-6))
        frac = float(agree.float().mean())
        print(f"[walk vs brute levels-4 {rname}] ids equal {same:.6f}, "
              f"same t (rel 1e-5) {frac:.6f}, largest rel t difference "
              f"{float((dt / h_b.t.abs())[both].max()):.3g}")
        check(frac >= 0.999, f"walk vs brute {rname}: same t on {frac}")
        check(same >= 0.99, f"walk vs brute {rname}: ids equal on {same}")

    path_err = 0.0
    cfg = (64, 64, 4, 4, 2)
    for sname, sc in (("levels-2", lv2), (f"levels-{BIG_LEVELS}", lv5)):
        fn = bp.make_bvh_path_renderer(sc, cam64, samples=4, max_depth=4,
                                       light_samples=2)
        k = fn(1234).reshape(-1, 3)
        torch.cuda.synchronize()
        dd = fn.data
        p = bp.bvh_path_plain(dd["nodes"], dd["tab"], dd["em"], dd["cam"],
                              1234, *cfg, leaf_width=dd["leaf_width"])
        path_err = max(path_err, fused_agree(f"bvh path {sname} 64x64", k, p))
        if sc is lv2:
            # the same estimator over the brute sweep
            ref, _ = fp.fused_fwd_ls_plain(*fp.fused_args(sc, cam64), 1234,
                                           *cfg)
            fused_agree("bvh path vs brute forward levels-2 64x64", k, ref)
    return walk_err, path_err, sweeps


def _phase_bounce_checks(scenes, cam64) -> list:
    """Phase 3, the three bounce kernels against their plain versions on
    the recorded state of every bounce of one 64x64, 4 spp, depth 4 render,
    at leaf width 2 (one tree copy) and 128 (eight octant copies), with
    and without the replay dump; the kernels' pipeline against the plain
    pipeline; a split_vis render against the fused one. Returns the
    largest errors (walk, vis, shade)."""
    import torch

    from orion_tpu_torch.ops import bounce as bo

    errs = [0.0, 0.0, 0.0]
    cfg = dict(samples=4, max_depth=4, light_samples=2)
    for sname, sc in scenes:
        for leaf in (2, 128):
            tree = dict(leaf_width=leaf, octant_trees=leaf == 128)
            fn = bo.make_bounce_path_renderer(sc, cam64, **cfg, **tree)
            for with_aux in (False, True):
                res = bounce_kernels_agree(
                    f"{sname} leaf {leaf}{' aux' if with_aux else ''}", fn,
                    1234, with_aux=with_aux)
                check(sorted(res) == list(range(5)) or len(res) >= 3,
                      f"bounce {sname}: bounces recorded {sorted(res)}")
                for r in res.values():
                    errs = [max(e, x) for e, x in zip(errs, r["errs"])]
            img = fn(1234)
            plain = bo.make_bounce_path_renderer(
                sc, cam64, steps=bo.PLAIN_STEPS, **cfg, **tree)(1234)
            fused_agree(f"bounce pipeline {sname} leaf {leaf} 64x64",
                        img.reshape(-1, 3), plain.reshape(-1, 3))
            split = bo.make_bounce_path_renderer(sc, cam64, split_vis=True,
                                                 **cfg, **tree)(1234)
            torch.cuda.synchronize()
            d = float((split - img).abs().max())
            print(f"[bounce split_vis {sname} leaf {leaf}] max abs "
                  f"difference from the fused render {d:.3g}")
            check(bool(torch.allclose(split, img, rtol=1e-6, atol=1e-7)),
                  f"split_vis render differs by {d}")
    return errs


def _stage_ms(timings) -> dict:
    """{(stage, depth): (lanes, ms)} of a pipeline's timing records."""
    return {(name, depth): (n, a.elapsed_time(b))
            for name, depth, n, a, b in timings}


def _phase_bounce(tmp: Path, dev, card: str, lv5, errs3: list) -> dict:
    """Phase 11: the bounce pipeline at full width: render, textured
    render, train step and fit. Returns the three kernels' records."""
    import dataclasses

    import torch

    from orion_tpu_torch import engine
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import bounce as bo
    from orion_tpu_torch.ops import bounce_prb as bpr
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.ops import cuda_build
    from orion_tpu_torch.optim import fit

    W, H, S, D, LS = (MAIN["xres"], MAIN["yres"], MAIN["samples"],
                      MAIN["depth"], MAIN["light_samples"])
    kernels = (bo.WALK_KERNEL, bo.VIS_KERNEL, bo.SHADE_KERNEL)

    def reset():
        for k in kernels:
            k.launches = 0

    def counts():
        return tuple(k.launches for k in kernels)

    # (a) the render ---------------------------------------------------------
    rtc = write_cornell(tmp / "bounce_main", xres=W, yres=H, depth=D,
                        levels=BIG_LEVELS)
    cam = camera_from_rtc(_resized(parse_rtc(rtc), MAIN), device=dev)
    cfg = dict(samples=S, max_depth=D, light_samples=LS)
    t0 = time.perf_counter()
    fn_b, name = engine.make_big_path_renderer(lv5, cam, order=("bounce",),
                                               **cfg)
    torch.cuda.synchronize()
    print(f"[11] bounce pipeline set-up (tree, table): "
          f"{time.perf_counter() - t0:.3f} s, backend {name}")
    check(name == "bounce-kernel", f"bounce backend {name}")
    fn_b(1)          # warm-up: the first sort allocates its scratch
    reset()
    timings = []
    img_b = fn_b(0, timings=timings)
    torch.cuda.synchronize()
    main_counts = counts()
    stage = _stage_ms(timings)
    lanes = [stage[("walk", d)][0] for d in range(D + 1)
             if ("walk", d) in stage]
    per = {k: sum(ms for (nm, _), (_, ms) in stage.items() if nm == k)
           for k in ("walk", "shade", "sort")}
    print(f"[11] bounce render {MAIN} on {lv5.num_triangles} triangles: "
          f"launches (walk, vis, shade) {main_counts}; lanes per bounce "
          f"{lanes}")
    for d in range(len(lanes)):
        print(f"[11]   depth {d}: {lanes[d]} lanes, walk "
              f"{stage[('walk', d)][1]:.3f} ms, shade "
              f"{stage[('shade', d)][1]:.3f} ms"
              + (f", sort + permute + count {stage[('sort', d)][1]:.3f} ms "
                 f"over {stage[('sort', d)][0]} lanes" if d else ""))
    print(f"[11]   sums: walk {per['walk']:.3f}, shade {per['shade']:.3f}, "
          f"sort {per['sort']:.3f} ms; primary wavefront "
          f"{stage[('primaries', 0)][1]:.3f} ms, image from the state "
          f"{stage[('image', 0)][1]:.3f} ms")
    check(main_counts[0] == len(lanes) and main_counts[2] == len(lanes)
          and main_counts[1] == 0 and len(lanes) >= 2,
          f"bounce render launches {main_counts}")
    check(img_b.shape == (H, W, 3) and torch_isfinite(img_b), "bounce image")

    # the same render with the standalone visibility kernel
    fn_s = bo.make_bounce_path_renderer(lv5, cam, split_vis=True, **cfg)
    reset()
    t_split = []
    img_s = fn_s(0, timings=t_split)
    torch.cuda.synchronize()
    split_counts = counts()
    st_split = _stage_ms(t_split)
    d_split = float((img_s - img_b).abs().max())
    print(f"[11] split_vis render: launches (walk, vis, shade) "
          f"{split_counts}; depth 0 vis {st_split[('vis', 0)][1]:.3f} ms, "
          f"shade given vis {st_split[('shade', 0)][1]:.3f} ms; sums vis "
          f"{sum(ms for (nm, _), (_, ms) in st_split.items() if nm == 'vis'):.3f}"
          f", shade "
          f"{sum(ms for (nm, _), (_, ms) in st_split.items() if nm == 'shade'):.3f}"
          f" ms; max abs difference from the fused render {d_split:.3g}")
    info = (ctypes.c_int * 4)()
    rc = ctypes.CDLL(str(cuda_build.lib_path("bounce"))).bounce_info(5, info)
    check(rc == 0, f"bounce_info failed: CUDA error {rc}")
    vis_sum = sum(ms for (nm, _), (_, ms) in st_split.items() if nm == "vis")
    given = sum(ms for (nm, _), (_, ms) in st_split.items() if nm == "shade")
    print(f"[11] vis kernel (6b) as built: {info[1]} registers, {info[2]} B "
          f"of local memory a thread, {info[0]} resident blocks of 128 "
          f"threads an SM; {vis_sum:.3f} ms a render, "
          f"{st_split[('vis', 0)][1]:.3f} at depth 0; vis + shade given vis "
          f"{vis_sum + given:.3f} ms against the fused shade "
          f"{per['shade']:.3f} a render, at depth 0 "
          f"{st_split[('vis', 0)][1] + st_split[('shade', 0)][1]:.3f} "
          f"against {stage[('shade', 0)][1]:.3f}")
    check(split_counts[1] == split_counts[0] > 0, "split_vis never launched "
          "the vis kernel")
    check(bool(torch.allclose(img_s, img_b, rtol=1e-6, atol=1e-7)),
          f"split_vis render differs by {d_split}")
    del img_s, fn_s

    # against kernel 8 on the same seed, and both candidates' times in
    # turns (bounce, walk, walk, bounce); kernel 8's tree flattened for
    # the camera's octant, as the CLI's `prepare` orders it, so that the
    # default route below renders this image bit for bit
    fn_w, name_w = engine.make_big_path_renderer(
        lv5, cam, order=("walk",), order_signs=engine.octant_signs(cam.front),
        **cfg)
    check(name_w == "bvh-path-kernel", f"walk backend {name_w}")
    b1, b1_times, _ = event_ms(lambda: fn_b(0), 2)
    w_ms, w_times, img_w = event_ms(lambda: fn_w(0), 4)
    b2, b2_times, _ = event_ms(lambda: fn_b(0), 2)
    b_times = b1_times + b2_times
    b_ms = float(np.median(b_times))
    rays = W * H * S
    print(f"[11] candidates on {card}, {rays} primary rays: bounce pipeline "
          f"{b_ms:.3f} ms (runs {', '.join(f'{x:.3f}' for x in b_times)}) = "
          f"{rays / (b_ms * 1e-3):.4g} primary rays/s; BVH path kernel "
          f"{w_ms:.3f} ms (runs {', '.join(f'{x:.3f}' for x in w_times)}) = "
          f"{rays / (w_ms * 1e-3):.4g} primary rays/s; BIG_PATH_ORDER "
          f"{engine.BIG_PATH_ORDER}")
    fused_agree("bounce vs bvh path 1080p", img_b.reshape(-1, 3),
                img_w.reshape(-1, 3))
    # and at a small image, where the pipeline's launches and host syncs
    # weigh more: the BVH wavefront's 256x256, 16 spp, depth 4
    cam_q = camera_from_rtc(_resized(parse_rtc(rtc), SECOND), device=dev)
    cfg_q = dict(samples=SECOND["samples"], max_depth=SECOND["depth"],
                 light_samples=SECOND["light_samples"])
    q_ms = {}
    for cand in ("bounce", "walk"):
        fn_q, _ = engine.make_big_path_renderer(lv5, cam_q, order=(cand,),
                                                **cfg_q)
        q_ms[cand], _, _ = event_ms(lambda: fn_q(0), 5)
    print(f"[11] candidates at {SECOND}: bounce pipeline "
          f"{q_ms['bounce']:.3f} ms, BVH path kernel {q_ms['walk']:.3f} ms")
    # the CLI's default route past the fused gate takes the first candidate
    # of engine.BIG_PATH_ORDER: the same seed gives the renderer's image,
    # once that has been through an .hdr file too
    first = engine.BIG_PATH_ORDER[0]
    bp.KERNEL.launches = 0
    reset()
    img_c, report = run_cli(rtc, tmp / "big_cli.hdr", MAIN, report=True)
    cli_counts = {"bounce": counts(), "walk": (bp.KERNEL.launches,)}[first]
    print(f"[11] the default route through the CLI: backend "
          f"{report['backend']}, {report['triangles']} triangles, render "
          f"{report['render_seconds']} s, launches {cli_counts}")
    check(report["backend"] == BIG_BACKENDS[first],
          f"CLI backend {report['backend']}, first candidate {first!r}")
    check(report["triangles"] == 34 * 4 ** BIG_LEVELS + 2, "CLI scene size")
    check(cli_counts[0] > 0 and cli_counts[-1] > 0,
          f"the CLI's default route never launched its kernels {cli_counts}")
    from orion_tpu_torch.io.image import load_hdr, save_image

    save_image(str(tmp / "big_direct.hdr"),
               (img_b if first == "bounce" else img_w).cpu().numpy())
    check(np.array_equal(img_c, load_hdr(tmp / "big_direct.hdr")),
          "the CLI's image differs from the renderer's")
    del img_w, fn_w

    # each kernel against its plain version on the recorded state of
    # depth 0 and two later bounces
    later = sorted({min(2, len(lanes) - 1), min(5, len(lanes) - 1)})
    res = bounce_kernels_agree("1080p", fn_b, 0, depths=[0] + later,
                               chunk=1 << 23)
    errs = [max([e] + [r["errs"][i] for r in res.values()])
            for i, e in enumerate(errs3)]
    r0 = res[0]
    N = r0["n"]
    data = fn_b.ctx["data"]
    tree_bytes = (data.nodes.numel() + data.tab.numel()) * 4
    flops = [st.get("box_tests", 0) * SLAB_TEST_FLOPS
             + st.get("tests", 0) * WOOP_TEST_FLOPS for st in r0["stats"]]
    # bytes a launch must move: state rows read (walk 7; vis 9; shade 16)
    # and written (shade 14), hitdata (8 rows written, 5 read), the vis
    # planes (8 rows), and the tree and the table once (the winners' table
    # rows are part of that table)
    nbytes = [N * (7 + 8) * 4 + tree_bytes,
              N * (9 + 5 + 8) * 4 + tree_bytes,
              N * (16 + 14 + 5) * 4 + tree_bytes]
    bounds = [bound_ms(f, b) for f, b in zip(flops, nbytes)]
    k_ms = (stage[("walk", 0)][1], st_split[("vis", 0)][1],
            stage[("shade", 0)][1])
    for i, kname in enumerate(("walk", "vis", "shade")):
        st = r0["stats"][i]
        print(f"[11] bounce {kname} kernel, depth 0 ({N} lanes): "
              f"{k_ms[i]:.3f} ms kernel, {r0['plain_ms'][i]:.1f} ms plain; "
              f"{st.get('box_tests', 0):.6g} box tests and "
              f"{st.get('tests', 0):.6g} Woop tests, {nbytes[i]:.6g} bytes, "
              f"bound {bounds[i][0]:.4f} ms ({bounds[i][1]})")
    records = {
        kname: {"launches": (main_counts[0], split_counts[1],
                             main_counts[2])[i],
                "max_abs_err": errs[i], "ms": k_ms[i],
                "plain_ms": r0["plain_ms"][i], "bound_ms": bounds[i][0],
                "bound_by": bounds[i][1], "library_ms": None}
        for i, kname in enumerate(("walk", "vis", "shade"))}
    del res, r0

    # (b) the same box, textured, through the CLI -----------------------------
    rtc_t = write_cornell(tmp / "bounce_tex", xres=W, yres=H, depth=D,
                          levels=BIG_LEVELS, checker=True)
    reset()
    t0 = time.perf_counter()
    img_t, report = run_cli(rtc_t, tmp / "tex.hdr", MAIN, report=True)
    secs = time.perf_counter() - t0
    tex_counts = counts()
    diff = float(np.abs(img_t - img_b.cpu().numpy()).mean())
    print(f"[11] textured box {MAIN} through the CLI: {secs:.3f} s (scene "
          f"{report['scene_build_seconds']} s, render "
          f"{report['render_seconds']} s = "
          f"{rays / report['render_seconds']:.4g} primary rays/s), backend "
          f"{report['backend']}, launches (walk, vis, shade) {tex_counts}, "
          f"mean {img_t.mean():.6g} vs the solid box's "
          f"{float(img_b.mean()):.6g}, mean |difference| {diff:.4g}")
    check(report["backend"] == "bounce-kernel",
          f"textured backend {report['backend']}")
    check(report["triangles"] == 34 * 4 ** BIG_LEVELS + 2, "textured size")
    check(tex_counts[0] > 0 and tex_counts[2] > 0, "textured render never "
          "launched the bounce kernels")
    check(img_t.shape == (H, W, 3) and np.isfinite(img_t).all()
          and img_t.mean() > 0, "textured image")
    check(diff > 1e-3, "the textured image equals the solid one")
    del img_b
    ps_t = engine.prepare(rtc_t, device=dev, xres=256, yres=256)
    fn_t = bo.make_bounce_path_renderer(ps_t.scene, ps_t.camera, **cfg)
    k = fn_t(0)
    # the kernels given texel kd planes, on three bounces' recorded state
    bounce_kernels_agree("textured 256x256", fn_t, 0, depths=(0, 1, 4))
    p_ms, p = once_ms(lambda: bo.make_bounce_path_renderer(
        ps_t.scene, ps_t.camera, steps=bo.PLAIN_STEPS, **cfg)(0))
    mrel = abs(float(k.mean()) - float(p.mean())) / float(p.mean())
    print(f"[11] textured 256x256: plain pipeline {p_ms:.1f} ms, mean rel "
          f"{mrel:.3g}")
    check(mrel <= 0.025, f"textured mean rel {mrel}")
    fused_agree("textured bounce pipeline 256x256", k.reshape(-1, 3),
                p.reshape(-1, 3))

    # (c) the trainer ---------------------------------------------------------
    TW, TH, TS, TD, TLS = (TRAIN["xres"], TRAIN["yres"], TRAIN["samples"],
                           TRAIN["depth"], TRAIN["light_samples"])
    tcfg = dict(samples=TS, max_depth=TD, light_samples=TLS)
    seed = 3
    ps = engine.prepare(rtc, device=dev)
    kd_true = ps.scene.mat_diffuse.clone()
    red = int(torch.argmax(kd_true[:, 0] - kd_true[:, 1]))
    kd_pert = kd_true.clone()
    kd_pert[red] *= 0.6
    pert = dataclasses.replace(ps.scene, mat_diffuse=kd_pert)
    params = {"mat_diffuse": kd_pert}

    # gradients against the plain pipeline's, at 256x256
    cam_s = camera_from_rtc(_resized(parse_rtc(rtc), dict(xres=256,
                                                          yres=256)),
                            device=dev)
    target_s = bo.make_bounce_path_renderer(ps.scene, cam_s, **tcfg)(seed)
    loss_k, g_k = bpr.make_bounce_train_step(pert, cam_s, target_s,
                                             **tcfg)(seed)
    loss_p, g_p = bpr.make_bounce_train_step(
        pert, cam_s, target_s, steps=bo.PLAIN_STEPS, **tcfg)(seed)
    loss_rel = abs(float(loss_k) - float(loss_p)) / float(loss_p)
    print(f"[11] train 256x256: loss kernels {float(loss_k):.7g} vs plain "
          f"{float(loss_p):.7g} (rel {loss_rel:.3g})")
    check(loss_rel <= 1e-3, f"bounce train loss rel {loss_rel}")
    for pname in ("mat_diffuse", "mat_emissive"):
        grad_agree(f"bounce train {pname} 256x256", g_k[pname], g_p[pname])

    # one step at full width, timed
    target = bo.make_bounce_path_renderer(ps.scene, ps.camera,
                                          **tcfg)(seed)
    step = bpr.make_bounce_train_step(pert, ps.camera, target,
                                      dynamic_params=True, **tcfg)
    reset()
    timings = []
    loss, grads = step(params, seed, timings=timings)
    torch.cuda.synchronize()
    step_counts = counts()
    stage = _stage_ms(timings)
    t_lanes = [stage[("walk", d)][0] for d in range(TD + 1)
               if ("walk", d) in stage]
    print(f"[11] bounce train step {TRAIN} on {pert.num_triangles} "
          f"triangles: loss {float(loss):.6g}, launches (walk, vis, shade) "
          f"{step_counts}, lanes per bounce {t_lanes}; largest |d kd| "
          f"{float(grads['mat_diffuse'].abs().max()):.4g}")
    print(f"[11]   of that step: "
          + ", ".join(f"{k} {stage[(k, 0)][1]:.3f} ms"
                      for k in ("primaries", "cotangent", "adjoints")))
    check(step_counts[0] == len(t_lanes) == step_counts[2] > 1,
          f"train step launches {step_counts}")
    check(torch_isfinite(grads["mat_diffuse"])
          and float(grads["mat_diffuse"].abs().max()) > 0, "train gradients")
    pipe = step.ctx["pipeline"]
    tab = step.ctx["data"].tab
    f_ms, f_times, _ = event_ms(lambda: pipe(seed, tab), 3)
    s_ms, s_times, _ = event_ms(lambda: step(params, seed), 3)
    t_rays = TW * TH * TS
    print(f"[11] bounce train step: {s_ms:.3f} ms (runs "
          f"{', '.join(f'{x:.3f}' for x in s_times)}) = "
          f"{t_rays / (s_ms * 1e-3):.4g} fwd+bwd primary rays/s on {card}; "
          f"forward with dumps {f_ms:.3f} ms (runs "
          f"{', '.join(f'{x:.3f}' for x in f_times)}), so table, image, "
          f"realignment and backward {s_ms - f_ms:.3f} ms")

    # the user's entry point: fit past the fused gate
    ps_pert = dataclasses.replace(ps, scene=pert)
    reset()
    t0 = time.perf_counter()
    res = fit(ps_pert, target, params=("mat_diffuse",), steps=5,
              learning_rate=0.05, seed=seed, resample_keys=False, **tcfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    err0 = float((kd_pert[red] - kd_true[red]).abs().sum())
    err1 = float((res.params["mat_diffuse"][red] - kd_true[red]).abs().sum())
    print(f"[11] fit 5 steps in {secs:.3f} s: losses "
          f"{', '.join(f'{x:.6g}' for x in res.losses)}; red wall albedo "
          f"error {err0:.5f} -> {err1:.5f}; launches (walk, vis, shade) "
          f"{counts()}")
    check(counts()[0] > 0 and counts()[2] > 0, "fit never launched the "
          "bounce kernels")
    check(res.losses[-1] < res.losses[0], "bounce fit loss did not fall")
    check(err1 < err0, "bounce fit: the red wall's albedo error did not fall")
    return records


def _phase_big_path(tmp: Path, dev, card: str, lv5, cornell_mean: float,
                    path_err: float) -> dict:
    """Phase 9: the big path scene at full width on the BVH path kernel.
    Returns the kernel's record."""
    import torch

    from orion_tpu_torch import engine, native
    from orion_tpu_torch.accel.bvh import build_scene_bvh
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.io.image import load_hdr, save_image
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import bvh_path as bp

    W, H, S, D, LS = (MAIN["xres"], MAIN["yres"], MAIN["samples"],
                      MAIN["depth"], MAIN["light_samples"])
    rtc = write_cornell(tmp / "big_main", xres=W, yres=H, depth=D,
                        levels=BIG_LEVELS)
    # the "walk" candidate by name, whatever engine.BIG_PATH_ORDER puts
    # first on the CLI's default route past the fused gate
    bp.KERNEL.launches = 0
    t0 = time.perf_counter()
    ps = engine.prepare(rtc, device=dev)
    fn, backend = engine.make_big_path_renderer(
        ps.scene, ps.camera, samples=S, max_depth=D, light_samples=LS,
        order_signs=ps.order_signs, order=("walk",))
    t1 = time.perf_counter()
    # through an .hdr file, as the CLI writes it and as phase 4's image
    # came back (its 8-bit mantissas lower the mean by 1%)
    save_image(str(tmp / "big.hdr"), fn(0).cpu().numpy())
    img = load_hdr(tmp / "big.hdr")
    secs = time.perf_counter() - t0
    launches = bp.KERNEL.launches
    rays = W * H * S
    mrel = abs(float(img.mean()) - cornell_mean) / cornell_mean
    print(f"[9] big path {MAIN} on {ps.scene.num_triangles} triangles "
          f"through make_big_path_renderer(order=('walk',)): {secs:.3f} s "
          f"({rays / secs:.4g} primary rays/s incl. scene setup; scene "
          f"{ps.build_seconds:.3f} s, tree and table {t1 - t0 - ps.build_seconds:.3f}"
          f" s, render and .hdr {secs - (t1 - t0):.3f} s), backend {backend}, "
          f"BVH path launches {launches}, image mean {img.mean():.6g} vs "
          f"the 36-triangle box's {cornell_mean:.6g} (rel {mrel:.3g})")
    check(backend == "bvh-path-kernel", f"big path backend {backend}")
    check(ps.scene.num_triangles == 34 * 4 ** BIG_LEVELS + 2, "big path size")
    check(launches > 0, "big path never launched the BVH path kernel")
    check(img.shape == (H, W, 3) and np.isfinite(img).all(), "big image")
    check(mrel <= 0.02, f"big path mean rel {mrel}")

    for builder in ("native", "numpy"):
        if builder == "native" and not native.native_available():
            print("[9] native builder unavailable (no g++?): NumPy builds")
            continue
        t0 = time.perf_counter()
        _, st = build_scene_bvh(lv5, leaf_size=bp.GPU_LEAF_WIDTH,
                                builder=builder)
        print(f"[9] BVH build ({builder}, SAH, leaf {bp.GPU_LEAF_WIDTH}): "
              f"{time.perf_counter() - t0:.3f} s, {st.nodes} nodes, depth "
              f"{st.max_depth}, {st.padded_tris} bundled rows")

    cam = camera_from_rtc(_resized(parse_rtc(rtc), MAIN), device=dev)
    t0 = time.perf_counter()
    fn = bp.make_bvh_path_renderer(lv5, cam, samples=S, max_depth=D,
                                   light_samples=LS)
    torch.cuda.synchronize()
    print(f"[9] tree + table packing: {time.perf_counter() - t0:.3f} s")
    ms, times, k_img = event_ms(lambda: fn(0), 3)
    k_flat = k_img.reshape(-1, 3)

    # the plain version over the whole image (its counters give the
    # bound), and N_TILES tiles of TILE_LANES lanes spread evenly over the
    # image, each rendered by the kernel through pix_base, against the
    # whole image's and the plain version's pixels
    n_pix = W * H
    dd = fn.data
    stats = {}
    plain_ms, p = once_ms(lambda: bp.bvh_path_plain(
        dd["nodes"], dd["tab"], dd["em"], dd["cam"], 0, W, H, S, D, LS,
        leaf_width=dd["leaf_width"], stats=stats))
    path_err = max(path_err, fused_agree("bvh path 1080p", k_flat, p))
    bases = [int(i * (n_pix - TILE_LANES) / (N_TILES - 1))
             for i in range(N_TILES)]
    tile_ms, _, tiles = event_ms(lambda: torch.cat(
        [fn(0, pix_base=b, n_lanes=TILE_LANES) for b in bases]), 3)
    pix = torch.cat([torch.arange(b, b + TILE_LANES, device=dev)
                     for b in bases])
    check(torch.equal(tiles, k_flat[pix]),
          "a tile does not render the whole image's pixels")
    fused_agree(f"bvh path 1080p, {N_TILES} tiles x {TILE_LANES} lanes",
                tiles, p[pix])
    box, tri = stats["box_tests"], stats["tests"]
    bound, by = bound_ms(
        box * SLAB_TEST_FLOPS + tri * WOOP_TEST_FLOPS,
        (dd["nodes"].numel() + dd["tab"].numel()) * 4 + n_pix * 12)
    print(f"[9] bvh path: {ms:.3f} ms kernel (runs "
          f"{', '.join(f'{x:.3f}' for x in times)}) = "
          f"{rays / (ms * 1e-3):.4g} primary rays/s of device time on "
          f"{card}; {plain_ms:.1f} ms plain; {box:.6g} box tests and "
          f"{tri:.6g} Woop tests, bound {bound:.4f} ms ({by}); the "
          f"{N_TILES} tiles: {tile_ms:.3f} ms in {N_TILES} launches")
    return {"launches": launches, "max_abs_err": path_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def _phase_bvh_wavefront(tmp: Path, dev, sweeps, walk_err: float) -> dict:
    """Phase 10: the wavefront, the regenerative wavefront and the Whitted
    wavefront over the walk kernel. Returns the walk kernel's record."""
    import torch

    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import brute_intersect as bi
    from orion_tpu_torch.ops import bvh_intersect as bx
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.render import render

    def reset():
        bx.KERNEL.launches = bx.ANY_HIT_KERNEL.launches = 0
        bp.KERNEL.launches = bi.KERNEL.launches = 0

    rtc = write_cornell(tmp / "big_wave", xres=256, yres=256, depth=4,
                        levels=BIG_LEVELS)
    reset()
    t0 = time.perf_counter()
    img_w, rep = run_cli(rtc, tmp / "bvh.hdr", SECOND, backend="bvh",
                         report=True)
    secs = time.perf_counter() - t0
    n_wave = bx.KERNEL.launches
    print(f"[10] --backend bvh {SECOND}: {secs:.3f} s, backend "
          f"{rep['backend']}, {rep['bvh_nodes']} nodes, walk launches "
          f"{n_wave} (any-hit {bx.ANY_HIT_KERNEL.launches}), path-kernel "
          f"launches {bp.KERNEL.launches}")
    check(rep["backend"] == "bvh-kernel", f"backend {rep['backend']}")
    check(n_wave > 0 and bp.KERNEL.launches == 0 and bi.KERNEL.launches == 0,
          "--backend bvh did not run on the walk kernel alone")
    from orion_tpu_torch.engine import BIG_PATH_ORDER

    img_k, rep_k = run_cli(rtc, tmp / "bvh_k.hdr", SECOND, report=True)
    check(rep_k["backend"] == BIG_BACKENDS[BIG_PATH_ORDER[0]],
          f"default route backend {rep_k['backend']}")
    c = corr(img_k, img_w)
    mrel = abs(img_k.mean() - img_w.mean()) / img_w.mean()
    print(f"[10] default big-path route ({rep_k['backend']}) vs BVH "
          f"wavefront 256^2: corr {c:.4f}, mean "
          f"{img_k.mean():.6g} vs {img_w.mean():.6g} (rel {mrel:.3g})")
    check(np.isfinite(img_w).all(), "BVH wavefront image non-finite")
    check(c > 0.93 and mrel < 0.15, f"BVH wavefront corr {c} rel {mrel}")

    ps = prepare(rtc, device=dev, force_backend="bvh", xres=256, yres=256)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    with torch.no_grad():
        img_s = render(ps.scene, ps.camera, gen, samples=SECOND["samples"],
                       max_depth=SECOND["depth"],
                       light_samples=SECOND["light_samples"],
                       intersect=ps.intersect,
                       sort_bounces="morton").cpu().numpy()
    torch.cuda.synchronize()
    c = corr(img_k, img_s)
    mrel = abs(img_k.mean() - img_s.mean()) / img_s.mean()
    print(f"[10] sort_bounces=morton: {time.perf_counter() - t0:.3f} s, corr "
          f"{c:.4f}, mean {img_s.mean():.6g} (rel {mrel:.3g})")
    check(c > 0.93 and mrel < 0.15, f"sorted wavefront corr {c} rel {mrel}")

    before = bx.KERNEL.launches
    t0 = time.perf_counter()
    img_r, rep = run_cli(rtc, tmp / "regen.hdr", REGEN, extra=["--regen"],
                         report=True)
    secs = time.perf_counter() - t0
    n_regen = bx.KERNEL.launches - before
    img_w8 = run_cli(rtc, tmp / "bvh8.hdr", REGEN, backend="bvh")
    mrel = abs(img_r.mean() - img_w8.mean()) / img_w8.mean()
    print(f"[10] --regen {REGEN}: {secs:.3f} s, backend {rep['backend']}, "
          f"walk launches {n_regen}, mean {img_r.mean():.6g} vs the depth-8 "
          f"wavefront's {img_w8.mean():.6g} (rel {mrel:.3g})")
    check(n_regen > 0, "--regen never launched the walk kernel")
    check(np.isfinite(img_r).all() and mrel <= 0.025, f"regen mean {mrel}")

    wrtc = write_cornell_whitted(tmp / "big_whitted", xres=512, yres=512,
                                 depth=4, levels=BIG_LEVELS)
    reset()
    t0 = time.perf_counter()
    img_b, rep = run_cli(wrtc, tmp / "wb.hdr", BIG_WHITTED, backend="bvh",
                         report=True)
    secs = time.perf_counter() - t0
    n_near, n_any = bx.KERNEL.launches, bx.ANY_HIT_KERNEL.launches
    img_ref = run_cli(wrtc, tmp / "wr.hdr", BIG_WHITTED, backend="brute")
    mrel = abs(img_b.mean() - img_ref.mean()) / img_ref.mean()
    print(f"[10] Whitted --backend bvh {BIG_WHITTED} on "
          f"{rep['triangles']} triangles: {secs:.3f} s, nearest launches "
          f"{n_near}, any-hit launches {n_any}, mean {img_b.mean():.6g} vs "
          f"--backend brute {img_ref.mean():.6g} (rel {mrel:.3g}), max abs "
          f"diff {np.abs(img_b - img_ref).max():.4g}")
    check(n_near > 0 and n_any > 0, "Whitted --backend bvh: no any-hit launch")
    check(np.isfinite(img_b).all() and mrel <= 0.025, f"Whitted mean {mrel}")

    # the walk kernel's own time: CUDA graphs of the recorded sweeps of one
    # wavefront sample over the engine's tree (eager launches from Python
    # measure the host), the 256x256 sample's (a quarter of the card's
    # threads a launch) and a 1920x1080 sample's (the card full)
    nodes, tri = bx._bvh_device_layout(ps.bvh, dev)
    leaf = ps.bvh.leaf_width

    def run(fn, rays):
        return lambda: [fn(nodes, tri, o, d, a, leaf_width=leaf)
                        for o, d, a in rays]

    stats = {}
    for o, d, a in sweeps:
        bx.bvh_walk_plain(nodes, tri, o, d, a, leaf_width=leaf, stats=stats)
    passes = 20
    ms, spread = graph_ms(run(bx.bvh_walk, sweeps), passes, 21)
    plain_ms, _, _ = event_ms(run(bx.bvh_walk_plain, sweeps), 3)
    n_calls = len(sweeps)
    plain_ms /= n_calls
    n_rays = sum(o.shape[0] for o, _, _ in sweeps)
    n_alive = sum(int(a.sum()) for _, _, a in sweeps)
    bound, by = walk_bound(stats, sweeps, nodes, tri)
    print(f"[10] walk kernel, per launch over the {n_calls} sweeps of one "
          f"256x256 wavefront sample ({n_rays} rays, {n_alive} alive; leaf "
          f"{leaf}, {nodes.shape[0]} nodes): {ms:.5f} ms kernel (median of "
          f"21 replays of a CUDA graph of {passes} passes; spread "
          f"(max-min)/median {spread:.4f}), {plain_ms:.3f} ms plain; "
          f"{stats['box_tests'] / n_alive:.1f} box tests and "
          f"{stats['tests'] / n_alive:.1f} Woop tests a live ray, bound "
          f"{bound:.5f} ms ({by})")
    cam_hd = camera_from_rtc(_resized(parse_rtc(rtc), HD), device=dev)
    hd = record_sweeps(ps.scene, cam_hd, ps.intersect, SECOND)
    hd_ms, hd_spread = graph_ms(run(bx.bvh_walk, hd), 3, 7)
    any_ms, _ = graph_ms(lambda: [bx.bvh_walk(nodes, tri, o, d, a,
                                              leaf_width=leaf, any_hit=True)
                                  for o, d, a in hd], 3, 7)
    print(f"[10] walk kernel, per launch over the {len(hd)} sweeps of one "
          f"{HD['xres']}x{HD['yres']} wavefront sample "
          f"({sum(o.shape[0] for o, _, _ in hd)} rays, "
          f"{sum(int(a.sum()) for _, _, a in hd)} alive): {hd_ms:.5f} ms "
          f"kernel (median of 7 replays of a CUDA graph of 3 passes; spread "
          f"{hd_spread:.4f}), any-hit {any_ms:.5f} ms; its bound from the "
          f"plain walk's counts: tools/bvh_probe.py --walk")
    return {"launches": n_wave + n_regen + n_near + n_any,
            "max_abs_err": walk_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def _phase_slice5_checks(tmp: Path, dev, cornell, lv2, lv5, cam64) -> dict:
    """Phase 3, kernels 7a, 7b, 9a and 9b against their plain versions at
    64x64, 4 spp, depth 4 (2 light samples for the path pair) on Cornell,
    levels-2 and levels-5, at leaf width 2 (one tree) and 128 (eight octant
    copies): the BVH Whitted kernel on the point-light box, the textured
    kernel's image on the checker-textured point-light box (against the
    records and epilogue of its plain version), the BVH PRB forward
    (image, per-sample radiance) and replay (gradients) on the path box.
    Returns the largest errors by kernel."""
    import torch

    from orion_tpu_torch.ops import bvh_prb as bvp
    from orion_tpu_torch.ops import bvh_whitted as bw
    from orion_tpu_torch.ops import fused_path as fp
    from orion_tpu_torch.scene import load_scene, subdivide_scene

    errs = {"7a": 0.0, "7b": 0.0, "9a": 0.0, "9b": 0.0}
    S, D = 4, 4
    solid, _ = load_scene(write_cornell_whitted(tmp / "s5w", xres=64,
                                                yres=64, depth=D), device=dev)
    tex, _ = load_scene(write_cornell_whitted(tmp / "s5t", xres=64, yres=64,
                                              depth=D, checker=True),
                        device=dev)
    whitted = [("cornell", solid, tex)] + [
        (f"levels-{lv}", subdivide_scene(solid, levels=lv),
         subdivide_scene(tex, levels=lv)) for lv in (2, BIG_LEVELS)]
    paths = (("cornell", cornell), ("levels-2", lv2),
             (f"levels-{BIG_LEVELS}", lv5))
    for leaf in (2, 128):
        tree = dict(leaf_width=leaf, octants=8 if leaf == 128 else 1)
        kw = dict(leaf_width=leaf, copies=tree["octants"])
        for sname, ws, ts in whitted:
            tag = f"{sname} leaf {leaf} 64x64"
            fn = bw.make_bvh_whitted_renderer(ws, cam64, samples=S,
                                              max_depth=D, **tree)
            k = fn(1234).reshape(-1, 3)
            torch.cuda.synchronize()
            dd = fn.data
            p = bw.bvh_whitted_plain(dd["nodes"], dd["tab"], dd["lights"],
                                     dd["cam"], 1234, 64, 64, S, D,
                                     dd["with_emissive"], **kw)
            errs["7a"] = max(errs["7a"], fused_agree(f"bvh whitted {tag}", k,
                                                     p))
            fd = bw.make_bvh_whitted_deferred(ts, cam64, samples=S,
                                              max_depth=D, **tree)
            dd = fd.data
            k = fd(1234).reshape(-1, 3)
            torch.cuda.synchronize()
            p = bw.bvh_whitted_textured_plain(
                ts, dd["nodes"], dd["tab"], dd["lights"], dd["cam"], 1234,
                64, 64, S, D, dd["with_emissive"], **kw)
            errs["7b"] = max(errs["7b"], fused_agree(
                f"bvh whitted textured {tag}", k, p))
        for sname, sc in paths:
            tag = f"{sname} leaf {leaf} 64x64"
            nodes, _, update = bvp.make_bvh_tab_updater(sc, **tree)
            args = (nodes, update(),
                    torch.as_tensor(fp.pack_emitters(sc), device=dev),
                    fp.camera_vec(cam64).to(dev), 1234)
            cfg = (64, 64, S, D, 2)
            img_k, ls_k = bvp.bvh_fwd_ls(*args, *cfg, **kw)
            torch.cuda.synchronize()
            img_p, ls_p = bvp.bvh_fwd_ls_plain(*args, *cfg, **kw)
            errs["9a"] = max(errs["9a"],
                             fused_agree(f"bvh prb fwd {tag}", img_k, img_p),
                             fused_agree(f"bvh prb fwd L_s {tag}", ls_k,
                                         ls_p))
            keep = agreeing_lanes(ls_k, ls_p)
            w = _cotangent(img_p, S, 7) * keep[:, None]
            print(f"[3] bvh prb replay {tag}: lanes held "
                  f"{int(keep.sum())} of {keep.numel()}")
            g_k = bvp.bvh_prb_replay(*args, w, ls_k, *cfg, **kw)
            torch.cuda.synchronize()
            g_p = bvp.bvh_prb_replay_plain(*args, w, ls_p, *cfg, **kw)
            errs["9b"] = max(errs["9b"], grad_agree(
                f"bvh prb replay {tag}", g_k, g_p))
    return errs


def _phase_big_whitted(tmp: Path, dev, card: str, errs: dict) -> dict:
    """Phase 12 (a) and (b): Whitted past the fused gate at full width, the
    levels-5 point-light box untextured (kernel 7a) and checker-textured
    (kernel 7b) through cli.main. Returns the two kernels' records."""
    import torch

    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import octant_signs
    from orion_tpu_torch.ops import bvh_whitted as bw
    from orion_tpu_torch.ops import whitted as wh
    from orion_tpu_torch.scene import load_scene, subdivide_scene

    W, H, S, D = (WHITTED["xres"], WHITTED["yres"], WHITTED["samples"],
                  WHITTED["depth"])
    n_pix, rays = W * H, W * H * WHITTED["samples"]
    small = dict(xres=256, yres=256, samples=16, light_samples=1, depth=D)
    bases = [int(i * (n_pix - TILE_LANES) / (N_TILES - 1))
             for i in range(N_TILES)]

    def reset():
        bw.KERNEL.launches = bw.DEFERRED_KERNEL.launches = 0
        wh.KERNEL.launches = 0

    def against_wavefront(name, checker, backend):
        rtc = write_cornell_whitted(tmp / f"bw256_{name}", xres=256,
                                    yres=256, depth=D, levels=BIG_LEVELS,
                                    checker=checker)
        img_k, rep = run_cli(rtc, tmp / f"{name}_k.hdr", small, report=True)
        img_w, rep_w = run_cli(rtc, tmp / f"{name}_w.hdr", small,
                               backend="bvh", report=True)
        c = corr(img_k, img_w)
        mrel = abs(img_k.mean() - img_w.mean()) / img_w.mean()
        print(f"[12] {name} {rep['backend']} vs the Whitted wavefront "
              f"({rep_w['backend']}) at {small}: corr {c:.4f}, means "
              f"{img_k.mean():.6g} vs {img_w.mean():.6g} (rel {mrel:.3g})")
        check(rep["backend"] == backend and rep_w["backend"] == "bvh-kernel",
              f"backends {rep['backend']}, {rep_w['backend']}")
        check(c > 0.93 and mrel <= 0.025, f"{name}: corr {c}, mean rel {mrel}")

    # (a) untextured ---------------------------------------------------------
    rtc = write_cornell_whitted(tmp / "bw_main", xres=W, yres=H, depth=D,
                                levels=BIG_LEVELS)
    reset()
    t0 = time.perf_counter()
    img, rep = run_cli(rtc, tmp / "bw.hdr", WHITTED, report=True)
    secs = time.perf_counter() - t0
    launches = bw.KERNEL.launches
    print(f"[12] (a) Whitted {WHITTED} on {rep['triangles']} triangles "
          f"through the CLI: {secs:.3f} s (render {rep['render_seconds']} s),"
          f" backend {rep['backend']}, BVH Whitted launches {launches} "
          f"(deferred {bw.DEFERRED_KERNEL.launches}, brute Whitted "
          f"{wh.KERNEL.launches}), image mean {img.mean():.6g}")
    check(rep["backend"] == "bvh-whitted-kernel", f"backend {rep['backend']}")
    check(launches > 0 and wh.KERNEL.launches == 0,
          "the CLI never launched the BVH Whitted kernel")
    check(img.shape == (H, W, 3) and np.isfinite(img).all()
          and img.mean() > 0, "BVH Whitted image")

    scene, r = load_scene(rtc, device=dev)
    cam = camera_from_rtc(_resized(r, WHITTED), device=dev)
    signs = octant_signs(cam.front)
    fn = bw.make_bvh_whitted_renderer(scene, cam, samples=S, max_depth=D,
                                      order_signs=signs)
    ms, times, k = event_ms(lambda: fn(0), 3)
    k = k.reshape(-1, 3)
    dd = fn.data
    stats = {}
    plain_ms, p = once_ms(lambda: bw.bvh_whitted_plain(
        dd["nodes"], dd["tab"], dd["lights"], dd["cam"], 0, W, H, S, D,
        dd["with_emissive"], leaf_width=dd["leaf_width"], stats=stats))
    err_a = max(errs["7a"], fused_agree("bvh whitted 1080p", k, p))
    tile_ms, _, tiles = event_ms(lambda: torch.cat(
        [fn(0, pix_base=b, n_lanes=TILE_LANES) for b in bases]), 3)
    pix = torch.cat([torch.arange(b, b + TILE_LANES, device=dev)
                     for b in bases])
    check(torch.equal(tiles, k[pix]),
          "a BVH Whitted tile does not render the whole image's pixels")
    fused_agree(f"bvh whitted 1080p, {N_TILES} tiles x {TILE_LANES} lanes",
                tiles, p[pix])
    box, tri = stats["box_tests"], stats["tests"]
    bound, by = bound_ms(box * SLAB_TEST_FLOPS + tri * WOOP_TEST_FLOPS,
                         (dd["nodes"].numel() + dd["tab"].numel()) * 4
                         + n_pix * 12)
    print(f"[12] bvh whitted: {ms:.3f} ms kernel (runs "
          f"{', '.join(f'{x:.3f}' for x in times)}) = "
          f"{rays / (ms * 1e-3):.4g} primary rays/s of device time on "
          f"{card}; {plain_ms:.1f} ms plain; {box:.6g} box tests and "
          f"{tri:.6g} Woop tests, bound {bound:.4f} ms ({by}); the "
          f"{N_TILES} tiles: {tile_ms:.3f} ms in {N_TILES} launches")
    # the same estimator as kernel 4 (the brute sweep) on levels-2
    w2 = subdivide_scene(load_scene(write_cornell_whitted(
        tmp / "bw64", xres=64, yres=64, depth=D), device=dev)[0], levels=2)
    cam64 = camera_from_rtc(_resized(r, dict(xres=64, yres=64)), device=dev)
    fused_agree("bvh whitted vs the Whitted kernel, levels-2 64x64",
                bw.make_bvh_whitted_renderer(w2, cam64, samples=S,
                                             max_depth=D)(1234).reshape(-1, 3),
                wh.fused_whitted(*wh.whitted_args(w2, cam64), 1234, 64, 64,
                                 S, D, True))
    against_wavefront("untextured", False, "bvh-whitted-kernel")
    rec_a = {"launches": launches, "max_abs_err": err_a, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
             "library_ms": None}

    # (b) textured -------------------------------------------------------
    rtc_t = write_cornell_whitted(tmp / "bwt_main", xres=W, yres=H, depth=D,
                                  levels=BIG_LEVELS, checker=True)
    reset()
    t0 = time.perf_counter()
    img_t, rep = run_cli(rtc_t, tmp / "bwt.hdr", WHITTED, report=True)
    secs = time.perf_counter() - t0
    launches = bw.DEFERRED_KERNEL.launches
    print(f"[12] (b) textured Whitted {WHITTED} through the CLI: {secs:.3f} "
          f"s (render {rep['render_seconds']} s), backend {rep['backend']}, "
          f"deferred launches {launches} (BVH Whitted {bw.KERNEL.launches}),"
          f" image mean {img_t.mean():.6g} (untextured {img.mean():.6g})")
    check(rep["backend"] == "bvh-whitted-deferred-kernel",
          f"backend {rep['backend']}")
    check(launches > 0 and bw.KERNEL.launches == 0,
          "the CLI never launched the deferred kernel")
    check(np.isfinite(img_t).all() and img_t.mean() > 0
          and not np.allclose(img_t, img, atol=1e-3), "textured image")
    tsc, _ = load_scene(rtc_t, device=dev)
    fd = bw.make_bvh_whitted_deferred(tsc, cam, samples=S, max_depth=D,
                                      order_signs=signs)
    dd = fd.data
    args = (tsc, dd["nodes"], dd["tab"], dd["lights"], dd["cam"], 0, W, H, S,
            D, dd["with_emissive"])
    kw = dict(leaf_width=dd["leaf_width"])
    k_ms, k_times, k = event_ms(lambda: bw.bvh_whitted_textured(
        *args, **kw, texels=dd["texels"]), 3)
    r_ms, r_times, _ = event_ms(lambda: fd(0), 3)
    stats = {}
    d_plain_ms, p = once_ms(lambda: bw.bvh_whitted_textured_plain(
        *args, **kw, stats=stats))
    err_b = max(errs["7b"], fused_agree("bvh whitted textured 1080p", k, p))
    tiles = torch.cat([fd(0, pix_base=b, n_lanes=TILE_LANES) for b in bases])
    check(torch.equal(tiles, k[pix]),
          "a textured tile does not render the whole image's pixels")
    fused_agree(f"bvh whitted textured 1080p, {N_TILES} tiles x "
                f"{TILE_LANES} lanes", tiles, p[pix])
    del p
    # the bound counts the walks the kernel makes: the mirror chain pruned
    # where the throughput is zero. The checker maps Kd alone, so this box
    # has (a)'s geometry, tree and Ks, and the kernel walks (a)'s rays: (a)'s
    # plain counts (the plain version's records run every bounce: printed
    # beside)
    mat_tex, atlas = dd["texels"]
    d_bound, d_by = bound_ms(box * SLAB_TEST_FLOPS + tri * WOOP_TEST_FLOPS,
                             (dd["nodes"].numel() + dd["tab"].numel()
                              + mat_tex.numel() + atlas.numel()) * 4
                             + n_pix * 12)
    print(f"[12] textured: kernel {k_ms:.3f} ms (runs "
          f"{', '.join(f'{x:.3f}' for x in k_times)}), the renderer "
          f"{r_ms:.3f} ms (runs {', '.join(f'{x:.3f}' for x in r_times)}) = "
          f"{rays / (r_ms * 1e-3):.4g} primary rays/s on {card}, backend "
          f"{rep['backend']}; {d_plain_ms:.1f} ms plain (records and "
          f"epilogue: {stats['box_tests']:.6g} box tests and "
          f"{stats['tests']:.6g} Woop tests, every bounce); the kernel's "
          f"walks {box:.6g} box tests and {tri:.6g} Woop tests, bound "
          f"{d_bound:.4f} ms ({d_by})")
    against_wavefront("textured", True, "bvh-whitted-deferred-kernel")
    return {"7a": rec_a,
            "7b": {"launches": launches, "max_abs_err": err_b, "ms": k_ms,
                   "plain_ms": d_plain_ms, "bound_ms": d_bound,
                   "bound_by": d_by, "library_ms": None}}


def _phase_bvh_train(tmp: Path, dev, card: str, errs: dict) -> dict:
    """Phase 12 (c): the BVH path-replay trainer at TRAIN shapes on the
    levels-5 box, red wall x 0.6. Returns the records of kernels 9a/9b."""
    import dataclasses

    import torch

    from orion_tpu_torch import engine
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.ops import bvh_prb as bvp
    from orion_tpu_torch.optim import fit

    W, H, S, D, LS = (TRAIN["xres"], TRAIN["yres"], TRAIN["samples"],
                      TRAIN["depth"], TRAIN["light_samples"])
    tcfg = dict(samples=S, max_depth=D, light_samples=LS)
    seed = 3
    rtc = write_cornell(tmp / "bvh_train", xres=W, yres=H, depth=D,
                        levels=BIG_LEVELS)
    ps = engine.prepare(rtc, device=dev)
    target = bp.make_bvh_path_renderer(ps.scene, ps.camera, **tcfg)(seed)
    kd_true = ps.scene.mat_diffuse.clone()
    red = int(torch.argmax(kd_true[:, 0] - kd_true[:, 1]))
    kd_pert = kd_true.clone()
    kd_pert[red] *= 0.6
    pert = dataclasses.replace(ps.scene, mat_diffuse=kd_pert)
    params = {"mat_diffuse": kd_pert, "mat_emissive": pert.mat_emissive}

    def reset():
        bvp.FWD_KERNEL.launches = bvp.REPLAY_KERNEL.launches = 0

    def counts():
        return bvp.FWD_KERNEL.launches, bvp.REPLAY_KERNEL.launches

    step = bvp.make_bvh_train_step(pert, ps.camera, target,
                                   order_signs=ps.order_signs,
                                   dynamic_params=True, **tcfg)
    reset()
    loss, grads = step(params, seed)
    torch.cuda.synchronize()
    print(f"[12] (c) BVH PRB step {TRAIN} on {pert.num_triangles} "
          f"triangles: loss {float(loss):.6g}, launches (fwd, replay) "
          f"{counts()}, largest |d kd| "
          f"{float(grads['mat_diffuse'].abs().max()):.4g}, |d ke| "
          f"{float(grads['mat_emissive'].abs().max()):.4g}")
    check(counts() == (1, 1), f"BVH PRB step launches {counts()}")
    plan = step.plan
    tab = plan.table(kd_pert, pert.mat_emissive)
    kw = dict(leaf_width=plan.leaf_width, copies=plan.copies)
    args = (plan.nodes, tab, plan.em, plan.cam, seed)
    cfg = (W, H, S, D, LS)
    f_ms, f_times, (img_k, ls_k) = event_ms(
        lambda: plan.forward(tab, seed), 3)
    diff = img_k.reshape(H, W, 3) - target
    w = (diff * (2.0 / (H * W * 3 * S))).reshape(-1, 3).contiguous()
    r_ms, r_times, _ = event_ms(lambda: plan.replay(tab, seed, w, ls_k), 3)
    s_ms, s_times, _ = event_ms(lambda: step(params, seed), 3)
    rays = W * H * S
    f_stats = {}
    f_plain_ms, (img_p, ls_p) = once_ms(lambda: bvp.bvh_fwd_ls_plain(
        *args, *cfg, **kw, stats=f_stats))
    fwd_err = max(errs["9a"], fused_agree("bvh prb fwd 1080p", img_k, img_p),
                  fused_agree("bvh prb fwd L_s 1080p", ls_k, ls_p))
    keep = agreeing_lanes(ls_k, ls_p)
    w_keep = (w * keep[:, None]).contiguous()
    print(f"[12] bvh prb replay 1080p: lanes held {int(keep.sum())} of "
          f"{keep.numel()}")
    r_plain_ms, g_p = once_ms(lambda: bvp.bvh_prb_replay_plain(
        *args, w_keep, ls_p, *cfg, **kw))
    replay_err = max(errs["9b"], grad_agree(
        "bvh prb replay 1080p", plan.replay(tab, seed, w_keep, ls_k), g_p))
    del ls_p, img_p
    box, tri = f_stats["box_tests"], f_stats["tests"]
    ops = box * SLAB_TEST_FLOPS + tri * WOOP_TEST_FLOPS
    tree_bytes = (plan.nodes.numel() + tab.numel()) * 4
    ls_bytes = W * H * 12 * S
    f_bound, f_by = bound_ms(ops, tree_bytes + W * H * 12 + ls_bytes)
    r_bound, r_by = bound_ms(ops, tree_bytes + W * H * 12 + ls_bytes
                             + 6 * bvp.M_LANES * 8)
    print(f"[12] bvh prb fwd: {f_ms:.3f} ms kernel (runs "
          f"{', '.join(f'{x:.3f}' for x in f_times)}), {f_plain_ms:.1f} ms "
          f"plain, {box:.6g} box tests and {tri:.6g} Woop tests, bound "
          f"{f_bound:.4f} ms ({f_by})")
    print(f"[12] bvh prb replay: {r_ms:.3f} ms kernel (runs "
          f"{', '.join(f'{x:.3f}' for x in r_times)}), {r_plain_ms:.1f} ms "
          f"plain, bound {r_bound:.4f} ms ({r_by})")
    print(f"[12] BVH PRB train step (fwd + replay + loss + table): "
          f"{s_ms:.3f} ms (runs {', '.join(f'{x:.3f}' for x in s_times)}) = "
          f"{rays / (s_ms * 1e-3):.4g} fwd+bwd primary rays/s on {card}")

    # gradients against the plain pair at 256x256
    cam_s = camera_from_rtc(_resized(parse_rtc(rtc), dict(xres=256,
                                                          yres=256)),
                            device=dev)
    target_s = bp.make_bvh_path_renderer(ps.scene, cam_s, **tcfg)(seed)
    step_s = bvp.make_bvh_train_step(pert, cam_s, target_s,
                                     order_signs=ps.order_signs, **tcfg)
    loss_k, _ = step_s(seed)
    pl = step_s.plan
    tab_s = pl.table()
    a_s = (pl.nodes, tab_s, pl.em, pl.cam, seed)
    c_s = (256, 256, S, D, LS)
    img_ps, ls_ps = bvp.bvh_fwd_ls_plain(*a_s, *c_s, **kw)
    _, ls_ks = pl.forward(tab_s, seed)
    d_s = img_ps.reshape(256, 256, 3) - target_s
    loss_p = float(torch.mean(d_s * d_s))
    keep = agreeing_lanes(ls_ks, ls_ps)
    w_s = ((d_s * (2.0 / (256 * 256 * 3 * S))).reshape(-1, 3)
           * keep[:, None]).contiguous()
    g_ks = pl.replay(tab_s, seed, w_s, ls_ks)
    g_ps = bvp.bvh_prb_replay_plain(*a_s, w_s, ls_ps, *c_s, **kw)
    M = pert.num_meshes
    loss_rel = abs(float(loss_k) - loss_p) / loss_p
    print(f"[12] BVH PRB 256x256: loss kernels {float(loss_k):.7g} vs plain "
          f"{loss_p:.7g} (rel {loss_rel:.3g}); lanes held "
          f"{int(keep.sum())} of {keep.numel()}")
    check(loss_rel <= 1e-3, f"BVH PRB loss rel {loss_rel}")
    replay_err = max(replay_err,
                     grad_agree("bvh prb mat_diffuse 256x256",
                                g_ks[0:3, :M], g_ps[0:3, :M]),
                     grad_agree("bvh prb mat_emissive 256x256",
                                g_ks[3:6, :M], g_ps[3:6, :M]))

    # the user's entry point: fit past the fused gate, emission included
    # (plain gradient steps: Adam would move every mesh's emission by its
    # learning rate at once and light the walls)
    ps_pert = dataclasses.replace(ps, scene=pert)
    reset()
    stamps = [time.perf_counter()]
    res = fit(ps_pert, target, params=("mat_diffuse", "mat_emissive"),
              steps=5, optimizer=lambda p: torch.optim.SGD(p, lr=1.0),
              seed=seed, resample_keys=False,
              callback=lambda i, v: stamps.append(time.perf_counter()),
              **tcfg)
    launches = counts()
    per_step = np.diff(stamps[1:]) * 1e3
    err0 = float((kd_pert[red] - kd_true[red]).abs().sum())
    err1 = float((res.params["mat_diffuse"][red] - kd_true[red]).abs().sum())
    print(f"[12] fit 5 steps (mat_diffuse, mat_emissive): first step "
          f"{(stamps[1] - stamps[0]) * 1e3:.1f} ms (set-up included), later "
          f"steps median {float(np.median(per_step)):.3f} ms; losses "
          f"{', '.join(f'{x:.6g}' for x in res.losses)}; red wall albedo "
          f"error {err0:.5f} -> {err1:.5f}; launches (fwd, replay) "
          f"{launches}")
    check(min(launches) > 0, "fit never launched the BVH PRB kernels")
    check(res.losses[-1] < res.losses[0], "BVH PRB fit loss did not fall")
    check(err1 < err0, "BVH PRB fit: the red wall's albedo error did not fall")
    return {
        "9a": {"launches": launches[0], "max_abs_err": fwd_err, "ms": f_ms,
               "plain_ms": f_plain_ms, "bound_ms": f_bound, "bound_by": f_by,
               "library_ms": None},
        "9b": {"launches": launches[1], "max_abs_err": replay_err,
               "ms": r_ms, "plain_ms": r_plain_ms, "bound_ms": r_bound,
               "bound_by": r_by, "library_ms": None},
    }


def _phase_refit(tmp: Path, dev) -> int:
    """Phase 12 (d): a vertex fit on the levels-5 box over the BVH backend,
    the tree refitted every step. Returns the walk kernel's launches."""
    import dataclasses

    import torch

    from orion_tpu_torch import engine
    from orion_tpu_torch.accel.refit import RefitPlan
    from orion_tpu_torch.ops import bvh_intersect as bx
    from orion_tpu_torch.optim import fit
    from orion_tpu_torch.render import render

    cfg = dict(samples=1, max_depth=2, light_samples=1)
    rtc = write_cornell(tmp / "refit", xres=128, yres=128, depth=2,
                        levels=BIG_LEVELS)
    ps = engine.prepare(rtc, device=dev, force_backend="bvh")
    check(ps.backend == "bvh-kernel" and ps.bvh is not None,
          f"refit backend {ps.backend}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with torch.no_grad():
        target = render(ps.scene, ps.camera, gen, intersect=ps.intersect,
                        **cfg)
    noise = np.random.default_rng(5).normal(0.0, 2e-3, ps.scene.tri_v0.shape)
    v0 = ps.scene.tri_v0 + torch.as_tensor(noise, dtype=torch.float32,
                                           device=dev)
    ps_p = dataclasses.replace(ps, scene=dataclasses.replace(ps.scene,
                                                             tri_v0=v0))
    bx.KERNEL.launches = bx.ANY_HIT_KERNEL.launches = 0
    stamps = [time.perf_counter()]
    res = fit(ps_p, target, params=("tri_v0",), steps=3, learning_rate=1e-3,
              seed=0, callback=lambda i, v: stamps.append(time.perf_counter()),
              **cfg)
    launches = bx.KERNEL.launches + bx.ANY_HIT_KERNEL.launches
    plan = RefitPlan(ps.bvh)
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        plan.refit(v0, ps.scene.tri_e1, ps.scene.tri_e2, device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    moved = float((res.params["tri_v0"] - v0).abs().max())
    print(f"[12] (d) vertex fit over the refitted tree, {ps.scene.num_triangles}"
          f" triangles, {ps.bvh.num_nodes} nodes, 128x128 1 spp depth 2: "
          f"losses {', '.join(f'{x:.6g}' for x in res.losses)}; step wall "
          f"times {', '.join(f'{x * 1e3:.1f}' for x in np.diff(stamps))} ms; "
          f"refit {float(np.median(secs)) * 1e3:.2f} ms a step (median of 5,"
          f" host NumPy + copy); walk launches {launches}; largest vertex "
          f"move {moved:.3g}")
    check(launches > 0, "the vertex fit never launched the walk kernel")
    check(np.isfinite(res.losses).all() and moved > 0, "vertex fit")
    return launches


def g8_equal(name: str, kernel, plain) -> None:
    """G8's (t, row) equal the plain walk's (leaf 128) bit for bit: a lane
    walks exactly its own path (nearest; any hit settles at the plain
    walk's first leaf with a hit)."""
    import torch

    (t_k, r_k), (t_p, r_p) = kernel, plain
    off = int((~((r_k == r_p) & ((t_k == t_p) | (r_p < 0)))).sum())
    print(f"[g8 {name}] {r_p.numel()} rays, (t, row) differ from the plain "
          f"walk's on {off}, hits {int((r_p >= 0).sum())}")
    check(torch.equal(r_k, r_p) and torch.equal(t_k, t_p),
          f"g8 {name}: (t, row) differ from the plain walk's on {off} rays")


def _rows_as_ids(t, row):
    """A binned sweep's (t, float row with the NO_ROW sentinel) as brute
    sweep results (t, id with -1 on a miss)."""
    import torch

    from orion_tpu_torch.ops import binned as bn

    hit = row < bn.NO_ROW
    return t, torch.where(hit, row.to(torch.int64),
                          torch.full_like(row, -1, dtype=torch.int64))


def _phase_binned_checks(dev, cornell, lv2, lv5, cam64, sweeps) -> dict:
    """Phase 13 (a): kernels 10 and 11 against their plain versions at
    64x64, 4 spp, depth 4, 2 light samples on Cornell, levels-2 and
    levels-5: the binned renderer's sweeps (kernel rounds against plain
    rounds on each bounce's recorded rays), the vis kernel's draws, the
    image against bounce_reference_render, the trainer's gradients against
    the plain rounds'; G8 against kernel 5's plain walk of the same
    leaf-128 tree on random rays and phase 3's recorded wavefront sweeps
    (the same box at every level), (t, row) bit for bit, nearest and any
    hit. Returns {"10": max t error, "11": max t error}."""
    import torch

    from orion_tpu_torch.accel.bvh import build_scene_bvh
    from orion_tpu_torch.ops import binned as bn
    from orion_tpu_torch.ops import bounce as bo
    from orion_tpu_torch.ops import bvh_g8 as g8
    from orion_tpu_torch.ops import bvh_intersect as bx
    from orion_tpu_torch.ops import prb_wavefront as pw

    cfg = dict(samples=4, max_depth=4, light_samples=2)
    errs = {"10": 0.0, "11": 0.0}
    for sname, sc in (("cornell", cornell), ("levels-2", lv2),
                      (f"levels-{BIG_LEVELS}", lv5)):
        fn = bn.make_binned_path_renderer(sc, cam64, **cfg)
        rec = []
        img = fn(1234, record=lambda depth, n, st, hd, kd, vis: rec.append(
            (depth, st[:, :n].clone(), hd)))
        torch.cuda.synchronize()
        plain = bn.BinnedSweep(fn.sweep.bins, fn.sweep.tab,
                               round_fn=bn.binned_round_plain)
        for depth, st, hd in rec:
            tag = f"{sname} 64x64 depth {depth}"
            o, d, alive = (st[0], st[1], st[2]), (st[3], st[4], st[5]), \
                st[9] > 0.0
            errs["10"] = max(errs["10"], brute_agree(
                f"binned sweep {tag}", _rows_as_ids(*fn.sweep.closest(
                    o, d, alive)), _rows_as_ids(*plain.closest(o, d,
                                                                 alive))))
            draws_agree(tag, fn.ctx["data"], st, hd, 1234, depth, 2)
        c = fn.sweep.counts
        print(f"[13] (a) binned {sname} 64x64: {c['sweeps']} sweeps, "
              f"{c['rounds']} rounds, {c['lanes']} round lanes, "
              f"{int(c['tests'])} Woop tests")
        ref = bo.bounce_reference_render(sc, cam64, 1234, **cfg)
        fused_agree(f"binned vs reference {sname} 64x64", img.reshape(-1, 3),
                    ref.reshape(-1, 3))
        target = ref * 0.8
        got = [pw.make_binned_train_step(sc, cam64, target, round_fn=r,
                                         **cfg)(1234)
               for r in (None, bn.binned_round_plain)]
        for pname in ("mat_diffuse", "mat_emissive"):
            grad_agree(f"binned train {pname} {sname} 64x64",
                       got[0][1][pname], got[1][1][pname])

    for sname, sc in (("cornell", cornell), ("levels-2", lv2),
                      (f"levels-{BIG_LEVELS}", lv5)):
        bvh, _ = build_scene_bvh(sc, leaf_size=g8.LEAF_WIDTH)
        nodes, tri = bx._bvh_device_layout(bvh, dev)
        rays = [("random", *random_rays(1 << 18, 2, dev))]
        rays += [(f"wavefront sweep {i}", *c) for i, c in enumerate(sweeps)]
        for rname, o, d, alive in rays:
            for any_hit in (False, True):
                k = g8.bvh_g8(nodes, tri, o, d, alive, any_hit=any_hit)
                torch.cuda.synchronize()
                p = bx.bvh_walk_plain(nodes, tri, o, d, alive,
                                      leaf_width=g8.LEAF_WIDTH,
                                      any_hit=any_hit)
                g8_equal(f"{sname} leaf 128 {rname}"
                         f"{' any-hit' if any_hit else ''}", k, p)
    return errs


def _round_bound(rounds, sweep):
    """(flops, bytes) of kernel 10 over recorded rounds [(st, key)]: the
    real rows' Woop tests, each lane's 8 floats and key in and 2 floats
    out, the bins and the table read once a launch."""
    flops = nbytes = 0
    for st, key in rounds:
        flops += int(sweep.real_rows[key.long()].sum()) * WOOP_TEST_FLOPS
        nbytes += key.numel() * (ROUND_LANE_BYTES) + (
            sweep.tab.numel() + 2 * sweep.row0.numel()) * 4
    return flops, nbytes


ROUND_LANE_BYTES = 8 * 4 + 4 + 2 * 4


def _phase_binned(tmp: Path, dev, card: str, lv5, big_rtc: Path, sweeps,
                  errs: dict) -> dict:
    """Phase 13 (b)-(d): the binned renderer and trainer at full width, and
    G8 against kernel 5 on one leaf-128 tree. Returns the two kernels'
    records."""
    import torch

    from orion_tpu_torch import engine
    from orion_tpu_torch.accel.bvh import build_scene_bvh
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import binned as bn
    from orion_tpu_torch.ops import bounce as bo
    from orion_tpu_torch.ops import bvh_g8 as g8
    from orion_tpu_torch.ops import bvh_intersect as bx
    from orion_tpu_torch.ops import cuda_build
    from orion_tpu_torch.ops import prb_wavefront as pw
    from orion_tpu_torch.render import render

    W, H, S, D, LS = (TRAIN["xres"], TRAIN["yres"], TRAIN["samples"],
                      TRAIN["depth"], TRAIN["light_samples"])
    cfg = dict(samples=S, max_depth=D, light_samples=LS)
    rtc = parse_rtc(big_rtc)
    cam = camera_from_rtc(_resized(rtc, TRAIN), device=dev)
    rays = W * H * S

    # (b) the render ---------------------------------------------------------
    t0 = time.perf_counter()
    fn, name = engine.make_big_path_renderer(lv5, cam, order=("binned",),
                                             **cfg)
    torch.cuda.synchronize()
    sweep = fn.sweep
    print(f"[13] (b) binned set-up (tree, bins, table): "
          f"{time.perf_counter() - t0:.3f} s, backend {name}, "
          f"{sweep.k} bins over {sweep.tab.shape[0]} bundled rows "
          f"(bundles a bin {np.bincount(sweep.bins.n_bundles[:-1])})")
    check(name == "binned-kernel", f"binned backend {name}")
    fn(1)                                   # warm-up
    bn.KERNEL.launches = bo.VIS_KERNEL.launches = 0
    for key in ("sweeps", "rounds", "lanes"):
        sweep.counts[key] = 0
    sweep.counts["tests"].zero_()
    sweep.timings = []
    rec1 = []
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    stages = []
    img = fn(0, timings=stages,
             record=lambda depth, n, st, hd, kd, vis: rec1.append(
                 st[:, :n].clone()) if depth == 1 else None)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
    stage = _stage_ms(stages)
    per = {k: sum(ms for (nm, _), (_, ms) in stage.items() if nm == k)
           for k in ("walk", "vis", "shade", "sort", "primaries", "image")}
    launches = bn.KERNEL.launches
    c = dict(sweep.counts)
    k10_ms = sum(a.elapsed_time(b) for a, b in sweep.timings)
    sweep.timings = None
    tests = int(c["tests"])
    b_flops = tests * WOOP_TEST_FLOPS
    b_bytes = c["lanes"] * ROUND_LANE_BYTES + launches * (
        sweep.tab.numel() + 2 * sweep.row0.numel()) * 4
    r_bound, r_by = bound_ms(b_flops, b_bytes)
    print(f"[13] (b) binned render {TRAIN} on {lv5.num_triangles} triangles: "
          f"kernel-10 launches {launches} in {c['sweeps']} sweeps "
          f"({c['rounds'] / max(c['sweeps'], 1):.2f} rounds a sweep, "
          f"{c['lanes']} round lanes, {tests} Woop tests), draw launches "
          f"{bo.VIS_KERNEL.launches}; kernel 10 {k10_ms:.3f} ms a render "
          f"(bound {r_bound:.4f} ms, {r_by}); peak memory of the render "
          f"{peak:.2f} GiB")
    print(f"[13] (b) that render's stages, summed over bounces (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in per.items())
          + " (walk: the nearest sweeps; vis: the draws and the shadow "
          "sweeps; kernel 10 runs inside both)")
    check(launches > 0 and launches == c["rounds"],
          "the binned render never launched kernel 10")
    check(bo.VIS_KERNEL.launches > 0, "no draw launch")
    check(img.shape == (H, W, 3) and torch_isfinite(img), "binned image")
    fn_b, name_b = engine.make_big_path_renderer(lv5, cam, order=("bounce",),
                                                 **cfg)
    n1, _, _ = event_ms(lambda: fn(0), 1)
    b_ms, b_times, img_b = event_ms(lambda: fn_b(0), 2)
    n2, _, _ = event_ms(lambda: fn(0), 1)
    n_times = [n1, n2]
    n_ms = float(np.median(n_times))
    print(f"[13] (b) on {card}, {rays} primary rays: binned {n_ms:.3f} ms "
          f"(runs {', '.join(f'{x:.3f}' for x in n_times)}) = "
          f"{rays / (n_ms * 1e-3):.4g} primary rays/s; bounce pipeline "
          f"{b_ms:.3f} ms (runs {', '.join(f'{x:.3f}' for x in b_times)}); "
          f"image means {float(img.mean()):.6g} vs {float(img_b.mean()):.6g}")
    fused_agree("binned vs bounce 1080p 4 spp", img.reshape(-1, 3),
                img_b.reshape(-1, 3))
    del img_b, fn_b

    # kernel 10 per launch on the rounds of a 256x256 render (the same
    # scene and shapes): against its plain version, and timed by CUDA-graph
    # replay (eager launches from Python measure the host)
    cam_q = camera_from_rtc(_resized(rtc, dict(xres=256, yres=256)),
                            device=dev)
    fn_q = bn.make_binned_path_renderer(lv5, cam_q, **cfg)
    fn_q.sweep.record = []
    fn_q(0)
    rounds = fn_q.sweep.record
    fn_q.sweep.record = None
    for i, (st, key) in enumerate(rounds):
        errs["10"] = max(errs["10"], binned_round_agree(
            f"256x256 round {i}", st, key, fn_q.sweep))

    def run(f):
        return lambda: [f(st, key, fn_q.sweep.row0, fn_q.sweep.nb,
                          fn_q.sweep.tab) for st, key in rounds]

    passes = 5
    k_ms, k_spread = graph_ms(run(bn.binned_round), passes, 11)
    p_ms, _, _ = event_ms(run(bn.binned_round_plain), 1)
    p_ms /= len(rounds)
    q_flops, q_bytes = _round_bound(rounds, fn_q.sweep)
    q_bound, q_by = bound_ms(q_flops / len(rounds), q_bytes / len(rounds))
    print(f"[13] (b) kernel 10 per launch over the {len(rounds)} rounds of a "
          f"256x256 render ({sum(k.numel() for _, k in rounds)} lanes): "
          f"{k_ms:.5f} ms (median of 11 replays of a CUDA graph of "
          f"{passes} passes; spread {k_spread:.4f}), {p_ms:.3f} ms plain, "
          f"bound {q_bound:.5f} ms ({q_by})")
    del rounds, fn_q

    # and on the rounds of one 1080p sweep (the nearest sweep of the
    # render's depth-1 rays), each against its plain version, timed alike
    st1 = rec1[0]
    sweep.record = []
    sweep.closest((st1[0], st1[1], st1[2]), (st1[3], st1[4], st1[5]),
                  st1[9] > 0.0)
    hd_rounds, sweep.record = sweep.record, None
    for i, (st, key) in enumerate(hd_rounds):
        errs["10"] = max(errs["10"], binned_round_agree(
            f"1080p round {i}", st, key, sweep))
    hd_ms, hd_spread = graph_ms(lambda: [
        bn.binned_round(st, key, sweep.row0, sweep.nb, sweep.tab)
        for st, key in hd_rounds], 3, 7)
    h_flops, h_bytes = _round_bound(hd_rounds, sweep)
    hd_bound, hd_by = bound_ms(h_flops / len(hd_rounds),
                               h_bytes / len(hd_rounds))
    print(f"[13] (b) kernel 10 per launch over the {len(hd_rounds)} rounds "
          f"of one {W}x{H} sweep ({sum(k.numel() for _, k in hd_rounds)} "
          f"lanes): {hd_ms:.5f} ms (median of 7 replays of a CUDA graph of "
          f"3 passes; spread {hd_spread:.4f}), bound {hd_bound:.5f} ms "
          f"({hd_by}); (t, row) bit for bit the plain version's on every "
          f"round at both sizes")
    del hd_rounds

    # (c) the trainer --------------------------------------------------------
    kd_true = lv5.mat_diffuse.clone()
    red = int(torch.argmax(kd_true[:, 0] - kd_true[:, 1]))
    kd_pert = kd_true.clone()
    kd_pert[red] *= 0.6
    step = pw.make_binned_train_step(lv5, cam, img, dynamic_params=True,
                                     **cfg)
    bn.KERNEL.launches = 0
    t_ms, (loss, grads) = once_ms(lambda: step({"mat_diffuse": kd_pert}, 0))
    print(f"[13] (c) binned train step {TRAIN}: {t_ms:.3f} ms = "
          f"{rays / (t_ms * 1e-3):.4g} fwd+bwd primary rays/s on {card}; "
          f"loss {float(loss):.6g}, kernel-10 launches {bn.KERNEL.launches}, "
          f"largest |d kd| {float(grads['mat_diffuse'].abs().max()):.4g}")
    check(bn.KERNEL.launches > 0 and torch_isfinite(grads["mat_diffuse"])
          and float(grads["mat_diffuse"][red].abs().max()) > 0,
          "binned train step")
    del img, fn, step
    # a 3-step SGD fit of the red wall's albedo at 256x256
    target_q = bn.make_binned_path_renderer(lv5, cam_q, **cfg)(3)
    step_q = pw.make_binned_train_step(lv5, cam_q, target_q,
                                       dynamic_params=True, **cfg)
    kd = kd_pert.clone().requires_grad_(True)
    opt = torch.optim.SGD([kd], lr=BINNED_FIT_LR)
    losses = []
    for _ in range(3):
        loss, g = step_q({"mat_diffuse": kd.detach()}, 3)
        losses.append(float(loss))
        kd.grad = g["mat_diffuse"]
        opt.step()
    err0 = float((kd_pert[red] - kd_true[red]).abs().sum())
    err1 = float((kd.detach()[red] - kd_true[red]).abs().sum())
    print(f"[13] (c) SGD fit 3 steps at 256x256 (lr {BINNED_FIT_LR}): losses "
          f"{', '.join(f'{x:.6g}' for x in losses)}; red wall albedo error "
          f"{err0:.5f} -> {err1:.5f}")
    check(losses[-1] < losses[0] and err1 < err0, "binned fit")

    # (d) G8 -----------------------------------------------------------------
    bvh, _ = build_scene_bvh(lv5, leaf_size=g8.LEAF_WIDTH)
    layout = bx._bvh_device_layout(bvh, dev)
    cam_w = camera_from_rtc(_resized(rtc, SECOND), device=dev)
    wcfg = dict(samples=SECOND["samples"], max_depth=SECOND["depth"],
                light_samples=SECOND["light_samples"])
    imgs = []
    for make in (g8.make_bvh_intersect_g8, bx.make_bvh_intersect_kernel):
        g8.KERNEL.launches = g8.ANY_HIT_KERNEL.launches = 0
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        with torch.no_grad():
            imgs.append(render(lv5, cam_w, gen, intersect=make(
                bvh, lv5, layout=layout), **wcfg))
        if make is g8.make_bvh_intersect_g8:
            g8_launches = g8.KERNEL.launches + g8.ANY_HIT_KERNEL.launches
    print(f"[13] (d) wavefront {SECOND} over G8: {g8_launches} launches")
    check(g8_launches > 0, "the wavefront never launched G8")
    fused_agree("G8 vs kernel 5 wavefront 256x256 leaf 128",
                imgs[0].reshape(-1, 3), imgs[1].reshape(-1, 3))
    st1 = rec1[0]
    bounce1 = [(st1[0:3].t().contiguous(), st1[3:6].t().contiguous(),
                st1[9] > 0.0)]
    del rec1, st1
    nodes, tri = layout
    info = (ctypes.c_int * 4)()
    lib = ctypes.CDLL(str(cuda_build.lib_path("bvh_g8")))
    for which, label in ((0, "nearest"), (1, "any-hit")):
        rc = lib.bvh_g8_info(which, info)
        check(rc == 0, f"bvh_g8_info failed: CUDA error {rc}")
        print(f"[13] (d) G8 {label} as built: {info[1]} registers, "
              f"{info[2]} B of local memory a thread, {info[0]} resident "
              f"blocks of 128 threads an SM")
    # G8 bit for bit on the bounce wavefront (phase 10's sweeps: in (a))
    o, d, a = bounce1[0]
    for any_hit in (False, True):
        g8_equal(f"1080p depth-1 bounce wavefront"
                 f"{' any-hit' if any_hit else ''}",
                 g8.bvh_g8(nodes, tri, o, d, a, any_hit=any_hit),
                 bx.bvh_walk_plain(nodes, tri, o, d, a,
                                   leaf_width=g8.LEAF_WIDTH, any_hit=any_hit))
    out = {}
    for rname, rs in (("phase 10's wavefront sweeps", sweeps),
                      ("the 1080p depth-1 bounce wavefront", bounce1)):
        times = {}
        for kname, f in (("G8", lambda o, d, a: g8.bvh_g8(
                nodes, tri, o, d, a)), ("kernel 5", lambda o, d, a: bx.bvh_walk(
                nodes, tri, o, d, a, leaf_width=g8.LEAF_WIDTH))):
            times[kname], _ = graph_ms(
                lambda: [f(o, d, a) for o, d, a in rs], 3, 5)
        n_r = sum(o.shape[0] for o, _, _ in rs)
        print(f"[13] (d) {rname} ({len(rs)} launches, {n_r} rays), leaf "
              f"128: G8 {times['G8']:.5f} ms a launch, kernel 5 "
              f"{times['kernel 5']:.5f} ms a launch (G8 / kernel 5 "
              f"{times['G8'] / times['kernel 5']:.3f})")
        out[rname] = times
    stats = {}
    for o, d, a in sweeps:
        bx.bvh_walk_plain(nodes, tri, o, d, a, leaf_width=g8.LEAF_WIDTH,
                          stats=stats)
    g_ms, _, _ = event_ms(lambda: [bx.bvh_walk_plain(
        nodes, tri, o, d, a, leaf_width=g8.LEAF_WIDTH)
        for o, d, a in sweeps], 1)
    n_calls = len(sweeps)
    n_rays = sum(o.shape[0] for o, _, _ in sweeps)
    g_bound, g_by = bound_ms(
        (stats["box_tests"] * SLAB_TEST_FLOPS
         + stats["tests"] * WOOP_TEST_FLOPS) / n_calls,
        (n_rays * 33 + n_calls * (nodes.numel() + tri.numel()) * 4) / n_calls)
    g_plain = g_ms / n_calls
    print(f"[13] (d) G8's plain version (kernel 5's plain walk, leaf 128) "
          f"{g_plain:.3f} ms a launch over phase 10's sweeps, bound "
          f"{g_bound:.5f} ms ({g_by})")
    return {"10": {"launches": launches, "max_abs_err": errs["10"],
                   "ms": k_ms, "plain_ms": p_ms, "bound_ms": q_bound,
                   "bound_by": q_by, "library_ms": None, "hd_ms": hd_ms,
                   "hd_bound_ms": hd_bound},
            "11": {"launches": g8_launches, "max_abs_err": errs["11"],
                   "ms": out["phase 10's wavefront sweeps"]["G8"],
                   "plain_ms": g_plain, "bound_ms": g_bound,
                   "bound_by": g_by, "library_ms": None}}


def _phase_options(tmp: Path, dev, card: str) -> dict:
    """Phase 14: every single-device render option and CLI flag on the
    card, each route launching kernel 2 or 5 (no fallback): (a)
    --normal-maps, (b) --checkpoint, (c) remat, (d) fold_samples. Returns
    kernel 2's time on the folded sweep and the routes' launches."""
    import dataclasses

    import torch

    from orion_tpu_torch import engine
    from orion_tpu_torch.io.checkpoint import load_checkpoint
    from orion_tpu_torch.ops import brute_intersect as bi
    from orion_tpu_torch.ops import bvh_intersect as bx
    from orion_tpu_torch.optim import make_loss
    from orion_tpu_torch.render import render

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def launches(fn):
        bi.KERNEL.launches = 0
        bx.KERNEL.launches = bx.ANY_HIT_KERNEL.launches = 0
        out = fn()
        return out, bi.KERNEL.launches, (bx.KERNEL.launches
                                         + bx.ANY_HIT_KERNEL.launches)

    def image_ok(name, img):
        check(np.isfinite(img).all() and img.mean() > 0, f"{name} image")

    def differs(name, a, b):
        off = float((np.abs(a - b) > 1e-4 + 1e-3 * np.abs(b)).any(
            axis=-1).mean())
        print(f"[14] {name}: pixels moved by the normal map {off:.4f}, "
              f"mean {a.mean():.6g} vs {b.mean():.6g} without")
        check(off > 0.05, f"{name}: the normal map moved {off} of pixels")

    counts = {}
    # (a) --normal-maps: the box with the normal map on every wall and box
    bump = write_cornell(tmp / "bump", depth=OPTIONS_HD["depth"], bump=True)
    (img_n, rep), b2, b5 = launches(lambda: run_cli(
        bump, tmp / "bump_n.hdr", OPTIONS_HD, extra=["--normal-maps"],
        report=True))
    print(f"[14] (a) --normal-maps {OPTIONS_HD}: backend {rep['backend']}, "
          f"{rep['render_seconds']} s, brute launches {b2}")
    check(rep["backend"] == "brute-kernel" and b2 > 0 and b5 == 0,
          f"--normal-maps took {rep['backend']}, brute launches {b2}")
    img_f = run_cli(bump, tmp / "bump_f.hdr", OPTIONS_HD, backend="brute")
    image_ok("--normal-maps 1080p", img_n)
    differs("(a) 1080p, the same wavefront", img_n, img_f)
    counts["normal maps 1080p (kernel 2)"] = b2
    bump5 = write_cornell(tmp / "bump5", depth=OPTIONS_SMALL["depth"],
                          levels=BIG_LEVELS, bump=True)
    (img_n, rep), b2, b5 = launches(lambda: run_cli(
        bump5, tmp / "bump5_n.hdr", OPTIONS_SMALL, backend="bvh",
        extra=["--normal-maps"], report=True))
    print(f"[14] (a) --backend bvh --normal-maps {OPTIONS_SMALL} on "
          f"{rep['triangles']} triangles: backend {rep['backend']}, "
          f"{rep['render_seconds']} s, walk launches {b5}")
    check(rep["backend"] == "bvh-kernel" and b5 > 0 and b2 == 0,
          f"--backend bvh --normal-maps: {rep['backend']}, walk {b5}")
    img_f = run_cli(bump5, tmp / "bump5_f.hdr", OPTIONS_SMALL, backend="bvh")
    image_ok("--backend bvh --normal-maps", img_n)
    differs("(a) 256x256 over the tree", img_n, img_f)
    counts["normal maps 256x256 (kernel 5)"] = b5
    # the kernel's image against the plain walk's on the card, one seed
    ps = engine.prepare(bump5, device=dev, force_backend="bvh", xres=256,
                        yres=256)
    cfg = dict(samples=2, max_depth=OPTIONS_SMALL["depth"],
               light_samples=OPTIONS_SMALL["light_samples"],
               normal_maps=True)
    with torch.no_grad():
        k, _, k5 = launches(lambda: render(ps.scene, ps.camera, gen(7),
                                           intersect=ps.intersect, **cfg))
        p = render(ps.scene, ps.camera, gen(7), intersect=plain_intersect(ps),
                   **cfg)
    check(k5 > 0, "the normal-mapped render never launched kernel 5")
    nmap_err = fused_agree("(a) normal maps 256x256 2 spp, kernel 5 vs the "
                           "plain walk", k, p)

    # (b) --checkpoint: 2 spp (one chunk of 2), then 4 (resumed), against
    # one chunk of 4
    ckpt = dict(OPTIONS_HD)
    rtc = write_cornell(tmp / "ckpt", depth=ckpt["depth"])
    ck, one = tmp / "resumed.ckpt", tmp / "oneshot.ckpt"
    t0 = time.perf_counter()
    _, c2, _ = launches(lambda: run_cli(
        rtc, tmp / "ck2.hdr", dict(ckpt, samples=2),
        extra=["--checkpoint", str(ck), "--checkpoint-every", "2"]))
    check(load_checkpoint(ck)[1] == 2, "the first run's checkpoint")
    _, c4, _ = launches(lambda: run_cli(
        rtc, tmp / "ck4.hdr", ckpt,
        extra=["--checkpoint", str(ck), "--checkpoint-every", "2"]))
    resumed_s = time.perf_counter() - t0
    _, c1, _ = launches(lambda: run_cli(
        rtc, tmp / "ck1.hdr", ckpt,
        extra=["--checkpoint", str(one), "--checkpoint-every", "4"]))
    a, b = load_checkpoint(ck), load_checkpoint(one)
    check(a[1] == b[1] == 4, f"samples done {a[1]}, {b[1]}")
    resumed, oneshot = a[0] / 4.0, b[0] / 4.0
    ck_err = float(np.abs(resumed - oneshot).max())
    print(f"[14] (b) --checkpoint {ckpt}: 2 spp then 4 resumed "
          f"({resumed_s:.2f} s with two CLI calls; brute launches {c2} + "
          f"{c4}) against one chunk of 4 ({c1} launches): max abs "
          f"{ck_err:.3g}, mean {resumed.mean():.6g}; config {a[4]}")
    check(c2 > 0 and c4 == c2 and c1 == c2 + c4,
          f"checkpoint launches {c2}, {c4}, {c1}")
    image_ok("--checkpoint", oneshot)
    check(np.allclose(resumed, oneshot, rtol=1e-5, atol=1e-6),
          f"resumed != one-shot (max abs {ck_err})")
    counts["checkpoint (kernel 2)"] = c2 + c4
    regen = dict(OPTIONS_SMALL, samples=4)
    (img_r, rep), r2, _ = launches(lambda: run_cli(
        rtc, tmp / "regen.hdr", regen, report=True,
        extra=["--regen", "--checkpoint", str(tmp / "regen.ckpt"),
               "--checkpoint-every", "2"]))
    rc = load_checkpoint(tmp / "regen.ckpt")
    print(f"[14] (b) --regen --checkpoint {regen}: backend {rep['backend']},"
          f" brute launches {r2}, samples done {rc[1]}, mean "
          f"{img_r.mean():.6g}")
    check(r2 > 0 and rc[1] == 4 and "regen=True" in rc[4], "regen checkpoint")
    image_ok("--regen --checkpoint", img_r)
    counts["regen checkpoint (kernel 2)"] = r2

    # (c) remat: one make_loss gradient, False / True / "hits"
    ps = engine.prepare(rtc, device=dev, xres=256, yres=256)
    check(ps.backend == "brute-kernel", f"remat backend {ps.backend}")
    with torch.no_grad():
        target = render(ps.scene, ps.camera, gen(1), intersect=ps.intersect,
                        **REMAT)
    res = {}
    torch.cuda.reset_peak_memory_stats(dev)
    for remat in (False, True, "hits"):
        params = {k: getattr(ps.scene, k).clone().requires_grad_(True)
                  for k in ("mat_diffuse", "tri_v0")}
        params["mat_diffuse"].data[1] *= 0.6
        loss_fn = make_loss(ps.scene, ps.camera, mode=None,
                            intersect=ps.intersect, remat=remat, **REMAT)
        t0 = time.perf_counter()
        loss, fwd, _ = launches(lambda: loss_fn(params, gen(3), target))
        bi.KERNEL.launches = 0
        loss.backward()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        res[remat] = (loss.detach(), params["mat_diffuse"].grad,
                      params["tri_v0"].grad, fwd, bi.KERNEL.launches)
        print(f"[14] (c) remat={remat!r} 256x256 {REMAT}: loss "
              f"{float(loss.detach()):.8g}, brute launches {fwd} forward, "
              f"{bi.KERNEL.launches} backward, {secs:.2f} s fwd+bwd, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        torch.cuda.reset_peak_memory_stats(dev)
    remat_err = 0.0
    for remat in (True, "hits"):
        check(res[remat][3] == res[False][3] > 0 and res[remat][4] == 0,
              f"remat={remat!r}: launches {res[remat][3:]} vs "
              f"{res[False][3:]}")
        for i, name in enumerate(("loss", "d mat_diffuse", "d tri_v0")):
            x, y = res[remat][i], res[False][i]
            scale = float(y.abs().max())
            err = float((x - y).abs().max())
            remat_err = max(remat_err, err / max(scale, 1e-30))
            check(scale > 0 and err <= 1e-6 * scale,
                  f"remat={remat!r} {name}: {err} > 1e-6 x {scale}")
    print(f"[14] (c) remat True and 'hits' against False: largest "
          f"difference {remat_err:.3g} of the largest entry")
    counts["remat (kernel 2)"] = res[False][3]

    # (d) fold_samples: the 16 samples as one wavefront of S*H*W rays
    sweeps = []

    def spy(sc, orig, dirs, *, alive=None):
        sweeps.append((orig.detach().float().contiguous().clone(),
                       dirs.detach().float().contiguous().clone(),
                       alive.contiguous().clone()))
        return ps.intersect(sc, orig, dirs, alive=alive)

    with torch.no_grad():
        (fold, f2, _) = launches(lambda: render(
            ps.scene, ps.camera, gen(5), intersect=spy, fold_samples=True,
            **FOLD))
        scan = render(ps.scene, ps.camera, gen(5), intersect=ps.intersect,
                      **FOLD)
    fold, scan = fold.cpu().numpy(), scan.cpu().numpy()
    rel = abs(fold.mean() - scan.mean()) / scan.mean()
    n_rays = FOLD["samples"] * 256 * 256
    nearest = sweeps[0::2]
    print(f"[14] (d) fold_samples 256x256 {FOLD}: brute launches {f2} "
          f"({len(nearest)} nearest sweeps of {nearest[0][0].shape[0]} rays"
          f", {len(sweeps) - len(nearest)} shadow sweeps of "
          f"{sweeps[1][0].shape[0]}); mean {fold.mean():.6g} vs the "
          f"per-sample loop's {scan.mean():.6g} (rel {rel:.3g})")
    image_ok("fold_samples", fold)
    check(f2 == len(sweeps) == 2 * (FOLD["max_depth"] + 1),
          f"fold launches {f2}, sweeps {len(sweeps)}")
    check(all(o.shape[0] == n_rays for o, _, _ in nearest),
          "a folded nearest sweep is not S*H*W rays")
    check(rel <= 0.025, f"fold mean rel {rel}")
    tab = bi.pack_tri_rows16(ps.scene)
    o, d, a = nearest[0]
    brute_equal("(d) the folded depth-0 sweep", bi.brute_sweep(tab, o, d, a),
                bi.brute_sweep_plain(tab, o, d, a))
    fold_ms, fold_times, _ = event_ms(lambda: bi.brute_sweep(tab, o, d, a),
                                      11)
    fold_bound, fold_by = brute_bound_ms(n_rays, int(a.sum()), tab.shape[0],
                                         1)
    print(f"[14] (d) kernel 2 on the folded depth-0 sweep ({n_rays} rays, "
          f"{tab.shape[0]} rows): {fold_ms:.5f} ms (CUDA-event median of "
          f"11 launches, {min(fold_times):.5f}-{max(fold_times):.5f}), "
          f"bound {fold_bound:.6f} ms ({fold_by}), on {card}")
    counts["fold (kernel 2)"] = f2
    print(f"[14] launches of kernels 2 and 5 on this phase's routes: "
          f"{json.dumps(counts)}")
    check(all(v > 0 for v in counts.values()), f"a route without launches: "
          f"{counts}")
    return {"fold_ms": fold_ms, "fold_bound_ms": fold_bound,
            "nmap_err": nmap_err, "launches": counts}



def _launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel number."""
    from orion_tpu_torch.ops import bounce as bo
    from orion_tpu_torch.ops import brute_intersect as bi
    from orion_tpu_torch.ops import bvh_intersect as bx
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.ops import bvh_whitted as bw
    from orion_tpu_torch.ops import fused_path as fp
    from orion_tpu_torch.ops import prb

    return {"1": fp.KERNEL, "2": bi.KERNEL, "3a": prb.FWD_KERNEL,
            "3b": prb.REPLAY_KERNEL, "5": bx.KERNEL, "5 any-hit":
            bx.ANY_HIT_KERNEL, "6a": bo.WALK_KERNEL, "6b": bo.VIS_KERNEL,
            "6c": bo.SHADE_KERNEL, "7a": bw.KERNEL, "8": bp.KERNEL}


def _digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def _generator(dev, seed: int):
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _shard_rank(rank: int, world: int, init: str, tmp: str,
                paths: dict) -> None:
    """One rank of phase 15 (b): joins the gloo group through `init`,
    drives cuda:0 (the one card, which every rank shares), writes its
    results to shard-<rank>.json (rank 0 also its images) under tmp."""
    import os
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = "0"      # every rank's device is card 0
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=SHARD_TIMEOUT))
    try:
        res = _shard_rank_work(rank, Path(tmp), paths)
        (Path(tmp) / f"shard-{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _shard_rank_work(rank: int, tmp: Path, paths: dict) -> dict:
    """Phase 15 (b) on one rank: each route's wall ms (its second run,
    synchronised; the all-gather included; a --shard route is the whole
    CLI call) and its launches, counted from 0 just before that run; the
    kernel-1 tile's ms and the all-gather's ms and bytes alone; the
    images' digests; the train steps' collectives and gradients."""
    import torch

    from orion_tpu_torch import cli
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import fused_path as fp
    from orion_tpu_torch.parallel import fused_shard as fs
    from orion_tpu_torch.parallel.distributed import (all_gather_rows,
                                                      measure_collective_bytes,
                                                      record_collectives)
    from orion_tpu_torch.parallel.sharding import (make_mesh,
                                                   make_train_step,
                                                   render_sharded)
    from orion_tpu_torch.render import render
    from orion_tpu_torch.scene import load_scene

    mesh = make_mesh()
    dev = mesh.device
    out = {"rank": mesh.rank, "world": mesh.world, "device": str(dev),
           "backend": torch.distributed.get_backend(), "routes": {}}
    counts = _launch_counts()

    def route(name, fn):
        fn()                    # warm: libraries loaded, tables packed
        for k in counts.values():
            k.launches = 0
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out["routes"][name] = {"ms": ms, "launches": {
            k: v.launches for k, v in counts.items() if v.launches}}
        return res

    # kernel 1, the main path
    cornell, rtc = load_scene(paths["cornell"], device=dev)
    cam = camera_from_rtc(_resized(rtc, MAIN), device=dev)
    cfg = dict(samples=MAIN["samples"], max_depth=MAIN["depth"],
               light_samples=MAIN["light_samples"])
    fused = fs.make_fused_render_sharded(cornell, cam, mesh=mesh, **cfg)
    img = route("fused 1080p (kernel 1)", lambda: fused(SHARD_SEED))
    out["fused_digest"] = _digest(img)
    N = MAIN["xres"] * MAIN["yres"]
    lo, hi = mesh.tile(N)
    out["tile"] = [lo, hi]
    args = fp.fused_args(cornell, cam)
    tile_ms, _, tile = event_ms(lambda: fp.fused_path(
        *args, SHARD_SEED, MAIN["xres"], MAIN["yres"], cfg["samples"],
        cfg["max_depth"], cfg["light_samples"], pix_base=lo,
        n_lanes=hi - lo), 3)
    all_gather_rows(tile, N, mesh)          # warm
    torch.cuda.synchronize()
    torch.distributed.barrier()
    with record_collectives() as log:
        t0 = time.perf_counter()
        all_gather_rows(tile, N, mesh)
        torch.cuda.synchronize()
        gather_ms = (time.perf_counter() - t0) * 1e3
    out.update(tile_ms=tile_ms, gather_ms=gather_ms,
               gather_bytes=sum(b for _, b in log))

    # the levels-5 box: kernel 8, the bounce pipeline, 7a
    box, brtc = load_scene(paths["box"], device=dev)
    bcam = camera_from_rtc(_resized(brtc, SHARD_BOX), device=dev)
    bcfg = dict(samples=SHARD_BOX["samples"], max_depth=SHARD_BOX["depth"],
                light_samples=SHARD_BOX["light_samples"])
    bvh_path = fs.make_bvh_render_sharded(box, bcam, mode="path", mesh=mesh,
                                          **bcfg)
    img = route("bvh path 256x256 (kernel 8)", lambda: bvh_path(SHARD_SEED))
    out["bvh_path_digest"] = _digest(img)
    bounce = fs.make_bounce_render_sharded(box, bcam, mesh=mesh, **bcfg)
    img = route("bounce 256x256 (6a, 6c)", lambda: bounce(SHARD_SEED))
    out["bounce_digest"] = _digest(img)
    if rank == 0:
        np.save(tmp / "shard_bounce.npy", img.cpu().numpy())
    wbox, wrtc = load_scene(paths["whitted_box"], device=dev)
    wcam = camera_from_rtc(_resized(wrtc, SHARD_WHITTED), device=dev)
    whitted = fs.make_bvh_render_sharded(
        wbox, wcam, mode="whitted", mesh=mesh,
        samples=SHARD_WHITTED["samples"], max_depth=SHARD_WHITTED["depth"])
    img = route("bvh whitted 256x256 (7a)", lambda: whitted(SHARD_SEED))
    out["bvh_whitted_digest"] = _digest(img)

    # the --shard CLI: Cornell at 1080p on kernel 2, the box over kernel 5
    def shard_cli(rtc_file, name, c, extra=()):
        argv = [str(rtc_file), "-o", str(tmp / f"{name}-{rank}.hdr"), "-p",
                str(c["samples"]), "-l", str(c["light_samples"]), "--depth",
                str(c["depth"]), "--xres", str(c["xres"]), "--yres",
                str(c["yres"]), "--shard", *extra]
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            check(cli.main(argv) == 0, f"--shard {name} on rank {rank}")

    route("--shard 1080p (kernel 2)",
          lambda: shard_cli(paths["cornell"], "cli", MAIN))
    route("--shard --backend bvh 256x256 (kernel 5)",
          lambda: shard_cli(paths["box"], "cli_bvh", SHARD_ONE,
                            ["--backend", "bvh"]))
    route("--shard --regen 256x256 (kernel 2)",
          lambda: shard_cli(paths["cornell"], "cli_regen", SHARD_ONE,
                            ["--regen"]))
    runs = []            # a checkpoint file a run: the timed one starts anew

    def checkpointed():
        runs.append(tmp / f"shard-{len(runs)}.ckpt")
        shard_cli(paths["cornell"], "cli_ck", SHARD_ONE,
                  ["--checkpoint", str(runs[-1]), "--checkpoint-every", "2"])

    route("--shard --checkpoint 256x256 (kernel 2)", checkpointed)
    out["checkpoint"] = str(runs[-1])

    # the global stream: render_sharded and make_train_step on kernel 2
    ps1 = prepare(paths["cornell"], device=dev, xres=SHARD_ONE["xres"],
                  yres=SHARD_ONE["yres"])
    ocfg = dict(samples=SHARD_ONE["samples"], max_depth=SHARD_ONE["depth"],
                light_samples=SHARD_ONE["light_samples"])
    with torch.no_grad():
        img = route("render_sharded 256x256 (kernel 2)",
                    lambda: render_sharded(ps1.scene, ps1.camera,
                                           _generator(dev, 5), mesh=mesh,
                                           **ocfg))
        target = render(ps1.scene, ps1.camera, _generator(dev, 9),
                        samples=1, max_depth=2, light_samples=1)
    out["render_sharded_digest"] = _digest(img)
    if rank == 0:
        np.save(tmp / "shard_render_sharded.npy", img.cpu().numpy())
    step = make_train_step(ps1.scene, ps1.camera, samples=1, max_depth=2,
                           light_samples=1, lr=1.0, mesh=mesh)
    params = {"mat_diffuse": ps1.scene.mat_diffuse * 0.5}
    new, loss = route("make_train_step 256x256 (kernel 2)",
                      lambda: step(params, _generator(dev, 2), target))
    out["train_step"] = {
        "loss": float(loss),
        "coll": measure_collective_bytes(step, params, _generator(dev, 2),
                                         target),
        "kd": (params["mat_diffuse"] - new["mat_diffuse"]).tolist()}

    # the sharded train steps: one all-reduce each
    tcam = camera_from_rtc(_resized(parse_rtc(paths["cornell"]), TRAIN),
                           device=dev)
    tcfg = dict(samples=TRAIN["samples"], max_depth=TRAIN["depth"],
                light_samples=TRAIN["light_samples"])
    target = torch.from_numpy(np.load(paths["train_target"])).to(dev)
    params = {"mat_diffuse": cornell.mat_diffuse * 0.8,
              "mat_emissive": cornell.mat_emissive}
    step = fs.make_fused_train_step_sharded(cornell, tcam, target, mesh=mesh,
                                            **tcfg)
    loss, g = route("fused train step 1080p (3a, 3b)",
                    lambda: step(params, 3))
    coll = measure_collective_bytes(step, params, 3)
    out["fused_train"] = {"loss": float(loss), "coll": coll,
                          "kd": g["mat_diffuse"].tolist(),
                          "ke": g["mat_emissive"].tolist()}
    btcam = camera_from_rtc(_resized(parse_rtc(paths["box"]),
                                     SHARD_BOX_TRAIN), device=dev)
    btarget = torch.from_numpy(np.load(paths["box_target"])).to(dev)
    bstep = fs.make_bounce_train_step_sharded(
        box, btcam, btarget, mesh=mesh, samples=SHARD_BOX_TRAIN["samples"],
        max_depth=SHARD_BOX_TRAIN["depth"],
        light_samples=SHARD_BOX_TRAIN["light_samples"])
    loss, g = route("bounce train step 256x256 (6a, 6c)", lambda: bstep(3))
    coll = measure_collective_bytes(bstep, 3)
    out["bounce_train"] = {"loss": float(loss), "coll": coll,
                           "kd": g["mat_diffuse"].tolist(),
                           "ke": g["mat_emissive"].tolist()}
    return out


def _phase_shard(tmp: Path, dev, card: str, cornell, rtc_path: Path,
                 big_rtc: Path, cam64) -> None:
    """Phase 15: ray sharding (parallel/) on the card: (a) kernel 1, 3a and
    3b on pixel tiles at full width and at 64x64 against plain, (c) a
    world of one on NCCL, (b) two ranks spawned on the one card over gloo.
    Raises on any failure, a rank's included."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops import bounce as bo
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.ops import bvh_whitted as bw
    from orion_tpu_torch.ops import fused_path as fp
    from orion_tpu_torch.ops import prb
    from orion_tpu_torch.ops.bounce_prb import make_bounce_train_step
    from orion_tpu_torch.parallel.distributed import measure_collective_bytes
    from orion_tpu_torch.io.checkpoint import load_checkpoint
    from orion_tpu_torch.io.image import load_hdr
    from orion_tpu_torch.parallel.sharding import (Mesh, make_mesh,
                                                   make_train_step,
                                                   render_sharded)
    from orion_tpu_torch.parallel.shardmap_render import (
        make_train_step_shardmap, render_shardmap)
    from orion_tpu_torch.regen import render_regen, render_regen_shardmap
    from orion_tpu_torch.render import render
    from orion_tpu_torch.scene import load_scene

    print("[15] one card: ranks that share it share its SMs, so no "
          "multi-GPU scaling figure can be measured here")

    def tiles(n, world):
        return [Mesh(None, r, world, dev).tile(n) for r in range(world)]

    # (a) kernel 1 on 2- and 3-way tiles of the main path
    W, H = MAIN["xres"], MAIN["yres"]
    N = W * H
    cam = camera_from_rtc(_resized(parse_rtc(rtc_path), MAIN), device=dev)
    args = fp.fused_args(cornell, cam)
    cfg = (W, H, MAIN["samples"], MAIN["depth"], MAIN["light_samples"])
    whole_ms, _, whole = event_ms(
        lambda: fp.fused_path(*args, SHARD_SEED, *cfg), 3)
    for world in (2, 3):
        parts, times = [], []
        for lo, hi in tiles(N, world):
            ms, _, t = event_ms(lambda: fp.fused_path(
                *args, SHARD_SEED, *cfg, pix_base=lo, n_lanes=hi - lo), 3)
            parts.append(t)
            times.append(ms)
        check(torch.equal(torch.cat(parts), whole),
              f"kernel 1's {world} tiles differ from the whole image")
        print(f"[15] (a) kernel 1, {world} tiles of {MAIN}: bit for bit the "
              f"whole image ({whole_ms:.3f} ms); tile ms "
              f"{', '.join(f'{x:.3f}' for x in times)} (CUDA-event medians "
              f"of 3, one card)")
    # what render_sharded's global stream costs a rank: a path bounce's
    # uniforms for the whole wavefront (then sliced), not its tile's
    from orion_tpu_torch.render import _path_draws

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    LS = MAIN["light_samples"]
    whole_draws, _, _ = event_ms(lambda: _path_draws(cornell, g, LS, N, dev),
                                 5)
    half_draws, _, _ = event_ms(
        lambda: _path_draws(cornell, g, LS, N // 2, dev), 5)
    print(f"[15] (a) render_sharded's draws a path bounce at {W}x{H} "
          f"({3 * LS * cornell.num_emissive + 3} uniforms a ray): the "
          f"whole wavefront's {whole_draws:.4f} ms on every rank, against "
          f"{half_draws:.4f} ms for a half-image tile's own (CUDA-event "
          f"medians of 5)")
    # 3a / 3b on 2 and 3 tiles of the 1080p 4 spp train problem
    tW, tH = TRAIN["xres"], TRAIN["yres"]
    tN = tW * tH
    tcam = camera_from_rtc(_resized(parse_rtc(rtc_path), TRAIN), device=dev)
    targs = fp.fused_args(cornell, tcam)
    tcfg = (tW, tH, TRAIN["samples"], TRAIN["depth"], TRAIN["light_samples"])
    img, ls = prb.fused_fwd_ls(*targs, 3, *tcfg)
    w = _cotangent(img, TRAIN["samples"], 5)
    g = prb.prb_replay(*targs, 3, w, ls, *tcfg)
    for world in (2, 3):
        g_sum = torch.zeros_like(g)
        for lo, hi in tiles(tN, world):
            kw = dict(pix_base=lo, n_lanes=hi - lo)
            i, l = prb.fused_fwd_ls(*targs, 3, *tcfg, **kw)
            check(torch.equal(i, img[lo:hi]) and torch.equal(l, ls[lo:hi]),
                  f"3a's tile [{lo}, {hi}) differs from the whole step's")
            g_sum += prb.prb_replay(*targs, 3, w[lo:hi].contiguous(), l,
                                    *tcfg, **kw)
        err = float((g_sum - g).abs().max() / g.abs().max())
        print(f"[15] (a) 3a/3b, {world} tiles of {TRAIN}: 3a's rows and "
              f"planes bit for bit the whole step's; 3b's tile gradients "
              f"summed against the whole image's: {err:.3g} of the largest "
              f"entry")
        check(err <= 1e-5, f"3b tiles: {err}")
    del ls
    # 64x64 tiles against the plain versions' tiles
    args64 = fp.fused_args(cornell, cam64)
    cfg64 = (64, 64, 4, 4, 2)
    for lo, hi in tiles(64 * 64, 3):
        kw = dict(pix_base=lo, n_lanes=hi - lo)
        fused_agree(f"(a) kernel 1 tile [{lo}, {hi}) 64x64",
                    fp.fused_path(*args64, 1234, *cfg64, **kw),
                    fp.fused_path_plain(*args64, 1234, *cfg64, **kw))
        i, l = prb.fused_fwd_ls(*args64, 1234, *cfg64, **kw)
        ip, lp = fp.fused_fwd_ls_plain(*args64, 1234, *cfg64, **kw)
        fused_agree(f"(a) 3a tile [{lo}, {hi}) 64x64", i, ip)
        fused_agree(f"(a) 3a L_s tile [{lo}, {hi}) 64x64", l, lp)
        wt = _cotangent(ip, 4, 7)
        grad_agree(f"(a) 3b tile [{lo}, {hi}) 64x64",
                   prb.prb_replay(*args64, 1234, wt, l, *cfg64, **kw),
                   prb.prb_replay_plain(*args64, 1234, wt, lp, *cfg64, **kw))

    # (c) a world of one on NCCL
    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl-one",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()
        ps = prepare(rtc_path, device=mesh.device, xres=SHARD_ONE["xres"],
                     yres=SHARD_ONE["yres"])
        ocfg = dict(samples=SHARD_ONE["samples"],
                    max_depth=SHARD_ONE["depth"],
                    light_samples=SHARD_ONE["light_samples"])
        counts = _launch_counts()
        counts["2"].launches = 0
        got = []
        with torch.no_grad():
            t0 = time.perf_counter()
            rep = measure_collective_bytes(lambda: got.append(render_shardmap(
                ps.scene, ps.camera, gen(3), mesh=mesh,
                intersect=ps.intersect, **ocfg)))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launched = counts["2"].launches
            ref = render(ps.scene, ps.camera, gen(3), intersect=ps.intersect,
                         **ocfg)
        check(launched > 0 and rep["ops"] == 1, f"NCCL render_shardmap: "
              f"{launched} launches, {rep}")
        check(torch.equal(got[0], ref), "the world of one != render")
        with torch.no_grad():
            one = render_sharded(ps.scene, ps.camera, gen(3), mesh=mesh,
                                 **ocfg)
        check(torch.equal(one, ref), "render_sharded (world of one) != "
              "render")
        regen = render_regen_shardmap(ps.scene, ps.camera, gen(4),
                                      mesh=mesh, intersect=ps.intersect,
                                      **ocfg)
        check(torch.equal(regen, render_regen(
            ps.scene, ps.camera, gen(4), intersect=ps.intersect, **ocfg)),
            "render_regen_shardmap (world of one) != render_regen")
        step = make_train_step_shardmap(ps.scene, ps.camera, mesh, samples=1,
                                        max_depth=2, light_samples=1,
                                        intersect=ps.intersect)
        srep = measure_collective_bytes(
            step, {"mat_diffuse": ps.scene.mat_diffuse * 0.5}, gen(1), ref)
        check(srep["ops"] == 1, f"NCCL train step collectives {srep}")
        print(f"[15] (c) NCCL world of one {SHARD_ONE}: render_shardmap "
              f"{ms:.1f} ms, kernel 2 launches {launched}, collectives "
              f"{json.dumps(rep)}, equal to render (and render_sharded's "
              f"image too; render_regen_shardmap's equal to render_regen);"
              f" make_train_step_shardmap collectives {json.dumps(srep)}")
    finally:
        dist.destroy_process_group()

    # (b) the single-device references, then two ranks on the one card
    box, brtc = load_scene(big_rtc, device=dev)
    bcam = camera_from_rtc(_resized(brtc, SHARD_BOX), device=dev)
    bcfg = dict(samples=SHARD_BOX["samples"], max_depth=SHARD_BOX["depth"],
                light_samples=SHARD_BOX["light_samples"])
    ref_path = bp.make_bvh_path_renderer(box, bcam, **bcfg)(SHARD_SEED)
    ref_bounce = bo.make_bounce_path_renderer(box, bcam, **bcfg)(SHARD_SEED)
    wbox_rtc = write_cornell_whitted(tmp / "shard_whitted", xres=64,
                                     yres=64, depth=SHARD_WHITTED["depth"],
                                     levels=BIG_LEVELS)
    wbox, wrtc = load_scene(wbox_rtc, device=dev)
    ref_whitted = bw.make_bvh_whitted_renderer(
        wbox, camera_from_rtc(_resized(wrtc, SHARD_WHITTED), device=dev),
        samples=SHARD_WHITTED["samples"],
        max_depth=SHARD_WHITTED["depth"])(SHARD_SEED)
    # the train problems: each target is the true scene's image; the
    # ranks' 3a/3b step runs at the albedos x 0.8, their bounce step at the
    # true box against another seed's image
    target = fp.make_fused_path_renderer(
        cornell, tcam, samples=TRAIN["samples"], max_depth=TRAIN["depth"],
        light_samples=TRAIN["light_samples"])(3)
    np.save(tmp / "shard_target.npy", target.cpu().numpy())
    btcam = camera_from_rtc(_resized(parse_rtc(big_rtc), SHARD_BOX_TRAIN),
                            device=dev)
    btcfg = dict(samples=SHARD_BOX_TRAIN["samples"],
                 max_depth=SHARD_BOX_TRAIN["depth"],
                 light_samples=SHARD_BOX_TRAIN["light_samples"])
    btarget = bo.make_bounce_path_renderer(box, btcam, **btcfg)(4)
    np.save(tmp / "shard_box_target.npy", btarget.cpu().numpy())
    params = {"mat_diffuse": cornell.mat_diffuse * 0.8,
              "mat_emissive": cornell.mat_emissive}
    ref_ft = prb.make_fused_train_step(cornell, tcam, target,
                                       dynamic_params=True,
                                       samples=TRAIN["samples"],
                                       max_depth=TRAIN["depth"],
                                       light_samples=TRAIN["light_samples"]
                                       )(params, 3)
    ref_bt = make_bounce_train_step(box, btcam, btarget, **btcfg)(3)

    ps1 = prepare(rtc_path, device=dev, xres=SHARD_ONE["xres"],
                  yres=SHARD_ONE["yres"])
    ocfg = dict(samples=SHARD_ONE["samples"], max_depth=SHARD_ONE["depth"],
                light_samples=SHARD_ONE["light_samples"])
    with torch.no_grad():
        ref_render = render(ps1.scene, ps1.camera, gen(5), **ocfg)
        target1 = render(ps1.scene, ps1.camera, gen(9), samples=1,
                         max_depth=2, light_samples=1)
    kd1 = ps1.scene.mat_diffuse * 0.5
    new1, loss1 = make_train_step(ps1.scene, ps1.camera, samples=1,
                                  max_depth=2, light_samples=1, lr=1.0)(
        {"mat_diffuse": kd1}, gen(2), target1)
    ref_step = (loss1, {"mat_diffuse": kd1 - new1["mat_diffuse"]})

    paths = {"cornell": str(rtc_path), "box": str(big_rtc),
             "whitted_box": str(wbox_rtc),
             "train_target": str(tmp / "shard_target.npy"),
             "box_target": str(tmp / "shard_box_target.npy")}
    init = tmp / "shard-gloo.init"
    t0 = time.perf_counter()
    ctx = mp.start_processes(_shard_rank, args=(SHARD_WORLD, str(init),
                                                str(tmp), paths),
                             nprocs=SHARD_WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SHARD_TIMEOUT
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            check(time.monotonic() < deadline,
                  f"phase 15 ranks still running after {SHARD_TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    codes = [proc.exitcode for proc in ctx.processes]
    check(codes == [0] * SHARD_WORLD, f"phase 15 rank exit codes {codes}")
    secs = time.perf_counter() - t0
    ranks = [json.loads((tmp / f"shard-{r}.json").read_text())
             for r in range(SHARD_WORLD)]
    print(f"[15] (b) {SHARD_WORLD} ranks on {ranks[0]['device']} ({card}), "
          f"backend {ranks[0]['backend']} over CUDA tensors (staged "
          f"through the host; NCCL refuses two ranks on one device), "
          f"spawned and joined in {secs:.1f} s, exit codes {codes}")
    for r in ranks:
        print(f"[15] (b) rank {r['rank']}: tile {r['tile']} of the 1080p "
              f"image; kernel 1 on it {r['tile_ms']:.3f} ms (CUDA-event "
              f"median of 3, beside the other rank's launches); the "
              f"all-gather alone {r['gather_ms']:.3f} ms for "
              f"{r['gather_bytes']} bytes")
        for name, v in r["routes"].items():
            print(f"[15] (b) rank {r['rank']} {name}: {v['ms']:.1f} ms "
                  f"(the second run, synchronised, all-gather included), "
                  f"launches {json.dumps(v['launches'])}")
    want = {"fused 1080p (kernel 1)": "1",
            "bvh path 256x256 (kernel 8)": "8",
            "bounce 256x256 (6a, 6c)": "6c",
            "bvh whitted 256x256 (7a)": "7a",
            "--shard 1080p (kernel 2)": "2",
            "--shard --backend bvh 256x256 (kernel 5)": "5",
            "fused train step 1080p (3a, 3b)": "3b",
            "bounce train step 256x256 (6a, 6c)": "6c",
            "--shard --regen 256x256 (kernel 2)": "2",
            "--shard --checkpoint 256x256 (kernel 2)": "2",
            "render_sharded 256x256 (kernel 2)": "2",
            "make_train_step 256x256 (kernel 2)": "2"}
    for r in ranks:
        for name, k in want.items():
            check(r["routes"][name]["launches"].get(k, 0) > 0,
                  f"rank {r['rank']} {name}: kernel {k} never launched")
        check(r["fused_digest"] == _digest(whole),
              f"rank {r['rank']}: the sharded kernel-1 image differs")
        check(r["bvh_path_digest"] == _digest(ref_path),
              f"rank {r['rank']}: the sharded kernel-8 image differs")
        check(r["bvh_whitted_digest"] == _digest(ref_whitted),
              f"rank {r['rank']}: the sharded 7a image differs")
        for name, ref, n_floats in (
                ("fused_train", ref_ft, 6 * prb.M_LANES),
                ("bounce_train", ref_bt, 8 * prb.M_LANES + 3),
                ("train_step", ref_step, cornell.mat_diffuse.numel())):
            coll = r[name]["coll"]
            check(coll["ops"] == 1 and coll["by_kind"]["all-reduce"]
                  == 4 * (1 + n_floats), f"{name} collectives {coll}")
            for k in ("kd", "ke")[:1 if name == "train_step" else 2]:
                field = {"kd": "mat_diffuse", "ke": "mat_emissive"}[k]
                grad_agree(f"(b) rank {r['rank']} {name} {field}",
                           torch.tensor(r[name][k]), ref[1][field].cpu())
            rel = abs(r[name]["loss"] - float(ref[0])) / float(ref[0])
            print(f"[15] (b) rank {r['rank']} {name}: one all-reduce of "
                  f"{coll['bytes_per_call']} bytes, loss rel {rel:.3g} of "
                  f"the single-device step's")
            check(rel <= 1e-5, f"{name} loss rel {rel}")
    same = ranks[0]["bounce_digest"] == _digest(ref_bounce)
    fused_agree("(b) sharded bounce pipeline 256x256 vs one device",
                torch.from_numpy(np.load(tmp / "shard_bounce.npy")).reshape(
                    -1, 3), ref_bounce.reshape(-1, 3))
    print(f"[15] (b) the sharded kernel-1, kernel-8 and 7a images are the "
          f"single-device images bit for bit (digests "
          f"{ranks[0]['fused_digest']}, {ranks[0]['bvh_path_digest']}, "
          f"{ranks[0]['bvh_whitted_digest']}); the bounce pipeline's "
          f"{'bit for bit too' if same else 'within fused_agree'}")
    same = ranks[0]["render_sharded_digest"] == _digest(ref_render)
    fused_agree("(b) render_sharded 256x256 vs one device's render",
                torch.from_numpy(np.load(tmp / "shard_render_sharded.npy"))
                .reshape(-1, 3), ref_render.reshape(-1, 3))
    print(f"[15] (b) render_sharded's image (the global stream, two ranks) "
          f"{'is' if same else 'is not'} one device's render bit for bit")
    for name, shape in (("cli", (H, W, 3)), ("cli_regen", None),
                        ("cli_ck", None)):
        check((tmp / f"{name}-0.hdr").exists()
              and not (tmp / f"{name}-1.hdr").exists(),
              f"--shard {name}: rank 0 alone writes the image")
        img = load_hdr(tmp / f"{name}-0.hdr")
        check((shape is None or img.shape == shape)
              and np.isfinite(img).all() and img.mean() > 0,
              f"--shard {name} image")
    ck = load_checkpoint(ranks[0]["checkpoint"])
    check(ck is not None and ck[1] == SHARD_ONE["samples"]
          and "world=2" in ck[4], f"--shard --checkpoint file: {ck and ck[1:]}")
    print(f"[15] (b) --shard, --shard --regen and --shard --checkpoint: rank "
          f"0 alone wrote each image; the checkpoint holds {ck[1]} samples, "
          f"config {ck[4]}")


def _slice_counts() -> dict:
    """The launch counts phase 16 reads: kernels 1, 2, 4, 5 (nearest and
    any hit), 7a, 7b and 8."""
    from orion_tpu_torch.ops import brute_intersect as bi
    from orion_tpu_torch.ops import bvh_intersect as bx
    from orion_tpu_torch.ops import bvh_path as bp
    from orion_tpu_torch.ops import bvh_whitted as bw
    from orion_tpu_torch.ops import fused_path as fp
    from orion_tpu_torch.ops import whitted as wh

    return {"1": fp.KERNEL, "2": bi.KERNEL, "4": wh.KERNEL, "5": bx.KERNEL,
            "5 any-hit": bx.ANY_HIT_KERNEL, "7a": bw.KERNEL,
            "7b": bw.DEFERRED_KERNEL, "8": bp.KERNEL}


def _zero(counts: dict) -> None:
    for k in counts.values():
        k.launches = 0


def _read(counts: dict) -> dict:
    return {k: v.launches for k, v in counts.items() if v.launches}


def _sync_ms(fn):
    """(wall ms, result) of one synchronised call of `fn`."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _intersect_calls(cfg: dict) -> int:
    """Intersect calls of a wavefront render: each of the depth + 1
    bounces of each sample makes a nearest call and one shadow call (the
    stacked NEE rays, or the one light's shadow rays)."""
    return 2 * (cfg["depth"] + 1) * cfg["samples"]


def _slice_rank(rank: int, world: int, init: str, tmp: str,
                paths: dict) -> None:
    """One rank of phase 16 (a) and (d): joins the gloo group through
    `init`, drives cuda:0, writes its results to slice-<rank>.json (rank 0
    also render_multihost's image) under tmp."""
    import os
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = "0"      # every rank's device is card 0
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=SHARD_TIMEOUT))
    try:
        res = _slice_rank_work(rank, Path(tmp), paths)
        (Path(tmp) / f"slice-{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _slice_rank_work(rank: int, tmp: Path, paths: dict) -> dict:
    """Phase 16 (a) and (d) on one rank: render_tp on the (1, 2) mesh (each
    case warmed, then timed with its launches and all-gathers counted from
    0), one all-gather of a 1080p sweep's buffer alone, and
    render_multihost of the main path's Cornell box."""
    import torch

    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.parallel.distributed import (all_gather_rows,
                                                      record_collectives,
                                                      render_multihost)
    from orion_tpu_torch.parallel.primitive_sharding import (make_mesh_2d,
                                                             render_tp)
    from orion_tpu_torch.scene import load_scene

    ray, tp = make_mesh_2d(1, 2)
    dev = tp.device
    out = {"rank": rank, "place": [ray.rank, ray.world, tp.rank, tp.world],
           "device": str(dev), "backend": torch.distributed.get_backend(),
           "tp": {}}
    counts = _slice_counts()
    for name, key, cfg, mode in (
            ("whitted 1080p", "whitted", TP_WHITTED, "whitted"),
            ("path 1080p", "cornell", TP_PATH, "path"),
            (f"levels-{BIG_LEVELS} box 256x256", "box", TP_BOX, "path")):
        sc, rtc = load_scene(paths[key], device=dev)
        cam = camera_from_rtc(_resized(rtc, cfg), device=dev)

        def run():
            return render_tp(sc, cam, _generator(dev, SLICE_SEED),
                             mesh=(ray, tp), samples=cfg["samples"],
                             max_depth=cfg["depth"],
                             light_samples=cfg["light_samples"], mode=mode)

        with torch.no_grad():
            run()                                   # warm
            _zero(counts)
            torch.distributed.barrier()
            with record_collectives() as log:
                ms, img = _sync_ms(run)
        out["tp"][name] = {
            "ms": ms, "launches": _read(counts), "digest": _digest(img),
            "gathers": sum(1 for k, _ in log if k == "all-gather"),
            "gather_bytes": sum(b for k, b in log if k == "all-gather")}
    # one all-gather of a 1080p sweep's [N, 2] int32 buffer alone
    N = TP_WHITTED["xres"] * TP_WHITTED["yres"]
    buf = torch.zeros((N, 2), dtype=torch.int32, device=dev)
    all_gather_rows(buf, 2 * N, tp)                 # warm
    torch.distributed.barrier()
    with record_collectives() as log:
        ms, _ = _sync_ms(lambda: all_gather_rows(buf, 2 * N, tp))
    out.update(gather_ms=ms, gather_bytes=sum(b for _, b in log))

    # (d) render_multihost: half the samples a rank, one all-gather
    sc, rtc = load_scene(paths["cornell"], device=dev)
    cam = camera_from_rtc(_resized(rtc, MULTIHOST), device=dev)
    with torch.no_grad():
        _zero(counts)
        torch.distributed.barrier()
        with record_collectives() as log:
            ms, img = _sync_ms(lambda: render_multihost(
                sc, cam, _generator(dev, SLICE_SEED),
                samples=MULTIHOST["samples"], max_depth=MULTIHOST["depth"],
                light_samples=MULTIHOST["light_samples"]))
    out["multihost"] = {"ms": ms, "launches": _read(counts),
                        "digest": _digest(img), "collectives": len(log),
                        "bytes": sum(b for _, b in log)}
    if rank == 0:
        np.save(tmp / "slice_multihost.npy", img.cpu().numpy())
    return out


def _fly(rtc_path: Path, cfg: dict, dev):
    """A camera flown from the rtc's, at cfg's resolution (the viewer's
    keys: forward, strafe, yaw, pitch, zoom)."""
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.viewer import TURN, FlyCamera

    rtc = _resized(parse_rtc(rtc_path), cfg)
    cam = FlyCamera.from_rtc(rtc)
    cam.move(forward=1, strafe=0.5)
    cam.turn(dyaw=TURN * 2, dpitch=-TURN)
    cam.zoom(3.0)
    return camera_from_rtc(cam.apply_to_rtc(rtc), device=dev)


def _phase_slice17(tmp: Path, dev, card: str, rtc_path: Path, big_rtc: Path,
                   wrtc: Path) -> dict:
    """Phase 16: the last modules of the port on the card. (a) primitive
    sharding on two gloo ranks on the one card, (b) treelets over kernel
    5, (c) the viewer on the five megakernel routes, (d) render_multihost
    (an NCCL world of one, and the two ranks of (a)), (e) the example
    ports. Returns this phase's launches by kernel. Raises on any
    failure, a rank's included."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from orion_tpu_torch import engine, viewer
    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.ops.brute_intersect import intersect_brute_kernel
    from orion_tpu_torch.parallel.distributed import render_multihost
    from orion_tpu_torch.render import render
    from orion_tpu_torch.scene import load_scene

    counts = _slice_counts()
    launches = {k: 0 for k in counts}

    def add(got: dict) -> None:
        for k, v in got.items():
            launches[k] += v

    print("[16] one card: ranks that share it share its SMs, so no "
          "multi-GPU scaling or NVLink figure can be measured here")
    wbox_rtc = write_cornell_whitted(tmp / "p16_wbox", xres=64, yres=64,
                                     depth=4, levels=BIG_LEVELS)
    tex_rtc = write_cornell_whitted(tmp / "p16_tex", xres=64, yres=64,
                                    depth=4, checker=True)

    # (d) an NCCL world of one: render_multihost is render
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl-p16",
                            rank=0, world_size=1)
    try:
        ps = prepare(rtc_path, device=dev, xres=SHARD_ONE["xres"],
                     yres=SHARD_ONE["yres"])
        ocfg = dict(samples=SHARD_ONE["samples"],
                    max_depth=SHARD_ONE["depth"],
                    light_samples=SHARD_ONE["light_samples"],
                    intersect=ps.intersect)
        with torch.no_grad():
            one = render_multihost(ps.scene, ps.camera,
                                   _generator(dev, SLICE_SEED), **ocfg)
            ref = render(ps.scene, ps.camera, _generator(dev, SLICE_SEED),
                         **ocfg)
        check(torch.equal(one, ref), "render_multihost (NCCL world of one) "
              "!= render")
        print(f"[16] (d) NCCL world of one {SHARD_ONE}: render_multihost "
              f"equal to render bit for bit")
    finally:
        dist.destroy_process_group()

    # (a, d) the single-device references, then two ranks on the one card
    refs = {}
    for name, path, cfg, mode in (
            ("whitted 1080p", wrtc, TP_WHITTED, "whitted"),
            ("path 1080p", rtc_path, TP_PATH, "path"),
            (f"levels-{BIG_LEVELS} box 256x256", big_rtc, TP_BOX, "path")):
        sc, rtc = load_scene(path, device=dev)
        cam = camera_from_rtc(_resized(rtc, cfg), device=dev)
        with torch.no_grad():
            refs[name] = _digest(render(
                sc, cam, _generator(dev, SLICE_SEED), samples=cfg["samples"],
                max_depth=cfg["depth"], light_samples=cfg["light_samples"],
                mode=mode, intersect=intersect_brute_kernel))
    sc, rtc = load_scene(rtc_path, device=dev)
    mcam = camera_from_rtc(_resized(rtc, MULTIHOST), device=dev)
    with torch.no_grad():
        mh_ms, mh_ref = _sync_ms(lambda: render(
            sc, mcam, _generator(dev, SLICE_SEED),
            samples=MULTIHOST["samples"], max_depth=MULTIHOST["depth"],
            light_samples=MULTIHOST["light_samples"]))
    paths = {"cornell": str(rtc_path), "whitted": str(wrtc),
             "box": str(big_rtc)}
    init = tmp / "slice-gloo.init"
    t0 = time.perf_counter()
    ctx = mp.start_processes(_slice_rank, args=(SHARD_WORLD, str(init),
                                                str(tmp), paths),
                             nprocs=SHARD_WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SHARD_TIMEOUT
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            check(time.monotonic() < deadline,
                  f"phase 16 ranks still running after {SHARD_TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    codes = [proc.exitcode for proc in ctx.processes]
    check(codes == [0] * SHARD_WORLD, f"phase 16 rank exit codes {codes}")
    secs = time.perf_counter() - t0
    ranks = [json.loads((tmp / f"slice-{r}.json").read_text())
             for r in range(SHARD_WORLD)]
    print(f"[16] (a) {SHARD_WORLD} ranks on {ranks[0]['device']} ({card}), "
          f"backend {ranks[0]['backend']} over CUDA tensors (staged through "
          f"the host), a (1, 2) mesh: spawned and joined in {secs:.1f} s, "
          f"exit codes {codes}")
    cfgs = {"whitted 1080p": TP_WHITTED, "path 1080p": TP_PATH,
            f"levels-{BIG_LEVELS} box 256x256": TP_BOX}
    for r in ranks:
        check(r["place"] == [0, 1, r["rank"], 2], f"rank {r['rank']} sits "
              f"at {r['place']}")
        for name, v in r["tp"].items():
            cfg = cfgs[name]
            calls = _intersect_calls(cfg)
            print(f"[16] (a) rank {r['rank']} render_tp {name} {cfg}: "
                  f"{v['ms']:.1f} ms (the second run, synchronised), "
                  f"launches {json.dumps(v['launches'])}, {v['gathers']} "
                  f"all-gathers of {v['gather_bytes']} bytes in all, "
                  f"{calls} intersect calls")
            check(v["digest"] == refs[name], f"rank {r['rank']} render_tp "
                  f"{name}: not one device's render over the brute sweep")
            check(v["launches"].get("2", 0) == calls == v["gathers"],
                  f"rank {r['rank']} {name}: {v['launches']} launches, "
                  f"{v['gathers']} all-gathers, {calls} intersect calls")
            add({"2": v["launches"]["2"]})
        print(f"[16] (a) rank {r['rank']}: one all-gather of a 1080p "
              f"sweep's [N, 2] int32 buffer alone {r['gather_ms']:.2f} ms "
              f"for {r['gather_bytes']} bytes")
    print("[16] (a) every render_tp image is one device's render(intersect="
          "intersect_brute_kernel) bit for bit (digests "
          + ", ".join(refs.values()) + ")")
    mh = np.load(tmp / "slice_multihost.npy")
    ref = mh_ref.cpu().numpy()
    err = float(np.abs(mh - ref).max() / np.abs(ref).max())
    for r in ranks:
        v = r["multihost"]
        print(f"[16] (d) rank {r['rank']} render_multihost {MULTIHOST}: "
              f"{v['ms']:.1f} ms, launches {json.dumps(v['launches'])}, "
              f"{v['collectives']} collective of {v['bytes']} bytes")
        check(v["digest"] == ranks[0]["multihost"]["digest"],
              "render_multihost: the ranks' images differ")
        check(v["collectives"] == 1, f"render_multihost collectives {v}")
        add({"2": v["launches"].get("2", 0)})
    print(f"[16] (d) render_multihost on 2 ranks: both images bit for bit "
          f"equal; against one device's render({MULTIHOST['samples']}) "
          f"({mh_ms:.1f} ms): max |diff| {err:.3g} of the largest entry")
    check(err <= 1e-6, f"render_multihost vs render: {err}")

    # (b) treelets over kernel 5: the cap lowered so that the box splits
    def treelet(name, rtc, cfg, mode):
        one = prepare(rtc, device=dev, force_backend="bvh", xres=cfg["xres"],
                      yres=cfg["yres"])
        check(one.backend == "bvh-kernel", f"one tree: {one.backend}")
        cap = engine.RESIDENT_MAX_BUNDLED
        engine.RESIDENT_MAX_BUNDLED = TREELET_CAP
        try:
            tl = prepare(rtc, device=dev, force_backend="bvh",
                         xres=cfg["xres"], yres=cfg["yres"])
        finally:
            engine.RESIDENT_MAX_BUNDLED = cap
        n = tl.intersect.num_treelets
        check(tl.backend == "bvh-kernel-treelet" and n >= 3,
              f"treelets: {tl.backend}, {n}")

        def run(ps):
            return render(ps.scene, ps.camera, _generator(dev, SLICE_SEED),
                          samples=cfg["samples"], max_depth=cfg["depth"],
                          light_samples=cfg["light_samples"], mode=mode,
                          intersect=ps.intersect,
                          shadow_intersect=ps.shadow_intersect)

        with torch.no_grad():
            _zero(counts)
            ms, img = _sync_ms(lambda: run(tl))
            got = _read(counts)
            one_ms, ref = _sync_ms(lambda: run(one))
        calls = _intersect_calls(cfg)
        print(f"[16] (b) treelets {name} {cfg}: {n} treelets under a cap "
              f"of {TREELET_CAP} rows (bundled rows of the one tree: "
              f"{one.bvh.num_bundled}); {ms:.1f} ms against the one tree's "
              f"{one_ms:.1f} ms; launches {json.dumps(got)}")
        # path: the nearest and the NEE calls walk the nearest-hit kernel;
        # Whitted: half the calls are shadow rays, on the any-hit chain
        shadow = calls // 2 if mode == "whitted" else 0
        check(got.get("5", 0) == n * (calls - shadow)
              and got.get("5 any-hit", 0) == n * shadow,
              f"treelet launches {got}, {n} treelets, {calls} calls")
        fused_agree(f"(b) treelets {name} vs one tree", img.reshape(-1, 3),
                    ref.reshape(-1, 3))
        add(got)

    treelet(f"levels-{BIG_LEVELS} path", big_rtc, TREELET_PATH, "path")
    treelet(f"levels-{BIG_LEVELS} Whitted", wbox_rtc, TREELET_WHITTED,
            "whitted")

    # (c) the viewer on the five megakernel routes
    for name, rtc, backend, k in (
            ("Cornell", rtc_path, "fused-kernel", "1"),
            (f"levels-{BIG_LEVELS} box path", big_rtc, "bvh-path-kernel",
             "8"),
            ("Cornell Whitted", wrtc, "fused-whitted-kernel", "4"),
            (f"levels-{BIG_LEVELS} box Whitted", wbox_rtc,
             "bvh-whitted-kernel", "7a"),
            ("textured Whitted", tex_rtc, "bvh-whitted-deferred-kernel",
             "7b")):
        _zero(counts)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            viewer.fps_probe(str(rtc), xres=VIEWER["xres"],
                             yres=VIEWER["yres"], samples=1,
                             frames=VIEWER["frames"], device="cuda")
        got = _read(counts)
        rep = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"[16] (c) fps_probe {name}: backend {rep['backend']}, "
              f"{rep['ms_per_frame']} ms a frame, {rep['fps']} fps "
              f"({VIEWER['frames']} frames at {VIEWER['xres']}x"
              f"{VIEWER['yres']}, 1 spp, each written as a PNG), launches "
              f"{json.dumps(got)}")
        check(rep["backend"] == backend and got.get(k, 0)
              == VIEWER["frames"] + 1, f"fps_probe {name}: {rep}, {got}")
        add(got)
        ps = prepare(rtc, device=dev, xres=VIEWER["xres"],
                     yres=VIEWER["yres"])
        depth = int(ps.rtc.recursion_level)
        fn, built = viewer.build_preview_megakernel(ps, ps.camera, 1, depth)
        flown = _fly(rtc, VIEWER, dev)
        fresh, _ = viewer.build_preview_megakernel(ps, flown, 1, depth)
        a, b = fn(0, camera_override=flown), fresh(0)
        check(built == backend and torch.equal(a, b)
              and float(a.max()) > 0, f"{name}: the overridden frame is "
              "not the frame of a renderer built for that camera")
    print("[16] (c) on each route the overridden frame equals a renderer "
          "built for that camera bit for bit")
    msgs = []
    _zero(counts)
    cam = viewer.run_viewer(str(rtc_path), xres=VIEWER["xres"],
                            yres=VIEWER["yres"], out=str(tmp / "view.png"),
                            dump_path=str(tmp / "dump.rtc"),
                            input_stream=["w", "\x1b[C", "d", "p", "q"],
                            echo=msgs.append)
    got = _read(counts)
    dumped = parse_rtc(tmp / "dump.rtc")
    check(np.allclose(dumped.view_point, cam.position, atol=1e-5)
          and (tmp / "view.png").exists()
          and any("dumped" in m for m in msgs) and got.get("1", 0) == 5,
          f"scripted run_viewer: {got}")
    add(got)
    print(f"[16] (c) scripted run_viewer on Cornell: 5 frames, launches "
          f"{json.dumps(got)}, camera dumped to an .rtc that parses back at "
          f"{[round(x, 4) for x in dumped.view_point]}")

    # (e) the example ports, --small, side by side
    root = Path(__file__).resolve().parent
    procs = {}
    for ex, extra in (("torch_render_scenes.py", [str(tmp / "ex")]),
                      ("torch_inverse_rendering.py", []),
                      ("torch_multichip_render.py", [])):
        procs[ex] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, str(root / "examples" / ex), *extra, "--small"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for ex, (t0, proc) in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
        secs = time.perf_counter() - t0
        print(f"[16] (e) examples/{ex} --small: exit {proc.returncode} in "
              f"{secs:.1f} s")
        for line in out.strip().splitlines():
            print(f"[16] (e)   {line}")
        check(proc.returncode == 0, f"examples/{ex}: {err[-2000:]}")
    return launches


if __name__ == "__main__":
    sys.exit(main())
