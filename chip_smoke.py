"""Drive the PyTorch/CUDA port on one GPU and check it, phase by phase.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device and build: the card's name and power limit; every CUDA source
     built from orion_tpu_torch/csrc/ (one nvcc each, in parallel).
  2. scenes: a Cornell box written as OBJ/MTL/RTC text (36 triangles, one
     two-triangle emissive quad, no point lights), its midpoint
     subdivisions (levels 2 and 4), a two-emitter variant, and a
     point-light (Whitted) variant whose tall box is a glossy mirror.
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
     of one 256x256 wavefront sample (recorded from `render`). CUDA-event
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
     depth 4 on the Whitted kernel; the kernel against its plain version
     at those shapes, with times; the kernel against the wavefront
     render(mode="whitted") at 256x256, 16 spp, depth 2 (means within
     2.5%, error under 3x the wavefront's own seed-to-seed error + 1e-4);
     a 5-step Whitted optim.fit (mat_diffuse, mat_specular) on the brute
     kernel whose loss falls.

The line before the last is a JSON object with one record per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device the
script fails before printing either.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): FP32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 arithmetic per Woop ray-triangle test (ops/woop.py): origin
# transform 3 x (3 mul + 3 add), direction transform 3 x (3 mul + 2 add),
# one divide, u/v 2 x (mul + add), the eps product; compares not counted
WOOP_TEST_FLOPS = 39

MAIN = dict(xres=1920, yres=1080, samples=16, light_samples=2, depth=8)
SECOND = dict(xres=256, yres=256, samples=16, light_samples=2, depth=4)
TRAIN = dict(xres=1920, yres=1080, samples=4, light_samples=2, depth=8)
WHITTED = dict(xres=1920, yres=1080, samples=4, light_samples=1, depth=4)
# kernel vs plain gradients: max |difference| <= this x the largest entry
GRAD_TOL = 1e-3


# ---------------------------------------------------------------------------
# the Cornell box (also imported by the tests)
# ---------------------------------------------------------------------------

def _box_faces(center, half, angle):
    """Six outward quads of a box rotated by `angle` about +y."""
    c, s = math.cos(angle), math.sin(angle)

    def p(x, y, z):
        return (center[0] + c * x * half[0] + s * z * half[2],
                center[1] + y * half[1],
                center[2] - s * x * half[0] + c * z * half[2])

    def n(x, y, z):
        return (c * x + s * z, y, -s * x + c * z)

    return [
        ([p(-1, 1, -1), p(-1, 1, 1), p(1, 1, 1), p(1, 1, -1)], n(0, 1, 0)),
        ([p(-1, -1, -1), p(1, -1, -1), p(1, -1, 1), p(-1, -1, 1)],
         n(0, -1, 0)),
        ([p(-1, -1, 1), p(1, -1, 1), p(1, 1, 1), p(-1, 1, 1)], n(0, 0, 1)),
        ([p(1, -1, -1), p(-1, -1, -1), p(-1, 1, -1), p(1, 1, -1)],
         n(0, 0, -1)),
        ([p(1, -1, 1), p(1, -1, -1), p(1, 1, -1), p(1, 1, 1)], n(1, 0, 0)),
        ([p(-1, -1, -1), p(-1, -1, 1), p(-1, 1, 1), p(-1, 1, -1)],
         n(-1, 0, 0)),
    ]


def cornell_objects():
    """[(name, material, [(quad corners, normal), ...])] of the box."""
    walls = [
        ("floor", "white", [(-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1)],
         (0, 1, 0)),
        ("ceiling", "white", [(-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1)],
         (0, -1, 0)),
        ("back", "white", [(-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)],
         (0, 0, 1)),
        ("left", "red", [(-1, 0, 1), (-1, 0, -1), (-1, 2, -1), (-1, 2, 1)],
         (1, 0, 0)),
        ("right", "green", [(1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1)],
         (-1, 0, 0)),
    ]
    objs = [(name, mat, [(quad, nrm)]) for name, mat, quad, nrm in walls]
    objs.append(("short_box", "white",
                 _box_faces((0.35, 0.3, 0.35), (0.3, 0.3, 0.3), -0.3)))
    objs.append(("tall_box", "white",
                 _box_faces((-0.35, 0.6, -0.3), (0.3, 0.6, 0.3), 0.3)))
    objs.append(("light", "light",
                 [([(-0.25, 1.98, -0.25), (0.25, 1.98, -0.25),
                    (0.25, 1.98, 0.25), (-0.25, 1.98, 0.25)], (0, -1, 0))]))
    return objs


def write_cornell(directory, *, xres: int = 64, yres: int = 64,
                  depth: int = 4) -> Path:
    """Write cornell.obj/.mtl/.rtc into `directory`; returns the .rtc path.

    Every triangle is wound so that cross(e1, e2) points along its listed
    normal (into the room for walls, out of the boxes, down for the light),
    and carries that normal as its vertex normal.
    """
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    (d / "cornell.mtl").write_text(
        "newmtl white\nKd 0.73 0.73 0.73\n\n"
        "newmtl red\nKd 0.65 0.05 0.05\n\n"
        "newmtl green\nKd 0.12 0.45 0.15\n\n"
        "newmtl light\nKd 0.78 0.78 0.78\nKe 17.0 12.0 4.0\n")
    lines = ["mtllib cornell.mtl"]
    nv = nn = 0
    for name, mat, quads in cornell_objects():
        lines += [f"o {name}", f"usemtl {mat}"]
        for quad, nrm in quads:
            q = np.asarray(quad, np.float64)
            if np.dot(np.cross(q[1] - q[0], q[2] - q[0]), nrm) < 0:
                q = q[::-1]
            lines += ["v %.9g %.9g %.9g" % tuple(v) for v in q]
            lines.append("vn %.9g %.9g %.9g" % tuple(nrm))
            nn += 1
            a, b, c, e = nv + 1, nv + 2, nv + 3, nv + 4
            lines.append(f"f {a}//{nn} {b}//{nn} {c}//{nn}")
            lines.append(f"f {a}//{nn} {c}//{nn} {e}//{nn}")
            nv += 4
    (d / "cornell.obj").write_text("\n".join(lines) + "\n")
    rtc = d / "cornell.rtc"
    rtc.write_text("# Cornell box, path traced (no point lights)\n"
                   f"cornell.obj\nnone\n{depth}\n{xres} {yres}\n"
                   "0 1 3.4\n0 1 0\n0 1 0\n0.8\n")
    return rtc


def write_cornell_whitted(directory, *, xres: int = 64, yres: int = 64,
                          depth: int = 4) -> Path:
    """The Cornell box lit by one rtc point light (Whitted mode), its tall
    box a glossy mirror (Ks 0.5, Ns 20) so that reflection chains run;
    the ceiling emitter stays (depth-0 emission)."""
    rtc = write_cornell(directory, xres=xres, yres=yres, depth=depth)
    obj, mtl = rtc.with_suffix(".obj"), rtc.with_suffix(".mtl")
    obj.write_text(obj.read_text().replace("o tall_box\nusemtl white",
                                           "o tall_box\nusemtl mirror"))
    mtl.write_text(mtl.read_text() + "\nnewmtl mirror\nKd 0.73 0.73 0.73\n"
                   "Ks 0.5 0.5 0.5\nNs 20\n")
    rtc.write_text(rtc.read_text() + "L 0 1.8 0.5 255 255 255 2.0\n")
    return rtc


def two_emitter(scene):
    """The Cornell scene with a second emissive mesh: the first non-emitter
    mesh of <= 8 triangles gets Ke = (0.5, 0.4, 0.3)."""
    from orion_tpu_torch.scene import scene_from_numpy, scene_to_numpy

    f = scene_to_numpy(scene)
    em0 = int(f["emissive_mesh_ids"][0])
    m2 = next(m for m in range(scene.num_meshes)
              if m != em0 and f["mesh_tri_count"][m] <= 8)
    f["mat_emissive"] = f["mat_emissive"].copy()
    f["mat_emissive"][m2] = (0.5, 0.4, 0.3)
    f["emissive_mesh_ids"] = np.array([em0, m2], np.int32)
    f["num_emissive"] = 2
    return scene_from_numpy(f, scene.device)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


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


def bound_ms(flops: float, nbytes: float):
    """(ms, 'operations' | 'bytes'): the larger of the two floors."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def random_rays(n: int, seed: int, device):
    """Rays from inside the box in random directions; ~10% dead."""
    import torch

    rng = np.random.default_rng(seed)
    o = rng.uniform((-0.95, 0.05, -0.95), (0.95, 1.95, 0.95), (n, 3))
    d = rng.normal(size=(n, 3))
    alive = rng.uniform(size=n) > 0.1
    return (torch.as_tensor(o, dtype=torch.float32, device=device),
            torch.as_tensor(d, dtype=torch.float32, device=device),
            torch.as_tensor(alive, device=device))


def run_cli(rtc: Path, out: Path, cfg: dict, backend=None) -> np.ndarray:
    from orion_tpu_torch import cli
    from orion_tpu_torch.io.image import load_hdr

    argv = [str(rtc), "-o", str(out), "-p", str(cfg["samples"]),
            "-l", str(cfg["light_samples"]), "--depth", str(cfg["depth"]),
            "--xres", str(cfg["xres"]), "--yres", str(cfg["yres"]),
            "--stats"]
    if backend:
        argv += ["--backend", backend]
    rc = cli.main(argv)
    check(rc == 0, f"cli exit code {rc}")
    return load_hdr(out)


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
    from orion_tpu_torch.render import render
    from orion_tpu_torch.scene import load_scene, subdivide_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. device and build ---------------------------------------------------
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
                              "whitted"])
    print(f"[1] built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1] {name}: {line.strip()}")

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
        print(f"[2] cornell {cornell.num_triangles} tris, levels-2 "
              f"{lv2.num_triangles} (T_pad {fp._fused_t_pad(lv2.num_triangles)}"
              f"), levels-4 {lv4.num_triangles}, two-emitter "
              f"{em2.num_emissive} emitters, Whitted {wsc64.num_lights} "
              f"light(s)")

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
        calls = []

        def recorder(scene, orig, dirs, *, alive=None):
            a = alive if alive is not None else torch.ones(
                orig.shape[0], dtype=torch.bool, device=orig.device)
            calls.append(tuple(x.detach().contiguous().clone()
                               for x in (orig.float(), dirs.float(), a)))
            return bi.intersect_brute_kernel(scene, orig, dirs, alive=alive)

        cam_w = camera_from_rtc(_resized(parse_rtc(rtc_path), SECOND),
                                device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        render(cornell, cam_w, gen, samples=1, max_depth=SECOND["depth"],
               light_samples=SECOND["light_samples"], intersect=recorder)
        tab = bi.pack_tri_rows16(cornell)
        for i, (o, d, alive) in enumerate(calls):
            k = bi.brute_sweep(tab, o, d, alive)
            torch.cuda.synchronize()
            brute_err = max(brute_err, brute_agree(
                f"wavefront sweep {i}", k,
                bi.brute_sweep_plain(tab, o, d, alive)))

        def sweeps(fn):
            return lambda: [fn(tab, o, d, alive) for o, d, alive in calls]

        # eager launches from Python leave the card waiting on the host, so
        # the kernel's own time is taken from a CUDA graph of 20 passes
        n_calls, passes = len(calls), 20
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(passes):
                sweeps(bi.brute_sweep)()
        b_ms, b_times, _ = event_ms(graph.replay, 21)
        b_ms /= passes * n_calls
        b_spread = (max(b_times) - min(b_times)) / float(np.median(b_times))
        b_eager_ms, _, _ = event_ms(sweeps(bi.brute_sweep), 21, inner=passes)
        b_plain_ms, _, _ = event_ms(sweeps(bi.brute_sweep_plain), 5)
        b_eager_ms, b_plain_ms = b_eager_ms / n_calls, b_plain_ms / n_calls
        n_rays = sum(o.shape[0] for o, _, _ in calls)
        n_alive = sum(int(a.sum()) for _, _, a in calls)
        b_bound, b_by = bound_ms(
            n_alive * tab.shape[0] * WOOP_TEST_FLOPS / n_calls,
            (n_rays * 25 + n_calls * tab.numel() * 4 + n_rays * 8) / n_calls)
        print(f"[6] brute, per launch over the {n_calls} sweeps of one "
              f"wavefront sample ({n_rays} rays, {n_alive} alive, x "
              f"{tab.shape[0]} rows): {b_ms:.6f} ms kernel (median of 21 "
              f"replays of a CUDA graph of {passes} passes; spread "
              f"(max-min)/median {b_spread:.4f}), {b_eager_ms:.5f} ms "
              f"launched eagerly, {b_plain_ms:.4f} ms plain, bound "
              f"{b_bound:.6f} ms ({b_by})")

        train = _phase_train(tmp, dev, card, fwd_err, replay_err)
        whit = _phase_whitted(tmp, dev, whitted_err)

    kernels = [
        {"name": "fused_path", "route": "cuda",
         "source": "orion_tpu_torch/csrc/fused_path.cu",
         "replaces": "orion_tpu/ops/pallas_fused.py:959",
         "launches": fused_launches, "max_abs_err": fused_err,
         "ms": f_ms, "plain_ms": f_plain_ms, "bound_ms": f_bound,
         "bound_by": f_by, "library_ms": None},
        {"name": "brute_intersect", "route": "cuda",
         "source": "orion_tpu_torch/csrc/brute_intersect.cu",
         "replaces": "orion_tpu/ops/pallas_intersect.py:87",
         "launches": brute_launches, "max_abs_err": brute_err,
         "ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound,
         "bound_by": b_by, "library_ms": None},
        {"name": "prb_fwd_ls", "route": "cuda",
         "source": "orion_tpu_torch/csrc/prb.cu",
         "replaces": "orion_tpu/ops/pallas_prb.py:90", **train["fwd"]},
        {"name": "prb_replay", "route": "cuda",
         "source": "orion_tpu_torch/csrc/prb.cu",
         "replaces": "orion_tpu/ops/pallas_prb.py:282", **train["replay"]},
        {"name": "whitted", "route": "cuda",
         "source": "orion_tpu_torch/csrc/whitted.cu",
         "replaces": "orion_tpu/ops/pallas_whitted.py:101", **whit},
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
    ms, times, k = event_ms(lambda: wh.fused_whitted(*args, 0, *cfg), 3)
    stats = {}
    plain_ms, p = once_ms(
        lambda: wh.fused_whitted_plain(*args, 0, *cfg, stats=stats))
    whitted_err = max(whitted_err, fused_agree("whitted 1080p", k, p))
    bound, by = bound_ms(stats["tests"] * WOOP_TEST_FLOPS,
                         args[0].numel() * 4 + W * H * 12)
    print(f"[8] whitted: {ms:.3f} ms kernel (runs "
          f"{', '.join(f'{x:.3f}' for x in times)}), {plain_ms:.1f} ms plain, "
          f"{stats['tests']:.6g} Woop tests, bound {bound:.4f} ms ({by})")

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


if __name__ == "__main__":
    sys.exit(main())
