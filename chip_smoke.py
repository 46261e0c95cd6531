"""Drive the PyTorch/CUDA port on one GPU and check it, phase by phase.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device and build: the card's name and power limit; both CUDA kernels
     built from orion_tpu_torch/csrc/ (one nvcc each, in parallel).
  2. scenes: a Cornell box written as OBJ/MTL/RTC text (36 triangles, one
     two-triangle emissive quad, no point lights), its midpoint
     subdivisions (levels 2 and 4) and a two-emitter variant.
  3. each kernel against its plain PyTorch version on the card: the brute
     sweep on 2^18 random rays (some dead), the fused path kernel at
     64x64, 4 spp, depth 4, 2 light samples on all four scenes.
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
    built = cuda_build.build(["fused_path", "brute_intersect"])
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
        print(f"[2] cornell {cornell.num_triangles} tris, levels-2 "
              f"{lv2.num_triangles} (T_pad {fp._fused_t_pad(lv2.num_triangles)}"
              f"), levels-4 {lv4.num_triangles}, two-emitter "
              f"{em2.num_emissive} emitters")

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
            args = _fused_args(fp, sc, cam64, dev)
            cfg = (64, 64, 4, 4, 2)
            k = fp.fused_path(*args, 1234, *cfg)
            torch.cuda.synchronize()
            fused_err = max(fused_err, fused_agree(
                f"{name} 64x64", k, fp.fused_path_plain(*args, 1234, *cfg)))

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
        args = _fused_args(fp, cornell, cam_main, dev)
        cfg = (MAIN["xres"], MAIN["yres"], MAIN["samples"], MAIN["depth"],
               MAIN["light_samples"])
        f_ms, f_times, k_main = event_ms(
            lambda: fp.fused_path(*args, 0, *cfg), 3)
        stats = {}
        f_plain_ms, _, p_main = event_ms(
            lambda: fp.fused_path_plain(*args, 0, *cfg, stats=stats), 1)
        fused_err = max(fused_err, fused_agree("main 1080p", k_main, p_main))
        tests = stats["tests"] / 2          # warm-up + one timed run
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


def _fused_args(fp, scene, camera, dev):
    """(tab, clo, chi, em, cam) device tensors of the fused kernel."""
    import torch

    lo, hi = fp.fused_chunk_bounds(scene)
    return (torch.as_tensor(fp.pack_fused_tri_table(scene), device=dev),
            torch.as_tensor(lo, device=dev).contiguous(),
            torch.as_tensor(hi, device=dev).contiguous(),
            torch.as_tensor(fp.pack_emitters(scene), device=dev),
            fp.camera_vec(camera).to(dev))


if __name__ == "__main__":
    sys.exit(main())
