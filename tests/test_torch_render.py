"""Port wavefront renderer, engine and CLI; the port's isolation from JAX.

The wavefront draws its uniforms from a torch.Generator and the JAX
renderer from threefry keys, so path-traced images are compared
statistically, with the thresholds tests/test_fused.py uses for two
estimators of one image: correlation > 0.93 and means within rel 0.15.
Whitted tracing draws no random numbers, so on identical rays the two
packages agree to rtol 1e-4 / atol 1e-5 (float32 op order).
"""

import ast
import contextlib
import dataclasses
import io
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.camera import primary_rays as jprimary_rays
from orion_tpu.render import render as jrender
from orion_tpu.render import trace_wavefront as jtrace
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch import cli
from orion_tpu_torch.camera import camera_from_rtc, primary_rays
from orion_tpu_torch.engine import (GPU_LEAF_SIZE, make_megakernel_renderer,
                                    prepare, select_intersect)
from orion_tpu_torch.ops.intersect import intersect_brute
from orion_tpu_torch.io.image import load_hdr
from orion_tpu_torch.render import render, trace_wavefront
from orion_tpu_torch.scene import subdivide_scene

from cornell_scenes import write_cornell, write_cornell_whitted
from torch_port_util import to_torch, write_textured, write_whitted

REPO = Path(__file__).resolve().parents[1]


def _corr(a, b):
    return float((a * b).sum()
                 / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-20))


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_path_wavefront_matches_jax_statistically(tmp_path):
    rtc = write_cornell(tmp_path, xres=48, yres=28, depth=4)
    js, jrtc = jload_scene(rtc)
    cfg = dict(samples=16, max_depth=4, light_samples=2, mode="path")
    theirs = np.asarray(jrender(js, jcamera_from_rtc(jrtc),
                                jax.random.key(1), **cfg))
    ours = render(to_torch(js), camera_from_rtc(jrtc, device="cpu"), _gen(1), **cfg).numpy()
    assert ours.shape == theirs.shape and np.isfinite(ours).all()
    assert _corr(ours, theirs) > 0.93, _corr(ours, theirs)
    assert ours.mean() == pytest.approx(theirs.mean(), rel=0.15)


def test_whitted_wavefront_matches_jax_on_identical_rays(tmp_path):
    rtc = write_whitted(tmp_path, xres=20, yres=16)
    js, jrtc = jload_scene(rtc)
    assert js.num_lights == 1
    jo, jd = jprimary_rays(jcamera_from_rtc(jrtc), 0.01, 0.02)
    to, td = primary_rays(camera_from_rtc(jrtc, device="cpu"), 0.01, 0.02)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)
    # hand both renderers the very same rays
    to, td = torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jd))
    theirs = np.asarray(jtrace(js, jo, jd, jax.random.key(0), max_depth=2))
    ours = trace_wavefront(to_torch(js), to, td, _gen(0), max_depth=2).numpy()
    assert theirs.max() > 0
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)


def test_wavefront_gradients_finite(tmp_path):
    rtc = write_cornell(tmp_path, xres=12, yres=10, depth=2)
    js, jrtc = jload_scene(rtc)
    ts = to_torch(js)
    kd = ts.mat_diffuse.clone().requires_grad_(True)
    ke = ts.mat_emissive.clone().requires_grad_(True)
    ts = dataclasses.replace(ts, mat_diffuse=kd, mat_emissive=ke)
    img = render(ts, camera_from_rtc(jrtc, device="cpu"), _gen(0), samples=2,
                 max_depth=2, light_samples=1)
    img.mean().backward()
    for g in (kd.grad, ke.grad):
        assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_unported_render_options_raise(tmp_path):
    """The three render options that raised NotImplementedError until
    they were ported now run: each gives a finite image of the right
    shape, and on a scene without a bump map normal_maps and remat leave
    it as it was (tests/test_torch_options.py holds them to JAX)."""
    rtc = write_cornell(tmp_path, xres=4, yres=4)
    js, jrtc = jload_scene(rtc)
    ts, cam = to_torch(js), camera_from_rtc(jrtc, device="cpu")
    base = render(ts, cam, _gen(0))
    for flag in ("remat", "fold_samples", "normal_maps"):
        img = render(ts, cam, _gen(0), **{flag: True})
        assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())
        if flag != "fold_samples":
            assert torch.equal(img, base), flag


def test_select_intersect(tmp_path):
    ts = to_torch(jload_scene(write_cornell(tmp_path))[0])
    assert select_intersect(ts)[1] == "brute-kernel"
    big = subdivide_scene(ts, levels=3)
    assert big.num_triangles > 1024
    # a CPU scene past the brute gate walks the tree in plain PyTorch
    fn, name, bvh, stats = select_intersect(big)
    assert name == "bvh-torch"
    assert stats.nodes == bvh.num_nodes and bvh.leaf_width == 16
    o, d = primary_rays(camera_from_rtc(
        jload_scene(write_cornell(tmp_path))[1], device="cpu"), 0.0131, 0.0217)
    ours, ref = fn(big, o, d), intersect_brute(big, o, d)
    # same nearest hit as the brute oracle (rays jittered off the mesh's
    # shared edges): ids >= 99.9%, t to rtol 1e-5
    assert (ours.tri_id == ref.tri_id).float().mean() >= 0.999
    both = (ours.tri_id >= 0) & (ref.tri_id >= 0)
    assert torch.equal(ours.mask, ref.mask)
    np.testing.assert_allclose(ours.t[both].numpy(), ref.t[both].numpy(),
                               rtol=1e-5)
    assert select_intersect(big, force="brute")[1] == "brute-kernel"
    # the kernel's name pins the kernel's tree (on a CPU scene its wrapper
    # runs the plain walk, as every kernel wrapper does)
    fn, name, bvh, _ = select_intersect(ts, force="bvh-kernel")
    assert name == "bvh-kernel" and bvh.leaf_width == GPU_LEAF_SIZE
    assert select_intersect(ts, force="bvh")[1] == "bvh-torch"
    with pytest.raises(ValueError, match="unknown"):
        select_intersect(ts, force="bvh-pallas")


@pytest.mark.parametrize("backend", [None, "brute"])
def test_cli_routes(tmp_path, capsys, backend):
    rtc = write_cornell(tmp_path, xres=12, yres=8, depth=2)
    out = tmp_path / "out.hdr"
    argv = [str(rtc), "-o", str(out), "-p", "2", "-l", "2",
            "--device", "cpu", "--stats"]
    if backend:
        argv += ["--backend", backend]
    assert cli.main(argv) == 0
    captured = capsys.readouterr()
    name = "brute-kernel" if backend else "fused-kernel"
    assert name in captured.out
    assert '"device": "cpu"' in captured.err
    img = load_hdr(out)
    assert img.shape == (8, 12, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    ps = prepare(rtc, device="cpu")
    assert ps.scene.device.type == "cpu"


@pytest.mark.parametrize("scene", ["cornell", "levels5", "checker",
                                   "whitted", "whitted-levels5"])
def test_megakernel_route_is_one(tmp_path, monkeypatch, scene):
    """engine.make_megakernel_renderer, the backend cli.main reports and
    the benchmark's frozen copy of the chain (portbench/harness.route)
    pick the same megakernel: the fused path kernel, the big-path chain
    past its gate (levels 5: 34,818 triangles) and for a textured box,
    the Whitted kernel and past its gate the BVH Whitted kernel for
    point-light boxes."""
    writer = write_cornell_whitted if scene.startswith("whitted") else \
        write_cornell
    rtc = writer(tmp_path, xres=8, yres=6, depth=1,
                 levels=5 if scene.endswith("levels5") else 0,
                 checker=scene == "checker")
    ps = prepare(rtc, device="cpu")
    cfg = dict(samples=1, max_depth=1, light_samples=2)
    _, ours = make_megakernel_renderer(ps, mode=None, **cfg)
    monkeypatch.syspath_prepend(str(REPO / "portbench"))
    import harness

    _, bench = harness.route(ps, **cfg)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main([str(rtc), "-o", str(tmp_path / "o.hdr"), "-p", "1",
                         "-l", "2", "--device", "cpu", "--stats"]) == 0
    reported = json.loads(err.getvalue().splitlines()[-1])["backend"]
    assert ours == bench == reported
    assert ours == {"cornell": "fused-kernel", "levels5": "bounce-torch",
                    "checker": "bounce-torch",
                    "whitted": "fused-whitted-kernel",
                    "whitted-levels5": "bvh-whitted-torch"}[scene]


@pytest.mark.parametrize("flags", [["-t", "8"], ["--threads", "8"],
                                   ["--checkpoint-every", "4"]])
def test_cli_accepts_launcher_flags(tmp_path, capsys, flags):
    """The reference launcher's -t/--threads (ignored) and the JAX CLI's
    --checkpoint-every parse and leave the render as it is (without
    --checkpoint, which takes io/checkpoint.render_accumulate:
    test_cli_unported_routes_fail[checkpoint])."""
    args = cli.build_parser().parse_args(["s.rtc", *flags])
    assert args.threads == (8 if flags[0] != "--checkpoint-every" else 0)
    assert args.checkpoint_every == (4 if flags[0] == "--checkpoint-every"
                                     else 64)
    rtc = write_cornell(tmp_path, xres=8, yres=6, depth=1)
    out = tmp_path / "out.hdr"
    assert cli.main([str(rtc), "-o", str(out), "-p", "1", "--device", "cpu",
                     *flags]) == 0
    assert "fused-kernel" in capsys.readouterr().out
    assert load_hdr(out).shape == (6, 8, 3)


@pytest.mark.parametrize("case", ["whitted", "checkpoint", "textured",
                                  "shard", "normal-maps", "fused-gate"])
def test_cli_unported_routes_fail(tmp_path, case):
    rtc = (write_whitted(tmp_path) if case == "whitted"
           else write_textured(tmp_path) if case == "textured"
           else write_cornell(tmp_path, xres=8, yres=8))
    if case == "whitted":
        # nine point lights leave every Whitted megakernel gate (1..8
        # lights: the fused, the BVH and the deferred BVH kernel's); the
        # JAX package then renders the Whitted wavefront, and so does the
        # port
        rtc.write_text(rtc.read_text() + "L 0 1.5 0 255 255 255 1.0\n" * 8)
    argv = [str(rtc), "-o", str(tmp_path / "o.ppm"), "--device", "cpu"]
    extra = {"checkpoint": ["--checkpoint", str(tmp_path / "c.ckpt"),
                            "-p", "2", "--checkpoint-every", "1"],
             "textured": [],
             "shard": ["--shard"], "normal-maps": ["--normal-maps"],
             "whitted": [], "fused-gate": ["--backend", "fused"]}[case]
    if case in ("textured", "whitted", "checkpoint", "normal-maps", "shard"):
        # a textured path scene leaves the fused gate and, since the
        # bounce pipeline is ported, renders through it; --checkpoint,
        # --normal-maps and --shard (a world of one without torchrun) take
        # the wavefront over the engine's intersect
        argv += ["--stats"] + extra
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert cli.main(argv) == 0
        size = 24 * 24 * 3 if case in ("textured", "whitted") else 8 * 8 * 3
        assert (tmp_path / "o.ppm").stat().st_size > size
        backend = json.loads(err.getvalue().splitlines()[-1])["backend"]
        assert backend == ("bounce-torch" if case == "textured"
                           else "brute-kernel")
        if case == "checkpoint":
            assert "[render] 2/2 spp" in err.getvalue()
            assert (tmp_path / "c.ckpt").exists()
        return
    if case == "fused-gate":
        # a second emissive mesh of > 8 triangles leaves the fused gate
        mtl = tmp_path / "cornell.mtl"
        mtl.write_text(mtl.read_text().replace(
            "newmtl green\nKd 0.12 0.45 0.15",
            "newmtl green\nKd 0.12 0.45 0.15\nKe 1 1 1").replace(
            "newmtl white\nKd 0.73 0.73 0.73",
            "newmtl white\nKd 0.73 0.73 0.73\nKe 0.1 0.1 0.1"))
    with pytest.raises(SystemExit) as e:
        cli.main(argv + extra)
    assert e.value.code not in (0, None)
    assert "not ported" in str(e.value.code) or "gate" in str(e.value.code)


def test_cli_whitted_wavefront_runs(tmp_path):
    rtc = write_whitted(tmp_path, xres=8, yres=8)
    out = tmp_path / "w.ppm"
    assert cli.main([str(rtc), "-o", str(out), "--backend", "brute",
                     "--device", "cpu"]) == 0
    assert out.stat().st_size > 8 * 8 * 3


def test_cli_cuda_requested_without_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rtc = write_cornell(tmp_path, xres=8, yres=8)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main([str(rtc), "-o", str(tmp_path / "o.ppm")])


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_port_never_imports_jax():
    files = sorted((REPO / "orion_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "cornell_scenes.py"]
    files += sorted((REPO / "tools").glob("*.py"))
    files += sorted((REPO / "examples").glob("torch_*.py"))
    assert len(files) > 10
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"orion_tpu_torch/accel/bvh.py", "orion_tpu_torch/native.py",
            "orion_tpu_torch/regen.py", "orion_tpu_torch/ops/reorder.py",
            "orion_tpu_torch/ops/bvh_traverse.py",
            "orion_tpu_torch/ops/bvh_intersect.py",
            "orion_tpu_torch/ops/bvh_path.py",
            "orion_tpu_torch/ops/bounce.py",
            "orion_tpu_torch/ops/bounce_prb.py",
            "orion_tpu_torch/ops/bvh_whitted.py",
            "orion_tpu_torch/ops/bvh_prb.py",
            "orion_tpu_torch/accel/refit.py",
            "orion_tpu_torch/io/checkpoint.py",
            "orion_tpu_torch/profiling.py",
            "orion_tpu_torch/parallel/distributed.py",
            "orion_tpu_torch/parallel/sharding.py",
            "orion_tpu_torch/parallel/shardmap_render.py",
            "orion_tpu_torch/parallel/fused_shard.py",
            "orion_tpu_torch/parallel/primitive_sharding.py",
            "orion_tpu_torch/viewer.py",
            "examples/torch_render_scenes.py",
            "examples/torch_inverse_rendering.py",
            "examples/torch_multichip_render.py"} <= names
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "orion_tpu"), (f, name)
    code = ("import sys, orion_tpu_torch.cli, orion_tpu_torch.engine, "
            "orion_tpu_torch.ops.fused_path, orion_tpu_torch.ops.prb, "
            "orion_tpu_torch.ops.whitted, orion_tpu_torch.ops.prb_whitted, "
            "orion_tpu_torch.optim, orion_tpu_torch.accel.bvh, "
            "orion_tpu_torch.native, orion_tpu_torch.regen, "
            "orion_tpu_torch.ops.bvh_traverse, "
            "orion_tpu_torch.ops.bvh_intersect, orion_tpu_torch.ops.bvh_path, "
            "orion_tpu_torch.ops.reorder, orion_tpu_torch.ops.bounce, "
            "orion_tpu_torch.ops.bounce_prb, orion_tpu_torch.ops.bvh_whitted, "
            "orion_tpu_torch.ops.bvh_prb, orion_tpu_torch.accel.refit, "
            "orion_tpu_torch.io.checkpoint, orion_tpu_torch.profiling, "
            "orion_tpu_torch.parallel, orion_tpu_torch.parallel.fused_shard, "
            "orion_tpu_torch.parallel.distributed, "
            "orion_tpu_torch.parallel.primitive_sharding, "
            "orion_tpu_torch.viewer, chip_smoke, cornell_scenes; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'orion_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """Without a CUDA device, or copied into a directory that holds
    nothing else of the repo, the script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present")
    script = REPO / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
