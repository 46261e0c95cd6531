"""Port wavefront renderer, engine and CLI; the port's isolation from JAX.

The wavefront draws its uniforms from a torch.Generator and the JAX
renderer from threefry keys, so path-traced images are compared
statistically, with the thresholds tests/test_fused.py uses for two
estimators of one image: correlation > 0.93 and means within rel 0.15.
Whitted tracing draws no random numbers, so on identical rays the two
packages agree to rtol 1e-4 / atol 1e-5 (float32 op order).
"""

import ast
import dataclasses
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
from orion_tpu_torch.engine import BVH_NOT_PORTED, prepare, select_intersect
from orion_tpu_torch.io.image import load_hdr
from orion_tpu_torch.render import render, trace_wavefront
from orion_tpu_torch.scene import subdivide_scene

from chip_smoke import write_cornell
from torch_port_util import to_torch, write_whitted

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
    rtc = write_cornell(tmp_path, xres=4, yres=4)
    js, jrtc = jload_scene(rtc)
    for flag in ("sort_bounces", "remat", "fold_samples", "normal_maps"):
        with pytest.raises(NotImplementedError, match=flag):
            render(to_torch(js), camera_from_rtc(jrtc, device="cpu"), _gen(0),
                   **{flag: True})


def test_select_intersect(tmp_path):
    ts = to_torch(jload_scene(write_cornell(tmp_path))[0])
    assert select_intersect(ts)[1] == "brute-kernel"
    big = subdivide_scene(ts, levels=3)
    assert big.num_triangles > 1024
    fn, name = select_intersect(big)
    assert name == BVH_NOT_PORTED
    with pytest.raises(NotImplementedError, match="BVH"):
        fn(big, torch.zeros((1, 3)), torch.ones((1, 3)))
    assert select_intersect(big, force="brute")[1] == "brute-kernel"


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


@pytest.mark.parametrize("case", ["whitted", "bvh", "regen", "shard",
                                  "normal-maps", "fused-gate"])
def test_cli_unported_routes_fail(tmp_path, case):
    rtc = (write_whitted(tmp_path) if case == "whitted"
           else write_cornell(tmp_path, xres=8, yres=8))
    if case == "whitted":
        # nine point lights leave the fused-Whitted gate (<= 8): the JAX
        # package would take a BVH Whitted megakernel, which is not ported
        rtc.write_text(rtc.read_text() + "L 0 1.5 0 255 255 255 1.0\n" * 8)
    argv = [str(rtc), "-o", str(tmp_path / "o.ppm"), "--device", "cpu"]
    extra = {"bvh": ["--backend", "bvh"], "regen": ["--regen"],
             "shard": ["--shard"], "normal-maps": ["--normal-maps"],
             "whitted": [], "fused-gate": ["--backend", "fused"]}[case]
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
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "tools").glob("*.py"))
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "orion_tpu"), (f, name)
    code = ("import sys, orion_tpu_torch.cli, orion_tpu_torch.engine, "
            "orion_tpu_torch.ops.fused_path, orion_tpu_torch.ops.prb, "
            "orion_tpu_torch.ops.whitted, orion_tpu_torch.ops.prb_whitted, "
            "orion_tpu_torch.optim, chip_smoke; "
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
