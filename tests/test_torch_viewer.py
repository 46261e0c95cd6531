"""The viewer (orion_tpu_torch/viewer.py) and the megakernels' camera_override,
on the CPU.

- FlyCamera (from_rtc, front, right, move, turn, zoom, apply_to_rtc)
  against the JAX package's within 1e-6.
- A scripted run_viewer session on the CPU (the wavefront route) writes
  its preview and dumps an .rtc that both packages parse alike, and that
  JAX's dump_rtc writes byte for byte from the same camera.
- fps_probe and `main --fps-probe` print one JSON line.
- camera_override on the five megakernel renderers (kernels 1, 8, 4, 7a,
  7b; their plain versions here): an overridden frame equals, bit for bit,
  the frame of a renderer built for that camera; a camera of another
  resolution raises. `tab=` on the path renderer equals a renderer built
  on the scene with those materials, bit for bit.
- `render_regen_shardmap` is exported from the package.
"""

import contextlib
import copy
import dataclasses
import io
import json
import math

import numpy as np
import pytest
import torch

from cornell_scenes import write_cornell, write_cornell_whitted
from orion_tpu.io.rtc import parse_rtc as jparse_rtc
from orion_tpu.viewer import FlyCamera as JFlyCamera
from orion_tpu.viewer import dump_rtc as jdump_rtc
from orion_tpu_torch import viewer
from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.engine import prepare
from orion_tpu_torch.io.rtc import parse_rtc
from orion_tpu_torch.ops import bvh_path as bp
from orion_tpu_torch.ops import bvh_whitted as bw
from orion_tpu_torch.ops import fused_path as fp
from orion_tpu_torch.ops import whitted as wh
from orion_tpu_torch.scene import load_scene, subdivide_scene
from orion_tpu_torch.viewer import FlyCamera, run_viewer

import torch_port_util  # noqa: F401  (one thread a worker)

W, H = 12, 9


def _cams(rtc_path):
    return FlyCamera.from_rtc(parse_rtc(rtc_path)), JFlyCamera.from_rtc(
        jparse_rtc(rtc_path))


def _same(ours, theirs):
    np.testing.assert_allclose(ours.position, theirs.position, atol=1e-6)
    np.testing.assert_allclose(ours.front, theirs.front, atol=1e-6)
    np.testing.assert_allclose(ours.right, theirs.right, atol=1e-6)
    for k in ("yaw", "pitch", "fov_deg"):
        assert getattr(ours, k) == pytest.approx(getattr(theirs, k),
                                                 abs=1e-6)


def test_flycamera_matches_jax(tmp_path):
    rtc_path = write_cornell(tmp_path, xres=W, yres=H)
    ours, theirs = _cams(rtc_path)
    _same(ours, theirs)
    front = np.asarray(parse_rtc(rtc_path).look_at) - np.asarray(
        parse_rtc(rtc_path).view_point)
    np.testing.assert_allclose(ours.front, front / np.linalg.norm(front),
                               atol=1e-6)
    steps = [("move", dict(forward=2)), ("move", dict(strafe=-1)),
             ("move", dict(lift=1)), ("turn", dict(dyaw=0.3)),
             ("turn", dict(dpitch=2.0)), ("turn", dict(dpitch=-0.2)),
             ("zoom", (-50.0,)), ("zoom", (7.0,)), ("move", dict(forward=-1))]
    for name, arg in steps:
        for cam in (ours, theirs):
            fn = getattr(cam, name)
            fn(**arg) if isinstance(arg, dict) else fn(*arg)
        _same(ours, theirs)
    assert ours.pitch == pytest.approx(1.55 - 0.2)     # clamped, then down
    a, b = ours.apply_to_rtc(parse_rtc(rtc_path)), theirs.apply_to_rtc(
        jparse_rtc(rtc_path))
    for k in ("view_point", "look_at"):
        np.testing.assert_allclose(getattr(a, k), getattr(b, k), atol=1e-6)
    assert a.y_view == pytest.approx(b.y_view, abs=1e-6)


def test_scripted_session_dumps_the_camera(tmp_path):
    rtc_path = write_cornell(tmp_path, xres=W, yres=H, depth=2)
    out, dump = tmp_path / "preview.png", tmp_path / "dump.rtc"
    msgs = []
    keys = ["w", "\x1b[C", "k", "+", " ", "r", "p", "q"]
    cam = run_viewer(str(rtc_path), xres=16, yres=9, out=str(out),
                     dump_path=str(dump), input_stream=keys,
                     echo=msgs.append, device="cpu")
    assert out.exists() and dump.exists()
    assert any("dumped" in m for m in msgs)
    assert any("spp=4" in m for m in msgs)        # the refine frame
    ours, theirs = parse_rtc(dump), jparse_rtc(dump)
    for k in ("obj_file", "texture_file", "recursion_level", "xres", "yres",
              "view_point", "look_at", "vector_up", "y_view"):
        assert getattr(ours, k) == pytest.approx(getattr(theirs, k)), k
    np.testing.assert_allclose(ours.view_point, cam.position, atol=1e-5)
    # the same camera through the JAX package's dump writes the same text
    jcam = JFlyCamera.from_rtc(jparse_rtc(rtc_path))
    for k in ("position", "yaw", "pitch", "fov_deg"):
        setattr(jcam, k, copy.deepcopy(getattr(cam, k)))
    jdump_rtc(jparse_rtc(rtc_path), jcam, tmp_path / "jax.rtc")
    assert (tmp_path / "jax.rtc").read_text() == dump.read_text()
    assert math.isfinite(FlyCamera.from_rtc(ours).yaw)


def test_fps_probe_and_main_on_cpu(tmp_path):
    rtc_path = write_cornell(tmp_path, xres=W, yres=H, depth=1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert viewer.main([str(rtc_path), "--fps-probe", "2", "--xres",
                            "8", "--yres", "6", "--device", "cpu"]) == 0
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rep["resolution"] == [8, 6] and rep["frames"] == 2
    assert rep["backend"] == "brute-kernel"       # the wavefront on the CPU
    assert rep["ms_per_frame"] > 0 and rep["fps"] > 0
    ps = prepare(rtc_path, device="cpu")
    assert viewer.build_preview_megakernel(ps, ps.camera, 1, 1) is None


def test_ansi_preview(tmp_path):
    from orion_tpu_torch.io.image import save_image

    img = np.zeros((6, 8, 3), np.float32)
    img[:, :4, 0] = 1.0
    save_image(str(tmp_path / "p.png"), img)
    art = viewer._ansi_preview(str(tmp_path / "p.png"), cols=8)
    lines = art.splitlines()
    # 8 columns of an 8x6 image: 6 rows, two to a line of half blocks
    assert len(lines) == 3 and all(ln.count("▀") == 8 for ln in lines)
    assert lines[0].startswith("\x1b[38;2;255;0;0m\x1b[48;2;255;0;0m▀")
    assert lines[0].endswith("\x1b[38;2;0;0;0m\x1b[48;2;0;0;0m▀\x1b[0m")


def _moved(rtc_path, xres=W, yres=H):
    """A camera flown away from the rtc's (same resolution)."""
    rtc = parse_rtc(rtc_path)
    rtc.xres, rtc.yres = xres, yres
    cam = FlyCamera.from_rtc(rtc)
    cam.move(forward=1, strafe=0.5)
    cam.turn(dyaw=0.15, dpitch=-0.1)
    cam.zoom(4.0)
    return camera_from_rtc(cam.apply_to_rtc(rtc), device="cpu")


def _route(tmp_path, name):
    """(rtc path, build camera, flown camera, make(camera) -> renderer)."""
    if name in ("1", "8"):
        rtc = write_cornell(tmp_path, xres=W, yres=H, depth=2)
    else:
        rtc = write_cornell_whitted(tmp_path, xres=W, yres=H, depth=2,
                                    checker=name == "7b")
    sc, r = load_scene(rtc, device="cpu")
    if name in ("8", "7a"):
        sc = subdivide_scene(sc, levels=1)
    cam, flown = camera_from_rtc(r, device="cpu"), _moved(rtc)
    make = {
        "1": lambda c: fp.make_fused_path_renderer(
            sc, c, samples=2, max_depth=2, light_samples=1),
        "8": lambda c: bp.make_bvh_path_renderer(
            sc, c, samples=2, max_depth=2, light_samples=1),
        "4": lambda c: wh.make_fused_whitted_renderer(
            sc, c, samples=2, max_depth=2),
        "7a": lambda c: bw.make_bvh_whitted_renderer(
            sc, c, samples=2, max_depth=2),
        "7b": lambda c: bw.make_bvh_whitted_deferred(
            sc, c, samples=2, max_depth=2),
    }[name]
    return rtc, cam, flown, make


@pytest.mark.parametrize("name", ["1", "8", "4", "7a", "7b"])
def test_camera_override_equals_a_fresh_renderer(tmp_path, name):
    rtc, cam, flown, make = _route(tmp_path, name)
    fn = make(cam)
    home = fn(3)
    flew = fn(3, camera_override=flown)
    fresh = make(flown)(3)
    assert flew.shape == (H, W, 3) and flew.max() > 0
    assert torch.equal(flew, fresh)
    assert not torch.equal(flew, home)
    assert torch.equal(fn(3), home)          # the build camera stays
    wrong = _moved(rtc, xres=W + 1, yres=H)
    with pytest.raises(ValueError, match="built for"):
        fn(3, camera_override=wrong)


def test_fused_tab_override_equals_a_rebuilt_renderer(tmp_path):
    sc, r = load_scene(write_cornell(tmp_path, xres=W, yres=H, depth=2),
                       device="cpu")
    cam = camera_from_rtc(r, device="cpu")
    fn = fp.make_fused_path_renderer(sc, cam, samples=2, max_depth=2)
    kd = sc.mat_diffuse * 0.5
    tab = fp.pack_fused_tri_table_torch(sc, mat_diffuse=kd)
    other = dataclasses.replace(sc, mat_diffuse=kd)
    got = fn(5, tab=tab)
    assert torch.equal(got, fp.make_fused_path_renderer(
        other, cam, samples=2, max_depth=2)(5))
    assert not torch.equal(got, fn(5))
    assert torch.equal(fn(5, camera_override=_moved(
        tmp_path / "cornell.rtc"), tab=tab), fp.make_fused_path_renderer(
        other, _moved(tmp_path / "cornell.rtc"), samples=2, max_depth=2)(5))


def test_render_regen_shardmap_is_exported():
    import orion_tpu_torch
    from orion_tpu_torch.regen import render_regen_shardmap

    assert orion_tpu_torch.render_regen_shardmap is render_regen_shardmap


@pytest.mark.parametrize("example", ["torch_render_scenes.py",
                                     "torch_inverse_rendering.py",
                                     "torch_multichip_render.py"])
def test_examples_run_small_on_cpu(tmp_path, example):
    """Each example port exits 0 with --small --device cpu."""
    import subprocess
    import sys
    from pathlib import Path

    script = Path(__file__).resolve().parents[1] / "examples" / example
    argv = [sys.executable, str(script), "--small", "--device", "cpu"]
    if example == "torch_render_scenes.py":
        argv.insert(2, str(tmp_path / "out"))
    r = subprocess.run(argv, cwd=tmp_path, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    if example == "torch_render_scenes.py":
        assert len(list((tmp_path / "out").glob("*.png"))) == 4
    elif example == "torch_multichip_render.py":
        assert "render_sharded == one device's render: True" in r.stdout
        assert "== render over the brute sweep: True" in r.stdout
        assert "no multi-device scaling figure" in r.stdout
    else:
        assert "recovered albedo error" in r.stdout
