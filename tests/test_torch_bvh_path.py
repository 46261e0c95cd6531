"""The port's BVH path renderer, big-scene routing, regenerative wavefront
and bounce sorting, on the CPU.

Tolerances. The plain BVH path version against the JAX kernel in
interpret mode, on the identical tree, table and PCG seed: the two run the
same float32 estimator in a different op order, so a pixel may differ by
1e-5 + 1e-4*|ref|, and at most 1% of pixels by more (a nearest-hit tie
that breaks the other way sends a path elsewhere). Against the port's
brute-sweep training forward (the same estimator, another sweep): the
same bound. Two estimators with different random streams (regen against
the wavefront, sorted against unsorted bounces) are held statistically.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from orion_tpu.ops import pallas_bvh_path as jpp
from orion_tpu.ops import pallas_fused as jf
from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch import cli, engine
from orion_tpu_torch.accel.bvh import bvh_from_numpy
from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.engine import (make_big_path_renderer,
                                    prepare, render_prepared)
from orion_tpu_torch.io.image import load_hdr
from orion_tpu_torch.ops import bvh_path as bp
from orion_tpu_torch.ops import fused_path as fp
from orion_tpu_torch.regen import render_regen
from orion_tpu_torch.render import render
from orion_tpu_torch.scene import load_scene

from cornell_scenes import write_cornell, write_cornell_whitted
from torch_port_util import jax_bvh_fields, to_torch, write_textured

W, H, S, D, LS = 16, 16, 2, 3, 2


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _pixels_agree(ours, ref):
    """<= 1% of pixels off by more than 1e-5 + 1e-4*|ref|."""
    off = np.abs(ours - ref) > 1e-5 + 1e-4 * np.abs(ref)
    assert off.any(axis=-1).mean() <= 0.01, off.any(axis=-1).mean()
    assert ref.mean() > 0 and np.isfinite(ours).all()


@pytest.fixture(scope="module")
def lv2(tmp_path_factory):
    rtc = write_cornell(tmp_path_factory.mktemp("lv2"), xres=W, yres=H,
                        depth=D, levels=2)
    js, jrtc = jload_scene(rtc)
    return rtc, js, jrtc


def test_plain_bvh_path_matches_jax_kernel(lv2):
    _, js, jrtc = lv2
    ts = to_torch(js)
    # the tree the JAX renderer builds (deterministic), handed to the port
    _, _, _, jb = jpp.bvh_path_device_data(js, with_bvh=True,
                                           check_cap=False)
    theirs = np.asarray(jpp.make_bvh_path_renderer(
        js, jcamera_from_rtc(jrtc), samples=S, max_depth=D,
        light_samples=LS, interpret=True)(jax.random.key(3)))
    seed = int(jf.seed_scalar(jax.random.key(3))[0])
    cam = camera_from_rtc(jrtc, device="cpu")
    fn = bp.make_bvh_path_renderer(ts, cam, samples=S, max_depth=D,
                                   light_samples=LS, leaf_width=128,
                                   bvh=bvh_from_numpy(jax_bvh_fields(jb)))
    ours = fn(seed).numpy()
    assert ours.shape == (H, W, 3)
    _pixels_agree(ours, theirs)
    # a tile renders the same pixels as the whole image
    tile = fn(seed, pix_base=37, n_lanes=50).numpy()
    assert np.array_equal(tile, ours.reshape(-1, 3)[37:87])
    with pytest.raises(ValueError, match="asked for"):
        bp.make_bvh_path_renderer(ts, cam, samples=S, max_depth=D,
                                  bvh=bvh_from_numpy(jax_bvh_fields(jb)))


@pytest.mark.parametrize("leaf,octants", [(2, 1), (8, 8), (128, 1)])
def test_plain_bvh_path_matches_brute_forward(lv2, leaf, octants):
    """The same estimator over the brute sweep: fused_fwd_ls_plain."""
    _, js, jrtc = lv2
    ts = to_torch(js)
    cam = camera_from_rtc(jrtc, device="cpu")
    stats = {}
    fn = bp.make_bvh_path_renderer(ts, cam, samples=S, max_depth=D,
                                   light_samples=LS, leaf_width=leaf,
                                   octants=octants, builder="numpy")
    dd = fn.data
    ours = bp.bvh_path_plain(dd["nodes"], dd["tab"], dd["em"], dd["cam"], 11,
                             W, H, S, D, LS, leaf_width=leaf, copies=octants,
                             stats=stats)
    assert torch.equal(ours.reshape(H, W, 3), fn(11))
    ref, _ = fp.fused_fwd_ls_plain(*fp.fused_args(ts, cam), 11, W, H, S, D,
                                   LS)
    _pixels_agree(ours.numpy(), ref.numpy())
    # the walks counted their work: some nodes, fewer Woop tests than a
    # sweep of every row by every walk
    assert stats["box_tests"] > 0
    assert 0 < stats["tests"] < stats["leaf_visits"] * leaf + 1


def test_bvh_path_gate_and_wrapper_checks(lv2, tmp_path):
    _, js, jrtc = lv2
    ts = to_torch(js)
    cam = camera_from_rtc(jrtc, device="cpu")
    assert bp.bvh_path_supported(ts) and fp.fused_path_supported(ts)
    tex = load_scene(write_textured(tmp_path), device="cpu")[0]
    assert not bp.bvh_path_supported(tex)
    assert bp.bounce_textured_supported(tex)
    with pytest.raises(ValueError, match="gate"):
        bp.make_bvh_path_renderer(tex, cam, samples=1, max_depth=1)
    fn = bp.make_bvh_path_renderer(ts, cam, samples=1, max_depth=1)
    with pytest.raises(ValueError):      # a tile past the image's end
        bp._check_tree("t", fn.data["nodes"], fn.data["tab"], fn.data["em"],
                       fn.data["cam"], 1, W, H, W * H - 3, 10)
    with pytest.raises(ValueError, match="copies"):
        bp._check_tree("t", fn.data["nodes"], fn.data["tab"], fn.data["em"],
                       fn.data["cam"], 3, W, H, 0, 10)
    with pytest.raises(ValueError, match="float32"):
        bp._check_tree("t", fn.data["nodes"].double(), fn.data["tab"],
                       fn.data["em"], fn.data["cam"], 1, W, H, 0, 10)


def test_make_big_path_renderer(lv2, tmp_path):
    _, js, jrtc = lv2
    ts = to_torch(js)
    cam = camera_from_rtc(jrtc, device="cpu")
    assert engine.BIG_PATH_ORDER == ("bounce", "walk")
    # the BVH path kernel on request
    fn, name = make_big_path_renderer(ts, cam, samples=1, max_depth=1,
                                      light_samples=1, order=("walk",))
    assert name == "bvh-path-kernel"
    # the first candidate, the bounce pipeline: the same estimator up to
    # the light normal's rounding
    fn_b, name_b = make_big_path_renderer(ts, cam, samples=1, max_depth=1,
                                          light_samples=1)
    assert name_b == "bounce-torch"
    img = fn(5)
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()
    assert img.mean() > 0
    np.testing.assert_allclose(fn_b(5).numpy(), img.numpy(), rtol=1e-4,
                               atol=1e-5)
    # "binned" by name: second, the first candidate takes the scene; alone,
    # the binned renderer on its plain versions
    _, name = make_big_path_renderer(ts, cam, samples=1, max_depth=1,
                                     order=("bounce", "binned"))
    assert name == "bounce-torch"
    fn_n, name_n = make_big_path_renderer(ts, cam, samples=1, max_depth=1,
                                          light_samples=1, order=("binned",))
    assert name_n == "binned-torch"
    np.testing.assert_allclose(fn_n(5).numpy(), img.numpy(), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="unknown"):
        make_big_path_renderer(ts, cam, samples=1, max_depth=1,
                               order=("sweep",))
    # a textured path scene: the bounce pipeline alone serves it
    tex = load_scene(write_textured(tmp_path), device="cpu")[0]
    fn_t, name_t = make_big_path_renderer(tex, cam, samples=1, max_depth=1)
    assert name_t == "bounce-torch"
    img_t = fn_t(5)
    assert img_t.shape == (H, W, 3) and torch.isfinite(img_t).all()
    # outside every gate (a second emitter of > 8 triangles): a plain
    # ValueError, on which callers take the wavefront as the JAX CLI does
    big_em = dataclasses.replace(
        ts, mesh_tri_count=torch.full_like(ts.mesh_tri_count, 64))
    with pytest.raises(ValueError, match="gate"):
        make_big_path_renderer(big_em, cam, samples=1, max_depth=1)


@pytest.mark.parametrize("res,spp,name", [
    ((3840, 2160), 32, "bvh-path-kernel"),
    ((1920, 1080), 65, "bvh-path-kernel"),
    ((3840, 2160), 16, "bounce-torch"),
])
def test_big_path_lane_gate_routes(lv2, res, spp, name):
    """Past the bounce pipeline's lane gate (2^27 lanes: 4K at 32 spp,
    1080p at 65) the first candidate raises ValueError and the BVH path
    kernel, which holds no wavefront, takes the render; 4K at 16 spp
    stays on the pipeline."""
    _, js, jrtc = lv2
    ts = to_torch(js)
    cam = dataclasses.replace(camera_from_rtc(jrtc, device="cpu"),
                              xres=res[0], yres=res[1])
    assert engine.BIG_PATH_ORDER[0] == "bounce"
    _, got = make_big_path_renderer(ts, cam, samples=spp, max_depth=1,
                                    light_samples=1)
    assert got == name


@pytest.fixture(scope="module")
def lv5(tmp_path_factory):
    return write_cornell(tmp_path_factory.mktemp("lv5"), xres=8, yres=6,
                         depth=1, levels=5)


@pytest.mark.parametrize("route", ["default", "fused", "bvh", "regen"])
def test_cli_big_scene_routes(lv5, tmp_path, capsys, route):
    """The levels-5 box (34,818 triangles, past the fused gate) through
    the CLI on the CPU: the first big-path candidate (the bounce
    pipeline's plain versions) by default and for --backend fused, the
    wavefront over the tree for --backend bvh, the regenerative wavefront
    for --regen."""
    out = tmp_path / "o.hdr"
    extra = {"default": [], "fused": ["--backend", "fused"],
             "bvh": ["--backend", "bvh", "--strategy", "median"],
             "regen": ["--regen"]}[route]
    assert cli.main([str(lv5), "-o", str(out), "-p", "1", "-l", "1",
                     "--device", "cpu", "--stats"] + extra) == 0
    cap = capsys.readouterr()
    name = "bvh-torch" if route in ("bvh", "regen") else "bounce-torch"
    assert f'"backend": "{name}"' in cap.err
    assert '"triangles": 34818' in cap.err
    assert '"bvh_nodes": 0' not in cap.err
    img = load_hdr(out)
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0


def test_cli_whitted_past_gate_names_bvh(tmp_path, capsys):
    """Past the fused-Whitted gate the CLI names the BVH Whitted kernel's
    backend (its plain version on the CPU), as the JAX CLI takes
    make_bvh_whitted_renderer there; --regen stays path mode only."""
    rtc = write_cornell_whitted(tmp_path, xres=8, yres=6, depth=1, levels=5)
    assert cli.main([str(rtc), "-o", str(tmp_path / "o.ppm"), "--device",
                     "cpu"]) == 0
    assert "bvh-whitted-torch" in capsys.readouterr().out
    assert (tmp_path / "o.ppm").stat().st_size > 8 * 6 * 3
    with pytest.raises(SystemExit, match="path mode"):
        cli.main([str(rtc), "-o", str(tmp_path / "o.ppm"), "--device",
                  "cpu", "--regen"])


def test_cli_whitted_bvh_calls_any_hit(tmp_path, monkeypatch):
    """A Whitted --backend bvh render over the walk kernel's tree sends
    its shadow rays through the any-hit function (the CLI passes
    ps.shadow_intersect on), and the image equals the brute wavefront's."""
    rtc = write_cornell_whitted(tmp_path, xres=12, yres=10, depth=2,
                                levels=2)
    calls = {"any": 0, "nearest": 0}
    real_prepare = engine.prepare

    def counting_prepare(path, **kw):
        if kw.get("force_backend") == "bvh":
            # on the card "bvh" selects the kernel's tree and its any-hit
            # variant; a CPU scene gets them by the kernel's name
            kw["force_backend"] = "bvh-kernel"
        ps = real_prepare(path, **kw)
        if ps.shadow_intersect is None:
            return ps
        nearest, shadow = ps.intersect, ps.shadow_intersect

        def count(kind, fn):
            def wrapped(*a, **k):
                calls[kind] += 1
                return fn(*a, **k)
            return wrapped

        return dataclasses.replace(ps, intersect=count("nearest", nearest),
                                   shadow_intersect=count("any", shadow))

    monkeypatch.setattr(engine, "prepare", counting_prepare)
    out_b, out_r = tmp_path / "b.hdr", tmp_path / "r.hdr"
    argv = [str(rtc), "-p", "2", "--device", "cpu"]
    assert cli.main(argv + ["-o", str(out_b), "--backend", "bvh"]) == 0
    # depth 2 => 3 bounces a sample, 2 samples: one shadow call a bounce
    assert calls == {"any": 6, "nearest": 6}
    assert cli.main(argv + ["-o", str(out_r), "--backend", "brute"]) == 0
    assert calls["any"] == 6
    np.testing.assert_allclose(load_hdr(out_b), load_hdr(out_r), rtol=0.02,
                               atol=1e-3)    # .hdr's 8-bit mantissa


def test_prepare_big_scene_and_refresh(lv2):
    rtc, _, _ = lv2
    ps = prepare(rtc, device="cpu", force_backend="bvh", strategy="middle")
    assert ps.backend == "bvh-torch" and ps.strategy == "middle"
    assert ps.bvh is not None and ps.bvh_stats.nodes == ps.bvh.num_nodes
    assert ps.order_signs == engine.octant_signs(ps.camera.front)
    assert ps.shadow_intersect is None      # a path scene reads none
    again = engine.refresh_octant_order(ps, ps.camera.front)
    assert again is ps
    turned = engine.refresh_octant_order(ps, -ps.camera.front)
    assert turned.order_signs != ps.order_signs
    assert turned.bvh.num_nodes == ps.bvh.num_nodes
    assert not np.array_equal(turned.bvh.numpy("node_lo"),
                              ps.bvh.numpy("node_lo"))
    img = render_prepared(turned, _gen(0), samples=1, light_samples=1)
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()
    report = engine.render_report(ps, samples=1, light_samples=1,
                                  max_depth=1, seconds=1.0)
    assert report["bvh_nodes"] == ps.bvh_stats.nodes > 0


def test_regen_matches_wavefront_statistically(tmp_path):
    """Image means within 3 seed-to-seed sigmas of the wavefront's (both
    draw one jitter per pixel and sample)."""
    rtc = write_cornell(tmp_path, xres=24, yres=20, depth=4)
    ps = prepare(rtc, device="cpu")
    cfg = dict(samples=8, max_depth=4, light_samples=2)
    waves = [float(render(ps.scene, ps.camera, _gen(s), shared_jitter=False,
                          **cfg).mean()) for s in range(5)]
    sigma = float(np.std(waves, ddof=1))
    img = render_regen(ps.scene, ps.camera, _gen(100), **cfg)
    assert img.shape == (20, 24, 3) and torch.isfinite(img).all()
    assert abs(float(img.mean()) - float(np.mean(waves))) <= 3.0 * sigma, (
        float(img.mean()), waves)
    # a step cap ends the loop early: fewer paths, a darker image
    capped = render_regen(ps.scene, ps.camera, _gen(100), max_steps=3, **cfg)
    assert 0 < float(capped.mean()) < float(img.mean())
    # regen over the tree gives the same statistics as over the sweep
    ps_b = prepare(rtc, device="cpu", force_backend="bvh")
    img_b = render_regen(ps_b.scene, ps_b.camera, _gen(100),
                         intersect=ps_b.intersect, **cfg)
    assert abs(float(img_b.mean()) - float(np.mean(waves))) <= 3.0 * sigma


@pytest.mark.parametrize("how", [True, "octant", "morton"])
def test_sort_bounces_matches_unsorted_at_noise_level(tmp_path, how):
    rtc = write_cornell(tmp_path, xres=24, yres=20, depth=3)
    ps = prepare(rtc, device="cpu")
    cfg = dict(samples=8, max_depth=3, light_samples=2)
    plain = render(ps.scene, ps.camera, _gen(1), **cfg).numpy()
    other = render(ps.scene, ps.camera, _gen(2), **cfg).numpy()
    srt = render(ps.scene, ps.camera, _gen(1), sort_bounces=how,
                 **cfg).numpy()
    noise = np.abs(other - plain).mean()
    assert np.isfinite(srt).all()
    assert np.abs(srt - plain).mean() <= 1.5 * noise
    assert srt.mean() == pytest.approx(plain.mean(), rel=0.1)
    # Whitted tracing draws no uniforms: sorting only permutes the rays
    wps = prepare(write_cornell_whitted(tmp_path / "w", xres=16, yres=12,
                                        depth=2), device="cpu")
    a = render(wps.scene, wps.camera, _gen(0), max_depth=2).numpy()
    b = render(wps.scene, wps.camera, _gen(0), max_depth=2,
               sort_bounces=how).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="sort_bounces"):
        render(ps.scene, ps.camera, _gen(0), sort_bounces="hilbert")
