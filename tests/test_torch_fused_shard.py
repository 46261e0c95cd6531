"""The megakernel routes on pixel tiles (parallel/fused_shard.py), on the
CPU through the kernels' plain versions.

The kernels' PCG4D streams hash global pixel ids, so a tile launched at
pix_base renders the whole image's rows: the tiles of kernel 1, kernel 8,
7a and the bounce pipeline reassemble bit for bit into the single-device
image, at worlds 1, 2 and 3 (uneven tiles; 2 and 3 in gloo processes,
tests/torch_dist_worker.py). Kernel 1's assembled image is held against
the JAX package's make_fused_render_sharded on its 8 virtual devices
(interpret mode) at tests/test_torch_fused.py's tolerance (at most 1% of
pixels off by more than 1e-5 + 1e-4 |ref|, means within rel 1e-4). The
sharded train steps (3a/3b and the bounce trainer) issue ONE all-reduce
and their gradients equal the single-device step's within 1e-5 of the
largest entry (tile partials summed in another order).
"""

import jax
import numpy as np
import pytest
import torch

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.ops import pallas_fused as jf
from orion_tpu.parallel.fused_shard import (
    make_fused_render_sharded as jfused_sharded)
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch.engine import prepare
from orion_tpu_torch.ops import fused_path as fp
from orion_tpu_torch.ops import prb
from orion_tpu_torch.ops.bounce import make_bounce_path_renderer
from orion_tpu_torch.ops.bounce_prb import make_bounce_train_step
from orion_tpu_torch.ops.bvh_path import make_bvh_path_renderer
from orion_tpu_torch.ops.bvh_whitted import make_bvh_whitted_renderer
from orion_tpu_torch.parallel import fused_shard as fs
from orion_tpu_torch.parallel.sharding import Mesh, make_mesh

import torch_dist_worker as dw
from torch_port_util import to_torch  # noqa: F401  (one thread a worker)

CFG = dict(samples=2, max_depth=3, light_samples=2)
CPU = torch.device("cpu")
ROUTES = ("fused", "fused_lv2", "bvh_path", "bvh_whitted", "bounce")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fshard")
    return tmp, dw.write_scenes(tmp)


@pytest.fixture(scope="module")
def prepared(scenes):
    return {k: prepare(v, device="cpu") for k, v in scenes[1].items()
            if k != "stats"}


@pytest.fixture(scope="module")
def singles(prepared):
    """The single-device images of the five routes, seed 5."""
    ps, pw, lv2 = (prepared[k] for k in ("cornell", "whitted", "levels2"))
    return {
        "fused": fp.make_fused_path_renderer(ps.scene, ps.camera, **CFG)(5),
        "fused_lv2": fp.make_fused_path_renderer(lv2.scene, lv2.camera,
                                                 **CFG)(5),
        "bvh_path": make_bvh_path_renderer(lv2.scene, lv2.camera,
                                           **CFG)(5),
        "bvh_whitted": make_bvh_whitted_renderer(pw.scene, pw.camera,
                                                 samples=2,
                                                 max_depth=2)(5),
        "bounce": make_bounce_path_renderer(lv2.scene, lv2.camera, **CFG)(5),
    }


# the int32 PCG seed of the JAX key the JAX comparison renders with
JAX_KEY = 5


def _jax_seed() -> int:
    return int(jf.seed_scalar(jax.random.key(JAX_KEY))[0])


@pytest.fixture(scope="module")
def world2(scenes):
    return dw.spawn_world("megakernels", 2, scenes[0], scenes=scenes[1],
                          train=True, jax_seed=_jax_seed())


@pytest.fixture(scope="module")
def world3(scenes):
    return dw.spawn_world("megakernels", 3, scenes[0], scenes=scenes[1],
                          jax_seed=_jax_seed())


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("route", ROUTES)
def test_tiles_reassemble_bit_for_bit(request, singles, world, route):
    ref = singles[route].numpy()
    assert ref.shape == (dw.H, dw.W, 3) and ref.max() > 0
    for r in request.getfixturevalue(f"world{world}"):
        np.testing.assert_array_equal(r[route], ref)


@pytest.mark.parametrize("route", ROUTES)
def test_world_of_one_is_the_single_device_route(prepared, singles, route):
    mesh = make_mesh(device="cpu")
    ps, pw, lv2 = (prepared[k] for k in ("cornell", "whitted", "levels2"))
    fn = {
        "fused": lambda: fs.make_fused_render_sharded(
            ps.scene, ps.camera, mesh=mesh, **CFG),
        "fused_lv2": lambda: fs.make_fused_render_sharded(
            lv2.scene, lv2.camera, mesh=mesh, **CFG),
        "bvh_path": lambda: fs.make_bvh_render_sharded(
            lv2.scene, lv2.camera, mesh=mesh, **CFG),
        "bvh_whitted": lambda: fs.make_bvh_render_sharded(
            pw.scene, pw.camera, mesh=mesh, samples=2, max_depth=2),
        "bounce": lambda: fs.make_bounce_render_sharded(
            lv2.scene, lv2.camera, mesh=mesh, **CFG),
    }[route]()
    assert torch.equal(fn(5), singles[route])


@pytest.mark.parametrize("world", [1, 2, 3])
def test_kernel_1_3a_3b_plain_tiles(prepared, world):
    """The plain versions of kernels 1, 3a and 3b on each tile: 1's and
    3a's rows (image and L_s) are the whole image's bit for bit, and 3b's
    tile gradients add up to the whole image's (float64 sums in another
    order)."""
    ps = prepared["levels2"]
    args = fp.fused_args(ps.scene, ps.camera)
    cfg = (dw.W, dw.H, 2, 3, 2)
    N = dw.W * dw.H
    whole = fp.fused_path(*args, 5, *cfg)
    img, ls = prb.fused_fwd_ls(*args, 5, *cfg)
    w = (img * 0.5 + 0.01).contiguous() / (N * 3 * 2)
    g = prb.prb_replay(*args, 5, w, ls, *cfg)
    parts, imgs, lss, g_sum = [], [], [], torch.zeros_like(g)
    for rank in range(world):
        lo, hi = Mesh(None, rank, world, CPU).tile(N)
        parts.append(fp.fused_path(*args, 5, *cfg, pix_base=lo,
                                   n_lanes=hi - lo))
        i, l = prb.fused_fwd_ls(*args, 5, *cfg, pix_base=lo, n_lanes=hi - lo)
        imgs.append(i)
        lss.append(l)
        g_sum += prb.prb_replay(*args, 5, w[lo:hi].contiguous(), l, *cfg,
                                pix_base=lo, n_lanes=hi - lo)
    assert torch.equal(torch.cat(parts), whole)
    assert torch.equal(torch.cat(imgs), img)
    assert torch.equal(torch.cat(lss), ls)
    scale = float(g.abs().max())
    assert scale > 0 and float((g_sum - g).abs().max()) <= 1e-6 * scale


def test_tile_outside_the_image_raises(prepared):
    args = fp.fused_args(prepared["cornell"].scene, prepared["cornell"].camera)
    with pytest.raises(ValueError, match="outside"):
        fp.fused_path(*args, 5, dw.W, dw.H, 1, 1, 1, pix_base=70, n_lanes=8)
    with pytest.raises(ValueError, match="outside"):
        prb.fused_fwd_ls(*args, 5, dw.W, dw.H, 1, 1, 1, pix_base=-1)


@pytest.mark.parametrize("world", [2, 3])
def test_fused_render_sharded_matches_jax(request, scenes, world):
    js, jrtc = jload_scene(scenes[1]["cornell"])
    theirs = np.asarray(jfused_sharded(
        js, jcamera_from_rtc(jrtc), ray_block=128, interpret=True,
        devices=jax.devices()[:8], **CFG)(jax.random.key(JAX_KEY)))
    assert theirs.shape == (dw.H, dw.W, 3) and theirs.mean() > 0
    for r in request.getfixturevalue(f"world{world}"):
        ours = r["fused_jax"]
        assert np.isfinite(ours).all()
        off = np.abs(ours - theirs) > 1e-5 + 1e-4 * np.abs(theirs)
        assert off.any(axis=-1).mean() <= 0.01
        assert ours.mean() == pytest.approx(theirs.mean(), rel=1e-4)


def _grads_agree(ours, ref):
    scale = float(ref.abs().max())
    assert scale > 0
    assert np.abs(ours - ref.numpy()).max() <= 1e-5 * scale


def test_fused_train_step_sharded_matches_single(prepared, world2):
    ps = prepared["cornell"]
    target = torch.zeros((dw.H, dw.W, 3))
    params = {"mat_diffuse": ps.scene.mat_diffuse * 0.8,
              "mat_emissive": ps.scene.mat_emissive}
    loss, g = prb.make_fused_train_step(ps.scene, ps.camera, target,
                                        dynamic_params=True, **CFG)(params,
                                                                   11)
    for r in world2:
        assert float(r["fused_loss"]) == pytest.approx(float(loss),
                                                       rel=1e-5)
        _grads_agree(r["fused_kd"], g["mat_diffuse"])
        _grads_agree(r["fused_ke"], g["mat_emissive"])


def test_bounce_train_step_sharded_matches_single(prepared, world2):
    lv2 = prepared["levels2"]
    target = torch.zeros((dw.H, dw.W, 3))
    loss, g = make_bounce_train_step(lv2.scene, lv2.camera, target,
                                     **CFG)(11)
    for r in world2:
        assert float(r["bounce_loss"]) == pytest.approx(float(loss),
                                                        rel=1e-5)
        _grads_agree(r["bounce_kd"], g["mat_diffuse"])
        _grads_agree(r["bounce_ke"], g["mat_emissive"])


def test_sharded_train_steps_issue_one_all_reduce(world2):
    for r in world2:
        assert int(r["fused_ops"]) == 1
        assert int(r["fused_bytes"]) == 4 * (1 + 6 * prb.M_LANES)
        assert int(r["bounce_ops"]) == 1
        assert int(r["bounce_bytes"]) == 4 * (1 + 8 * prb.M_LANES + 3)
