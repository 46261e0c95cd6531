"""The port's path-replay trainer over a BVH (ops/bvh_prb.py, kernels 9a
and 9b) on the CPU, against the JAX package's `make_bvh_train_step` in
interpret mode, and `fit`'s route to it past the fused-train gate.

Tolerances: on the identical tree, scene and PCG seed the loss agrees to
rtol 1e-6 and both gradient tables to 3e-4 x their largest entry (the
bound PR 4 held the bounce trainer to: float32 terms in another op order,
summed in double). On a box without channel ties the tree trainer equals
the port's brute-sweep trainer to the same bound. On boxes written by
chip_smoke.write_cornell (levels 2 and 4, one tree or eight octant copies
of it, emission fitted), the loss agrees to rtol 1e-3 and the gradients to
1e-3 x their largest entry (chip_smoke.py's tolerances for the kernels):
an octant copy may break a tie between leaves the other way.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.accel.bvh import build_bvh as jbuild_bvh
from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.ops import pallas_bvh_path as jpp
from orion_tpu.ops import pallas_bvh_prb as jbp
from orion_tpu.ops import pallas_fused as jf
from orion_tpu.scene import Scene as JScene
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu.scene import subdivide_scene as jsubdivide
from orion_tpu_torch import optim
from orion_tpu_torch.accel.bvh import bvh_from_numpy
from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.ops import bvh_prb as bvp
from orion_tpu_torch.ops import fused_path as fp
from orion_tpu_torch.ops import prb
from orion_tpu_torch.scene import (STATIC_FIELDS, TENSOR_FIELDS, load_scene,
                                   scene_to_numpy)

from chip_smoke import two_emitter, write_cornell
from torch_port_util import (jax_bvh_fields, jax_fields, regroup_meshes,
                             to_torch, write_textured)

RES, S, D, LS = 8, 2, 3, 2
GRAD_REL = 3e-4


def _seed(k):
    return int(jf.seed_scalar(jax.random.key(k))[0])


def _grads_agree(ours, theirs):
    for k in ("mat_diffuse", "mat_emissive"):
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        scale = np.abs(b).max()
        assert scale > 0, k
        assert np.abs(a - b).max() <= GRAD_REL * scale, (k, np.abs(a - b).max())


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    rtc = write_cornell(tmp_path_factory.mktemp("cornell"), xres=RES,
                        yres=RES, depth=D)
    js, jrtc = jload_scene(rtc)
    target = np.random.default_rng(0).random((RES, RES, 3), np.float32) * 0.3
    return rtc, js, jrtc, target


def _jtree(js):
    jb, _ = jbuild_bvh(np.asarray(js.tri_v0), np.asarray(js.tri_e1),
                       np.asarray(js.tri_e2), np.asarray(js.tri_valid),
                       leaf_size=jpp.LEAF_WIDTH, leaf_width=jpp.LEAF_WIDTH)
    return bvh_from_numpy(jax_bvh_fields(jb))


@pytest.mark.parametrize("case,samples,want", [
    ("one-emitter", 32, True), ("one-emitter", 33, False),
    ("two-emitter", 32, False), ("textured", 1, False)])
def test_bvh_train_supported_agrees_with_jax(cornell, tmp_path, case,
                                             samples, want):
    _, js, _, _ = cornell
    ts = to_torch(js)
    if case == "two-emitter":
        ts = two_emitter(ts)
    elif case == "textured":
        ts = load_scene(write_textured(tmp_path), device="cpu")[0]
    f = scene_to_numpy(ts)
    jscene = JScene(**{n: jnp.asarray(f[n]) for n in TENSOR_FIELDS},
                    **{n: int(f[n]) for n in STATIC_FIELDS})
    assert bvp.bvh_train_supported(ts, samples) is want
    assert jbp.bvh_train_supported(jscene, samples) is want


@pytest.mark.parametrize("levels", [0, 1])
def test_bvh_train_step_matches_jax(cornell, levels):
    _, js, jrtc, target = cornell
    if levels:
        js = jsubdivide(js, levels=levels)
    theirs_loss, theirs = jbp.make_bvh_train_step(
        js, jcamera_from_rtc(jrtc), jnp.asarray(target), samples=S,
        max_depth=D, light_samples=LS, interpret=True)(jax.random.key(3))
    step = bvp.make_bvh_train_step(
        to_torch(js), camera_from_rtc(jrtc, device="cpu"), target, samples=S,
        max_depth=D, light_samples=LS, leaf_width=jpp.LEAF_WIDTH,
        bvh=_jtree(js))
    loss, grads = step(_seed(3))
    assert float(loss) == pytest.approx(float(theirs_loss), rel=1e-6)
    _grads_agree({k: v.numpy() for k, v in grads.items()}, theirs)


def _jscene(fields):
    return JScene(**{n: jnp.asarray(fields[n]) for n in TENSOR_FIELDS},
                  **{n: int(fields[n]) for n in STATIC_FIELDS})


@pytest.mark.parametrize("levels,octants,groups", [
    (2, 1, None), (2, 8, None), (4, 1, None), (4, 8, None), (2, 1, 1),
    (4, 8, 1)])
def test_plain_pair_matches_jax_on_written_boxes(tmp_path, levels, octants,
                                                 groups):
    """The plain pair (the kernels' yardstick on the card) against the JAX
    step with dynamic parameters, mat_diffuse and mat_emissive fitted, on
    a subdivided box written to tmp_path, walked as one tree or as eight
    octant copies. groups=1: every surface but the emitter one mesh of one
    material, so most lanes of a vertex hit the same material (the replay
    kernel sums such lanes in the warp before one shared atomic)."""
    rtc = write_cornell(tmp_path, xres=RES, yres=RES, depth=D, levels=levels)
    js, jrtc = jload_scene(rtc)
    if groups:
        js = _jscene(regroup_meshes(jax_fields(js), groups))
    target = np.random.default_rng(levels).random((RES, RES, 3),
                                                  np.float32) * 0.3
    kd = np.asarray(js.mat_diffuse) * np.float32(0.8)
    ke = np.asarray(js.mat_emissive) * np.float32(0.9)
    theirs_loss, theirs = jbp.make_bvh_train_step(
        js, jcamera_from_rtc(jrtc), jnp.asarray(target), samples=S,
        max_depth=D, light_samples=LS, interpret=True, dynamic_params=True)(
            {"mat_diffuse": jnp.asarray(kd), "mat_emissive": jnp.asarray(ke)},
            jax.random.key(3))
    step = bvp.make_bvh_train_step(
        to_torch(js), camera_from_rtc(jrtc, device="cpu"), target, samples=S,
        max_depth=D, light_samples=LS, leaf_width=jpp.LEAF_WIDTH,
        octants=octants, bvh=_jtree(js), dynamic_params=True)
    loss, grads = step({"mat_diffuse": torch.from_numpy(kd),
                        "mat_emissive": torch.from_numpy(ke)}, _seed(3))
    assert float(loss) == pytest.approx(float(theirs_loss), rel=1e-3)
    for k in ("mat_diffuse", "mat_emissive"):
        a, b = grads[k].numpy(), np.asarray(theirs[k])
        scale = np.abs(b).max()
        assert scale > 0, k
        assert np.abs(a - b).max() <= 1e-3 * scale, (k, np.abs(a - b).max())


def test_bvh_train_step_equals_brute_prb_untied(cornell):
    """No channel ties (kd perturbed per channel): the walk's and the
    sweep's trainers see the same paths and give the same gradients."""
    _, js, jrtc, target = cornell
    ts = to_torch(js)
    kd = ts.mat_diffuse * torch.tensor([1.0, 0.97, 0.94])
    ts = dataclasses.replace(ts, mat_diffuse=kd)
    cam = camera_from_rtc(jrtc, device="cpu")
    cfg = dict(samples=S, max_depth=D, light_samples=LS)
    loss_t, g_t = bvp.make_bvh_train_step(ts, cam, target, leaf_width=2,
                                          **cfg)(11)
    loss_b, g_b = prb.make_fused_train_step(ts, cam, target, **cfg)(11)
    assert float(loss_t) == pytest.approx(float(loss_b), rel=1e-6)
    _grads_agree(g_t, g_b)


def test_dynamic_params_step_and_rejects_specular(cornell):
    _, js, jrtc, target = cornell
    ts = to_torch(js)
    cam = camera_from_rtc(jrtc, device="cpu")
    step = bvp.make_bvh_train_step(ts, cam, target, samples=S, max_depth=D,
                                   light_samples=LS, dynamic_params=True)
    kd = ts.mat_diffuse * 0.9
    loss, g = step({"mat_diffuse": kd}, 5)
    assert set(g) == {"mat_diffuse"} and torch.isfinite(g["mat_diffuse"]).all()
    loss_b, g_b = prb.make_fused_train_step(
        ts, cam, target, samples=S, max_depth=D, light_samples=LS,
        dynamic_params=True)({"mat_diffuse": kd}, 5)
    assert float(loss) == pytest.approx(float(loss_b), rel=1e-6)
    with pytest.raises(ValueError, match="material tables only"):
        step({"mat_specular": ts.mat_specular}, 5)
    with pytest.raises(ValueError, match="bvh-train gate"):
        bvp.make_bvh_train_step(two_emitter(ts), cam, target, samples=S,
                                max_depth=D)


def test_plain_pair_counts_walk_work_and_checks_inputs(cornell):
    _, js, jrtc, _ = cornell
    ts = to_torch(js)
    nodes, M, update = bvp.make_bvh_tab_updater(ts, leaf_width=2)
    assert nodes.shape == (M, 8)
    tab = update()
    em = torch.as_tensor(fp.pack_emitters(ts))
    cam = fp.camera_vec(camera_from_rtc(jrtc, device="cpu"))
    stats = {}
    img, ls = bvp.bvh_fwd_ls(nodes, tab, em, cam, 4, RES, RES, S, D, LS,
                             leaf_width=2)
    ref, ls_ref = bvp.bvh_fwd_ls_plain(nodes, tab, em, cam, 4, RES, RES, S,
                                       D, LS, leaf_width=2, stats=stats)
    assert torch.equal(img, ref) and torch.equal(ls, ls_ref)
    assert stats["box_tests"] > 0 and stats["tests"] > 0
    # the forward's per-sample radiance averages to its image
    assert torch.allclose(ls.reshape(-1, S, 3).mean(dim=1), img, atol=1e-6)
    w = torch.full((RES * RES, 3), 1e-3)
    g = bvp.bvh_prb_replay(nodes, tab, em, cam, 4, w, ls, RES, RES, S, D, LS,
                           leaf_width=2)
    assert g.shape == (6, prb.M_LANES) and g.abs().max() > 0
    with pytest.raises(ValueError, match="exactly one"):
        bvp.bvh_fwd_ls(nodes, tab, em.repeat(2, 1), cam, 4, RES, RES, S, D,
                       LS, leaf_width=2)
    with pytest.raises(ValueError, match="samples"):
        bvp.bvh_fwd_ls(nodes, tab, em, cam, 4, RES, RES, 33, D, LS,
                       leaf_width=2)
    bad = tab.clone()
    bad[0, fp._C_MESH] = prb.M_LANES
    with pytest.raises(ValueError, match="accumulator columns"):
        bvp.bvh_prb_replay(nodes, bad, em, cam, 4, w, ls, RES, RES, S, D, LS,
                           leaf_width=2)


def test_fit_trains_emission_past_the_fused_gate(cornell, monkeypatch):
    """With the fused-train gate closed (as for a scene past its triangle
    cap), a fit that includes mat_emissive takes make_bvh_train_step, as
    the JAX package does, and lowers the loss."""
    rtc, js, jrtc, _ = cornell
    ts = to_torch(js)
    cam = camera_from_rtc(jrtc, device="cpu")
    target = fp.make_fused_path_renderer(ts, cam, samples=S, max_depth=D,
                                         light_samples=LS)(3)
    monkeypatch.setattr(prb, "fused_train_supported", lambda *a: False)
    made = []
    real = bvp.make_bvh_train_step
    monkeypatch.setattr(bvp, "make_bvh_train_step",
                        lambda *a, **k: made.append(k) or real(*a, **k))
    from orion_tpu_torch.engine import prepare

    ps = prepare(rtc, device="cpu")
    ke = ps.scene.mat_emissive * 0.7
    ps = dataclasses.replace(ps, scene=dataclasses.replace(
        ps.scene, mat_emissive=ke))
    # plain gradient steps (Adam would move every mesh's emission by its
    # learning rate at once and light the walls)
    res = optim.fit(ps, target, params=("mat_emissive",), steps=5,
                    optimizer=lambda p: torch.optim.SGD(p, lr=1.0),
                    samples=S, max_depth=D, light_samples=LS, seed=3,
                    resample_keys=False)
    assert len(made) == 1 and made[0]["dynamic_params"] is True
    assert all(b < a for a, b in zip(res.losses, res.losses[1:]))
    em = int(ts.numpy("emissive_mesh_ids")[0])
    assert (res.params["mat_emissive"][em] > ke[em]).all()
