"""The port's closed-form trainer over the bounce pipeline
(orion_tpu_torch/ops/bounce_prb.py) against
orion_tpu.ops.pallas_bounce_prb in interpret mode, on the CPU, on the
identical tree, table and PCG seed.

Tolerances, as the JAX package's own tests state them: loss rel 1e-6
against the renderer's MSE; gradients rtol 3e-4 with atol 3e-4 x the
largest entry, against JAX's step and against torch autograd of the port's
reference estimator (legacy NEE: it differs from the fast-shadow forward by
the light normal's rounding, ~1e-6).
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.ops import pallas_bounce_prb as jbp
from orion_tpu.ops import pallas_fused as jf
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch import optim
from orion_tpu_torch.accel.bvh import bvh_from_numpy
from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.ops import bounce as bo
from orion_tpu_torch.ops import bounce_prb as bpr
from orion_tpu_torch.ops import bvh_path as bp
from orion_tpu_torch.ops import prb
from orion_tpu_torch.ops.brute_intersect import intersect_brute_kernel
from orion_tpu_torch.scene import subdivide_scene

from cornell_scenes import two_emitter, write_cornell
from torch_port_util import jax_bvh_fields, to_torch

S, D, LS = 2, 3, 2


def _seed(k):
    key = jax.random.key(k)
    return key, int(jf.seed_scalar(key)[0])


def _grads_agree(ours, ref):
    for name in ("mat_diffuse", "mat_emissive"):
        a = ours[name].numpy() if torch.is_tensor(ours[name]) \
            else np.asarray(ours[name])
        b = ref[name].numpy() if torch.is_tensor(ref[name]) \
            else np.asarray(ref[name])
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, rtol=3e-4,
                                   atol=3e-4 * np.abs(b).max())


def _both(tmp, res, levels):
    rtc = write_cornell(tmp, xres=res, yres=res, depth=D, levels=levels)
    js, jrtc = jload_scene(rtc)
    target = (np.random.default_rng(0).random((res, res, 3), np.float32)
              * 0.3)
    return types.SimpleNamespace(
        js=js, jrtc=jrtc, jcam=jcamera_from_rtc(jrtc), ts=to_torch(js),
        cam=camera_from_rtc(jrtc, device="cpu"), target=target, res=res)


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    return _both(tmp_path_factory.mktemp("cornell"), 16, 0)


@pytest.mark.parametrize("res,levels,sort", [(16, 0, True), (8, 0, False),
                                             (8, 2, True)])
def test_train_step_matches_jax(tmp_path, res, levels, sort):
    b = _both(tmp_path, res, levels)
    key, seed = _seed(3)
    jstep = jbp.make_bounce_train_step(
        b.js, b.jcam, b.target, samples=S, max_depth=D, light_samples=LS,
        sort=sort, interpret=True)
    j_loss, j_grads = jstep(key)
    # the tree the JAX trainer built (deterministic), handed to the port
    _, jctx = jbp.make_bounce_train_core(
        b.js, b.jcam, samples=S, max_depth=D, light_samples=LS, sort=sort,
        interpret=True)
    step = bpr.make_bounce_train_step(
        b.ts, b.cam, b.target, samples=S, max_depth=D, light_samples=LS,
        sort=sort, bvh=bvh_from_numpy(jax_bvh_fields(jctx["bvh"])))
    loss, grads = step(seed)
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-6)
    assert grads["mat_diffuse"].shape == (b.ts.num_meshes, 3)
    _grads_agree(grads, j_grads)


def test_loss_is_the_renderers_mse_and_layout_is_free(cornell):
    b = cornell
    _, seed = _seed(4)
    step = bpr.make_bounce_train_step(b.ts, b.cam, b.target, samples=S,
                                      max_depth=D, light_samples=LS)
    loss, grads = step(seed)
    img = bo.make_bounce_path_renderer(b.ts, b.cam, samples=S, max_depth=D,
                                       light_samples=LS)(seed)
    mse = torch.mean((img - torch.as_tensor(b.target)) ** 2)
    assert float(loss) == pytest.approx(float(mse), rel=1e-6)
    # the card's tree layout and the unsorted wavefront: the same step
    for kw in (dict(leaf_width=2, octant_trees=False), dict(sort=False)):
        loss2, grads2 = bpr.make_bounce_train_step(
            b.ts, b.cam, b.target, samples=S, max_depth=D, light_samples=LS,
            **kw)(seed)
        assert float(loss2) == pytest.approx(float(loss), rel=1e-6)
        _grads_agree(grads2, grads)


def test_grads_match_autograd_of_the_reference(cornell):
    """A tie-broken box: every material's channels differ, so p = max(kd)
    has one argmax and the subgradient is the gradient."""
    b = cornell
    _, seed = _seed(5)
    kd = b.ts.mat_diffuse.clone()
    kd = torch.clamp(kd * torch.tensor([1.0, 0.93, 0.86]), 0.02, 0.95)
    ts = dataclasses.replace(b.ts, mat_diffuse=kd)
    loss, grads = bpr.make_bounce_train_step(
        ts, b.cam, b.target, samples=S, max_depth=D, light_samples=LS)(seed)
    ref_loss, ref = bpr.bounce_train_reference_grads(
        ts, b.cam, b.target, seed, samples=S, max_depth=D, light_samples=LS)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    _grads_agree(grads, ref)
    # and with the grey walls' three-way tie: the even split on both sides
    loss_t, grads_t = bpr.make_bounce_train_step(
        b.ts, b.cam, b.target, samples=S, max_depth=D,
        light_samples=LS)(seed)
    _, ref_t = bpr.bounce_train_reference_grads(
        b.ts, b.cam, b.target, seed, samples=S, max_depth=D,
        light_samples=LS)
    _grads_agree(grads_t, ref_t)


def test_dynamic_params_and_gate(cornell):
    b = cornell
    _, seed = _seed(6)
    static = bpr.make_bounce_train_step(b.ts, b.cam, b.target, samples=S,
                                        max_depth=D, light_samples=LS)
    dyn = bpr.make_bounce_train_step(b.ts, b.cam, b.target, samples=S,
                                     max_depth=D, light_samples=LS,
                                     dynamic_params=True)
    loss, grads = static(seed)
    loss_d, grads_d = dyn({"mat_diffuse": b.ts.mat_diffuse}, seed)
    assert list(grads_d) == ["mat_diffuse"]
    assert float(loss_d) == float(loss)
    assert torch.equal(grads_d["mat_diffuse"], grads["mat_diffuse"])
    # other albedos: the table's columns are regathered, the loss moves
    loss_2, _ = dyn({"mat_diffuse": b.ts.mat_diffuse * 0.5}, seed)
    half = dataclasses.replace(b.ts, mat_diffuse=b.ts.mat_diffuse * 0.5)
    loss_h, _ = bpr.make_bounce_train_step(
        half, b.cam, b.target, samples=S, max_depth=D,
        light_samples=LS)(seed)
    assert float(loss_2) == float(loss_h) != float(loss)
    with pytest.raises(ValueError, match="mat_emissive"):
        dyn({"mat_diffuse": b.ts.mat_diffuse,
             "mat_emissive": b.ts.mat_emissive}, seed)
    # the gate: one emitter, <= M_LANES materials, no textures
    assert bpr.wavefront_train_supported(b.ts)
    two = two_emitter(b.ts)
    assert bp.bvh_path_supported(two)
    assert not bpr.wavefront_train_supported(two)
    with pytest.raises(ValueError, match="wavefront-train gate"):
        bpr.make_bounce_train_step(two, b.cam, b.target, samples=S,
                                   max_depth=D)


def test_tab_updater_matches_pack(cornell):
    from orion_tpu_torch.accel.bvh import build_bvh

    ts = cornell.ts
    bvh, _ = build_bvh(ts.numpy("tri_v0"), ts.numpy("tri_e1"),
                       ts.numpy("tri_e2"), ts.numpy("tri_valid"),
                       leaf_size=2, leaf_width=2)
    update = bp.tab_updater_from_bvh(bvh, ts)
    assert torch.equal(update(),
                       torch.as_tensor(bp.pack_bvh_path_table(bvh, ts)))
    kd = (ts.mat_diffuse * 0.5).requires_grad_(True)
    tab = update(mat_diffuse=kd)
    other = dataclasses.replace(ts, mat_diffuse=kd.detach())
    assert torch.equal(tab.detach(),
                       torch.as_tensor(bp.pack_bvh_path_table(bvh, other)))
    (g,) = torch.autograd.grad(tab[:, 22:25].sum(), [kd])
    counts = ts.numpy("mesh_tri_count")[:ts.num_meshes]
    assert g[:, 0].tolist() == [float(c) for c in counts]


def test_fit_past_the_fused_gate_takes_the_bounce_route(cornell, monkeypatch):
    b = cornell
    big = subdivide_scene(b.ts, levels=5)
    assert not prb.fused_train_supported(big, S)
    assert bpr.wavefront_train_supported(big)
    target = bo.make_bounce_path_renderer(
        big, b.cam, samples=S, max_depth=D, light_samples=LS,
        leaf_width=8)(3).numpy()
    kd = big.mat_diffuse.clone()
    red = int(torch.argmax(kd[:, 0] - kd[:, 1]))
    kd[red] *= 0.6
    ps = types.SimpleNamespace(
        scene=dataclasses.replace(big, mat_diffuse=kd), camera=b.cam,
        backend="bvh-kernel", intersect=intersect_brute_kernel)
    calls = []
    real = bpr.make_bounce_train_step

    def spy(*a, **k):
        calls.append(k)
        # small leaves: the CPU's batched plain walk pays per leaf row
        return real(*a, leaf_width=8, **k)

    monkeypatch.setattr(bpr, "make_bounce_train_step", spy)
    # plain gradient descent: at 16x16 and 2 spp Adam's sign-sized first
    # steps also move the seven albedos that are already right
    res = optim.fit(ps, target, params=("mat_diffuse",), steps=5,
                    optimizer=lambda p: torch.optim.SGD(p, lr=2.0),
                    samples=S, max_depth=D, light_samples=LS, seed=3,
                    resample_keys=False)
    assert len(calls) == 1 and calls[0]["dynamic_params"] is True
    assert all(b < a for a, b in zip(res.losses, res.losses[1:]))
    err0 = float((kd[red] - big.mat_diffuse[red]).abs().sum())
    err1 = float((res.params["mat_diffuse"][red]
                  - big.mat_diffuse[red]).abs().sum())
    assert err1 < err0


@pytest.mark.parametrize("res,samples,route", [
    ((1920, 1080), 4, "bounce"),
    ((3840, 2160), 32, "bvh"),       # 265 M lanes: past the lane gate
])
def test_fit_route_follows_the_lane_gate(cornell, monkeypatch, res,
                                         samples, route):
    """Past the fused gate a diffuse-only fit takes the bounce trainer
    while its wavefront passes bounce.bounce_lanes_check, and the BVH
    PRB pair (no wavefront) past it."""
    from orion_tpu_torch.ops import bvh_prb as bvp

    monkeypatch.setattr(prb, "fused_train_supported", lambda *a: False)
    monkeypatch.setattr(bpr, "make_bounce_train_step",
                        lambda *a, **k: "bounce")
    monkeypatch.setattr(bvp, "make_bvh_train_step", lambda *a, **k: "bvh")
    cam = dataclasses.replace(cornell.cam, xres=res[0], yres=res[1])
    ps = types.SimpleNamespace(scene=cornell.ts, camera=cam)
    got = optim._prb_loss_and_grad(
        ps, None, ("mat_diffuse",), samples=samples, max_depth=8,
        light_samples=2, mode=None, loss_fn=None)
    assert got == route
