"""Port path-replay backprop (ops/prb.py, the legacy-NEE pieces of
ops/fused_path.py) against the JAX package.

The plain versions run the TPU kernels' estimator on the same PCG4D
stream, so given the same int32 seed they reproduce the JAX kernels (in
Pallas interpret mode). Tolerances:
  - host tables: bitwise;
  - training forward (image and per-sample radiance): at most 1% of
    pixels off by more than 1e-5 + 1e-4*|ref| and means within rel 1e-4
    (tests/test_torch_fused.py's);
  - train step against JAX's (kernel or AD oracle): loss rel 1e-5,
    gradients rtol 2e-4, atol 1e-7 (tests/test_prb.py's);
  - against torch autograd of the port's own oracle: the same;
  - linearity in the cotangent: rtol 1e-5, atol 1e-8.

Tie split: the grey Cornell walls have kd = (0.73, 0.73, 0.73), so the
Russian-roulette probability p = max(kd) ties three ways. The kernels
(and the port's oracle, through torch.amax) split its gradient evenly;
JAX's AD oracle (nested jnp.maximum) splits it 1/4, 1/4, 1/2. The port is
held against JAX's kernel on the tied scene and against JAX's AD oracle
on a tie-broken one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.ops import pallas_fused as jf
from orion_tpu.ops import pallas_prb as jp
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu.scene import subdivide_scene as jsubdivide
from orion_tpu_torch import profiling
from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.engine import prepare
from orion_tpu_torch.ops import fused_path as fp
from orion_tpu_torch.ops import prb
from orion_tpu_torch.optim import fit

from cornell_scenes import two_emitter, write_cornell
from torch_port_util import to_torch

S, D, LS = 2, 3, 2
RES = 16
NAMES = ("mat_diffuse", "mat_emissive")


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    rtc = write_cornell(tmp_path_factory.mktemp("cornell"), xres=RES,
                        yres=RES, depth=D)
    js, jrtc = jload_scene(rtc)
    target = (np.random.default_rng(0).random((RES, RES, 3), np.float32)
              * 0.3)
    return js, jrtc, target


def _variant(js, name):
    if name == "levels-2":
        return jsubdivide(js, levels=2)
    if name == "untied":
        kd = np.asarray(js.mat_diffuse) * np.float32([1.0, 0.99, 0.98])
        return dataclasses.replace(js, mat_diffuse=jnp.asarray(kd))
    return js


def _jax_step(js, jrtc, target, key_int):
    step = jp.make_fused_train_step(js, jcamera_from_rtc(jrtc),
                                    jnp.asarray(target), samples=S,
                                    max_depth=D, light_samples=LS,
                                    ray_block=128)
    loss, g = step(jax.random.key(key_int))
    return float(loss), {k: np.asarray(v) for k, v in g.items()}


def _seed(key_int):
    return int(jf.seed_scalar(jax.random.key(key_int))[0])


def _port_step(ts, jrtc, target, **kw):
    step = prb.make_fused_train_step(ts, camera_from_rtc(jrtc, device="cpu"),
                                     target, samples=S, max_depth=D,
                                     light_samples=LS, **kw)
    return step


def _assert_grads(got, want):
    for k in NAMES:
        np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=2e-4,
                                   atol=1e-7, err_msg=k)
    assert np.abs(want["mat_diffuse"]).max() > 1e-6
    assert np.abs(want["mat_emissive"]).max() > 1e-6


@pytest.mark.parametrize("name", ["cornell", "levels-2", "untied"])
def test_pack_table_torch_bitwise(cornell, name):
    js = _variant(cornell[0], name)
    ts = to_torch(js)
    ours = prb.pack_fused_tri_table_torch(ts).numpy()
    assert np.array_equal(ours, np.asarray(jf.pack_fused_tri_table_jnp(js)))
    assert np.array_equal(ours, fp.pack_fused_tri_table(ts))


def test_pack_table_torch_carries_gradients(cornell):
    ts = to_torch(cornell[0])
    kd = ts.mat_diffuse.clone().requires_grad_(True)
    ke = ts.mat_emissive.clone().requires_grad_(True)
    tab = prb.pack_fused_tri_table_torch(ts, kd, ke)
    tab[:, fp._C_KD].sum().backward()
    counts = np.bincount(ts.numpy("tri_mat")[:ts.num_triangles],
                         minlength=ts.num_meshes)
    assert np.array_equal(kd.grad[:, 0].numpy(), counts.astype(np.float32))
    assert kd.grad[:, 1:].abs().sum() == 0 and ke.grad.abs().sum() == 0


@pytest.mark.parametrize("name", ["cornell", "levels-2"])
def test_fwd_ls_plain_matches_jax_kernel(cornell, name):
    js, jrtc, _ = cornell
    js = _variant(js, name)
    n = RES * RES
    jtab = jnp.asarray(jf.pack_fused_tri_table(js))
    call = jp.build_fwd_ls_call(jtab.shape[0], RES, RES, S, D, LS,
                                jf._emitter_consts(js), n, 256, 128, True)
    planes, ls = call(jf.camera_vec(jcamera_from_rtc(jrtc)),
                      jf.seed_scalar(jax.random.key(5)),
                      jnp.zeros((1,), jnp.int32), jtab)
    theirs = (np.asarray(planes)[0:3, :n].T,
              np.asarray(ls)[:3 * S, :n].T)
    args = fp.fused_args(to_torch(js), camera_from_rtc(jrtc, device="cpu"))
    ours = fp.fused_fwd_ls_plain(*args, _seed(5), RES, RES, S, D, LS)
    for o, t in zip(ours, theirs):
        o = o.numpy()
        assert o.shape == t.shape and np.isfinite(o).all() and t.mean() > 0
        off = np.abs(o - t) > 1e-5 + 1e-4 * np.abs(t)
        assert off.any(axis=-1).mean() <= 0.01
        assert o.mean() == pytest.approx(t.mean(), rel=1e-4)
    # the image is the mean of the per-sample radiance
    img, ls_t = ours
    np.testing.assert_allclose(
        img.numpy(), ls_t.reshape(n, S, 3).sum(1).numpy() / S, rtol=1e-5,
        atol=1e-7)


@pytest.mark.parametrize("name", ["cornell", "levels-2"])
def test_prb_step_matches_jax(cornell, name):
    js, jrtc, target = cornell
    js = _variant(js, name)
    loss_j, g_j = _jax_step(js, jrtc, target, 3)
    loss, g = _port_step(to_torch(js), jrtc, target)(_seed(3))
    assert float(loss) == pytest.approx(loss_j, rel=1e-5)
    _assert_grads(g, g_j)


def test_prb_matches_jax_ad_oracle_untied(cornell):
    js, jrtc, target = cornell
    js = _variant(js, "untied")
    key = jax.random.key(3)
    jcam = jcamera_from_rtc(jrtc)

    def loss_fn(params):
        s = dataclasses.replace(js, **params)
        img = jf.fused_reference_render(s, jcam, key, samples=S,
                                        max_depth=D, light_samples=LS,
                                        tab=jf.pack_fused_tri_table_jnp(s))
        return jnp.mean((img - target) ** 2)

    params = {k: getattr(js, k) for k in NAMES}
    loss_o, g_o = jax.value_and_grad(loss_fn)(params)
    loss, g = _port_step(to_torch(js), jrtc, target)(_seed(3))
    assert float(loss) == pytest.approx(float(loss_o), rel=1e-5)
    _assert_grads(g, {k: np.asarray(v) for k, v in g_o.items()})


def test_prb_matches_torch_autograd_tied(cornell):
    js, jrtc, target = cornell
    ts = to_torch(js)
    cam = camera_from_rtc(jrtc, device="cpu")
    kd = ts.mat_diffuse.clone().requires_grad_(True)
    ke = ts.mat_emissive.clone().requires_grad_(True)
    img = fp.fused_reference_render(
        ts, cam, _seed(3), samples=S, max_depth=D, light_samples=LS,
        tab=prb.pack_fused_tri_table_torch(ts, kd, ke))
    loss_o = torch.mean((img - torch.as_tensor(target)) ** 2)
    loss_o.backward()
    loss, g = _port_step(ts, jrtc, target)(_seed(3))
    assert float(loss) == pytest.approx(float(loss_o.detach()), rel=1e-5)
    _assert_grads(g, {"mat_diffuse": kd.grad.numpy(),
                      "mat_emissive": ke.grad.numpy()})
    # the grey materials tie three ways, and the tie is split evenly
    grey = np.flatnonzero(np.ptp(ts.numpy("mat_diffuse"), axis=1) == 0)
    assert grey.size >= 2


def test_grad_fn_linear_in_cotangent(cornell):
    js, jrtc, _ = cornell
    gfn = prb.make_fused_grad_fn(to_torch(js),
                                 camera_from_rtc(jrtc, device="cpu"),
                                 samples=S, max_depth=D, light_samples=LS)
    cot = torch.as_tensor(np.random.default_rng(1).normal(
        size=(RES, RES, 3)).astype(np.float32))
    g1, g2 = gfn(_seed(3), cot), gfn(_seed(3), 2.5 * cot)
    for k in NAMES:
        np.testing.assert_allclose(g2[k].numpy(), 2.5 * g1[k].numpy(),
                                   rtol=1e-5, atol=1e-8)
        assert g1[k].abs().max() > 0


def test_backward_through_function_equals_step(cornell):
    js, jrtc, target = cornell
    ts = to_torch(js)
    cam = camera_from_rtc(jrtc, device="cpu")
    plan = prb.PRBPlan.build(ts, cam, samples=S, max_depth=D,
                             light_samples=LS)
    kd = ts.mat_diffuse.clone().requires_grad_(True)
    ke = ts.mat_emissive.clone().requires_grad_(True)
    img = prb.FusedPathPRB.apply(kd, ke, plan, _seed(3))
    assert img.shape == (RES, RES, 3)
    loss = torch.mean((img - torch.as_tensor(target)) ** 2)
    loss.backward()
    loss_s, g = _port_step(ts, jrtc, target)(_seed(3))
    assert float(loss.detach()) == float(loss_s)
    assert torch.equal(kd.grad, g["mat_diffuse"])
    assert torch.equal(ke.grad, g["mat_emissive"])


def test_static_and_dynamic_steps_agree(cornell):
    js, jrtc, target = cornell
    ts = to_torch(js)
    l_s, g_s = _port_step(ts, jrtc, target)(_seed(3))
    l_d, g_d = _port_step(ts, jrtc, target, dynamic_params=True)(
        {"mat_diffuse": ts.mat_diffuse}, _seed(3))
    assert float(l_s) == float(l_d)
    assert set(g_d) == {"mat_diffuse"}
    assert torch.equal(g_s["mat_diffuse"], g_d["mat_diffuse"])
    with pytest.raises(ValueError, match="material tables only"):
        _port_step(ts, jrtc, target, dynamic_params=True)(
            {"tri_v0": ts.tri_v0}, _seed(3))


def test_train_gate_agrees(cornell):
    js, jrtc, target = cornell
    cases = {"cornell": js, "levels-2": _variant(js, "levels-2"),
             "two-emitter": None}
    for name, sc in cases.items():
        ts = (two_emitter(to_torch(js)) if sc is None else to_torch(sc))
        if sc is not None:
            assert (prb.fused_train_supported(ts)
                    == jp.fused_train_supported(sc)), name
        assert prb.fused_train_supported(ts) == (name != "two-emitter")
    assert not prb.fused_train_supported(to_torch(js), prb.MAX_SAMPLES + 1)
    with pytest.raises(ValueError, match="gate"):
        prb.make_fused_train_step(two_emitter(to_torch(js)),
                                  camera_from_rtc(jrtc, device="cpu"),
                                  target, samples=S, max_depth=D)


def test_wrappers_reject_other_devices(cornell):
    ts = to_torch(cornell[0])
    tab = torch.as_tensor(fp.pack_fused_tri_table(ts), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        prb.fused_fwd_ls(tab, tab, tab, tab, tab, 0, 4, 4, 1, 1, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        prb.prb_replay(tab, tab, tab, tab, tab, 0, tab, tab, 4, 4, 1, 1, 1)


@pytest.mark.parametrize("where", ["table", "emitter"])
def test_replay_rejects_materials_past_accumulator(cornell, where):
    js, jrtc, _ = cornell
    tab, clo, chi, em, cam = fp.fused_args(
        to_torch(js), camera_from_rtc(jrtc, device="cpu"))
    if where == "table":
        tab[0, fp._C_MESH] = prb.M_LANES
    else:
        em[0, 0] = prb.M_LANES
    n = RES * RES
    w = torch.zeros((n, 3))
    ls = torch.zeros((n, 3 * S))
    with pytest.raises(ValueError, match="accumulator columns"):
        prb.prb_replay(tab, clo, chi, em, cam, 0, w, ls, RES, RES, S, D, LS)


@pytest.mark.parametrize("where", ["table", "emitter"])
def test_plan_rejects_materials_past_accumulator_when_built(cornell, where):
    """A plan checks its material ids once, when it is made, with the
    replay's error."""
    js, jrtc, _ = cornell
    ts = to_torch(js)
    base, clo, chi, em, cam = fp.fused_args(
        ts, camera_from_rtc(jrtc, device="cpu"))
    if where == "table":
        base[0, fp._C_MESH] = prb.M_LANES
    else:
        em[0, 0] = prb.M_LANES
    with pytest.raises(ValueError, match="accumulator columns"):
        prb.PRBPlan(scene=ts, base=base, clo=clo, chi=chi, em=em, cam=cam,
                    W=RES, H=RES, samples=S, max_depth=D, light_samples=LS)


def test_fit_checks_material_ids_once_a_plan(tmp_path):
    """A 3-step fit on the fused route reads the replay's material ids
    once (its plan's check), not once a step; on the CPU its losses are
    read by float, not from a host copy."""
    ps = prepare(write_cornell(tmp_path, xres=RES, yres=RES, depth=D),
                 device="cpu")
    target = fp.make_fused_path_renderer(ps.scene, ps.camera, samples=S,
                                         max_depth=D, light_samples=LS)(5)
    ps = dataclasses.replace(ps, scene=dataclasses.replace(
        ps.scene, mat_diffuse=ps.scene.mat_diffuse * 0.8))
    profiling.reset()
    try:
        with profiling.recording():
            res = fit(ps, target, params=("mat_diffuse",), steps=3,
                      samples=S, max_depth=D, light_samples=LS, seed=11)
        t = profiling.totals()
    finally:
        profiling.reset()
    assert t["prb.id_check"] == {"count": 1}
    assert t["fit.step"]["n"] == 3 and t["prb.table"]["n"] == 3
    assert "fit.loss_event" not in t
    assert len(res.losses) == 3
