"""Port optim.fit (orion_tpu_torch/optim.py) and its gradient router
against the JAX package.

Tolerances: fit on the path-replay route for 5 Adam steps against JAX's
fit on the same PCG seed (resample_keys=False): losses rel 1e-4, fitted
params atol 1e-4 (torch.optim.Adam and optax.adam share the update rule;
their float32 op order differs). A plain SGD step equals
clamp(theta - lr * grad) to rtol 1e-6.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.ops import pallas_fused as jf
from orion_tpu.ops import pallas_prb as jp
from orion_tpu.ops import prb_wavefront as jpw
from orion_tpu.optim import fit as jfit
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu.scene import subdivide_scene as jsubdivide
from orion_tpu_torch import optim
from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.engine import BVH_NOT_PORTED, prepare
from orion_tpu_torch.ops import prb
from orion_tpu_torch.ops import prb_whitted as pw
from orion_tpu_torch.ops.brute_intersect import intersect_brute_kernel
from orion_tpu_torch.scene import subdivide_scene

from chip_smoke import write_cornell, write_cornell_whitted
from torch_port_util import to_torch

S, D, LS = 2, 3, 2
RES = 16


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    rtc = write_cornell(tmp_path_factory.mktemp("cornell"), xres=RES,
                        yres=RES, depth=D)
    js, jrtc = jload_scene(rtc)
    target = (np.random.default_rng(0).random((RES, RES, 3), np.float32)
              * 0.3)
    return rtc, js, jrtc, target


def _red_perturbed(kd):
    kd = np.array(kd, np.float32)
    red = int(np.argmax(kd[:, 0] - kd[:, 1]))
    kd[red] *= 0.6
    return kd


def _port_ps(ts, jrtc, backend="brute-kernel"):
    return types.SimpleNamespace(scene=ts,
                                 camera=camera_from_rtc(jrtc, device="cpu"),
                                 backend=backend,
                                 intersect=intersect_brute_kernel)


def test_fit_prb_matches_jax(cornell):
    _, js, jrtc, target = cornell
    js = dataclasses.replace(
        js, mat_diffuse=jnp.asarray(_red_perturbed(js.mat_diffuse)))
    cfg = dict(params=("mat_diffuse",), steps=5, learning_rate=0.05,
               samples=S, max_depth=D, light_samples=LS,
               resample_keys=False, use_prb=True)
    jps = types.SimpleNamespace(scene=js, camera=jcamera_from_rtc(jrtc),
                                backend="brute", intersect=None)
    theirs = jfit(jps, jnp.asarray(target), seed=3, **cfg)
    seed = int(jf.seed_scalar(jax.random.key(3))[0])
    ours = optim.fit(_port_ps(to_torch(js), jrtc), target, seed=seed, **cfg)
    assert len(ours.losses) == 5
    np.testing.assert_allclose(ours.losses, theirs.losses, rtol=1e-4)
    np.testing.assert_allclose(ours.params["mat_diffuse"].numpy(),
                               np.asarray(theirs.params["mat_diffuse"]),
                               atol=1e-4)
    assert torch.equal(ours.scene.mat_diffuse, ours.params["mat_diffuse"])


def test_fit_routes_to_prb_function(cornell, monkeypatch):
    _, js, jrtc, target = cornell
    calls = []
    real = prb.FusedPathPRB.apply
    monkeypatch.setattr(prb.FusedPathPRB, "apply",
                        lambda *a: calls.append(a[3]) or real(*a))
    res = optim.fit(_port_ps(to_torch(js), jrtc), target,
                    params=("mat_diffuse", "mat_emissive"), steps=2,
                    samples=S, max_depth=D, light_samples=LS, seed=9)
    assert len(calls) == 2 and calls[0] != calls[1]    # resampled seeds
    assert np.isfinite(res.losses).all()
    assert (res.params["mat_emissive"] >= 0).all()


def test_sgd_step_is_projected_gradient_step(cornell):
    _, js, jrtc, target = cornell
    ts = to_torch(js)
    seed, lr = 5, 0.5
    _, g = prb.make_fused_train_step(
        ts, camera_from_rtc(jrtc, device="cpu"), target, samples=S,
        max_depth=D, light_samples=LS)(seed)
    res = optim.fit(_port_ps(ts, jrtc), target, params=("mat_diffuse",),
                    steps=1, samples=S, max_depth=D, light_samples=LS,
                    seed=seed, resample_keys=False,
                    optimizer=lambda p: torch.optim.SGD(p, lr=lr))
    want = torch.clamp(ts.mat_diffuse - lr * g["mat_diffuse"], 0.0, 1.0)
    np.testing.assert_allclose(res.params["mat_diffuse"].numpy(),
                               want.numpy(), rtol=1e-6)


def test_project_clamps_in_place():
    params = {"mat_diffuse": torch.tensor([[-0.5, 0.5, 1.5]]),
              "mat_emissive": torch.tensor([[-1.0, 2.0, 0.0]]),
              "tri_v0": torch.tensor([[-3.0, 0.0, 3.0]])}
    kd = params["mat_diffuse"]
    optim._project(params)
    assert kd is params["mat_diffuse"]
    assert kd.tolist() == [[0.0, 0.5, 1.0]]
    assert params["mat_emissive"].tolist() == [[0.0, 2.0, 0.0]]
    assert params["tri_v0"].tolist() == [[-3.0, 0.0, 3.0]]


def test_use_prb_true_outside_gate_raises(cornell):
    _, js, jrtc, target = cornell
    with pytest.raises(ValueError, match="PRB gate"):
        optim.fit(_port_ps(to_torch(js), jrtc), target, params=("tri_v0",),
                  steps=1, use_prb=True)


def test_unported_routes_raise(cornell):
    _, js, jrtc, target = cornell
    # past the fused-train gate (T_pad > 16384), one emitter: JAX trains
    # diffuse with the bounce-pipeline PRB and materials with the BVH PRB
    big_j = jsubdivide(js, levels=5)
    assert not jp.fused_train_supported(big_j, S)
    assert jpw.wavefront_train_supported(big_j)
    big = subdivide_scene(to_torch(js), levels=5)
    assert not prb.fused_train_supported(big, S)
    ps = _port_ps(big, jrtc, backend=BVH_NOT_PORTED)
    cfg = dict(steps=1, samples=S, max_depth=D, light_samples=LS)
    with pytest.raises(NotImplementedError, match="bounce-pipeline PRB"):
        optim.fit(ps, target, params=("mat_diffuse",), **cfg)
    with pytest.raises(NotImplementedError, match="BVH PRB"):
        optim.fit(ps, target, params=("mat_diffuse", "mat_emissive"), **cfg)
    with pytest.raises(NotImplementedError, match="make_refit_loss"):
        optim.fit(ps, target, params=("tri_v0",), **cfg)
    with pytest.raises(NotImplementedError, match="make_refit_loss"):
        optim.make_refit_loss(ps)


def test_geometry_params_on_brute_take_wavefront_autograd(cornell):
    rtc, _, _, _ = cornell
    ps = prepare(rtc, device="cpu", xres=12, yres=8)
    assert ps.backend == "brute-kernel" and ps.shadow_intersect is None
    target = torch.full((8, 12, 3), 0.2)
    loss = optim.make_loss(ps.scene, ps.camera, samples=1, max_depth=1,
                           light_samples=1, mode=None,
                           intersect=ps.intersect)
    v0 = ps.scene.tri_v0.clone().requires_grad_(True)
    gen = torch.Generator()
    gen.manual_seed(0)
    (g,) = torch.autograd.grad(loss({"tri_v0": v0}, gen, target), [v0])
    assert torch.isfinite(g).all() and g.abs().max() > 0
    res = optim.fit(ps, target, params=("tri_v0",), steps=2, samples=1,
                    max_depth=1, light_samples=1, learning_rate=1e-2)
    assert np.isfinite(res.losses).all()
    moved = res.params["tri_v0"] - ps.scene.tri_v0
    assert torch.isfinite(moved).all() and moved.abs().max() > 0


def test_fit_routes_whitted_to_closed_form(tmp_path, monkeypatch):
    rtc = write_cornell_whitted(tmp_path, xres=12, yres=12, depth=1)
    ps = prepare(rtc, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    from orion_tpu_torch.render import render
    target = render(ps.scene, ps.camera, gen, samples=2, max_depth=1,
                    mode="whitted")
    calls = {"n": 0}
    real = pw.make_whitted_train_step

    def spy(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(pw, "make_whitted_train_step", spy)
    kd = torch.clamp(ps.scene.mat_diffuse * 0.5 + 0.2, 0.05, 0.95)
    ps_p = dataclasses.replace(ps, scene=dataclasses.replace(
        ps.scene, mat_diffuse=kd))
    res = optim.fit(ps_p, target, params=("mat_diffuse", "mat_specular"),
                    steps=8, learning_rate=0.05, samples=2, max_depth=1,
                    light_samples=1, mode="whitted", seed=0,
                    resample_keys=False, use_prb=True)
    assert calls["n"] == 1
    assert min(res.losses) < 0.5 * res.losses[0]
    # the Whitted route takes the wavefront with use_prb=False
    res_ad = optim.fit(ps_p, target, params=("mat_diffuse",), steps=1,
                       samples=2, max_depth=1, light_samples=1,
                       mode="whitted", seed=0, resample_keys=False,
                       use_prb=False)
    assert calls["n"] == 1
    assert res_ad.losses[0] == pytest.approx(res.losses[0], rel=1e-5)


def test_top_level_exports_fit():
    import orion_tpu_torch

    assert orion_tpu_torch.fit is optim.fit
    assert orion_tpu_torch.FitResult is optim.FitResult
