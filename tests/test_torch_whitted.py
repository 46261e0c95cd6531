"""Port Whitted megakernel (ops/whitted.py) and closed-form Whitted trainer
(ops/prb_whitted.py) against the JAX package, and the CLI's Whitted route.

Tolerances:
  - host tables and gates: exact;
  - the kernel's plain version against JAX's kernel (Pallas interpret
    mode) on the same PCG seed: at most 1% of pixels off by more than
    1e-5 + 1e-4*|ref|, means within rel 1e-4 (tests/test_torch_fused.py's);
  - the trainer against JAX's on JAX's jitter draws: loss rel 1e-5,
    gradients rtol 1e-4 with atol 1e-6 x the largest entry (float32 op
    order in the shading sums);
  - the closed form against torch autograd of render(mode="whitted",
    prune_zero=False) on the same generator: loss rel 1e-5, gradients
    rtol 2e-4, atol 2e-5 x the largest entry (tests/test_prb_whitted.py's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.ops import pallas_fused as jf
from orion_tpu.ops import pallas_whitted as jw
from orion_tpu.ops import prb_whitted as jpw
from orion_tpu.ops.intersect import intersect_brute as jintersect_brute
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch import cli
from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.ops import prb_whitted as pw
from orion_tpu_torch.ops import whitted as wh
from orion_tpu_torch.ops.brute_intersect import intersect_brute_kernel
from orion_tpu_torch.render import render
from orion_tpu_torch.scene import load_scene

from chip_smoke import write_cornell, write_cornell_whitted
from torch_port_util import to_torch, write_textured

RES = 16
NAMES = ("mat_diffuse", "mat_specular", "mat_ambient", "mat_emissive")


@pytest.fixture(scope="module")
def whitted(tmp_path_factory):
    rtc = write_cornell_whitted(tmp_path_factory.mktemp("whitted"),
                                xres=RES, yres=RES, depth=3)
    js, jrtc = jload_scene(rtc)
    return js, jrtc, rtc


def test_table_and_lights_match_jax(whitted):
    js, _, _ = whitted
    ts = to_torch(js)
    assert np.array_equal(wh.pack_whitted_tri_table(ts),
                          jw.pack_whitted_tri_table(js))
    L, pos, color, inten = jw._lights_consts(js)
    lights = wh.pack_lights(ts)
    assert lights.shape == (L, wh.LIGHT_COLS) and L == 1
    assert np.array_equal(lights[:, 0:3], pos)
    assert np.array_equal(lights[:, 3:6], color)
    assert np.array_equal(lights[:, 6], inten)
    # the mirror box is the only glossy material
    assert (ts.numpy("mat_specular")[:, 0] > 0).sum() == 1


def test_gate_agrees(whitted, tmp_path):
    js, _, _ = whitted
    cases = {"whitted": js,
             "path": jload_scene(write_cornell(tmp_path / "p"))[0],
             "textured": jload_scene(write_textured(tmp_path))[0]}
    verdicts = {}
    for name, sc in cases.items():
        verdicts[name] = wh.fused_whitted_supported(to_torch(sc))
        assert verdicts[name] == jw.fused_whitted_supported(sc), name
        assert (pw.whitted_train_supported(to_torch(sc))
                == jpw.whitted_train_supported(sc)), name
    assert verdicts == {"whitted": True, "path": False, "textured": False}


@pytest.mark.parametrize("x, e", [(0.0, 0.0), (0.0, 20.0), (0.5, 20.0),
                                  (0.5, 0.0), (1.0, 3.0)])
def test_pow_like_c(x, e):
    ours = wh._pow_like_c(torch.tensor([x]), torch.tensor([e]))
    theirs = jw._pow_like_c(jnp.asarray([x], jnp.float32),
                            jnp.asarray([e], jnp.float32))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6)
    assert float(ours[0]) == pytest.approx(np.power(np.float32(x), e),
                                           rel=1e-5)


def test_plain_matches_jax_kernel(whitted):
    js, jrtc, _ = whitted
    key = jax.random.key(5)
    cfg = dict(samples=2, max_depth=3)
    theirs = np.asarray(jw.make_fused_whitted_renderer(
        js, jcamera_from_rtc(jrtc), ray_block=128, interpret=True,
        **cfg)(key))
    seed = int(jf.seed_scalar(key)[0])
    fn = wh.make_fused_whitted_renderer(
        to_torch(js), camera_from_rtc(jrtc, device="cpu"), **cfg)
    ours = fn(seed).numpy()
    assert ours.shape == theirs.shape == (RES, RES, 3)
    assert np.isfinite(ours).all() and theirs.mean() > 0
    off = np.abs(ours - theirs) > 1e-5 + 1e-4 * np.abs(theirs)
    assert off.any(axis=-1).mean() <= 0.01
    assert ours.mean() == pytest.approx(theirs.mean(), rel=1e-4)
    assert torch.equal(fn(seed), fn(seed))
    assert not torch.equal(fn(seed), fn(seed + 1))


def test_plain_counts_shadow_tests_to_first_hit(whitted):
    # one sample at depth 0: every lane's primary sweep over the real rows
    # plus, on hit lanes, a shadow sweep that stops at its first hit
    js, jrtc, _ = whitted
    ts = to_torch(js)
    T = ts.num_triangles
    args = wh.whitted_args(ts, camera_from_rtc(jrtc, device="cpu"))
    stats = {}
    wh.fused_whitted_plain(*args, 3, RES, RES, 1, 0, True, stats=stats)
    n = RES * RES
    assert n * T < stats["tests"] < 2 * n * T


def _jax_jitter(key, samples):
    out = []
    for k in range(samples):
        k_jit, _ = jax.random.split(jax.random.fold_in(key, k))
        out.append(np.asarray(jax.random.uniform(k_jit, (2,))))
    return np.stack(out)


@pytest.mark.parametrize("depth", [0, 2])
def test_train_step_matches_jax(whitted, depth):
    js, jrtc, _ = whitted
    samples = 2
    key = jax.random.key(3)
    target = np.random.default_rng(0).random((RES, RES, 3), np.float32)
    jstep = jpw.make_whitted_train_step(
        js, jcamera_from_rtc(jrtc), jnp.asarray(target), samples=samples,
        max_depth=depth, intersect=jintersect_brute)
    loss_j, g_j = jstep({k: getattr(js, k) for k in NAMES}, key)
    ts = to_torch(js)
    step = pw.make_whitted_train_step(
        ts, camera_from_rtc(jrtc, device="cpu"), target, samples=samples,
        max_depth=depth, intersect=intersect_brute_kernel)
    loss, g = step({k: getattr(ts, k) for k in NAMES}, 0,
                   jitter=_jax_jitter(key, samples))
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-5)
    for k in NAMES:
        want = np.asarray(g_j[k])
        np.testing.assert_allclose(g[k].numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)
    if depth > 0:
        assert np.abs(g["mat_specular"].numpy()).max() > 0


@pytest.mark.parametrize("depth", [0, 2])
def test_closed_form_matches_autograd(whitted, depth):
    js, jrtc, _ = whitted
    ts = to_torch(js)
    cam = camera_from_rtc(jrtc, device="cpu")
    samples, seed = 2, 11
    target = torch.as_tensor(
        np.random.default_rng(1).random((RES, RES, 3), np.float32))
    step = pw.make_whitted_train_step(ts, cam, target, samples=samples,
                                      max_depth=depth,
                                      intersect=intersect_brute_kernel)
    loss_cf, g_cf = step({k: getattr(ts, k) for k in NAMES}, seed)

    params = {k: getattr(ts, k).clone().requires_grad_(True) for k in NAMES}
    gen = torch.Generator()
    gen.manual_seed(seed)
    img = render(dataclasses.replace(ts, **params), cam, gen,
                 samples=samples, max_depth=depth, light_samples=1,
                 mode="whitted", intersect=intersect_brute_kernel,
                 prune_zero=False)
    loss_ad = torch.mean((img - target) ** 2)
    loss_ad.backward()
    assert float(loss_cf) == pytest.approx(float(loss_ad.detach()), rel=1e-5)
    for k in NAMES:
        want = params[k].grad.numpy()
        np.testing.assert_allclose(g_cf[k].numpy(), want, rtol=2e-4,
                                   atol=2e-5 * np.abs(want).max(), err_msg=k)
    assert np.abs(g_cf["mat_diffuse"].numpy()).max() > 0


def test_train_step_rejects_other_params(whitted):
    js, jrtc, _ = whitted
    ts = to_torch(js)
    step = pw.make_whitted_train_step(
        ts, camera_from_rtc(jrtc, device="cpu"), np.zeros((RES, RES, 3)),
        samples=1, max_depth=1, intersect=intersect_brute_kernel)
    with pytest.raises(ValueError, match="material tables"):
        step({"tri_v0": ts.tri_v0}, 0)


def test_cli_routes_whitted_to_kernel(whitted, tmp_path, capsys):
    _, _, rtc = whitted
    out = tmp_path / "w.hdr"
    assert cli.main([str(rtc), "-o", str(out), "-p", "2", "--device", "cpu",
                     "--stats"]) == 0
    assert "fused-whitted-kernel" in capsys.readouterr().out
    ts, r = load_scene(rtc, device="cpu")
    want = wh.make_fused_whitted_renderer(
        ts, camera_from_rtc(r, device="cpu"), samples=2,
        max_depth=r.recursion_level)(0).numpy()
    from orion_tpu_torch.io.image import load_hdr
    got = load_hdr(out)
    # .hdr stores RGBE: 8 mantissa bits per channel under a shared exponent
    assert got.shape == want.shape and np.isfinite(got).all()
    assert got.mean() == pytest.approx(want.mean(), rel=1e-2)
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def test_wrapper_rejects_other_devices(whitted):
    ts = to_torch(whitted[0])
    tab = torch.as_tensor(wh.pack_whitted_tri_table(ts), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wh.fused_whitted(tab, tab, tab, tab, tab, 0, 4, 4, 1, 1, True)
