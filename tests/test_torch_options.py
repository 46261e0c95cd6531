"""The port's single-device render options and their oracles against the
JAX package: `mt_test`, `tangent_frame`, the shading oracles, `make_camera`,
normal maps, remat and folded samples.

Oracles are held elementwise (rtol 1e-5, atol 1e-6) on numpy inputs made
from a seed; the Whitted normal-map trace draws no random numbers, so on
identical rays the two packages agree to rtol 1e-4 (float32 op order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.camera import make_camera as jmake_camera
from orion_tpu.camera import primary_rays as jprimary_rays
from orion_tpu.ops import intersect as jix
from orion_tpu.ops import shade as jshade
from orion_tpu.render import trace_wavefront as jtrace
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch.camera import camera_from_rtc, make_camera, primary_rays
from orion_tpu_torch.ops import intersect as ix
from orion_tpu_torch.ops import shade
from orion_tpu_torch.ops.intersect import Hit, intersect_brute
from orion_tpu_torch.render import render, trace_wavefront

from cornell_scenes import write_cornell, write_cornell_whitted
from torch_port_util import to_torch

TOL = dict(rtol=1e-5, atol=1e-6)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.fixture(scope="module")
def textured(tmp_path_factory):
    """The Cornell box with the checker as map_Kd and the normal map as
    map_bump on every wall and box (two atlas images), in both packages,
    and one sample's hits of its primary rays (the JAX oracle's)."""
    rtc = write_cornell(tmp_path_factory.mktemp("tex"), xres=24, yres=20,
                        checker=True, bump=True)
    js, jrtc = jload_scene(rtc)
    jo, jd = jprimary_rays(jcamera_from_rtc(jrtc), 0.013, 0.021)
    jh = jix.intersect_brute(js, jo, jd)
    return js, to_torch(js), jo, jd, jh


def _hit(jh):
    return Hit(t=_t(jh.t), tri_id=_t(jh.tri_id))


def _t(x):
    return torch.as_tensor(np.array(x))


def test_mt_test_matches_jax(textured):
    js, ts, _, _, _ = textured
    rng = np.random.default_rng(3)
    o = rng.uniform((-0.9, 0.1, -0.9), (0.9, 1.9, 3.0), (256, 3))
    d = rng.normal(size=(256, 3))
    o, d = o.astype(np.float32), d.astype(np.float32)
    valid = np.asarray(js.tri_valid).copy()
    valid[::7] = False                       # the valid mask is honoured
    theirs = np.asarray(jix.mt_test(jnp.asarray(o), jnp.asarray(d),
                                    js.tri_v0, js.tri_e1, js.tri_e2,
                                    jnp.asarray(valid)))
    ours = ix.mt_test(torch.as_tensor(o), torch.as_tensor(d), ts.tri_v0,
                      ts.tri_e1, ts.tri_e2, torch.as_tensor(valid)).numpy()
    assert ours.shape == theirs.shape == (256, ts.tri_v0.shape[0])
    inf = np.isinf(theirs)
    assert np.array_equal(np.isinf(ours), inf)
    assert 0 < (~inf).sum() < inf.size
    assert np.isinf(ours[:, ::7]).all()
    np.testing.assert_allclose(ours[~inf], theirs[~inf], **TOL)
    # the nearest finite t of each ray is the Woop sweep's nearest hit
    near = ix.mt_test(torch.as_tensor(o), torch.as_tensor(d), ts.tri_v0,
                      ts.tri_e1, ts.tri_e2, ts.tri_valid).min(dim=1).values
    brute = intersect_brute(ts, torch.as_tensor(o), torch.as_tensor(d))
    assert torch.equal(torch.isinf(near), ~brute.mask)
    np.testing.assert_allclose(near[brute.mask].numpy(),
                               brute.t[brute.mask].numpy(), rtol=1e-4)


def test_tangent_frame_matches_jax(textured):
    js, ts, _, _, jh = textured
    jt, jb = jix.tangent_frame(js, jh)
    t, b = ix.tangent_frame(ts, _hit(jh))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), **TOL)
    # the walls whose u or v is constant take the (e1, e2) fallback, the
    # back wall a UV frame: both branches are held
    idx = torch.clamp(_hit(jh).tri_id, min=0).long()
    fallback = torch.all(t == ts.tri_e1[idx], dim=1)
    assert 0 < int(fallback.sum()) < fallback.numel()


def test_sample_texture_matches_jax(textured):
    js, ts, _, _, _ = textured
    rng = np.random.default_rng(4)
    n = 512
    imgs = int(np.asarray(js.tex_hw).shape[0])
    assert imgs == 2
    map_idx = rng.integers(-1, imgs, n).astype(np.int32)
    uv = rng.uniform(-3.0, 3.0, (n, 2)).astype(np.float32)
    solid = rng.uniform(size=(n, 3)).astype(np.float32)
    theirs = jshade.sample_texture(js, jnp.asarray(map_idx), jnp.asarray(uv),
                                   jnp.asarray(solid))
    ours = shade.sample_texture(ts, torch.as_tensor(map_idx),
                                torch.as_tensor(uv), torch.as_tensor(solid))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
    assert np.array_equal(ours.numpy()[map_idx < 0], solid[map_idx < 0])


def _surface(textured):
    """(JAX attrs, port attrs) at the primary hits."""
    js, ts, jo, jd, jh = textured
    ja = jix.hit_attributes(js, jo, jd, jh)
    ta = ix.hit_attributes(ts, _t(jo), _t(jd), _hit(jh))
    return ja, ta


def test_phong_and_brdf_match_jax(textured):
    js, ts, jo, jd, jh = textured
    ja, ta = _surface(textured)
    n = ta.point.shape[0]
    rng = np.random.default_rng(5)
    lpos = rng.uniform((-0.5, 1.5, -0.5), (0.5, 1.9, 0.5), (n, 3))
    lcol = rng.uniform(0.2, 1.0, (n, 3))
    lint = rng.uniform(0.5, 2.0, n)
    lnrm = rng.normal(size=(n, 3))
    lnrm /= np.linalg.norm(lnrm, axis=1, keepdims=True)
    args = [x.astype(np.float32) for x in (lpos, lcol, lint)]
    theirs = jshade.phong_color(js, ja.mat_id, ja.uv, jd, ja.s_normal,
                                ja.point, *map(jnp.asarray, args))
    ours = shade.phong_color(ts, ta.mat_id, ta.uv, _t(jd), ta.s_normal,
                             ta.point, *map(torch.as_tensor, args))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
    lnrm = lnrm.astype(np.float32)
    theirs = jshade.color_brdf(js, ja.mat_id, ja.uv, ja.s_normal, ja.point,
                               *map(jnp.asarray, args), jnp.asarray(lnrm))
    ours = shade.color_brdf(ts, ta.mat_id, ta.uv, ta.s_normal, ta.point,
                            *map(torch.as_tensor, args),
                            torch.as_tensor(lnrm))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
    assert float(ours.abs().max()) > 0


def test_perturb_normal_matches_jax(textured):
    js, ts, _, _, jh = textured
    ja, ta = _surface(textured)
    jt, jb = jix.tangent_frame(js, jh)
    t, b = ix.tangent_frame(ts, _hit(jh))
    theirs = np.asarray(jshade.perturb_normal(js, ja.mat_id, ja.uv,
                                              ja.s_normal, jt, jb))
    ours = shade.perturb_normal(ts, ta.mat_id, ta.uv, ta.s_normal, t,
                                b).numpy()
    np.testing.assert_allclose(ours, theirs, **TOL)
    # the emitter has no bump map and keeps its normal; the walls move
    bumped = ts.mat_map_bump[ta.mat_id] >= 0
    assert bool((~bumped).any()) and bool(bumped.any())
    np.testing.assert_array_equal(ours[~bumped.numpy()],
                                  ta.s_normal[~bumped].numpy())
    moved = np.abs(ours - ta.s_normal.numpy()).max(axis=1) > 1e-3
    assert moved[bumped.numpy()].mean() > 0.3


def test_make_camera_matches_jax():
    args = ((0.2, 1.1, 3.4), (0.0, 0.9, -0.2), (0.1, 1.0, 0.0), 0.8, 40, 24)
    jc = jmake_camera(*args)
    tc = make_camera(*args, device="cpu")
    assert (tc.xres, tc.yres) == (jc.xres, jc.yres)
    for f in ("origin", "front", "up", "right"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), **TOL)
    _, jd = jprimary_rays(jc, 0.01, 0.02)
    _, td = primary_rays(tc, 0.01, 0.02)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)


def test_whitted_normal_maps_match_jax_on_identical_rays(tmp_path):
    rtc = write_cornell_whitted(tmp_path, xres=20, yres=16, depth=2,
                                bump=True)
    js, jrtc = jload_scene(rtc)
    jo, jd = jprimary_rays(jcamera_from_rtc(jrtc), 0.01, 0.02)
    to, td = _t(jo), _t(jd)
    theirs = np.asarray(jtrace(js, jo, jd, jax.random.key(0), max_depth=2,
                               normal_maps=True))
    ours = trace_wavefront(to_torch(js), to, td, _gen(0), max_depth=2,
                           normal_maps=True).numpy()
    flat = trace_wavefront(to_torch(js), to, td, _gen(0),
                           max_depth=2).numpy()
    assert theirs.max() > 0
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)
    # the map moves the shading of most lit pixels (the reference's shadow
    # quirk leaves the rest black)
    lit = flat.max(axis=1) > 0
    moved = np.abs(ours - flat).max(axis=1) > 1e-3 * flat.max(axis=1)
    assert lit.mean() > 0.1 and moved[lit].mean() > 0.5, moved[lit].mean()


@pytest.mark.parametrize("mode", ["path", "whitted"])
def test_normal_maps_without_bump_map_change_nothing(tmp_path, mode):
    rtc = (write_cornell(tmp_path, xres=12, yres=10, depth=2) if mode == "path"
           else write_cornell_whitted(tmp_path, xres=12, yres=10, depth=2))
    js, jrtc = jload_scene(rtc)
    ts, cam = to_torch(js), camera_from_rtc(jrtc, device="cpu")
    assert bool((ts.mat_map_bump < 0).all())
    kw = dict(samples=2, max_depth=2, light_samples=2)
    on = render(ts, cam, _gen(3), normal_maps=True, **kw)
    off = render(ts, cam, _gen(3), **kw)
    assert torch.equal(on, off) and float(off.mean()) > 0


class _Spy:
    """An intersect that counts its calls (the plain brute sweep)."""

    def __init__(self):
        self.calls = 0

    def __call__(self, scene, orig, dirs, *, alive=None):
        self.calls += 1
        return intersect_brute(scene, orig, dirs, alive=alive)


@pytest.mark.parametrize("mode", ["path", "whitted"])
def test_remat_equals_plain_backward_without_intersects(tmp_path, mode):
    """remat=True and "hits" reschedule the backward pass only: the value
    and the gradients equal remat=False's (atol 1e-10), the forward makes
    the same intersect calls, and the recompute makes none."""
    rtc = (write_cornell(tmp_path, xres=12, yres=9, depth=3, bump=True)
           if mode == "path" else
           write_cornell_whitted(tmp_path, xres=12, yres=9, depth=3,
                                 bump=True))
    js, jrtc = jload_scene(rtc)
    ts, cam = to_torch(js), camera_from_rtc(jrtc, device="cpu")
    target = torch.zeros((9, 12, 3))
    out = {}
    for remat in (False, True, "hits"):
        kd = ts.mat_diffuse.clone().requires_grad_(True)
        v0 = ts.tri_v0.clone().requires_grad_(True)
        s = dataclasses.replace(ts, mat_diffuse=kd, tri_v0=v0)
        spy = _Spy()
        img = render(s, cam, _gen(0), samples=2, max_depth=3,
                     light_samples=2, intersect=spy, prune_zero=False,
                     normal_maps=True, remat=remat)
        loss = torch.mean((img - target) ** 2)
        fwd_calls = spy.calls
        loss.backward()
        assert spy.calls == fwd_calls, (remat, fwd_calls, spy.calls)
        out[remat] = (loss.detach(), kd.grad, v0.grad, fwd_calls)
    assert out[False][3] > 0
    for remat in (True, "hits"):
        assert out[remat][3] == out[False][3]
        for k in range(3):
            assert torch.allclose(out[remat][k], out[False][k], rtol=0,
                                  atol=1e-10), (remat, k)
    assert float(out[False][1].abs().sum()) > 0
    assert float(out[False][2].abs().sum()) > 0
    with pytest.raises(ValueError, match="remat"):
        render(ts, cam, _gen(0), remat="all")


def test_fold_samples_statistically_equivalent(tmp_path):
    """All spp as one wavefront: another order of the uniforms, the same
    estimator (means within rel 0.15, as the JAX package's test), and
    differentiable (with remat="hits" as there)."""
    rtc = write_cornell(tmp_path, xres=32, yres=18, depth=3)
    js, jrtc = jload_scene(rtc)
    ts, cam = to_torch(js), camera_from_rtc(jrtc, device="cpu")
    kw = dict(samples=16, max_depth=3, light_samples=2)
    scan = render(ts, cam, _gen(1), **kw)
    spy = _Spy()
    fold = render(ts, cam, _gen(1), fold_samples=True, intersect=spy, **kw)
    assert fold.shape == scan.shape and bool(torch.isfinite(fold).all())
    assert float(fold.mean()) == pytest.approx(float(scan.mean()), rel=0.15)
    # one nearest and one shadow sweep a bounce, each over S*H*W rays
    assert spy.calls == 2 * (3 + 1)
    per_pixel = render(ts, cam, _gen(1), fold_samples=True,
                       shared_jitter=False, **kw)
    assert float(per_pixel.mean()) == pytest.approx(float(scan.mean()),
                                                    rel=0.15)
    v = torch.ones((), requires_grad=True)
    s = dataclasses.replace(ts, mat_diffuse=ts.mat_diffuse * v)
    torch.mean(render(s, cam, _gen(1), fold_samples=True, remat="hits",
                      samples=2, max_depth=2, light_samples=1)).backward()
    assert bool(torch.isfinite(v.grad)) and float(v.grad) != 0.0
