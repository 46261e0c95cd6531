"""Port Woop transform, camera, brute sweep, hit attributes and shading
against the JAX package, on inline scenes and rays made with numpy.

Tolerances: transform rows and primary rays rtol 1e-6 (float32 sums of
three products, evaluated in possibly different order); brute-sweep ids
equal except on at most 0.1% of rays (edge ties, where a 1-ulp difference
in a transform row flips the winner) and t rtol 1e-5 plus atol 1e-6 (XLA
may fuse the origin transform into FMAs: its absolute error is an ulp of
the scene scale, which dominates for origins within ~1e-2 of a surface,
t ~ 1e-2); hit attributes and shading rtol 1e-5 with atol 1e-6 for
components near zero.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.camera import primary_rays as jprimary_rays
from orion_tpu.ops import shade as jshade
from orion_tpu.ops.intersect import Hit as JHit
from orion_tpu.ops.intersect import hit_attributes as jhit_attributes
from orion_tpu.ops.intersect import intersect_brute as jintersect_brute
from orion_tpu.ops.pallas_intersect import intersect_brute_pallas
from orion_tpu.ops.woop import woop_rows as jwoop_rows
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu.scene import subdivide_scene as jsubdivide
from orion_tpu_torch.camera import camera_from_rtc, primary_rays
from orion_tpu_torch.ops import brute_intersect as bi
from orion_tpu_torch.ops import shade
from orion_tpu_torch.ops.intersect import hit_attributes, intersect_brute
from orion_tpu_torch.ops.woop import woop_rows, woop_rows_np

from cornell_scenes import random_rays, write_cornell
from torch_port_util import to_torch, write_textured

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    rtc = write_cornell(tmp_path_factory.mktemp("cornell"), xres=20, yres=12)
    js, jrtc = jload_scene(rtc)
    return js, jrtc, to_torch(js)


def test_woop_rows_f64_host_path(cornell):
    js, _, ts = cornell
    T = js.num_triangles
    args = [np.asarray(getattr(js, k))[:T] for k in ("tri_v0", "tri_e1",
                                                     "tri_e2")]
    np.testing.assert_allclose(woop_rows_np(*args),
                               jwoop_rows(*args, xp=np), rtol=1e-6, atol=0)


def test_woop_rows_f32_path(cornell):
    js, _, ts = cornell
    ours = woop_rows(ts.tri_v0, ts.tri_e1, ts.tri_e2, ts.tri_valid).numpy()
    theirs = np.asarray(jwoop_rows(js.tri_v0, js.tri_e1, js.tri_e2,
                                   js.tri_valid))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-7)


def test_camera_and_primary_rays(cornell):
    _, jrtc, _ = cornell
    jc, tc = jcamera_from_rtc(jrtc), camera_from_rtc(jrtc, device="cpu")
    for k in ("origin", "front", "up", "right"):
        np.testing.assert_allclose(getattr(tc, k).numpy(),
                                   np.asarray(getattr(jc, k)), rtol=1e-6,
                                   atol=1e-7)
    jo, jd = jprimary_rays(jc, 0.013, 0.021)
    to, td = primary_rays(tc, 0.013, 0.021)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)


def _ids_and_t_match(t_ours, id_ours, t_theirs, id_theirs):
    same = id_ours == id_theirs
    assert same.mean() >= 0.999, same.mean()
    hit = same & (id_theirs >= 0)
    assert hit.sum() > 0
    np.testing.assert_allclose(t_ours[hit], t_theirs[hit], rtol=1e-5,
                               atol=1e-6)
    assert np.isinf(t_ours[id_ours < 0]).all()


@pytest.mark.parametrize("levels", [0, 2])
def test_brute_plain_vs_jax_oracle(cornell, levels):
    js, _, _ = cornell
    js = jsubdivide(js, levels=levels) if levels else js
    ts = to_torch(js)
    o, d, _ = random_rays(3000, 7, "cpu")
    ours = intersect_brute(ts, o, d)
    theirs = jintersect_brute(js, jnp.asarray(o.numpy()),
                              jnp.asarray(d.numpy()))
    _ids_and_t_match(ours.t.numpy(), ours.tri_id.numpy(),
                     np.asarray(theirs.t), np.asarray(theirs.tri_id))


def test_brute_sweep_plain_vs_pallas_interpret(cornell):
    js, _, ts = cornell
    o, d, alive = random_rays(2000, 11, "cpu")
    ours = bi.intersect_brute_kernel(ts, o, d, alive=alive)
    theirs = intersect_brute_pallas(js, jnp.asarray(o.numpy()),
                                    jnp.asarray(d.numpy()), interpret=True,
                                    alive=jnp.asarray(alive.numpy()))
    id_ours = ours.tri_id.numpy()
    _ids_and_t_match(ours.t.numpy(), id_ours, np.asarray(theirs.t),
                     np.asarray(theirs.tri_id))
    assert (id_ours[~alive.numpy()] == -1).all()
    # the sweep and the oracle agree on live rays
    oracle = intersect_brute(ts, o, d)
    live = alive.numpy()
    assert (oracle.tri_id.numpy()[live] == id_ours[live]).all()


def test_hit_attributes_match_and_differentiate(cornell):
    js, _, ts = cornell
    o, d, _ = random_rays(1500, 3, "cpu")
    hit = intersect_brute(ts, o, d)
    jhit = JHit(t=jnp.asarray(hit.t.numpy()),
                tri_id=jnp.asarray(hit.tri_id.numpy()))
    theirs = jhit_attributes(js, jnp.asarray(o.numpy()),
                             jnp.asarray(d.numpy()), jhit)
    ours = hit_attributes(ts, o, d, hit)
    m = hit.mask.numpy()
    for k in ("t", "u", "v", "point", "g_normal", "s_normal", "uv"):
        np.testing.assert_allclose(getattr(ours, k).detach().numpy()[m],
                                   np.asarray(getattr(theirs, k))[m],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert np.array_equal(ours.mat_id.numpy()[m],
                          np.asarray(theirs.mat_id)[m])

    # autograd through the recompute at the detached hit ids
    v0 = ts.tri_v0.clone().requires_grad_(True)
    nrm = ts.n0.clone().requires_grad_(True)
    oo = o.clone().requires_grad_(True)
    ts2 = dataclasses.replace(ts, tri_v0=v0, n0=nrm)
    attrs = hit_attributes(ts2, oo, d, hit)
    loss = (attrs.point[hit.mask].sum() + attrs.s_normal[hit.mask].sum()
            + attrs.t[hit.mask].sum())
    loss.backward()
    for g in (v0.grad, nrm.grad, oo.grad):
        assert g is not None and torch.isfinite(g).all()
    assert v0.grad.abs().sum() > 0


def test_shading_matches(tmp_path):
    rtc = write_textured(tmp_path)
    js, _ = jload_scene(rtc)
    ts = to_torch(js)
    rng = np.random.default_rng(5)
    n = 400
    mat = rng.integers(0, js.num_meshes, n).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    kd_t = shade.diffuse_color(ts, torch.as_tensor(mat), torch.as_tensor(uv))
    kd_j = jshade.diffuse_color(js, jnp.asarray(mat), jnp.asarray(uv))
    np.testing.assert_allclose(kd_t.numpy(), np.asarray(kd_j), rtol=0, atol=0)

    def vec(scale=1.0):
        return rng.normal(size=(n, 3)).astype(np.float32) * scale

    nrm = vec()
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    args = dict(ka=vec(0.1), kd=np.abs(vec()), ks=np.abs(vec()),
                shininess=np.abs(rng.normal(size=n)).astype(np.float32) * 8,
                ray_dir=vec(), normal=nrm, hit_point=vec(),
                light_pos=vec(3.0), light_color=np.abs(vec()),
                light_intensity=np.abs(rng.normal(size=n)).astype(np.float32))
    ours = shade.phong_eval(**{k: torch.as_tensor(v) for k, v in args.items()})
    theirs = jshade.phong_eval(**{k: jnp.asarray(v) for k, v in args.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL,
                               atol=ATOL)

    bargs = dict(kd=np.abs(vec()), normal=nrm, hit_point=vec(),
                 light_pos=vec(3.0), light_color=np.abs(vec()),
                 light_intensity=np.abs(rng.normal(size=n)).astype(np.float32),
                 light_normal=nrm[::-1].copy())
    ours = shade.brdf_eval(**{k: torch.as_tensor(v) for k, v in bargs.items()})
    theirs = jshade.brdf_eval(**{k: jnp.asarray(v) for k, v in bargs.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL,
                               atol=ATOL)

    u1 = rng.uniform(size=n).astype(np.float32)
    u2 = rng.uniform(size=n).astype(np.float32)
    axis = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (4, 1))
    nrm2 = np.concatenate([nrm[:-4], axis])   # exercises the degenerate frame
    for ref in (False, True):
        ours = shade.cosine_sample(torch.as_tensor(nrm2), torch.as_tensor(u1),
                                   torch.as_tensor(u2), reference_frame=ref)
        theirs = jshade.cosine_sample(jnp.asarray(nrm2), jnp.asarray(u1),
                                      jnp.asarray(u2), reference_frame=ref)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=RTOL, atol=ATOL)

    np.testing.assert_allclose(
        shade.reflect(torch.as_tensor(args["ray_dir"]),
                      torch.as_tensor(nrm)).numpy(),
        np.asarray(jshade.reflect(jnp.asarray(args["ray_dir"]),
                                  jnp.asarray(nrm))), rtol=RTOL, atol=ATOL)

    em = int(np.asarray(js.emissive_mesh_ids)[0])
    ut, ua, ub = (rng.uniform(size=n).astype(np.float32) for _ in range(3))
    p_t, w_t, tri_t = shade.sample_mesh_point(
        ts, em, torch.as_tensor(ut), torch.as_tensor(ua), torch.as_tensor(ub))
    p_j, w_j, tri_j = jshade.sample_mesh_point(
        js, em, jnp.asarray(ut), jnp.asarray(ua), jnp.asarray(ub))
    assert np.array_equal(tri_t.numpy(), np.asarray(tri_j))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=RTOL)
