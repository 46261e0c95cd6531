"""The port's grouped-pointer walk (orion_tpu_torch/ops/bvh_g8.py) against
orion_tpu.ops.pallas_bvh_g8.make_bvh_intersect_g8 (interpret mode), on the
CPU, on the identical leaf-128 tree (JAX's, through bvh_from_numpy).

On the CPU the port's wrapper runs its plain version, kernel 5's plain
walk: the nearest hit is the same function, whatever the scheduling. Hit
masks are equal but for a ray through a triangle's edge (`_masks_agree`);
t agrees to rel 1e-5 where both hit, or to 1e-7 absolute (the same
float32 Woop test, which XLA may evaluate with fused multiply-adds; t =
-o_w / d_w cancels for a random origin millimetres from a wall: one ray
at t = 0.0029 is 3.5e-8 apart); an any-hit walk is held by its mask only
(its row may be another hit's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.accel.bvh import SAH, build_bvh as jbuild_bvh
from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.camera import primary_rays
from orion_tpu.ops import pallas_bvh_g8 as jg8
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch.accel.bvh import bvh_from_numpy
from orion_tpu_torch.ops import bvh_g8 as g8
from orion_tpu_torch.ops import bvh_intersect as bx

from cornell_scenes import write_cornell
from torch_port_util import g8_walk_model, jax_bvh_fields, to_torch


@pytest.fixture(scope="module", params=[0, 3])
def case(request, tmp_path_factory):
    """(JAX scene, its leaf-128 tree, the port's scene, the same tree,
    rays [N, 3] x 2 as numpy: a 16x16 camera's primaries and 256 random
    rays from inside the box)."""
    rtc = write_cornell(tmp_path_factory.mktemp(f"g8_{request.param}"),
                        xres=16, yres=16, depth=1, levels=request.param)
    js, jrtc = jload_scene(rtc)
    jbvh, _ = jbuild_bvh(np.asarray(js.tri_v0), np.asarray(js.tri_e1),
                         np.asarray(js.tri_e2), np.asarray(js.tri_valid),
                         strategy=SAH, leaf_size=128, leaf_width=128)
    po, pd = primary_rays(jcamera_from_rtc(jrtc), 0.001, 0.001)
    rng = np.random.default_rng(request.param)
    ro = rng.uniform((-0.95, 0.05, -0.95), (0.95, 1.95, 0.95), (256, 3))
    rd = rng.normal(size=(256, 3))
    o = np.concatenate([np.asarray(po), ro]).astype(np.float32)
    d = np.concatenate([np.asarray(pd), rd]).astype(np.float32)
    return js, jbvh, to_torch(js), bvh_from_numpy(jax_bvh_fields(jbvh)), o, d


def _masks_agree(ts, o, d, hit, ref):
    """Hit masks equal, but for rays through a triangle's edge: there one
    package's Woop test (XLA may contract its multiply-adds) and the
    other's (explicit float32 ops) may decide the seam either way. At these
    sizes that is one primary ray, through the seam of the right wall and
    the floor; any other difference fails."""
    m, mr = hit.mask.numpy(), np.asarray(ref.mask)
    t = np.where(m, hit.t.numpy(), np.asarray(ref.t))
    tid = np.where(m, hit.tri_id.numpy(), np.asarray(ref.tri_id))
    v0, e1, e2 = (ts.numpy(k).astype(np.float64)
                  for k in ("tri_v0", "tri_e1", "tri_e2"))
    off = np.nonzero(m != mr)[0]
    assert off.size <= max(1, m.size // 200), off
    for i in off:
        p = o[i].astype(np.float64) + float(t[i]) * d[i].astype(np.float64)
        j = int(tid[i])
        uv = np.linalg.lstsq(np.stack([e1[j], e2[j]], axis=1), p - v0[j],
                             rcond=None)[0]
        assert min(uv[0], uv[1], 1.0 - uv.sum()) < 1e-4, (i, uv)


@pytest.mark.parametrize("mode", ["nearest", "any-hit", "alive"])
def test_g8_matches_jax(case, mode):
    js, jbvh, ts, bvh, o, d = case
    any_hit = mode == "any-hit"
    alive = (np.arange(o.shape[0]) % 3 != 0) if mode == "alive" else None
    ref = jg8.make_bvh_intersect_g8(jbvh, js, interpret=True,
                                    any_hit=any_hit)(
        js, jnp.asarray(o), jnp.asarray(d),
        alive=None if alive is None else jnp.asarray(alive))
    fn = g8.make_bvh_intersect_g8(bvh, ts, any_hit=any_hit)
    hit = fn(ts, torch.as_tensor(o), torch.as_tensor(d),
             alive=None if alive is None else torch.as_tensor(alive))
    m, mr = hit.mask.numpy(), np.asarray(ref.mask)
    _masks_agree(ts, o, d, hit, ref)
    assert 0 < mr.sum() < mr.size
    if alive is not None:
        assert not m[~alive].any()
    if any_hit:
        assert (hit.t.numpy()[m] == 1.0).all()
        return
    both = m & mr
    np.testing.assert_allclose(hit.t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=1e-5, atol=1e-7)
    # kernel 5's IntersectFn on the same tree: the same function
    k5 = bx.make_bvh_intersect_kernel(bvh, ts)(
        ts, torch.as_tensor(o), torch.as_tensor(d),
        alive=None if alive is None else torch.as_tensor(alive))
    assert torch.equal(k5.tri_id, hit.tri_id) and torch.equal(k5.t, hit.t)


@pytest.mark.parametrize("mode", ["nearest", "any-hit", "alive"])
def test_g8_model_matches_jax(case, mode):
    """The CPU model of the CUDA kernel's schedule (a warp's shared
    pointer, each lane's resume range, the split leaf and its butterfly;
    torch_port_util.g8_walk_model) against the JAX G8 in interpret mode,
    by test_g8_matches_jax's checks: masks equal but at a triangle's edge,
    t within 1e-5 where both hit; and its (t, row) the plain walk's."""
    js, jbvh, ts, bvh, o, d = case
    any_hit = mode == "any-hit"
    alive = (np.arange(o.shape[0]) % 3 != 0) if mode == "alive" else None
    ref = jg8.make_bvh_intersect_g8(jbvh, js, interpret=True,
                                    any_hit=any_hit)(
        js, jnp.asarray(o), jnp.asarray(d),
        alive=None if alive is None else jnp.asarray(alive))
    nodes, tri = bx._bvh_device_layout(bvh, ts.device)
    hit = bx.rows_to_hits(bvh, ts, lambda oo, dd, aa: g8_walk_model(
        nodes, tri, oo, dd, aa, any_hit=any_hit))(
        ts, torch.as_tensor(o), torch.as_tensor(d),
        alive=None if alive is None else torch.as_tensor(alive))
    m, mr = hit.mask.numpy(), np.asarray(ref.mask)
    _masks_agree(ts, o, d, hit, ref)
    assert 0 < mr.sum() < mr.size
    if alive is not None:
        assert not m[~alive].any()
    plain = g8.make_bvh_intersect_g8(bvh, ts, any_hit=any_hit)(
        ts, torch.as_tensor(o), torch.as_tensor(d),
        alive=None if alive is None else torch.as_tensor(alive))
    assert torch.equal(plain.tri_id, hit.tri_id)
    assert torch.equal(plain.t, hit.t)
    if any_hit:
        return
    both = m & mr
    np.testing.assert_allclose(hit.t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=1e-5, atol=1e-7)


def test_leaf_width_and_inputs(case, tmp_path):
    """A tree of another leaf width raises, as in the JAX package; the
    layout can be shared with kernel 5's walk of the same tree."""
    _, _, ts, bvh, o, d = case
    from orion_tpu_torch.accel.bvh import build_bvh

    small, _ = build_bvh(ts.numpy("tri_v0"), ts.numpy("tri_e1"),
                         ts.numpy("tri_e2"), ts.numpy("tri_valid"),
                         leaf_size=16, leaf_width=16)
    with pytest.raises(ValueError, match="leaf_width=128"):
        g8.make_bvh_intersect_g8(small, ts)
    layout = bx._bvh_device_layout(bvh, ts.device)
    a = g8.make_bvh_intersect_g8(bvh, ts, layout=layout)(
        ts, torch.as_tensor(o), torch.as_tensor(d))
    b = g8.make_bvh_intersect_g8(bvh, ts)(ts, torch.as_tensor(o),
                                          torch.as_tensor(d))
    assert torch.equal(a.tri_id, b.tri_id)
    with pytest.raises(ValueError, match="unsupported device"):
        g8.bvh_g8(*layout, torch.as_tensor(o).to("meta"),
                  torch.as_tensor(d).to("meta"),
                  torch.ones(o.shape[0], dtype=torch.bool, device="meta"))
