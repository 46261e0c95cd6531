"""Treelets: accel/bvh.partition_triangles and engine._make_treelet_intersect,
on the CPU (the walk kernel's plain version over each part's tree).

- partition_triangles gives the JAX package's masks exactly.
- With the cap lowered on the module (as tests/test_engine_cli.py lowers
  the JAX package's `pallas_bvh.RESIDENT_MAX_BUNDLED`), the treelet
  intersect's nearest hits are the brute sweep's: the same hit mask, ids
  on >= 99.9% of the hits, t within rtol 1e-3 (the tolerance of the JAX
  test: the trees' rows are float64-precomputed Woop rows, the brute
  table's float32 ones, and the random soup's slivers round apart). The
  same holds against JAX's _make_treelet_intersect, and the any-hit masks
  of both packages equal the brute sweep's mask.
- select_intersect routes to "bvh-kernel-treelet" only past the cap; the
  Whitted shadow rays take the any-hit chain; a geometry fit over treelets
  raises "refittable".
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import orion_tpu.ops.pallas_bvh as jpb
from cornell_scenes import write_cornell, write_cornell_whitted
from orion_tpu.accel.bvh import partition_triangles as jpartition
from orion_tpu.engine import _make_treelet_intersect as jtreelets
from orion_tpu.ops.intersect import intersect_brute as jintersect_brute
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu.scene import make_synthetic_scene as jsynthetic
from orion_tpu_torch import engine
from orion_tpu_torch.accel.bvh import partition_triangles
from orion_tpu_torch.engine import (_make_treelet_intersect, prepare,
                                    select_intersect)
from orion_tpu_torch.ops.brute_intersect import intersect_brute_kernel
from orion_tpu_torch.optim import fit
from orion_tpu_torch.render import render

from torch_port_util import to_torch

N_RAYS = 512


@pytest.fixture(scope="module")
def soup():
    js = jsynthetic(3000, seed=3)
    return js, to_torch(js)


def _rays():
    key = jax.random.key(0)
    orig = jax.random.uniform(key, (N_RAYS, 3), minval=-12.0, maxval=12.0)
    dirs = jax.random.normal(jax.random.fold_in(key, 1), (N_RAYS, 3))
    return orig, dirs


@pytest.fixture
def low_cap(monkeypatch):
    """Both packages' caps lowered so that a 3,000-triangle soup splits."""
    monkeypatch.setattr(engine, "RESIDENT_MAX_BUNDLED", 2048)
    monkeypatch.setattr(jpb, "RESIDENT_MAX_BUNDLED", 2048)


@pytest.mark.parametrize("max_tris", [7, 500, 1137, 3000, 5000])
@pytest.mark.parametrize("case", ["soup", "box", "masked"])
def test_partition_masks_equal_jax(tmp_path, soup, case, max_tris):
    if case == "soup":
        f = {k: np.asarray(getattr(soup[0], k))
             for k in ("tri_v0", "tri_e1", "tri_e2", "tri_valid")}
    else:
        js, _ = jload_scene(write_cornell(tmp_path, levels=2))
        f = {k: np.asarray(getattr(js, k))
             for k in ("tri_v0", "tri_e1", "tri_e2", "tri_valid")}
        if case == "masked":
            f["tri_valid"] = f["tri_valid"] & (np.arange(
                f["tri_valid"].shape[0]) % 3 != 1)
    args = (f["tri_v0"], f["tri_e1"], f["tri_e2"], f["tri_valid"], max_tris)
    ours, theirs = partition_triangles(*args), jpartition(*args)
    assert len(ours) == len(theirs) >= 1
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == bool
        np.testing.assert_array_equal(a, b)
    covered = np.sum(ours, axis=0)
    np.testing.assert_array_equal(covered, f["tri_valid"].astype(int))


def test_treelet_intersect_matches_brute_and_jax(soup, low_cap):
    js, ts = soup
    fn, stats = _make_treelet_intersect(ts, "sah", (1.0, 1.0, 1.0))
    assert fn.num_treelets > 1 and stats.nodes > 0
    jo, jd = _rays()
    o, d = torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jd))
    h = fn(ts, o, d)
    ref = intersect_brute_kernel(ts, o, d)
    hit_frac = float(ref.mask.float().mean())
    assert hit_frac > 0.3, f"degenerate test scene (hit {hit_frac})"
    assert torch.equal(h.mask, ref.mask)
    assert (h.tri_id == ref.tri_id).float().mean() >= 0.999
    np.testing.assert_allclose(h.t.numpy(), ref.t.numpy(), rtol=1e-3,
                               atol=1e-6)
    a = fn.any_hit_variant(ts, o, d)
    assert torch.equal(a.mask, ref.mask)
    assert bool((a.t[a.mask] == 1.0).all())

    jfn, _ = jtreelets(js, "sah", (1.0, 1.0, 1.0))
    assert jfn.num_treelets > 1
    jh = jfn(js, jo, jd)
    np.testing.assert_array_equal(h.mask.numpy(), np.asarray(jh.tri_id) >= 0)
    assert (h.tri_id.numpy() == np.asarray(jh.tri_id)).mean() >= 0.999
    np.testing.assert_allclose(h.t.numpy(), np.asarray(jh.t), rtol=1e-3,
                               atol=1e-6)
    ja = jfn.any_hit_variant(js, jo, jd)
    np.testing.assert_array_equal(a.mask.numpy(), np.asarray(ja.tri_id) >= 0)
    np.testing.assert_array_equal(
        np.asarray(jintersect_brute(js, jo, jd).tri_id) >= 0,
        ref.mask.numpy())


def test_treelet_alive_and_resplit(soup, monkeypatch):
    """Dead rays stay misses in both variants, and the any-hit chain walks
    a part only with the rays no earlier part occluded; a margin too small
    for the padding makes parts overflow the cap and split again, with the
    same hits."""
    _, ts = soup
    monkeypatch.setattr(engine, "RESIDENT_MAX_BUNDLED", 2048)
    monkeypatch.setattr(engine, "TREELET_MARGIN", 0.5)
    fn, _ = _make_treelet_intersect(ts, "sah", (1.0, 1.0, 1.0))
    jo, jd = _rays()
    o, d = torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jd))
    alive = torch.arange(N_RAYS) % 4 != 0
    ref = intersect_brute_kernel(ts, o, d, alive=alive)
    h = fn(ts, o, d, alive=alive)
    assert torch.equal(h.mask, ref.mask) and not bool(h.mask[~alive].any())
    assert (h.tri_id == ref.tri_id).float().mean() >= 0.999

    calls = []
    a = fn.any_hit_variant
    from orion_tpu_torch.ops import bvh_intersect as bx
    walk = bx.bvh_walk

    def spy(nodes, tri, orig, dirs, live, **kw):
        t, row = walk(nodes, tri, orig, dirs, live, **kw)
        calls.append((live.clone(), row >= 0))
        return t, row

    monkeypatch.setattr(bx, "bvh_walk", spy)
    got = a(ts, o, d, alive=alive)
    assert torch.equal(got.mask, ref.mask)
    # the margin's partition is one part, which overflows and splits
    v = [ts.numpy(k) for k in ("tri_v0", "tri_e1", "tri_e2", "tri_valid")]
    assert len(partition_triangles(*v, int(2048 / 0.5))) == 1
    assert len(calls) == fn.num_treelets >= 2
    occluded = torch.zeros(N_RAYS, dtype=torch.bool)
    for live, hit in calls:
        # a ray occluded by an earlier part walks no later one
        assert torch.equal(live, alive & ~occluded)
        occluded |= hit
    assert torch.equal(occluded, ref.mask)
    assert bool(calls[-1][0].sum() < calls[0][0].sum())


def test_select_intersect_route(tmp_path, monkeypatch):
    rtc = write_cornell_whitted(tmp_path / "w", xres=8, yres=6, depth=2,
                                levels=3)
    ps = prepare(rtc, device="cpu", force_backend="bvh-kernel")
    assert ps.backend == "bvh-kernel" and ps.bvh is not None
    assert ps.bvh.num_bundled < engine.RESIDENT_MAX_BUNDLED == 2 ** 27
    monkeypatch.setattr(engine, "RESIDENT_MAX_BUNDLED", 1500)
    pt = prepare(rtc, device="cpu", force_backend="bvh-kernel")
    assert pt.backend == "bvh-kernel-treelet" and pt.bvh is None
    assert pt.intersect.num_treelets > 1
    assert pt.shadow_intersect is pt.intersect.any_hit_variant
    # the CPU default (the batched PyTorch walk) and the brute gate keep
    # their routes
    assert prepare(rtc, device="cpu").backend == "bvh-torch"
    assert select_intersect(pt.scene, force="brute")[1] == "brute-kernel"
    # the Whitted wavefront over the treelets is the one tree's image
    cfg = dict(samples=1, max_depth=2, mode="whitted")
    g = [torch.Generator().manual_seed(0) for _ in range(2)]
    a = render(pt.scene, pt.camera, g[0], intersect=pt.intersect,
               shadow_intersect=pt.shadow_intersect, **cfg)
    b = render(ps.scene, ps.camera, g[1], intersect=ps.intersect,
               shadow_intersect=ps.shadow_intersect, **cfg)
    assert a.max() > 0
    assert (a - b).abs().max() <= 1e-5 * b.abs().max() + 1e-6 or \
        float(((a - b).abs() > 1e-4).float().mean()) <= 0.01
    # a geometry fit needs one refittable tree
    with pytest.raises(ValueError, match="refittable"):
        fit(pt, np.zeros((6, 8, 3), np.float32), params=("tri_v0",),
            steps=1, samples=1, max_depth=1)
    # and a material fit over treelets runs
    res = fit(dataclasses.replace(pt), b.numpy(), params=("mat_diffuse",),
              steps=1, samples=1, max_depth=1, use_prb=False)
    assert np.isfinite(res.losses[0])
