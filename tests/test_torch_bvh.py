"""The port's BVH build, tree transforms, sort keys and walks against JAX.

Inputs come from numpy seeds or from the Cornell writer; the same arrays
go through the JAX function and its counterpart in the port.

Tolerances. Everything built on the host in NumPy (the tree, the
re-flattenings, the float64 Woop tables, the path table) must be EQUAL
array for array. Sort keys are integers: equal. Walks: a winner id may
differ where two triangles tie within rounding (shared edges of the
subdivided mesh, coplanar faces), so ids must agree on >= 99.9% of rays
and t to rtol 1e-5 + atol 1e-6 where they do; any-hit masks must be equal
(a mask does not depend on which of two tied triangles wins).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.accel.bvh import build_bvh as jbuild_bvh
from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.camera import primary_rays as jprimary_rays
from orion_tpu.ops import pallas_bvh as jpb
from orion_tpu.ops import pallas_bvh_path as jpp
from orion_tpu.ops import reorder as jreorder
from orion_tpu.ops.bvh_traverse import traverse as jtraverse
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch import native
from orion_tpu_torch.accel.bvh import (ARRAY_FIELDS, build_bvh,
                                       build_scene_bvh, bvh_from_numpy,
                                       bvh_to_numpy)
from orion_tpu_torch.ops import bvh_intersect as bx
from orion_tpu_torch.ops import bvh_path as bp
from orion_tpu_torch.ops import reorder
from orion_tpu_torch.ops.bvh_traverse import (make_bvh_intersect, traverse,
                                              walk_plain)
from orion_tpu_torch.ops.intersect import intersect_brute
from orion_tpu_torch.ops.woop import BIG, woop_t

from cornell_scenes import random_rays, write_cornell
from torch_port_util import jax_bvh_fields, to_torch

SIGNS = {"ppp": (1.0, 1.0, 1.0), "npn": (-1.0, 1.0, -1.0)}


def _soup(n=2000):
    rng = np.random.default_rng(0)
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    return v0, e1, e2, np.ones(n, bool)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """{name: (JAX scene, rtc)} of the levels-2 and levels-3 Cornell."""
    out = {}
    for lv in (2, 3):
        rtc = write_cornell(tmp_path_factory.mktemp(f"lv{lv}"), xres=24,
                            yres=18, depth=3, levels=lv)
        out[f"levels-{lv}"] = jload_scene(rtc)
    return out


def _tri_arrays(scenes, name):
    if name == "soup":
        return _soup()
    js = scenes[name][0]
    return tuple(np.asarray(getattr(js, f)) for f in
                 ("tri_v0", "tri_e1", "tri_e2", "tri_valid"))


def _assert_trees_equal(ours, jb):
    theirs = jax_bvh_fields(jb)
    mine = bvh_to_numpy(ours)
    assert mine["num_nodes"] == theirs["num_nodes"]
    assert mine["leaf_width"] == theirs["leaf_width"]
    for f in ARRAY_FIELDS:
        assert mine[f].dtype == theirs[f].dtype, f
        assert np.array_equal(mine[f], theirs[f]), f


@pytest.mark.parametrize("signs", sorted(SIGNS))
@pytest.mark.parametrize("leaf", [16, 128])
@pytest.mark.parametrize("strategy", ["median", "middle", "sah"])
@pytest.mark.parametrize("name", ["levels-2", "levels-3", "soup"])
def test_numpy_builder_equals_jax(scenes, name, strategy, leaf, signs):
    v0, e1, e2, valid = _tri_arrays(scenes, name)
    kw = dict(strategy=strategy, leaf_size=leaf, builder="numpy",
              order_signs=SIGNS[signs])
    ours, st = build_bvh(v0, e1, e2, valid, **kw)
    jb, jst = jbuild_bvh(v0, e1, e2, valid, **kw)
    _assert_trees_equal(ours, jb)
    assert (st.nodes, st.leaves, st.max_depth, st.padded_tris) == (
        jst.nodes, jst.leaves, jst.max_depth, jst.padded_tris)


def test_bvh_numpy_round_trip_and_bad_builder(scenes):
    v0, e1, e2, valid = _tri_arrays(scenes, "levels-2")
    bvh, _ = build_bvh(v0, e1, e2, valid, builder="numpy")
    again = bvh_from_numpy(bvh_to_numpy(bvh))
    for f in ARRAY_FIELDS:
        assert np.array_equal(again.numpy(f), bvh.numpy(f))
    on_dev = bvh.to("cpu")
    assert torch.is_tensor(on_dev.node_lo) and on_dev.num_bundled == \
        bvh.num_bundled
    with pytest.raises(ValueError, match="builder"):
        build_bvh(v0, e1, e2, valid, builder="embree")
    with pytest.raises(ValueError, match="zero valid"):
        build_bvh(v0, e1, e2, np.zeros_like(valid), builder="numpy")


def _jax_tree(scenes, name, leaf=128, strategy="sah"):
    v0, e1, e2, valid = _tri_arrays(scenes, name)
    jb, _ = jbuild_bvh(v0, e1, e2, valid, strategy=strategy, leaf_size=leaf,
                       builder="numpy")
    return jb, bvh_from_numpy(jax_bvh_fields(jb))


@pytest.mark.parametrize("name", ["levels-2", "levels-3"])
def test_tree_transforms_equal_jax(scenes, name):
    jb, ours = _jax_tree(scenes, name, leaf=16)
    tree_j = tuple(np.asarray(x) for x in
                   (jb.node_lo, jb.node_hi, jb.node_skip, jb.node_start))
    tree_t = tuple(ours.numpy(f) for f in
                   ("node_lo", "node_hi", "node_skip", "node_start"))
    for a, b in zip(bp.collapse_skip_levels(*tree_t),
                    jpp.collapse_skip_levels(*tree_j)):
        assert np.array_equal(a, b)
    for signs in ((1.0, -1.0, 1.0), (-1.0, -1.0, -1.0)):
        rf_t = bp.reflatten_octant(*tree_t, signs)
        rf_j = jpp.reflatten_octant(*tree_j, signs)
        for a, b in zip(rf_t, rf_j):
            assert np.array_equal(a, b)
        for a, b in zip(bp.collapse_skip_levels(*rf_t),
                        jpp.collapse_skip_levels(*rf_j)):
            assert np.array_equal(a, b)
    # the float64 host Woop table: ours is the transpose of theirs
    assert np.array_equal(
        bx.pack_tri_comps16(ours.numpy("tri_v0"), ours.numpy("tri_e1"),
                            ours.numpy("tri_e2")).T,
        np.asarray(jpb.pack_tri_comps16(jb.tri_v0, jb.tri_e1, jb.tri_e2)))


@pytest.mark.parametrize("octants", [1, 8])
@pytest.mark.parametrize("name", ["levels-2", "levels-3"])
def test_path_tables_equal_jax(scenes, name, octants):
    js = scenes[name][0]
    ts = to_torch(js)
    nodes_j, tab_j, m_j, jb = jpp.bvh_path_device_data(
        js, octants=octants, with_bvh=True, check_cap=False)
    ours = bvh_from_numpy(jax_bvh_fields(jb))
    assert np.array_equal(bp.pack_bvh_path_table(ours, ts).T,
                          jpp.pack_bvh_path_table(jb, js))
    assert np.array_equal(bp.pack_bvh_tex_table(ours, ts),
                          jpp.pack_bvh_tex_table(jb, js))
    nodes, tab, m = bp.bvh_path_device_data(ts, octants=octants, bvh=ours,
                                            leaf_width=128)
    assert m == m_j
    assert np.array_equal(tab.numpy().T, np.asarray(tab_j))
    lo, hi, skip, start = bx.unpack_nodes(nodes)
    theirs = [np.asarray(x) for x in nodes_j]
    for k in range(3):
        assert np.array_equal(lo[:, k].numpy(), theirs[k])
        assert np.array_equal(hi[:, k].numpy(), theirs[3 + k])
    assert np.array_equal(skip.numpy(), theirs[6])
    assert np.array_equal(start.numpy(), theirs[7])
    assert (start.numpy() & 1).any()      # some leaf holds no emitter row
    assert bp.bvh_path_supported(ts) == jpp.bvh_path_supported(js)
    assert bp.bounce_textured_supported(ts) == \
        jpp.bounce_textured_supported(js)
    with pytest.raises(ValueError, match="even"):
        bp.bvh_path_device_data(ts, leaf_width=7)


def test_coherence_keys_equal_jax(scenes):
    js = scenes["levels-2"][0]
    ts = to_torch(js)
    lo_j, hi_j = jreorder.scene_bounds(js)
    lo, hi = reorder.scene_bounds(ts)
    assert np.array_equal(lo.numpy(), np.asarray(lo_j))
    assert np.array_equal(hi.numpy(), np.asarray(hi_j))
    o, d, alive = random_rays(4096, 3, "cpu")
    key = reorder.coherence_key(o, d, alive, lo, hi)
    key_j = jreorder.coherence_key(jnp.asarray(o.numpy()),
                                   jnp.asarray(d.numpy()),
                                   jnp.asarray(alive.numpy()), lo_j, hi_j)
    assert key.dtype == torch.int32
    assert np.array_equal(key.numpy(), np.asarray(key_j))
    assert np.array_equal(reorder.direction_octant(d).numpy(),
                          np.asarray(jreorder.direction_octant(
                              jnp.asarray(d.numpy()))))
    q = torch.as_tensor(np.random.default_rng(1).integers(0, 64, (500, 3)),
                        dtype=torch.int32)
    assert np.array_equal(reorder.morton3(q).numpy(),
                          np.asarray(jreorder.morton3(jnp.asarray(q.numpy()))))
    # stable: equal keys keep their order
    k = torch.tensor([3, 1, 3, 1, 2], dtype=torch.int32)
    assert reorder.sort_permutation(k).tolist() == [1, 3, 4, 0, 2]
    assert np.array_equal(reorder.sort_permutation(key).numpy(),
                          np.asarray(jreorder.sort_permutation(key_j)))


def _rays(scenes, kind, n=1024):
    """(orig, dirs, alive) float32 numpy: primary rays of the scene's
    camera, random rays from inside the box (10% dead), or rays grazing
    the floor and walls (a zero direction component, origins just above
    a face)."""
    js, jrtc = scenes["levels-3"]
    if kind == "primary":
        o, d = jprimary_rays(jcamera_from_rtc(jrtc), 0.01, 0.02)
        o, d = np.array(o), np.array(d)
        return o, d, np.ones(o.shape[0], bool)
    if kind == "random":
        o, d, alive = random_rays(n, 5, "cpu")
        return o.numpy(), d.numpy(), alive.numpy()
    rng = np.random.default_rng(11)
    o = rng.uniform((-0.9, 0.001, -0.9), (0.9, 0.01, 0.9), (n, 3))
    d = rng.normal(size=(n, 3))
    d[:, 1] = np.where(rng.uniform(size=n) < 0.5, 0.0, 1e-4 * d[:, 1])
    return (o.astype(np.float32), d.astype(np.float32), np.ones(n, bool))


def _ids_agree(row_a, t_a, row_b, t_b):
    """ids equal on >= 99.9% of rays; t rtol 1e-5 + atol 1e-6 there."""
    same = row_a == row_b
    assert same.mean() >= 0.999, same.mean()
    both = same & (row_b >= 0)
    assert both.sum() > 0
    np.testing.assert_allclose(t_a[both], t_b[both], rtol=1e-5, atol=1e-6)
    assert np.isinf(t_a[row_a < 0]).all()


@pytest.mark.parametrize("kind", ["primary", "random", "grazing"])
def test_plain_walk_matches_jax_kernel(scenes, kind):
    js = scenes["levels-3"][0]
    jb, ours = _jax_tree(scenes, "levels-3", leaf=128)
    o, d, alive = _rays(scenes, kind)
    nodes, tri = bx._bvh_device_layout(ours, "cpu")
    to, td, ta = (torch.as_tensor(x) for x in (o, d, alive))
    for any_hit in (False, True):
        fn = jpb.make_bvh_intersect_pallas(jb, js, interpret=True,
                                           any_hit=any_hit)
        theirs = fn(js, jnp.asarray(o), jnp.asarray(d),
                    alive=jnp.asarray(alive))
        t, row = bx.bvh_walk(nodes, tri, to, td, ta, leaf_width=128,
                             any_hit=any_hit)
        assert row.dtype == torch.int32 and (row[~ta] == -1).all()
        mine = bx.make_bvh_intersect_kernel(ours, to_torch(js),
                                            any_hit=any_hit)(
            None, to, td, alive=ta)
        if any_hit:
            assert np.array_equal(mine.mask.numpy(),
                                  np.asarray(theirs.tri_id) >= 0)
            assert (mine.t[mine.mask] == 1.0).all()
            assert np.array_equal(row.numpy() >= 0, mine.mask.numpy())
        else:
            _ids_agree(mine.tri_id.numpy(), mine.t.numpy(),
                       np.asarray(theirs.tri_id), np.asarray(theirs.t))


@pytest.mark.parametrize("kind", ["primary", "random", "grazing"])
def test_traverse_matches_jax(scenes, kind):
    jb, ours = _jax_tree(scenes, "levels-3", leaf=16, strategy="median")
    o, d, _ = _rays(scenes, kind)
    t_j, row_j, st_j = jtraverse(jb, jnp.asarray(o), jnp.asarray(d),
                                 with_stats=True)
    t, row, st = traverse(ours.to("cpu"), torch.as_tensor(o),
                          torch.as_tensor(d), with_stats=True)
    _ids_agree(row.numpy(), t.numpy(), np.asarray(row_j), np.asarray(t_j))
    # the same walk does the same work, but for rays whose winner differs
    assert st.box_tests == pytest.approx(float(st_j.box_tests), rel=0.01)
    assert st.tri_tests == pytest.approx(float(st_j.tri_tests), rel=0.01)
    assert st.steps == pytest.approx(float(st_j.steps), abs=2)
    assert traverse(ours.to("cpu"), torch.as_tensor(o),
                    torch.as_tensor(d))[2] is None


def test_walk_counts_and_flat_box():
    """One leaf over one axis-aligned quad: its AABB is flat. A ray
    through it hits (the slab test's >=), a ray lying in its plane is
    decided by the other two axes and misses the triangles, a dead ray
    visits nothing."""
    v0 = np.array([[0, 0, 0], [0, 0, 0]], np.float32)
    e1 = np.array([[1, 0, 0], [1, 0, 1]], np.float32)
    e2 = np.array([[1, 0, 1], [0, 0, 1]], np.float32)
    bvh, st = build_bvh(v0, e1, e2, builder="numpy", leaf_size=4)
    assert (st.nodes, st.leaves) == (1, 1) and bvh.num_bundled == 4
    nodes, tri = bx._bvh_device_layout(bvh, "cpu")
    o = torch.tensor([[0.5, 1.0, 0.25], [-1.0, 0.0, 0.5], [0.5, 1.0, 0.25]])
    d = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    alive = torch.tensor([True, True, False])
    stats = {}
    t, row = bx.bvh_walk_plain(nodes, tri, o, d, alive, leaf_width=4,
                               stats=stats)
    assert row.tolist() == [0, -1, -1]
    assert t[0] == 1.0 and torch.isinf(t[1:]).all()
    # two live rays visit the one node; both reach the leaf's 2 real rows
    assert stats["box_tests"] == 2 and stats["tests"] == 4
    assert stats["leaf_visits"] == 2


def test_native_builder_hits_equal_numpy(scenes):
    if not native.native_available():
        with pytest.raises(RuntimeError, match="native builder"):
            build_scene_bvh(to_torch(scenes["levels-3"][0]),
                            builder="native")
        return
    ts = to_torch(scenes["levels-3"][0])
    o, d, alive = (torch.as_tensor(x) for x in _rays(scenes, "random"))
    ref = intersect_brute(ts, o, d)
    hits = {}
    for builder in ("native", "numpy"):
        bvh, st = build_scene_bvh(ts, strategy="sah", leaf_size=8,
                                  builder=builder)
        assert st.nodes == bvh.num_nodes and st.leaves > 0
        hits[builder] = make_bvh_intersect(bvh)(ts, o, d)
    assert torch.equal(hits["native"].mask, hits["numpy"].mask)
    assert torch.equal(hits["native"].mask, ref.mask)
    # both trees find the brute oracle's nearest t (ids may differ on
    # coplanar faces: rtol 1e-5)
    for h in hits.values():
        np.testing.assert_allclose(h.t[ref.mask].numpy(),
                                   ref.t[ref.mask].numpy(), rtol=1e-5)
    assert (hits["native"].tri_id == hits["numpy"].tri_id).float().mean() \
        >= 0.999


def test_walk_plain_octant_copies_and_cap(scenes):
    """Eight per-octant flattenings give the one-copy winners; a cap
    below the nearest hit gives a miss."""
    ts = to_torch(scenes["levels-2"][0])
    o, d, _ = (torch.as_tensor(x) for x in _rays(scenes, "random", 512))
    out = {}
    for octants in (1, 8):
        nodes, tab, m = bp.bvh_path_device_data(ts, octants=octants,
                                                leaf_width=8)
        tree = bp.TreeData.from_nodes(nodes, octants, 8)
        assert tree.per_copy * octants == m
        out[octants] = tree.nearest(tab[:, :13], o, d, 3.0e38, None)
    assert torch.equal(out[1][0], out[8][0])
    same = (out[1][1] == out[8][1]).float().mean()
    # t is equal bit for bit; where two coplanar faces tie exactly (box
    # bottoms on the floor) another visit order finds the other one first
    assert same >= 0.99
    t, row = out[1]
    lo, hi, skip, start = bx.unpack_nodes(nodes[:m // 8])
    t2, row2 = walk_plain(lo, hi, skip, start, tab, o, d, leaf_width=8,
                          cap=float(t[row >= 0].min()), flagged_starts=True)
    assert (row2 == -1).all()


def _tie_scene():
    """A 6x6 grid of unit quads on the plane y = 0 (two triangles each, so
    edges are shared), every third quad listed twice (coplanar copies that
    tie exactly), and a box standing on the grid (its bottom coplanar with
    the floor): (v0, e1, e2) float32."""
    tris = []
    for i in range(6):
        for k in range(6):
            a = np.array([i, 0, k], np.float64)
            quad = [(a, a + (1, 0, 0), a + (1, 0, 1)),
                    (a, a + (1, 0, 1), a + (0, 0, 1))]
            tris += quad * (2 if (6 * i + k) % 3 == 0 else 1)
    lo, hi = np.array([2.0, 0.0, 2.0]), np.array([3.5, 1.5, 3.5])
    c = [lo + (hi - lo) * np.array(b) for b in np.ndindex(2, 2, 2)]
    for f in ((0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
              (0, 2, 6, 4), (1, 5, 7, 3)):
        q = [c[j] for j in f]
        tris += [(q[0], q[1], q[2]), (q[0], q[2], q[3])]
    t = np.asarray(tris, np.float32)
    return t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]


@pytest.mark.parametrize("leaf", [2, 4])
def test_plain_walk_is_the_lexicographic_min_over_rows(leaf):
    """The walk's (t, row) is the least (t, row) over every bundled row,
    ties to the smallest row, on rays aimed at shared edges and vertices
    of a grid, at coplanar copies and at a box's bottom on the floor: what
    a walk in another order must compare to give the same winners. Leaves
    are in row order and the slab cull is strict, so the walk meets the
    least row of a tie first and keeps it. Where it does not give that
    winner, the float32 slab test of the winner's leaf or of one of its
    ancestors turned the ray away: a ray through a box's edge (tmax
    rounding below tmin), or a box whose tmin rounds up to the t the walk
    holds while the winner's t lies an ulp below it. Those rays are
    counted, and every one of them is such a ray."""
    v0, e1, e2 = _tie_scene()
    bvh, _ = build_bvh(v0, e1, e2, builder="numpy", leaf_size=leaf)
    nodes, tri = bx._bvh_device_layout(bvh, "cpu")
    rng = np.random.default_rng(3)
    n = 4096
    # targets on the grid's lines and vertices (half of them), or anywhere
    tgt = rng.uniform(0.0, 6.0, (n, 3))
    snap = rng.uniform(size=(n, 2)) < 0.5
    tgt[:, 0] = np.where(snap[:, 0], np.round(tgt[:, 0]), tgt[:, 0])
    tgt[:, 2] = np.where(snap[:, 1], np.round(tgt[:, 2]), tgt[:, 2])
    tgt[:, 1] = 0.0
    o = tgt + rng.uniform((-2.0, 2.0, -2.0), (2.0, 4.0, 2.0), (n, 3))
    o[: n // 4, 1] = -1.0            # a quarter from below (the box's bottom)
    o32 = torch.as_tensor(o, dtype=torch.float32)
    d32 = torch.as_tensor(tgt, dtype=torch.float32) - o32
    alive = torch.ones((n,), dtype=torch.bool)
    t, row = bx.bvh_walk_plain(nodes, tri, o32, d32, alive, leaf_width=leaf)
    # every row's t (misses and padding rows: BIG), then the least (t, row)
    w = tuple(tri[None, :, k] for k in range(13))
    t_all = woop_t((o32[:, 0:1], o32[:, 1:2], o32[:, 2:3]),
                   (d32[:, 0:1], d32[:, 1:2], d32[:, 2:3]), w)   # [n, B]
    t_min = t_all.min(dim=1).values
    first = torch.argmax((t_all == t_min[:, None]).to(torch.int8), dim=1)
    hit = t_min < BIG
    ties = ((t_all == t_min[:, None]).sum(dim=1) > 1) & hit
    assert int(ties.sum()) > n // 10        # the scene does tie
    ref = torch.where(hit, first, -1)
    same = row.long() == ref
    assert bool(torch.equal(t[same & hit], t_min[same & hit]))
    assert bool(torch.isinf(t[same & ~hit]).all())
    # each other ray: a box on the path to the winner's leaf turns it away
    lo, hi, skip, start = bx.unpack_nodes(nodes)
    for i in (~same).nonzero().flatten().tolist():
        leaf_node = int(((start >= 0) & (start <= ref[i])
                         & (ref[i] < start + leaf)).nonzero()[0])
        path = [k for k in range(leaf_node + 1)
                if k == leaf_node or int(skip[k]) > leaf_node]
        inv = 1.0 / d32[i]
        t0, t1 = (lo[path] - o32[i]) * inv, (hi[path] - o32[i]) * inv
        tmin = torch.minimum(t0, t1).max(dim=1).values
        tmax = torch.maximum(t0, t1).min(dim=1).values
        t_walk = float(t[i]) if int(row[i]) >= 0 else BIG
        passes = (tmax >= tmin) & (tmax > 0.0) & (tmin < t_walk)
        assert not bool(passes.all()), i
    assert int((~same).sum()) < n // 10, int((~same).sum())
