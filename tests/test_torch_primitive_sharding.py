"""Primitive (triangle) sharding over torch.distributed, on the CPU.

The ranks run in 2- and 4-rank gloo worlds (tests/torch_dist_worker.py's
"tp" task, one spawn per world): (1, 2) and (2, 1) in the first, (1, 4)
and (2, 2) in the second. The JAX package runs on its 8 virtual CPU
devices (tests/conftest.py), as its own primitive-sharding tests do.

- The merged TP Hit equals the whole-table brute sweep (its plain version
  here) bit for bit: t and ids, alive honoured, ONE all-gather a call. It
  agrees with JAX's make_tp_intersect by id, or by t within rtol 1e-5
  where coplanar faces tie (JAX's slab test is Möller-Trumbore, the port's
  the Woop sweep).
- render_tp at (n_ray, n_tp) equals render_shardmap over the brute sweep
  on the same ray mesh bit for bit, path and Whitted; at (1, n_tp) that is
  `render(..., intersect=intersect_brute_kernel)`.
- Whitted draws no per-ray randoms: at JAX's primary-ray jitter the port's
  render_tp is held to JAX's render_tp within atol 1e-5 (rtol 1e-4, as
  tests/test_torch_render.py holds the Whitted wavefronts on identical
  rays).
- The TP train step's gradients (all-reduced over the ray group only)
  equal one device's within rtol 1e-4 (the JAX test's tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.parallel.primitive_sharding import make_mesh_2d as jmesh_2d
from orion_tpu.parallel.primitive_sharding import (
    make_tp_intersect as jtp_intersect)
from orion_tpu.parallel.primitive_sharding import render_tp as jrender_tp
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch.engine import prepare
from orion_tpu_torch.ops.brute_intersect import (brute_sweep_plain,
                                                 intersect_brute_kernel,
                                                 pack_tri_rows16)
from orion_tpu_torch.parallel.primitive_sharding import (make_mesh_2d,
                                                         make_tp_intersect,
                                                         render_tp)
from orion_tpu_torch.parallel.sharding import make_train_step
from orion_tpu_torch.render import render
from orion_tpu_torch.scene import subdivide_scene

import torch_dist_worker as dw
from torch_port_util import to_torch  # noqa: F401  (one thread a worker)

SHAPES = {2: [(1, 2), (2, 1)], 4: [(1, 4), (2, 2)]}
N_RAYS = 256


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _rays():
    rng = np.random.default_rng(7)
    orig = rng.uniform(-0.9, 0.9, (N_RAYS, 3)).astype(np.float32)
    orig[:, 1] += 1.0                       # inside the box
    dirs = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    alive = rng.uniform(size=N_RAYS) > 0.2
    return {"orig": orig, "dirs": dirs, "alive": alive}


def _jax_jitter(key):
    """The jitter of sample 0 of JAX's render_tp with `key`."""
    k_jit, _ = jax.random.split(jax.random.fold_in(key, 0))
    return [float(x) for x in np.asarray(jax.random.uniform(k_jit, (2,)))]


JAX_KEY = 11


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    return tmp, dw.write_scenes(tmp)


def _spawn(scenes, world):
    tmp, sc = scenes
    return dw.spawn_world("tp", world, tmp, scenes=sc, shapes=SHAPES[world],
                          rays=_rays(),
                          jitter=_jax_jitter(jax.random.key(JAX_KEY)))


@pytest.fixture(scope="module")
def world2(scenes):
    return _spawn(scenes, 2)


@pytest.fixture(scope="module")
def world4(scenes):
    return _spawn(scenes, 4)


def _cases():
    return [(w, s) for w in (2, 4) for s in SHAPES[w]]


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.fixture(scope="module")
def port(scenes):
    _, sc = scenes
    ps = prepare(sc["cornell"], device="cpu")
    return ps, prepare(sc["whitted"], device="cpu"), subdivide_scene(
        ps.scene, levels=2)


@pytest.mark.parametrize("world,shape", _cases())
def test_ranks_sit_on_the_grid(request, world, shape):
    ranks = request.getfixturevalue(f"world{world}")
    n_ray, n_tp = shape
    for r, res in enumerate(ranks):
        assert res[f"{_tag(shape)}_place"].tolist() == [
            r // n_tp, n_ray, r % n_tp, n_tp]


@pytest.mark.parametrize("world,shape", _cases())
def test_tp_hit_is_the_whole_sweep_bit_for_bit(request, port, world, shape):
    ranks = request.getfixturevalue(f"world{world}")
    ps, _, lv2 = port
    rays = _rays()
    o, d = torch.from_numpy(rays["orig"]), torch.from_numpy(rays["dirs"])
    alive = torch.from_numpy(rays["alive"])
    tag = _tag(shape)
    for name, sc in (("cornell", ps.scene), ("levels2", lv2)):
        t, ids = brute_sweep_plain(pack_tri_rows16(sc), o, d, alive)
        assert (ids >= 0).float().mean() > 0.5
        assert not bool((ids[~alive] >= 0).any())
        for res in ranks:
            np.testing.assert_array_equal(res[f"{tag}_{name}_id"],
                                          ids.numpy())
            np.testing.assert_array_equal(res[f"{tag}_{name}_t"], t.numpy())
            n_gathers, nbytes = res[f"{tag}_{name}_gathers"]
            if shape[1] == 1:
                assert n_gathers == 0
            else:                 # one [N, 2] int32 buffer from each rank
                assert (n_gathers, nbytes) == (1, N_RAYS * 8 * shape[1])


def test_tp_hit_agrees_with_jax(world2, scenes):
    """Rank 0's merged Hit of (1, 2) against JAX's TP intersect on its
    8-device mesh: ids equal, or t within rtol 1e-5 where faces tie."""
    _, sc = scenes
    js, _ = jload_scene(sc["cornell"])
    rays = _rays()
    fn = jtp_intersect(8)
    mesh = jmesh_2d(1, 8)

    @jax.shard_map(mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(),
                   check_vma=False)
    def run(scene, o, d):
        h = fn(scene, o, d)
        return h.t, h.tri_id

    jt, jid = (np.asarray(x) for x in run(js, jnp.asarray(rays["orig"]),
                                            jnp.asarray(rays["dirs"])))
    t, ids = world2[0]["1x2_cornell_t"], world2[0]["1x2_cornell_id"]
    alive = rays["alive"]
    # JAX's TP intersect ignores alive; compare the live rays
    assert np.array_equal(ids[alive] >= 0, jid[alive] >= 0)
    hit = alive & (ids >= 0)
    same = (ids == jid) | np.isclose(t, jt, rtol=1e-5, atol=0.0)
    assert same[hit].all()
    assert (ids == jid)[hit].mean() >= 0.95
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5)


@pytest.mark.parametrize("world,shape", _cases())
@pytest.mark.parametrize("mode", ["path", "whitted"])
def test_render_tp_is_render_shardmap_bit_for_bit(request, port, world,
                                                  shape, mode):
    ranks = request.getfixturevalue(f"world{world}")
    ps, pw, _ = port
    tag = _tag(shape)
    for res in ranks:
        img = res[f"{tag}_{mode}"]
        assert np.isfinite(img).all() and img.max() > 0
        np.testing.assert_array_equal(img, res[f"{tag}_{mode}_ref"])
        np.testing.assert_array_equal(img, ranks[0][f"{tag}_{mode}"])
    if shape[0] == 1:       # a ray world of one: render's own image
        with torch.no_grad():
            if mode == "path":
                ref = render(ps.scene, ps.camera, _gen(5), samples=2,
                             max_depth=3, light_samples=2, mode="path",
                             intersect=intersect_brute_kernel)
            else:
                ref = render(pw.scene, pw.camera, _gen(6), samples=2,
                             max_depth=2, light_samples=1, mode="whitted",
                             intersect=intersect_brute_kernel)
        np.testing.assert_array_equal(ranks[0][f"{tag}_{mode}"],
                                      ref.numpy())


@pytest.mark.parametrize("world,shape", _cases())
def test_render_tp_whitted_matches_jax(request, scenes, world, shape):
    ranks = request.getfixturevalue(f"world{world}")
    _, sc = scenes
    js, jrtc = jload_scene(sc["whitted"])
    theirs = np.asarray(jrender_tp(js, jcamera_from_rtc(jrtc),
                                   jax.random.key(JAX_KEY),
                                   mesh=jmesh_2d(1, 8), samples=1,
                                   max_depth=2, light_samples=1,
                                   mode="whitted"))
    assert theirs.max() > 0.01
    for res in ranks:
        np.testing.assert_allclose(res[f"{_tag(shape)}_whitted_jax"],
                                   theirs, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world,shape", _cases())
def test_tp_gradients_match_single_device(request, port, world, shape):
    ranks = request.getfixturevalue(f"world{world}")
    _, pw, _ = port
    target = torch.zeros((dw.H, dw.W, 3))
    kd = pw.scene.mat_diffuse
    step = make_train_step(pw.scene, pw.camera, samples=1, max_depth=1,
                           light_samples=1, mode="whitted", lr=1.0)
    new, loss = step({"mat_diffuse": kd}, _gen(8), target)
    ref = (kd - new["mat_diffuse"]).numpy()
    assert np.abs(ref).max() > 0
    for res in ranks:
        g = res[f"{_tag(shape)}_grad_kd"]
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, ref, rtol=1e-4, atol=1e-7)
        assert float(res[f"{_tag(shape)}_loss"]) == pytest.approx(
            float(loss), rel=1e-5)


def test_world_of_one_and_wrong_world(port):
    """Without a process group: make_mesh_2d(1, 1) is two Meshes without
    a group, the TP intersect issues no collective and is the whole sweep,
    and render_tp is render over the brute sweep; a world of the wrong
    size raises."""
    ps, _, _ = port
    ray, tp = make_mesh_2d(1, 1, device="cpu")
    assert (ray.group, ray.world, tp.group, tp.world) == (None, 1, None, 1)
    rays = _rays()
    o, d = torch.from_numpy(rays["orig"]), torch.from_numpy(rays["dirs"])
    h = make_tp_intersect(tp)(ps.scene, o, d)
    ref = intersect_brute_kernel(ps.scene, o, d)
    assert torch.equal(h.tri_id, ref.tri_id) and torch.equal(h.t, ref.t)
    cfg = dict(samples=2, max_depth=2, light_samples=1, mode="path")
    with torch.no_grad():
        assert torch.equal(
            render_tp(ps.scene, ps.camera, _gen(1), **cfg),
            render(ps.scene, ps.camera, _gen(1),
                   intersect=intersect_brute_kernel, **cfg))
    with pytest.raises(ValueError, match="need 2 ranks"):
        make_mesh_2d(1, 2, device="cpu")


@pytest.mark.parametrize("n_tp", [2, 3, 7, 50])
def test_slab_hits_merge_to_the_whole_sweep(port, n_tp):
    """Every rank's slab sweep merged in rank order is the whole-table
    sweep bit for bit, with empty slabs (50 slabs of a 36-row table) and
    with ties between slabs (the table's rows repeated)."""
    from orion_tpu_torch.parallel.primitive_sharding import (merge_slab_hits,
                                                             slab_hit)

    ps, _, _ = port
    rays = _rays()
    o, d = torch.from_numpy(rays["orig"]), torch.from_numpy(rays["dirs"])
    alive = torch.from_numpy(rays["alive"])
    for sc in (ps.scene, _doubled(ps.scene)):
        parts = [slab_hit(sc, o, d, alive, k, n_tp) for k in range(n_tp)]
        h = merge_slab_hits(torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts]))
        t, ids = brute_sweep_plain(pack_tri_rows16(sc), o, d, alive)
        assert torch.equal(h.tri_id, ids) and torch.equal(h.t, t)


def _doubled(scene):
    """The scene with its triangle table twice over: every hit ties with
    its copy T rows later, and the lower row must win."""
    from orion_tpu_torch.scene import scene_from_numpy, scene_to_numpy

    f = scene_to_numpy(scene)
    T = int(f["num_triangles"])
    for k in ("tri_v0", "tri_e1", "tri_e2", "tri_mat"):
        f[k] = np.concatenate([f[k][:T], f[k][:T]])
    f["tri_valid"] = np.ones(2 * T, bool)
    f["num_triangles"] = 2 * T
    return scene_from_numpy(f, "cpu")
