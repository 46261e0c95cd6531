"""Ray sharding of the wavefront over torch.distributed, on the CPU.

Multi-rank checks run in 2 and 3 gloo processes (tests/torch_dist_worker.py;
11x7 pixels, so the tiles are uneven: 39 + 38 and 26 + 26 + 25), one spawn
per world whose results every test here reads. The JAX package runs on
its 8 virtual CPU devices (tests/conftest.py), as its own shard tests do.

- render_sharded draws the whole image's uniforms on every rank and keeps
  its tile's slice: its image is one device's `render` bit for bit.
- render_shardmap / render_regen_shardmap fold the rank into the stream:
  deterministic per (seed, world size); held statistically (correlation
  > 0.93, means within rel 0.15, tests/test_torch_render.py's thresholds
  for two estimators of one image) against the single-device render and
  against the JAX package's shard_map paths. A world of one traces on the
  caller's generator and equals the unsharded route.
- make_train_step's gradients equal the unsharded step's within rtol
  1e-4 (tests/test_sharding.py holds JAX to the same), from ONE
  all-reduce whose bytes are the flattened gradients plus the loss.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.parallel.sharding import make_mesh as jmake_mesh
from orion_tpu.parallel.sharding import render_sharded as jrender_sharded
from orion_tpu.parallel.shardmap_render import (
    render_shardmap as jrender_shardmap)
from orion_tpu.regen import render_regen_shardmap as jregen_shardmap
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch import cli
from orion_tpu_torch.engine import prepare
from orion_tpu_torch.io.checkpoint import load_checkpoint
from orion_tpu_torch.io.image import load_hdr
from orion_tpu_torch.parallel import distributed as pdist
from orion_tpu_torch.parallel.sharding import (Mesh, make_mesh,
                                               make_train_step,
                                               render_sharded)
from orion_tpu_torch.parallel.shardmap_render import (rank_generator,
                                                      render_shardmap)
from orion_tpu_torch.regen import render_regen, render_regen_shardmap
from orion_tpu_torch.render import _path_draws, render, trace_wavefront
from orion_tpu_torch.camera import primary_rays

import torch_dist_worker as dw
from torch_port_util import to_torch  # noqa: F401  (one thread a worker)

PATH = dict(samples=2, max_depth=3, light_samples=2)
CPU = torch.device("cpu")


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _corr(a, b):
    return float((a * b).sum()
                 / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-20))


def _same_image(a, b):
    assert a.shape == b.shape and np.isfinite(a).all() and b.mean() > 0
    assert _corr(a, b) > 0.93, _corr(a, b)
    assert a.mean() == pytest.approx(b.mean(), rel=0.15)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard")
    sc = dw.write_scenes(tmp)
    # a checkpoint written by a world of one, for the world-2 CLI run
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert cli.main([str(sc["cornell"]), "-o", str(tmp / "w1.hdr"),
                         "--shard", "--device", "cpu", "--seed", "7", "-l",
                         "2", "-p", "2", "--checkpoint",
                         str(tmp / "world1.ckpt"), "--checkpoint-every",
                         "2"]) == 0
    return tmp, sc, load_checkpoint(tmp / "world1.ckpt")


@pytest.fixture(scope="module")
def world2(scenes):
    tmp, sc, _ = scenes
    return dw.spawn_world("wavefront", 2, tmp, scenes=sc, stats=True,
                          cli=True)


@pytest.fixture(scope="module")
def world3(scenes):
    tmp, sc, _ = scenes
    return dw.spawn_world("wavefront", 3, tmp, scenes=sc)


@pytest.fixture(scope="module")
def ps(scenes):
    return prepare(scenes[1]["cornell"], device="cpu")


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    assert len(devs) >= 8, "tests/conftest.py provides 8 virtual devices"
    return jmake_mesh(devs[:8])


def _ranks(request, world):
    return request.getfixturevalue(f"world{world}")


@pytest.mark.parametrize("world", [2, 3])
def test_render_sharded_is_render_bit_for_bit(request, scenes, ps, world):
    ranks = _ranks(request, world)
    pw = prepare(scenes[1]["whitted"], device="cpu")
    with torch.no_grad():
        ref = {
            "sharded_path": render(ps.scene, ps.camera, _gen(3), **PATH),
            "sharded_whitted": render(pw.scene, pw.camera, _gen(4),
                                      samples=2, max_depth=2),
            "sharded_jitter": render(ps.scene, ps.camera, _gen(3),
                                     shared_jitter=False, **PATH),
        }
    assert ref["sharded_path"].mean() > 0 and ref["sharded_whitted"].max() > 0
    for r in ranks:
        for k, v in ref.items():
            np.testing.assert_array_equal(r[k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("mode", ["path", "whitted"])
def test_tile_draws_are_the_wavefronts_slice(scenes, ps, mode):
    """A tile draws the whole wavefront's uniforms and keeps its slice
    (path mode draws every ray's, live or retired, each bounce; Whitted
    draws none), so a traced tile is the whole trace's rows, under
    prune_zero and without it."""
    sc = ps if mode == "path" else prepare(scenes[1]["whitted"],
                                           device="cpu")
    full = _path_draws(sc.scene, _gen(1), 2, 77, CPU)
    part = _path_draws(sc.scene, _gen(1), 2, 30, CPU, tile=(40, 77))
    for f, p in zip(full, part):
        assert torch.equal(f[..., 40:70], p)
    o, d = primary_rays(sc.camera, 0.001, 0.002)
    for prune in (True, False):
        kw = dict(max_depth=3, light_samples=2, mode=mode, prune_zero=prune)
        whole = trace_wavefront(sc.scene, o, d, _gen(2), **kw)
        tile = trace_wavefront(sc.scene, o[20:57], d[20:57], _gen(2),
                               tile=(20, 77), **kw)
        assert torch.equal(whole[20:57], tile)
    with pytest.raises(ValueError, match="sort_bounces"):
        trace_wavefront(sc.scene, o[:5], d[:5], _gen(2), max_depth=1,
                        tile=(0, 77), sort_bounces=True)


def test_render_sharded_matches_jax_statistically(scenes, world2, mesh8):
    js, jrtc = jload_scene(scenes[1]["stats"])
    theirs = np.asarray(jrender_sharded(
        js, jcamera_from_rtc(jrtc), jax.random.key(1), mesh=mesh8,
        samples=16, max_depth=4, light_samples=2, mode="path"))
    for r in world2:
        _same_image(r["stats_sharded"], theirs)


@pytest.mark.parametrize("world", [2, 3])
def test_shardmap_deterministic_per_world(request, world2, world3, world):
    ranks = _ranks(request, world)
    for r in ranks:
        for route in ("shardmap", "regen"):
            np.testing.assert_array_equal(r[f"{route}_a"], r[f"{route}_b"])
            np.testing.assert_array_equal(r[f"{route}_a"],
                                          ranks[0][f"{route}_a"])
            assert np.isfinite(r[f"{route}_a"]).all()
    # the stream folds the world: another world size, another image
    for route in ("shardmap", "regen"):
        assert not np.array_equal(world2[0][f"{route}_a"],
                                  world3[0][f"{route}_a"])


@pytest.mark.parametrize("world", [2, 3])
def test_shardmap_ranks_trace_different_streams(request, world):
    draws = [r["rank_draw"] for r in _ranks(request, world)]
    for i in range(len(draws)):
        for j in range(i):
            assert not np.array_equal(draws[i], draws[j])
    # the fold is a pure function of (shared draw, rank)
    m = Mesh(None, 1, world, CPU)
    np.testing.assert_array_equal(
        torch.rand(4, generator=rank_generator(_gen(5), m)).numpy(),
        draws[1])


def test_world_of_one_is_the_unsharded_route(ps):
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.world) == (None, 0, 1)
    with torch.no_grad():
        one = render(ps.scene, ps.camera, _gen(5), intersect=ps.intersect,
                     **PATH)
        assert torch.equal(render_shardmap(ps.scene, ps.camera, _gen(5),
                                           mesh=mesh,
                                           intersect=ps.intersect, **PATH),
                           one)
        assert torch.equal(render_sharded(ps.scene, ps.camera, _gen(5),
                                          mesh=mesh, **PATH), one)
    assert torch.equal(
        render_regen_shardmap(ps.scene, ps.camera, _gen(6), mesh=mesh,
                              **PATH),
        render_regen(ps.scene, ps.camera, _gen(6), **PATH))


def test_shardmap_matches_single_device_and_jax(scenes, world2, mesh8):
    st = prepare(scenes[1]["stats"], device="cpu")
    cfg = dict(samples=16, max_depth=4, light_samples=2)
    with torch.no_grad():
        single = render(st.scene, st.camera, _gen(1), mode="path",
                        **cfg).numpy()
    single_regen = render_regen(st.scene, st.camera, _gen(1), **cfg).numpy()
    js, jrtc = jload_scene(scenes[1]["stats"])
    jcam = jcamera_from_rtc(jrtc)
    theirs = np.asarray(jrender_shardmap(js, jcam, jax.random.key(1),
                                         mesh=mesh8, mode="path", **cfg))
    theirs_regen = np.asarray(jregen_shardmap(js, jcam, jax.random.key(1),
                                              mesh=mesh8, **cfg))
    for r in world2:
        _same_image(r["stats_shardmap"], single)
        _same_image(r["stats_shardmap"], theirs)
        _same_image(r["stats_regen"], single_regen)
        _same_image(r["stats_regen"], theirs_regen)


def test_train_step_grads_match_unsharded(ps, world2):
    """make_train_step at world 2 against the unsharded step, lr 1 (the
    step moves a parameter by minus its gradient)."""
    with torch.no_grad():
        target = render(ps.scene, ps.camera, _gen(9), samples=1,
                        max_depth=2, light_samples=1)
    params = {"mat_diffuse": ps.scene.mat_diffuse * 0.5,
              "tri_v0": ps.scene.tri_v0}
    step = make_train_step(ps.scene, ps.camera, samples=1, max_depth=2,
                           light_samples=1, lr=1.0)
    new, loss = step(params, _gen(2), target)
    g_kd = (params["mat_diffuse"] - new["mat_diffuse"]).numpy()
    g_v0 = (params["tri_v0"] - new["tri_v0"]).numpy()
    assert np.abs(g_kd).max() > 0 and np.abs(g_v0).max() > 0
    for r in world2:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(r["grad_kd"], g_kd, rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(r["grad_v0"], g_v0, rtol=1e-4,
                                   atol=1e-6 * np.abs(g_v0).max())


@pytest.mark.parametrize("world", [2, 3])
def test_train_step_issues_one_all_reduce(request, world):
    n_floats = 8 * 3 + 128 * 3 + 1      # mat_diffuse, tri_v0, the loss
    for r in _ranks(request, world):
        assert int(r["step_ops"]) == 1
        assert int(r["step_reduce_bytes"]) == int(r["step_bytes"]) \
            == 4 * n_floats


def test_train_step_shardmap_lowers_loss(world2):
    for r in world2:
        losses = r["shardmap_losses"]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0], losses


def test_cli_shard_rank0_writes_render_shardmap_image(scenes, world2):
    tmp = scenes[0]
    for name in ("cli", "regen", "ck2", "ck4", "one", "other", "fresh"):
        assert (tmp / f"{name}-0.hdr").exists(), name
        assert not (tmp / f"{name}-1.hdr").exists(), name
    assert (tmp / "cli-0.hdr").read_bytes() == (tmp / "direct.hdr").read_bytes()
    regen = load_hdr(tmp / "regen-0.hdr")
    assert np.isfinite(regen).all() and regen.mean() > 0


def test_cli_shard_checkpoint_resumes(scenes, world2):
    tmp = scenes[0]
    resumed, oneshot = (load_checkpoint(tmp / "resumed.ckpt"),
                        load_checkpoint(tmp / "oneshot.ckpt"))
    assert resumed[1] == oneshot[1] == 4
    assert "world=2" in resumed[4] and resumed[4] == oneshot[4]
    assert oneshot[0].mean() > 0
    np.testing.assert_allclose(resumed[0], oneshot[0], rtol=1e-5, atol=1e-6)


def test_cli_shard_checkpoint_of_another_world_starts_over(scenes, world2):
    """world1.ckpt (2 of 2 samples, world=1) is not resumed by the world-2
    run: it renders its 2 samples anew and overwrites the file."""
    tmp, _, before = scenes
    after = load_checkpoint(tmp / "world1.ckpt")
    assert "world=1" in before[4] and "world=2" in after[4]
    assert before[1] == after[1] == 2
    assert not np.array_equal(before[0], after[0])
    # the same world-2 render into a file of its own
    fresh = load_checkpoint(tmp / "fresh.ckpt")
    assert fresh[4] == after[4] and fresh[0].mean() > 0
    np.testing.assert_array_equal(after[0], fresh[0])


@pytest.mark.parametrize("route", [[], ["--regen"],
                                   ["--checkpoint", "CK",
                                    "--checkpoint-every", "1"]])
def test_cli_shard_world_of_one_equals_the_route(tmp_path, scenes, route):
    """Without torchrun --shard is a world of one: the same file as the
    unsharded route over the same backend (JAX: "no-op on one device")."""
    rtc = str(scenes[1]["cornell"])
    outs = []
    for shard in ([], ["--shard"]):
        extra = [a.replace("CK", str(tmp_path / f"{len(shard)}.ckpt"))
                 for a in route]
        out = tmp_path / f"o{len(shard)}.hdr"
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            assert cli.main([rtc, "-o", str(out), "--device", "cpu", "-p",
                             "2", "-l", "2", "--backend", "brute", "--seed",
                             "4", *shard, *extra]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_cli_shard_refuses_normal_maps(scenes):
    with pytest.raises(SystemExit, match="normal maps"):
        cli.main([str(scenes[1]["cornell"]), "--device", "cpu", "--shard",
                  "--normal-maps"])


def test_make_mesh_never_falls_back(monkeypatch):
    """A device that does not exist raises; nothing moves to the CPU or to
    another card."""
    with pytest.raises(RuntimeError):
        make_mesh(device="cuda:7")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(RuntimeError, match="does not exist"):
        make_mesh()
    with pytest.raises(ValueError, match="unsupported"):
        make_mesh(device="meta")


def test_distributed_helpers_in_a_world_of_one(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert pdist.init_distributed() == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1}
    assert not torch.distributed.is_initialized()
    assert pdist.host_tile(10) == (0, 10)
    assert pdist.scaling_report(8.0, 1.25, 8) == {
        "chips": 8, "speedup": 6.4, "efficiency": 0.8}
    mesh = make_mesh(device="cpu")
    x = torch.arange(6.0).reshape(3, 2)
    rep = pdist.measure_collective_bytes(
        lambda: (pdist.all_gather_rows(x, 3, mesh),
                 pdist.all_reduce_sum(x, mesh)))
    assert rep == {"ops": 0, "bytes_per_call": 0,
                   "by_kind": {k: 0 for k in pdist.KINDS}}
    assert [Mesh(None, r, 3, CPU).tile(77) for r in range(3)] == [
        (0, 26), (26, 52), (52, 77)]
    assert Mesh(None, 3, 4, CPU).tile(5) == (5, 5)
