"""Ranks of the multi-rank CPU tests: `spawn_world(task, world, tmp)`
starts `world` processes (spawn), joins them into one gloo group through
a file in `tmp`, runs the named task on every rank and returns each
rank's results (a dict of arrays, saved by the rank as .npz in `tmp`).

Starting a rank costs seconds (a fresh interpreter imports torch), so a
task bundles every check of one test file that needs that world. Every
spawn has its own deadline: a rank that hangs in a collective fails the
test instead of eating the suite's time. Imports nothing of JAX."""

from __future__ import annotations

import dataclasses
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cornell_scenes import write_cornell, write_cornell_whitted

# the scenes every task renders: W x H = 77 pixels, uneven tiles at 2
# ranks (39 + 38) and at 3 (26 + 26 + 25)
W, H = 11, 7
# the statistical comparisons' scene (as tests/test_torch_render.py's)
STATS = dict(xres=48, yres=28)


def write_scenes(tmp: Path) -> dict:
    """The tasks' scene files under tmp: {name: rtc path}."""
    return {
        "cornell": write_cornell(tmp / "cornell", xres=W, yres=H,
                                 depth=3),
        "whitted": write_cornell_whitted(tmp / "whitted", xres=W,
                                         yres=H, depth=2),
        "levels2": write_cornell(tmp / "levels2", xres=W, yres=H,
                                 depth=3, levels=2),
        "stats": write_cornell(tmp / "stats", depth=4, **STATS),
    }


def spawn_world(task: str, world: int, tmp: Path, timeout: float = 300.0,
                **kw) -> list:
    """Run TASKS[task](rank, world, tmp, **kw) on `world` gloo ranks;
    their results in rank order. Raises if a rank fails or the deadline
    passes (the ranks are killed)."""
    init = tmp / f"{task}-{world}.init"
    ctx = mp.start_processes(_run, args=(world, str(init), task, str(tmp),
                                         kw),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{task} at world {world}: ranks still "
                                   f"running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [dict(np.load(tmp / f"{task}-{world}-{r}.npz"))
            for r in range(world)]


def _run(rank: int, world: int, init: str, task: str, tmp: str,
         kw: dict) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        out = TASKS[task](rank, world, Path(tmp), **kw)
        np.savez(Path(tmp) / f"{task}-{world}-{rank}.npz",
                 **{k: np.asarray(v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def gen(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def wavefront_task(rank: int, world: int, tmp: Path, scenes: dict,
                   stats: bool = False, cli: bool = False) -> dict:
    """render_sharded (path, Whitted, per-pixel jitter), render_shardmap
    and render_regen_shardmap (each twice), the rank's stream, the two
    train steps with their collectives; with stats the 48x28 renders of
    the statistical comparisons; with cli the --shard CLI routes."""
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.parallel.distributed import measure_collective_bytes
    from orion_tpu_torch.parallel.sharding import (make_mesh, make_train_step,
                                                   render_sharded)
    from orion_tpu_torch.parallel.shardmap_render import (
        make_train_step_shardmap, rank_generator, render_shardmap)
    from orion_tpu_torch.regen import render_regen_shardmap
    from orion_tpu_torch.render import render

    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world) == (rank, world)
    ps = prepare(scenes["cornell"], device="cpu")
    pw = prepare(scenes["whitted"], device="cpu")
    path = dict(samples=2, max_depth=3, light_samples=2)
    out = {
        "sharded_path": render_sharded(ps.scene, ps.camera, gen(3), mesh=mesh,
                                       **path),
        "sharded_whitted": render_sharded(pw.scene, pw.camera, gen(4),
                                          mesh=mesh, samples=2, max_depth=2),
        "sharded_jitter": render_sharded(ps.scene, ps.camera, gen(3),
                                         mesh=mesh, shared_jitter=False,
                                         **path),
        "rank_draw": torch.rand(4, generator=rank_generator(gen(5), mesh)),
    }
    for run in "ab":
        out[f"shardmap_{run}"] = render_shardmap(
            ps.scene, ps.camera, gen(5), mesh=mesh, intersect=ps.intersect,
            **path)
        out[f"regen_{run}"] = render_regen_shardmap(
            ps.scene, ps.camera, gen(6), mesh=mesh, intersect=ps.intersect,
            **path)

    # make_train_step: lr 1, so the step moves each parameter by -grad
    with torch.no_grad():
        target = render(ps.scene, ps.camera, gen(9), samples=1, max_depth=2,
                        light_samples=1)
    params = {"mat_diffuse": ps.scene.mat_diffuse * 0.5,
              "tri_v0": ps.scene.tri_v0}
    step = make_train_step(ps.scene, ps.camera, samples=1, max_depth=2,
                           light_samples=1, lr=1.0, mesh=mesh)
    new, loss = step(params, gen(2), target)
    coll = measure_collective_bytes(step, params, gen(2), target)
    out.update(grad_kd=params["mat_diffuse"] - new["mat_diffuse"],
               grad_v0=params["tri_v0"] - new["tri_v0"], loss=loss,
               step_ops=coll["ops"], step_bytes=coll["bytes_per_call"],
               step_reduce_bytes=coll["by_kind"]["all-reduce"])

    # make_train_step_shardmap on a perturbed albedo, the same key each
    # step (as the JAX test)
    wrong = ps.scene.mat_diffuse * 0.5
    sm = make_train_step_shardmap(
        dataclasses.replace(ps.scene, mat_diffuse=wrong), ps.camera, mesh,
        samples=1, max_depth=2, light_samples=1, mode="path", lr=0.5,
        intersect=ps.intersect)
    p, losses = {"mat_diffuse": wrong}, []
    for _ in range(4):
        p, loss = sm(p, gen(0), target)
        losses.append(float(loss))
    out["shardmap_losses"] = np.array(losses)

    if stats:
        st = prepare(scenes["stats"], device="cpu")
        cfg = dict(samples=16, max_depth=4, light_samples=2)
        out["stats_sharded"] = render_sharded(st.scene, st.camera, gen(1),
                                              mesh=mesh, mode="path", **cfg)
        out["stats_shardmap"] = render_shardmap(
            st.scene, st.camera, gen(1), mesh=mesh, mode="path",
            intersect=st.intersect, **cfg)
        out["stats_regen"] = render_regen_shardmap(
            st.scene, st.camera, gen(1), mesh=mesh, intersect=st.intersect,
            **cfg)
    if cli:
        out.update(_cli_routes(rank, tmp, scenes, mesh, ps))
    return {k: _np(v) if torch.is_tensor(v) else v for k, v in out.items()}


def _cli_routes(rank: int, tmp: Path, scenes: dict, mesh, ps) -> dict:
    """--shard alone (each rank names its own output; rank 0 alone
    writes), the same render through render_shardmap, --shard --regen,
    and --shard --checkpoint: two samples then four (resumed) against
    one chunk of four, and over a file another world size wrote."""
    from orion_tpu_torch import cli
    from orion_tpu_torch.io.image import save_image
    from orion_tpu_torch.parallel.shardmap_render import render_shardmap

    rtc = str(scenes["cornell"])
    base = ["--shard", "--device", "cpu", "--seed", "7", "-l", "2"]

    def run(out: str, *extra) -> None:
        assert cli.main([rtc, "-o", str(tmp / f"{out}-{rank}.hdr"), *base,
                         *extra]) == 0

    run("cli", "-p", "2")
    with torch.no_grad():
        img = render_shardmap(ps.scene, ps.camera, gen(7), mesh=mesh,
                              samples=2, max_depth=3, light_samples=2,
                              intersect=ps.intersect)
    if rank == 0:
        save_image(tmp / "direct.hdr", img.numpy())
    run("regen", "-p", "2", "--regen")
    ck = str(tmp / "resumed.ckpt")
    run("ck2", "-p", "2", "--checkpoint", ck, "--checkpoint-every", "1")
    run("ck4", "-p", "4", "--checkpoint", ck, "--checkpoint-every", "1")
    run("one", "-p", "4", "--checkpoint", str(tmp / "oneshot.ckpt"),
        "--checkpoint-every", "4")
    run("other", "-p", "2", "--checkpoint", str(tmp / "world1.ckpt"),
        "--checkpoint-every", "2")
    run("fresh", "-p", "2", "--checkpoint", str(tmp / "fresh.ckpt"),
        "--checkpoint-every", "2")
    return {}


def megakernel_task(rank: int, world: int, tmp: Path, scenes: dict,
                    jax_seed: int, train: bool = False) -> dict:
    """The five megakernel routes on this rank's pixel tile through their
    plain versions: kernel 1 (also at `jax_seed`, the JAX comparison's
    seed), kernel 8 and 7a, the bounce pipeline; with train the fused
    (3a, 3b) and bounce train steps with their collectives."""
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.parallel import fused_shard as fs
    from orion_tpu_torch.parallel.distributed import measure_collective_bytes
    from orion_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(device="cpu")
    ps = prepare(scenes["cornell"], device="cpu")
    pw = prepare(scenes["whitted"], device="cpu")
    lv2 = prepare(scenes["levels2"], device="cpu")
    cfg = dict(samples=2, max_depth=3, light_samples=2)
    fused = fs.make_fused_render_sharded(ps.scene, ps.camera, mesh=mesh,
                                         **cfg)
    out = {
        "fused": fused(5),
        "fused_jax": fused(jax_seed),
        "fused_lv2": fs.make_fused_render_sharded(lv2.scene, lv2.camera,
                                                  mesh=mesh, **cfg)(5),
        "bvh_path": fs.make_bvh_render_sharded(lv2.scene, lv2.camera,
                                               mesh=mesh, mode="path",
                                               **cfg)(5),
        "bvh_whitted": fs.make_bvh_render_sharded(
            pw.scene, pw.camera, mesh=mesh, mode="whitted", samples=2,
            max_depth=2)(5),
        "bounce": fs.make_bounce_render_sharded(lv2.scene, lv2.camera,
                                                mesh=mesh, **cfg)(5),
    }
    if train:
        target = torch.zeros((H, W, 3))
        fused = fs.make_fused_train_step_sharded(ps.scene, ps.camera, target,
                                                 mesh=mesh, **cfg)
        params = {"mat_diffuse": ps.scene.mat_diffuse * 0.8,
                  "mat_emissive": ps.scene.mat_emissive}
        loss, g = fused(params, 11)
        coll = measure_collective_bytes(fused, params, 11)
        out.update(fused_loss=loss, fused_kd=g["mat_diffuse"],
                   fused_ke=g["mat_emissive"], fused_ops=coll["ops"],
                   fused_bytes=coll["by_kind"]["all-reduce"])
        bounce = fs.make_bounce_train_step_sharded(
            lv2.scene, lv2.camera, target, mesh=mesh, **cfg)
        loss, g = bounce(11)
        coll = measure_collective_bytes(bounce, 11)
        out.update(bounce_loss=loss, bounce_kd=g["mat_diffuse"],
                   bounce_ke=g["mat_emissive"], bounce_ops=coll["ops"],
                   bounce_bytes=coll["by_kind"]["all-reduce"])
    return {k: _np(v) if torch.is_tensor(v) else v for k, v in out.items()}


def tp_task(rank: int, world: int, tmp: Path, scenes: dict, shapes: list,
            rays: dict, jitter: list) -> dict:
    """Primitive sharding at each (n_ray, n_tp) of `shapes` (n_ray * n_tp
    == world): the TP intersect on `rays` over the Cornell box and its
    levels-2 subdivision (and its collectives), render_tp in path and
    Whitted mode beside render_shardmap over the brute sweep on the same
    ray mesh, the Whitted render_tp at the given primary-ray `jitter`, and
    a Whitted make_train_step_shardmap step over the TP intersect."""
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.ops.brute_intersect import intersect_brute_kernel
    from orion_tpu_torch.parallel import sharding
    from orion_tpu_torch.parallel.distributed import record_collectives
    from orion_tpu_torch.parallel.primitive_sharding import (
        make_mesh_2d, make_tp_intersect, render_tp)
    from orion_tpu_torch.parallel.shardmap_render import (
        make_train_step_shardmap, render_shardmap)
    from orion_tpu_torch.scene import subdivide_scene

    ps = prepare(scenes["cornell"], device="cpu")
    pw = prepare(scenes["whitted"], device="cpu")
    lv2 = subdivide_scene(ps.scene, levels=2)
    o, d = torch.from_numpy(rays["orig"]), torch.from_numpy(rays["dirs"])
    alive = torch.from_numpy(rays["alive"])
    out = {}
    for n_ray, n_tp in shapes:
        tag = f"{n_ray}x{n_tp}"
        ray, tp = make_mesh_2d(n_ray, n_tp, device="cpu")
        out[f"{tag}_place"] = np.array([ray.rank, ray.world, tp.rank,
                                        tp.world])
        fn = make_tp_intersect(tp)
        for name, sc in (("cornell", ps.scene), ("levels2", lv2)):
            with record_collectives() as log:
                h = fn(sc, o, d, alive=alive)
            out[f"{tag}_{name}_t"], out[f"{tag}_{name}_id"] = h.t, h.tri_id
            out[f"{tag}_{name}_gathers"] = np.array(
                [len(log), sum(b for k, b in log if k == "all-gather")])
        path = dict(samples=2, max_depth=3, light_samples=2, mode="path")
        out[f"{tag}_path"] = render_tp(ps.scene, ps.camera, gen(5),
                                       mesh=(ray, tp), **path)
        out[f"{tag}_path_ref"] = render_shardmap(
            ps.scene, ps.camera, gen(5), mesh=ray,
            intersect=intersect_brute_kernel, **path)
        whit = dict(samples=2, max_depth=2, light_samples=1,
                    mode="whitted")
        out[f"{tag}_whitted"] = render_tp(pw.scene, pw.camera, gen(6),
                                          mesh=(ray, tp), **whit)
        out[f"{tag}_whitted_ref"] = render_shardmap(
            pw.scene, pw.camera, gen(6), mesh=ray,
            intersect=intersect_brute_kernel, **whit)
        # the JAX comparison's primary rays: its sample's jitter
        draw = sharding._rand
        sharding._rand = (lambda g, shape, dev: torch.tensor(
            jitter, dtype=torch.float32) if tuple(shape) == (2,)
            else draw(g, shape, dev))
        try:
            out[f"{tag}_whitted_jax"] = render_tp(
                pw.scene, pw.camera, gen(7), mesh=(ray, tp), samples=1,
                max_depth=2, light_samples=1, mode="whitted")
        finally:
            sharding._rand = draw
        # gradients: lr 1, so the step moves the albedos by -grad
        target = torch.zeros((H, W, 3))
        kd = pw.scene.mat_diffuse
        step = make_train_step_shardmap(
            pw.scene, pw.camera, ray, samples=1, max_depth=1,
            light_samples=1, mode="whitted", lr=1.0,
            intersect=make_tp_intersect(tp))
        new, loss = step({"mat_diffuse": kd}, gen(8), target)
        out[f"{tag}_grad_kd"] = kd - new["mat_diffuse"]
        out[f"{tag}_loss"] = loss
    return {k: _np(v) if torch.is_tensor(v) else v for k, v in out.items()}


def multihost_task(rank: int, world: int, tmp: Path, scenes: dict,
                   counts: list) -> dict:
    """render_multihost of each sample count of `counts` over the world,
    in path mode (with its collectives) and Whitted mode, and of 16
    samples on the statistical comparisons' scene."""
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.parallel.distributed import (render_multihost,
                                                      record_collectives)

    ps = prepare(scenes["cornell"], device="cpu")
    pw = prepare(scenes["whitted"], device="cpu")
    out = {}
    for n in counts:
        with record_collectives() as log:
            out[f"path_{n}"] = render_multihost(
                ps.scene, ps.camera, gen(3), samples=n, max_depth=3,
                light_samples=2, intersect=ps.intersect)
        out[f"gathers_{n}"] = np.array([len(log),
                                        sum(b for _, b in log)])
        out[f"whitted_{n}"] = render_multihost(
            pw.scene, pw.camera, gen(4), samples=n, max_depth=2,
            intersect=pw.intersect)
    st = prepare(scenes["stats"], device="cpu")
    out["stats"] = render_multihost(st.scene, st.camera, gen(1), samples=16,
                                    max_depth=4, light_samples=2,
                                    mode="path", intersect=st.intersect)
    return {k: _np(v) if torch.is_tensor(v) else v for k, v in out.items()}


TASKS = {"wavefront": wavefront_task, "megakernels": megakernel_task,
         "tp": tp_task, "multihost": multihost_task}
