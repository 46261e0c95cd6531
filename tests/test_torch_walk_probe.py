"""Kernel 5's probe (tools/bvh_probe.py --walk) and A/B tool
(tools/walk_ab.py) on the CPU: their host arithmetic, the source rewrites
of the probe's sweep, the argument handling of the A/B tool, and the
plain walk's per-ray node counts that the probe's model reads."""

import numpy as np
import pytest
import torch

from orion_tpu_torch.accel.bvh import build_scene_bvh
from orion_tpu_torch.ops import bvh_intersect as bx
from orion_tpu_torch.ops import cuda_build
from orion_tpu_torch.scene import load_scene, subdivide_scene
from tools import bvh_probe, walk_ab

from cornell_scenes import random_rays, write_cornell


def test_thread_a_ray_model():
    """A warp is 32 consecutive rays and runs as many iterations as its
    longest: 8 visits over 32 x 5 lane slots in the first warp, a full
    warp of ones in the second; the tail counts the iterations in which
    fewer than 16 lanes walk; an all-dead warp counts for nothing."""
    steps = [3, 5] + [0] * 30 + [1] * 32 + [0] * 32
    m = bvh_probe.thread_a_ray(steps)
    assert m["simt"] == pytest.approx(40 / (32 * 6))
    assert m["tail"] == pytest.approx(5 / 6)
    assert m["steps"] == pytest.approx(40 / 34)
    assert m["warp_iters"] == pytest.approx(3.0)
    # a ragged last warp is padded with dead rays
    assert bvh_probe.thread_a_ray([4] * 40)["simt"] == pytest.approx(
        160 / (32 * 8))


def test_walk_report_ratios():
    c = dict(rays=10, steps=400, tests=30, loads=250, iters=100,
             iter_lanes=2400, tail_iters=20, warps=4, takes=7)
    r = bvh_probe.walk_report(c)
    assert (r["steps"], r["tests"], r["loads"]) == (40.0, 3.0, 25.0)
    assert r["simt"] == pytest.approx(0.75)
    assert r["tail"] == pytest.approx(0.2)
    assert r["warp_iters"] == pytest.approx(25.0) and r["takes"] == 7
    assert bvh_probe.walk_report(dict.fromkeys(c, 0))["simt"] == 0.0


@pytest.mark.parametrize("regs,blocks", [(32, 16), (40, 12), (48, 10),
                                         (64, 8), (80, 6), (128, 4)])
def test_resident_blocks_by_registers(regs, blocks):
    assert bvh_probe.resident_blocks(regs) == blocks


def test_walk_sweep_rewrites_one_constant(tmp_path):
    """--walk --sweep builds copies of csrc/bvh_intersect.cu with one
    constexpr set to each of its values: the source defines each exactly
    once, and each copy differs from it in that line alone."""
    src = cuda_build.CSRC / "bvh_intersect.cu"
    text = src.read_text().splitlines()
    paths = bvh_probe.walk_sources(src, tmp_path)
    assert len(paths) == sum(len(v) for v in bvh_probe.WALK_SWEEP.values())
    for tag, path in paths.items():
        name, value = tag.split("=")
        diff = [(a, b) for a, b in zip(text, path.read_text().splitlines())
                if a != b]
        if not diff:        # the source's own value
            assert f"constexpr int {name} = {value};" in text
            continue
        assert len(diff) == 1
        assert diff[0][1] == f"constexpr int {name} = {value};"


def test_walk_sets_build_constants_together(tmp_path):
    """--set NAME=V[,NAME=V]: one copy with every named constant set."""
    sets = [bvh_probe.parse_set("kCountedWindow=2, kCountedBlocks=10"),
            bvh_probe.parse_set("kBvhSteps=4")]
    assert sets[0] == {"kCountedWindow": 2, "kCountedBlocks": 10}
    paths = bvh_probe.walk_sources(cuda_build.CSRC / "bvh_intersect.cu",
                                   tmp_path / "sets", sets)
    assert list(paths) == ["kCountedWindow=2,kCountedBlocks=10",
                           "kBvhSteps=4"]
    text = paths["kCountedWindow=2,kCountedBlocks=10"].read_text()
    assert "constexpr int kCountedWindow = 2;" in text
    assert "constexpr int kCountedBlocks = 10;" in text
    with pytest.raises(ValueError):
        bvh_probe.walk_sources(cuda_build.CSRC / "bvh_intersect.cu",
                               tmp_path, [{"kNoSuchConstant": 1}])


def test_walk_ab_arguments(capsys):
    """Anything but OLD NEW or --one ROOT LABEL [DIR] prints the doc and
    returns 2."""
    assert walk_ab.main([]) == 2
    assert walk_ab.main(["a", "b", "c"]) == 2
    assert "walk_ab.py _archive/old ." in capsys.readouterr().err


def test_walk_ab_pixels_off_and_digest():
    a = np.ones((4, 4, 3), np.float32)
    b = a.copy()
    assert walk_ab.pixels_off(a, b) == 0.0
    b[0, 0, 1] += 2e-3            # past 1e-4 + 1e-3 * 1: one pixel of 16
    b[1, 1, 0] += 5e-4            # inside
    assert walk_ab.pixels_off(b, a) == pytest.approx(1 / 16)
    x = torch.arange(6, dtype=torch.float32)
    assert walk_ab.digest(x) == walk_ab.digest(x.clone())
    assert walk_ab.digest(x) != walk_ab.digest(x + 1)
    assert len(walk_ab.digest(x, x)) == 16


def test_plain_walk_counts_each_rays_nodes(tmp_path):
    """stats["ray_box_tests"] gets each ray's node visits: they sum to
    the walk's box tests, dead rays visit nothing, and the walk's result
    is the one without it."""
    sc, _ = load_scene(write_cornell(tmp_path, xres=8, yres=8), device="cpu")
    sc = subdivide_scene(sc, levels=2)
    bvh, _ = build_scene_bvh(sc, leaf_size=2)
    nodes, tri = bx._bvh_device_layout(bvh, "cpu")
    o, d, alive = random_rays(512, 4, "cpu")
    stats = {"ray_box_tests": torch.zeros(512, dtype=torch.int64)}
    t, row = bx.bvh_walk_plain(nodes, tri, o, d, alive, leaf_width=2,
                               stats=stats)
    per_ray = stats["ray_box_tests"]
    assert int(per_ray.sum()) == stats["box_tests"] > 0
    assert bool((per_ray[~alive] == 0).all())
    assert bool((per_ray[alive] > 0).all())
    t2, row2 = bx.bvh_walk_plain(nodes, tri, o, d, alive, leaf_width=2)
    assert torch.equal(t, t2) and torch.equal(row, row2)
