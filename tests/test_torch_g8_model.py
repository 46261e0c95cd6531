"""Kernel 11's walk (csrc/bvh_g8.cu), modelled in plain PyTorch on the CPU.

`torch_port_util.g8_walk_model` runs the kernel's schedule: a block's live
rays in order, groups of 32 lanes (or the list spread over the block's
warps) behind one node pointer, each lane's `resume` range, and the
cooperative leaf (32 threads x 4 rows for one lane at a time, merged by a
butterfly on the least (t, row)). It must
equal `bvh_walk_plain` at leaf 128 bit for bit: nearest (t, row), and any
hit's (t, row) too (a lane settles at its first leaf with a hit, the
plain walk's), on random rays, on groups that mix live and dead lanes,
and on a tree whose leaves all meet every ray, with duplicate rows at
equal t in one leaf (on other threads' rows) and across leaves.
tests/test_torch_bvh_g8.py holds the model against the JAX G8 in
interpret mode.
"""

import pytest
import torch

from orion_tpu_torch.accel.bvh import build_scene_bvh
from orion_tpu_torch.ops import bvh_intersect as bx
from orion_tpu_torch.scene import load_scene, subdivide_scene

from cornell_scenes import random_rays, write_cornell
from torch_port_util import g8_tie_layout, g8_walk_model


def _layout(tmp_path, levels: int):
    sc, _ = load_scene(write_cornell(tmp_path, xres=8, yres=8),
                       device="cpu")
    if levels:
        sc = subdivide_scene(sc, levels=levels)
    bvh, _ = build_scene_bvh(sc, leaf_size=128)
    assert bvh.leaf_width == 128
    return bx._bvh_device_layout(bvh, "cpu")


def _equal_plain(nodes, tri, o, d, alive, any_hit, block_rays=128,
                 spread=False):
    t_m, r_m = g8_walk_model(nodes, tri, o, d, alive, any_hit=any_hit,
                             block_rays=block_rays, spread=spread)
    t_p, r_p = bx.bvh_walk_plain(nodes, tri, o, d, alive, leaf_width=128,
                                 any_hit=any_hit)
    assert torch.equal(r_m, r_p)
    assert torch.equal(t_m, t_p)
    return r_p


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("levels", [2, 3])
def test_model_equals_plain_on_random_rays(tmp_path, levels, any_hit):
    nodes, tri = _layout(tmp_path, levels)
    o, d, alive = random_rays(700, 11 + levels, "cpu")
    r = _equal_plain(nodes, tri, o, d, alive, any_hit)
    assert 0 < int((r >= 0).sum()) < int(alive.sum())
    assert bool((r[~alive] == -1).all())


@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("block_rays", [128, 256])
def test_model_groups_mixing_live_and_dead(tmp_path, block_rays, spread):
    """Every third ray dead, and a last block of 77 rays: groups end part
    full, a block's live rays fill groups out of several warps', or are
    spread over its 4 warps in groups of fewer lanes."""
    nodes, tri = _layout(tmp_path, 2)
    o, d, _ = random_rays(3 * block_rays + 77, 5, "cpu")
    alive = torch.arange(o.shape[0]) % 3 != 0
    _equal_plain(nodes, tri, o, d, alive, False, block_rays, spread)


@pytest.mark.parametrize("any_hit", [False, True])
def test_model_ties_in_and_across_leaves(tmp_path, any_hit):
    """Every leaf meets every ray; duplicated rows tie at equal t inside a
    leaf (on another thread's rows) and across leaves: the smallest row of
    the earliest leaf wins, as in the plain walk, and the rays that meet a
    tie are many."""
    nodes, tri = g8_tie_layout(*_layout(tmp_path, 2))
    o, d, alive = random_rays(300, 9, "cpu")
    r = _equal_plain(nodes, tri, o, d, alive, any_hit)
    if any_hit:
        return
    # the winners that have an equal copy elsewhere in the table
    dup = (tri[:, None, :13] == tri[None, :, :13]).all(dim=2).sum(dim=1) > 1
    won = r[r >= 0].long()
    assert int(dup[won].sum()) >= 20


def test_model_all_dead_and_empty(tmp_path):
    nodes, tri = _layout(tmp_path, 1)
    o, d, _ = random_rays(40, 2, "cpu")
    dead = torch.zeros(40, dtype=torch.bool)
    t, r = g8_walk_model(nodes, tri, o, d, dead)
    assert bool(torch.isinf(t).all()) and bool((r == -1).all())
    t, r = g8_walk_model(nodes, tri, o[:0], d[:0], dead[:0])
    assert t.numel() == 0 and r.numel() == 0
