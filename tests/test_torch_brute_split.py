"""Kernel 2's split-row reduction, modelled in plain PyTorch on the CPU.

The brute sweep's kernel (csrc/brute_intersect.cu) sweeps each live ray
with a group of K lanes: lane j tests the rows j, j + K, j + 2K, ... in
order, keeping the strictly smaller t, and the group merges its K bests
by the lexicographic minimum of (t, row) over a butterfly of
__shfl_xor_sync. The model below does the same with whole tensors: K
interleaved row subsets, each swept by `brute_sweep_plain` (the first
least t of the subset), merged pairwise in the butterfly's order. It must
equal `brute_sweep_plain` over the whole table bit for bit, ties
included: duplicate rows at equal t that fall to different lanes, where
the smaller row must win. `brute_sweep_plain` is held against the JAX
oracle and the Pallas kernel in interpret mode by
tests/test_torch_intersect.py; the last test here holds the model against
the Pallas kernel as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.ops.pallas_intersect import intersect_brute_pallas
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch.ops import brute_intersect as bi
from orion_tpu_torch.scene import load_scene, subdivide_scene

from cornell_scenes import random_rays, write_cornell

def split_sweep(tab, orig, dirs, alive, k: int):
    """(t, id) of the kernel's K-lane split: lane j's best over rows j::k
    (global row ids), then the butterfly merge of the lanes' bests by the
    least (t, row); what lane 0 holds at the end."""
    lanes = []
    for j in range(k):
        t, row = bi.brute_sweep_plain(tab[j::k], orig, dirs, alive)
        row = torch.where(row >= 0, row * k + j, row)
        lanes.append((t, row))
    o = 1
    while o < k:
        merged = []
        for j in range(k):
            (t, r), (to, ro) = lanes[j], lanes[j ^ o]
            # a miss is (+inf, -1); -1 as the largest row, as the kernel's
            # unsigned compare takes it
            ru = r.to(torch.int64) % (1 << 32)
            rou = ro.to(torch.int64) % (1 << 32)
            take = (to < t) | ((to == t) & (rou < ru))
            merged.append((torch.where(take, to, t), torch.where(take, ro, r)))
        lanes = merged
        o <<= 1
    return lanes[0]


def _table(tmp_path, levels: int, ties: bool):
    sc, _ = load_scene(write_cornell(tmp_path, xres=8, yres=8), device="cpu")
    if levels:
        sc = subdivide_scene(sc, levels=levels)
    tab = bi.pack_tri_rows16(sc)
    if ties:
        # every row again after one missing row: row r ties with row r +
        # T + 1, which an interleave of K = 2, 4 or 8 lanes gives to
        # another lane (T + 1 is odd for these tables)
        tab = torch.cat([tab, torch.zeros_like(tab[:1]), tab])
    return tab


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("levels", [0, 2])
def test_split_rows_equal_plain(tmp_path, levels, k, ties):
    tab = _table(tmp_path, levels, ties)
    o, d, alive = random_rays(3000, 5 + levels, "cpu")
    t_p, id_p = bi.brute_sweep_plain(tab, o, d, alive)
    t_s, id_s = split_sweep(tab, o, d, alive, k)
    assert torch.equal(id_s.to(torch.int32), id_p)
    assert torch.equal(t_s, t_p)
    assert bool((id_p[~alive] == -1).all())
    assert bool(torch.isinf(t_p[id_p < 0]).all())
    if ties:
        T = (tab.shape[0] - 1) // 2
        # the ties are real: the winners lie in the first copy, and their
        # twins T + 1 rows on hit at the same t
        hit = id_p >= 0
        assert int(hit.sum()) > 100
        assert bool((id_p[hit] < T).all())
        twin, _ = bi.brute_sweep_plain(tab[T + 1:], o, d, alive)
        assert torch.equal(twin[hit], t_p[hit])


def test_split_ties_fall_to_other_lanes(tmp_path):
    """With K = 4, a row r and its twin r + 37 sit on lanes r % 4 and
    (r + 1) % 4: the twin lane holds the same t at the larger row, and the
    merge keeps the smaller."""
    tab = _table(tmp_path, 0, True)
    assert tab.shape[0] == 73
    o, d, alive = random_rays(2000, 13, "cpu")
    t_p, id_p = bi.brute_sweep_plain(tab, o, d, alive)
    hit = id_p >= 0
    lane = (id_p[hit] % 4).long()
    twin_lane = ((id_p[hit] + 37) % 4).long()
    assert bool((lane != twin_lane).all())
    t_s, id_s = split_sweep(tab, o, d, alive, 4)
    assert torch.equal(id_s.to(torch.int32), id_p)
    assert torch.equal(t_s, t_p)


def test_split_all_dead_and_no_rows(tmp_path):
    tab = _table(tmp_path, 0, False)
    o, d, _ = random_rays(257, 2, "cpu")
    dead = torch.zeros(257, dtype=torch.bool)
    for k in (1, 4):
        t, row = split_sweep(tab, o, d, dead, k)
        assert bool((row == -1).all()) and bool(torch.isinf(t).all())
    t, row = split_sweep(tab[:0], o, d, torch.ones(257, dtype=torch.bool), 4)
    assert bool((row == -1).all()) and bool(torch.isinf(t).all())


def test_split_matches_pallas_interpret(tmp_path):
    """The model at K = 4 against the JAX package's Pallas brute kernel in
    interpret mode on the same scene and rays (ids on >= 99.9% of the live
    rays, t within rel 1e-5: the JAX rows are its own float32 transform,
    tests/test_torch_intersect.py's tolerance)."""
    path = write_cornell(tmp_path, xres=8, yres=8)
    js, _ = jload_scene(str(path))
    sc, _ = load_scene(path, device="cpu")
    o, d, alive = random_rays(2000, 17, "cpu")
    t_s, id_s = split_sweep(bi.pack_tri_rows16(sc), o, d, alive, 4)
    theirs = intersect_brute_pallas(js, jnp.asarray(o.numpy()),
                                    jnp.asarray(d.numpy()), interpret=True,
                                    alive=jnp.asarray(alive.numpy()))
    id_j, t_j = np.asarray(theirs.tri_id), np.asarray(theirs.t)
    id_s, t_s = id_s.numpy(), t_s.numpy()
    same = id_s == id_j
    assert same.mean() >= 0.999
    both = same & (id_j >= 0)
    np.testing.assert_allclose(t_s[both], t_j[both], rtol=1e-5, atol=1e-6)
    assert (id_s[~alive.numpy()] == -1).all()
