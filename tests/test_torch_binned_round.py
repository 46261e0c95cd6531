"""Kernel 10's bin-major schedule and its split lanes, modelled on the CPU
(orion_tpu_torch/csrc/binned.cu runs only on the card).

`_kernel_model` computes a round as the kernel does: the blocks of
`binned.round_schedule` (one bin and one tile of its lanes each), S
threads a lane (more where the bin or the round has few lanes; a smaller
`fill` than the kernel's models a build whose rounds count as large
sooner, which these small rounds need to take every split) that test
interleaved rows kUnroll at a time, a step of
padding rows skipped, and the S threads' winners merged pairwise over
xor offsets S/2, ..., 1 by the least (t, row). Each case is held bit for
bit against `binned_round_plain` (itself held against the JAX round in
tests/test_torch_binned.py). The t of every (lane, row) is the plain
Woop test's, as the kernel's woop_t_rn computes it bit for bit; what the
model checks is the schedule and the merge.
"""

import re

import numpy as np
import pytest
import torch

from cornell_scenes import write_cornell
from orion_tpu_torch.ops import binned as bn
from orion_tpu_torch.ops import cuda_build
from orion_tpu_torch.ops.woop import BIG, woop_t
from orion_tpu_torch.scene import load_scene

UNROLL = 4          # csrc/binned.cu kUnroll


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    """The levels-3 Cornell box (2,178 triangles) cut into bins of at most
    256 rows, on the CPU: (bins, tab, row0, nb)."""
    rtc = write_cornell(tmp_path_factory.mktemp("box"), xres=8, yres=8,
                        depth=2, levels=3)
    sc, _ = load_scene(rtc, device="cpu")
    bins, tab, _ = bn.binned_device_data(sc, max_rows=256)
    return (bins, tab, torch.as_tensor(bins.row0),
            torch.as_tensor(bins.n_bundles))


def _lex_less(a, b):
    return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])


def _kernel_model(st, key, row0, nb, tab, fill=bn.ROUND_FILL):
    K = row0.shape[0] - 1
    out = st[6:8].clone()
    for b, first, lanes, split in bn.round_schedule(key, K, fill):
        r0, rows = int(row0[b]), int(nb[b]) * bn.ROUND_THREADS
        w = tab[r0:r0 + rows, :13]
        real = (w[:, 12] > 0.0).tolist()
        wc = tuple(w[None, :, c] for c in range(13))
        for i in range(first, first + lanes):
            tt = woop_t(tuple(st[c, i, None] for c in range(3)),
                        tuple(st[3 + c, i, None] for c in range(3)),
                        wc)[0].tolist()
            start = (float(st[6, i]), int(st[7, i]))
            best = []
            for sub in range(split):
                tb, rb = start
                for k in range(sub, rows, split * UNROLL):
                    step = [k + u * split for u in range(UNROLL)]
                    if not any(real[kk] for kk in step):
                        continue        # padding only: the kernel skips it
                    for kk in step:
                        t, r = tt[kk], r0 + kk
                        if t < BIG and _lex_less((t, r), (tb, rb)):
                            tb, rb = t, r
                best.append((tb, rb))
            off = split // 2
            while off:
                best = [min(best[x], best[x ^ off],
                            key=lambda p: (p[0], p[1]))
                        for x in range(split)]
                off //= 2
            out[0, i], out[1, i] = best[0][0], float(best[0][1])
    return out


def _round(tab, keys, seed, hit_share=0.3):
    """st [8, n] of random rays at the box for sorted `keys`, some lanes
    already holding a hit."""
    rng = np.random.default_rng(seed)
    n = len(keys)
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    o[:, 1] += 1.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    st = np.zeros((8, n), np.float32)
    st[0:3], st[3:6] = o.T, d.T
    held = rng.uniform(size=n) < hit_share
    st[6] = np.where(held, rng.uniform(0.2, 3.0, n), BIG).astype(np.float32)
    st[7] = np.where(held, rng.integers(0, tab.shape[0], n), bn.NO_ROW)
    return torch.as_tensor(st), torch.as_tensor(np.sort(keys).astype(np.int32))


@pytest.mark.parametrize("case", ["many-bins", "one-lane", "every-bin",
                                  "keyed-K"])
def test_kernel_model_equals_plain(box, case):
    """Lanes spread thin over many bins (late rounds), a round of one
    lane, every bin present with lane counts that take every split from 1
    to 32 (some bins past one block; modelled at a small fill), and lanes
    keyed K mixed in: the model's (t, row) is the plain round's bit for
    bit."""
    bins, tab, row0, nb = box
    K = bins.k
    rng = np.random.default_rng(3)
    if case == "many-bins":
        keys = rng.integers(0, K, 3 * K)
    elif case == "one-lane":
        keys = np.array([K // 2])
    elif case == "every-bin":
        counts = [1, 3, 5, 9, 17, 33, 65, 130, 2, 300]
        keys = np.repeat(np.arange(K), [counts[b % len(counts)]
                                        for b in range(K)])
    else:
        keys = np.where(rng.uniform(size=200) < 0.7,
                        rng.integers(0, K, 200), K)
    st, key = _round(tab, keys, seed=len(case))
    fill = 256 if case == "every-bin" else bn.ROUND_FILL
    splits = {s for *_, s in bn.round_schedule(key, K, fill)}
    if case == "every-bin":
        assert splits == {1, 2, 4, 8, 16, 32}
    else:                       # small rounds: a warp a lane
        assert splits == {bn.ROUND_MAX_SPLIT}
    model = _kernel_model(st, key, row0, nb, tab, fill)
    plain = bn.binned_round_plain(st, key, row0, nb, tab)
    assert torch.equal(model, plain)
    assert int((plain[1] < bn.NO_ROW).sum()) > 0


def test_kernel_model_ties_in_t_across_rows(box):
    """Two rows of one bin hold the same triangle (so the same t for every
    ray) and lie in different threads' shares of the rows; rays aimed at
    it tie, and the smaller row wins in the model and in the plain round,
    whatever the split. A lane whose running t equals the tie keeps its
    row where that is smaller."""
    bins, tab, row0, nb = box
    tab = tab.clone()
    b = int(np.argmax(bins.n_bundles[:-1]))
    r0 = int(bins.row0[b])
    real = torch.nonzero(tab[r0:r0 + 128, 12] > 0).flatten()
    ra, rb = r0 + int(real[0]), r0 + int(real[3])     # rows ra < rb
    tab[rb, :13] = tab[ra, :13]
    # points on the triangle of row ra: invert its Woop transform
    m = tab[ra, :9].double().reshape(3, 3)
    c = tab[ra, 9:12].double()
    inv = torch.linalg.inv(m)
    counts = [1, 3, 40, 130]
    keys = np.repeat(b, sum(counts))
    st, key = _round(tab, keys, seed=9, hit_share=0.0)
    rng = np.random.default_rng(10)
    n = key.numel()
    uvw = np.stack([rng.uniform(0.1, 0.4, n), rng.uniform(0.1, 0.4, n),
                    np.zeros(n)], 1)
    p = (inv @ (torch.as_tensor(uvw).T - c[:, None])).T     # on the plane
    nrm = m[2] / m[2].norm()
    o = p + 0.5 * nrm
    st[0:3] = o.T.float()
    st[3:6] = (-nrm).expand(n, 3).T.float()
    plain = bn.binned_round_plain(st, key, row0, nb, tab)
    assert int((plain[1] == ra).sum()) > n // 2
    assert not bool((plain[1] == rb).any())
    st[6, 0], st[7, 0] = plain[0, 0], float(rb + 1)   # the same t, a larger
    st[6, 1], st[7, 1] = plain[0, 1], float(ra - 1)   # row; a smaller one
    plain = bn.binned_round_plain(st, key, row0, nb, tab)
    assert int(plain[1, 0]) == ra and int(plain[1, 1]) == ra - 1
    for fill in (bn.ROUND_FILL, 256):       # splits 32; 32, 32, 2, 1
        model = _kernel_model(st, key, row0, nb, tab, fill)
        assert torch.equal(model, plain)


@pytest.mark.parametrize("col12", [0.0, -0.0, -1.0, -3e38, float("nan")])
def test_padding_row_never_wins(box, col12):
    """A row whose column 12 (|n|^2) is <= 0 (or NaN) fails the Woop
    test's first condition, |dw| * w12 > eps, for every ray (zero,
    infinite and NaN components included), whatever its other columns: so
    the kernel may skip it. With every padding row of the table filled
    with random transforms, binned_round_plain gives what it gives on the
    table as packed, and no winner is a padding row."""
    bins, tab, row0, nb = box
    rng = np.random.default_rng(11)
    pad = torch.nonzero(~(tab[:, 12] > 0.0)).flatten()
    assert pad.numel() > 0
    junk = tab.clone()
    junk[pad, :12] = torch.as_tensor(
        rng.normal(0.0, 3.0, (pad.numel(), 12)).astype(np.float32))
    junk[pad, 12] = col12
    o = torch.as_tensor(rng.normal(size=(4096, 3)).astype(np.float32))
    d = torch.as_tensor(rng.normal(size=(4096, 3)).astype(np.float32))
    d[:64, 0] = 0.0
    d[64:96, 1] = float("inf")
    o[96:128, 2] = float("nan")
    w = tuple(junk[None, pad, c] for c in range(13))
    t = woop_t(tuple(o[:, c, None] for c in range(3)),
               tuple(d[:, c, None] for c in range(3)), w)
    assert bool((t == BIG).all())
    keys = np.sort(np.random.default_rng(12).integers(0, bins.k, 600))
    st, key = _round(tab, keys, seed=13, hit_share=0.0)
    packed = bn.binned_round_plain(st, key, row0, nb, tab)
    filled = bn.binned_round_plain(st, key, row0, nb, junk)
    assert torch.equal(packed, filled)
    won = filled[1][filled[1] < bn.NO_ROW].long()
    assert won.numel() > 0 and bool((junk[won, 12] > 0.0).all())


@pytest.mark.parametrize("lanes", [1, 4, 5, 64, 65, 127, 128, 129, 300])
@pytest.mark.parametrize("fill", [bn.ROUND_FILL, 512])
def test_round_schedule_tiles_each_bin(lanes, fill):
    """Every lane of a real bin lies in exactly one block, a block holds
    the lanes of one bin (at most 128 / split of them), the split is the
    most threads (up to a warp) whose lanes fill one block, or the round's
    least (the most, up to a warp, that keep the round's lane threads
    within `fill`) where that is more, lanes keyed K lie in none, and the
    blocks fit the kernel's grid (n times the round's least split over 128
    rounded up, plus K)."""
    K = 7
    keys = np.sort(np.concatenate([np.full(lanes, 2), np.full(3, 5),
                                   np.full(lanes // 2 + 1, 6),
                                   np.full(4, K)]))
    n = len(keys)
    least = bn.round_split(bn.ROUND_THREADS + 1, n, fill)
    assert least == bn.ROUND_MAX_SPLIT or 2 * least * n > fill
    assert least * n <= fill or least == 1
    blocks = bn.round_schedule(torch.as_tensor(keys, dtype=torch.int32), K,
                               fill)
    seen = np.zeros(n, np.int64)
    for b, first, m, split in blocks:
        assert 1 <= m <= bn.ROUND_THREADS // split
        assert (keys[first:first + m] == b).all()
        seen[first:first + m] += 1
        c = int((keys == b).sum())
        assert split == bn.round_split(c, n, fill) >= least
        if split > least:
            assert c * split <= bn.ROUND_THREADS
            assert (split == bn.ROUND_MAX_SPLIT
                    or c * split * 2 > bn.ROUND_THREADS)
    assert (seen == (keys < K)).all()
    assert len(blocks) <= -(-n * least // bn.ROUND_THREADS) + K


def test_schedule_constants_match_the_kernel():
    """binned.round_schedule models csrc/binned.cu: its block size, its
    largest split and its rows a step are the kernel's."""
    src = (cuda_build.CSRC / "binned.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kLanes") == bn.ROUND_THREADS
    assert const("kMaxSplit") == bn.ROUND_MAX_SPLIT
    assert const("kFillThreads") == bn.ROUND_FILL
    assert const("kUnroll") == UNROLL
    assert const("kStageRows") % (bn.ROUND_THREADS) == 0
