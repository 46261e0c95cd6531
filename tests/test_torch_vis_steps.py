"""Kernel 6b's persistent pair walk (csrc/bounce.cu `bounce_vis_kernel`),
modelled in plain PyTorch on the CPU.

The kernel walks each lane's pair of shadow rays (the two light samples of
the single emitter, `shadow_em2`'s walk) in slices of at most S node steps
between refill votes: a warp's 32 slots take lanes from a counter in
order, a lane whose draws need no walk is answered at once, and a warp
refills when fewer than R of its slots walk. A pair's answer must not
depend on where its walk stops and resumes: `stepped_pair_vis` runs that
schedule, one node step at a time with the operations of the plain pair
walk (`bvh_traverse.shadow_em_plain`), and must equal `bounce_vis_plain`
bit for bit for several S and R, on one tree and on eight per-octant
copies, on every bounce of a render.
"""

import pytest
import torch

from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.ops import bounce as bo
from orion_tpu_torch.ops.bvh_traverse import _slab
from orion_tpu_torch.ops.fused_path import _C_MESH, NEE_T_CAP
from orion_tpu_torch.ops.woop import BIG, woop_t
from orion_tpu_torch.scene import load_scene, subdivide_scene

from cornell_scenes import write_cornell

SLOTS = 32


def stepped_pair_vis(data, st, hd, seed: int, depth: int, *, steps: int,
                     refill: int):
    """[2, n] 0/1 visibility of the two light samples, walked as the vis
    kernel schedules one warp: slots take lanes in order, at most `steps`
    node steps a walking slot between two votes, a refill below `refill`
    walking slots."""
    n = hd.shape[1]
    dr = bo.bounce_vis_plain(data, st, hd, seed, depth, draws=True)
    so = dr[0:3].t().contiguous()
    sds = (dr[3:6].t().contiguous(), dr[7:10].t().contiguous())
    needs = (dr[6] > 0, dr[10] > 0)
    tree = data.tree
    lo, hi, W = tree.lo, tree.hi, tree.leaf_width
    skip, start = tree.skip.long(), tree.start.long()
    w13 = data.tab[:, :13]
    is_em = data.tab[:, _C_MESH] == float(data.em[0, 0])
    inv = [1.0 / d for d in sds]
    first = data.first(tuple(sds[0][:, i] for i in range(3)))
    ptr = (torch.zeros(n, dtype=torch.int64) if first is None
           else first.long().clone())
    end = ptr + tree.per_copy
    tb = [torch.where(nd, torch.full((n,), NEE_T_CAP),
                      torch.full((n,), -BIG)) for nd in needs]
    em = [torch.zeros(n, dtype=torch.bool) for _ in range(2)]
    cols = torch.arange(W)

    def step(act):
        p = ptr[act]
        hit = torch.zeros(act.numel(), dtype=torch.bool)
        for j in range(2):
            hb, tmin = _slab(so[act], inv[j][act], lo[p], hi[p])
            hit = hit | (hb & (tmin < tb[j][act]))
        s = start[p]
        leaf = hit & (s >= 0)
        li = act[leaf]
        rows = (s[leaf] & -2)[:, None] + cols[None, :]
        no_em = (s[leaf] & 1) > 0
        g = w13[rows]
        w = tuple(g[:, :, i] for i in range(13))
        o = tuple(so[li, i, None] for i in range(3))
        for j in range(2):
            t = woop_t(o, tuple(sds[j][li, i, None] for i in range(3)), w)
            arg = torch.argmin(t, dim=1)                 # first min
            t_leaf = torch.gather(t, 1, arg[:, None])[:, 0]
            upd = (t_leaf < tb[j][li]) & (t_leaf < BIG)
            sel = li[upd]
            tb[j][sel] = t_leaf[upd]
            win = torch.gather(rows, 1, arg[:, None])[:, 0]
            em[j][sel] = (is_em[win] & ~no_em)[upd]
        ptr[act] = torch.where(hit & (s < 0), p + 1, skip[p])

    taken, walking = 0, []
    while taken < n or walking:
        if len(walking) < refill:
            # each idle slot takes lanes until one needs a walk
            idle = SLOTS - len(walking)
            while idle and taken < n:
                if bool(needs[0][taken] | needs[1][taken]):
                    walking.append(taken)
                    idle -= 1
                taken += 1
        idx = torch.tensor(walking, dtype=torch.int64)
        for _ in range(steps):
            act = idx[ptr[idx] < end[idx]]
            if act.numel() == 0:
                break
            step(act)
        walking = [lane for lane, go in zip(walking,
                                            (ptr[idx] < end[idx]).tolist())
                   if go]
    return torch.stack([(needs[j] & em[j]).float() for j in range(2)])


@pytest.fixture(scope="module")
def bounces(tmp_path_factory):
    """{octant_trees: [(depth, st, hd)]}: every bounce of a 16x12, 2 spp,
    depth 3 render of the levels-2 box on the CPU."""
    rtc = write_cornell(tmp_path_factory.mktemp("vis_steps"), xres=16,
                        yres=12, depth=3)
    sc, r = load_scene(rtc, device="cpu")
    sc = subdivide_scene(sc, levels=2)
    cam = camera_from_rtc(r, device="cpu")
    out = {}
    for octants in (False, True):
        fn = bo.make_bounce_path_renderer(sc, cam, samples=2, max_depth=3,
                                          light_samples=2,
                                          octant_trees=octants)
        rec = []
        fn(21, record=lambda depth, n, st, hd, kd, vis: rec.append(
            (depth, st[:, :n].clone(), hd.clone())))
        out[octants] = (fn.ctx["data"], rec)
    return out


@pytest.mark.parametrize("octants", [False, True])
@pytest.mark.parametrize("steps,refill", [(1, 16), (3, 8), (32, 16),
                                          (32, 32)])
def test_stepped_pair_walk_equals_plain(bounces, octants, steps, refill):
    data, rec = bounces[octants]
    assert len(rec) >= 2
    walked = 0
    for depth, st, hd in rec:
        want = bo.bounce_vis_plain(data, st, hd, 21, depth)
        got = stepped_pair_vis(data, st, hd, 21, depth, steps=steps,
                               refill=refill)
        assert torch.equal(got, want[:2]), depth
        assert not bool(want[2:].any())
        walked += int(want[:2].sum())
    assert walked > 0
