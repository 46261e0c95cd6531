"""CUDA kernels of the port against their plain PyTorch versions, on the GPU.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: the brute sweep is written without FMA contraction and must
equal its plain version bit for bit; the fused kernel contracts FMAs and
rounds sqrt/sin/cos differently from the plain version's op-by-op float32
order, so at most 1% of pixels may differ by more than 1e-4 + 1e-3*|ref|
and the image means agree to rel 1e-3. The PRB training forward (image
and per-sample radiance) and the Whitted kernel are held to the same; the
replay's gradients (float32 terms summed in double by atomics in an order
that varies from run to run) to 1e-3 x the largest entry, chip_smoke.py's
GRAD_TOL. The BVH walk kernel, like the brute sweep, has no multiply-add
to contract and must equal its plain version bit for bit; the BVH path
kernel is held to the fused kernel's pixel tolerance. The three bounce
kernels (walk, vis, shade) are held by chip_smoke.py's `walk_agree`,
`vis_agree` and `shade_agree` on every bounce of one render: winners and
visibility planes equal on >= 99.9% of lanes (a tie may break the other
way), <= 1% of shaded lanes off by more than 1e-4 + 1e-3*|ref|. The BVH
Whitted kernel (7a), the deferred kernel's records (7b, per record row)
and the BVH PRB pair (9a/9b) are held to the fused kernel's and the
replay's tolerances.
"""

import hashlib

import numpy as np
import pytest
import torch

from chip_smoke import (agreeing_lanes, binned_round_agree,
                        bounce_kernels_agree, brute_agree, draws_agree,
                        mask_agree, random_rays, two_emitter, write_cornell,
                        write_cornell_whitted)
from orion_tpu_torch.accel.bvh import build_bvh, build_scene_bvh
from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.ops import binned as bn
from orion_tpu_torch.ops import bounce as bo
from orion_tpu_torch.ops import bounce_prb as bpr
from orion_tpu_torch.ops import brute_intersect as bi
from orion_tpu_torch.ops import bvh_g8 as g8
from orion_tpu_torch.ops import bvh_intersect as bx
from orion_tpu_torch.ops import bvh_path as bp
from orion_tpu_torch.ops import bvh_prb as bvp
from orion_tpu_torch.ops import bvh_whitted as bw
from orion_tpu_torch.ops import fused_path as fp
from orion_tpu_torch.ops import prb
from orion_tpu_torch.ops import prb_wavefront as pw
from orion_tpu_torch.ops import whitted as wh
from orion_tpu_torch.scene import (load_scene, scene_from_numpy,
                                   scene_to_numpy, subdivide_scene)

from torch_port_util import cuda_device  # noqa: F401  (fixture)
from torch_port_util import regroup_meshes


def _scene(tmp_path, device, name):
    sc, rtc = load_scene(write_cornell(tmp_path, xres=32, yres=24),
                         device=device)
    if name.startswith("levels-"):
        sc = subdivide_scene(sc, levels=int(name[-1]))
    elif name == "two-emitter":
        sc = two_emitter(sc)
    return sc, camera_from_rtc(rtc, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "levels-4"])
def test_brute_kernel_equals_plain(tmp_path, cuda_device, name):
    sc, _ = _scene(tmp_path, cuda_device, name)
    o, d, alive = random_rays(1 << 16, 9, cuda_device)
    tab = bi.pack_tri_rows16(sc)
    before = bi.KERNEL.launches
    t_k, id_k = bi.brute_sweep(tab, o, d, alive)
    torch.cuda.synchronize()
    assert bi.KERNEL.launches == before + 1
    t_p, id_p = bi.brute_sweep_plain(tab, o, d, alive)
    assert torch.equal(id_k, id_p)
    assert torch.equal(t_k, t_p)
    assert (id_k[~alive] == -1).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "levels-2", "two-emitter"])
def test_fused_kernel_matches_plain(tmp_path, cuda_device, name):
    sc, cam = _scene(tmp_path, cuda_device, name)
    args = fp.fused_args(sc, cam)
    cfg = (32, 24, 4, 4, 2)
    before = fp.KERNEL.launches
    k = fp.fused_path(*args, 99, *cfg)
    torch.cuda.synchronize()
    assert fp.KERNEL.launches == before + 1
    # a pixel's sum does not depend on the thread that renders it
    assert torch.equal(fp.fused_path(*args, 99, *cfg), k)
    p = fp.fused_path_plain(*args, 99, *cfg)
    k, p = k.cpu().numpy(), p.cpu().numpy()
    assert np.isfinite(k).all() and p.mean() > 0
    off = np.abs(k - p) > 1e-4 + 1e-3 * np.abs(p)
    assert off.any(axis=-1).mean() <= 0.01
    assert k.mean() == pytest.approx(p.mean(), rel=1e-3)


def _images_agree(k, p):
    k, p = k.cpu().numpy(), p.cpu().numpy()
    assert np.isfinite(k).all() and p.mean() > 0
    off = np.abs(k - p) > 1e-4 + 1e-3 * np.abs(p)
    assert off.any(axis=-1).mean() <= 0.01
    assert k.mean() == pytest.approx(p.mean(), rel=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "levels-2"])
def test_prb_kernels_match_plain(tmp_path, cuda_device, name):
    sc, cam = _scene(tmp_path, cuda_device, name)
    args = fp.fused_args(sc, cam)
    cfg = (32, 24, 4, 4, 2)
    before = (prb.FWD_KERNEL.launches, prb.REPLAY_KERNEL.launches)
    img_k, ls_k = prb.fused_fwd_ls(*args, 99, *cfg)
    img_p, ls_p = fp.fused_fwd_ls_plain(*args, 99, *cfg)
    _images_agree(img_k, img_p)
    _images_agree(ls_k, ls_p)
    w = (img_p * 0.5 + 0.01).contiguous() / (32 * 24 * 3 * 4)
    g_k = prb.prb_replay(*args, 99, w, ls_k, *cfg)
    torch.cuda.synchronize()
    assert (prb.FWD_KERNEL.launches, prb.REPLAY_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    g_p = prb.prb_replay_plain(*args, 99, w, ls_p, *cfg)
    assert g_k.shape == (6, prb.M_LANES) and g_k.dtype == torch.float32
    scale = g_p.abs().max()
    assert scale > 0
    assert (g_k - g_p).abs().max() <= 1e-3 * scale


@pytest.mark.gpu
def test_prb_train_step_on_card_matches_cpu(tmp_path, cuda_device):
    sc, cam = _scene(tmp_path, cuda_device, "cornell")
    sc_cpu, cam_cpu = _scene(tmp_path / "cpu", torch.device("cpu"), "cornell")
    target = np.full((24, 32, 3), 0.1, np.float32)
    cfg = dict(samples=2, max_depth=3, light_samples=2)
    loss_k, g_k = prb.make_fused_train_step(sc, cam, target, **cfg)(7)
    loss_p, g_p = prb.make_fused_train_step(sc_cpu, cam_cpu, target, **cfg)(7)
    assert float(loss_k) == pytest.approx(float(loss_p), rel=1e-3)
    for k in g_p:
        assert (g_k[k].cpu() - g_p[k]).abs().max() <= 1e-3 * g_p[k].abs().max()


@pytest.mark.gpu
def test_whitted_kernel_matches_plain(tmp_path, cuda_device):
    sc, rtc = load_scene(write_cornell_whitted(tmp_path, xres=32, yres=24),
                         device=cuda_device)
    args = wh.whitted_args(sc, camera_from_rtc(rtc, device=cuda_device))
    cfg = (32, 24, 4, 4, True)
    before = wh.KERNEL.launches
    k = wh.fused_whitted(*args, 99, *cfg)
    torch.cuda.synchronize()
    assert wh.KERNEL.launches == before + 1
    _images_agree(k, wh.fused_whitted_plain(*args, 99, *cfg))


@pytest.mark.gpu
def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    o, d, alive = random_rays(64, 1, cuda_device)
    tab = torch.zeros((8, 16), device=cuda_device)
    with pytest.raises(ValueError):
        bi.brute_sweep(tab, o.double(), d, alive)
    with pytest.raises(ValueError):
        bi.brute_sweep(tab[:, :13], o, d, alive)
    tab32 = torch.zeros((8, 32), device=cuda_device)
    box = torch.zeros((1, 3), device=cuda_device)
    em = torch.zeros((2, fp.EM_STRIDE), device=cuda_device)
    cam = torch.zeros((12,), device=cuda_device)
    with pytest.raises(ValueError, match="exactly one"):
        prb.fused_fwd_ls(tab32, box, box, em, cam, 0, 4, 4, 1, 1, 1)
    with pytest.raises(ValueError, match="samples"):
        prb.fused_fwd_ls(tab32, box, box, em[:1], cam, 0, 4, 4,
                         prb.MAX_SAMPLES + 1, 1, 1)
    with pytest.raises(ValueError):
        wh.fused_whitted(tab32, box, box, torch.zeros((1, 8), device=cuda_device),
                         cam, 0, 4, 4, 1, 1, True)
    # a material id past the replay's accumulator columns
    tab32[0, fp._C_MESH] = prb.M_LANES
    w = torch.zeros((16, 3), device=cuda_device)
    ls = torch.zeros((16, 3), device=cuda_device)
    with pytest.raises(ValueError, match="accumulator columns"):
        prb.prb_replay(tab32, box, box, em[:1], cam, 0, w, ls, 4, 4, 1, 1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("leaf", [16, 128])
def test_bvh_walk_kernel_equals_plain(tmp_path, cuda_device, leaf, any_hit):
    sc, _ = _scene(tmp_path, cuda_device, "levels-3")
    bvh, _ = build_scene_bvh(sc, leaf_size=leaf)
    nodes, tri = bx._bvh_device_layout(bvh, cuda_device)
    o, d, alive = random_rays(1 << 16, 9, cuda_device)   # ~10% dead lanes
    kernel = bx.ANY_HIT_KERNEL if any_hit else bx.KERNEL
    before = kernel.launches
    t_k, r_k = bx.bvh_walk(nodes, tri, o, d, alive, leaf_width=leaf,
                           any_hit=any_hit)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    t_p, r_p = bx.bvh_walk_plain(nodes, tri, o, d, alive, leaf_width=leaf,
                                 any_hit=any_hit)
    assert torch.equal(r_k, r_p) and torch.equal(t_k, t_p)
    assert (r_k[~alive] == -1).all() and torch.isinf(t_k[~alive]).all()
    assert (r_k >= 0).any()
    if any_hit:
        assert (t_k[r_k >= 0] == 1.0).all()


@pytest.mark.gpu
def test_bvh_walk_kernel_one_leaf_and_flat_box(cuda_device):
    """A one-leaf tree over one axis-aligned quad (a flat AABB): a ray
    through it hits, a ray lying in its plane (0 * inf in the slab test)
    walks on and misses the triangles, as in the plain version."""
    v0 = np.array([[0, 0, 0], [0, 0, 0]], np.float32)
    e1 = np.array([[1, 0, 0], [1, 0, 1]], np.float32)
    e2 = np.array([[1, 0, 1], [0, 0, 1]], np.float32)
    bvh, st = build_bvh(v0, e1, e2, builder="numpy", leaf_size=4)
    assert st.nodes == 1
    nodes, tri = bx._bvh_device_layout(bvh, cuda_device)
    o = torch.tensor([[0.5, 1.0, 0.25], [-1.0, 0.0, 0.5], [0.5, 1.0, 0.25]],
                     device=cuda_device)
    d = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]],
                     device=cuda_device)
    alive = torch.tensor([True, True, False], device=cuda_device)
    for any_hit in (False, True):
        t_k, r_k = bx.bvh_walk(nodes, tri, o, d, alive, leaf_width=4,
                               any_hit=any_hit)
        t_p, r_p = bx.bvh_walk_plain(nodes, tri, o, d, alive, leaf_width=4,
                                     any_hit=any_hit)
        assert r_k.tolist() == [0, -1, -1] == r_p.tolist()
        assert torch.equal(t_k, t_p) and float(t_k[0]) == 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("leaf,octants", [(2, 1), (8, 8), (128, 1)])
def test_bvh_path_kernel_matches_plain(tmp_path, cuda_device, leaf, octants):
    sc, cam = _scene(tmp_path, cuda_device, "levels-3")
    cam = camera_from_rtc(
        load_scene(write_cornell(tmp_path / "c64", xres=64, yres=64),
                   device=cuda_device)[1], device=cuda_device)
    fn = bp.make_bvh_path_renderer(sc, cam, samples=4, max_depth=4,
                                   light_samples=2, leaf_width=leaf,
                                   octants=octants)
    before = bp.KERNEL.launches
    k = fn(99)
    torch.cuda.synchronize()
    assert bp.KERNEL.launches == before + 1
    assert torch.equal(fn(99), k)
    dd = fn.data
    p = bp.bvh_path_plain(dd["nodes"], dd["tab"], dd["em"], dd["cam"], 99,
                          64, 64, 4, 4, 2, leaf_width=leaf, copies=octants)
    _images_agree(k.reshape(-1, 3), p)
    tile = fn(99, pix_base=1000, n_lanes=300)
    torch.cuda.synchronize()
    assert torch.equal(tile, k.reshape(-1, 3)[1000:1300])


@pytest.mark.gpu
def test_bvh_wrappers_reject_bad_inputs(tmp_path, cuda_device):
    sc, cam = _scene(tmp_path, cuda_device, "levels-2")
    bvh, _ = build_scene_bvh(sc, leaf_size=4)
    nodes, tri = bx._bvh_device_layout(bvh, cuda_device)
    o, d, alive = random_rays(64, 1, cuda_device)
    with pytest.raises(ValueError):          # a table on the wrong device
        bx.bvh_walk(nodes, tri.cpu(), o, d, alive, leaf_width=4)
    with pytest.raises(ValueError):          # a tree of the wrong dtype
        bx.bvh_walk(nodes.double(), tri, o, d, alive, leaf_width=4)
    with pytest.raises(ValueError):
        bx.bvh_walk(nodes, tri, o, d, alive, leaf_width=0)
    fn = bp.make_bvh_path_renderer(sc, cam, samples=1, max_depth=1)
    dd = fn.data
    args = (dd["em"], dd["cam"], 0, 32, 24, 1, 1, 1)
    with pytest.raises(ValueError):
        bp.bvh_path(dd["nodes"].cpu(), dd["tab"], *args, leaf_width=2)
    with pytest.raises(ValueError):
        bp.bvh_path(dd["nodes"], dd["tab"].double(), *args, leaf_width=2)
    with pytest.raises(ValueError):
        bp.bvh_path(dd["nodes"], dd["tab"], *args, leaf_width=2,
                    pix_base=32 * 24 - 2, n_lanes=5)


@pytest.mark.gpu
def test_path_kernels_persistent_lanes(tmp_path, cuda_device):
    """More pixels than the card holds threads: every thread of kernels 1
    and 8 renders several pixels, each taken from the lane counter. The
    images match the plain versions, two launches are bit-identical, and
    kernel 8's tiles render the whole image's pixels."""
    W, H, S, D = 480, 480, 1, 2
    sc, rtc = load_scene(write_cornell(tmp_path, xres=W, yres=H),
                         device=cuda_device)
    cam = camera_from_rtc(rtc, device=cuda_device)
    args = fp.fused_args(sc, cam)
    k = fp.fused_path(*args, 5, W, H, S, D, 2)
    torch.cuda.synchronize()
    assert torch.equal(fp.fused_path(*args, 5, W, H, S, D, 2), k)
    _images_agree(k, fp.fused_path_plain(*args, 5, W, H, S, D, 2))
    fn = bp.make_bvh_path_renderer(subdivide_scene(sc, levels=3), cam,
                                   samples=S, max_depth=D, light_samples=2)
    k8 = fn(5).reshape(-1, 3)
    torch.cuda.synchronize()
    assert torch.equal(fn(5).reshape(-1, 3), k8)
    dd = fn.data
    _images_agree(k8, bp.bvh_path_plain(dd["nodes"], dd["tab"], dd["em"],
                                        dd["cam"], 5, W, H, S, D, 2,
                                        leaf_width=dd["leaf_width"]))
    for base, n in ((0, 1000), (W * H // 3, 150_000), (W * H - 77, 77)):
        assert torch.equal(fn(5, pix_base=base, n_lanes=n), k8[base:base + n])


@pytest.mark.gpu
@pytest.mark.parametrize("name,leaf,octants,with_aux",
                         [("cornell", 2, False, False),
                          ("levels-3", 2, False, True),
                          ("levels-3", 128, True, False),
                          ("two-emitter", 8, True, True)])
def test_bounce_kernels_match_plain(tmp_path, cuda_device, name, leaf,
                                    octants, with_aux):
    """Walk, vis and shade kernel (with and without the replay dump, with
    its own shadow walks and given the vis planes) on the recorded state of
    every bounce of one render."""
    sc, cam = _scene(tmp_path, cuda_device, name)
    fn = bo.make_bounce_path_renderer(sc, cam, samples=4, max_depth=4,
                                      light_samples=2, leaf_width=leaf,
                                      octant_trees=octants)
    before = (bo.WALK_KERNEL.launches, bo.SHADE_KERNEL.launches)
    img = fn(99)
    torch.cuda.synchronize()
    bounces = bo.WALK_KERNEL.launches - before[0]
    assert 2 <= bounces <= 5
    assert bo.SHADE_KERNEL.launches - before[1] == bounces
    res = bounce_kernels_agree(name, fn, 99, with_aux=with_aux)
    assert sorted(res) == list(range(bounces))
    assert res[0]["n"] == 32 * 24 * 4 > res[bounces - 1]["n"] > 0
    # the whole pipeline against the plain pipeline on the card
    plain = bo.make_bounce_path_renderer(sc, cam, samples=4, max_depth=4,
                                         light_samples=2, leaf_width=leaf,
                                         octant_trees=octants,
                                         steps=bo.PLAIN_STEPS)
    _images_agree(img.reshape(-1, 3), plain(99).reshape(-1, 3))


@pytest.mark.gpu
def test_bounce_renders_agree_on_card(tmp_path, cuda_device):
    """split_vis, the unsorted wavefront and tiles give the fused sorted
    render; the BVH path kernel's image differs by rounding and ties."""
    sc, cam = _scene(tmp_path, cuda_device, "levels-3")
    cfg = dict(samples=4, max_depth=4, light_samples=2)
    base = bo.make_bounce_path_renderer(sc, cam, **cfg)
    assert base.ctx["data"].leaf_width == 2 and base.ctx["data"].copies == 1
    img = base(5)
    before = bo.VIS_KERNEL.launches
    split = bo.make_bounce_path_renderer(sc, cam, split_vis=True, **cfg)(5)
    assert bo.VIS_KERNEL.launches > before
    assert torch.allclose(split, img, rtol=1e-6, atol=1e-7)
    assert torch.equal(bo.make_bounce_path_renderer(sc, cam, sort=False,
                                                    **cfg)(5), img)
    assert torch.equal(base(5), img)                   # run to run
    pipe, ctx = bo.build_forward_pipeline(sc, cam, pix_count=200, **cfg)
    st, _ = pipe(5, pix_base=301)
    assert torch.equal(bo.state_image(st, 200, 4, 301),
                       img.reshape(-1, 3)[301:501])
    k8 = bp.make_bvh_path_renderer(sc, cam, **cfg)(5)
    _images_agree(img.reshape(-1, 3), k8.reshape(-1, 3))


@pytest.mark.gpu
def test_bounce_train_step_on_card_matches_plain(tmp_path, cuda_device):
    sc, cam = _scene(tmp_path, cuda_device, "levels-3")
    target = np.full((24, 32, 3), 0.1, np.float32)
    cfg = dict(samples=4, max_depth=4, light_samples=2)
    before = bo.SHADE_KERNEL.launches
    loss_k, g_k = bpr.make_bounce_train_step(sc, cam, target, **cfg)(7)
    assert bo.SHADE_KERNEL.launches > before
    loss_p, g_p = bpr.make_bounce_train_step(sc, cam, target,
                                             steps=bo.PLAIN_STEPS, **cfg)(7)
    assert float(loss_k) == pytest.approx(float(loss_p), rel=1e-3)
    for k in g_p:
        assert (g_k[k] - g_p[k]).abs().max() <= 1e-3 * g_p[k].abs().max()


@pytest.mark.gpu
def test_bounce_wrappers_reject_bad_inputs(tmp_path, cuda_device):
    sc, cam = _scene(tmp_path, cuda_device, "cornell")
    fn = bo.make_bounce_path_renderer(sc, cam, samples=1, max_depth=1)
    data, N = fn.ctx["data"], fn.ctx["N"]
    st = torch.zeros((16, N), device=cuda_device)
    hd = torch.zeros((8, N), device=cuda_device)
    with pytest.raises(ValueError):          # a state on the wrong device
        bo.bounce_walk(data, st.cpu(), N)
    with pytest.raises(ValueError):          # of the wrong dtype
        bo.bounce_walk(data, st.double(), N)
    with pytest.raises(ValueError, match="live prefix"):
        bo.bounce_walk(data, st, N + 1)
    with pytest.raises(ValueError):          # hitdata of the wrong height
        bo.bounce_shade(data, st, hd[:5], 0, 0, 1, 2)
    with pytest.raises(ValueError):
        bo.bounce_shade(data, st, hd, 0, 0, 1, 2,
                        kd=torch.zeros((3, N - 1), device=cuda_device))
    with pytest.raises(ValueError, match="2 visibility planes for 3"):
        bo.bounce_shade(data, st, hd, 0, 0, 1, 3, vis=hd[:2])
    with pytest.raises(ValueError):          # not contiguous
        bo.bounce_vis(data, st, hd.t().contiguous().t(), 0, 0)
    assert bo.bounce_walk(data, st, 0).shape == (8, 0)     # nothing to do


def _whitted_scene(tmp_path, device, levels=3, checker=False):
    sc, rtc = load_scene(write_cornell_whitted(tmp_path, xres=32, yres=24,
                                               checker=checker),
                         device=device)
    if levels:
        sc = subdivide_scene(sc, levels=levels)
    return sc, camera_from_rtc(rtc, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("leaf,octants", [(2, 1), (128, 8)])
def test_bvh_whitted_kernel_matches_plain(tmp_path, cuda_device, leaf,
                                          octants):
    sc, cam = _whitted_scene(tmp_path, cuda_device)
    fn = bw.make_bvh_whitted_renderer(sc, cam, samples=4, max_depth=4,
                                      leaf_width=leaf, octants=octants)
    before = bw.KERNEL.launches
    k = fn(99)
    torch.cuda.synchronize()
    assert bw.KERNEL.launches == before + 1
    dd = fn.data
    p = bw.bvh_whitted_plain(dd["nodes"], dd["tab"], dd["lights"], dd["cam"],
                             99, 32, 24, 4, 4, dd["with_emissive"],
                             leaf_width=leaf, copies=octants)
    _images_agree(k.reshape(-1, 3), p)
    tile = fn(99, pix_base=100, n_lanes=300)
    torch.cuda.synchronize()
    assert torch.equal(tile, k.reshape(-1, 3)[100:400])
    # the Whitted kernel over the brute sweep (kernel 4): the same estimator
    _images_agree(k.reshape(-1, 3), wh.fused_whitted(
        *wh.whitted_args(sc, cam), 99, 32, 24, 4, 4, True))


@pytest.mark.gpu
@pytest.mark.parametrize("checker", [False, True])
def test_bvh_whitted_deferred_kernel_matches_plain(tmp_path, cuda_device,
                                                   checker):
    sc, cam = _whitted_scene(tmp_path, cuda_device, levels=2,
                             checker=checker)
    fn = bw.make_bvh_whitted_deferred(sc, cam, samples=3, max_depth=2)
    dd = fn.data
    args = (dd["nodes"], dd["tab"], dd["lights"], dd["cam"], 99, 32, 24, 2,
            1, 2, dd["with_emissive"])
    before = bw.DEFERRED_KERNEL.launches
    rec_k = bw.bvh_whitted_deferred(*args, leaf_width=2)
    torch.cuda.synchronize()
    assert bw.DEFERRED_KERNEL.launches == before + 1
    rec_p = bw.bvh_whitted_deferred_plain(*args, leaf_width=2)
    assert rec_k.shape == rec_p.shape == (2 * 3 * bw.REC_ROWS, 32 * 24)

    def rows(r):        # one row of 12 record floats per (group, lane)
        return r.reshape(6, bw.REC_ROWS, -1).permute(0, 2, 1).reshape(
            -1, bw.REC_ROWS)

    _images_agree(rows(rec_k), rows(rec_p))
    img = fn(99)
    assert bw.DEFERRED_KERNEL.launches == before + 2
    acc = bw.deferred_epilogue(sc, bw.bvh_whitted_deferred_plain(
        *args[:7], 3, 0, *args[9:], leaf_width=2), 3, 2)
    _images_agree(img.reshape(-1, 3), acc / 3.0)
    if not checker:     # the untextured records give the BVH Whitted image
        _images_agree(img.reshape(-1, 3), bw.make_bvh_whitted_renderer(
            sc, cam, samples=3, max_depth=2)(99).reshape(-1, 3))


@pytest.mark.gpu
@pytest.mark.parametrize("leaf,octants", [(2, 1), (8, 8)])
def test_bvh_prb_kernels_match_plain(tmp_path, cuda_device, leaf, octants):
    sc, cam = _scene(tmp_path, cuda_device, "levels-3")
    nodes, _, update = bvp.make_bvh_tab_updater(sc, leaf_width=leaf,
                                                octants=octants)
    tab = update()
    em = torch.as_tensor(fp.pack_emitters(sc), device=cuda_device)
    cam_v = fp.camera_vec(cam).to(cuda_device)
    args = (nodes, tab, em, cam_v, 99)
    cfg = (32, 24, 4, 4, 2)
    kw = dict(leaf_width=leaf, copies=octants)
    before = (bvp.FWD_KERNEL.launches, bvp.REPLAY_KERNEL.launches)
    img_k, ls_k = bvp.bvh_fwd_ls(*args, *cfg, **kw)
    img_p, ls_p = bvp.bvh_fwd_ls_plain(*args, *cfg, **kw)
    _images_agree(img_k, img_p)
    _images_agree(ls_k, ls_p)
    # lanes whose paths the two forwards trace alike (see
    # chip_smoke.agreeing_lanes); the others get a zero cotangent
    keep = agreeing_lanes(ls_k, ls_p)
    assert keep.float().mean() >= 0.99
    w = ((img_p * 0.5 + 0.01) * keep[:, None]).contiguous() / (32 * 24 * 3 * 4)
    g_k = bvp.bvh_prb_replay(*args, w, ls_k, *cfg, **kw)
    torch.cuda.synchronize()
    assert (bvp.FWD_KERNEL.launches, bvp.REPLAY_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    g_p = bvp.bvh_prb_replay_plain(*args, w, ls_p, *cfg, **kw)
    scale = g_p.abs().max()
    assert scale > 0 and (g_k - g_p).abs().max() <= 1e-3 * scale
    # the training step on the card against the same step on the CPU
    sc_cpu, cam_cpu = _scene(tmp_path / "cpu", torch.device("cpu"),
                             "levels-3")
    target = np.full((24, 32, 3), 0.1, np.float32)
    step_cfg = dict(samples=2, max_depth=3, light_samples=2, leaf_width=leaf,
                    octants=octants)
    loss_k, gk = bvp.make_bvh_train_step(sc, cam, target, **step_cfg)(7)
    loss_p, gp = bvp.make_bvh_train_step(sc_cpu, cam_cpu, target,
                                         **step_cfg)(7)
    assert float(loss_k) == pytest.approx(float(loss_p), rel=1e-3)
    for k in gp:
        assert (gk[k].cpu() - gp[k]).abs().max() <= 1e-3 * gp[k].abs().max()


@pytest.mark.gpu
def test_bvh_prb_forward_is_deterministic(tmp_path, cuda_device):
    """More pixels than the card holds threads: every thread of 9a runs
    several pixels, taken from the lane counter in an order that varies
    from launch to launch, and two launches of one seed give the same
    image and per-sample radiance bit for bit."""
    W, H, S, D = 480, 480, 2, 3
    sc, rtc = load_scene(write_cornell(tmp_path, xres=W, yres=H, levels=2),
                         device=cuda_device)
    nodes, _, update = bvp.make_bvh_tab_updater(sc)
    args = (nodes, update(),
            torch.as_tensor(fp.pack_emitters(sc), device=cuda_device),
            fp.camera_vec(camera_from_rtc(rtc, device=cuda_device)).to(
                cuda_device), 17)
    img, ls = bvp.bvh_fwd_ls(*args, W, H, S, D, 2, leaf_width=2)
    img2, ls2 = bvp.bvh_fwd_ls(*args, W, H, S, D, 2, leaf_width=2)
    torch.cuda.synchronize()
    assert img.mean() > 0
    assert torch.equal(img, img2) and torch.equal(ls, ls2)


@pytest.mark.gpu
def test_bvh_prb_replay_sums_over_split_meshes(tmp_path, cuda_device):
    """The replay's gradient on a box whose surfaces are one mesh of one
    material equals its gradient on the same box cut into eight meshes of
    that material, summed over the eight (d kd; and both rows of the
    emitter's column), within 1e-4 of the largest entry: the warp's lanes
    on one material are summed before one shared atomic, however many
    materials a vertex's lanes hit. (The non-emitters' d ke rows scale
    with each mesh's area, so they are not summed.)"""
    W = H = 128
    cfg = (W, H, 4, 4, 2)
    sc, rtc = load_scene(write_cornell(tmp_path, xres=W, yres=H, levels=2),
                         device="cpu")
    cam_v = fp.camera_vec(camera_from_rtc(rtc, device=cuda_device)).to(
        cuda_device)
    runs = []
    for groups in (1, 8):
        s = scene_from_numpy(regroup_meshes(scene_to_numpy(sc), groups),
                             cuda_device)
        nodes, _, update = bvp.make_bvh_tab_updater(s)
        args = (nodes, update(),
                torch.as_tensor(fp.pack_emitters(s), device=cuda_device),
                cam_v, 21)
        runs.append((args, *bvp.bvh_fwd_ls(*args, *cfg, leaf_width=2)))
    (a1, img1, ls1), (a8, img8, ls8) = runs
    assert torch.equal(img1, img8) and torch.equal(ls1, ls8)
    w = ((img1 - 0.05) * (2.0 / (W * H * 3 * 4))).contiguous()
    g1 = bvp.bvh_prb_replay(*a1, w, ls1, *cfg, leaf_width=2)
    g8 = bvp.bvh_prb_replay(*a8, w, ls8, *cfg, leaf_width=2)
    torch.cuda.synchronize()
    scale = float(g1.abs().max())
    assert scale > 0
    assert (g1[0:3, 0] - g8[0:3, :8].sum(dim=1)).abs().max() <= 1e-4 * scale
    assert (g1[:, 1] - g8[:, 8]).abs().max() <= 1e-4 * scale


# sha256 (first 16 hex digits) of the float32 bytes of kernel 1's image of
# the Cornell box and kernel 8's of the levels-3 box at 64x64, 4 spp,
# depth 4, 2 light samples, seed 11, as the two kernels rendered them
# before the training pair joined their lane loop (`_path_kernel_digests`
# on that tree)
PATH_KERNEL_DIGESTS = {"fused": "116502e401bfecec", "bvh": "3fe94d7434a21f70"}


def _path_kernel_digests(tmp_path, device) -> dict:
    sc, rtc = load_scene(write_cornell(tmp_path, xres=64, yres=64),
                         device=device)
    cam = camera_from_rtc(rtc, device=device)
    fused = fp.fused_path(*fp.fused_args(sc, cam), 11, 64, 64, 4, 4, 2)
    bvh = bp.make_bvh_path_renderer(subdivide_scene(sc, levels=3), cam,
                                    samples=4, max_depth=4,
                                    light_samples=2)(11)
    return {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()[:16]
            for k, v in (("fused", fused), ("bvh", bvh))}


@pytest.mark.gpu
def test_path_kernels_render_as_before(tmp_path, cuda_device):
    """Kernels 1 and 8 share their lane loop with 9a/9b; the training
    modes are compile-time branches that the render kernels drop, so
    their images are the ones they rendered before, bit for bit."""
    assert _path_kernel_digests(tmp_path, cuda_device) == PATH_KERNEL_DIGESTS


@pytest.mark.gpu
def test_bvh_whitted_and_prb_wrappers_reject_bad_inputs(tmp_path,
                                                        cuda_device):
    sc, cam = _whitted_scene(tmp_path, cuda_device, levels=1)
    fn = bw.make_bvh_whitted_renderer(sc, cam, samples=1, max_depth=1)
    dd = fn.data
    args = (dd["lights"], dd["cam"], 0, 32, 24, 1, 1, True)
    with pytest.raises(ValueError):          # a tree on the wrong device
        bw.bvh_whitted(dd["nodes"].cpu(), dd["tab"], *args, leaf_width=2)
    with pytest.raises(ValueError):          # the deferred table's width
        bw.bvh_whitted(dd["nodes"], torch.zeros((128, 48), device=cuda_device),
                       *args, leaf_width=2)
    with pytest.raises(ValueError):          # lanes outside the image
        bw.bvh_whitted(dd["nodes"], dd["tab"], *args, leaf_width=2,
                       pix_base=32 * 24 - 2, n_lanes=5)
    with pytest.raises(ValueError):          # nine lights
        bw.bvh_whitted(dd["nodes"], dd["tab"], dd["lights"].repeat(9, 1),
                       *args[1:], leaf_width=2)
    with pytest.raises(ValueError):          # the Whitted table's width
        bw.bvh_whitted_deferred(dd["nodes"], dd["tab"], dd["lights"],
                                dd["cam"], 0, 32, 24, 1, 0, 1, True,
                                leaf_width=2)
    psc, pcam = _scene(tmp_path / "p", cuda_device, "levels-1")
    nodes, _, update = bvp.make_bvh_tab_updater(psc)
    tab = update()
    em = torch.as_tensor(fp.pack_emitters(psc), device=cuda_device)
    cam_v = fp.camera_vec(pcam).to(cuda_device)
    with pytest.raises(ValueError, match="exactly one"):
        bvp.bvh_fwd_ls(nodes, tab, em.repeat(2, 1), cam_v, 0, 4, 4, 1, 1, 1,
                       leaf_width=2)
    with pytest.raises(ValueError, match="samples"):
        bvp.bvh_fwd_ls(nodes, tab, em, cam_v, 0, 4, 4, prb.MAX_SAMPLES + 1,
                       1, 1, leaf_width=2)
    bad = tab.clone()
    bad[0, fp._C_MESH] = prb.M_LANES
    w = torch.zeros((16, 3), device=cuda_device)
    ls = torch.zeros((16, 3), device=cuda_device)
    with pytest.raises(ValueError, match="accumulator columns"):
        bvp.bvh_prb_replay(nodes, bad, em, cam_v, 0, w, ls, 4, 4, 1, 1, 1,
                           leaf_width=2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "levels-3"])
def test_binned_round_kernel_equals_plain(tmp_path, cuda_device, name):
    """Kernel 10 on lanes sorted by bin (some keyed K, some holding a
    hit): bit for bit its plain version; and one sweep of random rays on
    the card equals the same sweep on the CPU (plain rounds)."""
    sc, _ = _scene(tmp_path, cuda_device, name)
    bins, tab, _ = bn.binned_device_data(sc)
    sw = bn.BinnedSweep(bins, tab)
    o, d, alive = random_rays(1 << 14, 4, cuda_device)
    o3, d3 = tuple(o[:, c] for c in range(3)), tuple(d[:, c] for c in range(3))
    before = bn.KERNEL.launches
    t_k, row_k = sw.closest(o3, d3, alive)
    torch.cuda.synchronize()
    assert bn.KERNEL.launches - before == sw.counts["rounds"] > 0
    cpu = bn.BinnedSweep(bins, tab.cpu())
    t_p, row_p = cpu.closest(tuple(x.cpu() for x in o3),
                             tuple(x.cpu() for x in d3), alive.cpu())
    assert torch.equal(row_k.cpu(), row_p) and torch.equal(t_k.cpu(), t_p)
    rng = np.random.default_rng(5)
    n, K = 5000, bins.k
    key = torch.as_tensor(np.sort(np.where(rng.uniform(size=n) < 0.9,
                                           rng.integers(0, K, n), K)),
                          dtype=torch.int32, device=cuda_device)
    st = torch.zeros((8, n), device=cuda_device)
    st[0:3], st[3:6] = o[:n].t(), d[:n].t()
    st[6] = torch.where(key < K, bn.BIG, -bn.BIG)
    st[7] = bn.NO_ROW
    st[6, ::7], st[7, ::7] = 0.8, 3.0
    binned_round_agree(name, st, key, sw)


@pytest.mark.gpu
def test_binned_render_and_draws_on_card(tmp_path, cuda_device):
    """The binned renderer on the card: kernel 10 and the vis kernel's
    draw-only mode launched, the draws equal their plain version's, the
    image within the fused tolerance of the bounce pipeline's reference
    render and of the same renderer's plain run on the CPU."""
    sc, cam = _scene(tmp_path, cuda_device, "levels-3")
    cfg = dict(samples=4, max_depth=3, light_samples=2)
    before = (bn.KERNEL.launches, bo.VIS_KERNEL.launches)
    fn = bn.make_binned_path_renderer(sc, cam, **cfg)
    rec = []
    img = fn(11, record=lambda depth, n, st, hd, kd, vis: rec.append(
        (depth, st[:, :n].clone(), hd, vis)))
    torch.cuda.synchronize()
    assert bn.KERNEL.launches > before[0]
    assert bo.VIS_KERNEL.launches - before[1] == len(rec) >= 2
    data = fn.ctx["data"]
    for depth, st, hd, vis in rec:
        assert vis.shape == (2, hd.shape[1])
        draws_agree(f"levels-3 depth {depth}", data, st, hd, 11, depth, 2)
    ref = bo.bounce_reference_render(sc, cam, 11, **cfg)
    _images_agree(img.reshape(-1, 3), ref.reshape(-1, 3))
    sc_cpu, cam_cpu = _scene(tmp_path / "cpu", "cpu", "levels-3")
    plain = bn.make_binned_path_renderer(sc_cpu, cam_cpu, **cfg)(11)
    _images_agree(img.reshape(-1, 3).cpu(), plain.reshape(-1, 3))


@pytest.mark.gpu
def test_binned_train_step_on_card_matches_plain(tmp_path, cuda_device):
    """The binned trainer on the card (kernel 10 in every sweep) against
    the same step on the CPU (plain rounds): GRAD_TOL of the largest
    entry, both tables dynamic."""
    target = np.full((24, 32, 3), 0.1, np.float32)
    out = []
    for dev in (cuda_device, "cpu"):
        sc, cam = _scene(tmp_path / str(dev), dev, "levels-2")
        step = pw.make_binned_train_step(sc, cam, target, samples=2,
                                         max_depth=3, dynamic_params=True)
        out.append(step({"mat_diffuse": sc.mat_diffuse * 0.9,
                         "mat_emissive": sc.mat_emissive}, 7))
    (loss_k, g_k), (loss_p, g_p) = out
    assert float(loss_k) == pytest.approx(float(loss_p), rel=1e-3)
    for k in g_p:
        assert ((g_k[k].cpu() - g_p[k]).abs().max()
                <= 1e-3 * g_p[k].abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_g8_kernel_matches_plain(tmp_path, cuda_device, any_hit):
    """G8 against kernel 5's plain walk on the same leaf-128 tree: winners
    on >= 99.9% of rays (a lane also tests the leaves its group opened),
    masks equal for any hit; one launch a call."""
    sc, _ = _scene(tmp_path, cuda_device, "levels-3")
    bvh, _ = build_scene_bvh(sc, leaf_size=128)
    assert bvh.leaf_width == 128
    nodes, tri = bx._bvh_device_layout(bvh, cuda_device)
    o, d, alive = random_rays(1 << 16, 3, cuda_device)
    kernel = g8.ANY_HIT_KERNEL if any_hit else g8.KERNEL
    before = kernel.launches
    k = g8.bvh_g8(nodes, tri, o, d, alive, any_hit=any_hit)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    p = bx.bvh_walk_plain(nodes, tri, o, d, alive, leaf_width=128,
                          any_hit=any_hit)
    assert (k[1][~alive] == -1).all()
    if any_hit:
        mask_agree("g8", k, p)
    else:
        brute_agree("g8", (k[0], k[1].long()), (p[0], p[1].long()))
