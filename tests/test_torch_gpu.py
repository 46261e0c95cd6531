"""CUDA kernels of the port against their plain PyTorch versions, on the GPU.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: the brute sweep is written without FMA contraction and must
equal its plain version bit for bit; the fused kernel contracts FMAs and
rounds sqrt/sin/cos differently from the plain version's op-by-op float32
order, so at most 1% of pixels may differ by more than 1e-4 + 1e-3*|ref|
and the image means agree to rel 1e-3; its images are also held bit for
bit to digests of those it rendered before its shadow sweeps were
paired. The PRB training forward (image
and per-sample radiance) and the Whitted kernel are held to the same; the
replay's gradients (float32 terms summed in double by atomics in an order
that varies from run to run) to 1e-3 x the largest entry, chip_smoke.py's
GRAD_TOL. The BVH walk kernel and G8, like the brute sweep, have no
multiply-add to contract and must equal their plain version bit for bit
(G8's any-hit rows too); the BVH path kernel is held to the fused
kernel's pixel tolerance. The three bounce kernels (walk, vis, shade) are
held by chip_smoke.py's `walk_agree`, `vis_agree` and `shade_agree` on
every bounce of one render: winners and visibility planes equal on >=
99.9% of lanes (a tie may break the other way), <= 1% of shaded lanes off
by more than 1e-4 + 1e-3*|ref|; the persistent walk and vis kernels give
the same bits from launch to launch. The BVH Whitted kernel (7a), the
deferred kernel's records (7b, per record row) and the BVH PRB pair
(9a/9b) are held to the fused kernel's and the replay's tolerances.
"""

import ctypes
import dataclasses
import hashlib
import re
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import (SECOND, agreeing_lanes, binned_round_agree,
                        bounce_kernels_agree, draws_agree, mask_agree,
                        record_sweeps, shade_agree, vis_agree, walk_agree)
from cornell_scenes import (random_rays, two_emitter, write_cornell,
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
from orion_tpu_torch.ops import cuda_build
from orion_tpu_torch.ops import fused_path as fp
from orion_tpu_torch.ops import prb
from orion_tpu_torch.ops import prb_wavefront as pw
from orion_tpu_torch.ops import whitted as wh
from orion_tpu_torch.scene import (load_scene, scene_from_numpy,
                                   scene_to_numpy, subdivide_scene)

from torch_port_util import cuda_device  # noqa: F401  (fixture)
from torch_port_util import regroup_meshes


def _big_light(rtc):
    """Make the Cornell box's light (written by write_cornell at `rtc`) a
    1.8 x 1.6 panel facing +z just before the back wall, from y = 0.3 to
    1.9: its plane crosses those of the boxes' tops and sides, so at a hit
    there one light sample can see the light's front while the other's
    geometry term is <= 0."""
    obj = rtc.with_suffix(".obj")
    text = obj.read_text()
    at = text.index("o light")
    corners = iter(["v -0.9 0.3 -0.9", "v 0.9 0.3 -0.9", "v 0.9 1.9 -0.9",
                    "v -0.9 1.9 -0.9"])
    light = re.sub(r"^v .*$", lambda m: next(corners), text[at:], flags=re.M)
    light = re.sub(r"^vn .*$", "vn 0 0 1", light, flags=re.M)
    obj.write_text(text[:at] + light)


def _scene(tmp_path, device, name, xres=32, yres=24):
    rtc = write_cornell(tmp_path, xres=xres, yres=yres)
    if name == "big-light":
        _big_light(rtc)
    sc, rtc = load_scene(rtc, device=device)
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


def _brute_table(tmp_path, device, rows: int, ties: bool = False):
    """A [rows, 16] Woop table: the box's (36 rows), its levels-2
    subdivision's (546) or its levels-4 subdivision's (8,706), whichever
    is the first to hold `rows`, cut to `rows`, or repeated up to them
    past 8,706; `ties`: the table, a row that misses, and the table again,
    so row r ties with row r + rows + 1."""
    name = ("cornell" if rows <= 36 else "levels-2" if rows <= 546
            else "levels-4")
    sc, _ = _scene(tmp_path, device, name)
    tab = bi.pack_tri_rows16(sc)
    tab = tab.repeat(-(-rows // tab.shape[0]), 1)[:rows].contiguous()
    if ties:
        tab = torch.cat([tab, torch.zeros_like(tab[:1]), tab]).contiguous()
    return tab


def _brute_which(n: int) -> int:
    """The instantiation the brute launch takes for n rays: 1 << which
    lanes a ray."""
    lib = ctypes.CDLL(str(cuda_build.lib_path("brute_intersect")))
    return lib.brute_intersect_which(n)


def _brute_equal(tab, o, d, alive):
    before = bi.KERNEL.launches
    t_k, id_k = bi.brute_sweep(tab, o, d, alive)
    torch.cuda.synchronize()
    assert bi.KERNEL.launches == before + 1
    t_p, id_p = bi.brute_sweep_plain(tab, o, d, alive)
    assert torch.equal(id_k, id_p)
    assert torch.equal(t_k, t_p)
    assert bool((id_k[~alive] == -1).all())
    assert bool(torch.isinf(t_k[id_k < 0]).all())
    return id_k


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4099, 1 << 18])
@pytest.mark.parametrize("rows", [1, 36, 257, 576, 9216])
def test_brute_kernel_rows_and_instantiations(tmp_path, cuda_device, rows,
                                              n):
    """The most lanes a ray (4,099 rays: not a whole number of blocks or
    groups) and one lane a ray (2^18 rays, more than a wave) at every
    table size around the tile, bit for bit against the plain version."""
    tab = _brute_table(tmp_path, cuda_device, rows)
    o, d, alive = random_rays(n, 21, cuda_device)
    bi.brute_sweep(tab, o, d, alive)        # builds the kernel
    most = int(re.search(r"constexpr int kMaxSplit = (\d+);",
                         (cuda_build.CSRC / "brute_intersect.cu")
                         .read_text()).group(1)).bit_length() - 1
    assert _brute_which(n) == (most if n < 100_000 else 0)
    ids = _brute_equal(tab, o, d, alive)
    assert int((ids >= 0).sum()) > (n // 10 if rows >= 36 else 0)


@pytest.mark.gpu
def test_brute_kernel_every_instantiation(tmp_path, cuda_device):
    """Sweeps of 4,099 to 140,001 rays (none a whole number of blocks)
    take every instantiation the launch has, 1 to kMaxSplit lanes a ray,
    each bit for bit against the plain version."""
    tab = _brute_table(tmp_path, cuda_device, 576)
    bi.brute_sweep(tab, *random_rays(64, 1, cuda_device))
    most = int(re.search(r"constexpr int kMaxSplit = (\d+);",
                         (cuda_build.CSRC / "brute_intersect.cu")
                         .read_text()).group(1)).bit_length() - 1
    taken = set()
    for k, n in enumerate((4099, 20011, 40009, 70001, 140001)):
        o, d, alive = random_rays(n, 30 + k, cuda_device)
        taken.add(_brute_which(n))
        _brute_equal(tab, o, d, alive)
    assert taken == set(range(most + 1))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4099, 1 << 18])
@pytest.mark.parametrize("rows", [36, 576])
def test_brute_kernel_ties_and_dead_sweeps(tmp_path, cuda_device, rows, n):
    """Planted ties (every row twice, rows + 1 apart: the twins fall to
    different lanes of a group) go to the smaller row; an all-dead sweep
    answers (+inf, -1) everywhere; a sweep with one live ray."""
    tab = _brute_table(tmp_path, cuda_device, rows, ties=True)
    o, d, alive = random_rays(n, 22, cuda_device)
    ids = _brute_equal(tab, o, d, alive)
    hit = ids >= 0
    assert int(hit.sum()) > n // 10 and bool((ids[hit] < rows).all())
    _brute_equal(tab, o, d, torch.zeros_like(alive))
    one = torch.zeros_like(alive)
    one[n // 2] = True
    _brute_equal(tab, o, d, one)


@pytest.mark.gpu
@pytest.mark.parametrize("light_samples", [1, 2, 3])
@pytest.mark.parametrize("name", ["cornell", "levels-2", "two-emitter"])
def test_fused_kernel_matches_plain(tmp_path, cuda_device, name,
                                    light_samples):
    """Kernel 1 against its plain version with one light sample, a pair
    (one shadow sweep for both) and a pair and an odd last sample."""
    sc, cam = _scene(tmp_path, cuda_device, name)
    args = fp.fused_args(sc, cam)
    cfg = (32, 24, 4, 4, light_samples)
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


# sha256 (first 16 hex digits) of the float32 bytes of kernel 1's image at
# 32x24, 4 spp, depth 4, seed 99, by (scene, light samples), as the kernel
# rendered them on an H100 when it swept the rows once for each light
# sample (`_fused_digest` on that tree)
ONE_SWEEP_A_SAMPLE_DIGESTS = {
    ("cornell", 2): "326d235fefda21b8",
    ("levels-2", 2): "42dce6d0b69c861b",
    ("two-emitter", 2): "6a33a483c8412eff",
    ("cornell", 1): "199a80d3d52d59ee",
    ("cornell", 3): "d4650e4d337aee8e",
    ("big-light", 2): "d84d2b9d626773b9",
    ("levels-2", 3): "89d10b47071af833",
    ("big-light", 3): "2b21282f9efe05db",
}


def _fused_digest(tmp_path, device, name, light_samples) -> str:
    sc, cam = _scene(tmp_path, device, name)
    img = fp.fused_path(*fp.fused_args(sc, cam), 99, 32, 24, 4, 4,
                        light_samples)
    return hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()[:16]


@pytest.mark.gpu
@pytest.mark.parametrize("name,light_samples",
                         list(ONE_SWEEP_A_SAMPLE_DIGESTS))
def test_fused_kernel_paired_shadow_sweeps_render_as_before(
        tmp_path, cuda_device, name, light_samples):
    """Kernel 1 sweeps the rows once for two light samples of a path
    vertex; its image is, bit for bit, the one it rendered with a sweep a
    sample: the digests are those of that earlier kernel. The cases hold
    a table swept chunk by chunk (levels-2), two emitters, an odd last
    sample (3) and one sample, and a light whose plane crosses other
    surfaces' (big-light), where a lane sweeps for one of its two samples
    and gates the other."""
    assert (_fused_digest(tmp_path, cuda_device, name, light_samples)
            == ONE_SWEEP_A_SAMPLE_DIGESTS[name, light_samples])


def _images_agree(k, p):
    k, p = k.cpu().numpy(), p.cpu().numpy()
    assert np.isfinite(k).all() and p.mean() > 0
    off = np.abs(k - p) > 1e-4 + 1e-3 * np.abs(p)
    assert off.any(axis=-1).mean() <= 0.01
    assert k.mean() == pytest.approx(p.mean(), rel=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("name,W,H", [("cornell", 32, 24),
                                      ("levels-2", 32, 24),
                                      ("levels-4", 32, 24),
                                      ("cornell", 33, 17)])
def test_prb_kernels_match_plain(tmp_path, cuda_device, name, W, H):
    """3a and 3b against their plain versions: a resident table, tables of
    2 and 18 chunks, and 33x17 pixels (no multiple of a warp or a block:
    the persistent lanes' last warp takes a partial set of pixels)."""
    sc, cam = _scene(tmp_path, cuda_device, name, W, H)
    args = fp.fused_args(sc, cam)
    cfg = (W, H, 4, 4, 2)
    before = (prb.FWD_KERNEL.launches, prb.REPLAY_KERNEL.launches)
    img_k, ls_k = prb.fused_fwd_ls(*args, 99, *cfg)
    img_p, ls_p = fp.fused_fwd_ls_plain(*args, 99, *cfg)
    _images_agree(img_k, img_p)
    _images_agree(ls_k, ls_p)
    w = (img_p * 0.5 + 0.01).contiguous() / (W * H * 3 * 4)
    g_k = prb.prb_replay(*args, 99, w, ls_k, *cfg)
    torch.cuda.synchronize()
    assert (prb.FWD_KERNEL.launches, prb.REPLAY_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    g_p = prb.prb_replay_plain(*args, 99, w, ls_p, *cfg)
    assert g_k.shape == (6, prb.M_LANES) and g_k.dtype == torch.float32
    scale = g_p.abs().max()
    assert scale > 0
    assert (g_k - g_p).abs().max() <= 1e-3 * scale


def _prb_big(tmp_path, device, W, H):
    sc, cam = _scene(tmp_path, device, "cornell", W, H)
    return fp.fused_args(sc, cam)


@pytest.mark.gpu
def test_prb_forward_is_deterministic(tmp_path, cuda_device):
    """More pixels than the card holds threads: every thread of 3a runs
    several pixels, taken from the lane counter in an order that varies
    from launch to launch, and two launches of one seed give the same
    image and per-sample radiance bit for bit."""
    args = _prb_big(tmp_path, cuda_device, 480, 480)
    cfg = (480, 480, 2, 3, 2)
    img, ls = prb.fused_fwd_ls(*args, 17, *cfg)
    img2, ls2 = prb.fused_fwd_ls(*args, 17, *cfg)
    torch.cuda.synchronize()
    assert img.mean() > 0
    assert torch.equal(img, img2) and torch.equal(ls, ls2)


@pytest.mark.gpu
def test_prb_replays_agree(tmp_path, cuda_device):
    """Two replays of one forward sum the same float terms in double, in
    an order of atomics that varies from launch to launch: their float32
    outputs agree within 1e-6 of the largest entry."""
    args = _prb_big(tmp_path, cuda_device, 480, 480)
    cfg = (480, 480, 2, 3, 2)
    img, ls = prb.fused_fwd_ls(*args, 17, *cfg)
    w = ((img - 0.05) * (2.0 / (480 * 480 * 3 * 2))).contiguous()
    g1 = prb.prb_replay(*args, 17, w, ls, *cfg)
    g2 = prb.prb_replay(*args, 17, w, ls, *cfg)
    torch.cuda.synchronize()
    scale = float(g1.abs().max())
    assert scale > 0
    assert (g1 - g2).abs().max() <= 1e-6 * scale


@pytest.mark.gpu
def test_prb_info_reports_the_built_blocks(tmp_path, cuda_device):
    """prb.cu's kernel_info of 3a and 3b at the Cornell box's staged
    table: at least the resident blocks an SM that __launch_bounds__
    asks for (the constexpr kTableBlocks), and no more than the shared
    memory of a block (the replay's 6 KB accumulator and the staged rows)
    leaves room for at 512 rows."""
    import re

    blocks = int(re.search(r"constexpr int kTableBlocks = (\d+);",
                           (cuda_build.CSRC / "prb.cu").read_text())[1])
    sc, cam = _scene(tmp_path, cuda_device, "cornell")
    t_pad = int(fp.fused_args(sc, cam)[0].shape[0])
    cuda_build.build(["prb"])
    lib = ctypes.CDLL(str(cuda_build.lib_path("prb")))
    out = (ctypes.c_int * 4)()
    for which in (0, 1):
        assert lib.prb_info(which, t_pad, out) == 0
        assert out[0] >= blocks, (which, list(out))
        assert out[1] <= 65536 // (blocks * 128)
        assert lib.prb_info(which, 512, out) == 0
        smem = 16 * (1 + 4 * 512) + (6 * 1024 if which else 0)
        assert out[0] <= 228 * 1024 // smem


@pytest.mark.gpu
def test_prb_planes_past_2_31_floats(tmp_path, cuda_device):
    """6144x3840 at 32 spp: the forward's 96 radiance planes hold 2.26e9
    floats (9 GB), so the last planes start past 2^31 floats and their
    offsets need 64 bits. Every plane is written (finite; the image is the
    mean of the samples' planes) and the last sample's planes have the
    first's means within the estimator's noise (1e-2 relative)."""
    W, H, S = 6144, 3840, 32
    args = _prb_big(tmp_path, cuda_device, W, H)
    img, ls = prb.fused_fwd_ls(*args, 5, W, H, S, 0, 2)
    planes = ls.t()                                 # [3 S, W H], a view
    torch.cuda.synchronize()
    assert 3 * S * W * H > 2**31 and (3 * S - 1) * W * H > 2**31
    means = torch.stack([p.double().mean() for p in planes])
    assert all(bool(torch.isfinite(p).all()) for p in planes[-6:])
    assert torch.isfinite(means).all()
    first, last = means[:3], means[-3:]
    assert (first > 0).all()
    assert torch.allclose(last, first, rtol=1e-2)
    per_ch = means.reshape(S, 3).mean(dim=0)
    assert torch.allclose(img.double().mean(dim=0), per_ch, rtol=1e-4)


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
def test_whitted_kernel_any_grid_and_tiles(tmp_path, cuda_device):
    """Kernel 4 takes pixels from a counter: one block of 128 threads
    renders every pixel the same, bit for bit, as the full grid, and a
    tile renders the whole image's pixels; the image and the tile agree
    with the plain version's (the fused tolerance)."""
    sc, rtc = load_scene(write_cornell_whitted(tmp_path, xres=32, yres=24),
                         device=cuda_device)
    args = wh.whitted_args(sc, camera_from_rtc(rtc, device=cuda_device))
    cfg = (32, 24, 3, 4, True)
    before = wh.KERNEL.launches
    full = wh.fused_whitted(*args, 11, *cfg)
    grid = ctypes.CDLL(str(cuda_build.lib_path("whitted")))
    grid.whitted_set_grid(1)
    try:
        one = wh.fused_whitted(*args, 11, *cfg)
        tile = wh.fused_whitted(*args, 11, *cfg, pix_base=5, n_lanes=700)
        torch.cuda.synchronize()
    finally:
        grid.whitted_set_grid(0)
    assert wh.KERNEL.launches == before + 3
    assert torch.equal(one, full)
    assert torch.equal(tile, full[5:705])
    _images_agree(full, wh.fused_whitted_plain(*args, 11, *cfg))
    _images_agree(tile, wh._whitted_plain(
        args[0], args[3], args[4], 11, *cfg, pix_base=5, n_lanes=700))
    with pytest.raises(ValueError, match="outside"):
        wh.fused_whitted(*args, 11, *cfg, pix_base=700, n_lanes=100)


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
@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_walk_kernel_refills_and_walks_recorded_sweeps(
        tmp_path, cuda_device, any_hit):
    """Kernel 5 on 2^21 random rays, more than the card's resident threads
    (so warps refill their lanes from the lane counter), and on every sweep
    of one 256x256 wavefront sample (a thread a ray, no counter): (t, row)
    of the plain walk bit for bit."""
    sc, cam = _scene(tmp_path, cuda_device, "levels-4", xres=256, yres=256)
    bvh, _ = build_scene_bvh(sc, leaf_size=2)
    nodes, tri = bx._bvh_device_layout(bvh, cuda_device)
    kernel = bx.ANY_HIT_KERNEL if any_hit else bx.KERNEL
    kernel._load()
    info = (ctypes.c_int * 4)()
    lib = ctypes.CDLL(str(cuda_build.lib_path("bvh_intersect")))
    assert lib.bvh_intersect_info(int(any_hit) + 2, info) == 0   # counted
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert (1 << 21) > info[0] * sms * 128 > 0
    rays = [random_rays(1 << 21, 5, cuda_device)]
    rays += record_sweeps(sc, cam, bx.make_bvh_intersect_kernel(bvh, sc),
                          SECOND)
    for o, d, alive in rays:
        before = kernel.launches
        t_k, r_k = bx.bvh_walk(nodes, tri, o, d, alive, leaf_width=2,
                               any_hit=any_hit)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        t_p, r_p = bx.bvh_walk_plain(nodes, tri, o, d, alive, leaf_width=2,
                                     any_hit=any_hit)
        assert torch.equal(r_k, r_p) and torch.equal(t_k, t_p)
        assert (r_k[~alive] == -1).all() and (r_k >= 0).any()


@pytest.mark.gpu
def test_bvh_walk_kernel_on_a_refitted_tree(tmp_path, cuda_device):
    """A refit step's layout (accel/refit.RefitPlan over moved vertices,
    what a vertex fit walks every step) walked by kernel 5: the plain
    walk's (t, row) bit for bit, nearest and any-hit, and the moved
    triangles' hits (t against the brute sweep of the moved scene)."""
    from orion_tpu_torch.accel.refit import RefitPlan

    sc, _ = _scene(tmp_path, cuda_device, "levels-3")
    bvh, _ = build_scene_bvh(sc, leaf_size=2)
    rng = np.random.default_rng(2)
    moved = sc.tri_v0 + torch.as_tensor(
        rng.normal(0.0, 0.02, tuple(sc.tri_v0.shape)), dtype=torch.float32,
        device=cuda_device)
    nodes, tri = RefitPlan(bvh).refit(moved, sc.tri_e1, sc.tri_e2,
                                      device=cuda_device)
    o, d, alive = random_rays(1 << 18, 8, cuda_device)
    for any_hit in (False, True):
        t_k, r_k = bx.bvh_walk(nodes, tri, o, d, alive, leaf_width=2,
                               any_hit=any_hit)
        t_p, r_p = bx.bvh_walk_plain(nodes, tri, o, d, alive, leaf_width=2,
                                     any_hit=any_hit)
        assert torch.equal(r_k, r_p) and torch.equal(t_k, t_p)
    moved_sc = dataclasses.replace(sc, tri_v0=moved)
    h_w = bx.make_bvh_intersect_kernel(bvh, sc, layout=(nodes, tri))(
        moved_sc, o, d, alive=alive)
    h_b = bi.intersect_brute_kernel(moved_sc, o, d, alive=alive)
    both = h_w.mask & h_b.mask
    same_t = (~h_w.mask & ~h_b.mask) | (
        both & ((h_w.t - h_b.t).abs() <= 1e-5 * h_b.t.abs() + 1e-6))
    assert float(same_t.float().mean()) >= 0.999


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


def _ray_state(n: int, seed: int, device):
    """A [16, n + 5] wavefront state of random_rays (~10% dead)."""
    o, d, alive = random_rays(n + 5, seed, device)
    st = torch.zeros((16, n + 5), dtype=torch.float32, device=device)
    st[0:3], st[3:6], st[9] = o.t(), d.t(), alive.float()
    return st


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 32, 33, 127, 129, 4097])
def test_bounce_walk_writes_every_lane(tmp_path, cuda_device, n):
    """The persistent walk takes every lane of the live prefix from its
    counter and writes its hitdata: no column is left unwritten (a NaN
    filled buffer), dead lanes read as misses, rows 5-7 are zero; the
    winners are the plain walk's; two launches give the same bits."""
    sc, cam = _scene(tmp_path, cuda_device, "levels-3")
    data = bo.make_bounce_path_renderer(sc, cam, samples=1,
                                        max_depth=1).ctx["data"]
    st = _ray_state(n, 7 + n, cuda_device)
    hd = torch.full((8, n), float("nan"), device=cuda_device)
    nxt = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    bo.WALK_KERNEL.launch(data.nodes.data_ptr(), data.tab.data_ptr(),
                          st.data_ptr(), hd.data_ptr(), nxt.data_ptr(),
                          *bo._tree_args(data), st.shape[1], n,
                          torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(hd).any())
    assert int(nxt) >= n                    # the counter ran past the prefix
    dead = st[9, :n] == 0
    assert bool((hd[0][dead] == bo.BIG).all())
    assert not bool(hd[1:5][:, dead].any()) and not bool(hd[5:].any())
    walk_agree(f"refill n {n}", hd, bo.bounce_walk_plain(data, st, n))
    assert torch.equal(bo.bounce_walk(data, st, n), hd)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 32, 33, 127, 129, 4097])
def test_bounce_vis_writes_every_lane(tmp_path, cuda_device, n):
    """The persistent vis kernel takes every lane of the prefix from its
    counter and writes its column: none left unwritten (a NaN-filled
    buffer), 0/1 planes equal to the plain version's, rows 2-7 zero, the
    lanes that missed all zero; two launches give the same bits."""
    sc, cam = _scene(tmp_path, cuda_device, "levels-3")
    data = bo.make_bounce_path_renderer(sc, cam, samples=1,
                                        max_depth=1).ctx["data"]
    st = _ray_state(n, 3 + n, cuda_device)
    st[14, :n] = torch.arange(n, device=cuda_device, dtype=torch.float32)
    hd = bo.bounce_walk(data, st, n)
    vis = torch.full((8, n), float("nan"), device=cuda_device)
    nxt = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    bo.VIS_KERNEL.launch(data.nodes.data_ptr(), data.tab.data_ptr(),
                         data.em.data_ptr(), st.data_ptr(), hd.data_ptr(),
                         vis.data_ptr(), nxt.data_ptr(), *bo._tree_args(data),
                         data.tab.shape[0], data.em.shape[0], st.shape[1], n,
                         5, 0, 2, 0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(vis).any())
    assert int(nxt) >= n                    # the counter ran past the prefix
    assert not bool(vis[:, hd[4] == 0].any())
    vis_agree(f"refill n {n}", vis, bo.bounce_vis_plain(data, st, hd, 5, 0))
    assert torch.equal(bo.bounce_vis(data, st, hd, 5, 0), vis)


# Both row loads of fused_common.cuh's Woop test on the same (ray, row)
# pairs: woop<true> (13 scalar loads; kernels 1, 8, 3a, 3b, 9a, 9b)
# and woop<true, true> (four float4 loads; the bounce walk, vis and shade).
WOOP_PAIR_CU = r"""
#include "fused_common.cuh"
using namespace orion;

__global__ void woop_pair_kernel(const float* tab, const int* rows,
                                 const float* rays, int n, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = rays[i]; r.oy = rays[n + i]; r.oz = rays[2 * n + i];
  r.dx = rays[3 * n + i]; r.dy = rays[4 * n + i]; r.dz = rays[5 * n + i];
  const float* w = tab + rows[i] * kCols;
  float u0, v0, u1, v1;
  out[i] = woop<true>(w, r, &u0, &v0);
  out[3 * n + i] = woop<true, true>(w, r, &u1, &v1);
  out[n + i] = u0; out[2 * n + i] = v0;
  out[4 * n + i] = u1; out[5 * n + i] = v1;
}

extern "C" int woop_pair(const float* tab, const int* rows,
                         const float* rays, int n, float* out) {
  woop_pair_kernel<<<(n + 127) / 128, 128>>>(tab, rows, rays, n, out);
  return static_cast<int>(cudaGetLastError());
}
"""


@pytest.mark.gpu
def test_woop_row_loads_agree_bitwise(tmp_path, cuda_device):
    """The Woop test's float4 row loads give the scalar loads' t, u and v
    bit for bit on random rays, each against the row its walk hit (so
    most pairs hit) or a random row; both are one template's arithmetic."""
    cu, so = tmp_path / "woop_pair.cu", tmp_path / "woop_pair.so"
    cu.write_text(WOOP_PAIR_CU)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                    str(cuda_build.CSRC), "-o", str(so), str(cu)],
                   check=True, capture_output=True, timeout=600)
    sc, cam = _scene(tmp_path, cuda_device, "levels-3")
    data = bo.make_bounce_path_renderer(sc, cam, samples=1,
                                        max_depth=1).ctx["data"]
    n = 1 << 16
    st = _ray_state(n, 11, cuda_device)
    st[9] = 1.0
    hd = bo.bounce_walk(data, st, n)
    rng = np.random.default_rng(5)
    other = torch.as_tensor(rng.integers(0, data.tab.shape[0], n),
                            device=cuda_device)
    hit = hd[4] > 0
    rows = torch.where(hit & (torch.arange(n, device=cuda_device) % 4 != 0),
                       hd[3].to(torch.int64), other).to(torch.int32)
    rays = st[:6, :n].contiguous()
    out = torch.empty((6, n), dtype=torch.float32, device=cuda_device)
    lib = ctypes.CDLL(str(so))
    lib.woop_pair.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                      ctypes.c_void_p]
    torch.cuda.synchronize()
    assert lib.woop_pair(data.tab.data_ptr(), rows.data_ptr(),
                         rays.data_ptr(), n, out.data_ptr()) == 0
    torch.cuda.synchronize()
    assert int((out[0] < bo.BIG).sum()) > n // 2      # mostly hits
    assert torch.equal(out[:3].view(torch.int32), out[3:].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("with_aux", [False, True])
def test_bounce_shade_instantiations_match_plain(tmp_path, cuda_device,
                                                 with_aux, planes, textured):
    """Each of the shade kernel's four instantiations (the aux dump; the
    visibility planes given or its own shadow walks), with and without
    texel kd planes, on the recorded state of every bounce."""
    sc, cam = _scene(tmp_path, cuda_device, "levels-3")
    fn = bo.make_bounce_path_renderer(sc, cam, samples=4, max_depth=4,
                                      light_samples=2)
    data = fn.ctx["data"]
    rec = []
    fn(5, record=lambda depth, n, st, hd, kd, vis: rec.append(
        (depth, n, st[:, :n].clone(), hd)))
    torch.cuda.synchronize()
    rng = np.random.default_rng(3)
    assert len(rec) >= 3
    for depth, n, st, hd in rec:
        kd = (torch.as_tensor(rng.uniform(0.05, 0.95, (3, n)),
                              dtype=torch.float32, device=cuda_device)
              if textured else None)
        vis = bo.bounce_vis(data, st, hd, 5, depth) if planes else None
        st_k = st.clone()
        aux_k = bo.bounce_shade(data, st_k, hd, 5, depth, 4, 2, kd=kd,
                                vis=vis, with_aux=with_aux)
        st_p, aux_p = bo.bounce_shade_plain(data, st, hd, 5, depth, 4, 2,
                                            kd=kd, vis=vis,
                                            with_aux=with_aux)
        tag = f"aux {with_aux} planes {planes} kd {textured} depth {depth}"
        shade_agree(tag, st_k, st_p)
        if with_aux:
            shade_agree(f"{tag} aux", aux_k, aux_p, rows=15)


@pytest.mark.gpu
@pytest.mark.parametrize("light_samples", [1, 3])
def test_bounce_shade_single_samples_match_plain(tmp_path, cuda_device,
                                         light_samples):
    """Two emitters and one or three light samples: the shade kernel's
    single-ray shadow walks (shadow_em), one per (emitter, light sample)
    site, beside the paired walks of two samples."""
    sc, cam = _scene(tmp_path, cuda_device, "two-emitter")
    fn = bo.make_bounce_path_renderer(sc, cam, samples=2, max_depth=3,
                                      light_samples=light_samples)
    res = bounce_kernels_agree(f"two-emitter ls {light_samples}", fn, 13,
                               with_aux=True)
    assert len(res) >= 2


@pytest.mark.gpu
def test_bounce_renders_agree_on_card(tmp_path, cuda_device):
    """split_vis, the unsorted wavefront and tiles give the fused sorted
    render; the BVH path kernel's and the binned renderer's images differ
    by rounding and ties."""
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
    binned = bn.make_binned_path_renderer(sc, cam, **cfg)(5)
    _images_agree(binned.reshape(-1, 3), img.reshape(-1, 3))


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
@pytest.mark.parametrize("textured", [False, True])
def test_bvh_whitted_kernels_any_grid(tmp_path, cuda_device, textured):
    """Kernels 7a and 7b take pixels from a counter: one block of 128
    threads renders every pixel of the image (several a thread) the same,
    bit for bit, as the full grid, and so does a tile."""
    sc, cam = _whitted_scene(tmp_path, cuda_device, levels=2,
                             checker=textured)
    if textured:
        fn = bw.make_bvh_whitted_deferred(sc, cam, samples=3, max_depth=4)
        dd = fn.data

        def run(**kw):
            return bw.bvh_whitted_textured(
                sc, dd["nodes"], dd["tab"], dd["lights"], dd["cam"], 11, 32,
                24, 3, 4, dd["with_emissive"], leaf_width=dd["leaf_width"],
                texels=dd["texels"], **kw)
        kernel = bw.DEFERRED_KERNEL
    else:
        fn = bw.make_bvh_whitted_renderer(sc, cam, samples=3, max_depth=4)
        dd = fn.data

        def run(**kw):
            return bw.bvh_whitted(dd["nodes"], dd["tab"], dd["lights"],
                                  dd["cam"], 11, 32, 24, 3, 4,
                                  dd["with_emissive"],
                                  leaf_width=dd["leaf_width"], **kw)
        kernel = bw.KERNEL
    before = kernel.launches
    full = run()
    # the library's test entry point: both launchers take one block
    grid = ctypes.CDLL(str(cuda_build.lib_path("bvh_whitted")))
    grid.bvh_whitted_set_grid(1)
    try:
        one = run()
        tile = run(pix_base=5, n_lanes=700)
        torch.cuda.synchronize()
    finally:
        grid.bvh_whitted_set_grid(0)
    assert kernel.launches == before + 3
    assert torch.equal(one, full)
    assert torch.equal(tile, full[5:705])
    assert torch.equal(full, fn(11).reshape(-1, 3))
    assert float(full.mean()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("checker", [False, True])
def test_bvh_whitted_deferred_kernel_matches_plain(tmp_path, cuda_device,
                                                   checker):
    """Kernel 7b's image, one launch a render, against the plain version's
    records and their epilogue (back to front) and against the same
    records folded in the kernel's order (front to back)."""
    sc, cam = _whitted_scene(tmp_path, cuda_device, levels=2,
                             checker=checker)
    fn = bw.make_bvh_whitted_deferred(sc, cam, samples=3, max_depth=2)
    dd = fn.data
    before = bw.DEFERRED_KERNEL.launches
    img = fn(99).reshape(-1, 3)
    torch.cuda.synchronize()
    assert bw.DEFERRED_KERNEL.launches == before + 1
    rec = bw.bvh_whitted_deferred_plain(
        dd["nodes"], dd["tab"], dd["lights"], dd["cam"], 99, 32, 24, 3, 0, 2,
        dd["with_emissive"], leaf_width=2)
    _images_agree(img, bw.deferred_epilogue(sc, rec, 3, 2) / 3.0)
    _images_agree(img, bw.fold_front_to_back(sc, rec, 3, 2) / 3.0)
    if not checker:     # untextured, it is the BVH Whitted image
        _images_agree(img, bw.make_bvh_whitted_renderer(
            sc, cam, samples=3, max_depth=2)(99).reshape(-1, 3))


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [0, 4])
@pytest.mark.parametrize("maps", ["kd", "kd+ks"])
def test_bvh_whitted_textured_kernel_maps_tiles_depths(tmp_path, cuda_device,
                                                       depth, maps):
    """Kernel 7b on the checker as the diffuse map, and as the specular
    map too (the mirror chain's throughput then comes from the texels and
    reaches zero), at depth 0 and 4, against its plain version (records and
    epilogue); a tile renders the whole image's pixels."""
    sc, cam = _whitted_scene(tmp_path, cuda_device, levels=2, checker=True)
    if maps == "kd+ks":
        f = scene_to_numpy(sc)
        f["mat_map_specular"] = f["mat_map_diffuse"].copy()
        sc = scene_from_numpy(f, cuda_device)
    fn = bw.make_bvh_whitted_deferred(sc, cam, samples=4, max_depth=depth)
    dd = fn.data
    img = fn(7).reshape(-1, 3)
    p = bw.bvh_whitted_textured_plain(
        sc, dd["nodes"], dd["tab"], dd["lights"], dd["cam"], 7, 32, 24, 4,
        depth, dd["with_emissive"], leaf_width=2)
    _images_agree(img, p)
    tile = fn(7, pix_base=100, n_lanes=300)
    torch.cuda.synchronize()
    assert torch.equal(tile, img[100:400])
    if maps == "kd+ks" and depth:     # the texels' Ks, not the solid one
        solid = bw.make_bvh_whitted_deferred(
            _whitted_scene(tmp_path / "s", cuda_device, levels=2,
                           checker=True)[0], cam, samples=4,
            max_depth=depth)(7).reshape(-1, 3)
        assert float((img - solid).abs().max()) > 1e-3


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
        bw.bvh_whitted_textured(sc, dd["nodes"], dd["tab"], dd["lights"],
                                dd["cam"], 0, 32, 24, 1, 1, True,
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
@pytest.mark.parametrize("case,max_rows", [
    ("many-bins", 256), ("one-lane", 512), ("four-lanes", 512),
    ("every-split", 256), ("keyed-K", 512), ("wide-bins", 1024)])
def test_binned_round_schedules_equal_plain(tmp_path, cuda_device, case,
                                            max_rows):
    """Kernel 10's bin-major blocks, bit for bit against the plain round:
    lanes spread thin over every bin, a round of 1 lane and one of 4,
    rounds of 300 to 70,000 lanes whose bins take every split the launch
    picks (1 to 32 threads a lane; bins past one block), lanes keyed K
    copied through, and bins of up to 8 bundles (staged 512 rows at a
    time)."""
    sc, _ = _scene(tmp_path, cuda_device, "levels-3")
    bins, tab, _ = bn.binned_device_data(sc, max_rows=max_rows)
    K = bins.k
    rng = np.random.default_rng(len(case) + max_rows)
    if case == "many-bins":
        keys = rng.integers(0, K, 3 * K)
    elif case == "one-lane":
        keys = np.array([K // 2])
    elif case == "four-lanes":
        keys = rng.integers(0, K, 4)
    elif case == "every-split":
        rounds = [rng.integers(0, K, n) for n in
                  (70000, 40000, 20000, 9000, 5000, 2000, 300)]
        rounds.append(np.repeat(np.arange(K), [(1, 3, 5, 9, 17, 33, 65)[
            b % 7] for b in range(K)]))
    elif case == "wide-bins":
        assert int(bins.n_bundles.max()) > 4
        keys = np.repeat(np.arange(K), 50)
    else:
        keys = np.where(rng.uniform(size=3000) < 0.7,
                        rng.integers(0, K, 3000), K)
    if case != "every-split":
        rounds = [keys]
    row0 = torch.as_tensor(bins.row0, device=cuda_device)
    nb = torch.as_tensor(bins.n_bundles, device=cuda_device)
    splits = set()
    for keys in rounds:
        n = len(keys)
        key = torch.as_tensor(np.sort(keys).astype(np.int32),
                              device=cuda_device)
        o, d, _ = random_rays(n, 5, cuda_device)
        st = torch.zeros((8, n), device=cuda_device)
        st[0:3], st[3:6] = o.t(), d.t()
        st[6], st[7] = bn.BIG, bn.NO_ROW
        st[6, ::5], st[7, ::5] = 0.9, 7.0
        splits |= {s for *_, s in bn.round_schedule(key, K)}
        before = bn.KERNEL.launches
        k = bn.binned_round(st, key, row0, nb, tab)
        torch.cuda.synchronize()
        assert bn.KERNEL.launches == before + 1
        p = bn.binned_round_plain(st, key, row0, nb, tab)
        assert torch.equal(k, p)
        assert int((p[1] < bn.NO_ROW).sum()) > 0
    if case == "every-split":
        assert splits == {1, 2, 4, 8, 16, 32}


@pytest.mark.gpu
def test_binned_sweep_phases_on_card(tmp_path, cuda_device):
    """BinnedSweep.phases (what tools/binned_probe.py splits a render by):
    a sweep on the card appends an event at the end of each of its steps,
    in order, a round's five steps once a kernel-10 launch; nothing when
    phases is None."""
    sc, _ = _scene(tmp_path, cuda_device, "levels-3")
    bins, tab, _ = bn.binned_device_data(sc)
    sw = bn.BinnedSweep(bins, tab)
    o, d, alive = random_rays(1 << 12, 4, cuda_device)
    o3, d3 = tuple(o[:, c] for c in range(3)), tuple(d[:, c] for c in range(3))
    sw.closest(o3, d3, alive)
    sw.phases = []
    sw.closest(o3, d3, alive)
    torch.cuda.synchronize()
    rounds = sw.counts["rounds"] // 2
    assert rounds > 0
    assert [n for n, _ in sw.phases] == (
        ["start", "order"]
        + ["select", "key sort", "gather", "kernel", "scatter"] * rounds
        + ["select", "finish"])
    assert all(a.elapsed_time(b) >= 0.0
               for (_, a), (_, b) in zip(sw.phases, sw.phases[1:]))


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
    """G8 against kernel 5's plain walk on the same leaf-128 tree: (t, row)
    bit for bit, nearest and any hit (a lane walks exactly its own path
    and settles at its first leaf with a hit); one launch a call."""
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
    assert torch.equal(k[1], p[1]) and torch.equal(k[0], p[0])


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["ties", "dead", "n"])
def test_g8_kernel_ties_dead_lanes_and_sizes(tmp_path, cuda_device, case,
                                             any_hit):
    """G8 bit for bit against the plain walk where every leaf meets every
    ray and rows tie at equal t inside a leaf and across leaves
    (torch_port_util.g8_tie_layout); on rays of which every third is dead
    (groups that end part full); and on launches of 1 to 4,099 rays and of
    2^18 rays, past one wave of the card (groups packed full; the smaller
    launches spread a block's live rays over its warps)."""
    from torch_port_util import g8_tie_layout

    sc, _ = _scene(tmp_path, cuda_device, "levels-2")
    bvh, _ = build_scene_bvh(sc, leaf_size=128)
    nodes, tri = bx._bvh_device_layout(bvh, cuda_device)
    if case == "ties":
        nodes, tri = g8_tie_layout(nodes, tri)
    sizes = [1, 31, 33, 257, 4099, 1 << 18] if case == "n" else [1 << 15]
    for n in sizes:
        o, d, alive = random_rays(n, 17 + n, cuda_device)
        if case == "dead":
            alive = torch.arange(n, device=cuda_device) % 3 != 0
        k = g8.bvh_g8(nodes, tri, o, d, alive, any_hit=any_hit)
        p = bx.bvh_walk_plain(nodes, tri, o, d, alive, leaf_width=128,
                              any_hit=any_hit)
        assert torch.equal(k[1], p[1]) and torch.equal(k[0], p[0]), n

@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["brute", "bvh"])
def test_normal_maps_kernel_image_equals_plain(tmp_path, cuda_device,
                                               backend):
    """render(normal_maps=True) over kernel 2 (Cornell) or kernel 5 (the
    levels-2 box's tree) against the same render over the kernel's plain
    version on the card, one generator seed: <= 1% of pixels off (the
    kernels' hits are their plain versions' bit for bit)."""
    from chip_smoke import fused_agree, plain_intersect
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.render import render

    rtc = write_cornell(tmp_path, xres=48, yres=40, depth=3,
                        levels=2 if backend == "bvh" else 0, bump=True)
    ps = prepare(rtc, device=cuda_device, force_backend=backend)
    assert ps.backend == f"{backend}-kernel"
    kernel = bi.KERNEL if backend == "brute" else bx.KERNEL
    images, launched = [], []
    for fn in (ps.intersect, plain_intersect(ps)):
        g = torch.Generator(device=cuda_device)
        g.manual_seed(11)
        before = kernel.launches
        with torch.no_grad():
            images.append(render(ps.scene, ps.camera, g, samples=2,
                                 max_depth=3, light_samples=2,
                                 normal_maps=True, intersect=fn))
        launched.append(kernel.launches - before)
    assert launched[0] > 0 and launched[1] == 0
    fused_agree(f"normal maps {backend}", *images)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(11)
    with torch.no_grad():
        flat = render(ps.scene, ps.camera, g, samples=2, max_depth=3,
                      light_samples=2, intersect=ps.intersect)
    assert float((images[0] - flat).abs().max()) > 1e-3


@pytest.mark.gpu
def test_remat_recompute_launches_no_intersect(tmp_path, cuda_device):
    """make_loss with remat True and "hits" on kernel 2: the same forward
    launches as remat=False, none in the backward pass, and the value and
    gradients within 1e-6 of the largest entry of remat=False's."""
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.optim import make_loss

    ps = prepare(write_cornell(tmp_path, xres=64, yres=48, depth=3),
                 device=cuda_device)
    assert ps.backend == "brute-kernel"
    target = torch.zeros((48, 64, 3), device=cuda_device)
    out = {}
    for remat in (False, True, "hits"):
        params = {k: getattr(ps.scene, k).clone().requires_grad_(True)
                  for k in ("mat_diffuse", "tri_v0")}
        loss_fn = make_loss(ps.scene, ps.camera, samples=2, max_depth=3,
                            light_samples=2, mode=None,
                            intersect=ps.intersect, remat=remat)
        g = torch.Generator(device=cuda_device)
        g.manual_seed(2)
        before = bi.KERNEL.launches
        loss = loss_fn(params, g, target)
        fwd = bi.KERNEL.launches - before
        loss.backward()
        torch.cuda.synchronize()
        out[remat] = (loss.detach(), params["mat_diffuse"].grad,
                      params["tri_v0"].grad, fwd,
                      bi.KERNEL.launches - before - fwd)
    assert out[False][3] == 2 * 2 * 4 and out[False][4] == 0
    for remat in (True, "hits"):
        assert out[remat][3:] == out[False][3:], remat
        for i in range(3):
            scale = float(out[False][i].abs().max())
            assert scale > 0
            err = float((out[remat][i] - out[False][i]).abs().max())
            assert err <= 1e-6 * scale, (remat, i, err, scale)


# --- pixel tiles of kernels 1, 3a and 3b (parallel/fused_shard.py) --------

# uneven tiles of a 33x17 image (561 pixels)
TILES = ((0, 200), (200, 433), (433, 561))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "levels-2"])
def test_path_kernel_tiles_are_the_whole_images_rows(tmp_path, cuda_device,
                                                     name):
    """Kernel 1 launched on a tile (pix_base != 0) renders the whole
    image's rows bit for bit (its draws hash global pixel ids), and each
    tile agrees with its plain version's tile."""
    sc, cam = _scene(tmp_path, cuda_device, name, 33, 17)
    args = fp.fused_args(sc, cam)
    cfg = (33, 17, 4, 4, 2)
    whole = fp.fused_path(*args, 99, *cfg)
    for lo, hi in TILES + ((37, 38),):
        before = fp.KERNEL.launches
        tile = fp.fused_path(*args, 99, *cfg, pix_base=lo, n_lanes=hi - lo)
        torch.cuda.synchronize()
        assert fp.KERNEL.launches == before + 1
        assert torch.equal(tile, whole[lo:hi]), (lo, hi)
    for lo, hi in TILES:
        _images_agree(fp.fused_path(*args, 99, *cfg, pix_base=lo,
                                    n_lanes=hi - lo),
                      fp.fused_path_plain(*args, 99, *cfg, pix_base=lo,
                                          n_lanes=hi - lo))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "levels-2"])
def test_prb_kernel_tiles_are_the_whole_images_rows(tmp_path, cuda_device,
                                                    name):
    """3a on a tile writes the whole image's rows and L_s planes bit for
    bit into the tile's own planes; 3b's tile gradients add up to the
    whole image's (double atomics in another order) and each tile pair
    agrees with its plain versions."""
    sc, cam = _scene(tmp_path, cuda_device, name, 33, 17)
    args = fp.fused_args(sc, cam)
    cfg = (33, 17, 4, 4, 2)
    img, ls = prb.fused_fwd_ls(*args, 99, *cfg)
    w = (img * 0.5 + 0.01).contiguous() / (33 * 17 * 3 * 4)
    g = prb.prb_replay(*args, 99, w, ls, *cfg)
    g_sum = torch.zeros_like(g)
    for lo, hi in TILES:
        kw = dict(pix_base=lo, n_lanes=hi - lo)
        i, l = prb.fused_fwd_ls(*args, 99, *cfg, **kw)
        torch.cuda.synchronize()
        assert l.shape == (hi - lo, 12)
        assert torch.equal(i, img[lo:hi]) and torch.equal(l, ls[lo:hi])
        ip, lp = fp.fused_fwd_ls_plain(*args, 99, *cfg, **kw)
        _images_agree(i, ip)
        _images_agree(l, lp)
        wt = w[lo:hi].contiguous()
        gt = prb.prb_replay(*args, 99, wt, l, *cfg, **kw)
        gp = prb.prb_replay_plain(*args, 99, wt, lp, *cfg, **kw)
        assert (gt - gp).abs().max() <= 1e-3 * gp.abs().max()
        g_sum += gt
    scale = g.abs().max()
    assert scale > 0 and (g_sum - g).abs().max() <= 1e-5 * scale


@pytest.mark.gpu
def test_prb_tile_planes_past_2_31_floats(tmp_path, cuda_device):
    """A tile of 22,692,960 pixels of a 6144x3840 image at 32 spp: its own
    96 planes hold 2.18e9 floats, so the last plane starts past 2^31
    floats; the tile's last rows equal the whole image's, image and
    planes."""
    W, H, S = 6144, 3840, 32
    args = _prb_big(tmp_path, cuda_device, W, H)
    lo = 900_000
    n = W * H - lo
    assert 3 * S * n > 2**31 and (3 * S - 1) * n > 2**31
    img, ls = prb.fused_fwd_ls(*args, 5, W, H, S, 0, 2, pix_base=lo,
                               n_lanes=n)
    tail_img, tail_ls = img[-4096:].clone(), ls[-4096:].clone()
    del img, ls
    whole_img, whole_ls = prb.fused_fwd_ls(*args, 5, W, H, S, 0, 2)
    torch.cuda.synchronize()
    assert torch.isfinite(tail_ls).all() and tail_img.mean() > 0
    assert torch.equal(tail_img, whole_img[-4096:])
    assert torch.equal(tail_ls, whole_ls[-4096:])


@pytest.mark.gpu
def test_shardmap_world_of_one_on_nccl(tmp_path, cuda_device):
    """A world of one over NCCL: render_shardmap on kernel 2 issues one
    all-gather (the image's bytes) and equals `render`; a
    make_train_step_shardmap step issues one all-reduce."""
    import torch.distributed as dist

    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.parallel.distributed import measure_collective_bytes
    from orion_tpu_torch.parallel.sharding import make_mesh
    from orion_tpu_torch.parallel.shardmap_render import (
        make_train_step_shardmap, render_shardmap)
    from orion_tpu_torch.render import render

    def gen(seed):
        g = torch.Generator(device=cuda_device)
        g.manual_seed(seed)
        return g

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()
        ps = prepare(write_cornell(tmp_path, xres=64, yres=48, depth=3),
                     device=mesh.device)
        cfg = dict(samples=2, max_depth=3, light_samples=2)
        out = []
        before = bi.KERNEL.launches
        with torch.no_grad():
            rep = measure_collective_bytes(lambda: out.append(
                render_shardmap(ps.scene, ps.camera, gen(3), mesh=mesh,
                                intersect=ps.intersect, **cfg)))
            ref = render(ps.scene, ps.camera, gen(3), intersect=ps.intersect,
                         **cfg)
        assert bi.KERNEL.launches > before
        assert rep["ops"] == 1
        assert rep["by_kind"]["all-gather"] == 64 * 48 * 3 * 4
        assert torch.equal(out[0], ref) and ref.mean() > 0
        step = make_train_step_shardmap(ps.scene, ps.camera, mesh, samples=1,
                                        max_depth=2, light_samples=1,
                                        intersect=ps.intersect)
        params = {"mat_diffuse": ps.scene.mat_diffuse * 0.5}
        rep = measure_collective_bytes(step, params, gen(1),
                                       torch.zeros_like(ref))
        assert rep["ops"] == 1 and rep["by_kind"]["all-reduce"] == 4 * (
            ps.scene.mat_diffuse.numel() + 1)
    finally:
        dist.destroy_process_group()


def _flown(rtc_path, xres, yres, device):
    """A camera flown from the rtc's at xres x yres (the viewer's keys)."""
    from orion_tpu_torch.io.rtc import parse_rtc
    from orion_tpu_torch.viewer import FlyCamera

    rtc = parse_rtc(rtc_path)
    rtc.xres, rtc.yres = xres, yres
    cam = FlyCamera.from_rtc(rtc)
    cam.move(forward=1, strafe=0.5)
    cam.turn(dyaw=0.14, dpitch=-0.07)
    cam.zoom(3.0)
    return camera_from_rtc(cam.apply_to_rtc(rtc), device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["1", "8", "4", "7a", "7b"])
def test_camera_override_on_card_equals_a_fresh_renderer(tmp_path,
                                                          cuda_device, name):
    """Each megakernel flown through camera_override renders, bit for bit,
    the frame of a renderer built for that camera (kernels 1, 8, 4, 7a,
    7b at 96x64)."""
    W, H = 96, 64
    if name in ("1", "8"):
        rtc = write_cornell(tmp_path, xres=W, yres=H, depth=3)
    else:
        rtc = write_cornell_whitted(tmp_path, xres=W, yres=H, depth=3,
                                    checker=name == "7b")
    sc, r = load_scene(rtc, device=cuda_device)
    if name in ("8", "7a"):
        sc = subdivide_scene(sc, levels=3)
    make = {"1": lambda c: fp.make_fused_path_renderer(
                sc, c, samples=2, max_depth=3),
            "8": lambda c: bp.make_bvh_path_renderer(
                sc, c, samples=2, max_depth=3),
            "4": lambda c: wh.make_fused_whitted_renderer(
                sc, c, samples=2, max_depth=3),
            "7a": lambda c: bw.make_bvh_whitted_renderer(
                sc, c, samples=2, max_depth=3),
            "7b": lambda c: bw.make_bvh_whitted_deferred(
                sc, c, samples=2, max_depth=3)}[name]
    kernel = {"1": fp.KERNEL, "8": bp.KERNEL, "4": wh.KERNEL,
              "7a": bw.KERNEL, "7b": bw.DEFERRED_KERNEL}[name]
    fn = make(camera_from_rtc(r, device=cuda_device))
    flown = _flown(rtc, W, H, cuda_device)
    before = kernel.launches
    a = fn(7, camera_override=flown)
    assert kernel.launches == before + 1
    b = make(flown)(7)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and float(a.max()) > 0
    assert not torch.equal(a, fn(7))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "levels-4"])
def test_tp_slab_sweeps_on_kernel2_merge_to_the_whole_sweep(tmp_path,
                                                            cuda_device,
                                                            name):
    """Primitive sharding's slab sweeps on kernel 2, merged rank by rank,
    equal intersect_brute_kernel over the whole table bit for bit."""
    from orion_tpu_torch.parallel.primitive_sharding import (merge_slab_hits,
                                                             slab_hit)

    sc, _ = _scene(tmp_path, cuda_device, name)
    o, d, alive = random_rays(1 << 18, 3, cuda_device)
    ref = bi.intersect_brute_kernel(sc, o, d, alive=alive)
    for n_tp in (2, 3, 8):
        before = bi.KERNEL.launches
        parts = [slab_hit(sc, o, d, alive, k, n_tp) for k in range(n_tp)]
        assert bi.KERNEL.launches == before + n_tp
        h = merge_slab_hits(torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts]))
        assert torch.equal(h.tri_id, ref.tri_id) and torch.equal(h.t, ref.t)
    assert float(ref.mask.float().mean()) > 0.5


@pytest.mark.gpu
def test_treelet_intersect_on_kernel5_matches_one_tree(tmp_path, cuda_device,
                                                       monkeypatch):
    """The treelet intersect (kernel 5 on every part, nearest and any hit)
    against the one-tree walk of the levels-4 box: on random rays from
    inside the room hit masks equal and t within rtol 1e-5 (rays from
    inside a box meet its bottom and the floor at one t, and that tie may
    break the other way across trees: 0.14% of the ids); on the camera's
    primary rays ids on >= 99.9% of the hits and t bit for bit."""
    from orion_tpu_torch import engine
    from orion_tpu_torch.camera import primary_rays

    sc, cam = _scene(tmp_path, cuda_device, "levels-4", xres=256, yres=256)
    fn1, name, bvh, _ = engine.select_intersect(sc)
    assert name == "bvh-kernel"
    monkeypatch.setattr(engine, "RESIDENT_MAX_BUNDLED", bvh.num_bundled // 3)
    fn, name, tree, _ = engine.select_intersect(sc)
    assert name == "bvh-kernel-treelet" and tree is None
    assert fn.num_treelets >= 3
    o, d, alive = random_rays(1 << 18, 4, cuda_device)
    before = (bx.KERNEL.launches, bx.ANY_HIT_KERNEL.launches)
    h, ref = fn(sc, o, d, alive=alive), fn1(sc, o, d, alive=alive)
    a = fn.any_hit_variant(sc, o, d, alive=alive)
    assert (bx.KERNEL.launches - before[0] - 1,
            bx.ANY_HIT_KERNEL.launches - before[1]) == (fn.num_treelets,
                                                       fn.num_treelets)
    assert torch.equal(h.mask, ref.mask) and torch.equal(a.mask, ref.mask)
    hit = ref.mask
    assert float(hit.float().mean()) > 0.5
    np.testing.assert_allclose(h.t[hit].cpu().numpy(),
                               ref.t[hit].cpu().numpy(), rtol=1e-5)
    o, d = primary_rays(cam, 0.0131, 0.0217)
    h, ref = fn(sc, o, d), fn1(sc, o, d)
    hit = ref.mask
    assert torch.equal(h.mask, hit) and float(hit.float().mean()) > 0.9
    assert float((h.tri_id == ref.tri_id)[hit].float().mean()) >= 0.999
    assert torch.equal(h.t, ref.t)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["path", "whitted"])
def test_sample_offset_on_cuda_generators(tmp_path, cuda_device, mode):
    """render(samples=m, sample_offset=k) on a CUDA generator continues
    render(k) on one generator bit for bit, and adds up with it to
    render(k + m) within 1e-6 of the largest entry; skipping leaves the
    generator's state as rendering does."""
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.render import render, skip_samples

    rtc = (write_cornell(tmp_path, xres=64, yres=48, depth=3)
           if mode == "path" else
           write_cornell_whitted(tmp_path, xres=64, yres=48, depth=3))
    ps = prepare(rtc, device=cuda_device)

    def gen():
        g = torch.Generator(device=cuda_device)
        g.manual_seed(11)
        return g

    cfg = dict(max_depth=3, light_samples=2, intersect=ps.intersect)
    with torch.no_grad():
        part = render(ps.scene, ps.camera, gen(), samples=2,
                      sample_offset=3, **cfg)
        g = gen()
        head = render(ps.scene, ps.camera, g, samples=3, **cfg)
        state = g.get_state()
        cont = render(ps.scene, ps.camera, g, samples=2, **cfg)
        whole = render(ps.scene, ps.camera, gen(), samples=5, **cfg)
    assert torch.equal(part, cont) and float(whole.max()) > 0
    err = float((part * 2 + head * 3 - whole * 5).abs().max())
    assert err <= 1e-6 * float((whole * 5).abs().max())
    s = gen()
    skip_samples(ps.scene, s, 3, ps.camera.yres, ps.camera.xres,
                 cuda_device, max_depth=3, light_samples=2, mode=None)
    assert torch.equal(s.get_state(), state)


FIT_CFG = dict(samples=2, max_depth=3, light_samples=2)


def _fit_problem(tmp_path, device, whitted=False):
    """A PreparedScene of the 32x24 box with its albedos x 0.8, and a grey
    target."""
    from orion_tpu_torch.engine import prepare

    write = write_cornell_whitted if whitted else write_cornell
    ps = prepare(write(tmp_path, xres=32, yres=24, depth=3), device=device)
    ps = dataclasses.replace(ps, scene=dataclasses.replace(
        ps.scene, mat_diffuse=ps.scene.mat_diffuse * 0.8))
    return ps, torch.full((24, 32, 3), 0.1, device=device)


def _fit_counted(ps, target, **kw):
    """(FitResult, whether the stream was idle when fit returned, the
    registry's totals over the fit)."""
    from orion_tpu_torch import profiling
    from orion_tpu_torch.optim import fit

    profiling.reset()
    try:
        with profiling.recording():
            res = fit(ps, target, **kw)
            idle = torch.cuda.current_stream().query()
        return res, idle, profiling.totals()
    finally:
        profiling.reset()


@pytest.mark.gpu
def test_fit_on_the_fused_route_reads_each_loss_from_its_copy(
        tmp_path, cuda_device):
    """fit over kernels 3a/3b reads each step's loss from its own host
    copy (one `fit.loss_event` a step, one id check a job) and returns
    with the stream idle; its losses, the parameters each callback reads
    and its result are bit for bit those of driving make_fused_train_step
    by hand with float(loss) after every step, the same Adam and the same
    projection."""
    ps, target = _fit_problem(tmp_path, cuda_device)
    steps, lr, seed = 4, 5e-2, 9
    opts, seen = [], []

    def adam(p):
        opts.append(torch.optim.Adam(p, lr=lr))
        return opts[-1]

    def callback(i, loss):
        seen.append(opts[0].param_groups[0]["params"][0].detach().clone())

    res, idle, t = _fit_counted(ps, target, params=("mat_diffuse",),
                                steps=steps, optimizer=adam, seed=seed,
                                callback=callback, **FIT_CFG)
    assert idle
    assert t["fit.loss_event"] == {"count": steps}
    assert t["prb.id_check"] == {"count": 1}
    step = prb.make_fused_train_step(ps.scene, ps.camera, target,
                                     dynamic_params=True, **FIT_CFG)
    theta = ps.scene.mat_diffuse.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=lr)
    seeds = torch.Generator()
    seeds.manual_seed(seed)
    losses, after = [], []
    for _ in range(steps):
        s = int(torch.randint(0, 2**31 - 1, (1,), generator=seeds))
        loss, g = step({"mat_diffuse": theta.detach()}, s)
        opt.zero_grad(set_to_none=True)
        theta.grad = g["mat_diffuse"]
        opt.step()
        with torch.no_grad():
            theta.clamp_(0.0, 1.0)
        losses.append(float(loss))
        after.append(theta.detach().clone())
    assert res.losses == losses
    assert len(seen) == steps
    assert all(torch.equal(a, b) for a, b in zip(seen, after))
    assert torch.equal(res.params["mat_diffuse"], after[-1])


@pytest.mark.gpu
def test_fit_over_the_tree_reads_each_loss_from_its_copy(
        tmp_path, cuda_device, monkeypatch):
    """Past the fused gate a mat_emissive fit takes kernels 9a/9b: one
    loss event a step, one id check a job, the stream idle at return."""
    from orion_tpu_torch.ops import bvh_prb

    ps, target = _fit_problem(tmp_path, cuda_device)
    monkeypatch.setattr(prb, "fused_train_supported", lambda *a: False)
    made = []
    real = bvh_prb.make_bvh_train_step
    monkeypatch.setattr(bvh_prb, "make_bvh_train_step",
                        lambda *a, **k: made.append(1) or real(*a, **k))
    res, idle, t = _fit_counted(
        ps, target, params=("mat_emissive",), steps=3, seed=4,
        optimizer=lambda p: torch.optim.SGD(p, lr=1.0), **FIT_CFG)
    assert made == [1] and idle
    assert t["fit.loss_event"] == {"count": 3}
    assert t["prb.id_check"] == {"count": 1}
    assert all(np.isfinite(res.losses))


@pytest.mark.gpu
def test_whitted_fit_reads_each_loss_by_float(tmp_path, cuda_device):
    """The Whitted closed form gives no early reading: no loss event, and
    fit still returns with the stream idle."""
    ps, target = _fit_problem(tmp_path, cuda_device, whitted=True)
    res, idle, t = _fit_counted(ps, target, params=("mat_diffuse",),
                                steps=2, samples=1, max_depth=2,
                                use_prb=True)
    assert idle and t["fit.step"]["n"] == 2
    assert "fit.loss_event" not in t and "prb.id_check" not in t
    assert all(np.isfinite(res.losses))


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["table", "emitter"])
def test_replays_check_material_ids_on_the_card(tmp_path, cuda_device,
                                                where):
    """prb_replay and bvh_prb_replay called directly check each call's
    table and emitter, and a plan its own when it is made: an id past the
    accumulator raises."""
    sc, cam = _scene(tmp_path, cuda_device, "cornell")
    base, clo, chi, em, cam_v = fp.fused_args(sc, cam)
    nodes, _, update = bvp.make_bvh_tab_updater(sc)
    tab = update()
    if where == "table":
        base[0, fp._C_MESH] = prb.M_LANES
        tab[0, fp._C_MESH] = prb.M_LANES
    else:
        em[0, 0] = prb.M_LANES
    n = 32 * 24
    w = torch.zeros((n, 3), device=cuda_device)
    ls = torch.zeros((n, 3), device=cuda_device)
    with pytest.raises(ValueError, match="accumulator columns"):
        prb.prb_replay(base, clo, chi, em, cam_v, 0, w, ls, 32, 24, 1, 1, 1)
    with pytest.raises(ValueError, match="accumulator columns"):
        bvp.bvh_prb_replay(nodes, tab, em, cam_v, 0, w, ls, 32, 24, 1, 1, 1,
                           leaf_width=bp.GPU_LEAF_WIDTH)
    with pytest.raises(ValueError, match="accumulator columns"):
        prb.PRBPlan(scene=sc, base=base, clo=clo, chi=chi, em=em, cam=cam_v,
                    W=32, H=24, samples=1, max_depth=1, light_samples=1)
