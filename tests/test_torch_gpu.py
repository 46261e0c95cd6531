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
GRAD_TOL.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (random_rays, two_emitter, write_cornell,
                        write_cornell_whitted)
from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.ops import brute_intersect as bi
from orion_tpu_torch.ops import fused_path as fp
from orion_tpu_torch.ops import prb
from orion_tpu_torch.ops import whitted as wh
from orion_tpu_torch.scene import load_scene, subdivide_scene

from torch_port_util import cuda_device  # noqa: F401  (fixture)


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
