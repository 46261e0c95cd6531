"""CUDA kernels of the port against their plain PyTorch versions, on the GPU.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: the brute sweep is written without FMA contraction and must
equal its plain version bit for bit; the fused kernel contracts FMAs and
rounds sqrt/sin/cos differently from the plain version's op-by-op float32
order, so at most 1% of pixels may differ by more than 1e-4 + 1e-3*|ref|
and the image means agree to rel 1e-3.
"""

import numpy as np
import pytest
import torch

from chip_smoke import random_rays, two_emitter, write_cornell
from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.ops import brute_intersect as bi
from orion_tpu_torch.ops import fused_path as fp
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
    lo, hi = fp.fused_chunk_bounds(sc)
    args = (torch.as_tensor(fp.pack_fused_tri_table(sc), device=cuda_device),
            torch.as_tensor(lo, device=cuda_device),
            torch.as_tensor(hi, device=cuda_device),
            torch.as_tensor(fp.pack_emitters(sc), device=cuda_device),
            fp.camera_vec(cam))
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


@pytest.mark.gpu
def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    o, d, alive = random_rays(64, 1, cuda_device)
    tab = torch.zeros((8, 16), device=cuda_device)
    with pytest.raises(ValueError):
        bi.brute_sweep(tab, o.double(), d, alive)
    with pytest.raises(ValueError):
        bi.brute_sweep(tab[:, :13], o, d, alive)
