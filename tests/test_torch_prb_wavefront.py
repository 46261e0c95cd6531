"""The port's binned wavefront trainer (orion_tpu_torch/ops/prb_wavefront.py)
against orion_tpu.ops.prb_wavefront.make_binned_train_step, on the CPU:
the port on the binned sweep's plain version, JAX in interpret mode, both
on JAX's tree (bvh_from_numpy) with the same PCG seed.

Tolerances: the loss to rel 1e-5; the gradients to rtol 3e-4 with atol
3e-4 x the largest entry, as tests/test_torch_bounce_prb.py holds the
bounce trainer (the same float32 per-lane terms summed in another order:
float32 scatter-adds in JAX, float64 here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.ops import pallas_binned as jbn
from orion_tpu.ops import pallas_fused as jf
from orion_tpu.ops import prb_wavefront as jpw
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch.accel.bvh import bvh_from_numpy
from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.ops import prb_wavefront as pw

from cornell_scenes import two_emitter, write_cornell
from torch_port_util import jax_bvh_fields, to_torch


def _seed(k):
    key = jax.random.key(k)
    return key, int(jf.seed_scalar(key)[0])


def _scene(tmp, res, levels):
    rtc = write_cornell(tmp, xres=res, yres=res, depth=2, levels=levels)
    js, jrtc = jload_scene(rtc)
    bvh = bvh_from_numpy(jax_bvh_fields(jbn.binned_device_data(js)[2]))
    return js, jcamera_from_rtc(jrtc), to_torch(js), \
        camera_from_rtc(jrtc, device="cpu"), bvh


def _target(res, seed):
    return np.random.default_rng(seed).uniform(
        0.0, 0.3, (res, res, 3)).astype(np.float32)


def _close(loss, g, j_loss, j_g):
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    for k in j_g:
        ref = np.asarray(j_g[k])
        scale = np.abs(ref).max()
        assert scale > 0, k
        np.testing.assert_allclose(g[k].numpy(), ref, rtol=3e-4,
                                   atol=3e-4 * scale, err_msg=k)


@pytest.mark.parametrize("levels,res,depth", [(0, 16, 2), (3, 8, 2),
                                              (0, 8, 3)])
def test_grads_match_jax(tmp_path, levels, res, depth):
    """Loss and both material gradients equal JAX's binned trainer."""
    js, jcam, ts, cam, bvh = _scene(tmp_path, res, levels)
    key, seed = _seed(5 + levels)
    target = _target(res, 1)
    j_loss, j_g = jpw.make_binned_train_step(
        js, jcam, jnp.asarray(target), samples=2, max_depth=depth,
        interpret=True)(key)
    step = pw.make_binned_train_step(ts, cam, target, samples=2,
                                     max_depth=depth, bvh=bvh)
    loss, g = step(seed)
    _close(loss, g, j_loss, j_g)
    c = step.sweep.counts
    assert c["rounds"] >= c["sweeps"] > 0 and int(c["tests"]) > 0


def test_dynamic_params_match_jax(tmp_path):
    """step(params, seed) rebuilds the table's material columns: JAX's
    gradients at perturbed albedo and emission, both tables live."""
    js, jcam, ts, cam, bvh = _scene(tmp_path, 8, 0)
    key, seed = _seed(2)
    target = _target(8, 3)
    kd = np.asarray(js.mat_diffuse) * 0.8
    ke = np.asarray(js.mat_emissive) * 1.1
    j_loss, j_g = jpw.make_binned_train_step(
        js, jcam, jnp.asarray(target), samples=2, max_depth=2,
        interpret=True, dynamic_params=True)(
            {"mat_diffuse": jnp.asarray(kd), "mat_emissive": jnp.asarray(ke)},
            key)
    step = pw.make_binned_train_step(ts, cam, target, samples=2, max_depth=2,
                                     dynamic_params=True, bvh=bvh)
    loss, g = step({"mat_diffuse": torch.as_tensor(kd),
                    "mat_emissive": torch.as_tensor(ke)}, seed)
    _close(loss, g, j_loss, j_g)
    # the perturbation is really read
    l0, _ = step({"mat_diffuse": ts.mat_diffuse}, seed)
    assert float(l0) != float(loss)
    with pytest.raises(ValueError, match="material tables"):
        step({"tri_v0": ts.tri_v0}, seed)


def test_gate(tmp_path):
    """Outside the wavefront-train gate (two emitters) the trainer raises,
    as JAX's does."""
    _, _, ts, cam, _ = _scene(tmp_path, 8, 0)
    assert pw.wavefront_train_supported(ts)
    with pytest.raises(ValueError, match="gate"):
        pw.make_binned_train_step(two_emitter(ts), cam, _target(8, 0),
                                  samples=1, max_depth=1)
    # a textured scene is outside the gate too
    tex = dataclasses.replace(ts, mat_map_diffuse=torch.zeros_like(
        ts.mat_map_diffuse))
    assert not pw.wavefront_train_supported(tex)
