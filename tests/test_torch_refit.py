"""The port's BVH refit (accel/refit.py) and the geometry-fit route over
it (optim.make_refit_loss, fit's refit branch), on the CPU.

Oracles: at the build vertices the refit equals the built tree's device
layout bit for bit (ops/bvh_intersect._bvh_device_layout); on the
identical tree its node boxes equal the JAX package's RefitPlan exactly;
the refit loss at the build vertices equals the wavefront loss over the
backend's own walk; its vertex gradient agrees with central differences
of the same loss (the refit inside every evaluation) on the three largest
coordinates to the JAX test's 12% (tests/test_refit.py:84-116: a finite
difference of a loss whose hits jump is a noisy oracle).
"""

import numpy as np
import pytest
import torch

from orion_tpu.accel.bvh import build_bvh as jbuild_bvh
from orion_tpu.accel.refit import RefitPlan as JRefitPlan
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch import optim
from orion_tpu_torch.accel.bvh import bvh_from_numpy, build_scene_bvh
from orion_tpu_torch.accel.refit import RefitPlan
from orion_tpu_torch.engine import prepare
from orion_tpu_torch.ops import bvh_intersect as bx
from orion_tpu_torch.scene import load_scene

from cornell_scenes import write_cornell
from torch_port_util import jax_bvh_fields


@pytest.fixture(scope="module")
def lv2(tmp_path_factory):
    return write_cornell(tmp_path_factory.mktemp("lv2"), xres=8, yres=8,
                         depth=1, levels=2)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("leaf", [2, 16, 128])
def test_refit_at_build_vertices_equals_device_layout(lv2, leaf):
    sc, _ = load_scene(lv2, device="cpu")
    bvh, _ = build_scene_bvh(sc, leaf_size=leaf)
    nodes, tri = RefitPlan(bvh).refit(sc.tri_v0, sc.tri_e1, sc.tri_e2)
    ref_nodes, ref_tri = bx._bvh_device_layout(bvh, "cpu")
    assert torch.equal(_bits(nodes), _bits(ref_nodes))
    assert torch.equal(_bits(tri), _bits(ref_tri))


def test_refit_boxes_equal_jax_and_track_a_moved_vertex(lv2):
    js, _ = jload_scene(lv2)
    jb, _ = jbuild_bvh(np.asarray(js.tri_v0), np.asarray(js.tri_e1),
                       np.asarray(js.tri_e2), np.asarray(js.tri_valid),
                       leaf_size=128, leaf_width=128)
    bvh = bvh_from_numpy(jax_bvh_fields(jb))
    v0 = np.asarray(js.tri_v0).copy()
    v0[0] += np.array([0.0, 5.0, 0.0], np.float32)
    v0[7] -= np.array([0.3, 0.0, 0.2], np.float32)
    e1, e2 = np.asarray(js.tri_e1), np.asarray(js.tri_e2)
    ns, td = JRefitPlan(jb).refit(v0, e1, e2)
    nodes, tri = RefitPlan(bvh).refit(v0, e1, e2)
    lo = np.stack([np.asarray(ns[i]) for i in range(3)], axis=1)
    hi = np.stack([np.asarray(ns[3 + i]) for i in range(3)], axis=1)
    assert np.array_equal(nodes[:, 0:3].numpy(), lo)
    assert np.array_equal(nodes[:, 3:6].numpy(), hi)
    assert np.array_equal(tri.numpy()[:, :13],
                          np.asarray(td).T[:tri.shape[0], :13])
    # the root bounds the moved vertex and has grown
    assert float(nodes[0, 4]) >= v0[0, 1] > float(bvh.node_hi[0, 1])


def _refit_ps(rtc):
    ps = prepare(rtc, device="cpu", force_backend="bvh")
    assert ps.backend == "bvh-torch" and ps.bvh is not None
    return ps


def _gen(seed=3):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_refit_loss_equals_the_backend_wavefront_loss(lv2):
    ps = _refit_ps(lv2)
    target = torch.zeros((8, 8, 3))
    cfg = dict(samples=1, max_depth=1, light_samples=1, mode="path")
    loss, plan = optim.make_refit_loss(ps, **cfg)
    sc = ps.scene
    nodes, tri = plan.refit(sc.tri_v0, sc.tri_e1, sc.tri_e2)
    ours = loss({"tri_v0": sc.tri_v0}, _gen(), target, nodes, tri)
    ref = optim.make_loss(sc, ps.camera, intersect=ps.intersect,
                          **cfg)({"tri_v0": sc.tri_v0}, _gen(), target)
    assert float(ours) == pytest.approx(float(ref), rel=1e-6)
    assert float(ours) > 0


def test_refit_loss_vertex_gradient_matches_finite_differences(lv2):
    ps = _refit_ps(lv2)
    sc = ps.scene
    target = torch.zeros((8, 8, 3))
    loss, plan = optim.make_refit_loss(ps, samples=1, max_depth=1,
                                       light_samples=1, mode="path")

    def full(v0):
        nodes, tri = plan.refit(v0, sc.tri_e1, sc.tri_e2)
        return float(loss({"tri_v0": v0}, _gen(), target, nodes, tri))

    v0 = sc.tri_v0.clone().requires_grad_(True)
    nodes, tri = plan.refit(sc.tri_v0, sc.tri_e1, sc.tri_e2)
    (g,) = torch.autograd.grad(loss({"tri_v0": v0}, _gen(), target, nodes,
                                    tri), [v0])
    assert torch.isfinite(g).all() and g.abs().max() > 0
    eps = 3e-3
    for idx in torch.argsort(g.abs().flatten())[-3:].tolist():
        t, c = divmod(idx, 3)
        vp, vm = sc.tri_v0.clone(), sc.tri_v0.clone()
        vp[t, c] += eps
        vm[t, c] -= eps
        fd = (full(vp) - full(vm)) / (2 * eps)
        gi = float(g[t, c])
        assert abs(fd - gi) <= 0.12 * max(abs(fd), abs(gi)), (t, c, fd, gi)


def test_fit_refits_the_tree_every_step(lv2, monkeypatch):
    ps = _refit_ps(lv2)
    calls = []
    real = RefitPlan.refit

    def spy(self, *a, **k):
        calls.append(k.get("device"))
        return real(self, *a, **k)

    monkeypatch.setattr(RefitPlan, "refit", spy)
    target = torch.full((8, 8, 3), 0.05)
    res = optim.fit(ps, target, params=("tri_v0",), steps=3, samples=1,
                    max_depth=1, light_samples=1, learning_rate=1e-2, seed=1)
    assert len(calls) == 3 and np.isfinite(res.losses).all()
    moved = res.params["tri_v0"] - ps.scene.tri_v0
    assert torch.isfinite(moved).all() and moved.abs().max() > 0
    # the closed-form trainers are not asked: geometry refits first
    res = optim.fit(ps, target, params=("tri_v0", "mat_diffuse"), steps=1,
                    samples=1, max_depth=1, light_samples=1, seed=1)
    assert len(calls) == 4 and res.params["mat_diffuse"].shape == \
        ps.scene.mat_diffuse.shape
    with pytest.raises(ValueError, match="refittable"):
        optim.make_refit_loss(prepare(lv2, device="cpu"), samples=1,
                              max_depth=1, light_samples=1, mode=None)
