"""Sample-parallel rendering: render(sample_offset=) and
parallel/distributed.render_multihost, on the CPU.

- render(samples=m, sample_offset=k) is the samples k .. k + m - 1 of
  render(samples=k + m) from the same generator state: m times its image
  plus k times render(k)'s equals (k + m) times render(k + m)'s within
  1e-6 of the largest entry (the same samples, summed in another order),
  and it is the continuation of render(k) on one generator bit for bit.
  The skipped draws depend on no data: after skipping k samples the
  generator's state is the one rendering them leaves, on scenes that hit
  everywhere and nowhere.
- render_multihost on 2 gloo ranks (tests/torch_dist_worker.py, one
  spawn): each rank's image is render(S)'s within 1e-6 relative, both
  ranks' images are equal bit for bit, one all-gather a render, a rank
  without samples contributes zeros; a world of one is render itself.
  Against the JAX package (whose render_multihost needs several JAX
  processes) the 16-sample image is held statistically to JAX's render
  (correlation > 0.93, means within rel 0.15, as tests/test_torch_render.py
  holds two estimators of one image).
"""

import jax
import numpy as np
import pytest
import torch

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.render import render as jrender
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch.engine import prepare
from orion_tpu_torch.parallel.distributed import render_multihost
from orion_tpu_torch.render import render, skip_samples

import torch_dist_worker as dw
from torch_port_util import to_torch  # noqa: F401  (one thread a worker)

COUNTS = [5, 1]


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    return tmp, dw.write_scenes(tmp)


@pytest.fixture(scope="module")
def world2(scenes):
    tmp, sc = scenes
    return dw.spawn_world("multihost", 2, tmp, scenes=sc, counts=COUNTS)


@pytest.fixture(scope="module")
def preps(scenes):
    _, sc = scenes
    return {k: prepare(sc[k], device="cpu") for k in ("cornell", "whitted")}


@pytest.mark.parametrize("case", ["path", "whitted", "jitter"])
@pytest.mark.parametrize("k,m", [(3, 2), (1, 4), (0, 2)])
def test_sample_offset_is_additive(preps, case, k, m):
    ps = preps["whitted" if case == "whitted" else "cornell"]
    cfg = dict(max_depth=3, light_samples=2,
               shared_jitter=case != "jitter")
    with torch.no_grad():
        part = render(ps.scene, ps.camera, _gen(1), samples=m,
                      sample_offset=k, **cfg)
        head = (render(ps.scene, ps.camera, _gen(1), samples=k, **cfg)
                if k else torch.zeros_like(part))
        whole = render(ps.scene, ps.camera, _gen(1), samples=k + m, **cfg)
        g = _gen(1)
        if k:
            render(ps.scene, ps.camera, g, samples=k, **cfg)
        cont = render(ps.scene, ps.camera, g, samples=m, **cfg)
    assert whole.max() > 0
    err = (part * m + head * k - whole * (k + m)).abs().max()
    assert float(err) <= 1e-6 * float((whole * (k + m)).abs().max())
    assert torch.equal(part, cont)


@pytest.mark.parametrize("aim", ["box", "away"])
def test_skipped_draws_depend_on_no_data(preps, aim):
    """Rays that hit the box everywhere, or leave it at once (the camera
    turned round): skip_samples leaves the generator as rendering does."""
    ps = preps["cornell"]
    cam = ps.camera
    if aim == "away":
        import dataclasses
        cam = dataclasses.replace(cam, front=-cam.front, right=-cam.right)
        cam = dataclasses.replace(cam, origin=cam.origin - 20 * ps.camera.front)
    a, b = _gen(2), _gen(2)
    with torch.no_grad():
        img = render(ps.scene, cam, a, samples=3, max_depth=4,
                     light_samples=2)
    skip_samples(ps.scene, b, 3, cam.yres, cam.xres, torch.device("cpu"),
                 max_depth=4, light_samples=2, mode=None)
    assert torch.equal(a.get_state(), b.get_state())
    assert (img.max() > 0) == (aim == "box")


def test_sample_offset_rejects_folded_samples(preps):
    ps = preps["cornell"]
    with pytest.raises(ValueError, match="fold_samples"):
        render(ps.scene, ps.camera, _gen(0), samples=2, sample_offset=1,
               fold_samples=True)
    with pytest.raises(ValueError, match="sample_offset"):
        render(ps.scene, ps.camera, _gen(0), samples=2, sample_offset=-1)


@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("mode", ["path", "whitted"])
def test_render_multihost_two_ranks(world2, preps, n, mode):
    ps = preps["cornell" if mode == "path" else "whitted"]
    with torch.no_grad():
        if mode == "path":
            ref = render(ps.scene, ps.camera, _gen(3), samples=n,
                         max_depth=3, light_samples=2, intersect=ps.intersect)
        else:
            ref = render(ps.scene, ps.camera, _gen(4), samples=n,
                         max_depth=2, intersect=ps.intersect)
    ref = ref.numpy()
    assert ref.max() > 0
    a, b = (r[f"{mode}_{n}"] for r in world2)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - ref).max() <= 1e-6 * np.abs(ref).max()
    for r in world2:
        if mode == "path":       # one all-gather of the two [H*W*3] parts
            assert r[f"gathers_{n}"].tolist() == [1, 2 * dw.H * dw.W * 3 * 4]


def test_render_multihost_world_of_one(preps):
    ps = preps["cornell"]
    cfg = dict(samples=3, max_depth=3, light_samples=2,
               intersect=ps.intersect)
    with torch.no_grad():
        assert torch.equal(render_multihost(ps.scene, ps.camera, _gen(3),
                                            **cfg),
                           render(ps.scene, ps.camera, _gen(3), **cfg))


def test_render_multihost_matches_jax_statistically(world2, scenes):
    _, sc = scenes
    js, jrtc = jload_scene(sc["stats"])
    theirs = np.asarray(jrender(js, jcamera_from_rtc(jrtc),
                                jax.random.key(1), samples=16, max_depth=4,
                                light_samples=2, mode="path"))
    ours = world2[0]["stats"]
    assert ours.shape == theirs.shape and np.isfinite(ours).all()
    corr = float((ours * theirs).sum() / (np.linalg.norm(ours)
                                          * np.linalg.norm(theirs)))
    assert corr > 0.93, corr
    assert ours.mean() == pytest.approx(theirs.mean(), rel=0.15)
