"""Port path megakernel (ops/fused_path.py) against the JAX package.

The plain version runs the TPU kernel's estimator with the same PCG4D
stream, so given the same int32 seed it must reproduce the JAX kernel
(run in Pallas interpret mode) image for image: at most 1% of pixels may
differ by more than 1e-5 + 1e-4*|ref| (float32 op order in the normal and
trig math can flip a Russian-roulette or edge decision on a rare path), and
the image means agree to rel 1e-4. Hashes and host tables are bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.ops import pallas_fused as jf
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu.scene import subdivide_scene as jsubdivide
from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.ops import fused_path as fp

from chip_smoke import write_cornell
from torch_port_util import to_torch, write_textured


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    rtc = write_cornell(tmp_path_factory.mktemp("cornell"), xres=16,
                        yres=16, depth=3)
    js, jrtc = jload_scene(rtc)
    return js, jrtc


def _two_emitter_jax(js):
    counts = np.asarray(js.mesh_tri_count)
    em0 = int(np.asarray(js.emissive_mesh_ids)[0])
    m2 = next(m for m in range(js.num_meshes) if m != em0 and counts[m] <= 8)
    ke = np.asarray(js.mat_emissive).copy()
    ke[m2] = (0.5, 0.4, 0.3)
    return dataclasses.replace(
        js, mat_emissive=jnp.asarray(ke),
        emissive_mesh_ids=jnp.asarray(np.array([em0, m2], np.int32)),
        num_emissive=2)


def _variant(js, name):
    if name == "levels-2":
        return jsubdivide(js, levels=2)
    if name == "two-emitter":
        return _two_emitter_jax(js)
    return js


def test_pcg4d_and_u01_bitwise():
    rng = np.random.default_rng(0)
    q = rng.integers(-2**31, 2**31, (4, 100_000), dtype=np.int64)
    q32 = q.astype(np.int32)
    theirs = jf._pcg4d(*(jnp.asarray(x) for x in q32))
    ours = fp._pcg4d(*(torch.as_tensor(x) for x in q))
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.numpy().astype(np.uint32),
                              np.asarray(b).astype(np.uint32))
        assert np.array_equal(fp._u01(a).numpy(), np.asarray(jf._u01(b)))


@pytest.mark.parametrize("name", ["cornell", "levels-2", "two-emitter"])
def test_fused_tables_bitwise(cornell, name):
    js = _variant(cornell[0], name)
    ts = to_torch(js)
    assert np.array_equal(fp.pack_fused_tri_table(ts),
                          jf.pack_fused_tri_table(js))
    for a, b in zip(fp.fused_chunk_bounds(ts), jf.fused_chunk_bounds(js)):
        assert np.array_equal(a, b)
    em = fp.pack_emitters(ts)
    for i, c in enumerate(jf._emitters_consts(js)):
        mesh, count, v0, e1, e2, weight, n0, n1, n2, ke = c
        assert em[i, 0] == mesh and em[i, 1] == count
        assert np.array_equal(em[i, 2:5], np.asarray(ke, np.float32))
        tri = em[i, fp.EM_HEADER:fp.EM_HEADER + count * fp.EM_TRI]
        tri = tri.reshape(count, fp.EM_TRI)
        for cols, ref in ((slice(0, 3), v0), (slice(3, 6), e1),
                          (slice(6, 9), e2), (9, weight), (slice(10, 13), n0),
                          (slice(13, 16), n1), (slice(16, 19), n2)):
            assert np.array_equal(tri[:, cols], np.asarray(ref, np.float32))


def test_gate_agrees(cornell, tmp_path):
    js = cornell[0]
    cases = {"cornell": js, "levels-2": jsubdivide(js, levels=2),
             "two-emitter": _two_emitter_jax(js)}
    js_tex, _ = jload_scene(write_textured(tmp_path))
    cases["textured"] = js_tex
    # an emissive mesh of 32 triangles (> FUSED_MAX_EMITTER_TRIS)
    cases["big-emitter"] = jsubdivide(js, levels=2, skip_emissive=False)
    verdicts = {}
    for name, sc in cases.items():
        verdicts[name] = fp.fused_path_supported(to_torch(sc))
        assert verdicts[name] == jf.fused_path_supported(sc), name
    assert verdicts == {"cornell": True, "levels-2": True,
                        "two-emitter": True, "textured": False,
                        "big-emitter": False}
    assert fp._fused_t_pad(34 * 4**5 + 2) > fp.FUSED_MAX_TRIS


@pytest.mark.parametrize("name", ["cornell", "levels-2", "two-emitter"])
def test_plain_matches_jax_kernel(cornell, name):
    js, jrtc = cornell
    js = _variant(js, name)
    if name == "levels-2":
        assert jf._fused_t_pad(js.num_triangles) > jf.FUSED_CHUNK
    key = jax.random.key(5)
    cfg = dict(samples=2, max_depth=3, light_samples=2)
    theirs = np.asarray(jf.make_fused_path_renderer(
        js, jcamera_from_rtc(jrtc), ray_block=128, interpret=True,
        **cfg)(key))
    seed = int(jf.seed_scalar(key)[0])
    ours = fp.make_fused_path_renderer(to_torch(js), camera_from_rtc(jrtc, device="cpu"),
                                       **cfg)(seed).numpy()
    assert ours.shape == theirs.shape == (16, 16, 3)
    assert np.isfinite(ours).all() and theirs.mean() > 0
    off = np.abs(ours - theirs) > 1e-5 + 1e-4 * np.abs(theirs)
    assert off.any(axis=-1).mean() <= 0.01
    assert ours.mean() == pytest.approx(theirs.mean(), rel=1e-4)


@pytest.mark.parametrize("name", ["cornell", "levels-2"])
def test_plain_counts_real_triangle_tests(cornell, name):
    # one sample at depth 0 with one light sample: every lane's primary
    # sweep plus at most one shadow sweep, each over the real rows only
    js, jrtc = cornell
    ts = to_torch(_variant(js, name))
    T = ts.num_triangles
    assert fp._fused_t_pad(T) > T
    lo, hi = fp.fused_chunk_bounds(ts)
    args = (torch.as_tensor(fp.pack_fused_tri_table(ts)),
            torch.as_tensor(lo), torch.as_tensor(hi),
            torch.as_tensor(fp.pack_emitters(ts)),
            fp.camera_vec(camera_from_rtc(jrtc, device="cpu")))
    stats = {}
    fp.fused_path_plain(*args, 3, 16, 16, 1, 0, 1, stats=stats)
    n = 16 * 16
    assert stats["tests"] % T == 0
    assert n * T < stats["tests"] <= 2 * n * T


def test_renderer_seed_and_gate(cornell, tmp_path):
    js, jrtc = cornell
    ts, cam = to_torch(js), camera_from_rtc(jrtc, device="cpu")
    fn = fp.make_fused_path_renderer(ts, cam, samples=1, max_depth=2,
                                     light_samples=1)
    a, b, c = fn(7), fn(7), fn(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    js_tex, _ = jload_scene(write_textured(tmp_path))
    with pytest.raises(ValueError):
        fp.make_fused_path_renderer(to_torch(js_tex), cam, samples=1,
                                    max_depth=1)
