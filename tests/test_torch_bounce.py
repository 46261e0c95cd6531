"""The port's sorted-wavefront bounce pipeline (orion_tpu_torch/ops/bounce.py)
against orion_tpu.ops.pallas_bounce, on the CPU: the port on its plain
versions, JAX in interpret mode, both on the identical tree, table and PCG
seed.

Tolerances. The two packages run the same float32 estimator in a different
op order: images and states agree to rtol 1e-5, atol 1e-6 (the JAX
package's own bound against its replica); walk winners (rows, hit masks,
visibility planes) are equal and t agrees to rel 1e-6; sort keys are equal
integer for integer. Within the port, a render is bitwise the same whatever
the sort, the tiling or the visibility split does, and a constant texel
equals the solid colour bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.ops import pallas_bounce as jb
from orion_tpu.ops import pallas_fused as jf
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu_torch import cli
from orion_tpu_torch.accel.bvh import bvh_from_numpy
from orion_tpu_torch.camera import camera_from_rtc
from orion_tpu_torch.engine import make_big_path_renderer
from orion_tpu_torch.io.image import load_hdr
from orion_tpu_torch.ops import bounce as bo
from orion_tpu_torch.ops import bvh_path as bp
from orion_tpu_torch.ops import reorder
from orion_tpu_torch.scene import load_scene

from cornell_scenes import write_cornell
from torch_port_util import jax_bvh_fields, to_torch, write_textured

S, D, LS = 2, 3, 2
RB = 128          # the JAX calls' ray block (n_pad == N at these sizes)


def _seed(k):
    key = jax.random.key(k)
    return key, int(jf.seed_scalar(key)[0])


class Both:
    """One inline scene in both packages, with the JAX pipeline built once
    per configuration."""

    def __init__(self, tmp, res, levels):
        self.rtc = write_cornell(tmp, xres=res, yres=res, depth=D,
                                 levels=levels)
        self.js, self.jrtc = jload_scene(self.rtc)
        self.jcam = jcamera_from_rtc(self.jrtc)
        self.ts = to_torch(self.js)
        self.cam = camera_from_rtc(self.jrtc, device="cpu")
        self.res = res
        self._jax = {}

    def jax_pipeline(self, **kw):
        """(jitted pipeline, ctx) of the JAX package, interpret mode."""
        name = tuple(sorted(kw.items()))
        if name not in self._jax:
            pipe, ctx = jb.build_forward_pipeline(
                self.js, self.jcam, samples=S, max_depth=D, light_samples=LS,
                ray_block=RB, interpret=True, **kw)
            self._jax[name] = (jax.jit(pipe), ctx)
        return self._jax[name]

    def port(self, jctx=None, scene=None, **kw):
        """The port's renderer; on the JAX pipeline's own tree if given."""
        if jctx is not None:
            kw["bvh"] = bvh_from_numpy(jax_bvh_fields(jctx["bvh"]))
        return bo.make_bounce_path_renderer(
            self.ts if scene is None else scene, self.cam, samples=S,
            max_depth=D, light_samples=LS, **kw)


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    return Both(tmp_path_factory.mktemp("cornell"), 16, 0)


@pytest.fixture(scope="module")
def lv2(tmp_path_factory):
    return Both(tmp_path_factory.mktemp("lv2"), 8, 2)


def _jax_image(st, n_pix, res):
    img = np.zeros((n_pix, 3), np.float32)
    np.add.at(img, st[14].astype(np.int64), st[10:13].T)
    return img.reshape(res, res, 3) / np.float32(S)


def _by_lane(st, pix_count):
    lane = st[15].astype(np.int64) * pix_count + st[14].astype(np.int64)
    assert len(np.unique(lane)) == st.shape[1]
    return st[:, np.argsort(lane)]


# ---------------------------------------------------------------------------
# the three walks and the kernels' plain versions, call by call
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def recorded(lv2):
    """The levels-2 pipeline's state before each bounce's shade step (the
    port, sorted, on the JAX tree: 8 octant copies, leaf width 128), with
    the JAX package's device data of the same tree."""
    _, jctx = lv2.jax_pipeline()
    fn = lv2.port(jctx)
    rec = []
    fn(_seed(5)[1], record=lambda depth, n, st, hd, kd, vis: rec.append(
        (depth, n, st.clone(), hd.clone())))
    assert [r[0] for r in rec] == list(range(D + 1))
    assert rec[0][1] == fn.ctx["N"] and rec[-1][1] < rec[0][1]
    return fn, jctx, rec


def _jax_state(st, n):
    """The first n lanes as a JAX [16, n_pad] state (padding lanes dead)."""
    n_pad = -(-n // RB) * RB
    out = np.zeros((16, n_pad), np.float32)
    out[:, :n] = st[:, :n].numpy()
    return jnp.asarray(out), n_pad


def test_walk_matches_jax_lean(recorded):
    fn, jctx, rec = recorded
    data = fn.ctx["data"]
    assert data.copies == 8 and data.leaf_width == 128
    for depth, n, st, hd in rec:
        jst, n_pad = _jax_state(st, n)
        call = jb.build_walk_call(jctx["num_nodes"], n_pad, RB, True,
                                  octant_copies=8, leaf_width=128)
        theirs = np.asarray(call(*jctx["node_scalars"], jst,
                                 jctx["tab"]))[:, :n]
        ours = bo.bounce_walk_plain(data, st, n).numpy()
        assert torch.equal(torch.as_tensor(ours), hd)      # the wrapper's
        assert np.array_equal(ours[4], theirs[4]), depth   # hit masks
        assert np.array_equal(ours[3], theirs[3]), depth   # winner rows
        np.testing.assert_allclose(ours[0], theirs[0], rtol=1e-6)
        np.testing.assert_allclose(ours[1:3], theirs[1:3], atol=2e-6)
        assert not ours[5:].any()


def test_vis_matches_jax_shadow_em2(recorded, lv2):
    fn, jctx, rec = recorded
    data = fn.ctx["data"]
    key, seed = _seed(5)
    emitter = jf._emitters_consts(lv2.js)
    for depth, n, st, hd in rec:
        jst, n_pad = _jax_state(st, n)
        jhd = np.zeros((8, n_pad), np.float32)
        jhd[0] = 3.0e38
        jhd[:, :n] = hd.numpy()
        rows = np.clip(jhd[3].astype(np.int64), 0, jctx["tab"].shape[1] - 1)
        attrs = jnp.asarray(np.asarray(jctx["tab"])[:, rows])
        call = jb.build_vis_call(jctx["num_nodes"], LS, emitter, n_pad, RB,
                                 True, octant_copies=8, leaf_width=128)
        theirs = np.asarray(call(
            jf.seed_scalar(key), jnp.asarray([depth], jnp.int32),
            *jctx["node_scalars"], jst, jnp.asarray(jhd), attrs,
            jctx["tab"]))[:, :n]
        ours = bo.bounce_vis(data, st, hd, seed, depth).numpy()
        assert np.array_equal(ours, theirs), depth
        if depth == 0:
            assert 0 < ours[:2].sum() < 2 * n


@pytest.mark.parametrize("light_samples", [1, 2, 3])
def test_shade_matches_jax_shade_call(recorded, lv2, light_samples):
    """One shade call on the recorded state: 2 light samples go through
    the dual walk (shadow_em2), 1 and 3 through the single walk
    (shadow_em)."""
    fn, jctx, rec = recorded
    data = fn.ctx["data"]
    key, seed = _seed(5)
    emitter = jf._emitters_consts(lv2.js)
    s_lo, s_hi = jb._scene_bounds_np(lv2.js)
    for depth, n, st, hd in rec[:3]:
        jst, n_pad = _jax_state(st, n)
        jhd = np.zeros((8, n_pad), np.float32)
        jhd[0] = 3.0e38
        jhd[:, :n] = hd.numpy()
        rows = np.clip(jhd[3].astype(np.int64), 0, jctx["tab"].shape[1] - 1)
        attrs = jnp.asarray(np.asarray(jctx["tab"])[:, rows])
        call = jb.build_shade_call(jctx["num_nodes"], D, light_samples,
                                   emitter, s_lo, s_hi, n_pad, RB, True,
                                   with_aux=True, octant_copies=8,
                                   leaf_width=128)
        j_st, j_aux = call(jf.seed_scalar(key),
                           jnp.asarray([depth], jnp.int32),
                           *jctx["node_scalars"], jst, jnp.asarray(jhd), attrs,
                           jnp.zeros((16, n_pad), jnp.float32), jctx["tab"])
        new, aux = bo.bounce_shade_plain(data, st, hd, seed, depth, D,
                                         light_samples, with_aux=True)
        j_st, j_aux = np.asarray(j_st)[:, :n], np.asarray(j_aux)[:, :n]
        assert np.array_equal(new[9].numpy(), j_st[9])        # continue
        assert np.array_equal(new[13:].numpy(), j_st[13:])    # key, riders
        np.testing.assert_allclose(new.numpy(), j_st, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(aux.numpy(), j_aux, rtol=1e-5, atol=1e-6)


def test_key_planes_equal_jax_and_reorder():
    rng = np.random.default_rng(3)
    n = 4096
    lo = np.array([-1.0, 0.0, -1.25], np.float32)
    hi = np.array([1.0, 2.0, 1.0], np.float32)
    # origins inside, on and outside the box; directions of every octant
    o = rng.uniform(-1.5, 2.5, (3, n)).astype(np.float32)
    o[:, :8] = np.stack([lo, hi] * 4, axis=1)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d[:, 8:16] = 0.0
    alive = rng.uniform(size=n) > 0.2
    theirs = np.asarray(jb._coherence_key_planes(
        tuple(jnp.asarray(x) for x in o), tuple(jnp.asarray(x) for x in d),
        jnp.asarray(alive), lo, hi))
    ours = bo.coherence_key_planes(
        tuple(torch.as_tensor(x) for x in o),
        tuple(torch.as_tensor(x) for x in d), torch.as_tensor(alive), lo,
        bo.key_scales(lo, hi)).numpy()
    assert np.array_equal(ours, theirs)
    assert (ours[~alive] == bo.DEAD_KEY).all() and bo.DEAD_KEY == 1 << 21
    assert ours[alive].max() < bo.DEAD_KEY
    # ops/reorder.py's key of the same rays: it divides where this one
    # multiplies, so an origin on a cell face may land next door
    other = reorder.coherence_key(
        torch.as_tensor(o.T.copy()), torch.as_tensor(d.T.copy()),
        torch.as_tensor(alive), torch.as_tensor(lo),
        torch.as_tensor(hi)).numpy()
    assert (other == ours).mean() > 0.99
    assert np.array_equal(other >> 18, ours >> 18)     # dead flag, octant


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene_name,sort", [("cornell", True),
                                             ("cornell", False),
                                             ("lv2", True), ("lv2", False)])
def test_pipeline_matches_jax(request, scene_name, sort):
    both = request.getfixturevalue(scene_name)
    key, seed = _seed(3)
    pipe, jctx = both.jax_pipeline(sort=sort)
    j_st = np.asarray(pipe(jf.seed_scalar(key))[0])
    fn = both.port(jctx, sort=sort)
    assert fn.ctx["data"].copies == 8 and fn.ctx["N"] == jctx["N"]
    st, _ = fn.pipeline(seed)
    ours = fn(seed).numpy()
    n_pix = both.res ** 2
    np.testing.assert_allclose(ours, _jax_image(j_st, n_pix, both.res),
                               rtol=1e-5, atol=1e-6)
    assert ours.mean() > 0.05
    # the final wavefront state, lane for lane
    assert j_st.shape[1] == st.shape[1]
    a, b = _by_lane(st.numpy(), n_pix), _by_lane(j_st, n_pix)
    assert np.array_equal(a[9], b[9]) and np.array_equal(a[13:], b[13:])
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    if sort:
        # the live lanes, were there any, sit in front of the dead ones
        alive = st[9].numpy() > 0
        assert not alive[int(alive.sum()):].any()


@pytest.mark.parametrize("scene_name", ["cornell", "lv2"])
def test_pipeline_matches_reference_renders(request, scene_name):
    both = request.getfixturevalue(scene_name)
    key, seed = _seed(4)
    ours = both.port()(seed)
    ref = bo.bounce_reference_render(both.ts, both.cam, seed, samples=S,
                                     max_depth=D, light_samples=LS)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    theirs = np.asarray(jb.bounce_reference_render(
        both.js, both.jcam, key, samples=S, max_depth=D, light_samples=LS))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5, atol=1e-6)
    # the BVH path kernel's estimator differs only in the light normal's
    # rounding (legacy NEE) and at ties
    k8 = bp.make_bvh_path_renderer(both.ts, both.cam, samples=S, max_depth=D,
                                   light_samples=LS)(seed)
    np.testing.assert_allclose(ours.numpy(), k8.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_sort_layout_and_split_do_not_change_the_image(lv2):
    _, seed = _seed(6)
    base = lv2.port()(seed)
    for kw in (dict(sort=False), dict(sort_every=2),
               dict(leaf_width=2, octant_trees=False),
               dict(leaf_width=8, octant_trees=True)):
        assert torch.equal(lv2.port(**kw)(seed), base), kw
    fused = lv2.port(leaf_width=2, octant_trees=False)
    split = lv2.port(leaf_width=2, octant_trees=False, split_vis=True)
    assert split.ctx["split_vis"] and not fused.ctx["split_vis"]
    np.testing.assert_allclose(split(seed).numpy(), fused(seed).numpy(),
                               rtol=1e-6, atol=1e-7)
    # the split needs one emitter and two light samples; else it is off
    three = bo.make_bounce_path_renderer(lv2.ts, lv2.cam, samples=1,
                                         max_depth=1, light_samples=3,
                                         split_vis=True)
    assert not three.ctx["split_vis"]
    with pytest.raises(ValueError, match="sort_every"):
        lv2.port(sort_every=0)


def test_tiles_equal_the_whole_image(cornell):
    _, seed = _seed(7)
    whole = cornell.port()
    st, _ = whole.pipeline(seed)
    n_pix = cornell.res ** 2
    lanes = bo.lane_radiance(st, n_pix)                  # [3, S, n_pix]
    pc = 96
    pipe, ctx = bo.build_forward_pipeline(
        cornell.ts, cornell.cam, samples=S, max_depth=D, light_samples=LS,
        pix_count=pc)
    assert ctx["N"] == pc * S
    for base in (0, 37, n_pix - pc):
        st_t, _ = pipe(seed, pix_base=base)
        tile = bo.lane_radiance(st_t, pc, base)
        assert torch.equal(tile, lanes[:, :, base:base + pc]), base
        assert torch.equal(bo.state_image(st_t, pc, S, base),
                           whole(seed).reshape(-1, 3)[base:base + pc])


def test_wrappers_check_their_inputs(cornell):
    fn = cornell.port(leaf_width=2, octant_trees=False)
    data, N = fn.ctx["data"], fn.ctx["N"]
    rec = []
    fn(1, record=lambda depth, n, st, hd, kd, vis: rec.append(st.clone()))
    st = rec[0]                                # the primary wavefront
    hd = bo.bounce_walk(data, st, N)
    assert hd.shape == (8, N) and hd[4].sum() > N // 2
    with pytest.raises(ValueError, match="float32"):
        bo.bounce_walk(data, st.double(), N)
    with pytest.raises(ValueError, match="live prefix"):
        bo.bounce_walk(data, st, N + 1)
    with pytest.raises(ValueError, match="contiguous"):
        bo.bounce_walk(data, st.t().contiguous().t(), N)
    with pytest.raises(ValueError, match="hitdata"):
        bo.bounce_shade(data, st, hd[:5], 1, 0, D, LS)
    with pytest.raises(ValueError, match="kd"):
        bo.bounce_shade(data, st, hd, 1, 0, D, LS, kd=torch.zeros(3, N - 1))
    # the given visibility planes hold one row per (emitter, light sample)
    # site: fewer rows than sites are refused
    with pytest.raises(ValueError, match="2 visibility planes for 3 sites"):
        bo.bounce_shade(data, st, hd, 1, 0, D, 3, vis=torch.zeros(2, N))
    with pytest.raises(ValueError, match="copies"):
        bo.bounce_walk(dataclasses.replace(data, copies=3), st, N)
    with pytest.raises(ValueError, match="nodes"):
        bo.bounce_vis(dataclasses.replace(data, nodes=data.nodes[:, :6]), st,
                      hd, 1, 0)
    two = torch.cat([data.em, data.em])
    with pytest.raises(ValueError, match="one emitter"):
        bo.bounce_vis(dataclasses.replace(data, em=two), st, hd, 1, 0)
    # shade works in place on the prefix and leaves the suffix alone
    before = st.clone()
    n = N // 2
    assert bo.bounce_shade(data, st, hd[:, :n].contiguous(), 1, 0, D,
                           LS) is None
    assert torch.equal(st[:, n:], before[:, n:])
    assert not torch.equal(st[:, :n], before[:, :n])
    aux = bo.bounce_shade(data, before, hd, 1, 0, D, LS, with_aux=True)
    assert aux.shape == (16, N) and not aux[15].any()


GATE_CARD = 80 * 10**9       # an 80 GB card's memory, in bytes


@pytest.mark.parametrize("lanes,kw,fits", [
    # the state's int32 indexing: 16 rows of at most 2^27 - 1 lanes
    ((1 << 27) - 1, {}, True),
    (1 << 27, {}, False),
    (3840 * 2160 * 16, {}, True),          # 4K, 16 spp
    (3840 * 2160 * 32, {}, False),         # 4K, 32 spp
    (1920 * 1080 * 65, {}, False),         # 1080p, 65 spp
    # the card's memory: half of 80 GB at LANE_BYTES a render's lane
    (1920 * 1080 * 64, dict(total_bytes=GATE_CARD), True),
    (1920 * 1080 * 16, dict(total_bytes=8 * 10**9), False),
    # a trainer's dumps and adjoints: 1080p 4 spp depth 8 fits, 32 spp not
    (1920 * 1080 * 4, dict(total_bytes=GATE_CARD, with_aux=True,
                           max_depth=8), True),
    (1920 * 1080 * 32, dict(total_bytes=GATE_CARD, with_aux=True,
                            max_depth=8), False),
])
def test_bounce_lanes_check(lanes, kw, fits):
    """The pipeline's gate on its lane count: below 2^27 lanes (the
    kernels index 16 state rows as row * N + lane in int32) and within
    MEMORY_SHARE of the card's bytes; on a CPU device with no card size
    given, the index limit alone."""
    assert bo.bounce_lanes_supported(lanes, "cpu", **kw) is fits
    if not fits:
        with pytest.raises(ValueError, match="int32|card's"):
            bo.bounce_lanes_check(lanes, "cpu", **kw)
    per_lane = bo.LANE_BYTES + (
        (kw.get("max_depth", 0) + 1) * bo.DUMP_BYTES + bo.ADJOINT_BYTES
        if kw.get("with_aux") else 0)
    if "total_bytes" in kw:
        assert fits == (lanes * per_lane <= bo.MEMORY_SHARE
                        * kw["total_bytes"] and lanes < 1 << 27)


def test_pipeline_past_the_lane_gate_raises(cornell):
    """build_forward_pipeline refuses a wavefront past the gate before it
    builds anything; the renderer raises ValueError, on which
    engine.make_big_path_renderer takes the next candidate."""
    cam = dataclasses.replace(cornell.cam, xres=3840, yres=2160)
    with pytest.raises(ValueError, match="int32"):
        bo.make_bounce_path_renderer(cornell.ts, cam, samples=32,
                                     max_depth=1)
    with pytest.raises(ValueError, match="int32"):
        bo.build_forward_pipeline(cornell.ts, cam, samples=1, max_depth=8,
                                  pix_count=1 << 27)


# ---------------------------------------------------------------------------
# textured scenes
# ---------------------------------------------------------------------------

def _with_texture(fields, tex, uv0, uv1, uv2, mats=None):
    """Scene fields with one texture image as the whole atlas, the given
    (or all) materials mapped to it, and per-corner uvs."""
    f = dict(fields)
    M = f["mat_diffuse"].shape[0]
    mm = np.full(M, -1, np.int32)
    mm[np.arange(M) if mats is None else np.asarray(mats)] = 0
    h, w = tex.shape[:2]
    f.update(tex_atlas=np.asarray(tex, np.float32),
             tex_off=np.zeros((1, 2), np.int32),
             tex_hw=np.array([[h, w]], np.int32), mat_map_diffuse=mm,
             uv0=np.asarray(uv0, np.float32), uv1=np.asarray(uv1, np.float32),
             uv2=np.asarray(uv2, np.float32))
    return f


def _fields(both):
    from torch_port_util import jax_fields

    return jax_fields(both.js)


def _scene(fields):
    from orion_tpu_torch.scene import scene_from_numpy

    return scene_from_numpy(fields, "cpu")


@pytest.mark.parametrize("uvc", [(0.375, 0.375), (-1.625, -1.625)])
def test_constant_texel_equals_solid_kd_bitwise(lv2, uvc):
    """Every corner uv pinned to texel (1, 1) of a 4x4 texture, by the
    in-range uv or through the floored-mod wrap of a negative one
    (-1.625 * 4 = -6.5 -> floor -7 -> mod 4 = 1)."""
    f = _fields(lv2)
    T = f["tri_v0"].shape[0]
    tex = np.full((4, 4, 3), 0.9, np.float32)
    texel = np.array([0.25, 0.5, 0.125], np.float32)
    tex[1, 1] = texel
    uv = np.broadcast_to(np.array(uvc, np.float32), (T, 2)).copy()
    em = {int(i) for i in f["emissive_mesh_ids"][:f["num_emissive"]]}
    mats = [m for m in range(f["mat_diffuse"].shape[0]) if m not in em]
    tex_scene = _scene(_with_texture(f, tex, uv, uv, uv, mats=mats))
    assert not bp.bvh_path_supported(tex_scene)
    kd = f["mat_diffuse"].copy()
    kd[mats] = texel
    solid = _scene(dict(f, mat_diffuse=kd))
    _, seed = _seed(2)
    fn = lv2.port(scene=tex_scene)
    assert fn.ctx["textured"]
    img_tex, img_solid = fn(seed), lv2.port(scene=solid)(seed)
    assert torch.equal(img_tex, img_solid)
    assert not torch.equal(img_tex, lv2.port()(seed))


def _checkered(both, seed=0):
    f = _fields(both)
    T = f["tri_v0"].shape[0]
    tex = np.zeros((8, 8, 3), np.float32)
    tex[::2, ::2] = 1.0
    tex[1::2, 1::2] = 1.0
    rng = np.random.default_rng(seed)
    uv0 = rng.random((T, 2), np.float32) * 3 - 1
    uv1 = uv0 + rng.random((T, 2), np.float32) * 0.3
    uv2 = uv0 + rng.random((T, 2), np.float32) * 0.3
    return _with_texture(f, tex, uv0, uv1, uv2)


def test_textured_pipeline_matches_jax(lv2):
    f = _checkered(lv2)
    key, seed = _seed(4)
    js = dataclasses.replace(lv2.js, **{
        k: jnp.asarray(f[k]) for k in ("tex_atlas", "tex_off", "tex_hw",
                                       "mat_map_diffuse", "uv0", "uv1",
                                       "uv2")})
    pipe, jctx = jb.build_forward_pipeline(
        js, lv2.jcam, samples=S, max_depth=D, light_samples=LS,
        ray_block=RB, interpret=True)
    j_st = np.asarray(jax.jit(pipe)(jf.seed_scalar(key))[0])
    ts = _scene(f)
    fn = lv2.port(jctx, scene=ts)
    ours = fn(seed).numpy()
    np.testing.assert_allclose(ours, _jax_image(j_st, 64, 8), rtol=1e-5,
                               atol=1e-6)
    # the texels are really read: the solid scene renders another image
    assert np.abs(ours - lv2.port()(seed).numpy()).max() > 1e-4
    # textured=False holds a textured scene to the untextured gate
    with pytest.raises(ValueError, match="gate"):
        lv2.port(scene=ts, textured=False)


def test_textured_scene_routes_to_bounce(tmp_path, capsys, cornell):
    rtc = write_textured(tmp_path)
    out = tmp_path / "o.hdr"
    assert cli.main([str(rtc), "-o", str(out), "-p", "2", "-l", "2",
                     "--device", "cpu", "--stats"]) == 0
    cap = capsys.readouterr()
    assert '"backend": "bounce-torch"' in cap.err
    assert "bounce-torch" in cap.out
    img = load_hdr(out)
    assert img.shape == (24, 24, 3) and np.isfinite(img).all()
    # the lit checkered floor is there, and it is checkered
    assert (img.mean(axis=-1) > 0.05).mean() > 0.2
    tex = load_scene(rtc, device="cpu")[0]
    for order in (None, ("walk", "bounce"), ("bounce",)):
        _, name = make_big_path_renderer(tex, cornell.cam, samples=1,
                                         max_depth=1, order=order)
        assert name == "bounce-torch"
    with pytest.raises(ValueError, match="no big-path megakernel fits"):
        make_big_path_renderer(tex, cornell.cam, samples=1, max_depth=1,
                               order=("walk",))
    # the binned renderer's gate is the untextured one, as in the JAX
    # package; on the untextured box it renders on its plain versions
    with pytest.raises(ValueError, match="no big-path megakernel fits"):
        make_big_path_renderer(tex, cornell.cam, samples=1, max_depth=1,
                               order=("binned",))
    _, name = make_big_path_renderer(cornell.ts, cornell.cam, samples=1,
                                     max_depth=1, order=("binned",))
    assert name == "binned-torch"


def test_walks_hold_the_tie_and_flag_rules():
    """Two coplanar triangles in different leaves tie: the earlier leaf
    keeps the hit; a lane that is not alive reports no hit; a leaf flagged
    "no emitter rows" votes the flag down on an improving hit."""
    from orion_tpu_torch.ops.bvh_traverse import lean_plain, shadow_em_plain
    from orion_tpu_torch.ops.woop import woop_rows_np

    # leaf A: a triangle at z = 1 (material 1) and one far away; leaf B:
    # the same triangle again (material 2) and one at z = 2 (material 2)
    v0 = np.array([[0, 0, 1], [5, 5, 5], [0, 0, 1], [0, 0, 2]], np.float32)
    e1 = np.array([[1, 0, 0]] * 4, np.float32)
    e2 = np.array([[0, 1, 0]] * 4, np.float32)
    tab = np.zeros((4, 32), np.float32)
    tab[:, :13] = woop_rows_np(v0, e1, e2)
    tab[:, 29] = [1, 0, 2, 2]                  # material per row
    tab = torch.as_tensor(tab)
    # a root over the two leaves of width 2; leaf B's start carries the
    # "no emitter rows" flag in bit 0
    lo = torch.tensor([[0, 0, 0], [0, 0, 0], [0, 0, 0]], dtype=torch.float32)
    hi = torch.tensor([[6, 6, 6]] * 3, dtype=torch.float32)
    skip = torch.tensor([3, 2, 3], dtype=torch.int32)
    start = torch.tensor([-1, 0, 2 | 1], dtype=torch.int32)
    o = torch.tensor([[0.25, 0.25, 0.0]] * 2)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 2)
    alive = torch.tensor([True, False])
    t, hit, u, v, row = lean_plain(lo, hi, skip, start, tab, o, d,
                                   leaf_width=2, alive=alive)
    assert hit.tolist() == [True, False] and row.tolist() == [0.0, 0.0]
    assert t[0] == 1.0 and t[1] > 1e38 and u[0] == 0.25 and v[1] == 0.0
    kw = dict(leaf_width=2, cap=5.0)
    mesh = tab[:, 29]
    for em_mesh, want in ((1.0, True), (2.0, False)):
        (vis,) = shadow_em_plain(lo, hi, skip, start, tab, mesh, o, (d,),
                                 (alive,), em_mesh, **kw)
        assert vis.tolist() == [want, False]
    # from behind, leaf A's hit at t = 2 comes first and leaf B's row 3
    # (material 2) improves on it at t = 1; B's flag says "no emitter
    # rows", so the improving hit votes the flag down unread
    o2 = torch.tensor([[0.25, 0.25, 3.0]] * 2)
    v0_, v1_ = shadow_em_plain(lo, hi, skip, start, tab, mesh, o2, (-d, d),
                               (alive, ~alive), 2.0, **kw)
    assert v0_.tolist() == [False, False] and v1_.tolist() == [False, False]
    start[2] = 2                               # the same leaf, unflagged
    v0_, _ = shadow_em_plain(lo, hi, skip, start, tab, mesh, o2, (-d, d),
                             (alive, ~alive), 2.0, **kw)
    assert v0_.tolist() == [True, False]
