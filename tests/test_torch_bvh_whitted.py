"""The port's BVH Whitted megakernels (ops/bvh_whitted.py, kernels 7a and
7b) on the CPU, against the JAX package's in interpret mode, and the
Whitted routes of the CLI.

Tolerances. The plain versions against the JAX kernels on the identical
tree, scene and PCG seed: the same float32 estimator in another op order,
rtol 1e-5 and atol 1e-6 per pixel (the JAX package's own BVH-against-
brute difference is 1.2e-7). Against the port's Whitted estimator over the
brute sweep (another sweep order, so a tie on a coplanar face may break
the other way): the JAX test's atol 5e-5, rtol 1e-4. Tiles, record chunks
and a texture holding the solid colour compose bit for bit or to 1e-6.
"""

import contextlib
import inspect
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.accel.bvh import build_bvh as jbuild_bvh
from orion_tpu.camera import Camera as JCamera
from orion_tpu.camera import camera_from_rtc as jcamera_from_rtc
from orion_tpu.ops import pallas_bvh_whitted as jw
from orion_tpu.ops import pallas_fused as jf
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu.scene import make_synthetic_scene as jsynthetic
from orion_tpu_torch import cli
from orion_tpu_torch.accel.bvh import bvh_from_numpy
from orion_tpu_torch.camera import Camera, camera_from_rtc
from orion_tpu_torch.io.image import load_hdr
from orion_tpu_torch.ops import bvh_whitted as bw
from orion_tpu_torch.ops import whitted as wh
from orion_tpu_torch.scene import (STATIC_FIELDS, TENSOR_FIELDS,
                                   make_synthetic_scene, scene_from_numpy,
                                   scene_to_numpy)

from cornell_scenes import write_cornell_whitted
from torch_port_util import jax_bvh_fields, to_torch

TOL = dict(rtol=1e-5, atol=1e-6)
BRUTE_TOL = dict(rtol=1e-4, atol=5e-5)


def _seed(k):
    return int(jf.seed_scalar(jax.random.key(k))[0])


def _jax_tree(js):
    """The tree the JAX Whitted kernels build (leaf width 128), as the
    port's BVH."""
    jb, _ = jbuild_bvh(np.asarray(js.tri_v0), np.asarray(js.tri_e1),
                       np.asarray(js.tri_e2), np.asarray(js.tri_valid),
                       leaf_size=jw.LEAF_WIDTH, leaf_width=jw.LEAF_WIDTH)
    return bvh_from_numpy(jax_bvh_fields(jb))


def _checker(scene_fields, side=8):
    """tests/test_bvh_whitted.py's red/green checker as every material's
    diffuse map, with random per-corner uvs (host fields in, fields out)."""
    rng = np.random.default_rng(11)
    f = dict(scene_fields)
    T = f["uv0"].shape[0]
    atlas = np.zeros((side, side, 3), np.float32)
    yy, xx = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    check = ((xx + yy) % 2).astype(np.float32)
    atlas[..., 0] = check
    atlas[..., 1] = 1.0 - check
    f.update(uv0=rng.random((T, 2), np.float32),
             uv1=rng.random((T, 2), np.float32),
             uv2=rng.random((T, 2), np.float32),
             mat_map_diffuse=np.zeros(f["mat_diffuse"].shape[0], np.int32),
             tex_atlas=atlas, tex_off=np.zeros((1, 2), np.int32),
             tex_hw=np.full((1, 2), side, np.int32))
    return f


def _jscene(fields):
    from orion_tpu.scene import Scene as JScene

    return JScene(**{n: jnp.asarray(fields[n]) for n in TENSOR_FIELDS},
                  **{n: int(fields[n]) for n in STATIC_FIELDS})


@pytest.fixture(scope="module")
def soup():
    """The JAX test's soup: make_synthetic_scene(1500, seed=3) with Ks 0.25
    so that mirror chains run, both packages' scenes, cameras and the JAX
    tree; its checker-textured variant."""
    f = scene_to_numpy(make_synthetic_scene(1500, seed=3, device="cpu"))
    f["mat_specular"] = np.full((1, 3), 0.25, np.float32)
    js, ts = _jscene(f), scene_from_numpy(f, "cpu")
    jcam = JCamera(origin=jnp.asarray([0.0, 0.0, 35.0]),
                   front=jnp.asarray([0.0, 0.0, -1.0]),
                   right=jnp.asarray([1.0, 0.0, 0.0]),
                   up=jnp.asarray([0.0, 1.0, 0.0]), xres=48, yres=32)
    cam = Camera(origin=torch.tensor([0.0, 0.0, 35.0]),
                 front=torch.tensor([0.0, 0.0, -1.0]),
                 right=torch.tensor([1.0, 0.0, 0.0]),
                 up=torch.tensor([0.0, 1.0, 0.0]), xres=48, yres=32)
    tf = _checker(f)
    return dict(js=js, ts=ts, jcam=jcam, cam=cam, tree=_jax_tree(js),
                jtex=_jscene(tf), ttex=scene_from_numpy(tf, "cpu"))


@pytest.mark.parametrize("seed,with_light", [(3, True), (0, False)])
def test_synthetic_scene_equals_jax(seed, with_light):
    js = jsynthetic(700, seed=seed, with_light=with_light)
    ts = make_synthetic_scene(700, seed=seed, with_light=with_light,
                              device="cpu")
    for n in TENSOR_FIELDS:
        a, b = np.asarray(getattr(js, n)), ts.numpy(n)
        assert a.dtype == b.dtype and np.array_equal(a, b), n
    for n in STATIC_FIELDS:
        assert getattr(js, n) == getattr(ts, n), n
    default = inspect.signature(make_synthetic_scene).parameters["device"]
    assert default.default == "cuda"


@pytest.mark.parametrize("case", ["soup", "textured", "no-lights",
                                  "nine-lights"])
def test_gates_agree_with_jax(soup, case):
    f = scene_to_numpy(soup["ts"])
    if case == "textured":
        f = scene_to_numpy(soup["ttex"])
    elif case == "no-lights":
        f["num_lights"] = 0
    elif case == "nine-lights":
        for n in ("light_pos", "light_color", "light_intensity"):
            f[n] = np.repeat(f[n], 9, axis=0)
        f["num_lights"] = 9
    js, ts = _jscene(f), scene_from_numpy(f, "cpu")
    assert bw.bvh_whitted_supported(ts) == jw.bvh_whitted_supported(js)
    assert bw.bvh_whitted_supported(ts) == (case == "soup")
    for depth in range(6):
        assert (bw.bvh_whitted_deferred_supported(ts, depth)
                == jw.bvh_whitted_deferred_supported(js, depth)), depth
    assert bw.bvh_whitted_deferred_supported(ts, bw.MAX_DEFERRED_DEPTH) == (
        case in ("soup", "textured"))


@pytest.fixture(scope="module")
def cornells(tmp_path_factory):
    out = {}
    for levels in (0, 2):
        rtc = write_cornell_whitted(tmp_path_factory.mktemp(f"w{levels}"),
                                    xres=16, yres=16, depth=2, levels=levels)
        js, jrtc = jload_scene(rtc)
        out[levels] = dict(js=js, ts=to_torch(js), jcam=jcamera_from_rtc(jrtc),
                           cam=camera_from_rtc(jrtc, device="cpu"),
                           tree=_jax_tree(js))
    return out


def _case(name, soup, cornells):
    if name == "soup":
        return soup, 4, 2
    return cornells[int(name[-1])], 2, 2


@pytest.mark.parametrize("name", ["soup", "cornell-0", "cornell-2"])
def test_plain_bvh_whitted_matches_jax(soup, cornells, name):
    c, S, D = _case(name, soup, cornells)
    theirs = np.asarray(jw.make_bvh_whitted_renderer(
        c["js"], c["jcam"], samples=S, max_depth=D,
        interpret=True)(jax.random.key(0)))
    fn = bw.make_bvh_whitted_renderer(c["ts"], c["cam"], samples=S,
                                      max_depth=D, leaf_width=jw.LEAF_WIDTH,
                                      bvh=c["tree"])
    ours = fn(_seed(0)).numpy()
    assert ours.shape == theirs.shape and theirs.mean() > 0.01
    np.testing.assert_allclose(ours, theirs, **TOL)
    # the port's Whitted estimator over the brute sweep, same seed
    brute = wh.fused_whitted_plain(*wh.whitted_args(c["ts"], c["cam"]),
                                   _seed(0), c["cam"].xres, c["cam"].yres,
                                   S, D, c["ts"].num_emissive > 0)
    np.testing.assert_allclose(ours.reshape(-1, 3), brute.numpy(),
                               **BRUTE_TOL)
    # a tile renders the same pixels as the whole image
    tile = fn(_seed(0), pix_base=37, n_lanes=50).numpy()
    assert np.array_equal(tile, ours.reshape(-1, 3)[37:87])


def test_octant_copies_give_the_same_image(soup):
    kw = dict(samples=2, max_depth=2, leaf_width=jw.LEAF_WIDTH,
              bvh=soup["tree"])
    one = bw.make_bvh_whitted_renderer(soup["ts"], soup["cam"], **kw)(5)
    eight = bw.make_bvh_whitted_renderer(soup["ts"], soup["cam"], octants=8,
                                         **kw)(5)
    np.testing.assert_allclose(eight.numpy(), one.numpy(), **TOL)
    assert one.mean() > 0.01


@pytest.mark.parametrize("depth", [0, 2])
def test_plain_deferred_matches_jax_on_checker(soup, depth):
    theirs = np.asarray(jw.make_bvh_whitted_deferred(
        soup["jtex"], soup["jcam"], samples=4, max_depth=depth,
        interpret=True)(jax.random.key(0)))
    ours = bw.make_bvh_whitted_deferred(
        soup["ttex"], soup["cam"], samples=4, max_depth=depth,
        leaf_width=jw.LEAF_WIDTH, bvh=soup["tree"])(_seed(0)).numpy()
    np.testing.assert_allclose(ours, theirs, **TOL)
    solid = bw.make_bvh_whitted_deferred(
        soup["ts"], soup["cam"], samples=4, max_depth=depth,
        leaf_width=jw.LEAF_WIDTH, bvh=soup["tree"])(_seed(0)).numpy()
    assert not np.allclose(ours, solid, atol=1e-3)     # the checker shows


def test_deferred_untextured_equals_bvh_whitted(soup):
    kw = dict(samples=4, max_depth=2, leaf_width=jw.LEAF_WIDTH,
              bvh=soup["tree"])
    d = bw.make_bvh_whitted_deferred(soup["ts"], soup["cam"], **kw)(7)
    s = bw.make_bvh_whitted_renderer(soup["ts"], soup["cam"], **kw)(7)
    np.testing.assert_allclose(d.numpy(), s.numpy(), **TOL)
    d0 = bw.make_bvh_whitted_deferred(soup["ts"], soup["cam"], samples=4,
                                      max_depth=0, leaf_width=jw.LEAF_WIDTH,
                                      bvh=soup["tree"])(7)
    assert (d - d0).abs().max() > 1e-4                 # mirrors contribute


def test_deferred_constant_texture_equals_solid(soup):
    f = scene_to_numpy(soup["ts"])
    kd = f["mat_diffuse"][0]
    f.update(mat_map_diffuse=np.zeros(1, np.int32),
             tex_atlas=np.broadcast_to(kd, (4, 4, 3)).astype(np.float32),
             tex_off=np.zeros((1, 2), np.int32),
             tex_hw=np.full((1, 2), 4, np.int32))
    kw = dict(samples=2, max_depth=1, leaf_width=jw.LEAF_WIDTH,
              bvh=soup["tree"])
    img_t = bw.make_bvh_whitted_deferred(scene_from_numpy(f, "cpu"),
                                         soup["cam"], **kw)(3)
    img_s = bw.make_bvh_whitted_deferred(soup["ts"], soup["cam"], **kw)(3)
    np.testing.assert_allclose(img_t.numpy(), img_s.numpy(), atol=1e-6)


def test_deferred_sample_chunking_composes(soup, monkeypatch):
    kw = dict(samples=6, max_depth=1, leaf_width=jw.LEAF_WIDTH,
              bvh=soup["tree"])
    one = bw.make_bvh_whitted_deferred(soup["ttex"], soup["cam"], **kw)
    assert one.data["chunks"] == [(0, 6)]
    monkeypatch.setattr(bw, "MAX_REC_GROUPS", 4)       # 3 chunks of 2
    chunked = bw.make_bvh_whitted_deferred(soup["ttex"], soup["cam"], **kw)
    assert chunked.data["chunks"] == [(0, 2), (2, 2), (4, 2)]
    np.testing.assert_allclose(chunked(5).numpy(), one(5).numpy(),
                               atol=1e-6)
    # a tile of the chunked render gives the whole image's pixels
    tile = chunked(5, pix_base=100, n_lanes=64)
    assert torch.equal(tile, chunked(5).reshape(-1, 3)[100:164])


def test_records_layout_and_wrapper_checks(soup):
    fn = bw.make_bvh_whitted_deferred(soup["ttex"], soup["cam"], samples=1,
                                      max_depth=1, leaf_width=jw.LEAF_WIDTH,
                                      bvh=soup["tree"])
    dd = fn.data
    args = (dd["nodes"], dd["tab"], dd["lights"], dd["cam"], 9, 48, 32)
    rec = bw.bvh_whitted_deferred_plain(*args, 2, 3, 1, False,
                                        leaf_width=jw.LEAF_WIDTH)
    assert rec.shape == (2 * 2 * bw.REC_ROWS, 48 * 32)
    r = rec.reshape(2, 2, bw.REC_ROWS, -1)
    hit0 = r[:, 0, 6:9].sum(dim=1) > 0                # lit primary hits
    mats = r[:, :, 2]
    assert hit0.any() and bool((mats == 0).all())     # one material
    assert bool((r[:, 1].abs().sum(dim=1)[~(r[:, 0, 0:2].abs().sum(1) > 0)]
                 == 0).all())                           # no bounce past a miss
    with pytest.raises(ValueError):                   # the Whitted table
        bw.bvh_whitted_textured(soup["ttex"], dd["nodes"], dd["tab"][:, :40],
                                *args[2:], 1, 1, False, leaf_width=128)
    with pytest.raises(ValueError):                   # lanes past the image
        bw.bvh_whitted_textured(soup["ttex"], *args, 1, 1, False,
                                leaf_width=128, pix_base=48 * 32 - 3,
                                n_lanes=4)
    with pytest.raises(ValueError, match="gate"):
        bw.make_bvh_whitted_deferred(soup["ttex"], soup["cam"], samples=1,
                                     max_depth=bw.MAX_DEFERRED_DEPTH + 1)
    with pytest.raises(ValueError, match="gate"):
        bw.make_bvh_whitted_renderer(soup["ttex"], soup["cam"], samples=1,
                                     max_depth=1)


def _cli(argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main(argv + ["--device", "cpu", "--stats"]) == 0
    return json.loads(err.getvalue().splitlines()[-1])


@pytest.mark.parametrize("case", ["textured", "big"])
def test_cli_whitted_routes_past_the_fused_gate(tmp_path, case):
    """A textured Whitted scene renders on the deferred kernel's plain
    version, the 34,818-triangle box on the BVH Whitted kernel's, as the
    JAX CLI routes them (orion_tpu/cli.py:107-137)."""
    rtc = write_cornell_whitted(tmp_path, xres=12, yres=8, depth=2,
                                checker=case == "textured",
                                levels=5 if case == "big" else 0)
    out = tmp_path / "o.hdr"
    rep = _cli([str(rtc), "-o", str(out), "-p", "1"])
    assert rep["backend"] == ("bvh-whitted-deferred-torch"
                              if case == "textured" else "bvh-whitted-torch")
    img = load_hdr(out)
    assert img.shape == (8, 12, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    if case == "textured":
        solid = write_cornell_whitted(tmp_path / "solid", xres=12, yres=8,
                                      depth=2)
        rep = _cli([str(solid), "-o", str(tmp_path / "s.hdr"), "-p", "1"])
        assert rep["backend"] == "fused-whitted-kernel"
        assert not np.allclose(load_hdr(tmp_path / "s.hdr"), img, atol=1e-3)


@pytest.mark.parametrize("spec_map", [False, True])
@pytest.mark.parametrize("depth", [0, 3])
def test_front_to_back_fold_equals_epilogue(soup, spec_map, depth):
    """Kernel 7b's order over the plain records (fold_front_to_back: the
    chain from the first bounce with the throughput T = prod ks(uv)) gives
    deferred_epilogue's back-to-front sum within TOL, with the checker as
    the diffuse map alone and as the specular map too (a red or green
    texel zeroes T's other channels, and two of them T itself)."""
    f = _checker(scene_to_numpy(soup["ts"]))
    if spec_map:
        f["mat_map_specular"] = np.zeros(f["mat_diffuse"].shape[0], np.int32)
    sc = scene_from_numpy(f, "cpu")
    S = 3
    dd = bw.make_bvh_whitted_deferred(sc, soup["cam"], samples=S,
                                      max_depth=depth,
                                      leaf_width=jw.LEAF_WIDTH,
                                      bvh=soup["tree"]).data
    rec = bw.bvh_whitted_deferred_plain(
        dd["nodes"], dd["tab"], dd["lights"], dd["cam"], 5, 48, 32, S, 0,
        depth, dd["with_emissive"], leaf_width=jw.LEAF_WIDTH)
    back = bw.deferred_epilogue(sc, rec, S, depth)
    front = bw.fold_front_to_back(sc, rec, S, depth)
    np.testing.assert_allclose(front.numpy(), back.numpy(), **TOL)
    assert float(front.max()) > 0.01
    if depth:           # the chain reaches the second bounce's texels
        first = bw.fold_front_to_back(sc, rec.reshape(
            S, depth + 1, bw.REC_ROWS, -1)[:, :1].reshape(
                S * bw.REC_ROWS, -1), S, 0)
        assert float((front - first).abs().max()) > 1e-4


def test_texel_table_of_the_maps(soup):
    """pack_texels: per material the diffuse, then the specular map's (h, w,
    y0, x0) in the atlas, zeros where the material has no such map."""
    f = _checker(scene_to_numpy(soup["ts"]))
    mat_tex, atlas = bw.pack_texels(scene_from_numpy(f, "cpu"))
    assert mat_tex.dtype == torch.int32 and mat_tex.shape == (1, 8)
    assert mat_tex.tolist() == [[8, 8, 0, 0, 0, 0, 0, 0]]
    assert atlas.shape == (8, 8, 3)
    f["mat_map_specular"] = np.zeros(1, np.int32)
    f["tex_off"] = np.array([[2, 5]], np.int32)
    mat_tex, _ = bw.pack_texels(scene_from_numpy(f, "cpu"))
    assert mat_tex.tolist() == [[8, 8, 2, 5, 8, 8, 2, 5]]
