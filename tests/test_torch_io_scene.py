"""Port I/O and scene model against the JAX package, on inline scenes.

Every comparison here is exact: the port's I/O and scene construction run
the same NumPy arithmetic as the JAX package, so rtc/OBJ/image bytes and
every Scene field must be equal, bit for bit.
"""

import dataclasses

import numpy as np
import pytest

from orion_tpu.io import image as jimage
from orion_tpu.io.obj import load_obj as jload_obj
from orion_tpu.io.rtc import parse_rtc as jparse_rtc
from orion_tpu.io.rtc import write_rtc as jwrite_rtc
from orion_tpu.scene import load_scene as jload_scene
from orion_tpu.scene import subdivide_scene as jsubdivide
from orion_tpu_torch.io import image as timage
from orion_tpu_torch.io.obj import load_obj
from orion_tpu_torch.io.rtc import parse_rtc, write_rtc
from orion_tpu_torch.scene import (STATIC_FIELDS, TENSOR_FIELDS, load_scene,
                                   scene_from_numpy, scene_to_numpy,
                                   subdivide_scene)
from orion_tpu_torch.validate import (SceneValidationError, validate_rtc,
                                      validate_scene)

from chip_smoke import write_cornell
from torch_port_util import jax_fields, write_textured, write_whitted


def _assert_scene_equal(jax_scene, port_scene):
    for name in TENSOR_FIELDS:
        a = np.asarray(getattr(jax_scene, name))
        b = port_scene.numpy(name)
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        assert np.array_equal(a, b), name
    for name in STATIC_FIELDS:
        assert getattr(jax_scene, name) == getattr(port_scene, name), name


@pytest.mark.parametrize("variant", ["cornell", "whitted", "textured"])
def test_rtc_round_trip(tmp_path, variant):
    writer = {"cornell": write_cornell, "whitted": write_whitted,
              "textured": write_textured}[variant]
    rtc_path = writer(tmp_path)
    ours, theirs = parse_rtc(rtc_path), jparse_rtc(rtc_path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    write_rtc(tmp_path / "a.rtc", ours)
    jwrite_rtc(tmp_path / "b.rtc", theirs)
    assert (tmp_path / "a.rtc").read_bytes() == (tmp_path / "b.rtc").read_bytes()
    again = parse_rtc(tmp_path / "a.rtc")
    assert again.obj_file == ours.obj_file
    assert again.xres == ours.xres and again.yres == ours.yres
    assert len(again.lights) == len(ours.lights)


@pytest.mark.parametrize("variant", ["cornell", "textured"])
def test_obj_arrays_equal(tmp_path, variant):
    rtc = (write_cornell if variant == "cornell" else write_textured)(tmp_path)
    obj_path = tmp_path / parse_rtc(rtc).obj_file
    ours = load_obj(obj_path)
    theirs = jload_obj(obj_path, parser="python")
    assert [m.name for m in ours.meshes] == [m.name for m in theirs.meshes]
    for a, b in zip(ours.meshes, theirs.meshes):
        for field in ("positions", "normals", "uvs"):
            assert np.array_equal(getattr(a, field), getattr(b, field))
        assert a.material.name == b.material.name
        assert np.array_equal(a.material.emissive, b.material.emissive)
        assert a.material.map_diffuse == b.material.map_diffuse


def test_obj_native_parser_not_ported(tmp_path):
    rtc = write_cornell(tmp_path)
    with pytest.raises(NotImplementedError):
        load_obj(tmp_path / parse_rtc(rtc).obj_file, parser="native")


@pytest.mark.parametrize("ext", ["ppm", "hdr"])
def test_image_bytes_equal(tmp_path, ext):
    img = np.random.default_rng(0).uniform(0.0, 3.0, (13, 17, 3))
    img = img.astype(np.float32)
    img[0, 0] = 0.0
    timage.save_image(tmp_path / f"a.{ext}", img)
    jimage.save_image(tmp_path / f"b.{ext}", img)
    assert (tmp_path / f"a.{ext}").read_bytes() == \
        (tmp_path / f"b.{ext}").read_bytes()
    if ext == "hdr":
        back = timage.load_hdr(tmp_path / "a.hdr")
        assert np.array_equal(back, jimage.load_hdr(tmp_path / "b.hdr"))
        # RGBE truncates each channel to a quantum of 2^(ceil(log2 m)+1)/256
        # for a pixel whose largest channel is m (<= 3 here: 8/256)
        assert np.allclose(back, img, rtol=0, atol=8.0 / 256.0)


@pytest.mark.parametrize("variant", ["cornell", "whitted", "textured"])
def test_scene_fields_equal(tmp_path, variant):
    writer = {"cornell": write_cornell, "whitted": write_whitted,
              "textured": write_textured}[variant]
    rtc = writer(tmp_path)
    js, _ = jload_scene(rtc)
    ts, _ = load_scene(rtc, device="cpu")
    _assert_scene_equal(js, ts)
    if variant == "textured":
        assert ts.numpy("tex_hw").max() == 8


@pytest.mark.parametrize("levels", [1, 2])
def test_subdivide_equal(tmp_path, levels):
    rtc = write_cornell(tmp_path)
    js, _ = jload_scene(rtc)
    ts, _ = load_scene(rtc, device="cpu")
    _assert_scene_equal(jsubdivide(js, levels=levels),
                        subdivide_scene(ts, levels=levels))


def test_scene_from_numpy_round_trip(tmp_path):
    js, _ = jload_scene(write_cornell(tmp_path))
    fields = jax_fields(js)
    ts = scene_from_numpy(fields, "cpu")
    _assert_scene_equal(js, ts)
    back = scene_to_numpy(ts)
    for name in TENSOR_FIELDS:
        assert np.array_equal(back[name], fields[name]), name
        assert back[name].dtype == fields[name].dtype, name
    for name in STATIC_FIELDS:
        assert back[name] == fields[name]


def test_validation(tmp_path):
    rtc_path = write_cornell(tmp_path)
    ts, rtc = load_scene(rtc_path, device="cpu")
    validate_rtc(rtc)
    validate_scene(ts)
    rtc.xres = 0
    with pytest.raises(SceneValidationError):
        validate_rtc(rtc)
    fields = scene_to_numpy(ts)
    fields["tri_v0"] = fields["tri_v0"].copy()
    fields["tri_v0"][0, 0] = np.nan
    with pytest.raises(SceneValidationError):
        validate_scene(scene_from_numpy(fields, "cpu"))


def test_entry_points_default_to_cuda():
    """Scene loading, scene building and the camera run on the card unless
    the caller asks for the CPU, as engine.prepare does."""
    import inspect

    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import prepare
    from orion_tpu_torch.scene import build_scene

    for fn in (load_scene, build_scene, camera_from_rtc, prepare):
        assert inspect.signature(fn).parameters["device"].default == "cuda", (
            fn.__name__)
