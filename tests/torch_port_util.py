"""Shared helpers of the tests/test_torch_*.py files: inline scenes written
to a temporary directory, the JAX -> PyTorch scene hand-over, and the
fixture that skips a test needing a CUDA device."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chip_smoke import write_cornell
from orion_tpu_torch.scene import (STATIC_FIELDS, TENSOR_FIELDS,
                                   scene_from_numpy)


# The test workers run side by side (pytest-xdist), each with JAX's and
# PyTorch's thread pools; one intra-op thread per worker keeps the many
# small tensor operations of the batched walks from fighting over cores.
torch.set_num_threads(1)


def jax_fields(js) -> dict:
    """{field: host array} + static ints of a JAX Scene."""
    out = {n: np.asarray(getattr(js, n)) for n in TENSOR_FIELDS}
    out.update({n: getattr(js, n) for n in STATIC_FIELDS})
    return out


def to_torch(js, device="cpu"):
    """The identical scene as the port's Scene."""
    return scene_from_numpy(jax_fields(js), device)


def jax_bvh_fields(jb) -> dict:
    """{field: host array} + num_nodes and leaf_width of a JAX BVH: what
    `orion_tpu_torch.accel.bvh.bvh_from_numpy` takes, so that both
    packages walk the identical tree."""
    from orion_tpu_torch.accel.bvh import ARRAY_FIELDS

    out = {n: np.asarray(getattr(jb, n)) for n in ARRAY_FIELDS}
    out.update(num_nodes=jb.num_nodes, leaf_width=jb.leaf_width)
    return out


def regroup_meshes(fields: dict, groups: int) -> dict:
    """The fields of a scene whose emitter is its last mesh (as
    chip_smoke.write_cornell writes the box), with every other triangle
    given the first mesh's material and cut, in its order, into `groups`
    contiguous meshes: the same geometry and the same radiance, with
    `groups` + 1 meshes and two materials. Areas are each new mesh's."""
    f = dict(fields)
    em = int(f["emissive_mesh_ids"][0])
    M = int(f["num_meshes"])
    if em != M - 1:
        raise ValueError(f"emitter mesh {em} is not the last of {M}")
    start = f["mesh_tri_start"]
    n_em = int(f["mesh_tri_count"][em])
    n = int(start[em])                         # triangles before the emitter
    cuts = np.linspace(0, n, groups + 1).round().astype(np.int32)
    f["mesh_tri_start"] = np.append(cuts[:-1], start[em]).astype(np.int32)
    f["mesh_tri_count"] = np.append(np.diff(cuts), n_em).astype(np.int32)
    mat = f["tri_mat"].copy()
    for g in range(groups):
        mat[cuts[g]:cuts[g + 1]] = g
    mat[n:n + n_em] = groups
    f["tri_mat"] = mat
    area = 0.5 * np.linalg.norm(np.cross(f["tri_e1"][:n], f["tri_e2"][:n]),
                                axis=1)
    f["mesh_area"] = np.append(
        [area[cuts[g]:cuts[g + 1]].sum() for g in range(groups)],
        f["mesh_area"][em]).astype(np.float32)
    rows = [0] * groups + [em]
    for k in ("mat_ambient", "mat_diffuse", "mat_specular", "mat_emissive",
              "mat_shininess", "mat_opacity", "mat_map_diffuse",
              "mat_map_specular", "mat_map_bump"):
        f[k] = f[k][rows].copy()
    f["emissive_mesh_ids"] = np.array([groups], np.int32)
    f["num_meshes"] = groups + 1
    return f


def write_textured(directory):
    """Floor with a checker map_Kd under an emissive quad (path mode)."""
    from orion_tpu_torch.io.image import save_image

    tex = np.zeros((8, 8, 3), np.float32)
    tex[::2, ::2] = 1.0
    tex[1::2, 1::2] = 1.0
    save_image(str(directory / "checker.png"), tex)
    (directory / "tex.mtl").write_text(
        "newmtl light\nKd 0.78 0.78 0.78\nKe 4.0 3.5 3.0\n\n"
        "newmtl floor\nKd 0.5 0.5 0.5\nmap_Kd checker.png\n")
    (directory / "tex.obj").write_text(
        "mtllib tex.mtl\n"
        "o floor\n"
        "v -2 0 -2\nv 2 0 -2\nv 2 0 2\nv -2 0 2\n"
        "vt 0 0\nvt 4 0\nvt 4 4\nvt 0 4\n"
        "vn 0 1 0\n"
        "usemtl floor\n"
        "f 1/1/1 3/3/1 2/2/1\nf 1/1/1 4/4/1 3/3/1\n"
        "o light\n"
        "v -1 3 -1\nv 1 3 -1\nv 1 3 1\nv -1 3 1\n"
        "vn 0 -1 0\n"
        "usemtl light\n"
        "f 5/1/2 6/2/2 7/3/2\nf 5/1/2 7/3/2 8/4/2\n")
    rtc = directory / "tex.rtc"
    rtc.write_text("tex.obj\nchecker.png\n3\n24 24\n"
                   "0 2.5 4.5\n0 0 0\n0 1 0\n1\n")
    return rtc


def write_whitted(directory, *, xres=24, yres=24):
    """The Cornell box with one rtc point light (Whitted mode)."""
    rtc = write_cornell(directory, xres=xres, yres=yres, depth=2)
    rtc.write_text(rtc.read_text() + "L 0 1.8 0.5 255 255 255 2.0\n")
    return rtc


@pytest.fixture
def cuda_device():
    """torch.device('cuda'), or skip: the kernels run only on a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")
