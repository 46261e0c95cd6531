"""Shared helpers of the tests/test_torch_*.py files: inline scenes written
to a temporary directory, the JAX -> PyTorch scene hand-over, and the
fixture that skips a test needing a CUDA device."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cornell_scenes import write_cornell
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
    cornell_scenes.write_cornell writes the box), with every other triangle
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


# --- G8 (kernel 11, csrc/bvh_g8.cu) modelled on the CPU -------------------

G8_THREADS = 32          # a warp: one shared node pointer
G8_WARPS = 4             # a block's
G8_ROWS = 4              # of a 128-row leaf, each thread's rows


def g8_walk_model(nodes, tri, orig, dirs, alive, *, any_hit: bool = False,
                  block_rays: int = 128, spread: bool = False):
    """Kernel 11's schedule in plain PyTorch: (t [N] f32, row [N] i32).

    A block lists its `block_rays` rays' live ones in order and walks them
    in groups behind one node pointer a group: of 32 lanes, or with
    `spread` of ceil(live / 4) lanes (at most 32), the list spread over the
    block's 4 warps (the launch's choice where it fits one wave; the last
    group's lanes past the list hold no ray). A lane takes part at the
    nodes from its `resume` on: where its own slab test of node p fails it
    resumes at skip[p]; the pointer descends where any lane passes. At a
    leaf each lane whose test passed is served in turn: thread j of 32
    tests rows j, j + 32, j + 64, j + 96 against it, keeping the strictly
    smaller t below the lane's best, and a butterfly (xor 16, 8, 4, 2, 1)
    merges the threads' bests by the least (t, row). Any hit: a lane
    settles at its first leaf with a hit; where no lane is at or past its
    resume the pointer jumps to the least resume. The slab test and the
    Woop test are the plain walk's (`_slab`, `woop_t`)."""
    from orion_tpu_torch.ops.bvh_intersect import unpack_nodes
    from orion_tpu_torch.ops.bvh_traverse import _slab
    from orion_tpu_torch.ops.woop import BIG, woop_t

    lo, hi, skip_t, start_t = unpack_nodes(nodes)
    skip, start = skip_t.tolist(), start_t.tolist()
    M, N = nodes.shape[0], orig.shape[0]
    w13 = tri[:, :13]
    lanes = torch.arange(G8_THREADS)
    cols = lanes[:, None] + G8_THREADS * torch.arange(G8_ROWS)[None, :]
    t_out = torch.full((N,), float("inf"), dtype=torch.float32)
    row_out = torch.full((N,), -1, dtype=torch.int32)
    for base in range(0, N, block_rays):
        live = base + torch.nonzero(alive[base:base + block_rays]).flatten()
        per = (min(G8_THREADS, -(-live.numel() // G8_WARPS)) if spread
               else G8_THREADS)
        for g in range(0, live.numel(), per):
            rays = live[g:g + per]
            n = rays.numel()
            o = torch.zeros((G8_THREADS, 3), dtype=torch.float32)
            d = torch.ones((G8_THREADS, 3), dtype=torch.float32)
            o[:n], d[:n] = orig[rays], dirs[rays]
            inv = 1.0 / d
            tb = torch.full((G8_THREADS,), BIG, dtype=torch.float32)
            rb = torch.full((G8_THREADS,), -1, dtype=torch.int64)
            resume = torch.where(lanes < n, 0, M)
            ptr = 0
            while ptr < M:
                active = resume <= ptr
                hit, tmin = _slab(o, inv, lo[ptr].expand(G8_THREADS, 3),
                                  hi[ptr].expand(G8_THREADS, 3))
                passed = active & hit & (tmin < tb)
                resume = torch.where(active & ~passed, skip[ptr], resume)
                if start[ptr] < 0:
                    ptr = ptr + 1 if bool(passed.any()) else skip[ptr]
                    continue
                rows = start[ptr] + cols                     # [32, 4]
                g13 = w13[rows]
                for src in torch.nonzero(passed).flatten().tolist():
                    t = woop_t(tuple(o[src, i] for i in range(3)),
                               tuple(d[src, i] for i in range(3)),
                               tuple(g13[:, :, i] for i in range(13)))
                    bt = tb[src].expand(G8_THREADS).clone()
                    br = torch.full((G8_THREADS,), -1, dtype=torch.int64)
                    for j in range(G8_ROWS):                 # in row order
                        upd = t[:, j] < bt
                        bt = torch.where(upd, t[:, j], bt)
                        br = torch.where(upd, rows[:, j], br)
                    x = 16
                    while x:
                        ot, orow = bt[lanes ^ x], br[lanes ^ x]
                        take = (ot < bt) | ((ot == bt) & (orow < br))
                        bt = torch.where(take, ot, bt)
                        br = torch.where(take, orow, br)
                        x >>= 1
                    assert bool((br == br[0]).all())     # every thread's
                    if int(br[0]) >= 0:
                        tb[src], rb[src] = bt[0], br[0]
                ptr = skip[ptr]
                if any_hit:
                    resume = torch.where(rb >= 0, M, resume)
                    if not bool((resume <= ptr).any()):
                        ptr = int(resume.min())
            hit = rb[:n] >= 0
            t_out[rays] = torch.where(
                hit, torch.ones_like(tb[:n]) if any_hit else tb[:n],
                torch.full_like(tb[:n], float("inf")))
            row_out[rays] = rb[:n].to(torch.int32)
    return t_out, row_out


def g8_tie_layout(nodes, tri, leaf: int = 128):
    """A copy of a leaf-`leaf` tree's (nodes, tri) full of ties: every
    node's box grown to the root's (a ray from inside the box then meets
    every leaf, t pruning aside), and in each pair of consecutive leaves
    (a, b) the rows a + k for k = 0, 4, ..., 124 copied to a + (k + 37) %
    leaf (the same leaf, another thread's rows, the copy sometimes the
    smaller row) and to b + k (the next leaf: the earlier leaf must
    win)."""
    from orion_tpu_torch.ops.bvh_intersect import unpack_nodes

    nodes, tri = nodes.clone(), tri.clone()
    nodes[:, 0:3] = nodes[0, 0:3].clone()
    nodes[:, 3:6] = nodes[0, 3:6].clone()
    start = unpack_nodes(nodes)[3]
    starts = sorted(int(s) for s in start[start >= 0].tolist())
    for a, b in zip(starts[::2], starts[1::2]):
        for k in range(0, leaf, 4):
            tri[a + (k + 37) % leaf] = tri[a + k]
            tri[b + k] = tri[a + k]
    return nodes, tri
