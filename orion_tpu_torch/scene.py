"""SoA scene representation: a frozen dataclass of torch tensors on one device.

The PyTorch counterpart of `orion_tpu.scene`. The reference's object graph
(TracedModel -> TracedMesh -> SBVH/Material, orion/model.hpp, mesh.hpp) is
flattened into structure-of-arrays over *triangles*, with integer tables
mapping triangles to meshes and materials.

Conventions (identical to the JAX package, field for field):
  - Triangles are stored as (v0, e1, e2) like the reference
    (geometry.hpp:64-69): e1 = v1 - v0, e2 = v2 - v0.
  - Triangle arrays are padded to a multiple of `pad_to` rows with
    degenerate triangles (e1 = e2 = 0 => Möller-Trumbore det = 0 => no hit).
  - Per-triangle surface areas use the correct 0.5*|cross(e1,e2)| formula
    (the reference's `abs(dot(e1,e2))*0.5`, geometry.hpp:155-157, is a bug;
    see PARITY.md).
  - One material per mesh (mesh id == material id), matching how the
    reference builds a TracedMesh per Assimp mesh (model.cpp:69-193).

All host-side construction is NumPy, exactly as in the JAX package; the
tensors are created once at the end on the requested device.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from orion_tpu_torch.io.image import load_texture
from orion_tpu_torch.io.obj import ObjScene, load_obj
from orion_tpu_torch.io.rtc import RTCData, parse_rtc

LANE = 128  # triangle padding granularity (kept equal to the JAX package's)

# tensor fields in declaration order; the four trailing ints are static
TENSOR_FIELDS = (
    "tri_v0", "tri_e1", "tri_e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
    "tri_mat", "tri_valid", "mesh_tri_start", "mesh_tri_count", "mesh_area",
    "mat_ambient", "mat_diffuse", "mat_specular", "mat_emissive",
    "mat_shininess", "mat_opacity", "mat_map_diffuse", "mat_map_specular",
    "mat_map_bump", "tex_atlas", "tex_off", "tex_hw", "emissive_mesh_ids",
    "light_pos", "light_color", "light_intensity")
STATIC_FIELDS = ("num_triangles", "num_meshes", "num_emissive", "num_lights")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Scene:
    """Flat SoA scene. Every field but the four trailing ints is a tensor.

    Shapes: T = padded triangle count, Nm = mesh count, M = material count
    (== Nm), E = emissive mesh count (>= 1 slot), L = point light count
    (>= 1 slot), I = texture image count (>= 1 slot).
    """

    # geometry (differentiable)
    tri_v0: torch.Tensor  # [T, 3]
    tri_e1: torch.Tensor  # [T, 3]
    tri_e2: torch.Tensor  # [T, 3]
    # per-corner shading attributes
    n0: torch.Tensor  # [T, 3]
    n1: torch.Tensor  # [T, 3]
    n2: torch.Tensor  # [T, 3]
    uv0: torch.Tensor  # [T, 2]
    uv1: torch.Tensor  # [T, 2]
    uv2: torch.Tensor  # [T, 2]
    # topology tables
    tri_mat: torch.Tensor   # [T] int32, material (== mesh) id; padding -> 0
    tri_valid: torch.Tensor  # [T] bool, False on padding rows
    mesh_tri_start: torch.Tensor  # [Nm] int32 (unpadded triangle index space)
    mesh_tri_count: torch.Tensor  # [Nm] int32
    mesh_area: torch.Tensor       # [Nm] float32 (correct areas)
    # materials (differentiable)
    mat_ambient: torch.Tensor    # [M, 3]
    mat_diffuse: torch.Tensor    # [M, 3]
    mat_specular: torch.Tensor   # [M, 3]
    mat_emissive: torch.Tensor   # [M, 3]
    mat_shininess: torch.Tensor  # [M]
    mat_opacity: torch.Tensor    # [M]
    # texture maps: -1 = use solid color
    mat_map_diffuse: torch.Tensor   # [M] int32
    mat_map_specular: torch.Tensor  # [M] int32
    mat_map_bump: torch.Tensor      # [M] int32 (tangent-space normal map)
    tex_atlas: torch.Tensor  # [AH, AW, 3] float32, shelf-packed texture atlas
    tex_off: torch.Tensor    # [I, 2] int32 (y0, x0) into the atlas
    tex_hw: torch.Tensor     # [I, 2] int32 (h, w)
    # emissive meshes (for NEE); padded with id -1
    emissive_mesh_ids: torch.Tensor  # [E] int32
    # point lights from the .rtc; padded with zero intensity
    light_pos: torch.Tensor        # [L, 3]
    light_color: torch.Tensor      # [L, 3]
    light_intensity: torch.Tensor  # [L]

    num_triangles: int = 0
    num_meshes: int = 0
    num_emissive: int = 0
    num_lights: int = 0

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    def numpy(self, name: str) -> np.ndarray:
        """Host copy of one tensor field."""
        return getattr(self, name).detach().cpu().numpy()


def scene_from_numpy(fields: dict, device) -> Scene:
    """Build a Scene from host arrays: {tensor field: array} plus the four
    static ints. This is how a scene crosses from another implementation
    (for example `{name: np.asarray(getattr(jax_scene, name))}`) so that
    two renderers see the identical scene."""
    kw = {name: torch.as_tensor(np.array(fields[name], order="C"),
                                device=device) for name in TENSOR_FIELDS}
    kw.update({name: int(fields[name]) for name in STATIC_FIELDS})
    return Scene(**kw)


def scene_to_numpy(scene: Scene) -> dict:
    """Inverse of scene_from_numpy."""
    out = {name: scene.numpy(name) for name in TENSOR_FIELDS}
    out.update({name: getattr(scene, name) for name in STATIC_FIELDS})
    return out


def pack_texture_atlas(tex_images):
    """Shelf-pack decoded textures into ONE [AH, AW, 3] atlas.

    Images sorted by height descend into rows of a fixed-width atlas
    (deterministic; the JAX package's layout, slot for slot).

    Returns (atlas [AH, AW, 3] f32, off [I, 2] (y0, x0) i32, hw [I, 2] i32).
    """
    if not tex_images:
        return (np.zeros((1, 1, 3), np.float32),
                np.zeros((1, 2), np.int32), np.ones((1, 2), np.int32))
    AW = max(t.shape[1] for t in tex_images)
    order = sorted(range(len(tex_images)),
                   key=lambda i: -tex_images[i].shape[0])
    I = len(tex_images)
    off = np.zeros((I, 2), np.int32)
    hw = np.zeros((I, 2), np.int32)
    y = x = shelf_h = 0
    for i in order:
        h, w = tex_images[i].shape[:2]
        if x + w > AW:
            y += shelf_h
            x = shelf_h = 0
        off[i] = (y, x)
        hw[i] = (h, w)
        x += w
        shelf_h = max(shelf_h, h)
    atlas = np.zeros((y + shelf_h, AW, 3), np.float32)
    for i, t in enumerate(tex_images):
        y0, x0 = off[i]
        atlas[y0:y0 + t.shape[0], x0:x0 + t.shape[1]] = t
    return atlas, off, hw


def _corner_vertices(mesh_positions: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    v0 = mesh_positions[:, 0, :]
    e1 = mesh_positions[:, 1, :] - v0
    e2 = mesh_positions[:, 2, :] - v0
    return v0, e1, e2


def triangle_areas(e1: np.ndarray, e2: np.ndarray) -> np.ndarray:
    """Correct triangle area: 0.5 * |e1 x e2| (fixes geometry.hpp:155-157)."""
    return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)


def build_scene(
    obj: ObjScene,
    rtc: Optional[RTCData] = None,
    pad_to: int = LANE,
    load_textures: bool = True,
    device="cuda",
) -> Scene:
    """Flatten an ObjScene (+ rtc lights) into a Scene on `device`."""
    meshes = obj.meshes
    if not meshes:
        raise ValueError("scene has no meshes")

    v0s, e1s, e2s, n0s, n1s, n2s, uv0s, uv1s, uv2s = [], [], [], [], [], [], [], [], []
    tri_mat: List[np.ndarray] = []
    mesh_tri_start, mesh_tri_count, mesh_area = [], [], []
    emissive_ids = []

    # texture registry (deduped by resolved path, like model.cpp:195-227)
    tex_paths: List[str] = []
    tex_images: List[np.ndarray] = []

    def register_texture(rel_path: Optional[str]) -> int:
        if not load_textures or rel_path is None:
            return -1
        p = obj.directory / rel_path
        key = str(p)
        if key in tex_paths:
            return tex_paths.index(key)
        if not p.exists():
            return -1
        tex_images.append(load_texture(p))
        tex_paths.append(key)
        return len(tex_paths) - 1

    mat_rows = dict(ambient=[], diffuse=[], specular=[], emissive=[],
                    shininess=[], opacity=[], map_diffuse=[], map_specular=[],
                    map_bump=[])

    t_cursor = 0
    for mesh_id, mesh in enumerate(meshes):
        F = mesh.num_triangles
        v0, e1, e2 = _corner_vertices(mesh.positions)
        v0s.append(v0); e1s.append(e1); e2s.append(e2)
        n0s.append(mesh.normals[:, 0]); n1s.append(mesh.normals[:, 1]); n2s.append(mesh.normals[:, 2])
        uv0s.append(mesh.uvs[:, 0]); uv1s.append(mesh.uvs[:, 1]); uv2s.append(mesh.uvs[:, 2])
        tri_mat.append(np.full(F, mesh_id, np.int32))
        mesh_tri_start.append(t_cursor)
        mesh_tri_count.append(F)
        mesh_area.append(float(np.sum(triangle_areas(e1, e2))))
        t_cursor += F

        m = mesh.material
        mat_rows["ambient"].append(m.ambient)
        mat_rows["diffuse"].append(m.diffuse)
        mat_rows["specular"].append(m.specular)
        mat_rows["emissive"].append(m.emissive)
        mat_rows["shininess"].append(m.shininess)
        mat_rows["opacity"].append(m.opacity)
        mat_rows["map_diffuse"].append(register_texture(m.map_diffuse))
        mat_rows["map_specular"].append(register_texture(m.map_specular))
        mat_rows["map_bump"].append(register_texture(m.map_bump))
        if m.is_emissive:
            emissive_ids.append(mesh_id)

    T = t_cursor
    T_pad = max(_round_up(T, pad_to), pad_to)

    def cat_pad(chunks, width):
        arr = np.concatenate(chunks, axis=0).astype(np.float32).reshape(T, width)
        out = np.zeros((T_pad, width), np.float32)
        out[:T] = arr
        return out

    tri_mat_arr = np.zeros(T_pad, np.int32)
    tri_mat_arr[:T] = np.concatenate(tri_mat)
    tri_valid = np.zeros(T_pad, bool)
    tri_valid[:T] = True

    atlas, off, hw = pack_texture_atlas(tex_images)

    num_emissive = len(emissive_ids)
    em_ids = np.full(max(num_emissive, 1), -1, np.int32)
    em_ids[:num_emissive] = emissive_ids

    lights = rtc.lights if rtc is not None else []
    num_lights = len(lights)
    Lp = max(num_lights, 1)
    light_pos = np.zeros((Lp, 3), np.float32)
    light_color = np.zeros((Lp, 3), np.float32)
    light_intensity = np.zeros(Lp, np.float32)
    for i, l in enumerate(lights):
        light_pos[i] = l.position
        light_color[i] = l.color
        light_intensity[i] = l.intensity

    return scene_from_numpy(dict(
        tri_v0=cat_pad(v0s, 3), tri_e1=cat_pad(e1s, 3), tri_e2=cat_pad(e2s, 3),
        n0=cat_pad(n0s, 3), n1=cat_pad(n1s, 3), n2=cat_pad(n2s, 3),
        uv0=cat_pad(uv0s, 2), uv1=cat_pad(uv1s, 2), uv2=cat_pad(uv2s, 2),
        tri_mat=tri_mat_arr, tri_valid=tri_valid,
        mesh_tri_start=np.array(mesh_tri_start, np.int32),
        mesh_tri_count=np.array(mesh_tri_count, np.int32),
        mesh_area=np.array(mesh_area, np.float32),
        mat_ambient=np.stack(mat_rows["ambient"]).astype(np.float32),
        mat_diffuse=np.stack(mat_rows["diffuse"]).astype(np.float32),
        mat_specular=np.stack(mat_rows["specular"]).astype(np.float32),
        mat_emissive=np.stack(mat_rows["emissive"]).astype(np.float32),
        mat_shininess=np.array(mat_rows["shininess"], np.float32),
        mat_opacity=np.array(mat_rows["opacity"], np.float32),
        mat_map_diffuse=np.array(mat_rows["map_diffuse"], np.int32),
        mat_map_specular=np.array(mat_rows["map_specular"], np.int32),
        mat_map_bump=np.array(mat_rows["map_bump"], np.int32),
        tex_atlas=atlas, tex_off=off, tex_hw=hw,
        emissive_mesh_ids=em_ids,
        light_pos=light_pos, light_color=light_color,
        light_intensity=light_intensity,
        num_triangles=T, num_meshes=len(meshes),
        num_emissive=num_emissive, num_lights=num_lights,
    ), device)


def subdivide_scene(scene: Scene, levels: int = 1,
                    skip_emissive: bool = True) -> Scene:
    """4-to-1 midpoint subdivision of every triangle: a geometrically
    IDENTICAL scene with 4^levels the triangle count.

    Corner normals/uvs are interpolated unnormalized at edge midpoints —
    barycentric interpolation over a child reproduces the parent's
    interpolant exactly. skip_emissive leaves emissive meshes
    unsubdivided so the NEE weight (triArea * triCount, mesh.hpp:178-184)
    and the fused kernel's per-emitter triangle table stay unchanged.
    Host NumPy arithmetic, the same as the JAX package's.
    """
    for _ in range(levels):
        T = scene.num_triangles
        em = set(int(i) for i in scene.numpy("emissive_mesh_ids")
                 if i >= 0) if skip_emissive else set()
        starts = scene.numpy("mesh_tri_start")
        counts = scene.numpy("mesh_tri_count")
        f = {k: scene.numpy(k)[:T].astype(np.float32)
             for k in ("tri_v0", "tri_e1", "tri_e2", "n0", "n1", "n2",
                       "uv0", "uv1", "uv2")}
        mat = scene.numpy("tri_mat")[:T]

        out = {k: [] for k in f}
        out_mat, new_starts, new_counts = [], [], []
        pos = 0
        for m in range(scene.num_meshes):
            s, c = int(starts[m]), int(counts[m])
            new_starts.append(pos)
            sl = slice(s, s + c)
            if m in em or c == 0:
                for k in f:
                    out[k].append(f[k][sl])
                out_mat.append(mat[sl])
                pos += c
                new_counts.append(c)
                continue
            v0, e1, e2 = f["tri_v0"][sl], f["tri_e1"][sl], f["tri_e2"][sl]
            # children in (corner a, corner b, corner c, center) order;
            # each stored as (v0', e1', e2') with e = half-edges
            ch_v0 = [v0, v0 + 0.5 * e1, v0 + 0.5 * e2, v0 + 0.5 * e1]
            ch_e1 = [0.5 * e1, 0.5 * e1, 0.5 * e1, 0.5 * e2]
            ch_e2 = [0.5 * e2, 0.5 * e2, 0.5 * e2, 0.5 * (e2 - e1)]
            for k, ch in (("tri_v0", ch_v0), ("tri_e1", ch_e1),
                          ("tri_e2", ch_e2)):
                out[k].append(np.stack(ch, 1).reshape(-1, 3))
            # corner attributes: a=corner0, b=corner1, c=corner2;
            # child corners follow the (v0', v0'+e1', v0'+e2') layout
            for base in ("n", "uv"):
                a = f[f"{base}0"][sl]
                b = f[f"{base}1"][sl]
                cc = f[f"{base}2"][sl]
                ab, ac, bc = (0.5 * (a + b), 0.5 * (a + cc),
                              0.5 * (b + cc))
                corners = [(a, ab, ac), (ab, b, bc), (ac, bc, cc),
                           (ab, bc, ac)]
                for ci in range(3):
                    out[f"{base}{ci}"].append(
                        np.stack([corners[ch][ci] for ch in range(4)],
                                 1).reshape(-1, a.shape[1]))
            out_mat.append(np.repeat(mat[sl], 4))
            pos += 4 * c
            new_counts.append(4 * c)

        new_T = pos
        T_pad = max(_round_up(new_T, LANE), LANE)

        def padded(chunks, width):
            a = np.concatenate(chunks, axis=0)
            full = np.zeros((T_pad, width), np.float32)
            full[:new_T] = a
            return full

        valid = np.zeros(T_pad, bool)
        valid[:new_T] = True
        mat_full = np.zeros(T_pad, np.int32)
        mat_full[:new_T] = np.concatenate(out_mat)
        fields = scene_to_numpy(scene)
        fields.update(
            tri_v0=padded(out["tri_v0"], 3),
            tri_e1=padded(out["tri_e1"], 3),
            tri_e2=padded(out["tri_e2"], 3),
            n0=padded(out["n0"], 3), n1=padded(out["n1"], 3),
            n2=padded(out["n2"], 3),
            uv0=padded(out["uv0"], 2), uv1=padded(out["uv1"], 2),
            uv2=padded(out["uv2"], 2),
            tri_mat=mat_full, tri_valid=valid,
            mesh_tri_start=np.array(new_starts, np.int32),
            mesh_tri_count=np.array(new_counts, np.int32),
            num_triangles=new_T)
        scene = scene_from_numpy(fields, scene.device)
    return scene


def load_scene(rtc_path: str | Path, pad_to: int = LANE,
               load_textures: bool = True,
               device="cuda") -> Tuple[Scene, RTCData]:
    """Parse an .rtc file and load its OBJ scene onto `device`
    (traceRTC's setup phase, raytracer.cpp:19-41)."""
    rtc_path = Path(rtc_path)
    rtc = parse_rtc(rtc_path)
    obj_path = rtc_path.parent / rtc.obj_file
    obj = load_obj(obj_path)
    scene = build_scene(obj, rtc, pad_to=pad_to, load_textures=load_textures,
                        device=device)
    return scene, rtc
