"""Wavefront OBJ/MTL loader (host-side, NumPy).

Replaces the reference's Assimp import path
(orion/model.cpp:19-44) with a from-scratch loader covering
the feature set the bundled assets use: `v`, `vn`, `vt`, `f` (all index
forms, negative indices, quad/ngon fan triangulation), `g`/`o` mesh
grouping, `usemtl`, `mtllib`, `s` (ignored); MTL `newmtl`, `Ka`, `Kd`, `Ks`,
`Ke`, `Ns`, `Ni`, `d`, `illum`, `map_Kd`, `map_Ks`, `map_bump`/`bump`.

Postprocessing mirrors the reference's Assimp flags (model.cpp:23-29):
  - Triangulate: ngons are fan-triangulated.
  - GenNormals: faces without `vn` get flat geometric normals.
  - FlipUVs: texture v coordinate is flipped (v -> 1 - v).
  - JoinIdenticalVertices: implicit — we keep per-corner attributes directly
    in SoA form, so vertex identity never matters downstream.

A *mesh* is a run of faces sharing one material, split at `g`/`o` statements
and at material changes — matching how Assimp splits OBJ scenes into
per-material aiMesh objects, which is what the reference's emissive-mesh NEE
and per-mesh surface areas key off (model.cpp:47-67).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class MTLMaterial:
    """One MTL material. Defaults match Assimp's for absent keys."""

    name: str = ""
    ambient: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    diffuse: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    specular: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    emissive: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    shininess: float = 0.0
    opacity: float = 1.0
    ior: float = 1.0
    illum: int = 2
    map_diffuse: Optional[str] = None   # path relative to the mtl file
    map_specular: Optional[str] = None
    map_bump: Optional[str] = None

    @property
    def is_emissive(self) -> bool:
        # reference: Ke != 0 on any channel (material.hpp:126-128)
        return bool(np.any(self.emissive != 0.0))


@dataclasses.dataclass
class ObjMesh:
    """One per-material triangle mesh, SoA per-corner attributes.

    Arrays are [F, 3, ...]: F triangles, 3 corners each.
    """

    name: str
    material: MTLMaterial
    positions: np.ndarray  # [F, 3, 3] float32
    normals: np.ndarray    # [F, 3, 3] float32 (flat face normals if absent)
    uvs: np.ndarray        # [F, 3, 2] float32 (zeros if absent; v flipped)

    @property
    def num_triangles(self) -> int:
        return self.positions.shape[0]


@dataclasses.dataclass
class ObjScene:
    meshes: List[ObjMesh]
    materials: Dict[str, MTLMaterial]
    directory: Path  # directory of the obj file — texture paths resolve here


def parse_mtl(path: Path) -> Dict[str, MTLMaterial]:
    """Parse a .mtl file into a name -> material dict."""
    materials: Dict[str, MTLMaterial] = {}
    cur: Optional[MTLMaterial] = None
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            key = toks[0]
            if key == "newmtl":
                cur = MTLMaterial(name=" ".join(toks[1:]))
                materials[cur.name] = cur
            elif cur is None:
                continue
            elif key == "Ka":
                cur.ambient = np.array([float(x) for x in toks[1:4]], np.float32)
            elif key == "Kd":
                cur.diffuse = np.array([float(x) for x in toks[1:4]], np.float32)
            elif key == "Ks":
                cur.specular = np.array([float(x) for x in toks[1:4]], np.float32)
            elif key == "Ke":
                cur.emissive = np.array([float(x) for x in toks[1:4]], np.float32)
            elif key == "Ns":
                cur.shininess = float(toks[1])
            elif key == "Ni":
                cur.ior = float(toks[1])
            elif key == "d":
                cur.opacity = float(toks[1])
            elif key == "Tr":
                cur.opacity = 1.0 - float(toks[1])
            elif key == "illum":
                cur.illum = int(float(toks[1]))
            elif key == "map_Kd":
                cur.map_diffuse = toks[-1]
            elif key == "map_Ks":
                cur.map_specular = toks[-1]
            elif key in ("map_bump", "bump", "map_Bump"):
                cur.map_bump = toks[-1]
            # everything else ignored
    return materials


def _resolve_index(idx: int, n: int) -> int:
    """OBJ indices are 1-based; negative counts from the end."""
    return idx - 1 if idx > 0 else n + idx


def _parse_corner(token: str) -> tuple:
    """Parse `v`, `v/vt`, `v//vn`, or `v/vt/vn` into (vi, ti, ni) raw ints (None if absent)."""
    parts = token.split("/")
    vi = int(parts[0])
    ti = int(parts[1]) if len(parts) > 1 and parts[1] else None
    ni = int(parts[2]) if len(parts) > 2 and parts[2] else None
    return vi, ti, ni


def load_obj(path: str | Path, parser: str = "python") -> ObjScene:
    """Load an OBJ file (and its MTL libraries) into per-material meshes.

    Only the Python tokenizer exists here (parser="python"); the native
    ctypes tokenizer of the JAX package is not ported yet.
    """
    if parser != "python":
        raise NotImplementedError(
            f"OBJ parser {parser!r} is not ported; use parser='python'")
    path = Path(path)
    directory = path.parent

    positions: List[List[float]] = []
    texcoords: List[List[float]] = []
    normals: List[List[float]] = []
    materials: Dict[str, MTLMaterial] = {}

    default_mat = MTLMaterial(name="<default>")

    # accumulated per-mesh face corner data
    meshes: List[ObjMesh] = []
    cur_group = "default"
    cur_mat: MTLMaterial = default_mat
    cur_faces: List[List[tuple]] = []  # list of triangles, each 3 corners of (vi, ti, ni)

    def flush():
        nonlocal cur_faces
        if not cur_faces:
            return
        F = len(cur_faces)
        pos = np.zeros((F, 3, 3), np.float32)
        uv = np.zeros((F, 3, 2), np.float32)
        nrm = np.zeros((F, 3, 3), np.float32)
        any_uv = False
        for fi, tri in enumerate(cur_faces):
            has_n = all(c[2] is not None for c in tri)
            for ci, (vi, ti, ni) in enumerate(tri):
                pos[fi, ci] = positions[vi]
                if ti is not None:
                    u, v = texcoords[ti][0], texcoords[ti][1]
                    uv[fi, ci] = (u, 1.0 - v)  # FlipUVs (model.cpp:28)
                    any_uv = True
                if has_n:
                    nrm[fi, ci] = normals[ni]
            if not has_n:
                # GenNormals: flat geometric normal, normalized
                e1 = pos[fi, 1] - pos[fi, 0]
                e2 = pos[fi, 2] - pos[fi, 0]
                n = np.cross(e1, e2)
                ln = np.linalg.norm(n)
                if ln > 0:
                    n = n / ln
                nrm[fi, 0] = nrm[fi, 1] = nrm[fi, 2] = n
        if not any_uv:
            uv[:] = 0.0
        meshes.append(ObjMesh(name=cur_group, material=cur_mat, positions=pos, normals=nrm, uvs=uv))
        cur_faces = []

    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            key = toks[0]
            if key == "v":
                positions.append([float(x) for x in toks[1:4]])
            elif key == "vt":
                uv = [float(x) for x in toks[1:3]]
                if len(uv) == 1:
                    uv.append(0.0)
                texcoords.append(uv)
            elif key == "vn":
                normals.append([float(x) for x in toks[1:4]])
            elif key in ("g", "o"):
                flush()
                cur_group = " ".join(toks[1:]) if len(toks) > 1 else "default"
            elif key == "usemtl":
                name = " ".join(toks[1:])
                new_mat = materials.get(name)
                if new_mat is None:
                    new_mat = MTLMaterial(name=name)
                    materials[name] = new_mat
                if new_mat is not cur_mat:
                    flush()
                    cur_mat = new_mat
            elif key == "mtllib":
                for mtl_name in toks[1:]:
                    mtl_path = directory / mtl_name
                    if mtl_path.exists():
                        materials.update(parse_mtl(mtl_path))
            elif key == "f":
                corners = [_parse_corner(t) for t in toks[1:]]
                resolved = []
                for vi, ti, ni in corners:
                    rv = _resolve_index(vi, len(positions))
                    rt = _resolve_index(ti, len(texcoords)) if ti is not None else None
                    rn = _resolve_index(ni, len(normals)) if ni is not None else None
                    resolved.append((rv, rt, rn))
                # fan triangulation (Triangulate, model.cpp:27)
                for i in range(1, len(resolved) - 1):
                    cur_faces.append([resolved[0], resolved[i], resolved[i + 1]])
            # s / l / p and others: ignored
    flush()
    # drop empty meshes
    meshes = [m for m in meshes if m.num_triangles > 0]
    return ObjScene(meshes=meshes, materials=materials, directory=directory)
