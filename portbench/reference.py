"""The plain reference of the benchmark: the path and Whitted tracers in
plain PyTorch.

It reads the scene files the benchmark wrote (its own .rtc/.obj/.mtl
parser), builds its own camera, Woop rows and tree, and traces each
(pixel, sample) path as a lane of its own: no regeneration, no kernels, no
table or tree of the program. It imports nothing of the program.

The estimator is the one the path kernels document (ops/fused_path.py):
PCG4D-jittered primary rays, nearest hits by the Woop unit-triangle test,
depth-0 emission, next-event estimation over every emissive mesh with
`light_samples` draws each, Russian roulette on max(kd), a cosine bounce.
The random numbers are the PCG4D hashes of (pixel, sample * 131071 +
depth, site, seed), so a path here and the same path in a kernel draw the
same numbers whatever order the kernel runs them in. Next-event
visibility asks whether the nearest hit below NEE_T_CAP lies on the
sampled emissive mesh; on the Cornell box, whose emitters are flat and
carry one normal, this equals the "legacy" form the training kernels use
(light normal and emitted colour read at the shadow winner) value for
value. The frozen copies of the program's arithmetic (`pcg4d`, the camera,
the Woop rows and test, the cosine bounce) each name their origin.

The Whitted estimator (`WhittedTracer`, for scenes with rtc point lights)
follows raytracer.cpp:195-207 and material.hpp:72-93 as the Whitted
kernel documents them (ops/whitted.py): the same PCG4D-jittered primary
rays, the nearest hit, depth-0 emission scaled by mesh area, one shadow
test per point light in which ANY hit at any t >= 0 blocks (even geometry
beyond the light), Phong ambient + diffuse + specular x colour x
intensity / d^2 with C's pow(0, 0) = 1, and the mirror continuation
scaled by Ks, a path ending where its throughput is zero.

`dtype` selects the precision of every floating-point operation: float32,
the configurations' stated precision, or bfloat16 for the control.

Counts: `Counts` adds, for each kind of segment ("nearest", "shadow"), the
segments traced, the slab tests and the triangle tests a nearest-hit
search over this reference's structure makes: a brute sweep tests every
triangle; the tree walk (`RefTree`) counts its node visits and the real
triangles of the leaves it enters. Shadow segments are counted only where
the geometry term is positive, the ones any correct estimator must trace.
A Whitted shadow test stops at its first hit, in the order of the scene
file's triangles.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

M32 = 0xFFFFFFFF
BIG = 3.0e38            # a miss's t (ops/woop.py)
MT_EPS = 1e-6           # the reference renderer's determinant epsilon
WOOP_DEGEN = 1e-12
BIAS = 1e-3             # ray-origin offset (raytracer.cpp:118)
NEE_T_CAP = 1.05        # shadow segment cap; the light point lies at t == 1


# ---------------------------------------------------------------------------
# scene files
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RefScene:
    """Triangles, materials and camera of an .rtc scene, as host arrays."""

    v0: np.ndarray          # [T, 3] float32
    e1: np.ndarray
    e2: np.ndarray
    n0: np.ndarray          # [T, 3] float32 corner normals
    n1: np.ndarray
    n2: np.ndarray
    mesh: np.ndarray        # [T] int64 mesh (== material) id
    mesh_area: np.ndarray   # [M] float32
    kd: np.ndarray          # [M, 3] float32
    ke: np.ndarray          # [M, 3] float32
    ka: np.ndarray          # [M, 3] float32
    ks: np.ndarray          # [M, 3] float32
    ns: np.ndarray          # [M] float32 Phong exponent
    mesh_names: list
    emitters: list          # [(mesh id, first triangle, count)]
    xres: int
    yres: int
    depth: int
    view_point: tuple
    look_at: tuple
    vector_up: tuple
    y_view: float
    lights: list            # [(position, colour / 255, intensity)]

    @property
    def num_triangles(self) -> int:
        return int(self.v0.shape[0])


def _data_lines(path: Path):
    for raw in path.read_text().splitlines():
        line = raw.strip()
        if line and not line.startswith("#"):
            yield line


# the material keys read, and their values where a material lacks them
MTL_DEFAULTS = {"Kd": (0.0, 0.0, 0.0), "Ke": (0.0, 0.0, 0.0),
                "Ka": (0.0, 0.0, 0.0), "Ks": (0.0, 0.0, 0.0), "Ns": 0.0}


def _parse_mtl(path: Path) -> dict:
    mats, cur = {}, None
    for line in _data_lines(path):
        tok = line.split()
        if tok[0] == "newmtl":
            cur = mats.setdefault(tok[1], dict(MTL_DEFAULTS))
        elif cur is None or tok[0] not in MTL_DEFAULTS:
            continue
        elif tok[0] == "Ns":
            cur["Ns"] = float(tok[1])
        else:
            cur[tok[0]] = tuple(float(x) for x in tok[1:4])
    return mats


def load_scene(rtc_path) -> RefScene:
    """Parse the .rtc and the .obj/.mtl it names. A mesh is a run of faces
    of one `o` group and one material; faces are triangles with `v//vn`
    or `v/vt/vn` corners; a material's absent keys are MTL_DEFAULTS'. The
    .rtc's lines after the eighth are point lights `L x y z r g b
    intensity`, the colour given in 0..255."""
    rtc_path = Path(rtc_path)
    lines = list(_data_lines(rtc_path))
    vec = [tuple(float(x) for x in lines[k].split()[:3]) for k in (4, 5, 6)]
    xres, yres = (int(x) for x in lines[3].split()[:2])
    obj_path = rtc_path.parent / lines[0]
    mats = {}
    pos, nrm = [], []
    meshes = []                      # [name, material, [corner triples]]
    cur_name, cur_mat = "default", None
    for line in _data_lines(obj_path):
        tok = line.split()
        key = tok[0]
        if key == "mtllib":
            mats.update(_parse_mtl(obj_path.parent / tok[1]))
        elif key == "v":
            pos.append([float(x) for x in tok[1:4]])
        elif key == "vn":
            nrm.append([float(x) for x in tok[1:4]])
        elif key in ("o", "g"):
            cur_name = tok[1] if len(tok) > 1 else "default"
            cur_mat = None
        elif key == "usemtl":
            cur_mat = tok[1]
        elif key == "f":
            corners = []
            for c in tok[1:4]:
                parts = c.split("/")
                corners.append((int(parts[0]) - 1, int(parts[2]) - 1))
            if not meshes or meshes[-1][0] != cur_name \
                    or meshes[-1][1] != cur_mat:
                meshes.append([cur_name, cur_mat, []])
            meshes[-1][2].append(corners)
    pos = np.asarray(pos, np.float32)
    nrm = np.asarray(nrm, np.float32)
    v0s, e1s, e2s, ns, mesh_ids, areas, names = ([] for _ in range(7))
    props_of = []
    emitters, first = [], 0
    for m, (name, mat, faces) in enumerate(meshes):
        f = np.asarray(faces, np.int64)                     # [F, 3, 2]
        p = pos[f[:, :, 0]]                                 # [F, 3, 3]
        v0, e1, e2 = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
        v0s.append(v0), e1s.append(e1), e2s.append(e2)
        ns.append(nrm[f[:, :, 1]])
        mesh_ids.append(np.full(len(f), m, np.int64))
        areas.append(float(np.sum(0.5 * np.linalg.norm(np.cross(e1, e2),
                                                        axis=1))))
        props = mats[mat]
        props_of.append(props), names.append(name)
        if any(x != 0.0 for x in props["Ke"]):
            emitters.append((m, first, len(f)))
        first += len(f)
    n = np.concatenate(ns)

    def column(key):
        return np.asarray([p[key] for p in props_of], np.float32)

    lights = []
    for line in lines[8:]:
        tok = line.split()
        at, col = (tuple(float(x) for x in tok[k:k + 3]) for k in (1, 4))
        lights.append((at, tuple(c / 255.0 for c in col), float(tok[7])))
    return RefScene(
        v0=np.concatenate(v0s), e1=np.concatenate(e1s),
        e2=np.concatenate(e2s), n0=n[:, 0].copy(), n1=n[:, 1].copy(),
        n2=n[:, 2].copy(), mesh=np.concatenate(mesh_ids),
        mesh_area=np.asarray(areas, np.float32),
        kd=column("Kd"), ke=column("Ke"), ka=column("Ka"), ks=column("Ks"),
        ns=column("Ns"), mesh_names=names, emitters=emitters, xres=xres,
        yres=yres, depth=int(lines[2].split()[0]), view_point=vec[0],
        look_at=vec[1], vector_up=vec[2], y_view=float(lines[7].split()[0]),
        lights=lights)


def camera_vec(sc: RefScene) -> torch.Tensor:
    """[12] float32 origin | front | right | up, computed in float32 as
    the reference renderer's camera (a copy of camera.camera_from_rtc)."""
    f32 = dict(dtype=torch.float32)
    vp = torch.tensor(sc.view_point, **f32)
    front = torch.tensor(sc.look_at, **f32) - vp
    up = torch.tensor(sc.vector_up, **f32)
    up = up - front * (torch.dot(front, up) / torch.dot(front, front))
    up = up / torch.linalg.norm(up)
    front = front / torch.linalg.norm(front)
    right = torch.linalg.cross(front, up)
    up = up * torch.tensor(sc.y_view * 0.5, **f32)
    right = right * torch.tensor(sc.y_view * (sc.xres / sc.yres) * 0.5, **f32)
    return torch.cat([vp, front, right, up])


def woop_rows(v0, e1, e2) -> np.ndarray:
    """[T, 13] float32 Woop rows (M row-major, c, |n|^2), computed in
    float64 (a copy of ops/woop.woop_rows_np)."""
    v0, e1, e2 = (np.asarray(x, np.float64) for x in (v0, e1, e2))
    n = np.cross(e1, e2)
    n2 = np.sum(n * n, axis=1, keepdims=True)
    ok = n2 > WOOP_DEGEN
    safe = np.where(ok, n2, 1.0)
    mu, mv, mw = np.cross(e2, n) / safe, np.cross(n, e1) / safe, n / safe
    m = np.where(ok, np.concatenate([mu, mv, mw], axis=1), 0.0)
    c = -np.stack([np.sum(mu * v0, axis=1), np.sum(mv * v0, axis=1),
                   np.sum(mw * v0, axis=1)], axis=1)
    c = np.where(ok, c, np.asarray([0.0, 0.0, 1.0]))
    n2 = np.where(ok, n2, 0.0)
    return np.concatenate([m, c, n2], axis=1).astype(np.float32)


def woop_tuv(o, d, w):
    """Masked (t, u, v) of rays (o, d) against Woop rows w: 3-tuples and a
    13-tuple of broadcastable tensors (a copy of ops/woop.woop_tuv)."""
    ou = w[0] * o[0] + w[1] * o[1] + w[2] * o[2] + w[9]
    ov = w[3] * o[0] + w[4] * o[1] + w[5] * o[2] + w[10]
    ow = w[6] * o[0] + w[7] * o[1] + w[8] * o[2] + w[11]
    du = w[0] * d[0] + w[1] * d[1] + w[2] * d[2]
    dv = w[3] * d[0] + w[4] * d[1] + w[5] * d[2]
    dw = w[6] * d[0] + w[7] * d[1] + w[8] * d[2]
    t = -ow / dw
    u = ou + t * du
    v = ov + t * dv
    ok = ((torch.abs(dw) * w[12] > MT_EPS) & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0))
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return (torch.where(ok, t, torch.full((), BIG, dtype=t.dtype,
                                          device=t.device)),
            torch.where(ok, u, zero), torch.where(ok, v, zero))


# ---------------------------------------------------------------------------
# nearest-hit searches and their counts
# ---------------------------------------------------------------------------

class Counts:
    """Segments and tests by kind of segment ("nearest", "shadow")."""

    def __init__(self):
        self.by_kind = {}

    def add(self, kind: str, segments: int, box: int, tri: int) -> None:
        c = self.by_kind.setdefault(kind, {"segments": 0, "box": 0,
                                           "tri": 0})
        c["segments"] += int(segments)
        c["box"] += int(box)
        c["tri"] += int(tri)

    def scaled(self, factor: float) -> dict:
        return {k: {q: v * factor for q, v in c.items()}
                for k, c in self.by_kind.items()}


class Brute:
    """Nearest hit by testing every triangle: (t, tri) with tri -1 for no
    hit below `cap`; ties go to the lower triangle index."""

    def __init__(self, rows: torch.Tensor, budget: int = 1 << 24):
        self.rows = rows
        self.budget = budget

    def __call__(self, o, d, cap, counts=None, kind="nearest"):
        n, T = o.shape[0], self.rows.shape[0]
        t_out = torch.full((n,), BIG, dtype=o.dtype, device=o.device)
        tri_out = torch.full((n,), -1, dtype=torch.int64, device=o.device)
        w = tuple(self.rows[None, :, i] for i in range(13))
        step = max(1, self.budget // max(T, 1))
        for s in range(0, n, step):
            oo = tuple(o[s:s + step, i, None] for i in range(3))
            dd = tuple(d[s:s + step, i, None] for i in range(3))
            t = woop_tuv(oo, dd, w)[0]
            row = torch.argmin(t, dim=1)
            tmin = torch.gather(t, 1, row[:, None])[:, 0]
            hit = tmin < cap
            t_out[s:s + step] = torch.where(hit, tmin, t_out[s:s + step])
            tri_out[s:s + step] = torch.where(hit, row, tri_out[s:s + step])
        if counts is not None:
            counts.add(kind, n, 0, n * T)
        return t_out, tri_out


def _slab(o, inv, lo, hi):
    """Ray-box test: hit iff tmax >= tmin and tmax > 0; fmin/fmax drop a
    NaN operand (a ray in the plane of a flat box)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
    tmin = torch.fmax(torch.fmax(near[:, 0], near[:, 1]), near[:, 2])
    tmax = torch.fmin(torch.fmin(far[:, 0], far[:, 1]), far[:, 2])
    return (tmax >= tmin) & (tmax > 0.0), tmin


def build_tree(v0, e1, e2, leaf: int = 2):
    """Binary tree over the triangles by object-median splits along the
    longest axis of the centroids' bounds, leaves of at most `leaf`
    triangles. Returns (lo [M,3], hi [M,3], left [M], right [M], axis [M],
    leaf_tris [M, leaf]) with nodes in breadth-first order (parents before
    children), left the lower half along `axis`, -1 where absent."""
    p = np.stack([v0, v0 + e1, v0 + e2], axis=1).astype(np.float64)
    tlo, thi = p.min(axis=1), p.max(axis=1)
    cen = 0.5 * (tlo + thi)
    T = len(v0)
    cap = 2 * T + 1
    lo = np.zeros((cap, 3))
    hi = np.zeros((cap, 3))
    left = np.full(cap, -1, np.int64)
    right = np.full(cap, -1, np.int64)
    axis = np.zeros(cap, np.int64)
    leaf_tris = np.full((cap, leaf), -1, np.int64)
    order = np.arange(T)
    queue = [(0, 0, T)]
    count = 1
    head = 0
    while head < len(queue):
        node, a, b = queue[head]
        head += 1
        ids = order[a:b]
        lo[node], hi[node] = tlo[ids].min(axis=0), thi[ids].max(axis=0)
        if b - a <= leaf:
            leaf_tris[node, :b - a] = np.sort(ids)
            continue
        c = cen[ids]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = (b - a) // 2
        part = np.argpartition(c[:, ax], mid, kind="introselect")
        order[a:b] = ids[part]
        axis[node] = ax
        left[node], right[node] = count, count + 1
        queue += [(count, a, a + mid), (count + 1, a + mid, b)]
        count += 2
    return (lo[:count].astype(np.float32), hi[:count].astype(np.float32),
            left[:count], right[:count], axis[:count], leaf_tris[:count])


def flatten(tree, signs):
    """Depth-first order of the tree for rays whose direction has the
    given signs (+1 / -1 per axis): at each node the child on the ray's
    near side goes first. Returns (lo, hi, skip, leaf_tris) in that order,
    skip[k] the position after node k's subtree."""
    lo, hi, left, right, axis, leaf_tris = tree
    M = len(lo)
    size = np.ones(M, np.int64)
    for k in range(M - 1, -1, -1):              # children follow parents
        if left[k] >= 0:
            size[k] += size[left[k]] + size[right[k]]
    pos = np.zeros(M, np.int64)
    neg = np.asarray(signs)[axis] < 0
    first = np.where(neg, right, left)
    second = np.where(neg, left, right)
    for k in range(M):
        if left[k] >= 0:
            pos[first[k]] = pos[k] + 1
            pos[second[k]] = pos[k] + 1 + size[first[k]]
    out_lo = np.empty_like(lo)
    out_hi = np.empty_like(hi)
    out_leaf = np.empty_like(leaf_tris)
    out_lo[pos], out_hi[pos], out_leaf[pos] = lo, hi, leaf_tris
    skip = np.empty(M, np.int64)
    skip[pos] = pos + size
    return out_lo, out_hi, skip, out_leaf


class RefTree:
    """Nearest hit by a skip-pointer walk over this reference's own tree,
    one depth-first flattening per direction octant (the near child
    first). Same (t, tri) as `Brute`: the Woop test of each pair, min t,
    ties to the lower triangle index."""

    COMPACT = 8

    def __init__(self, sc: RefScene, rows: torch.Tensor, leaf: int = 2):
        dev = rows.device
        tree = build_tree(sc.v0, sc.e1, sc.e2, leaf)
        self.M = len(tree[0])
        parts = [flatten(tree, [(-1.0 if (o >> a) & 1 else 1.0)
                                for a in range(3)]) for o in range(8)]
        off = [k * self.M for k in range(8)]
        self.lo = torch.as_tensor(np.concatenate([p[0] for p in parts]),
                                  device=dev).to(rows.dtype)
        self.hi = torch.as_tensor(np.concatenate([p[1] for p in parts]),
                                  device=dev).to(rows.dtype)
        self.skip = torch.as_tensor(
            np.concatenate([p[2] + o for p, o in zip(parts, off)]),
            device=dev)
        self.leaf_tris = torch.as_tensor(
            np.concatenate([p[3] for p in parts]), device=dev)
        self.rows = rows

    def __call__(self, o, d, cap, counts=None, kind="nearest"):
        n, dev = o.shape[0], o.device
        octant = ((d[:, 0] < 0).long() + 2 * (d[:, 1] < 0).long()
                  + 4 * (d[:, 2] < 0).long())
        ptr = octant * self.M
        end = ptr + self.M
        inv = 1.0 / d
        t_best = torch.full((n,), cap, dtype=o.dtype, device=dev)
        tri_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
        box = torch.zeros((), dtype=torch.int64, device=dev)
        tri = torch.zeros((), dtype=torch.int64, device=dev)
        # lanes still walking, compacted every COMPACT steps (a lane that
        # ends in between is masked, so the loop syncs with the host once
        # every COMPACT steps)
        idx = torch.arange(n, device=dev)
        step = 0
        while idx.numel():
            oo, dd, ii, ee = o[idx], d[idx], inv[idx], end[idx]
            for _ in range(self.COMPACT):
                pi = ptr[idx]
                live = pi < ee
                p = torch.minimum(pi, ee - 1)
                hit, tmin = _slab(oo, ii, self.lo[p], self.hi[p])
                tb, rb = t_best[idx], tri_best[idx]
                hit = hit & (tmin <= tb) & live
                box += live.sum()
                lt = self.leaf_tris[p]
                is_leaf = lt[:, 0] >= 0
                at_leaf = hit & is_leaf
                for k in range(lt.shape[1]):
                    tid = lt[:, k]
                    test = at_leaf & (tid >= 0)
                    tri += test.sum()
                    g = self.rows[tid.clamp(min=0)]
                    t = woop_tuv(oo.unbind(1), dd.unbind(1), g.unbind(1))[0]
                    upd = test & (t < cap) & ((t < tb) | ((t == tb)
                                                          & (tid < rb)))
                    tb = torch.where(upd, t, tb)
                    rb = torch.where(upd, tid, rb)
                t_best[idx], tri_best[idx] = tb, rb
                nxt = torch.where(hit & ~is_leaf, p + 1, self.skip[p])
                ptr[idx] = torch.where(live, nxt, pi)
                step += 1
            keep = ptr[idx] < ee
            idx = idx[keep]
        if counts is not None:
            counts.add(kind, n, int(box), int(tri))
        miss = tri_best < 0
        return torch.where(miss, torch.full_like(t_best, BIG), t_best), \
            tri_best


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------

def _mul32(x, y):
    lo = (x & 0xFFFF) * y
    hi = (((x >> 16) * y) & 0xFFFF) << 16
    return (lo + hi) & M32


def pcg4d(a, b, c, d):
    """PCG4D hash (Jarzynski & Olano, JCGT 2020) on uint32 values held in
    int64 tensors (a copy of ops/fused_path._pcg4d)."""
    a, b, c, d = (x & M32 for x in (a, b, c, d))
    a = (_mul32(a, 1664525) + 1013904223) & M32
    b = (_mul32(b, 1664525) + 1013904223) & M32
    c = (_mul32(c, 1664525) + 1013904223) & M32
    d = (_mul32(d, 1664525) + 1013904223) & M32
    for shift in (True, False):
        a = (a + _mul32(b, d)) & M32
        b = (b + _mul32(c, a)) & M32
        c = (c + _mul32(a, b)) & M32
        d = (d + _mul32(b, c)) & M32
        if shift:
            a, b, c, d = (x ^ (x >> 16) for x in (a, b, c, d))
    return a, b, c, d


def u01(bits, dtype):
    """Uniform [0, 1) from the low 24 bits."""
    return ((bits & 0xFFFFFF).to(torch.float32)
            * (1.0 / 16777216.0)).to(dtype)


def _norm(v):
    return v * torch.rsqrt(torch.clamp((v * v).sum(dim=1, keepdim=True),
                                       min=1e-20))


def primary_rays(cam, pix, samp, seed_t, W: int, H: int):
    """(o, d) [n, 3] of the camera rays of pixels `pix`, samples `samp`,
    PCG seeds `seed_t` (int64 tensors): one PCG4D jitter a sample shared
    by every pixel, in float32 (a copy of ops/fused_path._pixel_base,
    _sample_jitter and _camera_rays)."""
    f32 = torch.float32
    jb0, jb1, _, _ = pcg4d(samp, seed_t, torch.full_like(samp, 0x4A17),
                           torch.full_like(samp, 0x7E57))
    jx = u01(jb0, f32) * torch.tensor(np.float32(2.0 / W))
    jy = u01(jb1, f32) * torch.tensor(np.float32(2.0 / H))
    pf = pix.to(f32)
    inv_w = torch.tensor(np.float32(1.0 / W))
    inv_h = torch.tensor(np.float32(1.0 / H))
    row = torch.floor((pf + 0.5) * inv_w)
    col = pf - row * float(W)
    x = 2.0 * (col * inv_w) - 1.0 + jx
    y = -(2.0 * (row * inv_h) - 1.0 + jy)
    cam = cam.to(pix.device)
    d = torch.stack([cam[3 + k] + x * cam[6 + k] + y * cam[9 + k]
                     for k in range(3)], dim=1)
    return cam[:3].expand(d.shape), d


def cosine_bounce(sn, u1, u2):
    """Cosine-weighted direction about the unit normal sn: tangent from
    cross(n, (0, 1, 0)), else cross(n, (0, 0, 1)) (a copy of
    ops/fused_path._cosine_bounce)."""
    snx, sny, snz = sn.unbind(1)
    zero = torch.zeros_like(snx)
    sin_th = torch.sqrt(u1)
    cos_th = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    psi = u2 * torch.tensor(np.float32(2.0 * np.pi), dtype=u2.dtype,
                            device=u2.device)
    t1x, t1y, t1z = snz, zero, -snx
    deg = (t1x * t1x + t1z * t1z) == 0.0
    t1 = torch.stack([torch.where(deg, -sny, t1x), torch.where(deg, snx, t1y),
                      t1z], dim=1)
    t1 = _norm(t1)
    bt = torch.linalg.cross(sn, t1)
    ca = (sin_th * torch.cos(psi))[:, None]
    cb = (sin_th * torch.sin(psi))[:, None]
    return ca * t1 + cb * bt + cos_th[:, None] * sn


class Tracer:
    """The reference scene on a device in one precision, with its
    nearest-hit search ("brute" or "tree")."""

    def __init__(self, sc: RefScene, device, *, dtype=torch.float32,
                 accel: str = "brute"):
        self.sc, self.dev, self.dt = sc, torch.device(device), dtype
        dev, dt = self.dev, dtype

        def put(x, dtype=dt):
            return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

        self.rows = put(woop_rows(sc.v0, sc.e1, sc.e2))
        self.n = [put(sc.n0), put(sc.n1), put(sc.n2)]
        self.mesh = put(sc.mesh, torch.int64)
        self.area = put(sc.mesh_area)
        self.kd = put(sc.kd)
        self.ke = put(sc.ke)
        self.cam = camera_vec(sc)
        self.nearest = (RefTree(sc, self.rows) if accel == "tree"
                        else Brute(self.rows))
        self.emitters = []
        for m, first, count in sc.emitters:
            sl = slice(first, first + count)
            e1, e2 = sc.e1[sl], sc.e2[sl]
            area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
            self.emitters.append(dict(
                mesh=m, count=count, v0=put(sc.v0[sl]), e1=put(e1),
                e2=put(e2), weight=put((area * count).astype(np.float32)),
                n0=put(sc.n0[sl]), n1=put(sc.n1[sl]), n2=put(sc.n2[sl])))

    def trace(self, pix, spp: int, max_depth: int, light_samples: int,
              seed, *, kd=None, counts: Counts | None = None):
        """[P, 3] radiance / spp of pixels `pix` (int64 [P] on the
        device): every one of their spp paths traced to its end. `seed` is
        the render's PCG seed, or an int64 [P] tensor of one per entry of
        `pix` (several renders' pixels traced together). `kd`
        ([M, 3], default the scene's) may require grad: the result is
        differentiable with respect to it (hits and directions detached,
        as the program's estimator has them)."""
        dev, dt, sc = self.dev, self.dt, self.sc
        W, H = sc.xres, sc.yres
        kd = self.kd if kd is None else kd.to(dt)
        ke = self.ke
        P = pix.numel()
        lane_pix = pix.repeat_interleave(spp)
        lane_samp = torch.arange(spp, device=dev).repeat(P)
        lane_seed = (torch.as_tensor(seed, dtype=torch.int64, device=dev)
                     .expand(P) & M32).repeat_interleave(spp)
        o, d = primary_rays(self.cam, lane_pix, lane_samp, lane_seed, W, H)
        o, d = o.to(dt), d.to(dt)
        N = lane_pix.numel()
        acc = torch.zeros((N, 3), dtype=torch.float32, device=dev)
        idx = torch.arange(N, device=dev)
        T = torch.ones((N, 3), dtype=dt, device=dev)
        inv_ls = 1.0 / light_samples
        for depth in range(max_depth + 1):
            if not idx.numel():
                break
            t, tri = self.nearest(o, d, BIG, counts, "nearest")
            keep = tri >= 0
            idx, o, d, T, t, tri = (x[keep] for x in (idx, o, d, T, t, tri))
            if not idx.numel():
                break
            pixl, samp, seed_t = lane_pix[idx], lane_samp[idx], \
                lane_seed[idx]
            site_sd = (samp * 131071 + depth) & M32
            g = self.rows[tri]
            ot, dtup = o.unbind(1), d.unbind(1)
            _, u, v = woop_tuv(ot, dtup, g.unbind(1))
            h = o + t[:, None] * d
            w = (1.0 - u - v)[:, None]
            sn = _norm(w * self.n[0][tri] + u[:, None] * self.n[1][tri]
                       + v[:, None] * self.n[2][tri])
            gn = g[:, 6:9] * torch.sqrt(g[:, 12:13])
            m = self.mesh[tri]
            kdl = kd[m]
            r = torch.zeros((idx.numel(), 3), dtype=dt, device=dev)
            if depth == 0:
                cosv = -(_norm(d) * sn).sum(dim=1)
                r = r + ke[m] * (self.area[m] * cosv)[:, None]
            so = h + BIAS * gn
            A = torch.zeros_like(r)
            for mi, em in enumerate(self.emitters):
                draws = []
                for ls in range(light_samples):
                    site = ls + light_samples * mi
                    b0, b1, b2, _ = pcg4d(pixl, site_sd, torch.full_like(
                        pixl, 0x11 + 0x101 * site), seed_t)
                    ut, ua, ub = (u01(x, torch.float32) for x in (b0, b1, b2))
                    sel = torch.clamp((ut * float(em["count"])).long(),
                                      max=em["count"] - 1)
                    flip = (ua + ub) > 1.0
                    a = torch.where(flip, 1.0 - ua, ua).to(dt)[:, None]
                    b = torch.where(flip, 1.0 - ub, ub).to(dt)[:, None]
                    sd = em["v0"][sel] + a * em["e1"][sel] \
                        + b * em["e2"][sel] - h
                    ld = _norm(sd)
                    cos_s = (sn * ld).sum(dim=1)
                    d2 = (sd * sd).sum(dim=1)
                    ln = _norm((1.0 - a - b) * em["n0"][sel]
                               + a * em["n1"][sel] + b * em["n2"][sel])
                    geom = cos_s * -(ln * ld).sum(dim=1)
                    draws.append((sd, geom > 0.0,
                                  geom * em["weight"][sel] / (1.0 + d2)
                                  * inv_ls))
                need = torch.cat([nd for _, nd, _ in draws])
                sds = torch.cat([sd for sd, _, _ in draws])
                sos = so.repeat(light_samples, 1)
                lanes = torch.nonzero(need).flatten()
                vis = torch.zeros_like(need)
                if lanes.numel():
                    _, stri = self.nearest(sos[lanes], sds[lanes], NEE_T_CAP,
                                           counts, "shadow")
                    vis[lanes] = (stri >= 0) & (self.mesh[stri.clamp(min=0)]
                                                == em["mesh"])
                vis = vis.view(light_samples, -1)
                for k, (_, _, full) in enumerate(draws):
                    scale = torch.where(vis[k], full,
                                        torch.zeros_like(full))
                    A = A + ke[em["mesh"]][None, :] * scale[:, None]
            r = r + kdl * A
            acc = acc.index_add(0, idx, (T * r).to(torch.float32))
            c0, c1, c2, _ = pcg4d(pixl, site_sd, torch.full_like(pixl,
                                                                 0x5EED),
                                  seed_t)
            u_rr, u1, u2 = (u01(x, dt) for x in (c0, c1, c2))
            p = torch.amax(kdl, dim=1)
            cont = (u_rr <= p.detach()) & (depth < max_depth)
            pos = p > 0.0
            inv_p = torch.where(pos, 1.0 / torch.where(pos, p,
                                                        torch.ones_like(p)),
                                torch.zeros_like(p))
            T = T * kdl * inv_p[:, None]
            bd = cosine_bounce(sn, u1, u2)
            o = (h + sn * BIAS).detach()
            idx, o, d, T = idx[cont], o[cont], bd.detach()[cont], T[cont]
        return acc.view(P, spp, 3).sum(dim=1) * (1.0 / spp)


class WhittedTracer(Tracer):
    """The Whitted estimator over the reference scene's rtc point lights
    and Phong materials, in one precision. The methods `pow_c`,
    `light_distance2` and `reflectivity` and the constant SHADOW_CAP each
    hold one rule of the estimator."""

    # the specular term's weight, 0.5 * pow(cos, Ns) (a copy of the
    # constant in ops/whitted._whitted_plain)
    SPEC_WEIGHT = 0.5
    # a shadow ray is blocked by a hit at any t below this: the quirk
    # (raytracer.cpp:196-201), a hit beyond the light (t > 1) blocks too
    SHADOW_CAP = BIG

    def __init__(self, sc: RefScene, device, *, dtype=torch.float32,
                 accel: str = "brute"):
        if accel != "brute":
            raise ValueError("the Whitted reference sweeps every triangle")
        super().__init__(sc, device, dtype=dtype, accel=accel)

        def put(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=self.dev).to(dtype)

        self.ka, self.ks, self.ns = put(sc.ka), put(sc.ks), put(sc.ns)
        self.lights = [(put(p), put(c), float(i)) for p, c, i in sc.lights]

    def pow_c(self, x, e):
        """C's powf for x >= 0: pow(0, 0) == 1, pow(0, e > 0) == 0."""
        one = torch.ones_like(x)
        return torch.where(x > 0.0, torch.pow(torch.where(x > 0.0, x, one),
                                              e),
                           torch.where(e == 0.0, one, torch.zeros_like(x)))

    def light_distance2(self, d2):
        """The divisor of a light's intensity: the squared distance."""
        return torch.clamp(d2, min=1e-20)

    def reflectivity(self, m):
        """[n, 3] factor of the mirror continuation: the material's Ks."""
        return self.ks[m]

    def blocked(self, so, sd, counts=None):
        """Whether each shadow ray (so, sd) hits a triangle at a t below
        SHADOW_CAP; counts the tests of a sweep that stops at its first
        hit, in the scene file's order."""
        n, T = so.shape[0], self.rows.shape[0]
        out = torch.zeros((n,), dtype=torch.bool, device=so.device)
        tests = 0
        w = tuple(self.rows[None, :, i] for i in range(13))
        step = max(1, (1 << 24) // max(T, 1))
        for s in range(0, n, step):
            oo = tuple(so[s:s + step, i, None] for i in range(3))
            dd = tuple(sd[s:s + step, i, None] for i in range(3))
            hit = woop_tuv(oo, dd, w)[0] < self.SHADOW_CAP
            any_hit = hit.any(dim=1)
            first = torch.argmax(hit.to(torch.int8), dim=1)
            tests += int(torch.where(any_hit, first + 1,
                                     torch.full_like(first, T)).sum())
            out[s:s + step] = any_hit
        if counts is not None:
            counts.add("shadow", n, 0, tests)
        return out

    def trace(self, pix, spp: int, max_depth: int, light_samples: int,
              seed, *, kd=None, counts: Counts | None = None):
        """[P, 3] radiance / spp of pixels `pix` (int64 [P] on the
        device): every one of their spp Whitted paths traced to its end.
        `seed` is the render's PCG seed or an int64 [P] tensor of one per
        entry of `pix`; `light_samples` is not used (point lights)."""
        dev, dt, sc = self.dev, self.dt, self.sc
        kd = self.kd if kd is None else kd.to(dt)
        P = pix.numel()
        lane_pix = pix.repeat_interleave(spp)
        lane_samp = torch.arange(spp, device=dev).repeat(P)
        lane_seed = (torch.as_tensor(seed, dtype=torch.int64, device=dev)
                     .expand(P) & M32).repeat_interleave(spp)
        o, d = primary_rays(self.cam, lane_pix, lane_samp, lane_seed,
                            sc.xres, sc.yres)
        o, d = o.to(dt), d.to(dt)
        N = lane_pix.numel()
        acc = torch.zeros((N, 3), dtype=torch.float32, device=dev)
        idx = torch.arange(N, device=dev)
        T = torch.ones((N, 3), dtype=dt, device=dev)
        for depth in range(max_depth + 1):
            t, tri = self.nearest(o, d, BIG, counts, "nearest")
            keep = tri >= 0
            idx, o, d, T, t, tri = (x[keep] for x in (idx, o, d, T, t, tri))
            if not idx.numel():
                break
            g = self.rows[tri]
            _, u, v = woop_tuv(o.unbind(1), d.unbind(1), g.unbind(1))
            h = o + t[:, None] * d
            w = (1.0 - u - v)[:, None]
            sn = _norm(w * self.n[0][tri] + u[:, None] * self.n[1][tri]
                       + v[:, None] * self.n[2][tri])
            gn = g[:, 6:9] * torch.sqrt(g[:, 12:13])
            m = self.mesh[tri]
            r = torch.zeros((idx.numel(), 3), dtype=dt, device=dev)
            if depth == 0:
                cosv = -(_norm(d) * sn).sum(dim=1)
                r = r + self.ke[m] * (self.area[m] * cosv)[:, None]
            so = h + BIAS * gn
            vd = _norm(-d)
            for lp, lc, intensity in self.lights:
                tl = lp[None, :] - h
                d2 = (tl * tl).sum(dim=1)
                lit = ~self.blocked(so, tl, counts)
                ld = _norm(tl)
                ndotl = torch.clamp((sn * ld).sum(dim=1), min=0.0)
                dot_ln = -(ld * sn).sum(dim=1)
                refl = -ld - 2.0 * dot_ln[:, None] * sn
                spec_cos = torch.clamp((vd * refl).sum(dim=1), min=0.0)
                spec = self.SPEC_WEIGHT * self.pow_c(spec_cos, self.ns[m])
                scale = lit.to(dt) * intensity / self.light_distance2(d2)
                r = r + lc[None, :] * (self.ka[m] + ndotl[:, None] * kd[m]
                                       + spec[:, None] * self.ks[m]) \
                    * scale[:, None]
            acc = acc.index_add(0, idx, (T * r).to(torch.float32))
            T = T * self.reflectivity(m)
            cont = (T > 0.0).any(dim=1) & (depth < max_depth)
            bd = d - 2.0 * (d * sn).sum(dim=1)[:, None] * sn
            o = h + sn * BIAS
            idx, o, d, T = idx[cont], o[cont], bd[cont], T[cont]
        return acc.view(P, spp, 3).sum(dim=1) * (1.0 / spp)


# the retrace of each configuration's `integrator`
TRACERS = {"path": Tracer, "whitted": WhittedTracer}
