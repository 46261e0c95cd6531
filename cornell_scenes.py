"""The Cornell box scenes of the port's tests, tools and examples.

write_cornell writes the box as OBJ/MTL/RTC text (36 triangles, one
two-triangle emissive quad, no point lights), optionally subdivided,
checker-textured or normal-mapped; write_cornell_whitted is its
point-light (Whitted) variant, whose tall box is a glossy mirror;
two_emitter gives a loaded scene a second emitter; random_rays makes rays
from inside the box. chip_smoke.py drives the card on these scenes.

NumPy only at import time: the writers import orion_tpu_torch's image
writers, and random_rays torch, when they are called.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np


def _box_faces(center, half, angle):
    """Six outward quads of a box rotated by `angle` about +y."""
    c, s = math.cos(angle), math.sin(angle)

    def p(x, y, z):
        return (center[0] + c * x * half[0] + s * z * half[2],
                center[1] + y * half[1],
                center[2] - s * x * half[0] + c * z * half[2])

    def n(x, y, z):
        return (c * x + s * z, y, -s * x + c * z)

    return [
        ([p(-1, 1, -1), p(-1, 1, 1), p(1, 1, 1), p(1, 1, -1)], n(0, 1, 0)),
        ([p(-1, -1, -1), p(1, -1, -1), p(1, -1, 1), p(-1, -1, 1)],
         n(0, -1, 0)),
        ([p(-1, -1, 1), p(1, -1, 1), p(1, 1, 1), p(-1, 1, 1)], n(0, 0, 1)),
        ([p(1, -1, -1), p(-1, -1, -1), p(-1, 1, -1), p(1, 1, -1)],
         n(0, 0, -1)),
        ([p(1, -1, 1), p(1, -1, -1), p(1, 1, -1), p(1, 1, 1)], n(1, 0, 0)),
        ([p(-1, -1, -1), p(-1, -1, 1), p(-1, 1, 1), p(-1, 1, -1)],
         n(-1, 0, 0)),
    ]


def cornell_objects():
    """[(name, material, [(quad corners, normal), ...])] of the box."""
    walls = [
        ("floor", "white", [(-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1)],
         (0, 1, 0)),
        ("ceiling", "white", [(-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1)],
         (0, -1, 0)),
        ("back", "white", [(-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)],
         (0, 0, 1)),
        ("left", "red", [(-1, 0, 1), (-1, 0, -1), (-1, 2, -1), (-1, 2, 1)],
         (1, 0, 0)),
        ("right", "green", [(1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1)],
         (-1, 0, 0)),
    ]
    objs = [(name, mat, [(quad, nrm)]) for name, mat, quad, nrm in walls]
    objs.append(("short_box", "white",
                 _box_faces((0.35, 0.3, 0.35), (0.3, 0.3, 0.3), -0.3)))
    objs.append(("tall_box", "white",
                 _box_faces((-0.35, 0.6, -0.3), (0.3, 0.6, 0.3), 0.3)))
    objs.append(("light", "light",
                 [([(-0.25, 1.98, -0.25), (0.25, 1.98, -0.25),
                    (0.25, 1.98, 0.25), (-0.25, 1.98, 0.25)], (0, -1, 0))]))
    return objs


def _midpoint_subdivide(tris: np.ndarray, levels: int) -> np.ndarray:
    """[n, 3, 3] triangles -> [n * 4**levels, 3, 3]: 4-to-1 midpoint
    subdivision, children in subdivide_scene's order (corner a, corner b,
    corner c, centre), winding kept."""
    for _ in range(levels):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, ac, bc = 0.5 * (a + b), 0.5 * (a + c), 0.5 * (b + c)
        tris = np.stack([np.stack(t, 1) for t in
                         ((a, ab, ac), (ab, b, bc), (ac, bc, c),
                          (ab, bc, ac))], 1).reshape(-1, 3, 3)
    return tris


def write_normal_map(path, size: int = 16) -> None:
    """A [size, size] tangent-space normal map as a binary PPM: a ripple
    n = normalize(0.6 sin(2 pi x / 8), 0.6 cos(2 pi y / 8), 1) stored as
    (n + 1) / 2, with every fourth row and column flat (0.5, 0.5, 1)."""
    from orion_tpu_torch.io.image import save_ppm

    x = np.arange(size, dtype=np.float64)
    sx = 0.6 * np.sin(2.0 * np.pi * x / 8.0)[None, :].repeat(size, 0)
    sy = 0.6 * np.cos(2.0 * np.pi * x / 8.0)[:, None].repeat(size, 1)
    n = np.stack([sx, sy, np.ones_like(sx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    tex = (n + 1.0) * 0.5
    tex[::4, :] = tex[:, ::4] = (0.5, 0.5, 1.0)
    # the PPM writer truncates x * 255: nudge each texel to its byte's centre
    save_ppm(str(path), (np.floor(tex * 255.0) + 0.5) / 255.0)


def write_cornell(directory, *, xres: int = 64, yres: int = 64,
                  depth: int = 4, levels: int = 0,
                  checker: bool = False, bump: bool = False) -> Path:
    """Write cornell.obj/.mtl/.rtc into `directory`; returns the .rtc path.

    Every triangle is wound so that cross(e1, e2) points along its listed
    normal (into the room for walls, out of the boxes, down for the light),
    and carries that normal as its vertex normal.

    levels > 0 subdivides every triangle but the emitter's 4-to-1 at its
    edge midpoints `levels` times in the OBJ text: the same box with
    34 * 4**levels + 2 triangles (levels=5: 34,818), the count
    scene.subdivide_scene gives.

    checker=True maps an 8x8 two-colour checker (checker.png, written
    beside the OBJ) as map_Kd onto every material but the emitter's, with
    texture coordinates 0.8 * (x, y) + (0.07, 0.03) at every vertex: a
    textured path scene, which only the bounce pipeline renders. The
    offsets keep the axis-aligned walls, whose u or v is constant, off the
    texel boundaries, where one ulp in a hit's barycentrics would pick the
    other texel.

    bump=True maps write_normal_map's 16x16 tangent-space normal map
    (normal.ppm, beside the OBJ) as map_bump onto the same materials, with
    the same texture coordinates: the scene of render(normal_maps=True)
    and the CLI's --normal-maps. A wall whose u or v is constant has a
    degenerate UV frame and takes tangent_frame's fallback (e1, e2).
    """
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tex_line = ""
    if checker:
        from orion_tpu_torch.io.image import save_image

        tex = np.full((8, 8, 3), 0.25, np.float32)
        tex[::2, ::2] = (0.9, 0.75, 0.5)
        tex[1::2, 1::2] = (0.5, 0.75, 0.9)
        save_image(str(d / "checker.png"), tex)
        tex_line = "map_Kd checker.png\n"
    if bump:
        write_normal_map(d / "normal.ppm")
        tex_line += "map_bump normal.ppm\n"
    uvs = checker or bump
    (d / "cornell.mtl").write_text(
        f"newmtl white\nKd 0.73 0.73 0.73\n{tex_line}\n"
        f"newmtl red\nKd 0.65 0.05 0.05\n{tex_line}\n"
        f"newmtl green\nKd 0.12 0.45 0.15\n{tex_line}\n"
        "newmtl light\nKd 0.78 0.78 0.78\nKe 17.0 12.0 4.0\n")
    lines = ["mtllib cornell.mtl"]
    nv = nn = 0

    def verts(pts):
        out = ["v %.9g %.9g %.9g" % tuple(v) for v in pts]
        if uvs:
            out += ["vt %.9g %.9g" % (0.8 * v[0] + 0.07, 0.8 * v[1] + 0.03)
                    for v in pts]
        return out

    def face(*idx):
        return "f " + " ".join(f"{k}/{k if uvs else ''}/{nn}"
                               for k in idx)

    for name, mat, quads in cornell_objects():
        lines += [f"o {name}", f"usemtl {mat}"]
        for quad, nrm in quads:
            q = np.asarray(quad, np.float64)
            if np.dot(np.cross(q[1] - q[0], q[2] - q[0]), nrm) < 0:
                q = q[::-1]
            nn += 1
            vn = "vn %.9g %.9g %.9g" % tuple(nrm)
            if levels > 0 and mat != "light":
                tris = _midpoint_subdivide(
                    np.stack([q[[0, 1, 2]], q[[0, 2, 3]]]), levels)
                lines += verts(tris.reshape(-1, 3))
                lines.append(vn)
                lines += [face(k, k + 1, k + 2)
                          for k in range(nv + 1, nv + 1 + 3 * len(tris), 3)]
                nv += 3 * len(tris)
                continue
            lines += verts(q)
            lines.append(vn)
            a, b, c, e = nv + 1, nv + 2, nv + 3, nv + 4
            lines += [face(a, b, c), face(a, c, e)]
            nv += 4
    (d / "cornell.obj").write_text("\n".join(lines) + "\n")
    rtc = d / "cornell.rtc"
    rtc.write_text("# Cornell box, path traced (no point lights)\n"
                   f"cornell.obj\n{'checker.png' if checker else 'none'}\n"
                   f"{depth}\n{xres} {yres}\n"
                   "0 1 3.4\n0 1 0\n0 1 0\n0.8\n")
    return rtc


def write_cornell_whitted(directory, *, xres: int = 64, yres: int = 64,
                          depth: int = 4, levels: int = 0,
                          checker: bool = False, bump: bool = False) -> Path:
    """The Cornell box lit by one rtc point light (Whitted mode), its tall
    box a glossy mirror (Ks 0.5, Ns 20) so that reflection chains run;
    the ceiling emitter stays (depth-0 emission). checker=True maps
    write_cornell's 8x8 checker as map_Kd onto every material but the
    emitter's, the mirror's too: a textured Whitted scene, which of the
    Whitted megakernels only the deferred-texturing BVH kernel renders.
    bump=True maps write_cornell's normal map onto the same materials."""
    rtc = write_cornell(directory, xres=xres, yres=yres, depth=depth,
                        levels=levels, checker=checker, bump=bump)
    obj, mtl = rtc.with_suffix(".obj"), rtc.with_suffix(".mtl")
    obj.write_text(obj.read_text().replace("o tall_box\nusemtl white",
                                           "o tall_box\nusemtl mirror"))
    mtl.write_text(mtl.read_text() + "\nnewmtl mirror\nKd 0.73 0.73 0.73\n"
                   "Ks 0.5 0.5 0.5\nNs 20\n"
                   + ("map_Kd checker.png\n" if checker else "")
                   + ("map_bump normal.ppm\n" if bump else ""))
    rtc.write_text(rtc.read_text() + "L 0 1.8 0.5 255 255 255 2.0\n")
    return rtc


def two_emitter(scene):
    """The Cornell scene with a second emissive mesh: the first non-emitter
    mesh of <= 8 triangles gets Ke = (0.5, 0.4, 0.3)."""
    from orion_tpu_torch.scene import scene_from_numpy, scene_to_numpy

    f = scene_to_numpy(scene)
    em0 = int(f["emissive_mesh_ids"][0])
    m2 = next(m for m in range(scene.num_meshes)
              if m != em0 and f["mesh_tri_count"][m] <= 8)
    f["mat_emissive"] = f["mat_emissive"].copy()
    f["mat_emissive"][m2] = (0.5, 0.4, 0.3)
    f["emissive_mesh_ids"] = np.array([em0, m2], np.int32)
    f["num_emissive"] = 2
    return scene_from_numpy(f, scene.device)


def random_rays(n: int, seed: int, device):
    """Rays from inside the box in random directions; ~10% dead."""
    import torch

    rng = np.random.default_rng(seed)
    o = rng.uniform((-0.95, 0.05, -0.95), (0.95, 1.95, 0.95), (n, 3))
    d = rng.normal(size=(n, 3))
    alive = rng.uniform(size=n) > 0.1
    return (torch.as_tensor(o, dtype=torch.float32, device=device),
            torch.as_tensor(d, dtype=torch.float32, device=device),
            torch.as_tensor(alive, device=device))
