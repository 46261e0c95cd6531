"""Scene generators of the benchmark: the Cornell box as .rtc/.obj/.mtl text.

A frozen copy of `chip_smoke.cornell_objects`, `_box_faces`,
`_midpoint_subdivide`, `write_cornell` (without its texture options) and
`write_cornell_whitted`, so that the benchmark's inputs stay the same
whatever later changes make to chip_smoke.py. Nothing here imports the
program: both the program and the plain reference read the files written
here.
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
    subdivision (corner a, corner b, corner c, centre), winding kept."""
    for _ in range(levels):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, ac, bc = 0.5 * (a + b), 0.5 * (a + c), 0.5 * (b + c)
        tris = np.stack([np.stack(t, 1) for t in
                         ((a, ab, ac), (ab, b, bc), (ac, bc, c),
                          (ab, bc, ac))], 1).reshape(-1, 3, 3)
    return tris


def write_cornell(directory, *, xres: int = 64, yres: int = 64,
                  depth: int = 4, levels: int = 0) -> Path:
    """Write cornell.obj/.mtl/.rtc into `directory`; returns the .rtc path.

    Every triangle is wound so that cross(e1, e2) points along its listed
    normal and carries that normal as its vertex normal. levels > 0
    subdivides every triangle but the emitter's 4-to-1 at its edge
    midpoints `levels` times: 34 * 4**levels + 2 triangles."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    (d / "cornell.mtl").write_text(
        "newmtl white\nKd 0.73 0.73 0.73\n\n"
        "newmtl red\nKd 0.65 0.05 0.05\n\n"
        "newmtl green\nKd 0.12 0.45 0.15\n\n"
        "newmtl light\nKd 0.78 0.78 0.78\nKe 17.0 12.0 4.0\n")
    lines = ["mtllib cornell.mtl"]
    nv = nn = 0

    def verts(pts):
        return ["v %.9g %.9g %.9g" % tuple(v) for v in pts]

    def face(*idx):
        return "f " + " ".join(f"{k}//{nn}" for k in idx)

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
                   f"cornell.obj\nnone\n{depth}\n{xres} {yres}\n"
                   "0 1 3.4\n0 1 0\n0 1 0\n0.8\n")
    return rtc


def write_cornell_whitted(directory, *, xres: int = 64, yres: int = 64,
                          depth: int = 4, levels: int = 0) -> Path:
    """The Cornell box lit by one rtc point light (Whitted mode), its tall
    box a glossy mirror (Ks 0.5, Ns 20); the ceiling emitter stays."""
    rtc = write_cornell(directory, xres=xres, yres=yres, depth=depth,
                        levels=levels)
    obj, mtl = rtc.with_suffix(".obj"), rtc.with_suffix(".mtl")
    obj.write_text(obj.read_text().replace("o tall_box\nusemtl white",
                                           "o tall_box\nusemtl mirror"))
    mtl.write_text(mtl.read_text() + "\nnewmtl mirror\nKd 0.73 0.73 0.73\n"
                   "Ks 0.5 0.5 0.5\nNs 20\n")
    rtc.write_text(rtc.read_text() + "L 0 1.8 0.5 255 255 255 2.0\n")
    return rtc
