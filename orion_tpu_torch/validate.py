"""Fail-fast scene/config validation.

The reference prints-and-continues on bad input (SURVEY.md §5: bad rtc
`rtc_parser.cpp:74-77`, Assimp failure `model.cpp:31-35`, texture failure
`texture.hpp:36-41`) and its viewer dereferences lights[0] unchecked
(`viewer/main.cpp:65` — crashes on the light-less cornell rtc). Here every
problem is a typed exception with an actionable message, raised before any
device work starts.
"""

from __future__ import annotations

import warnings

import numpy as np


class SceneValidationError(ValueError):
    """A scene/config problem that would render garbage (or crash later)."""


def validate_rtc(rtc) -> None:
    problems = []
    if rtc.xres <= 0 or rtc.yres <= 0:
        problems.append(f"non-positive resolution {rtc.xres}x{rtc.yres}")
    if rtc.y_view <= 0:
        problems.append(f"non-positive y_view {rtc.y_view}")
    vp = np.asarray(rtc.view_point, np.float64)
    la = np.asarray(rtc.look_at, np.float64)
    up = np.asarray(rtc.vector_up, np.float64)
    front = la - vp
    if not np.isfinite(np.concatenate([vp, la, up])).all():
        problems.append("non-finite camera values")
    elif np.linalg.norm(front) == 0.0:
        problems.append("view_point == look_at (no view direction)")
    elif np.linalg.norm(np.cross(front, up)) == 0.0:
        problems.append("up vector parallel to the view direction "
                        "(degenerate camera basis — the reference's "
                        "Gram-Schmidt would divide by zero)")
    if rtc.recursion_level < 0:
        problems.append(f"negative recursion level {rtc.recursion_level}")
    for i, l in enumerate(rtc.lights):
        if l.intensity < 0:
            problems.append(f"light {i} has negative intensity")
    if problems:
        raise SceneValidationError("; ".join(problems))


def validate_scene(scene) -> None:
    problems = []
    if scene.num_meshes == 0 or scene.num_triangles == 0:
        problems.append("scene has no triangles")
    for name in ("tri_v0", "tri_e1", "tri_e2", "n0", "n1", "n2",
                 "mat_diffuse", "mat_emissive", "light_pos"):
        a = scene.numpy(name)
        if not np.isfinite(a).all():
            problems.append(f"non-finite values in {name}")
    if problems:
        raise SceneValidationError("; ".join(problems))
    if scene.num_lights == 0 and scene.num_emissive == 0:
        # the reference renders this scene (black, raytracer.cpp:131-194
        # with an empty emitter list) — warn loudly, don't refuse
        warnings.warn("no point lights and no emissive materials: every "
                      "pixel will render black (path mode needs an emitter; "
                      "whitted mode needs rtc L lines)",
                      stacklevel=2)
