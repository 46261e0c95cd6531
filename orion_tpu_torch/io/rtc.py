"""`.rtc` scene-config parser and writer.

File-format compatible with the reference parser
(orion/rtc_parser.cpp:69-134 for reading, :136-163 for
writing): a line-oriented format where, counting only non-empty non-comment
lines,

  line 1:  obj file (path relative to the rtc file)
  line 2:  texture file (parsed but unused by the renderer — kept for parity)
  line 3:  recursion depth (int)
  line 4:  `xres yres`
  line 5:  view point  (3 floats)
  line 6:  look at     (3 floats)
  line 7:  up vector   (3 floats)
  line 8:  y field of view (the full screen height at unit distance)
  line 9+: `L x y z r g b intensity` point lights; rgb given 0-255 and
           normalized to 0-1 on read (rtc_parser.cpp:111-126)

Lines whose first non-whitespace character is `#`, and blank lines, are
skipped (rtc_parser.cpp:85,128-130). Like the reference, whitespace means any
character with codepoint <= 32.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Tuple


@dataclasses.dataclass
class PointLight:
    """Point light: position, color (0-1), scalar intensity.

    Mirrors `orion::Light` (orion/light.hpp:8-13).
    """

    position: Tuple[float, float, float]
    color: Tuple[float, float, float]
    intensity: float


@dataclasses.dataclass
class RTCData:
    """Parsed `.rtc` scene configuration.

    Mirrors `orion::rtc_data` (orion/rtc_parser.hpp:11-31).
    """

    obj_file: str = ""
    texture_file: str = ""
    recursion_level: int = 0
    xres: int = 0
    yres: int = 0
    view_point: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    look_at: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    vector_up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    y_view: float = 1.0
    lights: List[PointLight] = dataclasses.field(default_factory=list)

    @property
    def aspect_ratio(self) -> float:
        return float(self.xres) / float(self.yres)


def _is_space(c: str) -> bool:
    # reference's isspace: anything <= 32 (rtc_parser.cpp:13-15)
    return ord(c) <= 32


def _trim(s: str) -> str:
    start = 0
    end = len(s)
    while start < end and _is_space(s[start]):
        start += 1
    while end > start and _is_space(s[end - 1]):
        end -= 1
    return s[start:end]


def _vec3(tokens: List[str]) -> Tuple[float, float, float]:
    return (float(tokens[0]), float(tokens[1]), float(tokens[2]))


def parse_rtc(path: str | Path) -> RTCData:
    """Parse an `.rtc` file. Raises on missing file / malformed content.

    Unlike the reference (which printf-and-continues on errors,
    rtc_parser.cpp:74-77), we fail fast with a clear exception.
    """
    path = Path(path)
    rtc = RTCData()
    line_count = 0
    with open(path, "r") as f:
        for raw in f:
            line = _trim(raw)
            if not line or line[0] == "#":
                continue
            line_count += 1
            toks = line.split()
            if line_count == 1:
                rtc.obj_file = line
            elif line_count == 2:
                rtc.texture_file = line
            elif line_count == 3:
                rtc.recursion_level = int(toks[0])
            elif line_count == 4:
                rtc.xres, rtc.yres = int(toks[0]), int(toks[1])
            elif line_count == 5:
                rtc.view_point = _vec3(toks)
            elif line_count == 6:
                rtc.look_at = _vec3(toks)
            elif line_count == 7:
                rtc.vector_up = _vec3(toks)
            elif line_count == 8:
                rtc.y_view = float(toks[0])
            else:
                if toks[0] not in ("L", "l"):
                    raise ValueError(
                        f"{path}: invalid light line {line!r} "
                        f"(expected 'L x y z r g b intensity')"
                    )
                pos = _vec3(toks[1:4])
                col = _vec3(toks[4:7])
                col = (col[0] / 255.0, col[1] / 255.0, col[2] / 255.0)
                intensity = float(toks[7])
                rtc.lights.append(PointLight(pos, col, intensity))
    if line_count < 8:
        raise ValueError(f"{path}: incomplete rtc file ({line_count} data lines, need 8)")
    return rtc


def _fmt_f(x: float) -> str:
    # match C++ ofstream default float formatting closely enough:
    # shortest representation without trailing zeros
    s = f"{x:.6g}"
    return s


def write_rtc(path: str | Path, rtc: RTCData) -> None:
    """Write an `.rtc` file in the reference dump format (rtc_parser.cpp:136-163)."""
    lines = ["# RTC dump from orion_tpu"]
    lines.append(rtc.obj_file)
    lines.append(rtc.texture_file)
    lines.append(str(rtc.recursion_level))
    lines.append(f"{rtc.xres} {rtc.yres}")
    for v in (rtc.view_point, rtc.look_at, rtc.vector_up):
        lines.append(" ".join(_fmt_f(c) for c in v))
    lines.append(_fmt_f(rtc.y_view))
    for light in rtc.lights:
        col = [int(c * 255.0) for c in light.color]
        pos = " ".join(_fmt_f(c) for c in light.position)
        lines.append(f"L {pos} {col[0]} {col[1]} {col[2]} {_fmt_f(light.intensity)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
