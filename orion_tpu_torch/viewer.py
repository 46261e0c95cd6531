"""Interactive scene previewer: progressive low-spp rendering + camera dump.

The PyTorch counterpart of `orion_tpu.viewer`, the reference's OpenGL
rviewer (viewer/main.cpp) for a headless host: it flies a WASD/arrow
camera on a terminal, previews each frame with the real renderer (what
you preview is what traces), and `p` writes the camera back to an .rtc
(viewer/main.cpp:182-191, through io/rtc.write_rtc) for the offline
tracer.

    python -m orion_tpu_torch.viewer scene.rtc [--fps-probe N] [--device cpu]

Controls (terminal, POSIX raw tty):
  w/a/s/d  move forward/left/back/right     r/f  move up/down
  arrows   yaw/pitch (hjkl also work)       +/-  zoom (y-FOV)
  p        dump camera to dump.rtc          q    quit
  space    re-render at 4x samples (refine)

Preview route on a CUDA scene: the megakernel of the scene's mode, in the
JAX package's order (viewer.py:124-186): the path kernel over the brute
sweep (kernel 1), else the BVH path kernel (8), for path scenes; the
Whitted kernel (4), else the BVH Whitted kernel (7a), else the deferred
textured one (7b), for point-light scenes. It is built once and flown
through its `camera_override` (no table is rebuilt; it is rebuilt only
when the sample count changes). Otherwise, and on a CPU scene, the frame
is the wavefront over the engine's intersect, with the BVH child order
re-baked for the camera's octant (engine.refresh_octant_order).

Camera model mirrors viewer/camera.hpp: yaw/pitch Euler angles recovered
from the rtc front vector (camera.hpp:67-76), one keypress = SPEED world
units, zoom clamped to [1, 45] degrees.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path
from typing import Optional

import numpy as np

SPEED = 0.5          # world units per keypress (viewer is keypress-driven)
TURN = math.radians(4.0)
ZOOM_MIN, ZOOM_MAX = 1.0, 45.0


@dataclasses.dataclass
class FlyCamera:
    """Euler-angle fly camera (viewer/camera.hpp:21-82)."""

    position: np.ndarray
    yaw: float
    pitch: float
    world_up: np.ndarray
    fov_deg: float

    @classmethod
    def from_rtc(cls, rtc) -> "FlyCamera":
        pos = np.asarray(rtc.view_point, np.float64)
        front = np.asarray(rtc.look_at, np.float64) - pos
        front = front / np.linalg.norm(front)
        # yaw/pitch from a front vector (viewer/camera.hpp:67-76)
        pitch = math.asin(np.clip(front[1], -1.0, 1.0))
        yaw = math.atan2(front[2], front[0])
        fov = math.degrees(2.0 * math.atan(rtc.y_view / 2.0))
        return cls(position=pos, yaw=yaw, pitch=pitch,
                   world_up=np.asarray(rtc.vector_up, np.float64),
                   fov_deg=min(max(fov, ZOOM_MIN), ZOOM_MAX))

    @property
    def front(self) -> np.ndarray:
        cp = math.cos(self.pitch)
        return np.array([math.cos(self.yaw) * cp,
                         math.sin(self.pitch),
                         math.sin(self.yaw) * cp])

    @property
    def right(self) -> np.ndarray:
        r = np.cross(self.front, self.world_up)
        return r / np.linalg.norm(r)

    def move(self, forward=0.0, strafe=0.0, lift=0.0):
        self.position = (self.position + forward * SPEED * self.front
                         + strafe * SPEED * self.right
                         + lift * SPEED * self.world_up)

    def turn(self, dyaw=0.0, dpitch=0.0):
        self.yaw += dyaw
        self.pitch = min(max(self.pitch + dpitch, -1.55), 1.55)

    def zoom(self, d):
        self.fov_deg = min(max(self.fov_deg + d, ZOOM_MIN), ZOOM_MAX)

    def apply_to_rtc(self, rtc):
        rtc.view_point = tuple(float(v) for v in self.position)
        rtc.look_at = tuple(float(v) for v in self.position + self.front)
        rtc.y_view = 2.0 * math.tan(math.radians(self.fov_deg) / 2.0)
        return rtc


def dump_rtc(rtc, cam: FlyCamera, path: str | Path = "dump.rtc") -> Path:
    """The `P`-key camera round-trip (viewer/main.cpp:182-191)."""
    import copy

    from orion_tpu_torch.io.rtc import write_rtc

    out = copy.deepcopy(rtc)
    cam.apply_to_rtc(out)
    write_rtc(path, out)
    return Path(path)


def build_preview_megakernel(ps, camera, samples: int, depth: int):
    """(fn(seed, camera_override=) -> [H, W, 3], backend name) of the
    preview megakernel of a CUDA scene (engine.make_megakernel_renderer,
    the big-path chain restricted to the BVH path kernel), or None where
    no megakernel takes the scene (or the scene is on the CPU). One light
    sample, as the JAX viewer. The trees' child order is baked for the
    build camera's octant: a camera flown across octants loses the
    near-first order's speed, not its correctness."""
    from orion_tpu_torch.engine import make_megakernel_renderer

    if ps.scene.device.type != "cuda":
        return None
    try:
        return make_megakernel_renderer(ps, mode=None, samples=samples,
                                        max_depth=depth, light_samples=1,
                                        big_path_order=("walk",),
                                        camera=camera)
    except ValueError:          # outside every gate: the wavefront
        return None


def _render_preview(ps, cam: FlyCamera, samples: int, out_path: str,
                    xres: int, yres: int):
    """Render one preview frame of `cam` to `out_path`; returns the
    (possibly re-baked) PreparedScene, which carries the built megakernel
    as `_viewer_fused` = (fn, spp, backend)."""
    import copy

    import torch

    from orion_tpu_torch.camera import camera_from_rtc
    from orion_tpu_torch.engine import refresh_octant_order
    from orion_tpu_torch.io.image import save_image
    from orion_tpu_torch.render import render

    rtc = copy.deepcopy(ps.rtc)
    rtc.xres, rtc.yres = xres, yres
    cam.apply_to_rtc(rtc)
    camera = camera_from_rtc(rtc, device=ps.scene.device)
    spp = max(samples, 1)
    fused = getattr(ps, "_viewer_fused", None)
    if fused is not None and fused[1] != spp:
        fused = ps._viewer_fused = None       # spp changed: rebuild
    if fused is None:
        built = build_preview_megakernel(ps, camera, spp,
                                         int(rtc.recursion_level))
        if built is not None:
            fused = ps._viewer_fused = (built[0], spp, built[1])
    if fused is not None:
        img = fused[0](0, camera_override=camera)
        save_image(out_path, img.cpu().numpy())
        return ps
    # the BVH child order was baked for the prepare-time camera octant; a
    # camera flown into another octant re-flattens it (no-op otherwise)
    ps = refresh_octant_order(ps, camera.front)
    g = torch.Generator(device=ps.scene.device)
    g.manual_seed(0)
    img = render(ps.scene, camera, g, samples=samples,
                 max_depth=int(rtc.recursion_level), light_samples=1,
                 intersect=ps.intersect, shadow_intersect=ps.shadow_intersect)
    save_image(out_path, img.cpu().numpy())
    return ps


def _ansi_preview(path: str, cols: int = 80) -> str:
    """Render the preview PNG as ANSI half-block art for the terminal."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    rows = max(2, int(cols * img.height / img.width / 2) * 2)
    img = img.resize((cols, rows))
    a = np.asarray(img)
    lines = []
    for y in range(0, rows, 2):
        line = []
        for x in range(cols):
            tr, tg, tb = a[y, x]
            br, bg, bb = a[y + 1, x]
            line.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                        f"\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(line) + "\x1b[0m")
    return "\n".join(lines)


def _check_device(device) -> None:
    import torch

    if str(device).startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but no CUDA device "
                           "is available (pass device='cpu')")


def run_viewer(rtc_path: str, *, xres: int = 192, yres: int = 108,
               samples: int = 1, out: str = "preview.png",
               dump_path: str = "dump.rtc",
               max_frames: Optional[int] = None,
               input_stream=None, echo=print,
               device="cuda") -> FlyCamera:
    """Interactive preview loop on `device`. Reads single keys from
    `input_stream` (default: raw tty on stdin), re-renders after every
    action, and returns the final camera. `max_frames`/`input_stream`
    exist for scripted use and tests."""
    from orion_tpu_torch.engine import prepare

    _check_device(device)
    ps = prepare(rtc_path, device=device)
    cam = FlyCamera.from_rtc(ps.rtc)

    def getch_tty():
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setraw(fd)
            ch = sys.stdin.read(1)
            if ch == "\x1b":  # arrow keys: ESC [ A/B/C/D
                ch += sys.stdin.read(2)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
        return ch

    get = (iter(input_stream).__next__ if input_stream is not None
           else getch_tty)

    frames = 0
    spp = samples
    while max_frames is None or frames < max_frames:
        ps = _render_preview(ps, cam, spp, out, xres, yres)
        frames += 1
        try:
            echo(_ansi_preview(out))
        except Exception:
            echo(f"[preview written to {out}]")
        echo(f"pos={np.round(cam.position, 2).tolist()} "
             f"yaw={math.degrees(cam.yaw):.1f} "
             f"pitch={math.degrees(cam.pitch):.1f} fov={cam.fov_deg:.1f} "
             f"spp={spp}  (wasd/rf move, arrows turn, +/- zoom, "
             f"space refine, p dump, q quit)")
        try:
            ch = get()
        except StopIteration:
            break
        spp = samples
        if ch == "q":
            break
        elif ch == "w":
            cam.move(forward=1)
        elif ch == "s":
            cam.move(forward=-1)
        elif ch == "a":
            cam.move(strafe=-1)
        elif ch == "d":
            cam.move(strafe=1)
        elif ch == "r":
            cam.move(lift=1)
        elif ch == "f":
            cam.move(lift=-1)
        elif ch in ("\x1b[D", "h"):
            cam.turn(dyaw=-TURN)
        elif ch in ("\x1b[C", "l"):
            cam.turn(dyaw=TURN)
        elif ch in ("\x1b[A", "k"):
            cam.turn(dpitch=TURN)
        elif ch in ("\x1b[B", "j"):
            cam.turn(dpitch=-TURN)
        elif ch == "+":
            cam.zoom(-1.0)
        elif ch == "-":
            cam.zoom(+1.0)
        elif ch == " ":
            spp = samples * 4
        elif ch == "p":
            path = dump_rtc(ps.rtc, cam, dump_path)
            echo(f"camera dumped to {path}")
    return cam


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="orion_tpu_torch.viewer",
        description="Progressive preview + camera authoring for .rtc scenes")
    p.add_argument("rtc_file")
    p.add_argument("--xres", type=int, default=192)
    p.add_argument("--yres", type=int, default=108)
    p.add_argument("-p", dest="samples", type=int, default=1)
    p.add_argument("--out", default="preview.png")
    p.add_argument("--dump", default="dump.rtc")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; fails without a CUDA device) or "
                        "cpu (the kernels' plain PyTorch versions)")
    p.add_argument("--fps-probe", type=int, default=0, metavar="N",
                   help="Render N frames along a camera orbit and print "
                        "achieved FPS (the rviewer-60fps-GL-loop "
                        "comparison point), then exit")
    args = p.parse_args(argv)
    if args.fps_probe:
        return fps_probe(args.rtc_file, xres=args.xres, yres=args.yres,
                         samples=args.samples, frames=args.fps_probe,
                         device=args.device)
    run_viewer(args.rtc_file, xres=args.xres, yres=args.yres,
               samples=args.samples, out=args.out, dump_path=args.dump,
               device=args.device)
    return 0


def fps_probe(rtc_file, *, xres: int, yres: int, samples: int,
              frames: int, device="cuda") -> int:
    """Measure preview frame rate: fly the camera along a small orbit and
    re-render every frame (the megakernel route where the scene has one:
    the camera rides in the kernel's camera tensor, so no frame rebuilds
    a table), each frame written as a PNG as the viewer does. Prints one
    JSON line: resolution, samples, frames, backend (the megakernel's
    name, else the wavefront's intersect), ms_per_frame, fps.

    The reference's rviewer is a 60fps GL rasterizer loop
    (viewer/main.cpp:127-173) that previews with a DIFFERENT renderer;
    this probe reports what the real tracer sustains per frame.
    """
    import json
    import tempfile
    import time

    import torch

    from orion_tpu_torch.engine import prepare

    _check_device(device)
    ps = prepare(rtc_file, device=device, xres=xres, yres=yres)
    cam = FlyCamera.from_rtc(ps.rtc)

    def sync():
        if ps.scene.device.type == "cuda":
            torch.cuda.synchronize(ps.scene.device)

    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "orion_fps_probe.png")
        ps = _render_preview(ps, cam, samples, out, xres, yres)  # warm
        sync()
        t0 = time.perf_counter()
        for _ in range(frames):
            cam.yaw += TURN / 8.0
            ps = _render_preview(ps, cam, samples, out, xres, yres)
        sync()
        dt = (time.perf_counter() - t0) / frames
    fused = getattr(ps, "_viewer_fused", None)
    print(json.dumps({
        "resolution": [xres, yres], "samples": samples, "frames": frames,
        "backend": fused[2] if fused is not None else ps.backend,
        "ms_per_frame": round(dt * 1e3, 2),
        "fps": round(1.0 / dt, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
