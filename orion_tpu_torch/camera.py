"""Camera model and primary-ray generation.

Reproduces the reference camera exactly (RayTracer::calculateCameraVectors,
raytracer.cpp:212-238, and the pixel loop, :69-85), as `orion_tpu.camera`:

  front = normalize(look_at - view_point)
  up    = normalize(Gram-Schmidt(front, up)) * y_view/2
  right = cross(front, normalized up) * y_view * aspect / 2
  x in [-1, 1) left->right over columns, y flipped so (-1,-1) is top-left
  dir(x, y) = front + x * right + (-y) * up        (unnormalized!)

The reference does NOT normalize primary ray directions; t is measured in
units of |dir|.
"""

from __future__ import annotations

import dataclasses

import torch

from orion_tpu_torch.io.rtc import RTCData


@dataclasses.dataclass(frozen=True)
class Camera:
    origin: torch.Tensor  # [3]
    front: torch.Tensor   # [3] unit
    up: torch.Tensor      # [3] scaled: unit-up * y_view/2
    right: torch.Tensor   # [3] scaled: unit-right * y_view*aspect/2
    xres: int = 0
    yres: int = 0

    @property
    def device(self) -> torch.device:
        return self.origin.device


def _orthogonalize(base: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt: component of v orthogonal to base (math.hpp:313-317)."""
    return v - base * (torch.dot(base, v) / torch.dot(base, base))


def camera_from_rtc(rtc: RTCData, device="cuda") -> Camera:
    """Float32 camera basis, computed on the host and moved to `device`."""
    f32 = dict(dtype=torch.float32)
    view_point = torch.tensor(rtc.view_point, **f32)
    look_at = torch.tensor(rtc.look_at, **f32)
    up = torch.tensor(rtc.vector_up, **f32)

    front = look_at - view_point
    up = _orthogonalize(front, up)
    up = up / torch.linalg.norm(up)
    front = front / torch.linalg.norm(front)
    right = torch.linalg.cross(front, up)

    up = up * torch.tensor(rtc.y_view * 0.5, **f32)
    right = right * torch.tensor(rtc.y_view * rtc.aspect_ratio * 0.5, **f32)
    return Camera(origin=view_point.to(device), front=front.to(device),
                  up=up.to(device), right=right.to(device),
                  xres=rtc.xres, yres=rtc.yres)


def primary_rays(camera: Camera, jitter_x, jitter_y):
    """One primary ray per pixel for a single sub-pixel jitter.

    jitter_x/jitter_y: scalars (or [H, W] tensors) in [0, pixel_size) NDC
    units; the reference shares one jitter pattern across all pixels
    (raytracer.cpp:53-63).

    Returns (origins [H*W, 3], directions [H*W, 3]) flattened row-major.
    """
    H, W = camera.yres, camera.xres
    dev = camera.device
    j = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    i = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    x = 2.0 * (j / W) - 1.0 + jitter_x
    y = -(2.0 * (i / H) - 1.0 + jitter_y)
    dirs = (camera.front[None, None, :]
            + x[:, :, None] * camera.right[None, None, :]
            + y[:, :, None] * camera.up[None, None, :])
    origins = camera.origin.expand(H, W, 3)
    return origins.reshape(-1, 3), dirs.reshape(-1, 3)
