"""Woop unit-triangle transform: the shared intersection formulation.

Every intersection sweep of the package (the plain brute oracle, the fused
path plain version and both CUDA kernels) tests ray-triangle pairs through
this transform, as `orion_tpu.ops.woop` does.

Precompute per triangle: with A = [e1 | e2 | n] (columns), n = e1 x e2,
the inverse has the closed form
    A^-1 = [ cross(e2, n) ; cross(n, e1) ; n ] / (n . n)
(rows), so a point p's barycentric/height coordinates are
M (p - v0) = M p + c with c = -M v0. A ray (o, d) hits the triangle's
plane at t = -o'_w / d'_w where o' = M o + c, d' = M d, and the
barycentrics are u = o'_u + t d'_u, v = o'_v + t d'_v.

Semantics parity with Möller-Trumbore (same predicate): det_MT = -(d . n)
and d'_w = (d . n)/|n|^2, so |d'_w| * |n|^2 == |det_MT|. Degenerate
triangles (|n|^2 <= WOOP_DEGEN, incl. padding rows with e1 = e2 = 0) get
the always-miss transform (M = 0, c = (0, 0, 1), n2 = 0).
"""

from __future__ import annotations

import numpy as np
import torch

# the reference's determinant epsilon (geometry.hpp:84)
MT_EPS = 1e-6

WOOP_ROWS = 13     # 9 (M row-major: u,v,w rows x xyz) + 3 (c) + 1 (|n|^2)
WOOP_DEGEN = 1e-12
BIG = 3.0e38       # masked-miss t (float32-representable)


def woop_rows_np(v0, e1, e2) -> np.ndarray:
    """[T, 13] float32 transform rows, precomputed in float64 on the host
    (the fused path's table; NumPy promotes through the cross products
    and division)."""
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    n = np.cross(e1, e2)
    n2 = np.sum(n * n, axis=1, keepdims=True)              # [T, 1]
    ok = n2 > WOOP_DEGEN
    safe = np.where(ok, n2, 1.0)
    mu = np.cross(e2, n) / safe
    mv = np.cross(n, e1) / safe
    mw = n / safe
    m = np.where(ok, np.concatenate([mu, mv, mw], axis=1), 0.0)  # [T, 9]
    c = -np.stack([np.sum(mu * v0, axis=1), np.sum(mv * v0, axis=1),
                   np.sum(mw * v0, axis=1)], axis=1)       # [T, 3]
    c = np.where(ok, c, np.asarray([0.0, 0.0, 1.0]))
    n2 = np.where(ok, n2, 0.0)
    return np.concatenate([m, c, n2], axis=1).astype(np.float32)


def woop_rows(v0, e1, e2, valid=None) -> torch.Tensor:
    """[T, 13] float32 transform rows computed in float32 on the tensors'
    device (the brute sweep's table, as jnp computes it in the JAX
    package). Rows where `valid` is False get the always-miss transform."""
    n = torch.linalg.cross(e1, e2)
    n2 = torch.sum(n * n, dim=1, keepdim=True)               # [T, 1]
    ok = n2 > WOOP_DEGEN
    if valid is not None:
        ok = ok & valid[:, None]
    safe = torch.where(ok, n2, torch.ones_like(n2))
    mu = torch.linalg.cross(e2, n) / safe
    mv = torch.linalg.cross(n, e1) / safe
    mw = n / safe
    m = torch.where(ok, torch.cat([mu, mv, mw], dim=1),
                    torch.zeros((), dtype=n.dtype, device=n.device))
    c = -torch.stack([torch.sum(mu * v0, dim=1), torch.sum(mv * v0, dim=1),
                      torch.sum(mw * v0, dim=1)], dim=1)
    c = torch.where(ok, c, torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype,
                                        device=n.device))
    n2 = torch.where(ok, n2, torch.zeros_like(n2))
    return torch.cat([m, c, n2], dim=1).to(torch.float32)


def woop_tuv(o, d, w):
    """Masked (t, u, v) from broadcast components.

    o, d: 3-tuples of ray components; w: 13-tuple of transform components
    (the columns of woop_rows, in order). Misses carry t = BIG, u = v = 0.
    """
    ou = w[0] * o[0] + w[1] * o[1] + w[2] * o[2] + w[9]
    ov = w[3] * o[0] + w[4] * o[1] + w[5] * o[2] + w[10]
    ow = w[6] * o[0] + w[7] * o[1] + w[8] * o[2] + w[11]
    du = w[0] * d[0] + w[1] * d[1] + w[2] * d[2]
    dv = w[3] * d[0] + w[4] * d[1] + w[5] * d[2]
    dw = w[6] * d[0] + w[7] * d[1] + w[8] * d[2]
    t = -ow / dw
    u = ou + t * du
    v = ov + t * dv
    # |d'_w| * |n|^2 == |det_MT|: bitwise-identical eps semantics
    ok = (torch.abs(dw) * w[12] > MT_EPS) & (u >= 0.0) & (u <= 1.0) \
        & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return (torch.where(ok, t, torch.full((), BIG, dtype=t.dtype,
                                          device=t.device)),
            torch.where(ok, u, zero), torch.where(ok, v, zero))


def woop_t(o, d, w):
    """Masked t only (nearest-t sweeps)."""
    return woop_tuv(o, d, w)[0]


def nearest_rows(rows13: torch.Tensor, orig: torch.Tensor, dirs: torch.Tensor,
                 cap: float = BIG, budget: int = 1 << 24):
    """Nearest hit of [N] rays against [T, 13] transform rows: (t, row).

    The winner rule of every sweep in the package: min t, ties -> min row;
    misses (and hits at t >= cap) give (BIG, -1). Rays are processed in
    slices so that one [slice, T] plane holds at most `budget` elements.
    """
    N, T = orig.shape[0], rows13.shape[0]
    t_out = torch.full((N,), BIG, dtype=torch.float32, device=orig.device)
    row_out = torch.full((N,), -1, dtype=torch.int64, device=orig.device)
    if T == 0 or N == 0:
        return t_out, row_out
    step = max(1, budget // T)
    w = tuple(rows13[None, :, i] for i in range(13))
    for s in range(0, N, step):
        o = tuple(orig[s:s + step, i, None] for i in range(3))
        d = tuple(dirs[s:s + step, i, None] for i in range(3))
        t = woop_t(o, d, w)                                # [n, T]
        row = torch.argmin(t, dim=1)                       # first min
        t_min = torch.gather(t, 1, row[:, None])[:, 0]
        hit = t_min < cap
        t_out[s:s + step] = torch.where(hit, t_min, t_out[s:s + step])
        row_out[s:s + step] = torch.where(hit, row, row_out[s:s + step])
    return t_out, row_out
