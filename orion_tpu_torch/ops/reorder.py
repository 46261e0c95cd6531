"""Wavefront ray reordering: coherence keys + a stable sort.

The PyTorch counterpart of `orion_tpu.ops.reorder`. Sorting the wavefront
between bounces puts rays that share a direction octant and a spatial cell
next to each other, so the threads of a warp walk similar paths through
the tree (on the TPU the same keys make a block's shared walk short).

Key layout (int32, top bit 0):
  [dead flag (1)] [direction octant (3)] [origin morton (3*bits)]
Dead rays sort last, so whole warps of the tail are dead and leave at once.
"""

from __future__ import annotations

import torch

# 3*6 = 18 morton bits + 3 octant bits + dead flag = 22 bits < 31
MORTON_BITS = 6


def direction_octant(dirs: torch.Tensor) -> torch.Tensor:
    """3-bit direction octant per ray [N] int32."""
    return ((dirs[:, 0] >= 0).to(torch.int32)
            + 2 * (dirs[:, 1] >= 0).to(torch.int32)
            + 4 * (dirs[:, 2] >= 0).to(torch.int32))


def _part_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Spread the low `bits` bits of x so consecutive bits land 3 apart."""
    out = torch.zeros_like(x)
    for i in range(bits):
        out = out | (((x >> i) & 1) << (3 * i))
    return out


def morton3(q: torch.Tensor, bits: int = MORTON_BITS) -> torch.Tensor:
    """Interleave [N,3] int32 cell coords (each < 2**bits) into a morton
    code [N]. z gets the high bit of each triple (x fastest-varying)."""
    return (_part_bits(q[:, 0], bits)
            | (_part_bits(q[:, 1], bits) << 1)
            | (_part_bits(q[:, 2], bits) << 2))


def coherence_key(orig: torch.Tensor, dirs: torch.Tensor,
                  alive: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, *,
                  bits: int = MORTON_BITS) -> torch.Tensor:
    """[N] int32 sort key: dead-last, then octant, then origin morton.

    lo/hi: scene AABB corners [3]; origins are quantized inside it.
    """
    span = torch.clamp(hi - lo, min=1e-20)
    q = ((orig - lo) / span * float(1 << bits)).to(torch.int32)
    q = torch.clamp(q, 0, (1 << bits) - 1)
    key = (direction_octant(dirs) << (3 * bits)) | morton3(q, bits)
    dead = torch.full_like(key, 1 << (3 * bits + 3))
    return torch.where(alive, key, dead)


def scene_bounds(scene):
    """Tight AABB over the scene's valid triangles ([3] lo, [3] hi)."""
    v0, e1, e2 = (scene.tri_v0.detach(), scene.tri_e1.detach(),
                  scene.tri_e2.detach())
    v1, v2 = v0 + e1, v0 + e2
    valid = scene.tri_valid[:, None]
    big = torch.full((), 3e38, dtype=torch.float32, device=v0.device)
    los = torch.where(valid, torch.minimum(torch.minimum(v0, v1), v2), big)
    his = torch.where(valid, torch.maximum(torch.maximum(v0, v1), v2), -big)
    return torch.min(los, dim=0).values, torch.max(his, dim=0).values


def sort_permutation(key: torch.Tensor) -> torch.Tensor:
    """Stable ascending permutation of an int32 key vector."""
    return torch.argsort(key, stable=True)
