"""The yardstick's peaks and the least time a kernel could take.

A frozen copy of chip_smoke.py's bound arithmetic: the NVIDIA H100 SXM
data-sheet peaks (dense FP32 outside the tensor cores, HBM3 bandwidth) and
the operations of one ray-triangle and one ray-box test. A bound is the
larger of the operations over the FP32 peak and the bytes over the memory
peak. The counts come from the plain reference (reference.Counts), never
from the program, so a bound reads the same work whatever implements it.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 arithmetic of one Woop ray-triangle test: origin transform 3 x (3 mul
# + 3 add), direction transform 3 x (3 mul + 2 add), one divide, u/v 2 x
# (mul + add), the eps product; compares not counted
WOOP_TEST_FLOPS = 39
# FP32 arithmetic of one slab (ray-box) test: 6 subtracts, 6 multiplies
SLAB_TEST_FLOPS = 12
# floats a megakernel reads once a triangle (Woop rows, three normals,
# material; the Whitted row adds Ka, Ks and the exponent) and a point light
TABLE_ROW_FLOATS = {"path": 32, "whitted": 40}
LIGHT_FLOATS = 8


def table_bytes(integrator: str, triangles: int, lights: int = 0) -> int:
    """Bytes of the scene a megakernel of `integrator` reads once."""
    return 4 * (TABLE_ROW_FLOATS[integrator] * triangles
                + LIGHT_FLOATS * lights)


def bound_s(flops: float, nbytes: float) -> float:
    """Seconds: the larger of the two floors."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)


def search_flops(c: dict) -> float:
    """Operations of the slab and triangle tests in a count."""
    return c.get("box", 0) * SLAB_TEST_FLOPS + c.get("tri", 0) * WOOP_TEST_FLOPS


def megakernel_bound_s(counts: dict, input_bytes: float,
                       output_bytes: float) -> float:
    """One launch that traces every segment of `counts` (nearest and
    shadow) and reads its inputs and writes its outputs once."""
    flops = sum(search_flops(c) for c in counts.values())
    return bound_s(flops, input_bytes + output_bytes)


def share_pct(bound_total_s: float, device_s: float):
    """bound / time in percent, or None where there is nothing to read."""
    if not device_s or device_s <= 0.0 or not bound_total_s:
        return None
    return 100.0 * bound_total_s / device_s
