"""Shared by the metric readers: which device operations are which kernel.

The kernel names are the program's CUDA entry points (csrc/*.cu); a
profiler trace gives them demangled, with their template arguments and
parameter lists, so a name is matched as a whole word."""

from __future__ import annotations

import re


def kernel(*names):
    """A predicate on a device operation's name: one of `names` as a whole
    word (not a suffix of a longer identifier)."""
    pat = re.compile(r"(?<![\w])(" + "|".join(map(re.escape, names))
                     + r")(?![\w])")
    return lambda name: bool(pat.search(name))


def renders(window):
    """Renders in the window, or None for a window of another loop."""
    return window.attempted if hasattr(window, "samples_per_unit") else None


def steps(window):
    """Train steps in the window, or None for a window of another loop."""
    return sum(window.steps) if hasattr(window, "samples_per_step") else None


# kernel 4, the Whitted megakernel over the brute sweep (csrc/whitted.cu)
IS_K4 = kernel("whitted_kernel")
