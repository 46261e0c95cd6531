"""Kernel 1 (csrc/fused_path.cu): the least time of a render's work (every
nearest and shadow segment the reference traces, each tested against every
triangle; the table read and the image written once) over kernel 1's
device time a render in the traced slice."""

import roofline
from kernelnames import kernel, renders

IS_K1 = kernel("fused_path_kernel")


def read(ctx):
    tr, n = ctx["trace"], renders(ctx["window"])
    if tr is None or not n:
        return None
    sz = ctx["sizes"]
    bound = roofline.megakernel_bound_s(ctx["counts"], sz["input_bytes"],
                                        sz["output_bytes"])
    return roofline.share_pct(bound * n, tr.seconds_where(IS_K1))
