"""Kernel 4 (csrc/whitted.cu): the least time of a render's work (every
nearest and shadow segment the reference's Whitted retrace traces, a
nearest segment tested against every triangle, a shadow segment up to its
first hit; the table and lights read and the image written once) over
kernel 4's device time a render in the traced slice."""

import roofline
from kernelnames import IS_K4, renders


def read(ctx):
    tr, n = ctx["trace"], renders(ctx["window"])
    if tr is None or not n:
        return None
    sz = ctx["sizes"]
    bound = roofline.megakernel_bound_s(ctx["counts"], sz["input_bytes"],
                                        sz["output_bytes"])
    return roofline.share_pct(bound * n, tr.seconds_where(IS_K4))
