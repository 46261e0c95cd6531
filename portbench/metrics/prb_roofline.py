"""The PRB pair (csrc/prb.cu, kernels 3a and 3b): each traces every
nearest and shadow segment of a step, each segment tested against every
triangle, so their summed least time a step is twice one pass's (the
table read, the image and per-sample planes written once each); over the
pair's summed device time a step in the traced slice."""

import roofline
from kernelnames import kernel, steps

IS_PRB = kernel("prb_fwd_ls_kernel", "prb_replay_kernel")


def read(ctx):
    tr, n = ctx["trace"], steps(ctx["window"])
    if tr is None or not n:
        return None
    sz = ctx["sizes"]
    bound = 2 * roofline.megakernel_bound_s(ctx["counts"], sz["input_bytes"],
                                            sz["output_bytes"])
    return roofline.share_pct(bound * n, tr.seconds_where(IS_PRB))
