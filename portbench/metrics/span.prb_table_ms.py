"""Host milliseconds a train step of the traced slice spends in the span
prb.table: FusedPathPRB.forward repacking the triangle table from the
materials before the PRB pair runs."""

from programspans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "prb.table")
