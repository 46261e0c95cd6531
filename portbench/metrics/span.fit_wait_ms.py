"""Host milliseconds a train step of the traced slice waits in optim.fit's
span fit.step.loss_read (float(loss): blocked until the step's kernels,
the PRB pair's above all, have ended)."""

from programspans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "fit.step.loss_read")
