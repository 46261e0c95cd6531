"""Host milliseconds a train step of the traced slice waits in optim.fit's
span fit.step.loss_read. On the PRB routes the step's loss is read from
its own pinned host copy once that copy's event has passed: the wait is
for the work queued before the copy (the previous step's replay and
update, this step's table, 3a and the loss's reduction), not for the
whole step, whose replay may still run. On other routes it is
float(loss), a wait for every kernel queued so far."""

from programspans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "fit.step.loss_read")
