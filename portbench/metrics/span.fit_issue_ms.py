"""Host milliseconds a train step of the traced slice spends issuing its
work: optim.fit's span fit.step less its child fit.step.loss_read (the
wait for the step's kernels)."""

from programspans import per_step_ms


def read(ctx):
    step = per_step_ms(ctx, "fit.step")
    wait = per_step_ms(ctx, "fit.step.loss_read")
    if step is None or wait is None:
        return None
    return step - wait
