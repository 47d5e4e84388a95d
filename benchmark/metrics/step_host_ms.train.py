"""Host wall inside the train step (its launches and Python path; the device
runs behind it) per step, in the traced window."""


def read(ctx):
    if ctx.kind != "train" or ctx.traced is None or ctx.traced.n_steps == 0:
        return None
    return 1e3 * ctx.traced.step_s / ctx.traced.n_steps
