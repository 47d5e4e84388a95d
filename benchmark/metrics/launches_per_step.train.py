"""Device kernels (copies and sets left out) per training step in the traced
window."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or ctx.trace.n_kernels == 0 or not ctx.traced.n_steps:
        return None
    return ctx.trace.n_kernels / ctx.traced.n_steps
