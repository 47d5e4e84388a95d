"""Share of the traced window in which no kernel, copy or set runs on the
card."""


def read(ctx):
    if ctx.kind != "eval" or ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - ctx.trace.busy_s / ctx.trace.window_s)
