"""Host wall inside the handler's `_ship` (host batch to device tensors,
the synchronous pageable H2D copy included) per train step, in the traced
window."""


def read(ctx):
    if ctx.kind != "train" or ctx.traced is None or ctx.traced.n_steps == 0:
        return None
    return 1e3 * ctx.traced.ship_s / ctx.traced.n_steps
