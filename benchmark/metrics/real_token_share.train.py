"""Real patches of real bags over the padded patch slots of the measured
window's batches (a count that repeats exactly for a seed)."""


def read(ctx):
    if ctx.kind != "train" or ctx.window is None or ctx.window.padded_tokens == 0:
        return None
    return 100.0 * ctx.window.real_tokens / ctx.window.padded_tokens
