"""Host wall of an evaluation pass after its last step (the program's span
`pass_end`: the stack, the pass's one device sync, the logger), per pass, in
the traced pass."""


def read(ctx):
    if ctx.kind != "eval":
        return None
    try:
        from advmil_tpu_torch.utils import tracing
    except ImportError:          # a program without its own spans
        return None
    snap = tracing.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    steps = spans.get("step", (0, 0.0))[0]
    if not steps or not spans.get("pass_end", (0, 0.0))[0]:
        return None
    n, seconds = spans["pass_end"]
    return 1e3 * seconds / n
