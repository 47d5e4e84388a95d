"""Share of the assembled batches' patch slots that lie in tail-filler rows
(the program's counters `slots_filler` over `slots_total`, counted by the
prefetch workers in the traced window; the rest of the empty slots is
padding)."""


def read(ctx):
    if ctx.kind != "train":
        return None
    try:
        from advmil_tpu_torch.utils import tracing
    except ImportError:          # a program without its own spans
        return None
    snap = tracing.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    steps = spans.get("step", (0, 0.0))[0]
    if not steps or not counters.get("slots_total"):
        return None
    return 100.0 * counters.get("slots_filler", 0) / counters["slots_total"]
