"""Host wall a prefetch worker spends assembling one batch (the program's
host span `assemble`, `BucketBatcher._make_batch`; overlapped with the
steps), per batch, in the traced window."""


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
    if not steps or not spans.get("assemble", (0, 0.0))[0]:
        return None
    n, seconds = spans["assemble"]
    return 1e3 * seconds / n
