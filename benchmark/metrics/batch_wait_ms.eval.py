"""Host wall the evaluation loop waits on the main thread for the batcher's
next batch (the program's span `batch_wait`), per step (span `step`), in the
traced pass (`advmil_tpu_torch/utils/tracing.py`)."""


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
    if not steps or "batch_wait" not in spans:
        return None
    return 1e3 * spans["batch_wait"][1] / steps
