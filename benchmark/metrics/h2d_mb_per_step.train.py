"""Megabytes of host arrays `_ship` hands to `.to(device)` (the program's
counter `h2d_bytes`), per step (span `step`), in the traced window."""


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
    if not steps or "h2d_bytes" not in counters:
        return None
    return counters["h2d_bytes"] / 1e6 / steps
