"""Rate of the host-to-device copies: the program's counter `h2d_bytes`
over the device time of the trace's `Memcpy HtoD` copies (pageable and
pinned alike), in the traced pass."""


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
    copy_s = ctx.trace.seconds_of(("Memcpy HtoD",)) if ctx.trace is not None else 0.0
    if not steps or "h2d_bytes" not in counters or copy_s <= 0:
        return None
    return counters["h2d_bytes"] / 1e9 / copy_s
