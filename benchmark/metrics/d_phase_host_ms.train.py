"""Host wall in the adversarial step's D phase (the program's span
`step.d`: G's prediction, D's forward and backward, `opt_D.step()`), per
step (span `step`), in the traced window."""


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
    if not steps or "step.d" not in spans:
        return None
    return 1e3 * spans["step.d"][1] / steps
