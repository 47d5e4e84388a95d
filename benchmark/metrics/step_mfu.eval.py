"""The whole 30-sample evaluation pass's share of the card's bf16 peak: the
configuration's operations (`flops.eval_pass_k30`) for the real bags of the
measured window, over the window's wall time, over 989 TFLOP/s."""
from benchmark import roofline


def read(ctx):
    if ctx.kind != "eval" or ctx.window is None or ctx.window_s <= 0:
        return None
    coef = ctx.spec.config["flops"]["eval_pass_k30"]
    ops = sum(roofline.step_flops(coef, int(n)) for _, _, sizes in ctx.window.shapes
              for n in sizes)
    return 100.0 * ops / ctx.window_s / roofline.PEAK["bf16"]
