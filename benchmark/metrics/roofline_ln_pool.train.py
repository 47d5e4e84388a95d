"""LayerNorm + ReLU + region mean (ops/ln_pool.py, kernels #1 / #2) against
its byte bound, in the traced window.

Work per batch, from the real patches M of its real bags, bf16 rows: D's
tower (`disc_netx_out_dim`, 128) and, in ESAT (`bcb_mode: patch`, unfused),
G's embedding (the hidden width, 384) each run the op forward twice (the D
phase and the G phase) and backward once. Forward: read h [M, D],
write the region means [M / 16, D]; backward: read h and the means'
cotangent, write dh. The device time is that of the kernels named below."""
from benchmark import roofline
KERNELS = ("ln_relu_region_mean", "sum_partials_kernel")


def widths(cfg) -> list:
    out = [int(cfg["disc_netx_out_dim"])]
    if cfg["bcb_mode"] == "patch" and not cfg["use_fused_embedding"]:
        out.append(int(str(cfg["bcb_dims"]).split("-")[1]))
    return out


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    b = roofline.BF16
    moved = 0.0
    for _, _, sizes in ctx.traced.shapes:
        M = float(sizes.sum())
        for D in widths(ctx.cfg):
            fwd = b * M * D + b * M / 16 * D
            bwd = 2 * b * M * D + b * M / 16 * D
            moved += 2 * fwd + bwd
    return roofline.share(roofline.bound_s(moved, 0.0), ctx.trace.seconds_of(KERNELS))
