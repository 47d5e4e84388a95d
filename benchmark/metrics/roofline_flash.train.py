"""Masked flash attention (ops/attention.py: forward #5, dQ #6, dK/dV #7)
against its bound, in the traced window.

Work per real bag of n_r real regions, H * Dh = 384: the forward's two
products 4 * n_r^2 * 384 operations, the backward's four 8 * n_r^2 * 384; G in
train mode runs flash forward and backward where the batch's padded region
count reaches `flash_min_len`, and G in eval mode (the D phase) its forward
where it reaches max(flash_min_len, 2048). Bytes (q, k, v, out and their
cotangents once) are far below the products' bound at these lengths and
counted too."""
from benchmark import roofline
KERNELS = ("flash_",)
WIDTH = 384


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or ctx.cfg["bcb_mode"] != "patch":
        return None
    gate = int(ctx.cfg["flash_min_len"])
    ops = moved = 0.0
    b = roofline.BF16
    for _, N, sizes in ctx.traced.shapes:
        L = N // 16
        if L < gate:
            continue
        passes_fwd = 2 if L >= max(gate, 2048) else 1
        for n in sizes:
            r = float(n // 16)
            ops += (4 * passes_fwd + 8) * r * r * WIDTH
            moved += (4 * passes_fwd + 8) * b * r * WIDTH
    return roofline.share(roofline.bound_s(moved, ops), ctx.trace.seconds_of(KERNELS))
