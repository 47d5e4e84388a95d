#!/usr/bin/env python3
"""Device time of every kernel behind the fused patch embedding, beside the
library pair it replaces, on one CUDA GPU.

    python3 scripts/profile_fused_embed.py

For M = 32,768 patches of K = 1,024 features, D = 384 and 128, bf16 and f32:
five calls each of the forward (#9), the parameter backward (#11: the row
kernel in backward mode, the dW product and their ordered sums), dx (#10),
and `F.linear` + the LN-pool kernel, under `torch.profiler`; prints the mean
device ms per launch by kernel name (wrapper casts and transposes included),
the host's seconds to enqueue one forward call, and the largest difference
between the kernels' gradients and autograd through the plain version (which
keeps dh in f32 and does not avoid ReLU edges: a yardstick, not a bound).
`chip_smoke.py` holds the kernels to their bounds; this script is for
working on their speed.
"""
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def main():
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from advmil_tpu_torch.ops import fused_embed as fe
    from advmil_tpu_torch.ops import ln_pool

    card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    M, K = 32768, 1024
    for D in (384, 128):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(M, K, device=dev, generator=g).to(dtype)
            w = torch.randn(K, D, device=dev, generator=g) / K ** 0.5
            b = 0.1 * torch.randn(D, device=dev, generator=g)
            scale = 1 + 0.1 * torch.randn(D, device=dev, generator=g)
            bias = 0.1 * torch.randn(D, device=dev, generator=g)
            gout = torch.randn(M // 16, D, device=dev, generator=g)
            wt, bt = w.t().contiguous().to(dtype), b.to(dtype)
            dh, *grads = fe.fused_region_embedding_bwd_dparams(gout, x, w, b, scale, bias)
            leaves = [t.detach().clone().requires_grad_(True) for t in (w, b, scale, bias)]
            want = torch.autograd.grad(fe.fused_region_embedding_plain(x, *leaves), leaves,
                                       gout.to(dtype))
            errs = [chip_smoke.max_abs(a, e) for a, e in zip(grads, want)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fe.fused_region_embedding_fwd(x, w, b, scale, bias)
            host_ms = (time.perf_counter() - t0) / 20 * 1e3
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fe.fused_region_embedding_fwd(x, w, b, scale, bias)
                    fe.fused_region_embedding_bwd_dparams(gout, x, w, b, scale, bias)
                    fe.fused_region_embedding_bwd_dx(dh, w)
                    ln_pool.ln_relu_region_mean_fwd(F.linear(x, wt, bt), scale, bias)
                torch.cuda.synchronize()
            print(f"== M={M} K={K} D={D} {str(dtype)[6:]} | host enqueue of one forward call "
                  f"{host_ms:.4f} ms | max |kernel - autograd| dW {errs[0]:.3e} db {errs[1]:.3e} "
                  f"dscale {errs[2]:.3e} dbias {errs[3]:.3e} | {card}")
            rows = [(getattr(ev, "self_device_time_total", 0), ev) for ev in prof.key_averages()]
            for us, ev in sorted(rows, key=lambda r: -r[0]):
                if us > 0 and ev.device_type.name != "CPU":
                    print(f"   {us / ev.count / 1e3:9.4f} ms x{ev.count:3d}  {ev.key[:100]}")


if __name__ == "__main__":
    main()
