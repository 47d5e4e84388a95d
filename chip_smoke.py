#!/usr/bin/env python3
"""Smoke test of advmil_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printed on its own line:
  1. device: refuses to run without CUDA; prints the card, its power limit,
     the torch / CUDA versions; turns TF32 off.
  2. build: compiles advmil_tpu_torch/csrc/*.cu with nvcc (one process per
     source, all at once).
  3. kernels against their plain PyTorch versions on the card, at the main
     path's shapes, in f32 and bf16, with CUDA-event timings: LN-pool forward
     and backward, flash forward (p = 0 and p = 0.25), flash dQ and dK/dV
     (p = 0 and 0.25) with their TFLOP/s over the real keys, a mask with a
     fully masked key tile inside a bag, the p = 0 forward and the backward at
     L = 4,096 (8-warp blocks), the forward against the plain attention branch
     at L = 256 .. 2,048, the keep-mask kernel (bit for bit) and philox.cuh
     against cuRAND's Philox4x32-10; the plain LN+ReLU kernels and the fused
     Dense+LN+ReLU+pool kernels (forward, parameter backward, dx; in bf16
     also against the tight bounds of `ops/fused_embed.py`: the forward, dh,
     dW and dx against their plain versions on the kernels' own
     intermediates) with the library pair
     they replace (F.linear + LN-pool) timed beside them. Each kernel's bound
     (bytes over 3.35 TB/s against operations over the peak of their type) is
     computed from the inputs it was timed on.
  4. training: the cfg_nlst adversarial training at full width through
     `advmil_tpu_torch.main` with `test: False` (synthetic data with two long
     training bags that engage flash with dropout, seeded random init, bf16,
     2 epochs); the kernels' launch counters are reset just before and read
     just after.
  5. test mode: the same entry point with `test: True`, loading the best
     checkpoint of phase 4, then the 30-sample pass; counters reset and read
     around it.
  6. one batch of the test-mode slice in f32 on the card (kernels) against
     the same batch and weights on the CPU (plain versions).
  7. one training step's gradients of G and D in f32 on the card against the
     CPU, dropout off and zero noise, on the long training batch.
  8. PatchGCN (`bcb_mode: graph`, 3 graph layers) training on the banded
     route, bf16, 2 epochs, on 8-nearest-neighbour graphs over tissue-like
     patch rasters (written here with numpy) of the same patients.
  9. one epoch of the same on the dense route (`graph_banded: off`).
 10. graph test mode from phase 8's best checkpoint.
 11. one graph training step's gradients in f32 on the card against the CPU,
     on each route.
 12. the phase-4 training again with `use_fused_embedding: True` (G's patch
     embedding through the fused kernels), then test mode from its best
     checkpoint; bags/s printed beside phase 4's, no gain claimed.
 13. one fused training step's gradients in f32, card against CPU, and the
     fused step against the unfused step on the card.
 14. one epoch with `use_coords_pe: True` and one with `disc_netx_ksize: 3`
     on a small split, and the ksize-3 step's f32 gradients card against CPU
     (cuDNN's TF32 is off: phase 1).
 15. the baseline handler (`--handler base`) with config/cfg_nlst_base.yaml
     as shipped (ABMIL 1024-384-384, surv_reg, f32), 2 epochs on phase 4's
     data: C-indices, prediction CSVs and best / last checkpoints.
 16. baseline test mode from phase 15's best checkpoint.
 17. one baseline step's loss and gradients in f32, card against CPU.
 18. the baseline ESAT run (`bcb_mode: patch`, surv_reg: the MSE rule, bf16),
     1 epoch on phase 4's data: LN-pool and the flash kernels launch.
 19. one baseline epoch each of surv_cox (pt041 init, origin times) and
     surv_nll (quantile labels, `pdh_dims: 384-4`) on ABMIL, small split.
 20. baseline PatchGCN (surv_reg) on phase 8's graphs, banded route, 1 epoch.
Phase 3 also holds the graph aggregation kernels (dense and banded, forward
and backward) against their plain versions at B=2, N=16,384, C=384. Every
phase's seconds are logged. The last lines are the kernels JSON, the card
line and the result JSON. Any failure raises and exits non-zero.
"""
import json
import math
import os
import os.path as osp
import shutil
import statistics
import subprocess
import sys
import time

ROOT = osp.dirname(osp.abspath(__file__))
OUT_DIR = osp.join(ROOT, "chiprun_out")
WORK_DIR = osp.join(ROOT, "results-chip-smoke")


def log(msg):
    print(msg, flush=True)


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


SPIN_CYCLES = 1_500_000   # ~0.8 ms of device time


def _event_times(fn, reps):
    """ms of `reps` single calls of `fn` between CUDA events. A spin kernel
    goes first, so that the host enqueues the call while the device is still
    busy: the events then bracket device time alone, not the host's way to the
    launch (0.05-0.15 ms through a Python wrapper, more than some kernels)."""
    import torch
    out = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def timed_pair(kernel_fn, plain_fn, reps=10):
    """Median ms of each, timed with CUDA events in turns plain, kernel,
    kernel, plain after a warm-up."""
    import torch
    for fn in (kernel_fn, plain_fn, kernel_fn, plain_fn):
        fn()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = (_event_times(fn, reps) for fn in (plain_fn, kernel_fn, kernel_fn, plain_fn))
    return statistics.median(k1 + k2), statistics.median(p1 + p2)


def timed_one(fn, reps=20):
    """Median ms of `fn` over `reps` calls, CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    return statistics.median(_event_times(fn, reps))


# published peaks of one H100 SXM: device memory, bf16 tensor cores, f32 CUDA cores
PEAK = {"bytes": 3.35e12, "bf16": 989e12, "f32": 67e12}


def share_of(got, want, atol, rtol):
    """The largest |got - want| as a share of atol + rtol |want| (1: at the bound)."""
    a, e = got.float(), want.float()
    return float(((a - e).abs() / (atol + rtol * e.abs())).max())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes, ops, kind):
    """The least ms the card could take: the bytes the function must move
    (inputs read once, outputs written once) over the memory rate, against its
    operations over the peak of their type (`kind`: bf16 tensor cores for
    products of bf16 inputs, else f32)."""
    t_b, t_o = moved_bytes / PEAK["bytes"] * 1e3, ops / PEAK[kind] * 1e3
    return dict(bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations")


def device_ms_by_kernel(fn, calls=10):
    """Device ms per call of each kernel that `fn` launches, by name
    (torch.profiler over `calls` calls after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0 and ev.device_type.name != "CPU":
            out[ev.key] = out.get(ev.key, 0.0) + us / calls / 1e3
    return out


def away_from_relu_edge(pre, g, rows_per_g):
    """g with the rows zeroed whose ReLU input `pre` has an element within 2e-5
    of 0 (a few per cent of the regions): a rounding difference flips the ReLU
    mask there, and then kernel and plain differ by the whole cotangent,
    whichever is right."""
    near = (pre.abs() < 2e-5).any(dim=1).reshape(-1, rows_per_g).any(dim=1)
    return g * (~near)[:, None].to(g.dtype)


def pre_relu(h32, scale, bias):
    mu = h32.mean(dim=-1, keepdim=True)
    var = ((h32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return (h32 - mu) * (var + 1e-6).rsqrt() * scale + bias


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke.py "
                           "runs only on a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] {card} | torch {torch.__version__} | CUDA {torch.version.cuda} "
        f"| devices {torch.cuda.device_count()} | tf32 off")
    return card


def phase_build():
    from advmil_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(osp.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(_build.build_info.get("log", ""))
    lines = _build.build_info.get("log", "").splitlines()
    regs = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    # C7520 / C7511: ptxas serialized a kernel's wgmmas (about half the rate)
    serialized = sorted({ln.strip() for ln in lines if "Potential Performance Loss" in ln})
    log(f"[2 build] {osp.basename(_build.build_info['path'])} in {secs:.1f} s "
        f"(nvcc {_build.build_info['seconds']:.1f} s); ptxas lines: {len(regs)}; wgmma "
        f"serialized: {len(serialized)}")
    for ln in serialized:
        log(f"[2 build] {ln}")
    return secs


def phase_kernels(card):
    import torch
    from advmil_tpu_torch.ops import attention as attn
    from advmil_tpu_torch.ops import ln_pool
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    report = {}

    # LN-pool at one batch_token_budget batch: M = 32768 patches; f32 within
    # 1e-5, bf16 within the plain 2e-2 bound and `ln_pool.fwd_tol`
    worst = 0.0
    for D in (384, 128):
        h32 = torch.randn(32768, D, device=dev, generator=g)
        scale = 1.0 + 0.1 * torch.randn(D, device=dev, generator=g)
        bias = 0.1 * torch.randn(D, device=dev, generator=g)
        for dtype, atol, rtol in ((torch.float32, 1e-5, 0.0), (torch.bfloat16, 2e-2, 2e-2)):
            h = h32.to(dtype)
            got = ln_pool.ln_relu_region_mean(h, scale, bias)
            again = ln_pool.ln_relu_region_mean(h, scale, bias)
            want = ln_pool.ln_relu_region_mean_plain(h, scale, bias)
            torch.cuda.synchronize()
            err = max_abs(got, want)
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
            assert torch.equal(got, again), "ln_relu_region_mean: two calls differ"
            tight = ""
            if dtype == torch.bfloat16:
                share = share_of(got, want, **ln_pool.fwd_tol(want))
                assert share <= 1.0, f"ln_relu_region_mean: {share:.3f} of fwd_tol"
                tight = f", {share:.3f} of fwd_tol"
            k_ms, p_ms = timed_pair(lambda: ln_pool.ln_relu_region_mean(h, scale, bias),
                                    lambda: ln_pool.ln_relu_region_mean_plain(h, scale, bias))
            gbs = (h.numel() * h.element_size() + got.numel() * got.element_size()) / k_ms / 1e6
            log(f"[3 kernel] ln_relu_region_mean M=32768 D={D} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e} (atol {atol}, rtol {rtol}{tight}; two calls bit for "
                f"bit) | kernel {k_ms:.4f} ms ({gbs:.0f} GB/s) | bound "
                f"{bound(nbytes(h, got, scale, bias), 10 * h.numel(), 'f32')['bound_ms']:.4f} "
                f"ms | plain {p_ms:.4f} ms | {card}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
                if D == 384:
                    report["ln_relu_region_mean"] = dict(
                        ms=k_ms, plain_ms=p_ms, library_ms=None,
                        **bound(nbytes(h, got, scale, bias), 10 * h.numel(), "f32"))
    report["ln_relu_region_mean"]["max_abs_err"] = worst

    # flash forward: B=1 ragged bag (last 300 keys masked) + 1 fully masked bag
    L, H, Dh = 2048, 8, 48
    q32, k32, v32 = (torch.randn(2, L, H, Dh, device=dev, generator=g) for _ in range(3))
    mask = torch.ones(2, L, device=dev)
    mask[0, L - 300:] = 0.0
    mask[1] = 0.0
    worst = 0.0
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        got, lse = attn.flash_attention_fwd(q, k, v, mask)
        want = attn.masked_attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        err = max_abs(got, want)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0.0)
        if not bool((got[1] == 0).all()):
            raise AssertionError("flash: the fully masked bag is not exactly 0")
        if not bool(torch.isfinite(lse[:H]).all()):
            raise AssertionError("flash: non-finite lse on the ragged bag")
        tight = _flash_tight((got,), (q, k, v, mask), "flash forward") if dtype == torch.bfloat16 \
            else ""
        q1, k1, v1, m1 = q[:1], k[:1], v[:1], mask[:1]
        k_ms, p_ms = timed_pair(lambda: attn.flash_attention_fwd(q1, k1, v1, m1),
                                lambda: attn.masked_attention_reference(q1, k1, v1, m1))
        keys = int(m1.sum())
        tflops = 4 * L * keys * H * Dh / k_ms / 1e9
        log(f"[3 kernel] masked_flash_attention B=1 L={L} H={H} Dh={Dh} "
            f"{str(dtype)[6:]}: max_abs_err {err:.3e} (atol {atol}){tight}; fully masked "
            f"bag exactly 0 | kernel {k_ms:.4f} ms ({tflops:.2f} TFLOP/s over the {keys} "
            f"real keys) | plain {p_ms:.4f} ms | {card}")
        if dtype == torch.bfloat16:
            worst = err
            lib_ms = timed_one(_sdpa(q1, k1, v1, m1, 0.0))
            report["masked_flash_attention"] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                **bound(nbytes(q1, k1, v1, q1, m1) + 4 * H * L, 4 * L * keys * H * Dh, "bf16"))
            log(f"[3 kernel] masked_flash_attention bf16: F.scaled_dot_product_attention "
                f"(same q, k, v, key mask, p=0) {lib_ms:.4f} ms | {card}")
    report["masked_flash_attention"]["max_abs_err"] = worst
    _kernels_flash_extra(card, dev, g)
    report.update(_kernels_training(card, dev, g))
    report.update(_kernels_graph(card, dev, g))
    report.update(_kernels_embed(card, dev, g))
    return report


def _flash_tight(got, args, what):
    """Hold the bf16 flash kernels' results `got` (out, or out, dq, dk, dv)
    against the plain version that rounds where they round
    (`masked_attention_rounded(*args)`), within `rounded_tol` (2^-7 of the
    largest value + 1e-2 relative): a bound far below the values themselves,
    which a dropped term of dS or a few keys never visited exceed, while the
    plain version's bound is as large as bf16's noise on the scores. Returns
    the errors for the log line."""
    import torch
    from advmil_tpu_torch.ops import attention as attn
    want = attn.masked_attention_rounded(*args)
    want = (want,) if len(got) == 1 else want
    errs = []
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        tol = attn.rounded_tol(b)
        errs.append(f"{name} {max_abs(a, b):.3e} (atol {tol['atol']:.1e})")
        torch.testing.assert_close(a.float(), b.float(), **tol,
                                   msg=lambda m, n=name: f"{what}, {n} against the rounding "
                                                         f"plain version: {m}")
    return (f", against the plain version with the kernels' roundings {' '.join(errs)}, rtol "
            f"{tol['rtol']}")


def _kernels_flash_extra(card, dev, g):
    """Phase 3, flash beyond the two main shapes: a mask with a fully masked
    64-key tile inside a real bag (the kernels skip such tiles), forward and
    backward, f32 and bf16; the p = 0 forward and the backward (p = 0 and
    0.25) at L = 4,096, where forward and dQ run 8-warp blocks; and the bf16
    forward against the plain branch of `_masked_mha` at the bucket lengths
    around the gate, one batch_token_budget batch (2,048 regions) each."""
    import torch
    from advmil_tpu_torch.models import layers
    from advmil_tpu_torch.ops import attention as attn
    H, Dh = 8, 48

    B, L = 2, 1024
    q32, k32, v32, do32 = (torch.randn(B, L, H, Dh, device=dev, generator=g) for _ in range(4))
    mask = torch.ones(B, L, device=dev)
    mask[0, 256:320] = 0.0            # key tile 4 of bag 0 holds no real key
    mask[0, 500:530] = 0.0            # a hole across a tile edge
    mask[0, L - 100:] = 0.0
    mask[1] = 0.0
    for p in (0.0, 0.25):
        sd = 0xC0FFEE if p else None
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            q, k, v, dout = (t.to(dtype) for t in (q32, k32, v32, do32))
            out, lse = attn.flash_attention_fwd(q, k, v, mask, p, sd)
            got = (out,) + attn.flash_attention_bwd(q, k, v, mask, out, lse, dout, p, sd)
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            ref = attn.masked_attention_reference(*leaves, mask, p, sd)
            want = (ref,) + torch.autograd.grad(ref, leaves, dout)
            torch.cuda.synchronize()
            errs = []
            for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
                errs.append(f"{name} {max_abs(a, b):.3e}")
                torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                           msg=lambda m, n=name: f"flash interior tile {n}: {m}")
                if not bool((a[1] == 0).all()):
                    raise AssertionError(f"flash interior tile {name}: masked bag not exactly 0")
            for name, a in (("dk", got[2]), ("dv", got[3])):
                if not bool((a[0][mask[0] == 0] == 0).all()):
                    raise AssertionError(f"flash interior tile {name}: a masked key's gradient "
                                         "is not exactly 0")
            tight = _flash_tight(got, (q, k, v, mask, dout, p, sd), "flash interior tile") \
                if dtype == torch.bfloat16 else ""
            log(f"[3 kernel] flash, a fully masked key tile inside the bag, B={B} L={L} H={H} "
                f"Dh={Dh} p={p} {str(dtype)[6:]}: max_abs_err {' '.join(errs)} (atol {tol}, rtol "
                f"{tol}){tight}; masked keys' dk, dv and the masked bag exactly 0 | {card}")

    L = 4096
    q, k, v = (torch.randn(1, L, H, Dh, device=dev, generator=g).bfloat16() for _ in range(3))
    mask = torch.ones(1, L, device=dev)
    mask[0, L - 300:] = 0.0
    got, _ = attn.flash_attention_fwd(q, k, v, mask)
    want = attn.masked_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0.0)
    tight = _flash_tight((got,), (q, k, v, mask), "flash forward L=4096")
    k_ms, p_ms = timed_pair(lambda: attn.flash_attention_fwd(q, k, v, mask),
                            lambda: attn.masked_attention_reference(q, k, v, mask), reps=5)
    lib_ms = timed_one(_sdpa(q, k, v, mask, 0.0))
    keys = int(mask.sum())
    log(f"[3 kernel] masked_flash_attention B=1 L={L} H={H} Dh={Dh} bfloat16: max_abs_err "
        f"{max_abs(got, want):.3e} (atol 0.02){tight} | kernel {k_ms:.4f} ms "
        f"({4 * L * keys * H * Dh / k_ms / 1e9:.2f} TFLOP/s over the {keys} real keys) | plain "
        f"{p_ms:.4f} ms | F.scaled_dot_product_attention {lib_ms:.4f} ms | {card}")
    del got, want
    # the backward at L = 4,096: the grid is large enough for dQ's 8-warp blocks
    dout = torch.randn(1, L, H, Dh, device=dev, generator=g).bfloat16()
    for p in (0.0, 0.25):
        sd = 0xBEEF if p else None
        out, lse = attn.flash_attention_fwd(q, k, v, mask, p, sd)
        ops = attn.flash_bwd_inputs(q, k, v, mask, out, lse, dout)
        got = (out,) + attn.flash_attention_bwd(q, k, v, mask, out, lse, dout, p, sd)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        ref = attn.masked_attention_reference(*leaves, mask, p, sd)
        want = (ref,) + torch.autograd.grad(ref, leaves, dout)
        torch.cuda.synchronize()
        errs = []
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            errs.append(f"{name} {max_abs(a, b):.3e}")
            torch.testing.assert_close(a.float(), b.float(), atol=3e-2, rtol=3e-2,
                                       msg=lambda m, n=name: f"flash L=4096 {n}: {m}")
        del leaves, ref, want
        tight = _flash_tight(got, (q, k, v, mask, dout, p, sd), f"flash L=4096 p={p}")
        dq_ms = timed_one(lambda: attn.flash_bwd_dq(ops, p, sd), reps=10)
        dkv_ms = timed_one(lambda: attn.flash_bwd_dkv(ops, p, sd), reps=10)
        lib_ms = timed_one(_sdpa(q, k, v, mask, p, dout), reps=10)
        pairs = L * keys * H * Dh
        log(f"[3 kernel] flash backward B=1 L={L} H={H} Dh={Dh} p={p} bfloat16: max_abs_err "
            f"{' '.join(errs)} (atol 0.03, rtol 0.03){tight} | dq kernel {dq_ms:.4f} ms "
            f"({6 * pairs / dq_ms / 1e9:.2f} TFLOP/s), dk/dv kernel {dkv_ms:.4f} ms "
            f"({8 * pairs / dkv_ms / 1e9:.2f} TFLOP/s over the {keys} real keys) | "
            f"F.scaled_dot_product_attention's backward (dq, dk, dv) {lib_ms:.4f} ms | {card}")
        del out, lse, ops, got
    del q, k, v, dout

    drop = layers.Dropout(0.25).eval()
    parts = []
    for L in (256, 512, 1024, 2048):
        B = 2048 // L
        q, k, v = (torch.randn(B, L, H, Dh, device=dev, generator=g).bfloat16() for _ in range(3))
        mask = torch.ones(B, L, device=dev)
        mask[:, L - L // 8:] = 0.0
        k_ms, p_ms = timed_pair(
            lambda: attn.flash_attention_fwd(q, k, v, mask),
            lambda: layers._masked_mha(q, k, v, mask, False, 0, drop, None))
        parts.append(f"L={L} (B={B}) kernel {k_ms:.4f} ms, plain branch {p_ms:.4f} ms")
    log(f"[3 kernel] flash forward (bf16, p=0) against the plain branch of _masked_mha, one "
        f"2,048-region batch per bucket length, H={H} Dh={Dh}, 1/8 of each bag masked: "
        f"{'; '.join(parts)} | the gates stay at 2,048 (eval) and flash_min_len (training) | "
        f"{card}")


def _sdpa(q, k, v, mask, p, dout=None):
    """The library yardstick of the flash kernels: one
    `F.scaled_dot_product_attention` call on the same q, k, v [B, L, H, Dh] and
    key mask (its own dropout stream at p > 0); with `dout`, its backward
    (dq, dk and dv in one call). Timed only: the port never calls it."""
    import torch
    import torch.nn.functional as F
    keep = mask.bool()[:, None, None, :]
    if dout is None:
        return lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=keep,
            dropout_p=p)
    leaves = [t.detach().transpose(1, 2).clone().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=keep, dropout_p=p)
    do = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def _kernels_training(card, dev, g):
    """Phase 3, the training kernels: LN-pool backward, flash forward with
    dropout, flash dQ and dK/dV, the keep mask and philox.cuh."""
    import torch
    from advmil_tpu_torch.ops import attention as attn
    from advmil_tpu_torch.ops import ln_pool
    from advmil_tpu_torch.ops import philox
    report = {}

    # LN-pool backward at M = 32768, D = 384 (G) and 128 (D's netx); bf16 also
    # within bwd_tol (one rounding of dh from f32), on a cotangent zeroed for the
    # regions with a ReLU input within 2e-5 of 0 (a rounding may flip the mask)
    worst = 0.0
    for D in (384, 128):
        h32 = torch.randn(32768, D, device=dev, generator=g)
        scale = 1.0 + 0.1 * torch.randn(D, device=dev, generator=g)
        bias = 0.1 * torch.randn(D, device=dev, generator=g)
        g32 = torch.randn(2048, D, device=dev, generator=g)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            h, gout = h32.to(dtype), g32.to(dtype)
            got = ln_pool.ln_relu_region_mean_bwd(gout, h, scale, bias)
            leaves = [t.detach().clone().requires_grad_(True) for t in (h, scale, bias)]
            out = ln_pool.ln_relu_region_mean_plain(*leaves)
            plain = lambda: torch.autograd.grad(out, leaves, gout, retain_graph=True)  # noqa: E731
            want = plain()
            torch.cuda.synchronize()
            errs = [max_abs(a, b) for a, b in zip(got, want)]
            torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
            for a, b in zip(got[1:], want[1:]):
                torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-4)
            tight = ""
            if dtype == torch.bfloat16:
                g_edge = away_from_relu_edge(pre_relu(h.float(), scale, bias), gout, 16)
                dh = ln_pool.ln_relu_region_mean_bwd(g_edge, h, scale, bias)[0]
                dh_ref = torch.autograd.grad(out, leaves, g_edge, retain_graph=True)[0]
                share = share_of(dh, dh_ref, **ln_pool.bwd_tol(dh_ref))
                if not share <= 1.0:
                    raise AssertionError(f"LN-pool backward bf16 D={D}: dh {share:.2f} times "
                                         f"bwd_tol")
                tight = f"; bwd_tol used {share:.3f}"
                del dh, dh_ref, g_edge
            k_ms, p_ms = timed_pair(lambda: ln_pool.ln_relu_region_mean_bwd(gout, h, scale, bias),
                                    plain)
            by_kernel = device_ms_by_kernel(
                lambda: ln_pool.ln_relu_region_mean_bwd(gout, h, scale, bias))
            tail = sum(v for k, v in by_kernel.items() if "partials" in k)
            gbs = 2 * h.numel() * h.element_size() / k_ms / 1e6
            # bytes: h read, dh written, g as the kernel reads it, scale / bias
            # read and dscale / dbias written; beside it the count with g in f32, as the
            # earlier kernel read it
            b_now = bound(nbytes(h, h, gout, scale, bias, scale, bias), 25 * h.numel(), "f32")
            b_f32g = bound(nbytes(h, h, scale, bias, scale, bias) + 4 * gout.numel(),
                           25 * h.numel(), "f32")
            log(f"[3 kernel] ln_relu_region_mean_bwd M=32768 D={D} {str(dtype)[6:]}: "
                f"max_abs_err dh {errs[0]:.3e} (atol {tol}, rtol {tol}){tight}, dscale "
                f"{errs[1]:.3e}, dbias {errs[2]:.3e} (atol 1e-3, rtol 1e-4) | kernel "
                f"{k_ms:.4f} ms ({gbs:.0f} GB/s of h + dh; tail {tail:.4f} ms, "
                f"{tail / sum(by_kernel.values()):.1%} of the call's device time, torch.profiler) "
                f"| bound {b_now['bound_ms']:.4f} ms (g as read; with g in f32 "
                f"{b_f32g['bound_ms']:.4f}) | plain autograd bwd {p_ms:.4f} ms | {card}")
            if dtype == torch.bfloat16:
                worst = max(worst, *errs)
                if D == 384:
                    report["ln_relu_region_mean_bwd"] = dict(
                        ms=k_ms, plain_ms=p_ms, library_ms=None, **b_now)
    report["ln_relu_region_mean_bwd"]["max_abs_err"] = worst

    # flash at the training shape: B=2 L=1024 H=8 Dh=48, one ragged bag and one
    # fully masked bag; forward with p = 0.25, backward with p = 0 and 0.25
    B, L, H, Dh = 2, 1024, 8, 48
    q32, k32, v32, do32 = (torch.randn(B, L, H, Dh, device=dev, generator=g)
                           for _ in range(4))
    mask = torch.ones(B, L, device=dev)
    mask[0, L - 300:] = 0.0
    mask[1] = 0.0
    seed = 0x5EED_0F_D20F0
    scale = 1.0 / Dh ** 0.5
    for p in (0.25, 0.0):
        sd = seed if p else None
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            q, k, v, dout = (t.to(dtype) for t in (q32, k32, v32, do32))
            out, lse = attn.flash_attention_fwd(q, k, v, mask, p, sd)
            ops = attn.flash_bwd_inputs(q, k, v, mask, out, lse, dout)
            dq = attn.flash_bwd_dq(ops, p, sd) * scale
            dk, dv = attn.flash_bwd_dkv(ops, p, sd)
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            ref = attn.masked_attention_reference(*leaves, mask, p, sd)
            plain_bwd = lambda: torch.autograd.grad(ref, leaves, dout, retain_graph=True)  # noqa: E731
            want = plain_bwd()
            torch.cuda.synchronize()
            errs = {}
            for name, a, b in (("out", out, ref), ("dq", dq, want[0]), ("dk", dk, want[1]),
                               ("dv", dv, want[2])):
                errs[name] = max_abs(a, b)
                torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol, msg=name)
                if not bool((a[1] == 0).all()):
                    raise AssertionError(f"flash {name}: fully masked bag not exactly 0")
            tight = _flash_tight((out, dq, dk, dv), (q, k, v, mask, dout, p, sd),
                                 f"flash p={p}") if dtype == torch.bfloat16 else ""
            dq_ms, plain_ms = timed_pair(lambda: attn.flash_bwd_dq(ops, p, sd), plain_bwd)
            dkv_ms, _ = timed_pair(lambda: attn.flash_bwd_dkv(ops, p, sd), plain_bwd)
            # products over the real keys of the ragged bag; the masked bag needs none
            pairs = L * int(mask.sum()) * H * Dh
            line = (f"[3 kernel] flash B={B} L={L} H={H} Dh={Dh} p={p} {str(dtype)[6:]}: "
                    f"max_abs_err out {errs['out']:.3e} dq {errs['dq']:.3e} dk "
                    f"{errs['dk']:.3e} dv {errs['dv']:.3e} (atol {tol}, rtol {tol}){tight}; "
                    f"fully masked bag exactly 0")
            if p:
                f_ms, fp_ms = timed_pair(
                    lambda: attn.flash_attention_fwd(q, k, v, mask, p, sd),
                    lambda: attn.masked_attention_reference(q, k, v, mask, p, sd))
                line += (f" | fwd kernel {f_ms:.4f} ms ({4 * pairs / f_ms / 1e9:.2f} TFLOP/s), "
                         f"plain {fp_ms:.4f} ms")
            log(f"{line} | dq kernel {dq_ms:.4f} ms ({6 * pairs / dq_ms / 1e9:.2f} TFLOP/s), "
                f"dk/dv kernel {dkv_ms:.4f} ms ({8 * pairs / dkv_ms / 1e9:.2f} TFLOP/s over the "
                f"real keys), plain autograd bwd (dq, dk, dv) {plain_ms:.4f} ms | {card}")
            if dtype == torch.bfloat16:
                lib_f, lib_b = timed_one(_sdpa(q, k, v, mask, p)), \
                    timed_one(_sdpa(q, k, v, mask, p, dout))
                log(f"[3 kernel] flash bf16 p={p}: F.scaled_dot_product_attention forward "
                    f"{lib_f:.4f} ms, its backward (dq, dk, dv in one call) {lib_b:.4f} ms "
                    f"| {card}")
            if dtype == torch.bfloat16 and p:
                io = nbytes(q, k, v, out)
                report["masked_flash_attention_dropout"] = dict(
                    ms=f_ms, plain_ms=fp_ms, max_abs_err=errs["out"], library_ms=lib_f,
                    **bound(io + nbytes(mask, lse), 4 * pairs, "bf16"))
                report["flash_bwd_dq"] = dict(
                    ms=dq_ms, plain_ms=plain_ms, max_abs_err=errs["dq"], library_ms=lib_b,
                    **bound(io + nbytes(dout, dq, mask, lse), 6 * pairs, "bf16"))
                report["flash_bwd_dkv"] = dict(
                    ms=dkv_ms, plain_ms=plain_ms, max_abs_err=max(errs["dk"], errs["dv"]),
                    library_ms=lib_b,
                    **bound(io + nbytes(dout, dk, dv, mask, lse), 8 * pairs, "bf16"))

    # the keep-mask oracle, bit for bit, and philox.cuh against cuRAND
    km = philox.keep_mask(seed, B * H, L, L, 0.25, device=dev)
    kp = philox.keep_mask_plain(seed, B * H, L, L, 0.25, device=dev)
    if not torch.equal(km, kp):
        raise AssertionError(f"keep mask differs from the torch Philox in "
                             f"{int((km != kp).sum())} elements")
    rate = float(km.mean())
    k_ms, p_ms = timed_pair(lambda: philox.keep_mask(seed, B * H, L, L, 0.25, device=dev),
                            lambda: philox.keep_mask_plain(seed, B * H, L, L, 0.25, device=dev))
    ours, ref = philox.check_against_curand(1 << 16, dev)
    if not torch.equal(ours, ref):
        raise AssertionError(f"philox.cuh differs from curand_Philox4x32_10 in "
                             f"{int((ours != ref).sum())} of {ours.numel()} words")
    log(f"[3 kernel] keep_mask [{B * H}, {L}, {L}] p=0.25: bit-exact against the torch "
        f"Philox (keep rate {rate:.5f}) | kernel {k_ms:.4f} ms | plain {p_ms:.4f} ms | "
        f"philox.cuh == curand_Philox4x32_10 on {ours.shape[0]} counters | {card}")
    report["keep_mask"] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=max_abs(km, kp),
                               library_ms=None, **bound(nbytes(km), 0, "f32"))
    return report


def tissue_graph(n, rng, width=48, k=8, p_short=0.05, p_hole=0.05):
    """The [2, E] (dst, src) k-nearest-neighbour graph of n patches on a
    tissue-like raster about `width` patches wide: most rows full, a share
    `p_short` of short rows (tissue edges) and a share `p_hole` with a hole
    of 1-3 patches. Nodes are numbered in raster order; each receives from
    its k nearest patches, ties broken in a fixed (row, column) order, as a
    kNN over patch coordinates gives. Short rows and holes move the vertical
    neighbours' offsets, which makes the residual (off-band) edges."""
    import numpy as np
    rows, total = [], 0
    while total < n:
        lo, hi = 0, width
        if rng.random() < p_short:
            lo, hi = sorted(int(v) for v in rng.integers(0, width, size=2))
            hi = min(max(hi, lo + 4), width)
        cols = np.arange(lo, hi)
        if rng.random() < p_hole:
            h = int(rng.integers(lo, max(lo + 1, hi - 3)))
            cols = cols[(cols < h) | (cols >= h + int(rng.integers(1, 4)))]
        rows.append(cols)
        total += len(cols)
    rc = np.concatenate([np.stack([np.full(len(c), r), c], 1)
                         for r, c in enumerate(rows)])[:n]
    reach = 4
    grid = np.full((rc[:, 0].max() + 1 + 2 * reach, width + 2 * reach), -1, np.int64)
    grid[rc[:, 0] + reach, rc[:, 1] + reach] = np.arange(n)
    offs = np.asarray(sorted(((dr, dc) for dr in range(-reach, reach + 1)
                              for dc in range(-reach, reach + 1) if (dr, dc) != (0, 0)),
                             key=lambda o: (o[0] ** 2 + o[1] ** 2, o[0], o[1])))
    cand = grid[rc[:, 0, None] + reach + offs[None, :, 0],
                rc[:, 1, None] + reach + offs[None, :, 1]]
    take = (cand >= 0) & (np.cumsum(cand >= 0, axis=1) <= k)
    return np.stack([np.repeat(np.arange(n), take.sum(1)), cand[take]]).astype(np.int64)


def _graph_kernel_inputs(B, N, epn, rng):
    """B tissue graphs of N nodes as the batcher lays them out: dense tables
    and band tables, with node 100 of each bag left without edges and one
    sentinel u_rows slot."""
    import numpy as np
    from advmil_tpu_torch.ops import banded as tband
    from advmil_tpu_torch.ops import segment as tseg
    dense, band = [], []
    for _ in range(B):
        dst, src = tissue_graph(N, rng)
        pos = np.arange(dst.shape[0]) - np.searchsorted(dst, dst, side="left")
        esrc = np.zeros((N, epn), np.int32)
        em = np.zeros((N, epn), np.float32)
        esrc[dst, pos], em[dst, pos] = src, 1.0
        em[100] = 0.0
        dense.append((esrc, em))
        band.append(tseg.build_band_tables(esrc, em)[:2])
    u_rows = max(tseg.band_coverage(*d)[2] for d in dense)
    ut = [tband.build_u_tables(*d, bm, u_slots=u_rows + 1) for d, (_, bm) in zip(dense, band)]
    tabs = {"edge_src": np.stack([d[0] for d in dense]),
            "edge_mask": np.stack([d[1] for d in dense]),
            "band_offs": np.stack([o for o, _ in band]),
            "band_mask": np.stack([bm for _, bm in band]),
            "band_urows": np.stack([u[0] for u in ut]),
            "band_usrc": np.stack([u[1] for u in ut]),
            "band_uemask": np.stack([u[2] for u in ut]),
            "band_uinv": np.stack([tband.build_u_inv(u[0], N) for u in ut])}
    if not ((tabs["band_urows"] < N).sum(1).min() > 0 and (tabs["band_urows"] == N).any()):
        raise AssertionError("graph kernel inputs: need residual rows and a sentinel slot")
    return tabs, u_rows


def _kernels_graph(card, dev, g):
    """Phase 3, the graph aggregation kernels at B=2, N=16,384, epn=9,
    C=384: #12 / #13 (dense) on the gathered messages, #14 / #15 (the banded
    core) on the node messages, and the whole banded op (core + exact
    residual rows) against its plain twin."""
    import numpy as np
    import torch
    from advmil_tpu_torch.ops import banded as tband
    from advmil_tpu_torch.ops import segment as tseg
    B, N, epn, C = 2, 16384, 9, 384
    tabs, u_rows = _graph_kernel_inputs(B, N, epn, np.random.default_rng(3))
    tabs = {k: torch.from_numpy(v).to(dev) for k, v in tabs.items()}
    esrc, em = tabs["edge_src"].long(), tabs["edge_mask"]
    offs, bm = tabs["band_offs"], tabs["band_mask"]
    u = [tabs[k] for k in ("band_urows", "band_usrc", "band_uemask", "band_uinv")]
    bidx = torch.arange(B, device=dev)[:, None, None]
    t = torch.tensor([1.3], device=dev)
    y32 = torch.relu(torch.randn(B, N, C, device=dev, generator=g)) + 1e-7
    g32 = torch.randn(B, N, C, device=dev, generator=g)
    report = {}

    def grads(fn, x, gout):
        leaves = [x.detach().clone().requires_grad_(True), t.clone().requires_grad_(True)]
        out = fn(*leaves)
        return out, leaves, lambda: torch.autograd.grad(out, leaves, gout, retain_graph=True)

    def check(name, got, want, dtype, tag):
        errs = []
        for what, a, b in zip(("out", "dx", "dt"), got, want):
            errs.append(max_abs(a, b))
            if what == "dt":
                tol = dict(atol=0.0, rtol=1e-4)
            else:
                tol = dict(atol=1e-5, rtol=0.0) if dtype == torch.float32 else \
                    dict(atol=2e-2, rtol=2e-2)
            torch.testing.assert_close(a.float(), b.float(), **tol,
                                       msg=lambda m, w=what: f"{name} {tag} {w}: {m}")
        return errs

    for dtype in (torch.float32, torch.bfloat16):
        y, gout = y32.to(dtype), g32.to(dtype)
        tag = str(dtype)[6:]
        # dense route: #12 / #13 on the gathered [B, N, epn, C] messages
        msg = y[bidx, esrc]
        out = tseg.fused_agg_fwd(msg, em, t)
        dm, dt = tseg.fused_agg_bwd(msg, em, t, gout)
        ref, _, plain_bwd = grads(lambda m, tt: tseg.knn_edge_softmax_aggregate(m, em, tt),
                                  msg, gout)
        want = plain_bwd()
        torch.cuda.synchronize()
        errs = check("knn", (out, dm, dt), (ref, *want), dtype, tag)
        if not (bool((out[:, 100] == 0).all()) and bool((dm[em == 0] == 0).all())):
            raise AssertionError("knn: a node without edges or a masked slot is not 0")
        knn_tight = ""
        if dtype == torch.bfloat16:
            # both round once from f32: within a bf16 ulp (`knn_tol`)
            share = share_of(out, ref, **tseg.knn_tol(ref))
            if not share <= 1.0:
                raise AssertionError(f"knn forward bf16: {share:.2f} times knn_tol")
            knn_tight = f"; knn_tol used out {share:.3f}"
        f_ms, fp_ms = timed_pair(lambda: tseg.fused_agg_fwd(msg, em, t),
                                 lambda: tseg.knn_edge_softmax_aggregate(msg, em, t))
        b_ms, bp_ms = timed_pair(lambda: tseg.fused_agg_bwd(msg, em, t, gout), plain_bwd)
        gbs = 2 * msg.numel() * msg.element_size() / b_ms / 1e6
        log(f"[3 kernel] fused_knn_softmax_aggregate B={B} N={N} epn={epn} C={C} {tag}: "
            f"max_abs_err out {errs[0]:.3e} dmessages {errs[1]:.3e} dt {errs[2]:.3e} "
            f"(f32 1e-5, bf16 2e-2 + 2e-2 rel, dt 1e-4 rel){knn_tight}; empty node exactly 0 | fwd "
            f"kernel {f_ms:.4f} ms, plain {fp_ms:.4f} ms | bwd kernel {b_ms:.4f} ms "
            f"({gbs:.0f} GB/s of messages + dmessages), plain autograd bwd {bp_ms:.4f} ms "
            f"| {card}")
        # the path gathers its messages in f32 (models/backbones.py, ops/banded.py):
        # the f32 rows are the kernels' entries, the bf16 ones go beside them
        rows = (dict(ms=f_ms, plain_ms=fp_ms, max_abs_err=errs[0], library_ms=None,
                     **bound(nbytes(msg, em, out), 8 * msg.numel(), "f32")),
                dict(ms=b_ms, plain_ms=bp_ms, max_abs_err=max(errs[1:]), library_ms=None,
                     **bound(nbytes(msg, dm, em, gout), 16 * msg.numel(), "f32")))
        for name, r in zip(("fused_knn_softmax_aggregate", "fused_knn_softmax_aggregate_bwd"),
                           rows):
            if dtype == torch.float32:
                report[name] = dict(r, dtype="f32")
            else:
                report[name]["bf16"] = {k: r[k] for k in ("ms", "plain_ms", "max_abs_err",
                                                          "bound_ms", "bound_by")}
        log(f"[3 kernel] fused_knn_softmax_aggregate {tag}: bound fwd {rows[0]['bound_ms']:.4f} "
            f"ms, bwd {rows[1]['bound_ms']:.4f} ms (bytes of messages, mask, cotangent and "
            f"outputs over 3.35 TB/s) | {card}")
        del msg, dm, ref, want, plain_bwd

        # banded route: #14 / #15 on the node messages, then the whole op
        out, stats = tband.banded_core_fwd(y, offs, bm, t, save_stats=True)
        dy, dt = tband.banded_core_bwd(y, offs, bm, t, stats, gout)
        ref, _, plain_bwd = grads(lambda yy, tt: tband.banded_core_plain(yy, offs, bm, tt),
                                  y, gout)
        want = plain_bwd()
        torch.cuda.synchronize()
        errs = check("banded core", (out, dy, dt), (ref, *want), dtype, tag)
        f_ms, fp_ms = timed_pair(lambda: tband.banded_core_fwd(y, offs, bm, t, True),
                                 lambda: tband.banded_core_plain(y, offs, bm, t))
        b_ms, bp_ms = timed_pair(lambda: tband.banded_core_bwd(y, offs, bm, t, stats, gout),
                                 plain_bwd)
        whole = [grads(lambda yy, tt, k=k: tband.banded_aggregate(yy, offs, bm, *u, tt,
                                                                  use_kernels=k), y, gout)
                 for k in (True, False)]
        werrs = check("banded op", (whole[0][0], *whole[0][2]()),
                      (whole[1][0], *whole[1][2]()), dtype, tag)
        tight = ""
        if dtype == torch.bfloat16:
            # both round once from f32: within a bf16 ulp (`banded_tol`)
            shares = [share_of(a, b, **tband.banded_tol(b.float()))
                      for a, b in ((out, ref), (dy, want[0]))]
            if max(shares) > 1:
                raise AssertionError(f"banded core bf16: outside banded_tol (shares out "
                                     f"{shares[0]:.3f}, dy {shares[1]:.3f})")
            tight = f"; banded_tol used out {shares[0]:.3f} dy {shares[1]:.3f}"
        if not bool((whole[0][0][:, 100] == 0).all()):
            raise AssertionError("banded: a node without edges is not exactly 0")
        log(f"[3 kernel] banded_aggregate B={B} N={N} epn={epn} C={C} {tag}, residual rows "
            f"{u_rows} + 1 sentinel: core max_abs_err out {errs[0]:.3e} dy {errs[1]:.3e} dt "
            f"{errs[2]:.3e}; whole op (core + exact rows) out {werrs[0]:.3e} dy "
            f"{werrs[1]:.3e} dt {werrs[2]:.3e} (f32 1e-5, bf16 2e-2 + 2e-2 rel, dt 1e-4 "
            f"rel){tight}; empty node exactly 0 | fwd kernel {f_ms:.4f} ms, plain {fp_ms:.4f} ms | "
            f"bwd kernel {b_ms:.4f} ms, plain autograd bwd {bp_ms:.4f} ms | {card}")
        if dtype == torch.bfloat16:
            # the core reads y once and writes out and its statistics (lse, f32
            # out) once; the backward reads y, g and the statistics and writes dy;
            # the operations run over the epn band slots of every node and channel
            report["banded_aggregate"] = dict(
                ms=f_ms, plain_ms=fp_ms, max_abs_err=max(errs[0], werrs[0]), library_ms=None,
                **bound(nbytes(y, offs, bm, out, *stats), 8 * epn * y.numel(), "f32"))
            report["banded_aggregate_bwd"] = dict(
                ms=b_ms, plain_ms=bp_ms, max_abs_err=max(errs[1:] + werrs[1:]),
                library_ms=None,
                **bound(nbytes(y, offs, bm, gout, dy, *stats), 16 * epn * y.numel(), "f32"))
        del out, stats, dy, ref, want, plain_bwd, whole
    return report


def _kernels_embed(card, dev, g):
    """Phase 3, the patch-embedding kernels: the plain LN+ReLU (#3 / #4) and
    the fused Dense+LN+ReLU+pool (#9 forward, #11 parameter backward, #10 dx),
    each against its plain version, with the library pair the fusion replaces
    (F.linear + the LN-pool kernels) timed beside it. Cotangents are zeroed
    where a ReLU input lies within 2e-5 of 0 (`away_from_relu_edge`)."""
    import torch
    import torch.nn.functional as F
    from advmil_tpu_torch.ops import fused_embed as fe
    from advmil_tpu_torch.ops import ln_pool
    report = {}

    # #3 / #4: bounds f32 1e-5 (values and dh), bf16 2e-2 + 2e-2 rel; dscale and
    # dbias (sums over M rows) 1e-3 + 1e-4 rel, as the LN-pool backward's
    M = 32768
    worst = [0.0, 0.0]
    for D in (768, 384):
        h32 = torch.randn(M, D, device=dev, generator=g)
        scale = 1.0 + 0.1 * torch.randn(D, device=dev, generator=g)
        bias = 0.1 * torch.randn(D, device=dev, generator=g)
        g32 = away_from_relu_edge(pre_relu(h32, scale, bias),
                                  torch.randn(M, D, device=dev, generator=g), 1)
        for dtype, tol in ((torch.float32, dict(atol=1e-5, rtol=0.0)),
                           (torch.bfloat16, dict(atol=2e-2, rtol=2e-2))):
            h = h32.to(dtype)
            gout = away_from_relu_edge(pre_relu(h.float(), scale, bias), g32, 1).to(dtype)
            out = ln_pool.ln_relu_fwd(h, scale, bias)
            got = ln_pool.ln_relu_bwd(gout, h, scale, bias)
            leaves = [t.detach().clone().requires_grad_(True) for t in (h, scale, bias)]
            ref = ln_pool.ln_relu_plain(*leaves)
            plain_bwd = lambda: torch.autograd.grad(ref, leaves, gout, retain_graph=True)  # noqa: E731
            want = plain_bwd()
            torch.cuda.synchronize()
            errs = [max_abs(out, ref)] + [max_abs(a, b) for a, b in zip(got, want)]
            torch.testing.assert_close(out.float(), ref.float(), **tol)
            if dtype == torch.bfloat16:
                assert share_of(out, ref, **ln_pool.fwd_tol(ref)) <= 1.0, "ln_relu: fwd_tol"
            torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
            for a, b in zip(got[1:], want[1:]):
                torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-4)
            f_ms, fp_ms = timed_pair(lambda: ln_pool.ln_relu_fwd(h, scale, bias),
                                     lambda: ln_pool.ln_relu_plain(h, scale, bias))
            b_ms, bp_ms = timed_pair(lambda: ln_pool.ln_relu_bwd(gout, h, scale, bias),
                                     plain_bwd)
            log(f"[3 kernel] ln_relu M={M} D={D} {str(dtype)[6:]}: max_abs_err out "
                f"{errs[0]:.3e} dh {errs[1]:.3e} (f32 1e-5, bf16 2e-2 + 2e-2 rel) dscale "
                f"{errs[2]:.3e} dbias {errs[3]:.3e} (1e-3 + 1e-4 rel) | fwd kernel {f_ms:.4f} "
                f"ms ({2 * nbytes(h) / f_ms / 1e6:.0f} GB/s), plain {fp_ms:.4f} ms | bwd "
                f"kernel {b_ms:.4f} ms ({3 * nbytes(h) / b_ms / 1e6:.0f} GB/s of g + h + dh), "
                f"plain autograd bwd {bp_ms:.4f} ms | {card}")
            if dtype == torch.bfloat16:
                worst = [max(worst[0], errs[0]), max(worst[1], *errs[1:])]
                if D == 768:
                    report["ln_relu"] = dict(
                        ms=f_ms, plain_ms=fp_ms, library_ms=None,
                        **bound(nbytes(h, out, scale, bias), 10 * h.numel(), "f32"))
                    report["ln_relu_bwd"] = dict(
                        ms=b_ms, plain_ms=bp_ms, library_ms=None,
                        **bound(nbytes(gout, h, got[0], scale, bias, scale, bias),
                                25 * h.numel(), "f32"))
        del h32, g32, h, gout, out, got, leaves, ref, want, plain_bwd
    report["ln_relu"]["max_abs_err"], report["ln_relu_bwd"]["max_abs_err"] = worst

    # #9 / #10 / #11 at one batch_token_budget batch (M = 32,768 patches of
    # 1,024 features), D = 384 (G) and 128, and a ragged M (M % 64 != 0).
    # Bounds: values f32 1e-5 + 1e-4 rel; gradients f32 2e-4 + 1e-3 rel (the
    # JAX package's own for this op's sums over M); bf16 2e-2 + 2e-2 rel
    # against the plain versions with the kernels' roundings, and the tight
    # bounds that only the sums' order and the last rounding fill: the
    # forward within fwd_tol, dh within dh_tol of the plain dh rounded, dW
    # within dw_tol of the plain product of the kernel's own dh.
    K = 1024
    worst = {"out": 0.0, "dx": 0.0, "dparams": 0.0}
    for M, D in ((32768, 384), (32768, 128), (16 * 67, 384)):
        x32 = torch.randn(M, K, device=dev, generator=g)
        x32[16:32] = 0.0                                  # a fully zero (padded) region
        w = torch.randn(K, D, device=dev, generator=g) / K ** 0.5
        b = 0.1 * torch.randn(D, device=dev, generator=g)
        scale = 1.0 + 0.1 * torch.randn(D, device=dev, generator=g)
        bias = 0.1 * torch.randn(D, device=dev, generator=g)
        g32 = torch.randn(M // 16, D, device=dev, generator=g)
        g32[1] = 0.0                                      # as the region mask makes it
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            wt, bt = w.t().contiguous().to(dtype), b.to(dtype)     # the unfused layer's
            pre = pre_relu(x.float() @ w.to(dtype).float() + b, scale, bias)
            gout = away_from_relu_edge(pre, g32, 16)
            del pre
            out = fe.fused_region_embedding_fwd(x, w, b, scale, bias)
            dh, dw, db, dsc, dbi = fe.fused_region_embedding_bwd_dparams(gout, x, w, b, scale,
                                                                         bias)
            dx = fe.fused_region_embedding_bwd_dx(dh, w)
            ref = fe.fused_region_embedding_plain(x, w, b, scale, bias)
            want = fe.fused_region_embedding_bwd_plain(gout, x, w, b, scale, bias)
            torch.cuda.synchronize()
            f32 = dtype == torch.float32
            torch.testing.assert_close(out.float(), ref.float(),
                                       **(dict(atol=1e-5, rtol=1e-4) if f32 else
                                          dict(atol=2e-2, rtol=2e-2)))
            tol = dict(atol=2e-4, rtol=1e-3) if f32 else dict(atol=2e-2, rtol=2e-2)
            errs = {"out": max_abs(out, ref)}
            for name, a, e in zip(("dx", "dw", "db", "dscale", "dbias"),
                                  (dx, dw, db, dsc, dbi), want):
                errs[name] = max_abs(a, e)
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"fused embedding {name}: non-finite values")
                torch.testing.assert_close(a.float(), e.float(), **tol,
                                           msg=lambda m, n=name: f"fused embedding {n}: {m}")
            if not bool((dx[16:32] == 0).all()):
                raise AssertionError("fused embedding: dx of the zero-cotangent region is not 0")
            # dx against the plain product of the kernel's own dh: only the order
            # of the f32 sum and the last rounding differ (2^-7 rel + 2^-8 of max |dx|)
            own = fe.fused_region_embedding_bwd_dx_plain(dh, w)
            own_tol = fe.dx_tol(own)
            torch.testing.assert_close(dx.float(), own.float(), **own_tol,
                                       msg=lambda m: f"fused embedding dx against its own dh: {m}")
            line = (f"[3 kernel] fused_region_embedding M={M} K={K} D={D} {str(dtype)[6:]}: "
                    f"max_abs_err out {errs['out']:.3e} dx {errs['dx']:.3e} dw {errs['dw']:.3e} "
                    f"db {errs['db']:.3e} dscale {errs['dscale']:.3e} dbias "
                    f"{errs['dbias']:.3e} (f32 out 1e-5 + 1e-4 rel, grads 2e-4 + 1e-3 rel; "
                    f"bf16 2e-2 + 2e-2 rel); dx against the plain product of its own dh "
                    f"{max_abs(dx, own):.3e} (atol {own_tol['atol']:.1e}, rtol 2^-7)")
            del own
            if not f32:
                line += _embed_tight(out, ref, dh, dw, gout, x, w, b, scale, bias)
            if M < 32768:
                log(f"{line} | ragged M | {card}")
                continue
            leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, b, scale, bias)]
            pout = fe.fused_region_embedding_plain(*leaves)
            plain_bwd = lambda: torch.autograd.grad(pout, leaves, gout.to(dtype), retain_graph=True)  # noqa: E731
            f_ms, fp_ms = timed_pair(
                lambda: fe.fused_region_embedding_fwd(x, w, b, scale, bias),
                lambda: fe.fused_region_embedding_plain(x, w, b, scale, bias))
            p_ms, pp_ms = timed_pair(
                lambda: fe.fused_region_embedding_bwd_dparams(gout, x, w, b, scale, bias),
                plain_bwd)
            x_ms = timed_one(lambda: fe.fused_region_embedding_bwd_dx(dh, w))
            # the pair the switch replaces, never called on the fused path:
            # F.linear + LN-pool forward; LN-pool backward + F.linear's backward
            lib_f = timed_one(lambda: ln_pool.ln_relu_region_mean_fwd(F.linear(x, wt, bt),
                                                                      scale, bias))
            hh = F.linear(x, wt, bt)
            lin = [t.detach().clone().requires_grad_(True) for t in (wt, bt)]
            hl = F.linear(x, *lin)

            def lib_params():
                d = ln_pool.ln_relu_region_mean_bwd(gout, hh, scale, bias)[0]
                return torch.autograd.grad(hl, lin, d, retain_graph=True)

            lib_p = timed_one(lib_params)
            lib_x = timed_one(lambda: torch.matmul(dh, wt))
            prod = 2 * M * K * D
            kind = "f32" if f32 else "bf16"
            log(f"{line} | fwd kernel {f_ms:.4f} ms ({prod / f_ms / 1e9:.1f} TFLOP/s), plain "
                f"{fp_ms:.4f} ms, F.linear + LN-pool kernel {lib_f:.4f} ms | dparams kernels "
                f"(dh, dW) {p_ms:.4f} ms, plain autograd bwd (all five) {pp_ms:.4f} ms, "
                f"LN-pool bwd kernel + F.linear's dW, db {lib_p:.4f} ms | dx kernel {x_ms:.4f} "
                f"ms, torch.matmul {lib_x:.4f} ms | {card}")
            if not f32:
                worst = {"out": max(worst["out"], errs["out"]), "dx": max(worst["dx"], errs["dx"]),
                         "dparams": max(worst["dparams"], errs["dw"], errs["db"],
                                        errs["dscale"], errs["dbias"])}
                if D == 384:
                    small = nbytes(b, scale, bias)
                    report["fused_region_embedding"] = dict(
                        ms=f_ms, plain_ms=fp_ms, library_ms=lib_f,
                        **bound(nbytes(x, w, out) + small, prod, kind))
                    report["fused_region_embedding_bwd_dparams"] = dict(
                        ms=p_ms, plain_ms=pp_ms, library_ms=lib_p,
                        **bound(nbytes(x, w, gout, dw) + 3 * small, 2 * prod, kind))
                    report["fused_region_embedding_bwd_dx"] = dict(
                        ms=x_ms, plain_ms=pp_ms, library_ms=lib_x,
                        **bound(nbytes(dh, w, dx), prod, kind))
            del leaves, pout, plain_bwd, hh, hl, lin
        del x32, x, out, dh, dw, dx, ref, want
    report["fused_region_embedding"]["max_abs_err"] = worst["out"]
    report["fused_region_embedding_bwd_dparams"]["max_abs_err"] = worst["dparams"]
    report["fused_region_embedding_bwd_dx"]["max_abs_err"] = worst["dx"]
    return report


def _embed_tight(out, ref, dh, dw, gout, x, w, b, scale, bias):
    """The bf16 #9 / #11 against their tight bounds (ops/fused_embed.py:
    fwd_tol, dh_tol, dw_tol); raises past one, returns the shares used."""
    import torch
    from advmil_tpu_torch.ops import fused_embed as fe
    dh_ref = fe.fused_region_embedding_dh_plain(gout, x, w, b, scale, bias)[0].bfloat16()
    own = x.float().t() @ dh.float()
    shares = []
    for name, got, want, tol in (("out", out, ref, fe.fwd_tol(ref)),
                                 ("dh", dh, dh_ref, fe.dh_tol(dh_ref)),
                                 ("dW", dw, own, fe.dw_tol(own))):
        share = share_of(got, want, **tol)
        if not share <= 1.0:
            raise AssertionError(f"fused embedding bf16 {name}: {share:.2f} times its tight bound")
        shares.append(f"{name} {share:.2f}")
    del dh_ref, own
    torch.cuda.synchronize()
    return ("; tight bounds (fwd_tol, dh_tol, dw_tol against dW of its own dh) used: "
            + ", ".join(shares))


def _write_yaml(path, cfg):
    """Floats are written positionally: YAML 1.1 reads `8e-05` (no dot) as a
    string."""
    import numpy as np

    def fmt(v):
        if v is None:
            return "null"
        return np.format_float_positional(v) if isinstance(v, float) else str(v)

    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k}: {fmt(v)}\n")


COUNTERS = (("ln_relu_region_mean", "ln_pool", "LAUNCHES"),
            ("ln_relu_region_mean_bwd", "ln_pool", "LAUNCHES_BWD"),
            ("masked_flash_attention", "attention", "LAUNCHES"),
            ("masked_flash_attention_dropout", "attention", "LAUNCHES_DROPOUT"),
            ("flash_bwd_dq", "attention", "LAUNCHES_DQ"),
            ("flash_bwd_dkv", "attention", "LAUNCHES_DKV"),
            ("keep_mask", "philox", "LAUNCHES"),
            ("fused_knn_softmax_aggregate", "segment", "LAUNCHES"),
            ("fused_knn_softmax_aggregate_bwd", "segment", "LAUNCHES_BWD"),
            ("banded_aggregate", "banded", "LAUNCHES"),
            ("banded_aggregate_bwd", "banded", "LAUNCHES_BWD"),
            ("ln_relu", "ln_pool", "LAUNCHES_LNRELU"),
            ("ln_relu_bwd", "ln_pool", "LAUNCHES_LNRELU_BWD"),
            ("fused_region_embedding", "fused_embed", "LAUNCHES"),
            ("fused_region_embedding_bwd_dx", "fused_embed", "LAUNCHES_BWD_DX"),
            ("fused_region_embedding_bwd_dparams", "fused_embed", "LAUNCHES_BWD_DPARAMS"))
# kernels that no model path runs: ops with their own gradient (as in the JAX
# package) or the tests' oracle; their launches are those of phase 3
OFF_PATH = ("keep_mask", "ln_relu", "ln_relu_bwd", "fused_region_embedding_bwd_dx")


def _counter_modules():
    from advmil_tpu_torch.ops import attention, banded, fused_embed, ln_pool, philox, segment
    return {"ln_pool": ln_pool, "attention": attention, "philox": philox,
            "segment": segment, "banded": banded, "fused_embed": fused_embed}


def reset_counters():
    mods = _counter_modules()
    for _, mod, attr in COUNTERS:
        setattr(mods[mod], attr, 0)


def read_counters() -> dict:
    mods = _counter_modules()
    return {name: getattr(mods[mod], attr) for name, mod, attr in COUNTERS}


def make_data():
    """cfg_nlst-width synthetic data: 36 patients of 64-256 regions (around
    the reference's ~212), one 2,048-region test bag (the eval flash gate)
    and two training bags of 700 and 1,000 regions, whose 16,384-patch bucket
    (1,024 regions) engages flash with dropout in the G phase."""
    import numpy as np
    from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    counts = np.random.default_rng(7).integers(64, 257, size=38)
    counts[0], counts[36], counts[37] = 2048, 700, 1000
    paths = make_synthetic_dataset(osp.join(WORK_DIR, "data"), dim=1024, seed=7,
                                   feat_format="pt", region_counts=list(counts),
                                   test_pids=[f"P{i:04d}" for i in range(7)],
                                   train_pids=["P0036", "P0037"])
    log(f"[4 train] synthetic cfg_nlst-width data: 38 patients, 1024-d, regions "
        f"{int(counts[1:36].min())}-{int(counts[1:36].max())}, a test bag of 2048 and "
        f"training bags of 700 and 1000 ({time.perf_counter() - t0:.1f} s)")
    paths["region_counts"] = [int(c) for c in counts]
    return paths


def _smoke_cfg(paths, run="run", **over):
    from advmil_tpu_torch.config import read_yaml
    cfg = read_yaml(osp.join(ROOT, "config", "cfg_nlst.yaml"))
    test_dir = "test_{}-{}" if run == "run" else run + "_test_{}-{}"
    run = osp.join(WORK_DIR, run)
    cfg.update(path_patch=paths["path_patch"], path_label=paths["path_label"],
               path_coordx5=paths["path_coordx5"],
               data_split_path=paths["data_split_path"], data_split_seed=0,
               save_path=run, test_load_path=run,
               test_save_path=osp.join(WORK_DIR, test_dir), device="cuda")
    cfg.update(over)
    return cfg


def _read_csv_preds(path):
    import numpy as np
    with open(path) as f:
        rows = f.read().strip().splitlines()[1:]
    return np.asarray([float(r.split(",")[-1]) for r in rows])


def phase_train(paths, tag="4 train", run="run", fused=False):
    """Phase 4 (and 12 with `fused`): `exec` at full cfg_nlst width, bf16, 2
    epochs, on the card."""
    import json as _json
    import numpy as np
    from advmil_tpu_torch import main as port_main

    cfg = _smoke_cfg(paths, run, test=False, epochs=2, es_warmup=0,
                     use_fused_embedding=fused)
    yaml_path = osp.join(WORK_DIR, f"cfg_nlst_train_{run}.yaml")
    _write_yaml(yaml_path, cfg)
    reset_counters()
    [(handler, metrics)] = port_main.main(["--config", yaml_path, "--handler", "adv"])
    launches = read_counters()

    need = ("ln_relu_region_mean", "ln_relu_region_mean_bwd", "masked_flash_attention",
            "masked_flash_attention_dropout", "flash_bwd_dq", "flash_bwd_dkv")
    if fused:
        need += ("fused_region_embedding", "fused_region_embedding_bwd_dparams")
    for name in need:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the training path")
    if launches["fused_region_embedding_bwd_dx"]:
        raise AssertionError("the dx kernel ran although the patch features need no gradient")
    run = handler.save_dir
    for f in ("train_modelG-best.ckpt", "train_modelD-best.ckpt", "train_modelG-last.ckpt",
              "train_modelD-last.ckpt", "train_metrics-best.txt"):
        if not osp.exists(osp.join(run, f)):
            raise AssertionError(f"training wrote no {f}")
    losses = []
    with open(osp.join(run, f"{osp.basename(run)}_scalars.jsonl")) as f:
        for line in f:
            rec = _json.loads(line)
            losses += [v for k, v in rec.items() if k.startswith("train_batch/Loss")]
    if not losses or not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training losses ({len(losses)} logged)")
    for split in ("train", "validation", "test"):
        preds = _read_csv_preds(osp.join(run, f"train_best_pred_{split}.csv"))
        if not (len(preds) and np.all(np.isfinite(preds)) and preds.min() >= 0
                and preds.max() <= 1):
            raise AssertionError(f"{split} predictions not finite in [0, 1]")
        ci = dict(metrics[split])["cindex"]
        if not 0.0 <= ci <= 1.0:
            raise AssertionError(f"{split} C-index {ci!r} not in [0, 1]")
    on_cuda = all(p.is_cuda for m in (handler.gen_model, handler.disc_model)
                  for p in m.parameters())
    if not on_cuda:
        raise AssertionError("parameters are not on cuda")
    rates = " ".join(f"epoch {i + 1} {b / s:.2f} ({b} bags, {s:.3f} s);"
                     for i, (b, s) in enumerate(handler.train_timings))
    log(f"[{tag}] exec: {len(losses)} finite losses logged; best/last checkpoints; "
        f"C-index train {dict(metrics['train'])['cindex']:.4f} validation "
        f"{dict(metrics['validation'])['cindex']:.4f} test "
        f"{dict(metrics['test'])['cindex']:.4f}; predictions finite in [0, 1] | "
        f"launches {launches}")
    log(f"[{tag}] training bags/s: {rates}")
    return handler, launches


def phase_slice(paths, tag="5 slice", run="run", fused=False):
    """Phase 5 (and 12 with `fused`): test mode through the same entry point,
    loading the best checkpoint the training phase wrote."""
    import numpy as np
    import torch
    from advmil_tpu_torch import main as port_main

    cfg = _smoke_cfg(paths, run, test=True, use_fused_embedding=fused)
    yaml_path = osp.join(WORK_DIR, f"cfg_nlst_smoke_{run}.yaml")
    _write_yaml(yaml_path, cfg)

    reset_counters()
    [(handler, metrics)] = port_main.main(["--config", yaml_path, "--handler", "adv"])
    ds, batcher = handler.loaders["exec-test"]
    dist = handler._run_eval(ds, batcher, n_samples=handler.cfg["times_test_sample"],
                             rng_tag=1)
    launches = read_counters()

    ci = dict(metrics["exec-test"])["cindex"]
    if not (isinstance(ci, float) and 0.0 <= ci <= 1.0):
        raise AssertionError(f"C-index {ci!r} is not a float in [0, 1]")
    for key in ("y_hat", "f_fake", "avg_y_hat", "dist_y_hat"):
        if not np.all(np.isfinite(dist[key])):
            raise AssertionError(f"non-finite {key}")
    for key in ("y_hat", "avg_y_hat", "dist_y_hat"):
        if dist[key].min() < 0.0 or dist[key].max() > 1.0:
            raise AssertionError(f"{key} outside [0, 1]")
    if dist["dist_y_hat"].shape != (len(ds), 30, 1):
        raise AssertionError(f"dist shape {dist['dist_y_hat'].shape}")
    csv_path = osp.join(handler.save_dir, "test_mode_best_pred_exec-test.csv")
    preds = _read_csv_preds(csv_path)
    if len(preds) != len(ds):
        raise AssertionError(f"CSV has {len(preds)} rows for {len(ds)} patients")
    if not (np.all(np.isfinite(preds)) and preds.min() >= 0 and preds.max() <= 1):
        raise AssertionError("CSV predictions not finite in [0, 1]")
    shipped = handler._ship(next(iter(batcher.epoch_batches())))
    on_cuda = (shipped["feats"].is_cuda and shipped["feats"].dtype == torch.bfloat16
               and all(p.is_cuda for p in handler.gen_model.parameters())
               and all(p.is_cuda for p in handler.disc_model.parameters()))
    if not on_cuda:
        raise AssertionError("feats / parameters are not on cuda")
    for name in ("ln_relu_region_mean", "masked_flash_attention") + \
            (("fused_region_embedding",) if fused else ()):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the test-mode path")
    (b1, s1), (b2, s2) = handler.eval_timings[-2:]
    log(f"[{tag}] exec-test C-index {ci:.6f} (best checkpoint of its training phase) | CSV "
        f"{osp.relpath(csv_path, ROOT)} with {len(preds)} rows | feats bf16 and params "
        f"on cuda | launches {launches}")
    log(f"[{tag}] eval bags/s: test-mode pass {b1 / s1:.2f} ({b1} bags, {s1:.3f} s); "
        f"30-sample pass {b2 / s2:.2f} ({b2} bags, {s2:.3f} s)")
    return handler, launches


def phase_gpu_vs_cpu(handler):
    import torch
    from advmil_tpu_torch.train.handler import build_models
    from advmil_tpu_torch.train.steps import make_eval_step

    _, batcher = handler.loaders["exec-test"]
    batch = list(batcher.epoch_batches())[-1]   # the largest bucket (2048 regions)
    cfg32 = dict(handler.cfg, precision="f32")
    outs = {}
    for dev in ("cuda", "cpu"):
        G, D = build_models(cfg32)
        G.load_state_dict(handler.gen_model.state_dict())
        D.load_state_dict(handler.disc_model.state_dict())
        G.to(dev).eval()
        D.to(dev).eval()
        step = make_eval_step(G, D, n_samples=1, zero_noise=True)
        out = step({"feats": torch.from_numpy(batch.feats).to(dev),
                    "mask": torch.from_numpy(batch.mask).to(dev)})
        outs[dev] = {k: v.float().cpu() for k, v in out.items()}
    diff = {k: max_abs(outs["cuda"][k], outs["cpu"][k]) for k in ("y_hat", "f_fake")}
    log(f"[6 gpu-vs-cpu] f32 batch {tuple(batch.feats.shape)}: max |y_hat| diff "
        f"{diff['y_hat']:.3e}, max |f_fake| diff {diff['f_fake']:.3e} (bound 1e-4)")
    for k, d in diff.items():
        if not d <= 1e-4:
            raise AssertionError(f"GPU vs CPU {k} differs by {d}")


def _step_grads(handler, batch, dev, **over):
    """The gradients of one adversarial step (D phase, then G phase against
    the frozen D) in f32 with dropout off and zero noise, with `handler`'s
    weights, on device `dev`; `over` overrides config keys."""
    import torch
    from advmil_tpu_torch import losses
    from advmil_tpu_torch.models.layers import set_dropout_rates
    from advmil_tpu_torch.train.handler import build_models

    cfg = dict(handler.cfg, precision="f32", **over)
    G, D = build_models(cfg)
    G.load_state_dict(handler.gen_model.state_dict())
    D.load_state_dict(handler.disc_model.state_dict())
    set_dropout_rates(G.to(dev), 0.0)
    set_dropout_rates(D.to(dev), 0.0)
    feats, mask, label, smask = (torch.from_numpy(a).to(dev) for a in (
        batch.feats, batch.mask, batch.label, batch.sample_mask))
    if "coords" in batch.extra:
        extra = torch.from_numpy(batch.extra["coords"]).to(dev)
    else:
        extra = {k: torch.from_numpy(v).to(dev) for k, v in batch.extra.items()} or None
    t, e = label[:, 0], label[:, 1]
    G.eval()
    D.train()
    with torch.no_grad():
        pred = G(feats, mask, extra, zero_noise=True)
    f_real, f_fake = D(feats, (t[:, None], pred), mask)
    losses.real_fake_loss(f_real.float(), f_fake.float(), cfg["loss_netD"],
                          real_weight=(e == 1).float() * smask,
                          fake_weight=smask).backward()
    G.train()
    D.eval()
    D.requires_grad_(False)
    pred = G(feats, mask, extra, zero_noise=True)
    total = (handler.sup_loss_fn(pred[:, 0], t, e, weight=smask)
             + cfg["loss_gan_coef"] * losses.fake_generator_loss(
                 D(feats, pred, mask).float(), weight=smask)
             + losses.loss_reg_l1(G.parameters(), cfg["loss_regl1_coef"]))
    total.backward()
    return {f"{tag}.{n}": p.grad.detach().cpu()
            for tag, m in (("G", G), ("D", D))
            for n, p in m.named_parameters() if p.grad is not None}


def _compare_grads(tag, what, a, b, shape, bound_=1e-4, min_tensors=40, nets="G and D"):
    if set(a) != set(b) or len(b) < min_tensors:
        raise AssertionError(f"{tag}: gradients missing on one side")
    diffs = {k: max_abs(a[k], b[k]) for k in b}
    worst = max(diffs, key=diffs.get)
    scale = max(float(g.abs().max()) for g in b.values())
    log(f"[{tag}] f32 step on batch {shape}, {what}: gradients of {len(diffs)} {nets} "
        f"tensors, max |diff| {diffs[worst]:.3e} at {worst} (bound {bound_}; largest |grad| "
        f"{scale:.3e})")
    if not diffs[worst] <= bound_:
        raise AssertionError(f"{tag}, {what}: gradient {worst} differs by {diffs[worst]}")


def phase_gpu_vs_cpu_train(handler, batch=None, tag="7 gpu-vs-cpu train"):
    """Phases 7, 11, 13 and 14: one adversarial step's gradients in f32 on the
    card (kernels) against the CPU (plain versions), on `batch` (default: the
    long training batch)."""
    if batch is None:
        _, batcher = handler.loaders["train"]
        batch = list(batcher.epoch_batches())[-1]     # the largest bucket (1,024 regions)
    before = read_counters()
    grads = {dev: _step_grads(handler, batch, dev) for dev in ("cuda", "cpu")}
    if handler.cfg["use_fused_embedding"]:
        now = read_counters()
        for name in ("fused_region_embedding", "fused_region_embedding_bwd_dparams"):
            if now[name] <= before[name]:
                raise AssertionError(f"{tag}: the step on the card did not launch {name}")
    _compare_grads(tag, "card against CPU", grads["cuda"], grads["cpu"],
                   tuple(batch.feats.shape))
    return batch, grads["cuda"]


def phase_fused_vs_unfused(handler, batch, fused_grads):
    """Phase 13, second half: the same step on the card with the unfused
    patch embedding (Dense + LN-pool kernels) and the same weights."""
    before = read_counters()
    plain = _step_grads(handler, batch, "cuda", use_fused_embedding=False)
    now = read_counters()
    if now["fused_region_embedding"] != before["fused_region_embedding"] or \
            now["ln_relu_region_mean_bwd"] < before["ln_relu_region_mean_bwd"] + 2:
        raise AssertionError("13 fused-vs-unfused: the unfused step did not run LN-pool for "
                             "both G and D")
    _compare_grads("13 fused-vs-unfused", "fused against unfused on the card", fused_grads,
                   plain, tuple(batch.feats.shape))


def make_small_split(paths):
    """Phase 14's split: 10 training patients of 64-256 regions, the
    validation split and the test split without its 2,048-region bag."""
    import numpy as np
    from advmil_tpu_torch.utils.io import read_datasplit_npz
    train, val, test = read_datasplit_npz(paths["data_split_path"].format(0))
    drop = {"P0000", "P0036", "P0037"}
    root = osp.dirname(paths["path_label"])
    np.savez(osp.join(root, "small-split-fold0.npz"),
             train_patients=np.asarray([p for p in train if p not in drop][:10]),
             val_patients=np.asarray(val),
             test_patients=np.asarray([p for p in test if p not in drop]))
    return osp.join(root, "small-split-fold{}.npz")


def phase_option_run(paths, small_split, name, **over):
    """Phase 14: one training epoch through `advmil_tpu_torch.main` with a
    patch-embedding option switched on, on the small split."""
    from advmil_tpu_torch import main as port_main
    cfg = _smoke_cfg(paths, f"run_{name}", test=False, epochs=1, es_warmup=0,
                     data_split_path=small_split, **over)
    yaml_path = osp.join(WORK_DIR, f"cfg_nlst_{name}.yaml")
    _write_yaml(yaml_path, cfg)
    reset_counters()
    [(handler, metrics)] = port_main.main(["--config", yaml_path, "--handler", "adv"])
    launches = read_counters()
    _check_run(handler, metrics, ("train", "validation", "test"), "train_best_pred_{}.csv")
    batch = next(iter(handler.loaders["train"][1].epoch_batches()))
    extra = handler._ship(batch).get("extra")
    if over.get("use_coords_pe") and (extra is None or tuple(extra.shape) != (
            batch.feats.shape[0], batch.feats.shape[1] // 16, 2)):
        raise AssertionError("use_coords_pe: no [B, L, 2] region coordinates reached the model")
    b, sec = handler.train_timings[-1]
    used = {k: v for k, v in launches.items() if v}
    log(f"[14 {name}] exec with {over}: C-index train {dict(metrics['train'])['cindex']:.4f} "
        f"validation {dict(metrics['validation'])['cindex']:.4f} test "
        f"{dict(metrics['test'])['cindex']:.4f}; predictions finite in [0, 1]; {b / sec:.2f} "
        f"bags/s ({b} bags, {sec:.3f} s) | launches {used}")
    return handler, launches


def make_graph_data(paths):
    """Phase 8's data: the tissue graphs of the phase-4 patients (per slide,
    `graphs/<sid>.npz` with `edge_index` [2, E] (dst, src)), and a split
    without the two bags that are not 1,024-4,096 nodes apart from the one
    16,000-node training bag: P0000 (32,768) and P0036 (11,200)."""
    import numpy as np
    from advmil_tpu_torch.utils.io import read_datasplit_npz
    t0 = time.perf_counter()
    root = osp.join(WORK_DIR, "data")
    gdir = osp.join(root, "graphs")
    os.makedirs(gdir, exist_ok=True)
    rng = np.random.default_rng(11)
    for i, regions in enumerate(paths["region_counts"]):
        n = 16 * regions
        ei = tissue_graph(n, rng)
        np.savez(osp.join(gdir, f"S{i:04d}.npz"), edge_index=ei, edge_latent=ei,
                 num_nodes=np.asarray(n))
    train, val, test = read_datasplit_npz(paths["data_split_path"].format(0))
    drop = {"P0000", "P0036"}
    np.savez(osp.join(root, "graph-split-fold0.npz"),
             train_patients=np.asarray([p for p in train if p not in drop]),
             val_patients=np.asarray(val),
             test_patients=np.asarray([p for p in test if p not in drop]))
    sizes = [16 * c for i, c in enumerate(paths["region_counts"]) if i not in (0, 36)]
    log(f"[8 graph] tissue kNN graphs (k=8, raster ~48 wide, short rows and holes): "
        f"{len(sizes)} patients of {min(sizes[:-1])}-{max(sizes[:-1])} nodes and a "
        f"training bag of {sizes[-1]} ({time.perf_counter() - t0:.1f} s)")
    return {"path_graph": gdir,
            "data_split_path": osp.join(root, "graph-split-fold{}.npz")}


def _graph_cfg(paths, gpaths, run, **over):
    return _smoke_cfg(paths, bcb_mode="graph", num_graph_layers=3,
                      path_graph=gpaths["path_graph"],
                      data_split_path=gpaths["data_split_path"],
                      save_path=osp.join(WORK_DIR, run), test_load_path=osp.join(WORK_DIR, run),
                      test_save_path=osp.join(WORK_DIR, run + "_test_{}-{}"),
                      test_mask_ratio=0.0, **over)


def _check_run(handler, metrics, splits, csv_fmt, unit=True):
    """Every split's C-index in [0, 1] and its CSV predictions finite (and
    in [0, 1] with `unit`: a sigmoid output or a survival curve); parameters
    on the card."""
    import numpy as np
    for split in splits:
        preds = _read_csv_preds(osp.join(handler.save_dir, csv_fmt.format(split)))
        if not (len(preds) and np.all(np.isfinite(preds))):
            raise AssertionError(f"{split} predictions not finite")
        if unit and not (preds.min() >= 0 and preds.max() <= 1):
            raise AssertionError(f"{split} predictions not in [0, 1]")
        ci = dict(metrics[split])["cindex"]
        if not 0.0 <= ci <= 1.0:
            raise AssertionError(f"{split} C-index {ci!r} not in [0, 1]")
    models = ((handler.model,) if hasattr(handler, "model")
              else (handler.gen_model, handler.disc_model))
    if not all(p.is_cuda for m in models for p in m.parameters()):
        raise AssertionError("parameters are not on cuda")


def phase_graph_train(paths, gpaths, banded: bool):
    """Phases 8 and 9: PatchGCN training through `advmil_tpu_torch.main` at
    full width, bf16, on the banded route (2 epochs) or the dense route
    (`graph_banded: off`, 1 epoch)."""
    from advmil_tpu_torch import main as port_main
    run = "graph_run" if banded else "graph_run_dense"
    cfg = _graph_cfg(paths, gpaths, run, test=False, epochs=2 if banded else 1, es_warmup=0,
                     graph_banded="auto" if banded else "off")
    yaml_path = osp.join(WORK_DIR, f"{run}.yaml")
    _write_yaml(yaml_path, cfg)
    reset_counters()
    [(handler, metrics)] = port_main.main(["--config", yaml_path, "--handler", "adv"])
    launches = read_counters()
    need = (("banded_aggregate", "banded_aggregate_bwd") if banded else
            ("fused_knn_softmax_aggregate", "fused_knn_softmax_aggregate_bwd"))
    for name in need + ("ln_relu_region_mean", "ln_relu_region_mean_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the graph "
                                 f"{'banded' if banded else 'dense'} training path")
    _check_run(handler, metrics, ("train", "validation", "test"), "train_best_pred_{}.csv")
    phase = "8 graph train banded" if banded else "9 graph train dense"
    route = ""
    for split, (_, batcher) in handler.loaders.items():
        if batcher.band_on != banded:
            raise AssertionError(f"{split}: the batcher took the wrong route")
        if banded:
            if not 0.7 <= batcher.coverage <= 0.99:
                raise AssertionError(f"{split}: band coverage {batcher.coverage} not in "
                                     "[0.7, 0.99]")
            tabs = list(batcher._tab_cache.values())
            if not tabs or any(not (t["band_urows"] < t["_bucket_n"]).any() for t in tabs):
                raise AssertionError(f"{split}: a bag without residual rows")
            route += f" {split} coverage {batcher.coverage:.3f} ({len(tabs)} bags, all " \
                     "with residual rows);"
    rates = " ".join(f"epoch {i + 1} {b / s:.2f} ({b} bags, {s:.3f} s);"
                     for i, (b, s) in enumerate(handler.train_timings))
    log(f"[{phase}] exec{route} C-index train {dict(metrics['train'])['cindex']:.4f} "
        f"validation {dict(metrics['validation'])['cindex']:.4f} test "
        f"{dict(metrics['test'])['cindex']:.4f}; predictions finite in [0, 1] | launches "
        f"{launches}")
    log(f"[{phase}] training bags/s: {rates}")
    return handler, launches


def phase_graph_test(paths, gpaths):
    """Phase 10: graph test mode from phase 8's best checkpoint."""
    from advmil_tpu_torch import main as port_main
    cfg = _graph_cfg(paths, gpaths, "graph_run", test=True)
    yaml_path = osp.join(WORK_DIR, "graph_test.yaml")
    _write_yaml(yaml_path, cfg)
    reset_counters()
    [(handler, metrics)] = port_main.main(["--config", yaml_path, "--handler", "adv"])
    launches = read_counters()
    for name in ("banded_aggregate", "ln_relu_region_mean"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the graph test-mode path")
    _check_run(handler, metrics, ("exec-test",), "test_mode_best_pred_{}.csv")
    b, sec = handler.eval_timings[-1]
    log(f"[10 graph test] exec-test C-index {dict(metrics['exec-test'])['cindex']:.6f} "
        f"(best checkpoint of phase 8), {b / sec:.2f} bags/s ({b} bags, {sec:.3f} s) | "
        f"launches {launches}")
    return launches


def _first_bags(b, n):
    """The first n bags of a batch, with their extra tables."""
    from advmil_tpu_torch.data.bags import Batch
    return Batch(idx=b.idx[:n], feats=b.feats[:n], mask=b.mask[:n], label=b.label[:n],
                 sample_mask=b.sample_mask[:n], extra={k: v[:n] for k, v in b.extra.items()})


def _two_bag_batch(handler):
    """The first two bags of the training loader's first batch, with their
    graph tables (a small batch for the CPU side of phase 11)."""
    _, batcher = handler.loaders["train"]
    return _first_bags(next(iter(batcher.epoch_batches())), 2)


# ---------------------------------------------------------------------------
# phases 15-20: the baseline handler (`--handler base`)
# ---------------------------------------------------------------------------

def _base_cfg(paths, run, **over):
    """config/cfg_nlst_base.yaml as shipped, on the smoke data, on the card."""
    from advmil_tpu_torch.config import read_yaml
    cfg = read_yaml(osp.join(ROOT, "config", "cfg_nlst_base.yaml"))
    run_dir = osp.join(WORK_DIR, run)
    cfg.update(path_patch=paths["path_patch"], path_label=paths["path_label"],
               path_coordx5=paths["path_coordx5"], data_split_path=paths["data_split_path"],
               data_split_seed=0, save_path=run_dir, test_load_path=run_dir,
               test_save_path=osp.join(WORK_DIR, run + "_test_{}-{}"), device="cuda")
    cfg.update(over)
    return cfg


def _base_run(cfg, name, need=(), splits=("train", "validation", "test")):
    """One baseline run through `advmil_tpu_torch.main --handler base`, with
    the launch counters reset just before and read just after; checks the
    metrics, CSVs, checkpoints and that every kernel in `need` launched."""
    import numpy as np
    from advmil_tpu_torch import main as port_main
    yaml_path = osp.join(WORK_DIR, f"{name}.yaml")
    _write_yaml(yaml_path, cfg)
    reset_counters()
    [(handler, metrics)] = port_main.main(["--config", yaml_path, "--handler", "base"])
    launches = read_counters()
    for k in need:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the baseline path {name}")
    test_mode = splits == ("exec-test",)
    _check_run(handler, metrics, splits,
               "test_mode_best_pred_{}.csv" if test_mode else "train_best_pred_{}.csv",
               unit=handler.task != "surv_cox")
    for split in splits:
        if not np.isfinite(dict(metrics[split])["loss"]):
            raise AssertionError(f"{name}: non-finite {split} loss")
    if not test_mode:
        for f in ("train_model-best.ckpt", "train_model-last.ckpt", "train_metrics-best.txt"):
            if not osp.exists(osp.join(handler.save_dir, f)):
                raise AssertionError(f"{name} wrote no {f}")
    return handler, metrics, launches


def _base_log(tag, handler, metrics, launches, card, splits=("train", "validation", "test")):
    cis = " ".join(f"{s} {dict(metrics[s])['cindex']:.4f}" for s in splits)
    timings = handler.train_timings or handler.eval_timings[-1:]
    rates = " ".join(f"{'epoch ' + str(i + 1) if handler.train_timings else 'eval'} "
                     f"{b / s:.2f} ({b} bags, {s:.3f} s);" for i, (b, s) in enumerate(timings))
    used = {k: v for k, v in launches.items() if v}
    log(f"[{tag}] task {handler.task}, bcb_mode {handler.bcb}, precision "
        f"{handler.cfg['precision']}: C-index {cis}; predictions finite | launches {used}")
    log(f"[{tag}] {'training' if handler.train_timings else 'eval'} bags/s: {rates} | {card}")


def phase_base_train(paths, card):
    """Phase 15: cfg_nlst_base.yaml as shipped (ABMIL, surv_reg, f32), 2 epochs."""
    from advmil_tpu_torch.models.backbones import ABMIL
    cfg = _base_cfg(paths, "base_run", test=False, epochs=2, es_warmup=0)
    handler, metrics, launches = _base_run(cfg, "base_run")
    if not isinstance(handler.model.backbone, ABMIL) or handler.cfg["time_format"] != "ratio":
        raise AssertionError("cfg_nlst_base did not build ABMIL on ratio times")
    if len(handler.train_timings) != 2:
        raise AssertionError(f"{len(handler.train_timings)} epochs instead of 2")
    _base_log("15 base train", handler, metrics, launches, card)
    return handler, launches


def phase_base_test(paths, card):
    """Phase 16: baseline test mode from phase 15's best checkpoint."""
    cfg = _base_cfg(paths, "base_run", test=True)
    handler, metrics, launches = _base_run(cfg, "base_test", splits=("exec-test",))
    _base_log("16 base test", handler, metrics, launches, card, splits=("exec-test",))
    return launches


def _base_step_grads(handler, batch, dev):
    """Loss and gradients of one baseline step in f32, dropout off, with
    `handler`'s weights, on device `dev`."""
    import torch
    from advmil_tpu_torch import losses
    from advmil_tpu_torch.models.layers import XAVIER, set_dropout_rates
    from advmil_tpu_torch.train.baseline import build_survnet

    cfg = dict(handler.cfg, precision="f32")
    model = build_survnet(cfg, handler.model.out_scale, XAVIER)
    model.load_state_dict(handler.model.state_dict())
    set_dropout_rates(model.to(dev), 0.0).train()
    feats, mask, label, smask = (torch.from_numpy(a).to(dev) for a in (
        batch.feats, batch.mask, batch.label, batch.sample_mask))
    extra = {k: torch.from_numpy(v).to(dev) for k, v in batch.extra.items()} or None
    pred = model(feats, mask, extra)
    loss = handler.sup_loss_fn(pred if handler.task == "surv_nll" else pred[:, 0],
                               label[:, 0], label[:, 1], weight=smask)
    total = loss + losses.loss_reg_l1(model.parameters(), cfg["loss_regl1_coef"])
    total.backward()
    return float(total.detach()), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def phase_base_gpu_vs_cpu_train(handler):
    """Phase 17: one baseline step (the long training batch) in f32, card
    against CPU: the loss and every gradient within 1e-4."""
    _, batcher = handler.loaders["train"]
    batch = list(batcher.epoch_batches())[-1]
    (lc, gc), (lh, gh) = (_base_step_grads(handler, batch, dev) for dev in ("cuda", "cpu"))
    log(f"[17 base gpu-vs-cpu train] loss card {lc:.7f} CPU {lh:.7f} (|diff| "
        f"{abs(lc - lh):.3e}, bound 1e-4)")
    if not abs(lc - lh) <= 1e-4:
        raise AssertionError(f"baseline loss differs by {abs(lc - lh)}")
    _compare_grads("17 base gpu-vs-cpu train", "card against CPU", gc, gh,
                   tuple(batch.feats.shape), min_tensors=14, nets="SurvNet")


def phase_base_esat(paths, card):
    """Phase 18: the baseline ESAT run (surv_reg + patch: the MSE rule), bf16,
    1 epoch; #1 / #2 and the flash kernels launch."""
    cfg = _base_cfg(paths, "base_esat_run", test=False, epochs=1, es_warmup=0,
                    bcb_mode="patch", precision="bf16")
    handler, metrics, launches = _base_run(
        cfg, "base_esat_run", need=("ln_relu_region_mean", "ln_relu_region_mean_bwd",
                                    "masked_flash_attention", "masked_flash_attention_dropout",
                                    "flash_bwd_dq", "flash_bwd_dkv"))
    if handler.sup_loss_fn.func.__name__ != "mse_loss":
        raise AssertionError("surv_reg + patch did not train on the MSE")
    _base_log("18 base ESAT train", handler, metrics, launches, card)
    return launches


def phase_base_cox_nll(paths, small_split, card):
    """Phase 19: one epoch each of surv_cox and surv_nll on ABMIL."""
    import numpy as np
    from advmil_tpu_torch.models.layers import PT041, Dense
    out = {}
    for task, over in (("surv_cox", {}), ("surv_nll", {"pdh_dims": "384-4"})):
        cfg = _base_cfg(paths, f"base_{task}", test=False, epochs=1, es_warmup=0,
                        task=task, data_split_path=small_split, **over)
        handler, metrics, launches = _base_run(cfg, f"base_{task}")
        _, batcher = handler.loaders["train"]
        labels = np.concatenate([b.label for b in batcher.epoch_batches()])
        if task == "surv_cox":
            inits = {m.init for m in handler.model.modules() if isinstance(m, Dense)}
            if inits != {PT041} or handler.cfg["time_format"] != "origin" or \
                    labels[:, 0].max() <= 1.0:
                raise AssertionError("surv_cox: not pt041 init on origin times")
        else:
            bins = np.unique(labels[:, 0])
            if handler.cfg["time_format"] != "quantile" or not set(bins) <= {0, 1, 2, 3}:
                raise AssertionError(f"surv_nll: labels {bins} are not 4 quantile bins")
        _base_log(f"19 base {task}", handler, metrics, launches, card)
        out[task] = launches
    return out


def phase_base_graph(paths, gpaths, card):
    """Phase 20: baseline PatchGCN (surv_reg) on phase 8's tissue graphs,
    banded route, 1 epoch; #12-#15 launch."""
    cfg = _base_cfg(paths, "base_graph_run", test=False, epochs=1, es_warmup=0,
                    bcb_mode="graph", num_graph_layers=3, path_graph=gpaths["path_graph"],
                    data_split_path=gpaths["data_split_path"], graph_banded="auto")
    handler, metrics, launches = _base_run(
        cfg, "base_graph_run", need=("banded_aggregate", "banded_aggregate_bwd",
                                     "fused_knn_softmax_aggregate",
                                     "fused_knn_softmax_aggregate_bwd"))
    if not handler.loaders["train"][1].band_on:
        raise AssertionError("the baseline graph run did not take the banded route")
    _base_log("20 base graph train", handler, metrics, launches, card)
    return launches


SOURCES = {
    "ln_relu_region_mean": ("advmil_tpu_torch/csrc/ln_pool.cu", "advmil_tpu/ops/ln_pool.py:67"),
    "ln_relu_region_mean_bwd": ("advmil_tpu_torch/csrc/ln_pool.cu",
                                "advmil_tpu/ops/ln_pool.py:74"),
    # the bf16 kernels, which the main path runs; the f32 ones and the C entry
    # points are in flash_fwd.cu / flash_bwd.cu / fused_embed.cu
    "masked_flash_attention": ("advmil_tpu_torch/csrc/flash_fwd_mma.cu",
                               "advmil_tpu/ops/attention.py:85"),
    "masked_flash_attention_dropout": ("advmil_tpu_torch/csrc/flash_fwd_mma.cu",
                                       "advmil_tpu/ops/attention.py:85"),
    "flash_bwd_dq": ("advmil_tpu_torch/csrc/flash_dq_mma.cu", "advmil_tpu/ops/attention.py:138"),
    "flash_bwd_dkv": ("advmil_tpu_torch/csrc/flash_dkv_mma.cu",
                      "advmil_tpu/ops/attention.py:182"),
    "keep_mask": ("advmil_tpu_torch/csrc/keep_mask.cu", "advmil_tpu/ops/attention.py:505"),
    "fused_knn_softmax_aggregate": ("advmil_tpu_torch/csrc/knn_agg.cu",
                                    "advmil_tpu/ops/segment.py:162"),
    "fused_knn_softmax_aggregate_bwd": ("advmil_tpu_torch/csrc/knn_agg.cu",
                                        "advmil_tpu/ops/segment.py:167"),
    "banded_aggregate": ("advmil_tpu_torch/csrc/banded.cu",
                         "advmil_tpu/ops/banded_pallas.py:89"),
    "banded_aggregate_bwd": ("advmil_tpu_torch/csrc/banded.cu",
                             "advmil_tpu/ops/banded_pallas.py:123"),
    "ln_relu": ("advmil_tpu_torch/csrc/ln_pool.cu", "advmil_tpu/ops/ln_pool.py:198"),
    "ln_relu_bwd": ("advmil_tpu_torch/csrc/ln_pool.cu", "advmil_tpu/ops/ln_pool.py:204"),
    "fused_region_embedding": ("advmil_tpu_torch/csrc/fused_embed_rows.cu",
                               "advmil_tpu/ops/fused_embed.py:35"),
    "fused_region_embedding_bwd_dx": ("advmil_tpu_torch/csrc/fused_embed_dx.cu",
                                      "advmil_tpu/ops/fused_embed.py:76"),
    # two launches: the row kernel in backward mode (dh), then dW = x^T dh
    # (csrc/fused_embed_dw.cu)
    "fused_region_embedding_bwd_dparams": ("advmil_tpu_torch/csrc/fused_embed_rows.cu",
                                           "advmil_tpu/ops/fused_embed.py:85"),
}


def timed(name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    if not osp.isdir(osp.join(ROOT, "advmil_tpu_torch")):
        raise SystemExit("chip_smoke.py runs from the root of a checkout: "
                         "advmil_tpu_torch/ not found beside it")
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    card = timed("1 device", phase_device)
    timed("2 build", phase_build)
    reset_counters()
    report = timed("3 kernels", phase_kernels, card)
    kernel_phase_launches = read_counters()
    paths = timed("4 data", make_data)
    train_handler, train_launches = timed("4 train", phase_train, paths)
    handler, test_launches = timed("5 slice", phase_slice, paths)
    timed("6 gpu-vs-cpu", phase_gpu_vs_cpu, handler)
    timed("7 gpu-vs-cpu train", phase_gpu_vs_cpu_train, train_handler)
    gpaths = timed("8 graph data", make_graph_data, paths)
    banded_handler, banded_launches = timed("8 graph train banded", phase_graph_train, paths,
                                            gpaths, True)
    dense_handler, dense_launches = timed("9 graph train dense", phase_graph_train, paths,
                                          gpaths, False)
    rate = lambda h: " / ".join(f"{b / sec:.2f}" for b, sec in h.train_timings)  # noqa: E731
    log(f"[9 graph train dense] training bags/s: banded route (phase 8, epochs 1 / 2) "
        f"{rate(banded_handler)} beside the dense route {rate(dense_handler)} (same data, one "
        f"run each: no gain claimed) | {card}")
    graph_test_launches = timed("10 graph test", phase_graph_test, paths, gpaths)
    for h, route in ((banded_handler, "banded"), (dense_handler, "dense")):
        timed(f"11 graph gpu-vs-cpu train {route}", phase_gpu_vs_cpu_train, h,
              _two_bag_batch(h), f"11 graph gpu-vs-cpu train {route}")

    fused_handler, fused_launches = timed("12 fused train", phase_train, paths,
                                          "12 fused train", "run_fused", True)
    # G's embedding went through #9 / #11; #1 / #2 ran for D's tower only: with
    # the same data and call as phase 4, every launch #1 / #2 lost is one of #9 / #11
    for plain, fused in (("ln_relu_region_mean", "fused_region_embedding"),
                         ("ln_relu_region_mean_bwd", "fused_region_embedding_bwd_dparams")):
        if train_launches[plain] != fused_launches[plain] + fused_launches[fused]:
            raise AssertionError(
                f"{plain}: {train_launches[plain]} launches unfused, {fused_launches[plain]} "
                f"+ {fused_launches[fused]} {fused} with use_fused_embedding")
    log(f"[12 fused train] training bags/s, epochs 1 / 2: fused {rate(fused_handler)} beside "
        f"phase 4's unfused {rate(train_handler)} (same data, same call, one run each: no "
        f"gain claimed) | {card}")
    _, fused_test_launches = timed("12 fused slice", phase_slice, paths, "12 fused slice",
                                   "run_fused", True)
    batch, fused_grads = timed("13 fused gpu-vs-cpu train", phase_gpu_vs_cpu_train,
                               fused_handler, None, "13 fused gpu-vs-cpu train")
    timed("13 fused-vs-unfused", phase_fused_vs_unfused, fused_handler, batch, fused_grads)
    small_split = make_small_split(paths)
    _, pe_launches = timed("14 coords_pe", phase_option_run, paths, small_split, "coords_pe",
                           use_coords_pe=True)
    k3_handler, k3_launches = timed("14 netx_ksize3", phase_option_run, paths, small_split,
                                    "netx_ksize3", disc_netx_ksize=3)
    k3_batch = next(iter(k3_handler.loaders["train"][1].epoch_batches()))
    timed("14 netx_ksize3 gpu-vs-cpu train", phase_gpu_vs_cpu_train, k3_handler,
          _first_bags(k3_batch, 2), "14 netx_ksize3 gpu-vs-cpu train")
    base_handler, base_launches = timed("15 base train", phase_base_train, paths, card)
    base_test_launches = timed("16 base test", phase_base_test, paths, card)
    timed("17 base gpu-vs-cpu train", phase_base_gpu_vs_cpu_train, base_handler)
    base_esat_launches = timed("18 base ESAT train", phase_base_esat, paths, card)
    base_cn_launches = timed("19 base cox / nll", phase_base_cox_nll, paths, small_split, card)
    base_graph_launches = timed("20 base graph train", phase_base_graph, paths, gpaths, card)
    shutil.rmtree(osp.join(WORK_DIR, "data"), ignore_errors=True)
    log(f"[time] total: {time.perf_counter() - t_start:.1f} s")

    import torch
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = report[name]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces}
        if name in OFF_PATH:
            entry.update(launches=kernel_phase_launches[name], main_path=False)
        else:
            by_path = {"train": train_launches[name], "test_mode": test_launches[name],
                       "graph_train_banded": banded_launches[name],
                       "graph_train_dense": dense_launches[name],
                       "graph_test_mode": graph_test_launches[name],
                       "fused_train": fused_launches[name],
                       "fused_test_mode": fused_test_launches[name],
                       "coords_pe_train": pe_launches[name],
                       "netx_ksize3_train": k3_launches[name],
                       "base_train": base_launches[name],
                       "base_test_mode": base_test_launches[name],
                       "base_esat_train": base_esat_launches[name],
                       "base_cox_train": base_cn_launches["surv_cox"][name],
                       "base_nll_train": base_cn_launches["surv_nll"][name],
                       "base_graph_train": base_graph_launches[name]}
            entry.update(launches=sum(by_path.values()), launches_by_path=by_path)
        if entry["launches"] <= 0:
            raise AssertionError(f"kernel {name} was never launched")
        for path, need in (("base_esat_train", ("ln_relu_region_mean",
                                                "ln_relu_region_mean_bwd")),
                           ("base_graph_train", ("fused_knn_softmax_aggregate",))):
            if name in need and entry["launches_by_path"][path] <= 0:
                raise AssertionError(f"kernel {name} was not launched on {path}")
        entry.update({k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")})
        entry.update({k: r[k] for k in ("dtype", "bf16") if k in r})
        kernels.append(entry)
    assert all(math.isfinite(k[f]) for k in kernels for f in ("ms", "plain_ms", "bound_ms"))
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
