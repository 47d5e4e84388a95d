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
 21. disc_gansurv training at cfg_nlst width (4 quantile bins, G's head
     384 -> 4, bf16, 2 epochs) on phase 4's data: the discrete CSVs, the
     checkpoints, and #1 at D = 384 and 128, #2 and the flash kernels launch.
 22. one disc_gansurv step through the port's step function in f32, card
     against CPU: losses within 1e-5 relative, gradients within 1e-4.
 23. semi-supervised UD+LD training at cfg_nlst width (bf16; depth cut to
     2 folds, 3 epochs): the labelled split against RandomState(seed) in
     numpy, the folds, the visible labels per epoch, the checkpoints.
 24. one UD+LD step with mixed label visibility and with every label hidden,
     card against CPU, as phase 22.
 25. phase 4's run with `accum_steps: 4`, `accum_drop_remainder: True`: the
     launches beside phase 4's, floor(batches / 4) inner steps an epoch for
     G and D, the accumulator in the checkpoints.
 26. four f32 micro-batches of the accumulated adversarial step, card
     against CPU: mean gradients within 1e-4, parameters after the inner step
     within 1e-5, bit-unchanged after mini-steps 1-3.
 27. `bcb_mode: cluster` (G on DeepAttnMISL, 8 clusters), bf16, 2 epochs,
     then its test mode: #1 at D = 128 and #2 launch, flash does not.
 28. `--handler base`, cluster, surv_nll, f32, 1 epoch: with `opt_net:
     adahessian`, and with one bag a micro-batch and a step every 16 bags.
 29. every optimizer of the factory (and lookahead_adam, AdaHessian with the
     same z), three f32 ABMIL steps, card against CPU within 1e-5.
 30. one adversarial ESAT epoch with `opt_netG: lookahead_radam`.
 31. the flash kernels #5-#7 at the sequence-parallel op's shapes: 512 local
     query rows against 1,024 keys, f32 and bf16, p = 0 and 0.25 with the
     rank's seed (seed + rank * 7919), against the plain version; two ranks'
     p = 0 results joined against the unsharded launch; CUDA-event times
     beside the unsharded kernels'.
 32. dp_devices 2 on the one card (two ranks on cuda:0 through the
     launcher's device list; gloo, which takes CUDA tensors and stages them
     through pinned host memory itself: the phase checks each collective):
     one f32 adversarial step on the long training
     batch against the single-process card step, then the cfg_nlst bf16
     2-epoch run over two ranks through `advmil_tpu_torch.main.run_one`:
     equal metrics on both ranks, each artifact written once, each rank's
     kernel launches.
 33. inst_devices 2 on the one card: one f32 adversarial ESAT step on the
     two long training bags (a bucket of 1,000 regions: flash on 500 local
     rows against 1,000 keys) and one ABMIL base step, each against the
     single-process card step; test mode from phase 32's best checkpoint
     over two inst ranks against the same test mode in one process.
 34. the offline tools: 12 CLAM-like patients written with numpy (elliptical
     tissue masks with holes on a 256-px grid, 1,500-12,000 patches a slide,
     two over 200 patches wide after cropping, 1024-d features, coordinates
     as .npy); their graphs built by the port's `build_graphs` CLI (feature
     kNN on the card); the C++ spatial kNN against torch.cdist and the card's
     feature kNN against the C++ kNN, ties aside; a slide written as a
     reference-format torch_geometric .pt graph and read back.
 35. adversarial PatchGCN at full width (1024-384-384, 3 graph layers, bf16)
     on those graphs, 2 epochs, then test mode from the best checkpoint: the
     grid route engages (compact and grid coverage, inflation printed) and
     #12-#15, #1 and #2 launch.
 36. one f32 grid-route step, card against CPU (gradients 1e-4); on the card
     the grid route against the dense route on the same two bags (bag
     embedding 1e-5, gradients 1e-4), with graph_grid_resident off and on;
     the same grid-vs-dense gradient gap on the CPU and the dense route card
     against CPU, logged beside the card's, and the dense step twice on the
     card.
 37. #14 / #15 on grid tables at cropped widths ~40, ~60 and ~220 (offset
     spans inside and past the rows the kernels stage), f32 and bf16, and
     #12 / #13 on their residual rows (f32 and bf16; two backward calls bit
     for bit), against the plain versions, with CUDA-event times and byte
     bounds; rows `<kernel>@grid_W<width>` in the kernels JSON.
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
            # torch.profiler may record no device activity (CUPTI): then not measured
            tail_txt = (f"tail {tail:.4f} ms, {tail / sum(by_kernel.values()):.1%} of the "
                        f"call's device time, torch.profiler" if by_kernel else
                        "tail not measured: torch.profiler recorded no device time")
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
                f"{k_ms:.4f} ms ({gbs:.0f} GB/s of h + dh; {tail_txt}) | bound "
                f"{b_now['bound_ms']:.4f} ms (g as read; with g in f32 "
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
        dm2, dt2 = tseg.fused_agg_bwd(msg, em, t, gout)
        ref, _, plain_bwd = grads(lambda m, tt: tseg.knn_edge_softmax_aggregate(m, em, tt),
                                  msg, gout)
        want = plain_bwd()
        torch.cuda.synchronize()
        errs = check("knn", (out, dm, dt), (ref, *want), dtype, tag)
        if not (bool((out[:, 100] == 0).all()) and bool((dm[em == 0] == 0).all())):
            raise AssertionError("knn: a node without edges or a masked slot is not 0")
        if not (torch.equal(dm, dm2) and torch.equal(dt, dt2)):
            raise AssertionError(f"knn backward {tag}: two calls differ")
        knn_tight = ""
        if dtype == torch.bfloat16:
            # both round once from f32: within a bf16 ulp (`knn_tol`, `knn_bwd_tol`)
            shares = (share_of(out, ref, **tseg.knn_tol(ref)),
                      share_of(dm, want[0], **tseg.knn_bwd_tol(want[0])))
            if not all(x <= 1.0 for x in shares):
                raise AssertionError(f"knn bf16: out / dmessages at {shares} times knn_tol / "
                                     f"knn_bwd_tol")
            knn_tight = f"; knn_tol used out {shares[0]:.3f}, knn_bwd_tol dm {shares[1]:.3f}"
        del dm2, dt2
        f_ms, fp_ms = timed_pair(lambda: tseg.fused_agg_fwd(msg, em, t),
                                 lambda: tseg.knn_edge_softmax_aggregate(msg, em, t))
        b_ms, bp_ms = timed_pair(lambda: tseg.fused_agg_bwd(msg, em, t, gout), plain_bwd)
        gbs = 2 * msg.numel() * msg.element_size() / b_ms / 1e6
        log(f"[3 kernel] fused_knn_softmax_aggregate B={B} N={N} epn={epn} C={C} {tag}: "
            f"max_abs_err out {errs[0]:.3e} dmessages {errs[1]:.3e} dt {errs[2]:.3e} "
            f"(f32 1e-5, bf16 2e-2 + 2e-2 rel, dt 1e-4 rel){knn_tight}; empty node and masked "
            f"slots exactly 0; two bwd calls bit for bit | fwd "
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
    mods["ln_pool"].LAUNCHES_BY_D.clear()
    mods["ln_pool"].LAUNCHES_BWD_BY_D.clear()


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


# ---------------------------------------------------------------------------
# phases 21-24: the adversarial handler's other training modes
# ---------------------------------------------------------------------------

# the discrete task at cfg_nlst width: 4 quantile bins, G's head 384 -> 4 hazards
DISC = {"task": "disc_gansurv", "time_format": "quantile", "time_bins": 4,
        "gen_dims": "384-4", "disc_nety_in_dim": 4}
FLASH_KERNELS = ("masked_flash_attention", "masked_flash_attention_dropout", "flash_bwd_dq",
                 "flash_bwd_dkv")


def read_widths() -> dict:
    """The LN-pool launches (#1 forward, #2 backward) by row width since the
    last reset."""
    from advmil_tpu_torch.ops import ln_pool
    return {"fwd": dict(ln_pool.LAUNCHES_BY_D), "bwd": dict(ln_pool.LAUNCHES_BWD_BY_D)}


def _adv_run(cfg, name, need, dims=(384, 128)):
    """One `--handler adv` run through `advmil_tpu_torch.main`, the launch
    counters reset just before and read just after; fails unless every kernel
    in `need` launched, and #1 (and #2, where it is needed) at each width of
    `dims`: G's (384) and D's X tower's (128). Returns (handler, metrics,
    launches, widths, printed lines)."""
    import contextlib
    import io
    from advmil_tpu_torch import main as port_main
    yaml_path = osp.join(WORK_DIR, f"{name}.yaml")
    _write_yaml(yaml_path, cfg)
    buf = io.StringIO()
    reset_counters()
    try:
        with contextlib.redirect_stdout(buf):
            [(handler, metrics)] = port_main.main(["--config", yaml_path, "--handler", "adv"])
    finally:
        sys.stdout.write(buf.getvalue())
    launches, widths = read_counters(), read_widths()
    for k in need:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the path {name}")
    for way, kernel in (("fwd", "ln_relu_region_mean"), ("bwd", "ln_relu_region_mean_bwd")):
        if kernel in need and not all(widths[way].get(d, 0) > 0 for d in dims):
            raise AssertionError(f"{name}: LN-pool {way} launches by width {widths[way]}, "
                                 f"not at each of {dims}")
    return handler, metrics, launches, widths, buf.getvalue().splitlines()


def _check_disc_csv(path, n_bins=4):
    """A discrete prediction CSV: the columns of the discrete branch, risk and
    survival finite, the survival curve in [0, 1] and falling."""
    import numpy as np
    with open(path) as f:
        header = f.readline().strip().split(",")
        rows = np.asarray([[float(v) for v in ln.strip().split(",")[1:]] for ln in f if ln.strip()])
    want = ["patient_id", "t", "e", "risk"] + [f"surf_{i + 1}" for i in range(n_bins)]
    if header != want:
        raise AssertionError(f"{path}: columns {header}, not {want}")
    surv = rows[:, 3:]
    if not (len(rows) and np.all(np.isfinite(rows[:, 2:])) and surv.min() >= 0
            and surv.max() <= 1 and np.all(np.diff(surv, axis=1) <= 0)):
        raise AssertionError(f"{path}: risk / survival not finite, in [0, 1] and falling")
    return len(rows)


def _log_adv_run(tag, handler, metrics, launches, widths, splits, card):
    cis = " ".join(f"{s} {dict(metrics[s])['cindex']:.4f}" for s in splits)
    rates = " ".join(f"epoch {i + 1} {b / s:.2f} ({b} bags, {s:.3f} s);"
                     for i, (b, s) in enumerate(handler.train_timings))
    used = {k: v for k, v in launches.items() if v}
    log(f"[{tag}] task {handler.task}, precision {handler.cfg['precision']}: C-index {cis} | "
        f"launches {used} | LN-pool launches by width {widths}")
    log(f"[{tag}] training bags/s: {rates} | {card}")


def phase_disc_train(paths, card):
    """Phase 21: disc_gansurv `exec` at cfg_nlst width (bf16, 2 epochs) on
    phase 4's data, whose 1,024-region training bucket engages the flash
    kernels."""
    import numpy as np
    cfg = _smoke_cfg(paths, "disc_run", test=False, epochs=2, es_warmup=0, **DISC)
    handler, metrics, launches, widths, _ = _adv_run(
        cfg, "disc_run", ("ln_relu_region_mean", "ln_relu_region_mean_bwd") + FLASH_KERNELS)
    splits = ("train", "validation", "test")
    for split in splits:
        n = _check_disc_csv(osp.join(handler.save_dir, f"train_best_pred_{split}.csv"))
        ci = dict(metrics[split])["cindex"]
        if not (n and np.isfinite(ci) and 0.0 <= ci <= 1.0):
            raise AssertionError(f"disc_gansurv {split}: C-index {ci!r}")
    for f in ("train_modelG-best.ckpt", "train_modelD-best.ckpt", "train_modelG-last.ckpt",
              "train_modelD-last.ckpt", "train_metrics-best.txt"):
        if not osp.exists(osp.join(handler.save_dir, f)):
            raise AssertionError(f"disc_gansurv wrote no {f}")
    if handler.evaluator.__class__.__name__ != "DiscSurvEvaluator" or \
            len(handler.train_timings) != 2:
        raise AssertionError("disc_gansurv: not the discrete evaluator, or not 2 epochs")
    _log_adv_run("21 disc train", handler, metrics, launches, widths, splits, card)
    return handler, launches


class _ZeroNoise:
    """A generator whose forward always takes zero noise (the adversarial step
    draws noise; the card and the CPU draw different noise)."""

    def __init__(self, gen):
        self.gen = gen

    def __call__(self, *args, **kwargs):
        kwargs["zero_noise"] = True
        return self.gen(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.gen, name)


def _adv_step(handler, batch, dev, visible):
    """Losses and gradients of one adversarial step through the port's own
    step function (`make_adv_train_step`) in f32, dropout off, zero noise,
    with `handler`'s weights, on device `dev`. The optimizers' rates are 0,
    so the G phase scores against the same D on both devices."""
    import torch
    from advmil_tpu_torch.models.layers import Rngs, set_dropout_rates
    from advmil_tpu_torch.train.handler import build_models
    from advmil_tpu_torch.train.steps import make_adv_train_step

    cfg = dict(handler.cfg, precision="f32")
    G, D = build_models(cfg)
    G.load_state_dict(handler.gen_model.state_dict())
    D.load_state_dict(handler.disc_model.state_dict())
    set_dropout_rates(G.to(dev), 0.0)
    set_dropout_rates(D.to(dev), 0.0)
    step = make_adv_train_step(
        _ZeroNoise(G), D, torch.optim.SGD(G.parameters(), lr=0.0),
        torch.optim.SGD(D.parameters(), lr=0.0), loss_netD=cfg["loss_netD"],
        coef_gan=cfg["loss_gan_coef"], l1_coef=cfg["loss_regl1_coef"], gen_updates=1,
        sup_loss_fn=handler.sup_loss_fn, task=handler.task, nbins=handler.nbins)
    shipped = {k: torch.from_numpy(v).to(dev) for k, v in (
        ("feats", batch.feats), ("mask", batch.mask), ("label", batch.label),
        ("sample_mask", batch.sample_mask), ("visible", visible))}
    rngs = Rngs(device=torch.Generator(device=dev).manual_seed(0),
                host=torch.Generator().manual_seed(1))
    metrics, _ = step(shipped, rngs)
    out = {k: float(v) for k, v in metrics.items()}
    grads = {f"{tag}.{n}": p.grad.detach().cpu() for tag, m in (("G", G), ("D", D))
             for n, p in m.named_parameters() if p.grad is not None}
    return out, grads


def _compare_steps(tag, handler, batch, visible, what):
    """The step on the card against the CPU: every loss within 1e-5 relative
    (exactly equal where it is 0), every gradient within 1e-4."""
    (lc, gc), (lh, gh) = (_adv_step(handler, batch, dev, visible) for dev in ("cuda", "cpu"))
    worst = 0.0
    for k in ("Loss_D", "Loss_G_total", "Loss_G_time"):
        if not (math.isfinite(lc[k]) and abs(lc[k] - lh[k]) <= 1e-5 * abs(lh[k])):
            raise AssertionError(f"{tag}: {k} card {lc[k]!r} CPU {lh[k]!r}")
        worst = max(worst, abs(lc[k] - lh[k]) / max(abs(lh[k]), 1e-30))
    log(f"[{tag}] {what}: visible {visible.tolist()}; losses card / CPU "
        + ", ".join(f"{k} {lc[k]:.7f} / {lh[k]:.7f}" for k in ("Loss_D", "Loss_G_total",
                                                              "Loss_G_time"))
        + f" (largest relative |diff| {worst:.3e}, bound 1e-5)")
    _compare_grads(tag, what, gc, gh, tuple(batch.feats.shape))
    return lc


def phase_disc_gpu_vs_cpu_train(handler):
    """Phase 22: one disc_gansurv step (the long training batch), card
    against CPU."""
    import numpy as np
    _, batcher = handler.loaders["train"]
    batch = list(batcher.epoch_batches())[-1]     # the 1,024-region bucket
    _compare_steps("22 disc gpu-vs-cpu train", handler, batch,
                   np.ones_like(batch.sample_mask), "card against CPU")


def phase_ssl_train(paths, card):
    """Phase 23: semi-supervised UD+LD training at cfg_nlst width (bf16) on
    phase 4's data; the labelled split, the folds and the visible counts are
    recomputed here with numpy."""
    import json as _json
    import numpy as np
    from advmil_tpu_torch.utils.io import read_datasplit_npz
    # depth cut: 2 folds; the early-stopping warmup is forced to ssl_kfold,
    # so the first best checkpoint is saved in epoch 3 (fold 0 again)
    cut = {"ssl_kfold": 2, "ssl_epochs": 3}
    log(f"[23 ssl train] cfg_nlst's SSL block with depth cut {cut} (shipped ssl_kfold 5, "
        "ssl_epochs 300)")
    cfg = _smoke_cfg(paths, "ssl_run", test=False, semi_training=True,
                     semi_training_mode="UD+LD", ssl_num_labeled=0.6, **cut)
    handler, metrics, launches, widths, lines = _adv_run(
        cfg, "ssl_run", ("ln_relu_region_mean", "ln_relu_region_mean_bwd"))

    pids_train = read_datasplit_npz(paths["data_split_path"].format(0))[0]
    perm = np.random.RandomState(cfg["seed"]).permutation(len(pids_train))
    labeled = [pids_train[i] for i in perm[:int(len(pids_train) * 0.6)]]
    printed = [_json.loads(ln.split("=", 1)[1]) for ln in lines
               if ln.startswith("PARITY_SSL_LABELED_JSON=")]
    if printed != [sorted(labeled)]:
        raise AssertionError(f"labelled split {printed} is not RandomState(seed)'s "
                             f"{sorted(labeled)}")
    folds = [handler.patient_id[f"fold{i}_mixed_train"] for i in range(2)]
    n_lab = len(labeled)
    rest = [f[n_lab:] for f in folds]
    if any(f[:n_lab] != labeled for f in folds) or set(rest[0]) & set(rest[1]) \
            or sorted(rest[0] + rest[1]) != sorted(set(pids_train) - set(labeled)):
        raise AssertionError("the two folds do not each hold every labelled patient and "
                             "half of the unlabelled ones")
    if handler.train_visible != [n_lab] * 3:
        raise AssertionError(f"visible labels per epoch {handler.train_visible}, not "
                             f"{[n_lab] * 3}")
    splits = ("labeled_train", "unlabeled_train", "validation", "test")
    _check_run(handler, metrics, splits, "semitrain_LD_UD_best_pred_{}.csv")
    for net in "GD":
        for ck in ("best", "last"):
            if not osp.exists(osp.join(handler.save_dir, f"semitrain_LD_UD_model{net}-{ck}.ckpt")):
                raise AssertionError(f"SSL wrote no semitrain_LD_UD_model{net}-{ck}.ckpt")
    losses = []
    with open(osp.join(handler.save_dir, f"{osp.basename(handler.save_dir)}_scalars.jsonl")) as f:
        for line in f:
            losses += [v for k, v in _json.loads(line).items() if k.startswith("train_batch/Loss")]
    if not losses or not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite SSL training losses ({len(losses)} logged)")
    log(f"[23 ssl train] labelled split = RandomState({cfg['seed']}).permutation of the "
        f"{len(pids_train)} training pids ({n_lab} labelled); folds of "
        f"{[len(f) for f in folds]} patients, unlabelled parts disjoint; visible labels per "
        f"epoch {handler.train_visible}; {len(losses)} finite losses")
    _log_adv_run("23 ssl train", handler, metrics, launches, widths, splits, card)
    return handler, launches


def phase_ssl_gpu_vs_cpu_train(handler):
    """Phase 24: one UD+LD step on a fold batch with mixed visibility, and on
    the same batch with every label hidden (the supervised weights sum to 0:
    the loss is exactly 0 on both devices), card against CPU."""
    import numpy as np
    visible_set = handler.patient_id["label_visible"]
    for name in ("fold0_mixed_train", "fold1_mixed_train"):
        ds, batcher = handler.loaders[name]
        for batch in batcher.epoch_batches():
            vis = handler._visible(ds, batch, visible_set) * batch.sample_mask
            if 0 < vis.sum() < batch.sample_mask.sum():
                break
        else:
            continue
        break
    else:
        raise AssertionError("no fold batch mixes labelled and unlabelled patients")
    _compare_steps("24 ssl gpu-vs-cpu train", handler, batch, vis, "mixed visibility")
    lc = _compare_steps("24 ssl gpu-vs-cpu train", handler, batch, np.zeros_like(vis),
                        "every label hidden")
    if lc["Loss_G_time"] != 0.0:
        raise AssertionError(f"hidden labels: supervised loss {lc['Loss_G_time']!r}, not 0")


# ---------------------------------------------------------------------------
# phases 25-30: gradient accumulation, the cluster backbone, the optimizers
# ---------------------------------------------------------------------------

LN_KERNELS = ("ln_relu_region_mean", "ln_relu_region_mean_bwd")


def _scalars_finite(handler, prefix="train_batch/"):
    """The finite training losses a run logged (raises on none or a non-finite one)."""
    import json as _json
    import numpy as np
    losses = []
    with open(osp.join(handler.save_dir, f"{osp.basename(handler.save_dir)}_scalars.jsonl")) as f:
        for line in f:
            losses += [v for k, v in _json.loads(line).items()
                       if k.startswith(prefix) and "oss" in k]
    if not losses or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{handler.save_dir}: non-finite training losses "
                             f"({len(losses)} logged)")
    return len(losses)


def phase_accum_train(paths, card, train_launches, train_widths):
    """Phase 25: phase 4's run with `accum_steps: 4` and
    `accum_drop_remainder: True` (bf16, 2 epochs, same data and seed): the
    kernels launch as in phase 4; G and D take floor(batches / 4) inner steps
    an epoch; the checkpoints carry the accumulator."""
    import torch
    from advmil_tpu_torch.train.optim import MultiSteps
    k = 4
    cfg = _smoke_cfg(paths, "accum_run", test=False, epochs=2, es_warmup=0, accum_steps=k,
                     accum_drop_remainder=True)
    handler, metrics, launches, widths, _ = _adv_run(cfg, "accum_run",
                                                     LN_KERNELS + FLASH_KERNELS)
    _check_run(handler, metrics, ("train", "validation", "test"), "train_best_pred_{}.csv")
    n_losses = _scalars_finite(handler)
    n_batches = len(list(handler.loaders["train"][1].epoch_batches()))
    per_epoch = n_batches // k
    for net, opt in (("G", handler.opt_G), ("D", handler.opt_D)):
        if not (isinstance(opt, MultiSteps) and opt.k == k and opt.mini_step == 0
                and opt.gradient_step == 2 * per_epoch):
            raise AssertionError(f"{net}: {getattr(opt, 'gradient_step', None)} inner steps in "
                                 f"2 epochs of {n_batches} batches, not 2 x {per_epoch}")
        state = torch.load(osp.join(handler.save_dir, f"train_model{net}-last.ckpt"),
                           weights_only=True)["opt_state"]
        if not {"inner", "mini_step", "gradient_step", "acc"} <= set(state):
            raise AssertionError(f"{net}'s checkpoint lacks the accumulator state")
    keys = LN_KERNELS + FLASH_KERNELS
    same = all(launches[n] == train_launches[n] for n in keys) and widths == train_widths
    log(f"[25 accum train] accum_steps {k}, drop remainder: {n_batches} batches an epoch, "
        f"inner steps an epoch G {per_epoch} D {per_epoch} (totals {handler.opt_G.gradient_step}"
        f" / {handler.opt_D.gradient_step}); {n_losses} finite losses | launches "
        f"{ {n: launches[n] for n in keys} } beside phase 4's "
        f"{ {n: train_launches[n] for n in keys} }; by width {widths} beside {train_widths}: "
        f"{'equal' if same else 'NOT equal'}")
    _log_adv_run("25 accum train", handler, metrics, launches, widths,
                 ("train", "validation", "test"), card)
    return handler, launches


def _bag_slice(b, start, n):
    from advmil_tpu_torch.data.bags import Batch
    sl = slice(start, start + n)
    return Batch(idx=b.idx[sl], feats=b.feats[sl], mask=b.mask[sl], label=b.label[sl],
                 sample_mask=b.sample_mask[sl], extra={k: v[sl] for k, v in b.extra.items()})


def _accum_run(handler, micro, dev):
    """The accumulated adversarial step (MultiSteps of len(micro) around the
    handler's optimizers) over `micro` in f32 on `dev`, dropout off, zero
    noise, from `handler`'s weights: (the mean gradients the inner step
    took, the parameters after it, whether mini-steps 1 .. k-1 left every
    parameter bit-unchanged, the inner step counts)."""
    import torch
    from advmil_tpu_torch.models.layers import Rngs, set_dropout_rates
    from advmil_tpu_torch.train.handler import build_models
    from advmil_tpu_torch.train.optim import MultiSteps, create_optimizer
    from advmil_tpu_torch.train.steps import make_adv_train_step
    cfg = dict(handler.cfg, precision="f32")
    G, D = build_models(cfg)
    G.load_state_dict(handler.gen_model.state_dict())
    D.load_state_dict(handler.disc_model.state_dict())
    set_dropout_rates(G.to(dev), 0.0)
    set_dropout_rates(D.to(dev), 0.0)
    k = len(micro)
    opt_G = MultiSteps(create_optimizer(cfg["opt_netG"], G.parameters(), cfg["opt_netG_lr"],
                                        weight_decay=cfg["opt_netG_weight_decay"]), k)
    opt_D = MultiSteps(create_optimizer("adam", D.parameters(), cfg["opt_netD_lr"]), k)
    step = make_adv_train_step(
        _ZeroNoise(G), D, opt_G, opt_D, loss_netD=cfg["loss_netD"],
        coef_gan=cfg["loss_gan_coef"], l1_coef=cfg["loss_regl1_coef"], gen_updates=1,
        sup_loss_fn=handler.sup_loss_fn, task=handler.task, nbins=handler.nbins)
    rngs = Rngs(device=torch.Generator(device=dev).manual_seed(0),
                host=torch.Generator().manual_seed(1))
    named = [(f"{t}.{n}", p) for t, m in (("G", G), ("D", D)) for n, p in m.named_parameters()]
    start = {n: p.detach().clone() for n, p in named}
    unchanged = True
    for i, batch in enumerate(micro):
        shipped = {key: torch.from_numpy(v).to(dev) for key, v in (
            ("feats", batch.feats), ("mask", batch.mask), ("label", batch.label),
            ("sample_mask", batch.sample_mask), ("visible", batch.sample_mask))}
        step(shipped, rngs)
        if i < k - 1:
            unchanged &= all(torch.equal(p, start[n]) for n, p in named)
    means = {n: p.grad.detach().cpu() for n, p in named if p.grad is not None}
    after = {n: p.detach().cpu() for n, p in named}
    return means, after, unchanged, (opt_G.gradient_step, opt_D.gradient_step)


def _check_stepped_grads(tag, g_card, g_cpu):
    """The gradients the optimizer stepped on (per step, name -> tensor),
    card against CPU, within phase 7's 1e-4 at every step; returns the
    largest difference."""
    worst = 0.0
    for i, (gc, gh) in enumerate(zip(g_card, g_cpu)):
        if set(gc) != set(gh):
            raise AssertionError(f"{tag}: step {i + 1}'s gradients missing on one side")
        d = max(max_abs(gc[n], gh[n]) for n in gh)
        if not d <= 1e-4:
            raise AssertionError(f"{tag}: step {i + 1}'s gradients differ by {d} card vs CPU "
                                 f"(bound 1e-4)")
        worst = max(worst, d)
    return worst


def _check_params(tag, got, want, start, g_card, g_cpu, lr_of, steps):
    """Parameters after `steps` optimizer steps, card (`got`) against CPU
    (`want`), both from `start`: every element within 1e-5, except where no
    two f32 orders can agree on an Adam-like step: at t = 1 such a step is
    lr * g / (|g| + eps), lr times the sign of g, so an element whose CPU
    gradient lies within 10x the devices' gradient difference of 0 at some
    step (`g_card` / `g_cpu`: per step, name -> the gradient the optimizer
    stepped on, its coupled L2 included) may differ by up to 2 * lr a step.
    That set is bounded twice: the stepped gradients themselves agree
    within 1e-4 at every step (`_check_stepped_grads`), and it may hold at
    most 0.1% of the elements. Returns (the worst difference among the
    other elements, its tensor, the count of such elements, the count of
    all, the largest move, the largest stepped-gradient difference)."""
    import torch
    g_diff = _check_stepped_grads(tag, g_card, g_cpu)
    worst, worst_n, n_open, n_all, moved = 0.0, None, 0, 0, 0.0
    for n in want:
        d = (got[n] - want[n]).abs()
        undetermined = torch.zeros_like(d, dtype=torch.bool)
        for gc, gh in zip(g_card, g_cpu):
            undetermined |= gh[n].abs() < 10 * (gc[n] - gh[n]).abs()
        allowed = torch.where(undetermined, 1e-5 + 2 * lr_of(n) * steps,
                              torch.full_like(d, 1e-5))
        if not bool((d <= allowed).all()):
            raise AssertionError(f"{tag}: parameter {n} differs by {float(d.max())} card vs "
                                 f"CPU")
        n_open += int(undetermined.sum())
        n_all += d.numel()
        rest = d[~undetermined]
        if rest.numel() and float(rest.max()) >= worst:
            worst, worst_n = float(rest.max()), n
        moved = max(moved, float((want[n] - start[n]).abs().max()))
    if n_open > 1e-3 * n_all:
        raise AssertionError(f"{tag}: {n_open} of {n_all} elements undetermined, over the "
                             f"cap of 0.1%")
    return worst, worst_n, n_open, n_all, moved, g_diff


def _rank_of_difference(diff, feats):
    """How a weight gradient's card-vs-CPU difference (`diff`, [out, in]) is
    made: the share of its squared norm in its largest singular value and in
    its four largest, and, where `in` is the feature width, the largest
    |cos| between its top right singular vector and any input row of
    `feats` (a difference made by a few rows whose ReLU fell on opposite
    sides on the two devices is a sum of outer(delta, x_row): low rank,
    aligned with those rows; rounding spread over the whole product is
    not)."""
    import torch
    _, sv, vh = torch.linalg.svd(diff.double(), full_matrices=False)
    energy = sv * sv
    share1 = float(energy[0] / energy.sum())
    share4 = float(energy[:4].sum() / energy.sum())
    cos = None
    if diff.shape[1] == feats.shape[1]:
        x = feats.double()
        cos = float(((x @ vh[0]).abs() / x.norm(dim=1).clamp_min(1e-30)).max())
    return share1, share4, cos


def phase_accum_gpu_vs_cpu(handler):
    """Phase 26: four f32 micro-batches (two bags each) of the accumulated
    adversarial step, card against CPU from the same weights: the mean
    gradients within 1e-4 (phase 7's bound), the parameters after the inner
    step within 1e-5 (where Adam's first step is determined, `_check_params`),
    the parameters after mini-steps 1-3 bit-unchanged on both devices; and
    how the gradient difference of the worst tensor is made
    (`_rank_of_difference`)."""
    import numpy as np
    import torch
    _, batcher = handler.loaders["train"]
    batch = max(batcher.epoch_batches(), key=lambda b: int(b.sample_mask.sum()))
    if batch.sample_mask.sum() < 8:
        raise AssertionError("no training batch holds 8 real bags")
    micro = [_bag_slice(batch, 2 * i, 2) for i in range(4)]
    (mc, pc, uc, sc), (mh, ph, uh, sh) = (_accum_run(handler, micro, dev)
                                          for dev in ("cuda", "cpu"))
    if not (uc and uh):
        raise AssertionError(f"26: mini-steps 1-3 moved parameters (card {not uc}, "
                             f"CPU {not uh})")
    if sc != (1, 1) or sh != (1, 1):
        raise AssertionError(f"26: inner steps card {sc} CPU {sh}, not one each")
    _compare_grads("26 accum gpu-vs-cpu train", "mean of 4 micro-batches, card against CPU",
                   mc, mh, (4,) + tuple(micro[0].feats.shape))
    worst_g = max(mh, key=lambda n: max_abs(mc[n], mh[n]))
    if mh[worst_g].ndim == 2:
        feats = torch.from_numpy(np.concatenate(
            [m.feats[m.mask > 0] for m in micro])).float()
        share1, share4, cos = _rank_of_difference(mc[worst_g] - mh[worst_g], feats)
        log(f"[26 accum gpu-vs-cpu train] the difference of {worst_g}'s gradient: its top "
            f"singular value holds {share1:.4f} of its squared norm, the top four {share4:.4f}"
            + ("" if cos is None else f"; the top right singular vector's largest |cos| "
               f"with one of the {feats.shape[0]} real input rows {cos:.4f}"))
    cfg = handler.cfg
    start = _handler_params(handler)
    # what the inner Adam steps on: the mean plus G's coupled L2 on its matrices
    wd = {n: cfg["opt_netG_weight_decay"] if n.startswith("G.") and p.ndim > 1 else 0.0
          for n, p in start.items()}
    g_card, g_cpu = ({n: g[n] + wd[n] * start[n] for n in mh} for g in (mc, mh))
    worst, worst_n, n_open, n_all, moved, _ = _check_params(
        "26 accum gpu-vs-cpu train", pc, ph, start, [g_card], [g_cpu],
        lambda n: cfg["opt_netG_lr"] if n.startswith("G.") else cfg["opt_netD_lr"], 1)
    log(f"[26 accum gpu-vs-cpu train] parameters after mini-steps 1-3 bit-unchanged on card "
        f"and CPU; after the inner step max |diff| {worst:.3e} at {worst_n} (bound 1e-5) "
        f"where Adam's first step is determined; {n_open} of {n_all} elements whose gradient "
        f"lies within 10x its card-vs-CPU difference of 0 within 2 lr (cap 0.1%); largest "
        f"move {moved:.3e}")
    if not moved > 0:
        raise AssertionError("26: the inner step moved no parameter")


def _handler_params(handler):
    return {f"{t}.{n}": p.detach().float().cpu() for t, m in
            (("G", handler.gen_model), ("D", handler.disc_model))
            for n, p in m.named_parameters()}


def phase_cluster(paths, card):
    """Phase 27: `--handler adv` with `bcb_mode: cluster` (G on DeepAttnMISL
    1024-384-384 over the writer's 8 clusters; D's X tower the patch
    embedding), bf16, 2 epochs, then test mode from its best checkpoint
    (no occlusion: the JAX package masks patch-style bags only). #1 at
    D=128 and #2 launch, the flash kernels and #1 at D=384 do not."""
    from advmil_tpu_torch.models.backbones import DeepAttnMISL
    over = dict(bcb_mode="cluster", path_cluster=paths["path_cluster"], test_mask_ratio=0.0)
    out = {}
    for mode in ("train", "test"):
        cfg = _smoke_cfg(paths, "cluster_run", test=mode == "test", epochs=2, es_warmup=0,
                         **over)
        handler, metrics, launches, widths, _ = _adv_run(cfg, f"cluster_{mode}", LN_KERNELS[:1]
                                                         + (LN_KERNELS[1:] if mode == "train"
                                                            else ()), dims=(128,))
        if not isinstance(handler.gen_model.backbone, DeepAttnMISL):
            raise AssertionError("bcb_mode cluster did not build DeepAttnMISL")
        if any(launches[n] for n in FLASH_KERNELS) or any(
                384 in widths[w] for w in widths):
            raise AssertionError(f"cluster {mode}: flash or #1 at D=384 launched: {launches}")
        splits = ("train", "validation", "test") if mode == "train" else ("exec-test",)
        _check_run(handler, metrics, splits, "train_best_pred_{}.csv" if mode == "train"
                   else "test_mode_best_pred_{}.csv")
        if mode == "train":
            _scalars_finite(handler)
            for f in ("train_modelG-best.ckpt", "train_modelD-last.ckpt"):
                if not osp.exists(osp.join(handler.save_dir, f)):
                    raise AssertionError(f"cluster training wrote no {f}")
            _log_adv_run("27 cluster train", handler, metrics, launches, widths, splits, card)
        else:
            (b, sec), = handler.eval_timings[-1:]
            log(f"[27 cluster test] exec-test C-index {dict(metrics['exec-test'])['cindex']:.4f}"
                f" (best checkpoint of the cluster run); {b / sec:.2f} bags/s ({b} bags, "
                f"{sec:.3f} s) | launches {({n: v for n, v in launches.items() if v})} | "
                f"by width {widths}")
        out[mode] = launches
    return out


def phase_base_cluster(paths, card):
    """Phase 28: `--handler base`, `bcb_mode: cluster`, surv_nll (as
    run_parity.cluster_cfg, at 1024-384-384), f32, 1 epoch, once with
    `opt_net: adahessian` and once in the reference's regime (one bag a
    micro-batch, an inner step every 16 bags, the remainder dropped)."""
    from advmil_tpu_torch.models.backbones import DeepAttnMISL
    from advmil_tpu_torch.train.optim import AdaHessian, MultiSteps
    out = {}
    for name, over in (("adahessian", {"opt_net": "adahessian"}),
                       ("refregime", {"accum_steps": 16, "batch_max_size": 1,
                                      "accum_drop_remainder": True})):
        cfg = _base_cfg(paths, f"base_cluster_{name}", test=False, epochs=1, es_warmup=0,
                        bcb_mode="cluster", path_cluster=paths["path_cluster"], task="surv_nll",
                        pdh_dims="384-4", precision="f32", **over)
        handler, metrics, launches = _base_run(cfg, f"base_cluster_{name}")
        _scalars_finite(handler)
        if not isinstance(handler.model.backbone, DeepAttnMISL):
            raise AssertionError("bcb_mode cluster did not build DeepAttnMISL")
        n_train = len(handler.patient_id["train"])
        if name == "adahessian" and not isinstance(handler.opt, AdaHessian):
            raise AssertionError("opt_net adahessian did not build AdaHessian")
        if name == "refregime" and not (isinstance(handler.opt, MultiSteps)
                                        and handler.opt.gradient_step == n_train // 16):
            raise AssertionError(f"refregime: {getattr(handler.opt, 'gradient_step', None)} "
                                 f"inner steps for {n_train} bags")
        _base_log(f"28 base cluster {name}", handler, metrics, launches, card)
        if name == "refregime":
            log(f"[28 base cluster refregime] {n_train} one-bag micro-batches, "
                f"{handler.opt.gradient_step} inner steps (every 16 bags, remainder dropped)")
        out[name] = launches
    return out


def phase_optimizer_sweep(base_handler):
    """Phase 29: every name of the optimizer factory (and lookahead_adam),
    weight decay 5e-4, three f32 baseline ABMIL steps (phase 15's weights,
    dropout off, two bags) on the card against the CPU: parameters within
    1e-5 where the steps are determined (`_check_params`: Adam-like steps on
    a gradient within its card-vs-CPU difference of 0 may differ by 2 lr a
    step). AdaHessian: one step with the same z on both devices; its update
    is -lr * g / (|h| + eps), so besides 1e-5 + 2e-5 relative a parameter may
    differ by what the Hessian diagonal's own card-vs-CPU difference (read
    here) allows: |update| * max|h diff| / |h|."""
    import torch
    from advmil_tpu_torch.models.layers import XAVIER, Rngs, set_dropout_rates
    from advmil_tpu_torch.train import optim, steps as steps_mod
    from advmil_tpu_torch.train.baseline import build_survnet
    _, batcher = base_handler.loaders["train"]
    batch = _first_bags(next(iter(batcher.epoch_batches())), 2)
    cfg = dict(base_handler.cfg, precision="f32")
    lr, wd, n_steps = cfg["opt_net_lr"], 5e-4, 3
    ref = build_survnet(cfg, base_handler.model.out_scale, XAVIER)
    zs = optim.rademacher_like(list(ref.parameters()), torch.Generator().manual_seed(29))
    seen = {}

    def run(name, dev):
        """(parameters after the steps, per step the gradients stepped on)."""
        model = build_survnet(cfg, base_handler.model.out_scale, XAVIER)
        model.load_state_dict(base_handler.model.state_dict())
        set_dropout_rates(model.to(dev), 0.0)
        params = list(model.parameters())
        second = name == "adahessian"
        opt = (optim.AdaHessian(params, lr, weight_decay=wd) if second
               else optim.create_optimizer(name, params, lr, weight_decay=wd))
        coupled = name.split("_")[-1] in optim._COUPLED | {"adam"}
        stepped, inner_step = [], opt.step

        def recorded(*args, **kwargs):
            stepped.append({n: (p.grad + (wd * p if coupled and p.ndim > 1 else 0.0))
                            .detach().cpu() for n, p in model.named_parameters()})
            return inner_step(*args, **kwargs)

        opt.step = recorded
        step = steps_mod.make_base_train_step(
            model, opt, task=base_handler.task, l1_coef=cfg["loss_regl1_coef"],
            sup_loss_fn=base_handler.sup_loss_fn,
            z_fn=lambda ps, gen: [z.to(p.device) for z, p in zip(zs, ps)])
        shipped = {k: torch.from_numpy(v).to(dev) for k, v in (
            ("feats", batch.feats), ("mask", batch.mask), ("label", batch.label),
            ("sample_mask", batch.sample_mask))}
        rngs = Rngs(device=torch.Generator(device=dev).manual_seed(0),
                    host=torch.Generator().manual_seed(1))
        for _ in range(1 if second else n_steps):
            step(shipped, rngs)
        return {n: p.detach().cpu() for n, p in model.named_parameters()}, stepped

    start = {n: p.detach().float().cpu() for n, p in base_handler.model.named_parameters()}
    real = steps_mod.hutchinson_diag

    def spy(loss, params, zz):
        grads, hd = real(loss, params, zz)
        seen[params[0].device.type] = [h.detach().cpu() for h in hd]
        return grads, hd

    rows = []
    for name in optim.OPTIMIZER_NAMES + ("lookahead_adam", "adahessian"):
        steps_mod.hutchinson_diag = spy
        try:
            (got, g_card), (want, g_cpu) = run(name, "cuda"), run(name, "cpu")
        finally:
            steps_mod.hutchinson_diag = real
        if name != "adahessian":
            worst, _, n_open, n_all, moved, g_diff = _check_params(
                f"29 {name}", got, want, start, g_card, g_cpu, lambda n: lr, n_steps)
            rows.append(f"{name} {worst:.2e} [{n_open} of {n_all} undetermined; gradients "
                        f"{g_diff:.2e}] (moved {moved:.2e})")
        else:
            g_diff = _check_stepped_grads("29 adahessian", g_card, g_cpu)
            h_diff = max(max_abs(a, b) for a, b in zip(seen["cuda"], seen["cpu"]))
            h_cpu = dict(zip(start, seen["cpu"]))
            worst, moved = 0.0, 0.0
            for n in want:
                d, upd = (got[n] - want[n]).abs(), (want[n] - start[n]).abs()
                allowed = 1e-5 + upd * (2e-5 + h_diff / (h_cpu[n].abs() + 1e-8))
                if not bool((d <= allowed).all()):
                    raise AssertionError(f"29 adahessian: {n} differs by {float(d.max())}")
                worst, moved = max(worst, float(d.max())), max(moved, float(upd.max()))
            rows.append(f"adahessian {worst:.2e} (moved {moved:.2e}; gradients {g_diff:.2e}; "
                        f"Hessian diagonal card-vs-CPU |diff| {h_diff:.2e})")
        if not moved > 0:
            raise AssertionError(f"29 {name}: no parameter moved")
    log(f"[29 optimizer sweep] f32 ABMIL on {tuple(batch.feats.shape)}, wd {wd}, lr {lr}, "
        f"{n_steps} steps (adahessian 1), card against CPU, max |param diff| where the steps "
        f"are determined (bound 1e-5), undetermined elements (cap 0.1%), max |diff| of the "
        f"gradients stepped on (bound 1e-4 each step): " + "; ".join(rows))


def phase_other_optimizer(paths, small_split, card):
    """Phase 30: one adversarial ESAT epoch with `opt_netG: lookahead_radam`
    (bf16, small split): finite losses; #1 at both widths and #2 launch."""
    from advmil_tpu_torch.train.optim import Lookahead
    cfg = _smoke_cfg(paths, "lookahead_radam_run", test=False, epochs=1, es_warmup=0,
                     data_split_path=small_split, opt_netG="lookahead_radam")
    handler, metrics, launches, widths, _ = _adv_run(cfg, "lookahead_radam_run", LN_KERNELS)
    if not (isinstance(handler.opt_G, Lookahead) and handler.opt_G.inner.name == "radam"):
        raise AssertionError("opt_netG lookahead_radam did not build Lookahead(RAdam)")
    _check_run(handler, metrics, ("train", "validation", "test"), "train_best_pred_{}.csv")
    n = _scalars_finite(handler)
    log(f"[30 lookahead_radam] {n} finite losses, Lookahead count {handler.opt_G.count}")
    _log_adv_run("30 lookahead_radam", handler, metrics, launches, widths,
                 ("train", "validation", "test"), card)
    return launches


# ---------------------------------------------------------------------------
# phases 31-33: parallelism (dp_devices, inst_devices) on the one card
# ---------------------------------------------------------------------------

def phase_inst_kernels(card):
    """Phase 31: the flash kernels #5-#7 at the shapes the sequence-parallel
    op gives them on two inst ranks: B=2, 1,024 keys, 512 local query rows
    (rank r: rows r*512 .. r*512+511, seed + r*7919), f32 and bf16, p = 0 and
    0.25, each rank's forward, dQ and dK/dV against the plain version (bf16
    also `_flash_tight`); at p = 0 the two ranks' outputs and dQ concatenated
    against the unsharded launch, and their partial dK / dV summed (what the
    reduce-scatter does) against the unsharded dK / dV. CUDA-event times of
    the local launches beside the unsharded ones, the plain version at the
    local shape and F.scaled_dot_product_attention at the same shape.
    Returns per kernel the local shape's times and bound."""
    import torch
    from advmil_tpu_torch.ops import attention as attn
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    B, L, Lq, H, Dh = 2, 1024, 512, 8, 48
    q32, k32, v32, do32 = (torch.randn(B, L, H, Dh, device=dev, generator=g) for _ in range(4))
    mask = torch.ones(B, L, device=dev)
    mask[0, L - 200:] = 0.0
    mask[0, 320:384] = 0.0            # a key tile with no real key
    mask[1, 600:] = 0.0
    keys = int(mask.sum())
    pairs = Lq * keys * H * Dh        # one rank's products over the real keys
    out_report = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        q, k, v, dout = (t.to(dtype) for t in (q32, k32, v32, do32))
        for p in (0.0, 0.25):
            seed = 0x1D57 if p else None
            got_r = []
            for r in range(2):
                rows = slice(r * Lq, (r + 1) * Lq)
                qr, dor = q[:, rows].contiguous(), dout[:, rows].contiguous()
                sr = attn.rank_seed(seed, r)
                out, lse = attn.flash_attention_fwd(qr, k, v, mask, p, sr)
                got = (out,) + attn.flash_attention_bwd(qr, k, v, mask, out, lse, dor, p, sr)
                leaves = [t.detach().clone().requires_grad_(True) for t in (qr, k, v)]
                ref = attn.masked_attention_reference(*leaves, mask, p, sr)
                want = (ref,) + torch.autograd.grad(ref, leaves, dor)
                torch.cuda.synchronize()
                errs = []
                for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
                    errs.append(f"{name} {max_abs(a, b):.3e}")
                    torch.testing.assert_close(
                        a.float(), b.float(), atol=tol, rtol=tol,
                        msg=lambda m, n=name: f"31 flash Lq<Lk rank {r} p={p} {n}: {m}")
                tight = _flash_tight(got, (qr, k, v, mask, dor, p, sr),
                                     f"31 flash Lq<Lk rank {r} p={p}") \
                    if dtype == torch.bfloat16 else ""
                log(f"[31 inst kernels] flash rank {r} of 2: q rows {rows.start}-{rows.stop - 1} "
                    f"(Lq={Lq}) against Lk={L} keys, B={B} H={H} Dh={Dh} p={p} "
                    f"{str(dtype)[6:]}, seed + {r}*{attn.INST_SEED_STRIDE}: max_abs_err "
                    f"{' '.join(errs)} (atol {tol}, rtol {tol}){tight}")
                got_r.append(got)
                del leaves, ref, want
            if p == 0.0:
                full, lse_f = attn.flash_attention_fwd(q, k, v, mask)
                full_g = attn.flash_attention_bwd(q, k, v, mask, full, lse_f, dout)
                cat_out = torch.cat([x[0] for x in got_r], dim=1)
                cat_dq = torch.cat([x[1] for x in got_r], dim=1)
                sum_dk = got_r[0][2].float() + got_r[1][2].float()
                sum_dv = got_r[0][3].float() + got_r[1][3].float()
                torch.cuda.synchronize()
                errs = []
                for name, a, b in (("out", cat_out, full), ("dq", cat_dq, full_g[0]),
                                   ("dk", sum_dk, full_g[1]), ("dv", sum_dv, full_g[2])):
                    errs.append(f"{name} {max_abs(a, b):.3e}")
                    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                               msg=lambda m, n=name: f"31 sharded {n}: {m}")
                bit = torch.equal(cat_out, full)
                qr, dor = q[:, :Lq].contiguous(), dout[:, :Lq].contiguous()
                o_r, l_r = attn.flash_attention_fwd(qr, k, v, mask)
                ops_r = attn.flash_bwd_inputs(qr, k, v, mask, o_r, l_r, dor)
                ops_f = attn.flash_bwd_inputs(q, k, v, mask, full, lse_f, dout)
                leaves = [t.detach().clone().requires_grad_(True) for t in (qr, k, v)]
                ref = attn.masked_attention_reference(*leaves, mask)
                times = {}
                times["fwd"] = timed_pair(lambda: attn.flash_attention_fwd(qr, k, v, mask),
                                          lambda: attn.masked_attention_reference(qr, k, v, mask))
                plain_bwd = lambda: torch.autograd.grad(ref, leaves, dor, retain_graph=True)  # noqa: E731
                times["dq"] = timed_pair(lambda: attn.flash_bwd_dq(ops_r), plain_bwd)
                times["dkv"] = timed_pair(lambda: attn.flash_bwd_dkv(ops_r), plain_bwd)
                full_ms = {"fwd": timed_one(lambda: attn.flash_attention_fwd(q, k, v, mask)),
                           "dq": timed_one(lambda: attn.flash_bwd_dq(ops_f)),
                           "dkv": timed_one(lambda: attn.flash_bwd_dkv(ops_f))}
                lib = {"fwd": timed_one(_sdpa(qr, k, v, mask, 0.0)),
                       "bwd": timed_one(_sdpa(qr, k, v, mask, 0.0, dor))}
                io = nbytes(qr, k, v, o_r)
                bounds = {"fwd": bound(io + nbytes(mask, l_r), 4 * pairs,
                                       "bf16" if dtype == torch.bfloat16 else "f32"),
                          "dq": bound(io + nbytes(dor, qr, mask, l_r), 6 * pairs,
                                      "bf16" if dtype == torch.bfloat16 else "f32"),
                          "dkv": bound(io + nbytes(dor, k, v, mask, l_r), 8 * pairs,
                                       "bf16" if dtype == torch.bfloat16 else "f32")}
                log(f"[31 inst kernels] p=0 {str(dtype)[6:]}: the two ranks' outputs and dQ "
                    f"concatenated, their dK / dV summed, against the unsharded launch: "
                    f"max_abs_err {' '.join(errs)} (atol {tol}, rtol {tol}); outputs bit for "
                    f"bit: {bit} | per rank (Lq={Lq}, Lk={L}): fwd {times['fwd'][0]:.4f} ms, dq "
                    f"{times['dq'][0]:.4f} ms, dk/dv {times['dkv'][0]:.4f} ms | unsharded "
                    f"(Lq=Lk={L}): fwd {full_ms['fwd']:.4f} ms, dq {full_ms['dq']:.4f} ms, dk/dv "
                    f"{full_ms['dkv']:.4f} ms | bounds per rank fwd "
                    f"{bounds['fwd']['bound_ms']:.4f} dq {bounds['dq']['bound_ms']:.4f} dk/dv "
                    f"{bounds['dkv']['bound_ms']:.4f} ms | plain per rank fwd "
                    f"{times['fwd'][1]:.4f} ms, autograd bwd {times['dq'][1]:.4f} ms | "
                    f"F.scaled_dot_product_attention per rank fwd {lib['fwd']:.4f} ms, bwd "
                    f"{lib['bwd']:.4f} ms | {card}")
                if dtype == torch.bfloat16:
                    for name, key, lib_key in (("masked_flash_attention", "fwd", "fwd"),
                                               ("flash_bwd_dq", "dq", "bwd"),
                                               ("flash_bwd_dkv", "dkv", "bwd")):
                        out_report[name] = dict(
                            shape=f"B={B} Lq={Lq} Lk={L} H={H} Dh={Dh} bf16 p=0",
                            ms=times[key][0], unsharded_ms=full_ms[key],
                            plain_ms=times[key][1], library_ms=lib[lib_key], **bounds[key])
                del leaves, ref, ops_r, ops_f
    return out_report


def _timed_collectives():
    """Wrap torch.distributed's all_reduce / all_gather / reduce_scatter_tensor
    (the calls `parallel/comm.py` makes) with a device sync and a host clock on
    each side; returns the running totals."""
    import torch
    import torch.distributed as tdist
    box = {"ms": 0.0, "calls": 0}
    for name in ("all_reduce", "all_gather", "reduce_scatter_tensor"):
        orig = getattr(tdist, name)

        def wrapped(*args, _orig=orig, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _orig(*args, **kwargs)
            torch.cuda.synchronize()
            box["ms"] += (time.perf_counter() - t0) * 1e3
            box["calls"] += 1
            return out
        setattr(tdist, name, wrapped)
    return box


def _collective_probe(device) -> dict:
    """Which of the collectives `parallel/comm.py` calls the process group
    (gloo where ranks share a card, NCCL where each has its own) runs on
    CUDA tensors, each checked."""
    import torch
    import torch.distributed as tdist
    w, r = tdist.get_world_size(), tdist.get_rank()
    x = torch.full((4 * w,), float(r + 1), device=device)
    out = {}
    y = x.clone()
    tdist.all_reduce(y)
    out["all_reduce"] = float(y[0]) == w * (w + 1) / 2
    parts = [torch.empty_like(x) for _ in range(w)]
    tdist.all_gather(parts, x)
    out["all_gather"] = all(float(p[0]) == i + 1 for i, p in enumerate(parts))
    z = torch.empty(4, device=device)
    tdist.reduce_scatter_tensor(z, x)
    out["reduce_scatter_tensor"] = float(z[0]) == w * (w + 1) / 2
    torch.cuda.synchronize()
    return dict(out, backend=tdist.get_backend())


def _one_step(kind, cfg, weights, batch, dev):
    """One f32 step from `weights` (dropout off, zero noise) through the
    port's step function, under the registered grid if any (the model sees
    this rank's rows and share of the patch axis): the parameters after it
    and the gradients the optimizer stepped on (the world's sum; coupled L2
    added), name -> CPU tensor."""
    import torch
    from advmil_tpu_torch.models.layers import Rngs, XAVIER, set_dropout_rates
    from advmil_tpu_torch.parallel import mesh
    from advmil_tpu_torch.train import steps
    from advmil_tpu_torch.train.optim import create_optimizer
    cfg = dict(cfg, precision="f32")
    if kind == "adv":
        from advmil_tpu_torch.train.handler import build_models
        G, D = build_models(cfg)
        nets = {"G": G, "D": D}
    else:
        from advmil_tpu_torch.train.baseline import build_survnet
        nets = {"net": build_survnet(cfg, "sigmoid", XAVIER)}
    for t, m in nets.items():
        m.load_state_dict(weights[t])
        set_dropout_rates(m.to(dev), 0.0)
    if kind == "adv":
        opt_G = create_optimizer(cfg["opt_netG"], G.parameters(), cfg["opt_netG_lr"],
                                 weight_decay=cfg["opt_netG_weight_decay"])
        opt_D = create_optimizer("adam", D.parameters(), cfg["opt_netD_lr"])
        step = steps.make_adv_train_step(
            _ZeroNoise(G), D, opt_G, opt_D, loss_netD=cfg["loss_netD"],
            coef_gan=cfg["loss_gan_coef"], l1_coef=cfg["loss_regl1_coef"], gen_updates=1,
            sup_loss_fn=steps.make_supervised_loss(cfg["task"], cfg))
        wd = {"G": cfg["opt_netG_weight_decay"], "D": 0.0}
    else:
        opt = create_optimizer(cfg["opt_net"], nets["net"].parameters(), cfg["opt_net_lr"],
                               weight_decay=cfg["opt_net_weight_decay"])
        step = steps.make_base_train_step(
            nets["net"], opt, task=cfg["task"], l1_coef=cfg["loss_regl1_coef"],
            sup_loss_fn=steps.make_supervised_loss(cfg["task"], cfg))
        wd = {"net": cfg["opt_net_weight_decay"]}
    local = mesh.shard_batch_2d({"feats": batch.feats, "mask": batch.mask})
    shipped = {"feats": torch.from_numpy(local["feats"].copy()).to(dev),
               "mask": torch.from_numpy(local["mask"].copy()).to(dev),
               "label": torch.from_numpy(batch.label).to(dev),
               "sample_mask": torch.from_numpy(batch.sample_mask).to(dev),
               "visible": torch.from_numpy(batch.sample_mask).to(dev)}
    start = {f"{t}.{n}": p.detach().clone() for t, m in nets.items()
             for n, p in m.named_parameters()}
    step(shipped, Rngs(device=torch.Generator(device=dev).manual_seed(0),
                       host=torch.Generator().manual_seed(1)))
    after, stepped = {}, {}
    for t, m in nets.items():
        for n, p in m.named_parameters():
            key = f"{t}.{n}"
            after[key] = p.detach().cpu()
            decay = wd[t] if p.ndim > 1 else 0.0
            stepped[key] = (p.grad.detach() + decay * start[key]).cpu()
    return after, stepped


def _rank_step(rank, device, kind, cfg, weights, batch, dp, inst):
    """A spawned rank of phases 32 / 33: the collective probe, then
    `_one_step` under the dp x inst grid twice (the first warms the fresh
    process up), the launch counters and the collectives' time around the
    second. The step's wall includes building the models and the optimizer
    from `weights` and shipping the batch."""
    from advmil_tpu_torch.parallel import mesh
    probe = _collective_probe(device)
    import torch
    mesh.set_grid(mesh.make_grid(dp, inst, device))
    _one_step(kind, cfg, weights, batch, device)     # warm-up: a fresh process's first step
    coll = _timed_collectives()
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    after, stepped = _one_step(kind, cfg, weights, batch, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"probe": probe, "launches": read_counters(), "coll_ms": coll["ms"],
            "coll_calls": coll["calls"], "step_s": wall,
            **({"after": after, "stepped": stepped} if rank == 0 else {})}


def _rank_run(rank, device, handler_name, cfg):
    """A spawned rank of a run through `advmil_tpu_torch.main`'s `run_one`,
    with its launch counters reset before and read after."""
    from advmil_tpu_torch import main as port_main
    reset_counters()
    handler, metrics = port_main.run_one(port_main.handler_class(handler_name), cfg)
    return {"metrics": metrics, "launches": read_counters(),
            "train_timings": getattr(handler, "train_timings", []),
            "eval_timings": handler.eval_timings}


def _hold_step(tag, want, got, kind, cfg, shape):
    """Parameters after the sharded step (`got`) against the single-process
    card step (`want`): the stepped gradients within 1e-4, the parameters
    within 1e-5 where f32 determines the sign of Adam's first step
    (`_check_params`, as phases 26 / 29)."""
    start, (after_w, grad_w), (after_g, grad_g) = want[0], want[1], got
    if kind == "adv":
        lr_of = lambda n: cfg["opt_netG_lr"] if n.startswith("G.") else cfg["opt_netD_lr"]  # noqa: E731
    else:
        lr_of = lambda n: cfg["opt_net_lr"]  # noqa: E731
    worst, worst_n, n_open, n_all, moved, g_diff = _check_params(
        tag, after_g, after_w, start, [grad_g], [grad_w], lr_of, 1)
    log(f"[{tag}] f32 step on batch {shape}, sharded against the single-process card step: "
        f"stepped gradients within {g_diff:.3e} (bound 1e-4); parameters max |diff| "
        f"{worst:.3e} at {worst_n} (bound 1e-5) where Adam's first step is determined; "
        f"{n_open} of {n_all} elements undetermined (cap 0.1%); largest move {moved:.3e}")
    if not moved > 0:
        raise AssertionError(f"{tag}: the step moved no parameter")


def _weights(nets):
    return {t: {k: v.detach().cpu() for k, v in m.state_dict().items()} for t, m in nets.items()}


def _ranks_summary(tag, results, card):
    probe = dict(results[0]["probe"])
    backend = probe.pop("backend")
    refused = [k for k, ok in probe.items() if not ok]
    if refused:
        raise AssertionError(f"{tag}: {backend} refused CUDA tensors for {refused}")
    coll = " ".join(f"rank {i} {r['coll_ms']:.1f} ms in {r['coll_calls']} calls "
                    f"(step {r['step_s']:.3f} s);" for i, r in enumerate(results))
    staged = (" (gloo stages CUDA tensors through pinned host memory)"
              if backend == "gloo" else "")
    log(f"[{tag}] {backend} collectives on CUDA tensors ({len(results)} ranks): "
        f"{', '.join(f'{k} ok' for k in probe)}{staged} | collective time per step, "
        f"{backend}'s, device-synced host clock: {coll} | {card}")


def phase_dp2(paths, train_handler, card):
    """Phase 32: dp_devices 2 on the one card (two ranks on cuda:0 through
    the launcher's device list, gloo): one f32 adversarial step on the long
    training batch against the single-process card step, then the cfg_nlst
    bf16 2-epoch `exec` over two ranks: equal metrics on both ranks, each
    artifact written once, each rank's kernel launches."""
    import torch
    from advmil_tpu_torch.config import with_defaults
    from advmil_tpu_torch.parallel import launch
    _, batcher = train_handler.loaders["train"]
    batch = list(batcher.epoch_batches())[-1]          # the two long training bags
    cfg = dict(train_handler.cfg)
    weights = _weights({"G": train_handler.gen_model, "D": train_handler.disc_model})
    start = {f"{t}.{n}": v.float() for t, sd in weights.items() for n, v in sd.items()}
    want = (start, _one_step("adv", cfg, weights, batch, torch.device("cuda")))
    results = launch.run_ranks(_rank_step, [0, 0], ("adv", cfg, weights, batch, 2, 1))
    _ranks_summary("32 dp2 step", results, card)
    _hold_step("32 dp2 step", want, (results[0]["after"], results[0]["stepped"]), "adv", cfg,
               tuple(batch.feats.shape))

    run_cfg = with_defaults(_smoke_cfg(paths, "run_dp2", test=False, epochs=2, es_warmup=0,
                                       dp_devices=2))
    out = launch.run_ranks(_rank_run, [0, 0], ("adv", run_cfg))
    if out[0]["metrics"] != out[1]["metrics"]:
        raise AssertionError(f"32 dp2 exec: the ranks' metrics differ: {out[0]['metrics']} "
                             f"vs {out[1]['metrics']}")
    run_dir = run_cfg["save_path"]
    for f in ("train_modelG-best.ckpt", "train_modelD-best.ckpt", "train_modelG-last.ckpt",
              "train_metrics-best.txt", "print_config.txt", "train_best_pred_test.csv"):
        if not osp.exists(osp.join(run_dir, f)):
            raise AssertionError(f"32 dp2 exec wrote no {f}")
    with open(osp.join(run_dir, "run_dp2_scalars.jsonl")) as f:
        steps_ = [json.loads(line)["_step"] for line in f]
    if steps_ != list(range(1, len(steps_) + 1)):
        raise AssertionError("32 dp2 exec: the scalars log was written by more than one rank")
    for i, r in enumerate(out):
        for name in LN_KERNELS + FLASH_KERNELS:
            if r["launches"][name] <= 0:
                raise AssertionError(f"32 dp2 exec: rank {i} never launched {name}")
    m = out[0]["metrics"]
    rates = " / ".join(f"{b / s:.2f}" for b, s in out[0]["train_timings"])
    log(f"[32 dp2 exec] cfg_nlst bf16, 2 epochs over two ranks on one card: metrics equal on "
        f"both ranks; C-index train {dict(m['train'])['cindex']:.4f} validation "
        f"{dict(m['validation'])['cindex']:.4f} test {dict(m['test'])['cindex']:.4f}; "
        f"checkpoints, CSVs, print_config and one scalars log ({len(steps_)} records, steps "
        f"1..{len(steps_)}) written by rank 0 | launches rank 0 "
        f"{ {k: v for k, v in out[0]['launches'].items() if v} } rank 1 "
        f"{ {k: v for k, v in out[1]['launches'].items() if v} }")
    log(f"[32 dp2 exec] rank 0 training bags/s (its half of each batch; both ranks share the "
        f"card), epochs 1 / 2: {rates} beside phase 4's one process "
        f"{' / '.join(f'{b / s:.2f}' for b, s in train_handler.train_timings)} (no gain "
        f"claimed) | {card}")
    launches = {name: out[0]["launches"][name] + out[1]["launches"][name]
                for name in out[0]["launches"]}
    return run_cfg, launches


def phase_inst2(paths, train_handler, base_handler, dp2_cfg, card):
    """Phase 33: inst_devices 2 on the one card: one f32 adversarial ESAT
    step on the two long training bags (their bucket holds 1,000 regions:
    the flash kernels run on 500 local query rows against 1,000 keys) and
    one ABMIL base step,
    each against the single-process card step; then test mode from phase
    32's best checkpoint over two inst ranks against the same test mode in
    one process."""
    import numpy as np
    import torch
    from advmil_tpu_torch import main as port_main
    from advmil_tpu_torch.config import with_defaults
    from advmil_tpu_torch.parallel import launch
    dev = torch.device("cuda")
    _, batcher = train_handler.loaders["train"]
    batch = list(batcher.epoch_batches())[-1]
    cfg = dict(train_handler.cfg)
    weights = _weights({"G": train_handler.gen_model, "D": train_handler.disc_model})
    start = {f"{t}.{n}": v.float() for t, sd in weights.items() for n, v in sd.items()}
    want = (start, _one_step("adv", cfg, weights, batch, dev))
    results = launch.run_ranks(_rank_step, [0, 0], ("adv", cfg, weights, batch, 1, 2))
    _ranks_summary("33 inst2 ESAT step", results, card)
    _hold_step("33 inst2 ESAT step", want, (results[0]["after"], results[0]["stepped"]), "adv",
               cfg, tuple(batch.feats.shape))
    step_launches = {name: results[0]["launches"][name] + results[1]["launches"][name]
                     for name in results[0]["launches"]}
    for name in LN_KERNELS + ("masked_flash_attention", "flash_bwd_dq", "flash_bwd_dkv"):
        if any(r["launches"][name] <= 0 for r in results):
            raise AssertionError(f"33 inst2 ESAT step: a rank never launched {name}")

    _, bbatcher = base_handler.loaders["train"]
    bbatch = list(bbatcher.epoch_batches())[-1]
    bcfg = dict(base_handler.cfg)
    bweights = _weights({"net": base_handler.model})
    bstart = {f"net.{n}": v.float() for n, v in bweights["net"].items()}
    bwant = (bstart, _one_step("base", bcfg, bweights, bbatch, dev))
    bres = launch.run_ranks(_rank_step, [0, 0], ("base", bcfg, bweights, bbatch, 1, 2))
    _ranks_summary("33 inst2 ABMIL step", bres, card)
    _hold_step("33 inst2 ABMIL step", bwant, (bres[0]["after"], bres[0]["stepped"]), "base",
               bcfg, tuple(bbatch.feats.shape))

    test_cfg = with_defaults(dict(dp2_cfg, test=True, dp_devices=1, inst_devices=2,
                                  test_save_path=osp.join(WORK_DIR, "run_dp2_inst2_test_{}-{}")))
    out = launch.run_ranks(_rank_run, [0, 0], ("adv", test_cfg))
    if out[0]["metrics"] != out[1]["metrics"]:
        raise AssertionError("33 inst2 test mode: the ranks' metrics differ")
    one_cfg = with_defaults(dict(test_cfg, inst_devices=1,
                                 test_save_path=osp.join(WORK_DIR, "run_dp2_one_test_{}-{}")))
    reset_counters()
    one, one_metrics = port_main.run_one(port_main.handler_class("adv"), one_cfg)
    csv_name = "test_mode_best_pred_exec-test.csv"
    a = _read_csv_preds(osp.join(test_cfg["test_save_path"].format(
        test_cfg["test_mask_ratio"], test_cfg["data_split_seed"]), csv_name))
    b = _read_csv_preds(osp.join(one.save_dir, csv_name))
    diff = float(np.abs(a - b).max())
    ci_a, ci_b = (dict(m["exec-test"])["cindex"] for m in (out[0]["metrics"], one_metrics))
    # a pair whose order differs between the runs: each prediction moves by
    # at most the bound, so such a pair lies within twice the bound (the
    # C-indices may then differ)
    flips = [abs(b[i] - b[j]) for i in range(len(b)) for j in range(i + 1, len(b))
             if np.sign(a[i] - a[j]) != np.sign(b[i] - b[j])] if len(a) == len(b) else []
    for name in ("ln_relu_region_mean", "masked_flash_attention"):
        if any(r["launches"][name] <= 0 for r in out):
            raise AssertionError(f"33 inst2 test mode: a rank never launched {name}")
    log(f"[33 inst2 test] test mode from phase 32's best checkpoint over two inst ranks "
        f"(bf16; the 2,048-region test bag: flash on 1,024 local rows): metrics equal on both "
        f"ranks, C-index {ci_a:.6f} beside {ci_b:.6f} in one process; {len(a)} predictions "
        f"within {diff:.3e} of the one-process run's (bound 5e-3, bf16); {len(flips)} pairs "
        f"ordered otherwise, their one-process gap at most {max(flips, default=0.0):.3e} | "
        f"launches rank 0 "
        f"{ {k: v for k, v in out[0]['launches'].items() if v} } | {card}")
    if not (len(a) == len(b) and diff <= 5e-3 and np.all(np.isfinite(a))):
        raise AssertionError(f"33 inst2 test mode: predictions differ by {diff}")
    test_launches = {name: out[0]["launches"][name] + out[1]["launches"][name]
                     for name in out[0]["launches"]}
    return step_launches, test_launches


# ---------------------------------------------------------------------------
# phases 34-37: real-slide graphs: the tools, the grid route
# ---------------------------------------------------------------------------

# the phase-34 patients: each slide an elliptical tissue mask with holes on a
# (width x height) grid of 256-px patches (advmil_tpu_torch.data.synthetic.
# tissue_coords); patient 8 has two slides, patients 3 and 4 are over 200
# patches wide after cropping
TISSUE_SLIDES = [[(60, 45)], [(80, 50)], [(100, 60)], [(240, 66)], [(236, 58)], [(120, 70)],
                 [(90, 90)], [(150, 60)], [(70, 40), (66, 36)], [(110, 80)], [(200, 50)],
                 [(130, 100)]]
# phase 37: (cropped width aimed at, tissue_coords width, height): two slides
# of about 16,000 grid cells each
GRID_WIDTHS = ((40, 42, 390), (60, 62, 265), (220, 228, 72))
GRAPH_KERNELS = ("fused_knn_softmax_aggregate", "fused_knn_softmax_aggregate_bwd",
                 "banded_aggregate", "banded_aggregate_bwd")


def _write_geom_pt(path, x, edge_index_pyg, centroid):
    """Write a graph as the reference does: a pickled torch_geometric `Data`
    (PyG 2 layout: the attributes in `_store._mapping`). torch_geometric is
    not installed, so stand-in classes are registered under its module names
    for the pickler and removed afterwards."""
    import types
    import torch
    names = ("torch_geometric", "torch_geometric.data", "torch_geometric.data.storage")
    mods = {n: types.ModuleType(n) for n in names}

    class BaseStorage:
        def __init__(self, mapping):
            self._mapping = mapping

    class Data:
        def __init__(self, **kw):
            self._store = BaseStorage(dict(kw))

    for cls, mod in ((BaseStorage, "torch_geometric.data.storage"), (Data, "torch_geometric.data")):
        cls.__module__, cls.__qualname__ = mod, cls.__name__
        setattr(mods[mod], cls.__name__, cls)
    sys.modules.update(mods)
    try:
        torch.save(Data(x=torch.from_numpy(x), edge_index=torch.from_numpy(edge_index_pyg),
                        edge_latent=torch.from_numpy(edge_index_pyg),
                        centroid=torch.from_numpy(centroid)), path)
    finally:
        for n in names:
            sys.modules.pop(n, None)


def phase_tools(card):
    """Phase 34: CLAM-like patients written with numpy (TISSUE_SLIDES: 1024-d
    features as .pt, coordinates as .npy), their graphs built by the port's
    `build_graphs` CLI on the card (feature kNN on the card, spatial kNN in
    C++); the C++ spatial kNN against torch.cdist and the card's feature kNN
    against the C++ kNN; one slide written as a reference-format .pt graph
    and read back."""
    import numpy as np
    import torch
    from advmil_tpu_torch import native
    from advmil_tpu_torch.data.synthetic import tissue_coords
    from advmil_tpu_torch.ops.segment import crop_empty_grid_lines, grid_layout
    from advmil_tpu_torch.tools import build_graphs
    from advmil_tpu_torch.utils.io import read_geom_graph
    t0 = time.perf_counter()
    root = osp.join(WORK_DIR, "tissue")
    dirs = {d: osp.join(root, d) for d in ("feats", "coords", "graphs", "refgraphs")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(34)
    rows, sizes, widths = [], [], []
    for p, slides in enumerate(TISSUE_SLIDES):
        signal = rng.uniform(-1.0, 1.0)
        t = float(np.clip(50.0 * (1.0 + signal) + rng.normal(0, 5.0), 1.0, 120.0))
        for s, (w, h) in enumerate(slides):
            sid = f"T{p:02d}_{s}"
            coords = tissue_coords(rng, w, h)
            feats = rng.normal(size=(len(coords), 1024)).astype(np.float32)
            feats[:, :8] += signal
            np.save(osp.join(dirs["coords"], f"{sid}.npy"), coords)
            torch.save(torch.from_numpy(feats), osp.join(dirs["feats"], f"{sid}.pt"))
            gl = grid_layout(coords)
            widths.append(crop_empty_grid_lines(gl[0], gl[1])[2])
            sizes.append(len(coords))
            rows.append(f"{sid},TP{p:02d},{int(p % 4 != 3)},{t:.4f}")
    with open(osp.join(root, "labels.csv"), "w") as f:
        f.write("pathology_id,patient_id,e,t\n" + "\n".join(rows) + "\n")
    pids = [f"TP{p:02d}" for p in range(len(TISSUE_SLIDES))]
    np.savez(osp.join(root, "split-fold0.npz"), train_patients=np.asarray(pids[3:11]),
             val_patients=np.asarray(pids[1:3]), test_patients=np.asarray([pids[0], pids[11]]))
    if sum(w > 200 for w in widths) < 2 or not (1500 <= min(sizes) and max(sizes) <= 12000):
        raise AssertionError(f"tissue slides: sizes {sizes}, cropped widths {widths}")
    t_data = time.perf_counter() - t0

    t0 = time.perf_counter()
    build_graphs.main(["--coords", dirs["coords"], "--feats", dirs["feats"],
                       "--save", dirs["graphs"]])
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0

    # the C++ spatial kNN against brute force on the card, ties aside: every
    # neighbour kept lies within the 9th distance, every point nearer than it
    # is kept
    sp_sid = "T01_0"
    coords = np.load(osp.join(dirs["coords"], f"{sp_sid}.npy"))
    idx = native.knn_l2(coords, 9)
    c = torch.from_numpy(coords).cuda().double()
    d = torch.cdist(c, c)
    kth = d.sort(dim=1).values[:, 8:9]
    kept = torch.zeros_like(d, dtype=torch.bool)
    kept[torch.arange(len(coords))[:, None], torch.from_numpy(idx).long().cuda()] = True
    ties = int(((d == kth).sum(1) > 1).sum())
    if not (bool((d[kept] <= kth.expand_as(d)[kept]).all())
            and bool((kept | (d >= kth)).all()) and int(kept.sum()) == 9 * len(coords)):
        raise AssertionError("C++ spatial kNN disagrees with torch.cdist")
    # the card's feature kNN against the C++ kNN (1024-d): equal sets, but for
    # near-ties at the 9th distance that f32 cannot order. The card computes
    # |q|^2 + |x|^2 - 2 q.x, with an error of at most gamma (|q|^2 + |x|^2 +
    # 2 sum_k |q_k x_k|); the C++ sums (q_k - x_k)^2, with an error of at most
    # gamma |q - x|^2; gamma = (d + 2) u / (1 - (d + 2) u), u = 2^-24, in any
    # summation order (Higham, Accuracy and Stability of Numerical
    # Algorithms, 3.1). E is the sum of the two. A neighbour one side keeps
    # and the exact (f64) 9 nearest do not, or the reverse, lies within E_j
    # + max E (over the exact 9 and both sides' sets) of the exact 9th
    # distance; so does each neighbour that differs card vs C++. At most
    # 0.5% of the rows may differ.
    sid = "T00_0"
    feats = torch.load(osp.join(dirs["feats"], f"{sid}.pt")).numpy()
    dev_idx = build_graphs.knn_l2_device(feats, 9, device="cuda")
    host_idx = native.knn_l2(feats, 9)
    differ = [i for i, (a, b) in enumerate(zip(dev_idx, host_idx)) if set(a) != set(b)]
    if len(differ) > max(1, len(feats) // 200):
        raise AssertionError(f"feature kNN: {len(differ)} of {len(feats)} rows differ card "
                             "vs C++ (more than 0.5%)")
    dim = feats.shape[1]
    gamma = (dim + 2) * 2.0 ** -24 / (1 - (dim + 2) * 2.0 ** -24)
    x64 = torch.from_numpy(feats).cuda().double()
    sq, ax = (x64 * x64).sum(dim=1), x64.abs()
    worst = 0.0        # largest |d_j - 9th| / bound over the neighbours that differ
    for i in differ:
        d2 = ((x64 - x64[i]) ** 2).sum(dim=1)
        err = gamma * (sq[i] + sq + 2.0 * (ax @ ax[i])) + gamma * d2
        near = d2.topk(9, largest=False)
        kth = float(near.values.max())
        cand = set(near.indices.tolist()) | set(dev_idx[i].tolist()) | set(host_idx[i].tolist())
        e_max = float(err[sorted(cand)].max())
        for j in set(dev_idx[i].tolist()) ^ set(host_idx[i].tolist()):
            ratio = abs(float(d2[j]) - kth) / (float(err[j]) + e_max)
            worst = max(worst, ratio)
            if ratio > 1.0:
                raise AssertionError(f"feature kNN: row {i} differs card vs C++ at patch {j}, "
                                     "beyond the f32 error bound of a near-tie")
    # a reference-format .pt graph, read back
    with np.load(osp.join(dirs["graphs"], f"{sid}.npz")) as g:
        g = dict(g)
    pt = osp.join(dirs["refgraphs"], f"{sid}.pt")
    _write_geom_pt(pt, feats, np.ascontiguousarray(g["edge_index"][::-1]), g["centroid"])
    back = read_geom_graph(pt)
    if not (np.array_equal(back["edge_index"][::-1], g["edge_index"])
            and np.array_equal(back["centroid"], g["centroid"])
            and back["num_nodes"] == int(g["num_nodes"]) and "torch_geometric" not in sys.modules):
        raise AssertionError("reference-format .pt graph did not read back")
    log(f"[34 tools] {len(TISSUE_SLIDES)} CLAM-like patients, {len(sizes)} slides of "
        f"{min(sizes)}-{max(sizes)} patches (cropped grid widths {min(widths)}-{max(widths)}, "
        f"{sum(w > 200 for w in widths)} over 200), 1024-d ({t_data:.1f} s); build_graphs CLI "
        f"(feature kNN on the card) {t_build:.1f} s; C++ spatial kNN = torch.cdist on {sp_sid} "
        f"({len(coords)} patches, {ties} rows with ties at the 9th distance); card feature "
        f"kNN = C++ kNN on {sid} ({len(feats)} patches; sets equal in all but {len(differ)} "
        f"rows, which differ by near-ties at the 9th distance, at most {worst:.3f} of their "
        f"f32 error bound); reference "
        f".pt graph read back | {card}")
    return {"path_patch": dirs["feats"], "path_label": osp.join(root, "labels.csv"),
            "path_graph": dirs["graphs"], "path_coordx5": None,
            "data_split_path": osp.join(root, "split-fold{}.npz")}


def _tissue_cfg(tpaths, run, **over):
    return _smoke_cfg(tpaths, bcb_mode="graph", num_graph_layers=3,
                      path_graph=tpaths["path_graph"], save_path=osp.join(WORK_DIR, run),
                      test_load_path=osp.join(WORK_DIR, run),
                      test_save_path=osp.join(WORK_DIR, run + "_test_{}-{}"),
                      test_mask_ratio=0.0, **over)


def phase_grid_train(tpaths, card):
    """Phase 35: adversarial PatchGCN at full width (1024-384-384, 3 graph
    layers, bf16) on phase 34's graphs, 2 epochs, then test mode from the
    best checkpoint; the grid route must engage and #12-#15 launch."""
    from advmil_tpu_torch import main as port_main
    runs = {}
    for mode, over in (("train", dict(test=False, epochs=2, es_warmup=0)),
                       ("test", dict(test=True))):
        yaml_path = osp.join(WORK_DIR, f"grid_{mode}.yaml")
        _write_yaml(yaml_path, _tissue_cfg(tpaths, "grid_run", **over))
        reset_counters()
        [(handler, metrics)] = port_main.main(["--config", yaml_path, "--handler", "adv"])
        runs[mode] = (handler, metrics, read_counters())
    handler, metrics, launches = runs["train"]
    for name in GRAPH_KERNELS + LN_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the grid training path")
    if runs["test"][2]["banded_aggregate"] <= 0:
        raise AssertionError("banded_aggregate was not launched in grid test mode")
    _check_run(handler, metrics, ("train", "validation", "test"), "train_best_pred_{}.csv")
    _check_run(runs["test"][0], runs["test"][1], ("exec-test",), "test_mode_best_pred_{}.csv")
    routes = []
    for split, (_, b) in list(handler.loaders.items()) + [
            ("exec-test", runs["test"][0].loaders["exec-test"])]:
        if not (b.grid_on and not b.band_on and b.coverage < 0.7 <= b.grid_coverage
                and b.grid_inflation <= 3.0):
            raise AssertionError(f"{split}: the grid route did not engage (compact coverage "
                                 f"{b.coverage}, grid {b.grid_coverage}, inflation "
                                 f"{b.grid_inflation})")
        shapes = sorted({(bn, gn) for bn, gn, _ in b._groups})
        routes.append(f"{split}: compact coverage {b.coverage:.3f}, grid coverage "
                      f"{b.grid_coverage:.3f}, inflation {b.grid_inflation:.2f}, (bucket, grid) "
                      f"{shapes}, residual rows {b._grid_u_slots}")
    log(f"[35 grid train] grid-raster banded streaming ON: " + "; ".join(routes))
    rates = " ".join(f"epoch {i + 1} {b / s:.2f} ({b} bags, {s:.3f} s);"
                     for i, (b, s) in enumerate(handler.train_timings))
    k = {n: launches[n] for n in GRAPH_KERNELS + LN_KERNELS}
    log(f"[35 grid train] exec C-index train {dict(metrics['train'])['cindex']:.4f} validation "
        f"{dict(metrics['validation'])['cindex']:.4f} test {dict(metrics['test'])['cindex']:.4f}; "
        f"test mode from the best checkpoint C-index "
        f"{dict(runs['test'][1]['exec-test'])['cindex']:.4f}; predictions finite in [0, 1] | "
        f"launches #12-#15, #1 / #2: {k}; test mode {runs['test'][2]} | {card}")
    log(f"[35 grid train] training bags/s: {rates} | {card}")
    return handler, launches, runs["test"][2]


def _dense_batch(handler, batch):
    """`batch` with its grid tables replaced by the dense edge tables of the
    same bags (the dense route's `edge_src` / `edge_mask`)."""
    import numpy as np
    from advmil_tpu_torch.data.bags import Batch, dense_table
    ds = handler.loaders["train"][1].ds
    epn = int(handler.cfg["graph_edges_per_node"])
    tabs = [dense_table(ds.peek_edges(int(i)), batch.feats.shape[1], epn)[:2] for i in batch.idx]
    return Batch(idx=batch.idx, feats=batch.feats, mask=batch.mask, label=batch.label,
                 sample_mask=batch.sample_mask,
                 extra={"edge_src": np.stack([t[0] for t in tabs]),
                        "edge_mask": np.stack([t[1] for t in tabs])})


def _g_forward(handler, batch, **over):
    """G's bag embedding [B, 384] in f32, eval mode, on the card."""
    import torch
    from advmil_tpu_torch.train.handler import build_models
    G, _ = build_models(dict(handler.cfg, precision="f32", **over))
    G.load_state_dict(handler.gen_model.state_dict())
    G.cuda().eval()
    extra = {k: torch.from_numpy(v).cuda() for k, v in batch.extra.items()}
    with torch.no_grad():
        return G.embed(torch.from_numpy(batch.feats).cuda(), torch.from_numpy(batch.mask).cuda(),
                       extra).float().cpu()


def phase_grid_checks(handler):
    """Phase 36: one f32 grid-route step card against CPU (gradients 1e-4);
    the grid route against the dense route on the CPU and the dense route
    card against CPU (gradients 1e-4: with the first line, every side of the
    (route, device) square); the dense step twice on the card (its
    run-to-run spread); then on the card the grid route
    against the dense route on the same two bags (G's forward 1e-5, the
    step's gradients 1e-4), with graph_grid_resident off and on.

    The dense card step is the reference of the last check, so it is first
    held to the CPU on this batch and these weights: graphs that the
    build_graphs tool made from slide coordinates, where phase 11 holds the
    dense route on phase 8's generated rasters. Its repeat tells a card that
    sums in another order each run from one that does not; the four corners
    and that spread are what ROADMAP C's diagnosis of the grid-vs-dense gap
    reads."""
    batch = _two_bag_batch(handler)
    shape = tuple(batch.feats.shape)
    grads = {dev: _step_grads(handler, batch, dev) for dev in ("cuda", "cpu")}
    _compare_grads("36 grid gpu-vs-cpu train", "grid route, card against CPU", grads["cuda"],
                   grads["cpu"], shape)
    dense = _dense_batch(handler, batch)
    # the four corners of (route, device) on one batch and one set of weights:
    # which of them stands apart, beside the dense step's own spread on the card
    cpu_dense = _step_grads(handler, dense, "cpu")
    _compare_grads("36 grid-vs-dense cpu", "grid against dense on the CPU", grads["cpu"],
                   cpu_dense, shape)
    want_g = _step_grads(handler, dense, "cuda")
    _compare_grads("36 dense gpu-vs-cpu", "dense route, card against CPU", want_g, cpu_dense,
                   shape)
    _compare_grads("36 dense-vs-dense", "the dense route twice on the card",
                   _step_grads(handler, dense, "cuda"), want_g, shape)
    want_f = _g_forward(handler, dense)
    for resident in (False, True):
        before = read_counters()
        got_f = _g_forward(handler, batch, graph_grid_resident=resident)
        got_g = _step_grads(handler, batch, "cuda", graph_grid_resident=resident)
        now = read_counters()
        if now["banded_aggregate_bwd"] <= before["banded_aggregate_bwd"]:
            raise AssertionError("36: the grid step did not launch #15")
        d = max_abs(got_f, want_f)
        log(f"[36 grid-vs-dense] f32 on batch {shape}, graph_grid_resident {resident}: G's "
            f"bag embedding max |diff| {d:.3e} (bound 1e-5; largest |value| "
            f"{float(want_f.abs().max()):.3e})")
        if not d <= 1e-5:
            raise AssertionError(f"36: grid and dense forwards differ by {d}")
        _compare_grads("36 grid-vs-dense", f"grid (resident {resident}) against dense on the "
                       "card", got_g, want_g, shape)


def phase_grid_kernels(card):
    """Phase 37: #14 / #15 on the grid tables of two tissue slides (epn 9, as
    the path; C=384) about 40, 60 and 220 patches wide, f32 and bf16, against
    the plain versions (f32 1e-5; bf16 2e-2 and `banded_tol`), with
    CUDA-event times and byte bounds. The offsets are the 8 grid neighbours
    and a ninth (+-2W or +-2 on these slides), so the span is about 3W:
    within the 128 rows every kernel stages at W~40; at W~60 beyond the bf16
    backward's 128 but within the others' 192; at W~220 beyond all, so the
    far slots read device memory. Then #12 / #13 on the same tables'
    residual rows (their messages gathered in f32, as the path gathers
    them), against the plain version within 1e-5."""
    import numpy as np
    import torch
    from advmil_tpu_torch.data.synthetic import tissue_grid_tables
    from advmil_tpu_torch.ops import banded as tband
    from advmil_tpu_torch.ops import segment as tseg
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(37)
    rng = np.random.default_rng(37)
    report = {}
    for W, width, height in GRID_WIDTHS:
        tabs = tissue_grid_tables([(width, height), (width - 2, height - 2)], rng)
        widths = tabs["cropped_widths"]
        offs = torch.from_numpy(tabs["band_offs"]).to(dev)
        bm = torch.from_numpy(tabs["band_mask"]).to(dev)
        span = int((offs.max(1).values - offs.min(1).values).max())
        if (W == 40 and span > 128) or (W == 220 and span <= 192):
            raise AssertionError(f"37: offset span {span} at cropped widths {widths}")
        B, grid_n, C = 2, bm.shape[1], 384
        y32 = torch.relu(torch.randn(B, grid_n, C, device=dev, generator=g)) + 1e-7
        g32 = torch.randn(B, grid_n, C, device=dev, generator=g)
        t = torch.tensor([1.3], device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            y, gout = y32.to(dtype), g32.to(dtype)
            tag = "f32" if dtype == torch.float32 else "bf16"
            out, stats = tband.banded_core_fwd(y, offs, bm, t, save_stats=True)
            dy, dt = tband.banded_core_bwd(y, offs, bm, t, stats, gout)
            yy, tt = y.detach().clone().requires_grad_(True), t.clone().requires_grad_(True)
            ref = tband.banded_core_plain(yy, offs, bm, tt)
            want = torch.autograd.grad(ref, (yy, tt), gout, retain_graph=True)
            torch.cuda.synchronize()
            tol = dict(atol=1e-5, rtol=0.0) if dtype == torch.float32 else \
                dict(atol=2e-2, rtol=2e-2)
            for what, a, b in (("out", out, ref), ("dy", dy, want[0])):
                torch.testing.assert_close(a.float(), b.float(), **tol,
                                           msg=lambda m, w=what: f"37 W~{W} {tag} {w}: {m}")
            torch.testing.assert_close(dt, want[1].reshape(1).float(), atol=0.0, rtol=1e-4)
            tight = ""
            if dtype == torch.bfloat16:
                shares = [share_of(a, b, **tband.banded_tol(b.float()))
                          for a, b in ((out, ref), (dy, want[0]))]
                if max(shares) > 1:
                    raise AssertionError(f"37 W~{W}: outside banded_tol ({shares})")
                tight = f"; banded_tol used out {shares[0]:.3f} dy {shares[1]:.3f}"
            f_ms, fp_ms = timed_pair(lambda: tband.banded_core_fwd(y, offs, bm, t, True),
                                     lambda: tband.banded_core_plain(y, offs, bm, t))
            b_ms, bp_ms = timed_pair(
                lambda: tband.banded_core_bwd(y, offs, bm, t, stats, gout),
                lambda: torch.autograd.grad(ref, (yy, tt), gout, retain_graph=True))
            epn = bm.shape[2]
            fb = bound(nbytes(y, offs, bm, out, *stats), 8 * epn * y.numel(), "f32")
            bb = bound(nbytes(y, offs, bm, gout, dy, *stats), 16 * epn * y.numel(), "f32")
            errs = (max_abs(out, ref.detach()), max_abs(dy, want[0]),
                    max_abs(dt, want[1].reshape(1)))
            log(f"[37 grid kernels] banded core on grid tables, cropped widths {widths} (offset "
                f"span {span} against the staged 128 / 192 rows), B={B} "
                f"grid_n={grid_n} epn={epn} C={C} {tag}: max_abs_err out {errs[0]:.3e} dy "
                f"{errs[1]:.3e} dt {errs[2]:.3e}{tight} | fwd {f_ms:.4f} ms (plain {fp_ms:.4f}, "
                f"bound {fb['bound_ms']:.4f} {fb['bound_by']}) | bwd {b_ms:.4f} ms (plain "
                f"{bp_ms:.4f}, bound {bb['bound_ms']:.4f} {bb['bound_by']}) | {card}")
            for name, ms, pms, b_, err in (("banded_aggregate", f_ms, fp_ms, fb, errs[0]),
                                           ("banded_aggregate_bwd", b_ms, bp_ms, bb,
                                            max(errs[1:]))):
                row = dict(ms=ms, plain_ms=pms, max_abs_err=err, bound_ms=b_["bound_ms"],
                           bound_by=b_["bound_by"])
                if dtype == torch.float32:
                    report.setdefault(name, {})[W] = {"f32": row}
                else:       # bf16: the grid path's dtype in phase 35
                    report[name][W].update(row, dtype="bf16", library_ms=None, span=span,
                                           grid_n=grid_n)
            del out, stats, dy, ref, want
        # #12 / #13 on the residual rows: the messages of their whole edge rows
        u_src = torch.from_numpy(tabs["band_usrc"]).to(dev).long()
        u_em = torch.from_numpy(tabs["band_uemask"]).to(dev)
        U, epn = u_src.shape[1], u_src.shape[2]
        msg32 = torch.gather(y32, 1, u_src.reshape(B, -1, 1).expand(B, U * epn, C)
                             ).reshape(B, U, epn, C)
        real = int((tabs["band_urows"] < grid_n).sum(1).max())
        for dtype in (torch.float32, torch.bfloat16):   # the path gathers in f32
            msg, gu = msg32.to(dtype), g32[:, :U].to(dtype)
            tag = "f32" if dtype == torch.float32 else "bf16"
            out = tseg.fused_agg_fwd(msg, u_em, t)
            dm, dt = tseg.fused_agg_bwd(msg, u_em, t, gu)
            dm2, dt2 = tseg.fused_agg_bwd(msg, u_em, t, gu)
            mm, tt = msg.clone().requires_grad_(True), t.clone().requires_grad_(True)
            ref = tseg.knn_edge_softmax_aggregate(mm, u_em, tt)
            want = torch.autograd.grad(ref, (mm, tt), gu, retain_graph=True)
            torch.cuda.synchronize()
            tol = dict(atol=1e-5, rtol=0.0) if dtype == torch.float32 else \
                dict(atol=2e-2, rtol=2e-2)
            for what, a, b in (("out", out, ref), ("dmessages", dm, want[0])):
                torch.testing.assert_close(a.float(), b.float(), **tol,
                                           msg=lambda m, w=what: f"37 W~{W} knn {tag} {w}: {m}")
            torch.testing.assert_close(dt, want[1].reshape(1), atol=0.0, rtol=1e-4)
            if not (torch.equal(dm, dm2) and torch.equal(dt, dt2)):
                raise AssertionError(f"37 W~{W} knn {tag}: two backward calls differ")
            if not (bool((out[u_em.sum(-1) == 0] == 0).all()) and bool((dm[u_em == 0] == 0).all())):
                raise AssertionError(f"37 W~{W} knn {tag}: a slot row without edges or a masked "
                                     f"slot is not 0")
            tight = ""
            if dtype == torch.bfloat16:
                shares = (share_of(out, ref, **tseg.knn_tol(ref)),
                          share_of(dm, want[0], **tseg.knn_bwd_tol(want[0])))
                if not all(x <= 1.0 for x in shares):
                    raise AssertionError(f"37 W~{W} knn bf16: outside knn_tol / knn_bwd_tol "
                                         f"({shares})")
                tight = f"; knn_tol used out {shares[0]:.3f}, knn_bwd_tol dm {shares[1]:.3f}"
            f_ms, fp_ms = timed_pair(lambda: tseg.fused_agg_fwd(msg, u_em, t),
                                     lambda: tseg.knn_edge_softmax_aggregate(msg, u_em, t))
            b_ms, bp_ms = timed_pair(lambda: tseg.fused_agg_bwd(msg, u_em, t, gu),
                                     lambda: torch.autograd.grad(ref, (mm, tt), gu,
                                                                 retain_graph=True))
            fb = bound(nbytes(msg, u_em, out), 8 * msg.numel(), "f32")
            bb = bound(nbytes(msg, dm, u_em, gu), 16 * msg.numel(), "f32")
            errs = (max_abs(out, ref.detach()), max_abs(dm, want[0]),
                    max_abs(dt, want[1].reshape(1)))
            log(f"[37 grid kernels] kNN aggregation on the residual rows of the same tables "
                f"(U={U} slots, at most {real} real a bag), B={B} epn={epn} C={C} {tag}: "
                f"max_abs_err out {errs[0]:.3e} dmessages {errs[1]:.3e} dt {errs[2]:.3e}{tight}; "
                f"two bwd calls bit for bit | fwd {f_ms:.4f} ms (plain {fp_ms:.4f}, bound "
                f"{fb['bound_ms']:.4f} {fb['bound_by']}) | bwd {b_ms:.4f} ms (plain {bp_ms:.4f}, "
                f"bound {bb['bound_ms']:.4f} {bb['bound_by']}) | {card}")
            for name, ms, pms, b_, err in (("fused_knn_softmax_aggregate", f_ms, fp_ms, fb,
                                            errs[0]),
                                           ("fused_knn_softmax_aggregate_bwd", b_ms, bp_ms, bb,
                                            max(errs[1:]))):
                row = dict(ms=ms, plain_ms=pms, max_abs_err=err, bound_ms=b_["bound_ms"],
                           bound_by=b_["bound_by"])
                if dtype == torch.float32:
                    report.setdefault(name, {})[W] = dict(
                        row, dtype="f32", library_ms=None, span=span, grid_n=grid_n, u_slots=U)
                else:
                    report[name][W]["bf16"] = row
            del msg, out, dm, dm2, ref, want
    return report


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
    train_widths = read_widths()
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
    disc_handler, disc_launches = timed("21 disc train", phase_disc_train, paths, card)
    timed("22 disc gpu-vs-cpu train", phase_disc_gpu_vs_cpu_train, disc_handler)
    ssl_handler, ssl_launches = timed("23 ssl train", phase_ssl_train, paths, card)
    timed("24 ssl gpu-vs-cpu train", phase_ssl_gpu_vs_cpu_train, ssl_handler)
    accum_handler, accum_launches = timed("25 accum train", phase_accum_train, paths, card,
                                          train_launches, train_widths)
    timed("26 accum gpu-vs-cpu train", phase_accum_gpu_vs_cpu, accum_handler)
    cluster_launches = timed("27 cluster", phase_cluster, paths, card)
    base_cluster_launches = timed("28 base cluster", phase_base_cluster, paths, card)
    timed("29 optimizer sweep", phase_optimizer_sweep, base_handler)
    la_launches = timed("30 lookahead_radam", phase_other_optimizer, paths, small_split, card)
    inst_report = timed("31 inst kernels", phase_inst_kernels, card)
    dp2_cfg, dp2_launches = timed("32 dp2", phase_dp2, paths, train_handler, card)
    inst2_step_launches, inst2_test_launches = timed(
        "33 inst2", phase_inst2, paths, train_handler, base_handler, dp2_cfg, card)
    tpaths = timed("34 tools", phase_tools, card)
    grid_handler, grid_launches, grid_test_launches = timed("35 grid train", phase_grid_train,
                                                            tpaths, card)
    log(f"[35 grid train] training bags/s, epochs 1 / 2: grid route on the tool-built graphs "
        f"{rate(grid_handler)} beside phase 8's banded route {rate(banded_handler)} (other "
        f"data, a reading only) | {card}")
    timed("36 grid checks", phase_grid_checks, grid_handler)
    grid_report = timed("37 grid kernels", phase_grid_kernels, card)
    for d in ("data", "tissue"):
        shutil.rmtree(osp.join(WORK_DIR, d), ignore_errors=True)
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
                       "base_graph_train": base_graph_launches[name],
                       "disc_train": disc_launches[name],
                       "ssl_train": ssl_launches[name],
                       "accum_train": accum_launches[name],
                       "cluster_train": cluster_launches["train"][name],
                       "cluster_test_mode": cluster_launches["test"][name],
                       "base_cluster_adahessian_train": base_cluster_launches["adahessian"][name],
                       "base_cluster_refregime_train": base_cluster_launches["refregime"][name],
                       "lookahead_radam_train": la_launches[name],
                       "dp2_train": dp2_launches[name],
                       "inst2_esat_step": inst2_step_launches[name],
                       "inst2_test_mode": inst2_test_launches[name],
                       "grid_train": grid_launches[name],
                       "grid_test_mode": grid_test_launches[name]}
            entry.update(launches=sum(by_path.values()), launches_by_path=by_path)
        if entry["launches"] <= 0:
            raise AssertionError(f"kernel {name} was never launched")
        for path, need in (("base_esat_train", ("ln_relu_region_mean",
                                                "ln_relu_region_mean_bwd")),
                           ("base_graph_train", ("fused_knn_softmax_aggregate",)),
                           ("disc_train", ("ln_relu_region_mean", "ln_relu_region_mean_bwd")
                            + FLASH_KERNELS),
                           ("ssl_train", ("ln_relu_region_mean", "ln_relu_region_mean_bwd")),
                           ("accum_train", LN_KERNELS + FLASH_KERNELS),
                           ("cluster_train", LN_KERNELS),
                           ("cluster_test_mode", LN_KERNELS[:1]),
                           ("lookahead_radam_train", LN_KERNELS),
                           ("dp2_train", LN_KERNELS + FLASH_KERNELS),
                           ("inst2_esat_step", LN_KERNELS + FLASH_KERNELS[:1]
                            + FLASH_KERNELS[2:]),
                           ("inst2_test_mode", LN_KERNELS[:1] + FLASH_KERNELS[:1]),
                           ("grid_train", GRAPH_KERNELS + LN_KERNELS),
                           ("grid_test_mode", ("banded_aggregate", "ln_relu_region_mean"))):
            if name in need and entry["launches_by_path"][path] <= 0:
                raise AssertionError(f"kernel {name} was not launched on {path}")
        entry.update({k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")})
        entry.update({k: r[k] for k in ("dtype", "bf16") if k in r})
        if name in inst_report:       # phase 31: the local query rows of an inst rank
            entry["lq_lt_lk"] = inst_report[name]
        kernels.append(entry)
        # phase 37: the graph kernels on grid tables, one row per cropped
        # width (#14 / #15 in bf16, the grid path's dtype in phase 35, with
        # f32 beside it; #12 / #13 in f32, as the path runs them, with bf16
        # beside it); their
        # launches are the grid path's (phase 35)
        for W, row in grid_report.get(name, {}).items():
            kernels.append(dict(
                {k: entry[k] for k in ("route", "source", "replaces")}, **row,
                name=f"{name}@grid_W{W}",
                launches=grid_launches[name] + grid_test_launches[name],
                launches_by_path={"grid_train": grid_launches[name],
                                  "grid_test_mode": grid_test_launches[name]}))
    assert all(math.isfinite(k[f]) for k in kernels for f in ("ms", "plain_ms", "bound_ms"))
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
