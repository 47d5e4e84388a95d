#!/usr/bin/env python3
"""Device time of every kernel behind the fused patch embedding, beside the
library pair it replaces, on one CUDA GPU.

    python3 scripts/profile_fused_embed.py
    python3 scripts/profile_fused_embed.py --dx [--other-csrc DIR] [--variants a,b] [--reps 20]
    python3 scripts/profile_fused_embed.py --dx-mutant

Without arguments, for M = 32,768 patches of K = 1,024 features, D = 384 and
128, bf16 and f32: five calls each of the forward (#9), the parameter backward
(#11: the row kernel in backward mode, the dW product and their ordered sums),
dx (#10), and `F.linear` + the LN-pool kernel, under `torch.profiler`; prints
the mean device ms per launch by kernel name (wrapper casts and transposes
included), the host's seconds to enqueue one forward call, and the largest
difference between the kernels' gradients and autograd through the plain
version (which keeps dh in f32 and does not avoid ReLU edges: a yardstick, not
a bound). `chip_smoke.py` holds the kernels to their bounds; this script is
for working on their speed.

`--dx`: the bf16 dx kernel (#10) alone. It is held to
`fused_region_embedding_bwd_dx_plain` on the same dh within `dx_tol` (one bf16
ulp relative + 2^-8 of the largest |dx|) at D = 32 .. 384, ragged M and narrow
K, then timed beside `torch.matmul` at M = 32,768, K = 1,024, D = 384 and 128
(CUDA events behind a spin kernel, medians, in turns). `--other-csrc DIR` also
builds the kernels from another source tree with the same C entry point (an
earlier commit's `advmil_tpu_torch/csrc`, unpacked anywhere) and times its dx
in the same turns. `--variants` does the same for builds of the present
sources with one textual change each (`DX_VARIANTS`: the kernel without its
stores, without its products or without W's loads, which give wrong results
and are only timed; another ring depth or cluster size). JSON lines go to
stdout and to `chiprun_out/profile_fused_embed_dx.jsonl`.

`--dx-mutant`: builds the dx kernel with one 64-wide chunk of D dropped in one
output tile and fails unless `dx_tol` catches it at D = 128 and 384. Variants
and the mutant are built from a patched copy of the sources under
`chiprun_out/`, removed afterwards; the shipped sources hold no switch.
"""
import argparse
import json
import os
import os.path as osp
import shutil
import statistics
import sys
import time
from pathlib import Path

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = []
# a warpgroup skips chunk 1 of output tile 1 (columns 128 .. 255 of dx lose D[64:128])
_K_STEPS = "for (int s = 0; s < wg::kChunk / 16; ++s) {"
DX_MUTANT = [(_K_STEPS, "for (int s = 0; s < ((kc == 1 && nt == 1) ? 0 : wg::kChunk / 16); ++s) {")]
_NO_STORE = ("if (row < M && col < K)", "if (row < 0 && col < K)")
_NO_MMA = (_K_STEPS, "for (int s = 0; s < (D < 0 ? wg::kChunk / 16 : 0); ++s) {")
# W's ring is filled once and then read again and again (stale data, no load after the first round)
_NO_LOAD = [("wg::mbar_wait(bar_full + 8 * st, (it / kDxStages) & 1);",
             "if (it < kDxStages) wg::mbar_wait(bar_full + 8 * st, 0);"),
            ("          const int st = it % kDxStages;\n          // every block's",
             "          if (it >= kDxStages) continue;\n          const int st = it % kDxStages;\n"
             "          // every block's")]
# name: (text, replacement) pairs in fused_embed_dx.cu; each text must occur exactly once.
# The first five give wrong results and are only timed.
DX_VARIANTS = {
    "no_store": [_NO_STORE],
    "no_mma": [_NO_MMA],
    "loads_only": [_NO_STORE, _NO_MMA],
    "mma_only": _NO_LOAD + [_NO_STORE],
    "mma_store": _NO_LOAD,
    "stages4": [("kDxStages = 6;", "kDxStages = 4;")],
    "stages8": [("kDxStages = 6;", "kDxStages = 8;")],
    "cluster1": [("kDxCluster = 2;", "kDxCluster = 1;")],
    "cluster4": [("kDxCluster = 2;", "kDxCluster = 4;")],
}


def emit(**rec):
    print(json.dumps(rec), flush=True)
    OUT.append(rec)


def load_from(csrc, build_dir):
    """The kernel library built from the sources under `csrc`, loaded beside
    the package's own; the package's build state is left as it was."""
    from advmil_tpu_torch.ops import _build
    saved = _build.CSRC, _build.BUILD_DIR, _build._lib, dict(_build.build_info)
    _build.CSRC, _build.BUILD_DIR, _build._lib = Path(csrc), Path(build_dir), None
    try:
        return _build.load()
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._lib = saved[:3]
        _build.build_info.clear()
        _build.build_info.update(saved[3])


def build_patched(name, fname, changes):
    """The library built from a copy of the package's sources in which each
    `old` of `changes` (which must occur once in `fname`) reads `new`; (lib,
    directory)."""
    from advmil_tpu_torch.ops import _build
    tmp = Path(ROOT) / "chiprun_out" / f"dx_{name}"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.copytree(_build.CSRC, tmp / "csrc")
    text = (tmp / "csrc" / fname).read_text()
    for old, new in changes:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to change occurs {text.count(old)} times in {fname}")
        text = text.replace(old, new)
    (tmp / "csrc" / fname).write_text(text)
    return load_from(tmp / "csrc", tmp / "_build"), tmp


def dx_of(lib, dh, w16):
    """dx from the C entry point of `lib` (bf16 dh [M, D], w16 [K, D])."""
    import torch
    from advmil_tpu_torch.ops import _build
    (M, D), K = dh.shape, w16.shape[0]
    dx = torch.empty((M, K), dtype=dh.dtype, device=dh.device)
    _build.check(lib.advmil_fused_embed_dx(dh.data_ptr(), w16.data_ptr(), dx.data_ptr(), M, K, D,
                                           _build.DTYPE_CODES[dh.dtype], _build.stream_of(dh)),
                 "advmil_fused_embed_dx")
    return dx


def dx_case(M, K, D, dev, seed=0):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed + M + K + D)
    dh = (torch.randn(M, D, device=dev, generator=g) / D ** 0.5).bfloat16()
    if M >= 32:
        dh[16:32] = 0.0
    w = torch.randn(K, D, device=dev, generator=g)
    return dh, w


def check_dx(lib, shapes, dev):
    """Whether every shape is within `dx_tol`, and the share of it each uses."""
    import torch
    from advmil_tpu_torch.ops import fused_embed as fe
    ok, shares = True, []
    for M, K, D in shapes:
        dh, w = dx_case(M, K, D, dev)
        got = dx_of(lib, dh, w.bfloat16().contiguous())
        torch.cuda.synchronize()
        want = fe.fused_region_embedding_bwd_dx_plain(dh, w)
        tol = fe.dx_tol(want)
        a, b = got.float(), want.float()
        share = float(((a - b).abs() / (tol["atol"] + tol["rtol"] * b.abs())).max())
        zero = bool((got[16:32] == 0).all()) if M >= 32 else True
        fine = bool(torch.isfinite(a).all()) and share <= 1.0 and zero
        emit(check=f"dx M={M} K={K} D={D} bf16", ok=fine, share_of_dx_tol=share,
             max_abs_err=float((a - b).abs().max()), largest=float(b.abs().max()),
             zero_rows_exactly_zero=zero)
        ok = ok and fine
        shares.append(share)
    return ok, shares


def event_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_500_000)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def run_dx(args, card, dev):
    import torch
    from advmil_tpu_torch.ops import _build
    lib = _build.load()
    lines = _build.build_info.get("log", "").splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "dx_wgmma" in ln:
            emit(ptxas=ln.split("'")[1], used=" ".join(x.strip() for x in lines[i + 1:i + 4]))
    # C7520 and its kin: the compiler serialized the wgmmas (about half the rate)
    serialized = sorted({ln.strip() for ln in lines if "Potential Performance Loss" in ln})
    emit(ptxas_performance_warnings=serialized)
    shapes = [(32768, 1024, 384), (32768, 1024, 128), (16 * 67, 1024, 384), (16 * 67, 128, 96),
              (48, 64, 32), (16, 32, 256), (4096, 1024, 320), (16 * 9, 288, 64)]
    ok, _ = check_dx(lib, shapes, dev)
    emit(all_dx_checks_ok=ok)
    others, tmps = {}, []
    if args.other_csrc:
        others["other_csrc"] = load_from(args.other_csrc,
                                         osp.join(ROOT, "chiprun_out", "other_build"))
    for name in filter(None, (args.variants or "").split(",")):
        others[name], tmp = build_patched(name, "fused_embed_dx.cu", DX_VARIANTS[name])
        tmps.append(tmp)
    for D in (384, 128):
        dh, w = dx_case(32768, 1024, D, dev)
        w16 = w.bfloat16().contiguous()
        wt = w16.t().contiguous()
        arms = {"kernel": lambda: dx_of(lib, dh, w16), "torch_matmul": lambda: torch.matmul(dh, wt)}
        for name, olib in others.items():
            arms[name] = lambda olib=olib: dx_of(olib, dh, w16)
        order = list(arms) + list(arms)[::-1]          # a, b, c, c, b, a
        times = {n: [] for n in arms}
        for n in order:
            times[n] += event_ms(arms[n], args.reps)
        flop, moved = 2 * 32768 * 1024 * D, 2 * (dh.numel() + w16.numel() + 32768 * 1024)
        emit(time=f"dx M=32768 K=1024 D={D} bf16", card=card,
             bound_ms=max(flop / 989e12, moved / 3.35e12) * 1e3,
             **{f"{n}_ms": statistics.median(v) for n, v in times.items()},
             kernel_tflops=flop / statistics.median(times["kernel"]) / 1e9)
    for tmp in tmps:
        shutil.rmtree(tmp, ignore_errors=True)
    if not ok:
        raise SystemExit("a dx check failed")


def run_dx_mutant(dev):
    lib, tmp = build_patched("mutant", "fused_embed_dx.cu", DX_MUTANT)
    new = DX_MUTANT[0][1]
    ok, shares = check_dx(lib, [(32768, 1024, 384), (32768, 1024, 128), (16 * 67, 1024, 384)], dev)
    shutil.rmtree(tmp, ignore_errors=True)
    emit(mutant="dx drops chunk 1 of D in output tile 1", change=new, passes_dx_tol=ok,
         share_of_dx_tol=shares)
    if min(shares) <= 1.0:
        raise SystemExit("the dx mutant passed dx_tol")


def run_profile(card, dev):
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from advmil_tpu_torch.ops import fused_embed as fe
    from advmil_tpu_torch.ops import ln_pool

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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dx", action="store_true", help="check and time the bf16 dx kernel alone")
    ap.add_argument("--dx-mutant", action="store_true",
                    help="build the dx kernel with a chunk of D dropped; fail unless dx_tol "
                         "catches it")
    ap.add_argument("--other-csrc", help="with --dx: another csrc tree whose dx is timed too")
    ap.add_argument("--variants", help="with --dx: comma-separated names of DX_VARIANTS to build "
                                       "and time beside the kernel")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    import chip_smoke
    card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    dev = torch.device("cuda")
    os.makedirs(osp.join(ROOT, "chiprun_out"), exist_ok=True)
    if args.dx or args.dx_mutant:
        try:
            if args.dx:
                run_dx(args, card, dev)
            if args.dx_mutant:
                run_dx_mutant(dev)
        finally:
            with open(osp.join(ROOT, "chiprun_out", "profile_fused_embed_dx.jsonl"), "w") as f:
                for rec in OUT:
                    f.write(json.dumps(rec) + "\n")
        return
    run_profile(card, dev)


if __name__ == "__main__":
    main()
