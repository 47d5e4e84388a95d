#!/usr/bin/env python3
"""Device time of every kernel behind the fused patch embedding, beside the
library pair it replaces, on one CUDA GPU.

    python3 scripts/profile_fused_embed.py
    python3 scripts/profile_fused_embed.py --dx [--other-csrc DIR] [--variants a,b] [--reps 20]
    python3 scripts/profile_fused_embed.py --dx-mutant
    python3 scripts/profile_fused_embed.py --fwd --dparams [--other-csrc DIR] [--variants a,b]
    python3 scripts/profile_fused_embed.py --mutants
    python3 scripts/profile_fused_embed.py --f32 --fwd --dparams --mutants [--other-csrc DIR] [--variants a,b]

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

`--fwd` / `--dparams`: the bf16 row kernel (#9; `csrc/fused_embed_rows.cu`)
and the parameter backward (#11: the row kernel in backward mode, then dW =
x^T dh, `csrc/fused_embed_dw.cu`), both on wgmma + TMA. First the checks
(`EMBED_SHAPES`: D = 32 .. 384, ragged M, narrow K, a zero region): the
forward against `fused_region_embedding_plain` within `fwd_tol`, dh against
`fused_region_embedding_dh_plain` rounded within `dh_tol`, dW against the
plain product of the kernel's own dh within `dw_tol`, db / dscale / dbias and
every value also within the plain bounds (2e-2 + 2e-2 relative), and two
calls bit for bit. Then times at M = 32,768, K = 1,024, D = 384 and 128 of
the C entry points (the wrapper's cast of W not included) beside the library
pair (`F.linear` + the LN-pool kernel; the LN-pool backward + `F.linear`'s
dW, db), the dh and the dW launch apart, with `--other-csrc` and `--variants`
(`ROW_VARIANTS`) in the same turns; then one call of each under
`torch.profiler`, for the share of the ordered sums. JSON lines to stdout and
`chiprun_out/profile_fused_embed_rows.jsonl`.

`--mutants`: three faulty builds (`EMBED_MUTANTS`: a 64-wide K chunk dropped
in one row tile; one M slab dropped from dW; a column beyond D let into the
LayerNorm's variance at D = 96), each held to the plain and the tight bounds
over `MUTANT_CASES` (rows of mean 0 to 1 for the LayerNorm one); fails
unless each is caught by its tight bound.

`--f32` with `--fwd` / `--dparams` / `--mutants`: the same for the f32
kernels of `csrc/fused_embed.cu` (true f32 on the CUDA cores; TF32 off for
the library pair too). The checks hold each value to the f32 bounds of
`chip_smoke.py` phase 3 (values 1e-5 + 1e-4 relative, dh and the gradients
2e-4 + 1e-3 relative against the plain versions), which are the tight ones
in f32; the times use the f32 peak (67 TFLOP/s) for the bound;
`F32_VARIANTS` are the builds without the products' FMAs (`no_products`),
without the loads after the ring's first round (`no_loads`) or without the
row kernel's epilogue (`no_epilogue`; all three give wrong results and are
only timed); `F32_MUTANTS` are the three faults written for
the f32 sources. Beside the ptxas lines it prints, from `cuobjdump -sass` of
the library, the FFMA and shared-load (LDS) instructions of each f32
kernel's innermost loop that holds FFMAs (`sass_loops`).
"""
import argparse
import json
import os
import os.path as osp
import re
import shutil
import statistics
import subprocess
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


_ROWS, _DW = "fused_embed_rows.cu", "fused_embed_dw.cu"
_ROW_K_STEPS = "for (int s = 0; s < wg::kChunk / 16; ++s) {  // K beyond the edge is zero fill"
_DW_K_STEPS = "for (int s = 0; s < kDwChunkRows / 16; ++s)  // 16 reduction rows: 2,048 bytes"
# name: (file, text, replacement) triples; each text must occur exactly once in its file.
# The no_* variants give wrong results and are only timed.
ROW_VARIANTS = {
    "no_store": [(_ROWS, "if (live && c < D)", "if (live && c < 0)"),
                 (_ROWS, "if (row < M && col < D)", "if (row < 0 && col < D)"),
                 (_DW, "      if (col < D)", "      if (col < 0)")],
    "no_mma": [(_ROWS, _ROW_K_STEPS, "for (int s = 0; s < (D < 0 ? wg::kChunk / 16 : 0); ++s) {"),
               (_DW, _DW_K_STEPS, "for (int s = 0; s < (D < 0 ? kDwChunkRows / 16 : 0); ++s)")],
    "stages2": [(_ROWS, "kRowMaxStages = 6;", "kRowMaxStages = 2;"),
                (_DW, "kDwMaxStages = 6;", "kDwMaxStages = 2;")],
    "stages4": [(_ROWS, "kRowMaxStages = 6;", "kRowMaxStages = 4;"),
                (_DW, "kDwMaxStages = 6;", "kDwMaxStages = 4;")],
    # (one block alone would load all of W^T's D rows as one box: above TMA's 256 at D = 384)
    "cluster4": [(_ROWS, "kRowCluster = 2;", "kRowCluster = 4;")],
}
ROW_VARIANTS["loads_only"] = ROW_VARIANTS["no_store"] + ROW_VARIANTS["no_mma"]
# the backward row kernel without its epilogue (dh, sums): the products and loads alone
ROW_VARIANTS["bwd_no_epilogue"] = [
    (_ROWS, "    const int tid = threadIdx.x;\n    consumer_barrier();",
     "    const int tid = threadIdx.x;\n    if (D > 0) {\n      wg::cluster_sync();\n"
     "      return;\n    }\n    consumer_barrier();")]
EMBED_MUTANTS = {
    "K chunk 1 dropped in row tile 1": [
        (_ROWS, _ROW_K_STEPS,
         "for (int s = 0; s < ((kc == 1 && blockIdx.x == 1) ? 0 : wg::kChunk / 16); ++s) {")],
    "slab 1 of M dropped from dW": [
        (_DW, _DW_K_STEPS, "for (int s = 0; s < (blockIdx.z == 1 ? 0 : kDwChunkRows / 16); ++s)")],
    "8 columns beyond D in the variance": [
        (_ROWS, "if (p * S::kN + 8 * j < D) {", "if (p * S::kN + 8 * j < D + 8) {")],
}
_F32 = "fused_embed.cu"
_F32_ROW_K = "for (int kq = 0; kq < kBK; kq += 4) {\n      float4 an[8];"
_F32_GEMM_K = "for (int kq = 0; kq < kBK; kq += 4) {\n      float an[4][8], bn[4][8];"
# name: (file, text, replacement) triples in the f32 sources; wrong results, only timed
F32_VARIANTS = {
    "no_products": [(_F32, _F32_ROW_K, _F32_ROW_K.replace("kq < kBK", "kq < (nk < 0 ? kBK : 0)")),
                    (_F32, _F32_GEMM_K, _F32_GEMM_K.replace("kq < kBK", "kq < (nk < 0 ? kBK : 0)"))],
    # each ring slot is filled once; later chunks multiply stale tiles
    "no_loads": [(_F32, "if (kt < nk) {\n      float* As = stage_a(kt);\n      load_tile<kRowsBM",
                  "if (kt < nk && kt < kStages - 1) {\n      float* As = stage_a(kt);\n"
                  "      load_tile<kRowsBM"),
                 (_F32, "if (kt < nk) {\n      float* As = stage_a(kt);\n      float* Bs",
                  "if (kt < nk && kt < kStages - 1) {\n      float* As = stage_a(kt);\n"
                  "      float* Bs")],
    # the row kernel ends after its products (which it keeps: D <= 0 would use them)
    "no_epilogue": [(_F32, "  cp_async_wait<0>();\n\n  // h = acc + b",
                     "  cp_async_wait<0>();\n  if (D > 0) return;\n\n  // h = acc + b")],
}
F32_MUTANTS = {
    "K chunk 1 dropped in row tile 1": [
        (_F32, _F32_ROW_K,
         _F32_ROW_K.replace("kq < kBK", "kq < ((kt == 1 && blockIdx.x == 1) ? 0 : kBK)"))],
    "slab 1 of M dropped from dW": [
        (_F32, _F32_GEMM_K, _F32_GEMM_K.replace("kq < kBK", "kq < (blockIdx.z == 1 ? 0 : kBK)"))],
    # the first idle group of 32 columns (zero-filled W: h = 0 there) in the variance
    "32 columns beyond D in the variance": [
        (_F32, "    if (live[j]) {\n#pragma unroll\n      for (int i = 0; i < 8; ++i) {\n"
               "        const float dx",
         "    if (32 * (wc + 4 * j) < D + 32) {\n#pragma unroll\n      for (int i = 0; i < 8; ++i) {\n"
         "        const float dx")],
}
# the f32 kernels whose ptxas lines and innermost loops are reported
F32_KERNELS = ("fused_rows_kernel", "gemm_tile_kernel", "sum_rows_kernel")
# (M, K, D, mean of b, a zero region): the checks of right kernels
EMBED_SHAPES = [(32768, 1024, 384, 0.0, True), (32768, 1024, 128, 0.0, True),
                (16 * 67, 1024, 384, 0.0, True), (16 * 67, 128, 96, 0.0, True),
                (48, 64, 32, 0.0, True), (16, 32, 256, 0.0, True), (4096, 1024, 320, 0.0, True),
                (16 * 9, 288, 64, 0.0, True), (4096, 1024, 96, 1.0, True)]
# rows of mean 0.3 .. 1 without a zero region: there a zero row's variance is
# b's own, which the variance mutant changes many times over in any case
MUTANT_CASES = [(32768, 1024, 384, 0.0, True), (32768, 1024, 128, 0.0, True),
                (16 * 67, 1024, 384, 0.0, True), (32768, 1024, 96, 0.0, True),
                (32768, 1024, 96, 0.3, False), (32768, 1024, 96, 0.5, False),
                (32768, 1024, 96, 1.0, False), (16 * 67, 1024, 96, 0.5, False)]


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
    `old` of `changes` (which must occur once in its file) reads `new`;
    `changes` holds (old, new) pairs in `fname` or (file, old, new) triples.
    Returns (lib, directory)."""
    from advmil_tpu_torch.ops import _build
    tmp = Path(ROOT) / "chiprun_out" / f"patched_{name.replace(' ', '_')}"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.copytree(_build.CSRC, tmp / "csrc")
    for change in changes:
        f, old, new = change if len(change) == 3 else (fname, *change)
        text = (tmp / "csrc" / f).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to change occurs {text.count(old)} times in {f}")
        (tmp / "csrc" / f).write_text(text.replace(old, new))
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


def embed_case(M, K, D, b_mean, dev, zero_region=True, seed=0, dtype=None):
    """x [M, K] in `dtype` (bf16 unless given; rows 16 .. 31 zero with
    `zero_region`), f32 parameters (b around `b_mean`: the rows' mean), and a
    cotangent zeroed on the zero region and wherever a ReLU input lies within
    2e-5 of 0 (there a rounding flips the mask)."""
    import torch

    import chip_smoke
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed + M + K + D)
    x = torch.randn(M, K, device=dev, generator=g).to(dtype)
    if M >= 32 and zero_region:
        x[16:32] = 0.0
    w = torch.randn(K, D, device=dev, generator=g) / K ** 0.5
    b = b_mean + 0.1 * torch.randn(D, device=dev, generator=g)
    scale = 1.0 + 0.1 * torch.randn(D, device=dev, generator=g)
    bias = 0.1 * torch.randn(D, device=dev, generator=g)
    gout = torch.randn(M // 16, D, device=dev, generator=g)
    if M >= 32 and zero_region:
        gout[1] = 0.0
    pre = chip_smoke.pre_relu(x.float() @ w.to(dtype).float() + b, scale, bias)
    return x, w, b, scale, bias, chip_smoke.away_from_relu_edge(pre, gout, 16)


def w_operand(w, dtype):
    """W as the row kernels take it: W^T [D, K] in bf16, W [K, D] in f32."""
    import torch
    return w.bfloat16().t().contiguous() if dtype == torch.bfloat16 else w.contiguous()


def fwd_of(lib, x, wk, b, scale, bias):
    """The forward from `lib`'s C entry point (wk: `w_operand`)."""
    import torch
    from advmil_tpu_torch.ops import _build
    from advmil_tpu_torch.ops.ln_pool import LN_EPS
    (M, K), D = x.shape, b.shape[0]
    out = torch.empty((M // 16, D), dtype=x.dtype, device=x.device)
    _build.check(lib.advmil_fused_embed_fwd(x.data_ptr(), wk.data_ptr(), b.data_ptr(),
                                            scale.data_ptr(), bias.data_ptr(), out.data_ptr(), M,
                                            K, D, _build.DTYPE_CODES[x.dtype], LN_EPS,
                                            _build.stream_of(x)),
                 "advmil_fused_embed_fwd")
    return out


def dh_of(lib, gout, x, wk, b, scale, bias):
    """(dh, [db, dscale, dbias]) from `lib`'s backward row kernel."""
    import torch
    from advmil_tpu_torch.ops import _build
    from advmil_tpu_torch.ops.ln_pool import LN_EPS
    (M, K), D = x.shape, b.shape[0]
    code = _build.DTYPE_CODES[x.dtype]
    dh = torch.empty((M, D), dtype=x.dtype, device=x.device)
    sums = torch.empty((3, D), dtype=torch.float32, device=x.device)
    # (M, dtype): 64-row f32 blocks, 128-row bf16 ones; a library built before
    # the f32 redesign (128 rows in both) reads M alone
    part = torch.empty((lib.advmil_fused_embed_row_blocks(M, code), 3, D), dtype=torch.float32,
                       device=x.device)
    _build.check(lib.advmil_fused_embed_bwd_dh(gout.data_ptr(), x.data_ptr(), wk.data_ptr(),
                                               b.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                               dh.data_ptr(), part.data_ptr(), sums.data_ptr(), M,
                                               K, D, code, LN_EPS, _build.stream_of(x)),
                 "advmil_fused_embed_bwd_dh")
    return dh, sums


def dw_of(lib, x, dh, part):
    """dW [K, D] f32 from `lib`'s product; `part` holds the slabs' partials."""
    import torch
    from advmil_tpu_torch.ops import _build
    (M, K), D = x.shape, dh.shape[1]
    dw = torch.empty((K, D), dtype=torch.float32, device=x.device)
    _build.check(lib.advmil_fused_embed_dw(x.data_ptr(), dh.data_ptr(), dw.data_ptr(),
                                           part.data_ptr(), M, K, D, _build.DTYPE_CODES[x.dtype],
                                           _build.stream_of(x)),
                 "advmil_fused_embed_dw")
    return dw


def dw_scratch(lib, M, K, D, dev, dtype):
    import torch
    from advmil_tpu_torch.ops import _build
    slabs = lib.advmil_fused_embed_dw_slabs(M, K, D, _build.DTYPE_CODES[dtype])
    return torch.empty((slabs if slabs > 1 else 0, K, D), dtype=torch.float32, device=dev)


# f32: the bounds of chip_smoke.py phase 3 (values; dh and the gradients), as (atol, rtol)
F32_OUT_TOL, F32_GRAD_TOL = (1e-5, 1e-4), (2e-4, 1e-3)


def check_embed(lib, cases, dev, tag, dtype=None):
    """Each case against the plain bounds and the tight ones (in f32 both are
    the f32 bounds); returns the records (shares of each bound, bit-for-bit
    repeat)."""
    import torch

    import chip_smoke
    from advmil_tpu_torch.ops import fused_embed as fe
    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    recs = []
    for M, K, D, b_mean, zero_region in cases:
        x, w, b, scale, bias, gout = embed_case(M, K, D, b_mean, dev, zero_region, dtype=dtype)
        wk = w_operand(w, dtype)
        part = dw_scratch(lib, M, K, D, dev, dtype)
        out = fwd_of(lib, x, wk, b, scale, bias)
        dh, sums = dh_of(lib, gout, x, wk, b, scale, bias)
        dw = dw_of(lib, x, dh, part)
        again = (fwd_of(lib, x, wk, b, scale, bias), *dh_of(lib, gout, x, wk, b, scale, bias))
        same = all(torch.equal(u, v) for u, v in zip((out, dh, sums), again)) and \
            torch.equal(dw, dw_of(lib, x, again[1], part))
        torch.cuda.synchronize()
        ref = fe.fused_region_embedding_plain(x, w, b, scale, bias)
        dh_ref = fe.fused_region_embedding_dh_plain(gout, x, w, b, scale, bias)[0].to(dtype)
        _, dw_ref, *sums_ref = fe.fused_region_embedding_bwd_plain(gout, x, w, b, scale, bias)
        share = chip_smoke.share_of
        if f32:
            tight = {"out": share(out, ref, *F32_OUT_TOL), "dh": share(dh, dh_ref, *F32_GRAD_TOL),
                     "dw": share(dw, dw_ref, *F32_GRAD_TOL),
                     "db_dscale_dbias": max(share(a, e, *F32_GRAD_TOL)
                                            for a, e in zip(sums, sums_ref))}
            plain = tight
        else:
            own = x.float().t() @ dh.float()
            plain = {"out": share(out, ref, 2e-2, 2e-2), "dw": share(dw, dw_ref, 2e-2, 2e-2),
                     "db_dscale_dbias": max(share(a, e, 2e-2, 2e-2)
                                            for a, e in zip(sums, sums_ref))}
            tight = {"out": share(out, ref, **fe.fwd_tol(ref)),
                     "dh": share(dh, dh_ref, **fe.dh_tol(dh_ref)),
                     "dw": share(dw, own, **fe.dw_tol(own))}
            del own
        finite = all(bool(torch.isfinite(t).all()) for t in (out, dh, dw, sums))
        zero = bool((dh[16:32] == 0).all()) if M >= 32 and zero_region else True
        rec = dict(check=f"{tag} M={M} K={K} D={D} b_mean={b_mean} {str(dtype)[6:]}",
                   share_of_plain=plain, share_of_tight=tight, bit_for_bit=same, finite=finite,
                   zero_region_dh_exactly_zero=zero,
                   ok=finite and zero and same and max(plain.values()) <= 1.0
                   and max(tight.values()) <= 1.0)
        emit(**rec)
        recs.append(rec)
        del x, w, out, dh, dw, part, ref, dh_ref, dw_ref
    return recs


def ptxas_report(prefixes):
    """ptxas lines of the kernels whose names contain one of `prefixes`, and
    every 'Potential Performance Loss' line (C7520 / C7511: wgmma serialized)."""
    from advmil_tpu_torch.ops import _build
    lines = _build.build_info.get("log", "").splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and any(p in ln for p in prefixes):
            emit(ptxas=ln.split("'")[1], used=" ".join(x.strip() for x in lines[i + 1:i + 4]))
    serialized = sorted({ln.strip() for ln in lines if "Potential Performance Loss" in ln})
    emit(ptxas_performance_warnings=serialized)


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_loops(so_path, prefixes):
    """For each kernel of the library whose name contains one of `prefixes`:
    from `cuobjdump -sass`, the innermost loop (a backward branch's range)
    that holds the most FFMAs, with its count of FFMA and of shared loads by
    width (LDS, LDS.64, LDS.128), and the same counts over the whole kernel."""
    from advmil_tpu_torch.ops import _build
    tool = osp.join(osp.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    for name, body in zip(parts[1::2], parts[2::2]):
        if not any(p in name for p in prefixes):
            continue
        insns = [(int(a, 16), op, rest) for a, op, rest in _SASS_INSN.findall(body)]

        def counts(seq):
            c = {"FFMA": 0, "LDS": 0, "LDS.64": 0, "LDS.128": 0}
            for _, op, _ in seq:
                base = op.split(".")[0]
                if base == "FFMA":
                    c["FFMA"] += 1
                elif base == "LDS":
                    width = ".128" if ".128" in op else ".64" if ".64" in op else ""
                    c["LDS" + width] += 1
            return c

        loops = []
        for addr, op, rest in insns:
            m = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
                lo = int(m.group(1), 16)
                body_insns = [t for t in insns if lo <= t[0] <= addr]
                loops.append((counts(body_insns), addr - lo, len(body_insns)))
        # the loop with the most FFMAs; of equals, the innermost (shortest)
        best = max(loops, key=lambda t: (t[0]["FFMA"], -t[1])) if loops else None
        emit(sass=name, whole_kernel=counts(insns),
             main_loop=best[0] if best else None,
             main_loop_instructions=best[2] if best else None)


def run_embed(args, card, dev):
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from advmil_tpu_torch.ops import _build
    from advmil_tpu_torch.ops import ln_pool
    f32 = args.f32
    dtype = torch.float32 if f32 else torch.bfloat16
    tag = "f32" if f32 else "bf16"
    peak = 67e12 if f32 else 989e12
    lib = _build.load()
    if f32:
        ptxas_report(F32_KERNELS)
        sass_loops(_build.build_info["path"], F32_KERNELS)
    else:
        ptxas_report(("rows_wgmma", "dw_wgmma"))
    ok = all(r["ok"] for r in check_embed(lib, EMBED_SHAPES, dev, "embed", dtype))
    emit(all_embed_checks_ok=ok)
    others, tmps = {}, []
    if args.other_csrc:
        others["other_csrc"] = load_from(args.other_csrc,
                                         osp.join(ROOT, "chiprun_out", "other_build"))
    variants = F32_VARIANTS if f32 else ROW_VARIANTS
    for name in filter(None, (args.variants or "").split(",")):
        others[name], tmp = build_patched(name, _ROWS, variants[name])
        tmps.append(tmp)
    M, K = 32768, 1024
    for D in (384, 128):
        x, w, b, scale, bias, gout = embed_case(M, K, D, 0.0, dev, dtype=dtype)
        wk = w_operand(w, dtype)
        wt = w.to(dtype).t().contiguous()      # W^T [D, K]: F.linear's weight
        bl = b.to(dtype)
        libs = {"kernel": lib, **others}
        parts = {n: dw_scratch(lb, M, K, D, dev, dtype) for n, lb in libs.items()}
        dhs = {n: dh_of(lb, gout, x, wk, b, scale, bias)[0] for n, lb in libs.items()}
        flop = 2 * M * K * D
        small = 3 * D * 4
        el = x.element_size()
        if args.fwd:
            arms = {n: (lambda lb=lb: fwd_of(lb, x, wk, b, scale, bias)) for n, lb in libs.items()}
            arms["library"] = lambda: ln_pool.ln_relu_region_mean_fwd(F.linear(x, wt, bl), scale,
                                                                     bias)
            times = turns(arms, args.reps)
            moved = (x.numel() + wk.numel() + M // 16 * D) * el + small
            bound_ms = max(flop / peak, moved / 3.35e12) * 1e3
            med = {n: statistics.median(v) for n, v in times.items()}
            emit(time=f"fwd #9 M={M} K={K} D={D} {tag}", card=card, bound_ms=bound_ms,
                 **{f"{n}_ms": v for n, v in med.items()},
                 kernel_tflops=flop / med["kernel"] / 1e9,
                 kernel_share_of_bound=bound_ms / med["kernel"])
        if args.dparams:
            arms = {}
            for n, lb in libs.items():
                arms[f"{n}_dh"] = lambda lb=lb: dh_of(lb, gout, x, wk, b, scale, bias)
                arms[f"{n}_dw"] = lambda lb=lb, n=n: dw_of(lb, x, dhs[n], parts[n])
            hh = F.linear(x, wt, bl)
            lin = [t.detach().clone().requires_grad_(True) for t in (wt, bl)]
            hl = F.linear(x, *lin)

            def lib_params():
                d = ln_pool.ln_relu_region_mean_bwd(gout, hh, scale, bias)[0]
                return torch.autograd.grad(hl, lin, d, retain_graph=True)

            arms["library"] = lib_params
            times = turns(arms, args.reps)
            med = {n: statistics.median(v) for n, v in times.items()}
            moved = (x.numel() + wk.numel()) * el + gout.numel() * 4 + K * D * 4 + 3 * small
            bound_ms = max(2 * flop / peak, moved / 3.35e12) * 1e3
            emit(time=f"dparams #11 M={M} K={K} D={D} {tag}", card=card, bound_ms=bound_ms,
                 **{f"{n}_ms": v for n, v in med.items()},
                 **{f"{n}_dh_plus_dw_ms": med[f"{n}_dh"] + med[f"{n}_dw"] for n in libs},
                 dh_tflops=flop / med["kernel_dh"] / 1e9, dw_tflops=flop / med["kernel_dw"] / 1e9,
                 kernel_share_of_bound=bound_ms / (med["kernel_dh"] + med["kernel_dw"]))
            del hh, hl, lin
        if f32 and args.fwd:
            # #10 rides on the same product kernel as #11's dW
            from advmil_tpu_torch.ops import fused_embed as fe
            dh = dhs["kernel"]
            arms = {"kernel": lambda: fe.fused_region_embedding_bwd_dx(dh, w),
                    "library": lambda: torch.matmul(dh, wt)}
            times = turns(arms, args.reps)
            med = {n: statistics.median(v) for n, v in times.items()}
            bound_ms = max(flop / peak, (dh.numel() + wk.numel() + M * K) * el / 3.35e12) * 1e3
            emit(time=f"dx #10 M={M} K={K} D={D} {tag}", card=card, bound_ms=bound_ms,
                 **{f"{n}_ms": v for n, v in med.items()},
                 kernel_tflops=flop / med["kernel"] / 1e9,
                 kernel_share_of_bound=bound_ms / med["kernel"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fwd_of(lib, x, wk, b, scale, bias)
                dh_of(lib, gout, x, wk, b, scale, bias)
                dw_of(lib, x, dhs["kernel"], parts["kernel"])
            torch.cuda.synchronize()
        rows = [(getattr(ev, "self_device_time_total", 0), ev) for ev in prof.key_averages()]
        emit(profile=f"M={M} K={K} D={D} {tag}, device ms per launch", card=card,
             kernels={ev.key[:90]: us / ev.count / 1e3 for us, ev in rows
                      if us > 0 and ev.device_type.name != "CPU"})
        del x, w, wk, wt, dhs, parts
    for tmp in tmps:
        shutil.rmtree(tmp, ignore_errors=True)
    if not ok:
        raise SystemExit("an embedding check failed")


def turns(arms, reps):
    """CUDA-event times of each arm, in turns a, b, .., b, a (medians later)."""
    order = list(arms) + list(arms)[::-1]
    times = {n: [] for n in arms}
    for n in order:
        times[n] += event_ms(arms[n], reps)
    return times


def run_embed_mutants(args, dev):
    import torch
    f32 = args.f32
    dtype = torch.float32 if f32 else torch.bfloat16
    caught_all = True
    for name, changes in (F32_MUTANTS if f32 else EMBED_MUTANTS).items():
        lib, tmp = build_patched(name, _ROWS, changes)
        cases = [c for c in MUTANT_CASES if (c[2] == 96) == ("beyond D" in name)]
        recs = check_embed(lib, cases, dev, f"mutant '{name}'", dtype)
        shutil.rmtree(tmp, ignore_errors=True)
        caught = [max(r["share_of_tight"].values()) > 1.0 for r in recs]
        passes_plain = [max(r["share_of_plain"].values()) <= 1.0 for r in recs]
        emit(mutant=name, dtype=str(dtype)[6:], caught_by_tight_bounds=caught,
             passes_plain_bounds=passes_plain,
             tight_share=[max(r["share_of_tight"].values()) for r in recs])
        caught_all = caught_all and any(caught)
    if not caught_all:
        raise SystemExit("a mutant passed every tight bound")


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
    ap.add_argument("--fwd", action="store_true", help="check and time the bf16 forward (#9)")
    ap.add_argument("--dparams", action="store_true",
                    help="check and time the bf16 parameter backward (#11: dh, then dW)")
    ap.add_argument("--mutants", action="store_true",
                    help="build #9 / #11 with three faults; fail unless the tight bounds "
                         "catch them")
    ap.add_argument("--other-csrc", help="with --dx / --fwd / --dparams: another csrc tree timed "
                                         "in the same turns")
    ap.add_argument("--variants", help="comma-separated names of DX_VARIANTS (with --dx) or "
                                       "ROW_VARIANTS (with --fwd / --dparams) to build and time")
    ap.add_argument("--f32", action="store_true",
                    help="with --fwd / --dparams / --mutants: the f32 kernels of "
                         "csrc/fused_embed.cu instead of the bf16 ones")
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
    if args.fwd or args.dparams or args.mutants:
        try:
            if args.fwd or args.dparams:
                run_embed(args, card, dev)
            if args.mutants:
                run_embed_mutants(args, dev)
        finally:
            name = "profile_fused_embed_f32.jsonl" if args.f32 else "profile_fused_embed_rows.jsonl"
            with open(osp.join(ROOT, "chiprun_out", name), "w") as f:
                for rec in OUT:
                    f.write(json.dumps(rec) + "\n")
        return
    run_profile(card, dev)


if __name__ == "__main__":
    main()
