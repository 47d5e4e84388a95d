#!/usr/bin/env python3
"""Check and time the flash attention kernels of advmil_tpu_torch on one GPU.

    python3 scripts/profile_torch_flash.py [--no-time] [--reps 20]
    python3 scripts/profile_torch_flash.py --variant no_exp|no_mma|wide|narrow
    python3 scripts/profile_torch_flash.py --mutants
    python3 scripts/profile_torch_flash.py --f32 [--other-csrc DIR] [--only-other]
        [--variants a,b] [--other-variants a,b] [--mutants] [--reps 20]

Builds the kernels, prints the ptxas lines (registers, spills, shared memory)
of the flash kernels, holds the bf16 forward, dQ and dK/dV kernels against
the plain version (within the card tests' bounds) and against the plain
version that rounds where they round (within `rounded_tol`) over ragged
shapes, every head dim, Lq != Lk, masks with holes and fully masked tiles,
checks the dropout keep bits of all three kernels bit for bit against the
keep-mask kernel, and then times forward, dQ and dK/dV at the main path's
shapes (CUDA events behind a spin kernel, medians) beside
`F.scaled_dot_product_attention` and its backward on the same inputs, with
the achieved TFLOP/s over the real keys, and the device time of each kernel
behind one forward and one backward call from torch.profiler. JSON lines go
to stdout and to `chiprun_out/profile_torch_flash*.jsonl`.

`--variant` times a build with one textual change (`VARIANTS`): the kernels
without their exponentials or without their mma.sync products (wrong results,
so the checks are skipped), with 8-warp forward and dQ blocks always / never,
or with dQ's 8-warp blocks one to an SM (no register cap). `--mutants` builds
each fault of `MUTANTS` (a real key tile skipped, a term of dS dropped in
dK/dV, the same term dropped in dQ at every second key and at one key in
sixteen) and reports which of the two bounds catches it at the main path's
shapes; it fails unless `rounded_tol` catches every one. Variants and mutants
are built from a copy of the sources under `chiprun_out/`, removed afterwards:
the package's own sources and build directory are not touched.

`--f32`: the f32 kernels #5 (`csrc/flash_fwd.cu`) and #6 / #7
(`csrc/flash_bwd.cu`), true f32 on the CUDA cores. Prints their ptxas lines
and, from `cuobjdump -sass`, the FFMA / LDS / LDS.64 / LDS.128 / MUFU counts
of every loop of each kernel (nested loops' instructions not counted again).
Checks each build against the plain version within the card tests' f32
bound (atol = rtol = 1e-4): out, lse, dQ, dK and dV, the fully masked bag
exactly 0 (lse -1e30), two calls bit for bit and the keep bits of the
forward, dQ and dV against the torch Philox. Then times the three through
the C entry points (CUDA events behind a spin kernel, medians, in turns) at
`F32_SHAPES`: phase 3's training shape of `chip_smoke.py` (B = 2, L =
1,024, H = 8, Dh = 48, 300 keys of bag 0 masked, bag 1 fully masked) and
the same shape with every key real, p = 0.25 and 0, beside SDPA's forward
and its one-call backward (TF32 off) and the bound over the real keys (67
TFLOP/s against 3.35 TB/s); the forward also at `F32_FWD_SHAPES`, phase 3's
eval bag (B = 1, L = 2,048, its last 300 keys masked, p = 0).
`--other-csrc DIR` adds another source tree's kernels (an earlier commit's
`advmil_tpu_torch/csrc`; `--only-other` leaves the package's own build out)
to the same turns; `--variants` (`F32_VARIANTS`) and `--other-variants`
(`F32_PARENT_VARIANTS`, written for the tree before this forward: these
backward kernels and the lane-per-key forward) add builds with one textual
change: no exponentials, no Philox rounds, no second products (the
forward's P~ V), no step at all, the forward's V loads or half its q
loads taken out of their loops (wrong results: only timed). `--f32
--mutants` builds each fault of `F32_MUTANTS` (a real key tile skipped in
dQ and in the forward, one term of dS dropped at one key in sixteen in dQ
and in dK/dV, a Philox word taken for the wrong key in dQ and in the
forward, a split group's rescale dropped and the row sum of the dropped p
in the forward) and fails unless the f32 bound catches each at the main
shape. JSON lines to stdout and to
`chiprun_out/profile_torch_flash_f32*.jsonl`.
"""
import argparse
import json
import math
import os
import os.path as osp
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from advmil_tpu_torch.ops import _build  # noqa: E402
from advmil_tpu_torch.ops import attention as attn  # noqa: E402
from advmil_tpu_torch.ops import philox  # noqa: E402

SPIN_CYCLES = 1_500_000
OUT = []
CSRC = _build.CSRC    # the package's sources, whatever build is loaded

# name: (source, text, replacement); the text must occur exactly once
VARIANTS = {
    "no_exp": ("mma.cuh", """  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));
  return y;""", "  return fminf(fmaxf(fmaf(x, 0.01f, 0.5f), 0.f), 1.f);"),
    "no_mma": ("mma.cuh", "  asm volatile(\n      \"mma.sync", """  c[0] += __uint_as_float((a[0] ^ b0) & 0x3f7fffffu);
  c[2] += __uint_as_float((a[1] ^ b1) & 0x3f7fffffu);
  return;
  asm volatile(
      "mma.sync"""),
    "wide": ("mma.cuh", "kWideMinBlocksPerSm = 3;", "kWideMinBlocksPerSm = 0;"),
    "narrow": ("mma.cuh", "kWideMinBlocksPerSm = 3;", "kWideMinBlocksPerSm = 1000000;"),
    # dQ's 8-warp blocks one to an SM: 255 registers and no spills in place of 128 and two blocks
    "dq_wide_one_block": ("flash_dq_mma.cu", "__launch_bounds__(32 * NW, DH > 64 ? 1 : 2)",
                          "__launch_bounds__(32 * NW, (DH > 64 || NW == 8) ? 1 : 2)"),
}
_DQ_DS = ("s[j][1] = p1 * (d1 - dv0);\n      s[j][2] = p2 * (d2 - dv1);\n"
          "      s[j][3] = p3 * (d3 - dv1);")
MUTANTS = {
    # the forward and dQ never visit key tile 2 (keys 128..191), real or not
    "fwd_skips_a_real_tile": ("mma.cuh", "list[tt] = any ?", "list[tt] = any && tt != 2 ?"),
    # dK/dV: dS loses its - dvec term for every second query of the upper key rows
    "dkv_drops_a_term_of_ds": ("flash_dkv_mma.cu", "dp[j][1] = p1 * (d1 - dvv.y);",
                               "dp[j][1] = p1 * d1;"),
    # dQ: dS loses its - dvec term for every second key (large enough for both bounds) ...
    "dq_drops_a_term_of_ds": ("flash_dq_mma.cu", _DQ_DS,
                              "s[j][1] = p1 * d1;\n      s[j][2] = p2 * (d2 - dv1);\n"
                              "      s[j][3] = p3 * d3;"),
    # ... and for one key in sixteen (one column of each A fragment of dS K)
    "dq_drops_a_term_of_ds_at_one_key_in_16": (
        "flash_dq_mma.cu", _DQ_DS,
        "s[j][1] = p1 * (d1 - ((j % 2 == 0 && t == 0) ? 0.f : dv0));\n"
        "      s[j][2] = p2 * (d2 - dv1);\n"
        "      s[j][3] = p3 * (d3 - ((j % 2 == 0 && t == 0) ? 0.f : dv1));"),
}


def build_changed(name, change):
    """Build and load the kernels from a copy of the sources with `change`
    applied; returns the copy's directory (remove it when done)."""
    fname, old, new = change
    tmp = Path(ROOT) / "chiprun_out" / f"flash_variant_{name}"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.copytree(CSRC, tmp / "csrc")
    text = (tmp / "csrc" / fname).read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: the text to change occurs {text.count(old)} times in {fname}")
    (tmp / "csrc" / fname).write_text(text.replace(old, new))
    _build.CSRC, _build.BUILD_DIR, _build._lib = tmp / "csrc", tmp / "_build", None
    _build.load()
    return tmp


def emit(**rec):
    print(json.dumps(rec), flush=True)
    OUT.append(rec)


def ptxas_lines(log, needle):
    """(entry, resources) pairs of the kernels whose mangled name holds `needle`."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and needle in ln:
            name = ln.split("'")[1]
            used = next((x.strip() for x in lines[i + 1:i + 4] if "Used" in x), "")
            spill = next((x.strip() for x in lines[i + 1:i + 4] if "spill" in x), "")
            yield name, used, spill


def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return statistics.median(out)


def inputs(B, Lq, Lk, H, Dh, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(B, Lq, H, Dh, device=dev, generator=g).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, Lk, H, Dh, device=dev, generator=g).bfloat16() for _ in range(2))
    return q, k, v, do


def make_mask(kind, B, Lk, dev):
    mask = torch.ones(B, Lk, device=dev)
    if kind == "ragged":
        mask[0, max(1, Lk - 300 if Lk > 300 else Lk // 2):] = 0.0
    elif kind == "holes":
        g = torch.Generator(device=dev).manual_seed(Lk)
        mask = (torch.rand(B, Lk, device=dev, generator=g) < 0.7).float()
        mask[:, 0] = 1.0
    elif kind == "interior":          # a fully masked 64-key tile inside a real bag
        mask[0, 64:128] = 0.0
        mask[0, Lk - 20:] = 0.0
    if B > 1 and kind != "holes":
        mask[-1] = 0.0                # a fully masked bag
    return mask


def check_case(B, Lq, Lk, H, Dh, kind, p, dev):
    q, k, v, do = inputs(B, Lq, Lk, H, Dh, Lq + Lk + Dh, dev)
    mask = make_mask(kind, B, Lk, dev)
    seed = 0x1234_5678_9ABC_DEF0 if p else None
    out, lse = attn.flash_attention_fwd(q, k, v, mask, p, seed)
    dq, dk, dv = attn.flash_attention_bwd(q, k, v, mask, out, lse, do, p, seed)
    torch.cuda.synchronize()
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ref = attn.masked_attention_reference(*leaves, mask, p, seed)
    want = torch.autograd.grad(ref, leaves, do)
    rnd = attn.masked_attention_rounded(q, k, v, mask, do, p, seed)
    errs, errs_r, shares, ok, tight_ok = {}, {}, {}, True, True
    # the card tests' bounds: forward at p = 0 2e-2 abs; else 3e-2 abs + rel
    for name, a, b_, c in (("out", out, ref.detach(), rnd[0]), ("dq", dq, want[0], rnd[1]),
                           ("dk", dk, want[1], rnd[2]), ("dv", dv, want[2], rnd[3])):
        a, b_, c = a.float(), b_.float(), c.float()
        errs[name] = float((a - b_).abs().max())
        errs_r[name] = float((a - c).abs().max())
        tol, rtol = (2e-2, 0.0) if name == "out" and not p else (3e-2, 3e-2)
        ok = ok and bool(torch.isfinite(a).all()) and bool(((a - b_).abs() <= tol + rtol * b_.abs()).all())
        t = attn.rounded_tol(c)
        shares[name] = float(((a - c).abs() / (t["atol"] + t["rtol"] * c.abs())).max())
        tight_ok = tight_ok and shares[name] <= 1.0
        if B > 1 and kind != "holes":
            ok = ok and bool((a[-1] == 0).all())
    emit(check=f"B={B} Lq={Lq} Lk={Lk} H={H} Dh={Dh} {kind} p={p}", ok=ok,
         ok_vs_rounded_plain=tight_ok, largest_share_of_rounded_tol=max(shares.values()),
         share_of_rounded_tol=shares, err_vs_plain=errs, err_vs_rounded_plain=errs_r)
    return ok, tight_ok


def run_mutants(dev):
    """Each fault of MUTANTS at the main path's shapes: caught by the bounds
    against the plain version, by rounded_tol, or by neither."""
    all_caught = True
    for name, change in MUTANTS.items():
        tmp = build_changed(name, change)
        passed_plain, passed_tight = [], []
        for case in ((2, 1024, 1024, 8, 48, "ragged"), (2, 2048, 2048, 8, 48, "ragged"),
                     (1, 4096, 4096, 8, 48, "ragged")):
            for p in (0.0, 0.25):
                ok, tight_ok = check_case(*case, p, dev)
                passed_plain += [f"L={case[1]} p={p}"] * ok
                passed_tight += [f"L={case[1]} p={p}"] * tight_ok
        emit(mutant=name, change=change[2], passes_the_plain_bounds_at=passed_plain,
             passes_rounded_tol_at=passed_tight)
        all_caught = all_caught and not passed_tight
        shutil.rmtree(tmp, ignore_errors=True)
    return all_caught


def check_keep_bits(dev):
    """q = 0 gives uniform probabilities; with v = I the forward's output is
    non-zero exactly where an element was kept, and with dO = I so is dV. For
    dQ: k = I makes dQ[i, j] = dS[i, j]; an `out` of zeros makes dvec 0, and
    v = dO = e_0 makes every dP 1, so dQ is non-zero exactly where kept."""
    BH, L, Dh, p, seed = 6, 128, 128, 0.4, (1 << 63) + 99
    q = torch.zeros(1, L, BH, Dh, device=dev, dtype=torch.bfloat16)
    eye = torch.eye(L, device=dev, dtype=torch.bfloat16)[None, :, None, :].expand(1, L, BH, Dh)
    eye = eye.contiguous()
    mask = torch.ones(1, L, device=dev)
    keep = philox.keep_mask(seed, BH, L, L, p, device=dev)          # [BH, Lq, Lk]
    out, lse = attn.flash_attention_fwd(q, eye, eye, mask, p, seed)  # out[0, i, h, j] ~ keep[h, i, j]
    ops = attn.flash_bwd_inputs(q, eye, eye, mask, out, lse, eye)
    _, dv = attn.flash_bwd_dkv(ops, p, seed)                         # dv[0, j, h, i] ~ keep[h, i, j]
    e0 = torch.zeros_like(eye)
    e0[..., 0] = 1.0
    ops = attn.flash_bwd_inputs(q, eye, e0, mask, torch.zeros_like(out), lse, e0)
    dq = attn.flash_bwd_dq(ops, p, seed)                             # dq[0, i, h, j] ~ keep[h, i, j]
    torch.cuda.synchronize()
    fwd_ok = torch.equal((out[0] != 0).permute(1, 0, 2).float(), keep)
    dkv_ok = torch.equal((dv[0] != 0).permute(1, 2, 0).float(), keep)
    dq_ok = torch.equal((dq[0] != 0).permute(1, 0, 2).float(), keep)
    emit(check="dropout keep bits against the keep-mask kernel", forward_bit_exact=fwd_ok,
         dkv_bit_exact=dkv_ok, dq_bit_exact=dq_ok, keep_rate=float(keep.mean()))
    return fwd_ok and dkv_ok and dq_ok


def sdpa(q, k, v, mask, p, dout=None):
    keep = mask.bool()[:, None, None, :]
    if dout is None:
        return lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=keep, dropout_p=p)
    leaves = [t.detach().transpose(1, 2).clone().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=keep, dropout_p=p)
    do = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def time_case(B, L, H, Dh, p, reps, dev, card, masked_bag=True, tail=300):
    q, k, v, do = inputs(B, L, L, H, Dh, L, dev)
    mask = torch.ones(B, L, device=dev)
    mask[0, L - tail:] = 0.0
    if B > 1 and masked_bag:
        mask[-1] = 0.0
    seed = 77 if p else None
    out, lse = attn.flash_attention_fwd(q, k, v, mask, p, seed)
    ops = attn.flash_bwd_inputs(q, k, v, mask, out, lse, do)
    pairs = L * int(mask.sum()) * H * Dh          # score elements over real keys x Dh
    f_ms = event_ms(lambda: attn.flash_attention_fwd(q, k, v, mask, p, seed), reps)
    dq_ms = event_ms(lambda: attn.flash_bwd_dq(ops, p, seed), reps)
    dkv_ms = event_ms(lambda: attn.flash_bwd_dkv(ops, p, seed), reps)
    lib_f = event_ms(sdpa(q, k, v, mask, p), reps)
    lib_b = event_ms(sdpa(q, k, v, mask, p, do), reps)
    emit(time=f"B={B} L={L} H={H} Dh={Dh} p={p} bf16, real keys {int(mask.sum())}", card=card,
         fwd_ms=f_ms, fwd_tflops=4 * pairs / f_ms / 1e9, dq_ms=dq_ms,
         dq_tflops=6 * pairs / dq_ms / 1e9, dkv_ms=dkv_ms, dkv_tflops=8 * pairs / dkv_ms / 1e9,
         sdpa_fwd_ms=lib_f, sdpa_bwd_ms=lib_b)


def kernel_times(dev, card, calls=10):
    """Device time of each kernel behind one forward call at the eval shape
    and one backward call (dQ, dK, dV) at the training shape with dropout,
    ours, then the library's, from torch.profiler: what the wrapper's own
    kernels (the q scaling, dvec) and the library's mask handling add to the
    attention kernels themselves."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, _ = inputs(1, 2048, 2048, 8, 48, 2048, dev)
    mask = torch.ones(1, 2048, device=dev)
    mask[0, 2048 - 300:] = 0.0
    qb, kb, vb, dob = inputs(2, 1024, 1024, 8, 48, 1024, dev)
    mb = torch.ones(2, 1024, device=dev)
    mb[0, 1024 - 300:] = 0.0
    mb[1] = 0.0
    outb, lseb = attn.flash_attention_fwd(qb, kb, vb, mb, 0.25, 77)
    fwd_shape, bwd_shape = "B=1 L=2048 H=8 Dh=48 p=0 bf16", "B=2 L=1024 H=8 Dh=48 p=0.25 bf16"
    for name, shape, fn in (
            ("flash_attention_fwd", fwd_shape, lambda: attn.flash_attention_fwd(q, k, v, mask)),
            ("scaled_dot_product_attention", fwd_shape, sdpa(q, k, v, mask, 0.0)),
            ("flash_attention_bwd", bwd_shape,
             lambda: attn.flash_attention_bwd(qb, kb, vb, mb, outb, lseb, dob, 0.25, 77)),
            ("scaled_dot_product_attention backward", bwd_shape,
             sdpa(qb, kb, vb, mb, 0.25, dob))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
            if us and ev.device_type.name == "CUDA":
                rows[ev.key[:90]] = us / calls / 1e3
        emit(kernels_of=name, shape=shape, ms_per_call=rows, card=card)


# --- f32: the CUDA-core kernels of flash_fwd.cu and flash_bwd.cu ----------

_F32 = "flash_bwd.cu"
_FWD = "flash_fwd.cu"
_ROUNDS = "  for (int r = 0; r < 10; ++r) {\n    const uint32_t hi0"
_DQ_STEPS = "const int n_steps = (n_active + NT - 1) / NT;"   # dQ's, and the forward's
_DQ_PRODUCT = "kk < (ks + 1) * KPER; ++kk)"                    # dQ's, and the forward's P~ V
# name: [(file, text, replacement)], each text occurring once in its file;
# wrong results, only timed. The backward's texts hold for this tree and
# its parent alike (the backward kernels are the same).
_BWD_VARIANTS = {
    "no_products": [(_F32, _DQ_PRODUCT, "kk < ks * KPER; ++kk)"),
                    (_F32, "i < (qsp + 1) * QPER; ++i)", "i < qsp * QPER; ++i)")],
    # the fixed cost: tile list, resident tiles, the ordered sums and stores, no step
    "no_steps": [(_F32, _DQ_STEPS, "const int n_steps = 0 * n_active;"),
                 (_F32, "const int n_steps = (Lq + BQ - 1) / BQ;", "const int n_steps = 0 * Lq;")],
}
F32_VARIANTS = {
    "no_exp": [VARIANTS["no_exp"]],
    "no_philox": [("philox.cuh", _ROUNDS, _ROUNDS.replace("r < 10", "r < 0"))],
    "no_products": _BWD_VARIANTS["no_products"] + [(_FWD, _DQ_PRODUCT, "kk < ks * KPER; ++kk)")],
    "no_steps": _BWD_VARIANTS["no_steps"] + [(_FWD, _DQ_STEPS, "const int n_steps = 0 * n_active;")],
    # what the shared-memory loads cost: the forward with P~ V's V rows, or
    # half of the scores' q operands, read from one place a step (the loads
    # leave the loops; every FFMA stays)
    "no_v_loads": [(_FWD, "vr[c] = lds4(tV + kk * P + cg * CW + 4 * c);",
                    "vr[c] = lds4(tV + cg * CW + 4 * c);")],
    "half_q_loads": [(_FWD, "qv[e][1] = lds4(sQt + (d + e) * kRes + 4 * (qg ^ 1));",
                      "qv[e][1] = lds4(sQt + e * kRes + 4 * (qg ^ 1));")],
}
# the same four for the parent tree (an --other-csrc tree): these backward
# kernels and the earlier lane-per-key f32 forward of flash_fwd.cu
F32_PARENT_VARIANTS = {
    "no_exp": [VARIANTS["no_exp"],
               (_FWD, '#include "philox.cuh"\n\nnamespace advmil {',
                '#include "philox.cuh"\n#define expf(x) fminf(fmaxf(fmaf((x), 0.01f, 0.5f), 0.f), 1.f)'
                '\n\nnamespace advmil {')],
    "no_philox": F32_VARIANTS["no_philox"],
    "no_products": _BWD_VARIANTS["no_products"] + [
        (_FWD, "for (int j = 0; j < kBK; ++j) {\n      float vv[NCOL];",
         "for (int j = 0; j < 0; ++j) {\n      float vv[NCOL];")],
    "no_steps": _BWD_VARIANTS["no_steps"] + [
        (_FWD, "for (int k0 = 0; k0 < Lk; k0 += kBK) {", "for (int k0 = 0; k0 < 0 * Lk; k0 += kBK) {")],
}
F32_MUTANTS = {
    # dQ never visits the third listed key tile (keys 128..191 at the main shape)
    "dq_skips_a_real_key_tile": [(_F32, "const bool have = e < n_active;",
                                  "const bool have = e < n_active && e != 2;")],
    # dS loses its - dvec term at one key in sixteen
    "dq_drops_a_term_of_ds_at_one_key_in_16": [
        (_F32, "ds[i] = p * (dpv - dvr[i]);",
         "ds[i] = p * (dpv - (((j & 3) == 0 && (kq & 3) == 0) ? 0.f : dvr[i]));")],
    "dkv_drops_a_term_of_ds_at_one_key_in_16": [
        (_F32, "ds[j] = p * (dpv - dvv);", "ds[j] = p * (dpv - ((j == 0 && (kg & 3) == 0) ? 0.f : dvv));")],
    # one key quad of each tile reads its neighbour's Philox words in dQ
    "dq_takes_a_philox_word_for_the_wrong_key": [
        (_F32, "keep[i][h] = ((n | (n << 4)) >> rot) & 0xFu;",
         "keep[i][h] = ((n | (n << 4)) >> (rot ^ (kq == 5 ? 1 : 0))) & 0xFu;")],
    # the forward never visits the third listed key tile (keys 128..191)
    "fwd_skips_a_real_key_tile": [(_FWD, "const bool have = e < n_active;",
                                   "const bool have = e < n_active && e != 2;")],
    # one split group's partial output is not rescaled with its rows
    "fwd_drops_one_split_groups_rescale": [
        (_FWD, "acc[i][c] *= f4_at(al, i);", "acc[i][c] *= ks == 1 ? 1.f : f4_at(al, i);")],
    # the row sum adds the dropped probabilities (acts at p > 0 only)
    "fwd_l_sums_the_dropped_p": [
        (_FWD, "          sum += p;\n", ""),
        (_FWD, "          s[i][j] = p;\n", "          s[i][j] = p;\n          sum += p;\n")],
    # one key quad of each tile reads its neighbour's Philox words in the forward
    "fwd_takes_a_philox_word_for_the_wrong_key": [
        (_FWD, "keep[i][h] = ((n | (n << 4)) >> rot) & 0xFu;",
         "keep[i][h] = ((n | (n << 4)) >> (rot ^ (kq == 5 ? 1 : 0))) & 0xFu;")],
}
# the sources of the f32 entry points (each calls its bf16 kernels' launchers)
F32_SOURCES = ("flash_fwd.cu", "flash_fwd_mma.cu", "flash_bwd.cu", "flash_dq_mma.cu",
               "flash_dkv_mma.cu")
# (B, Lq, Lk, H, Dh, mask kind): the checks of a right build
F32_CHECKS = [(2, 1024, 1024, 8, 48, "masked"), (2, 1024, 1024, 8, 48, "real"),
              (2, 300, 1024, 4, 48, "holes"), (3, 1000, 200, 2, 32, "holes"),
              (2, 77, 77, 4, 64, "holes"), (2, 200, 200, 1, 128, "holes"),
              (2, 130, 333, 3, 128, "holes"), (3, 130, 130, 2, 16, "holes"),
              (2, 1, 65, 2, 16, "holes"), (1, 4096, 4096, 2, 48, "holes")]
# timed: phase 3's training shape as it is (masked) and with every key real,
# at p = 0.25 and 0; the forward also at phase 3's eval shape, p = 0
F32_SHAPES = [(2, 1024, 1024, 8, 48, "masked"), (2, 1024, 1024, 8, 48, "real")]
F32_FWD_SHAPES = [(1, 2048, 2048, 8, 48, "tail")]
F32_TOL = 1e-4
_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def f32_csrc(base, name, changes):
    """A copy of the source tree `base` under chiprun_out/ with `changes`
    applied; returns its directory."""
    tmp = Path(ROOT) / "chiprun_out" / f"flash_f32_{name}"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.copytree(base, tmp / "csrc")
    for fname, old, new in changes:
        text = (tmp / "csrc" / fname).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to change occurs {text.count(old)} times in {fname}")
        (tmp / "csrc" / fname).write_text(text.replace(old, new))
    return tmp / "csrc"


def f32_libs(trees):
    """Build the f32 flash entry points of each source tree of `trees`
    (name -> csrc directory) from the five sources they need, not the
    package's whole library, every nvcc at once; returns name -> (ctypes
    library, ptxas log, path of the library)."""
    import ctypes
    nvcc = _build._nvcc()
    jobs = {}
    for name, csrc in trees.items():
        out = Path(ROOT) / "chiprun_out" / f"flash_f32_build_{name}"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        jobs[name] = (out, [(out / f"{Path(src).stem}.o", subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(out / f"{Path(src).stem}.o"),
             str(Path(csrc) / src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in F32_SOURCES])
    libs = {}
    for name, (out, procs) in jobs.items():
        logs = []
        for obj, proc in procs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                raise SystemExit(f"{name}: nvcc failed\n{logs[-1]}")
        so = out / "libflash_f32.so"
        subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o", str(so),
                        *(str(o) for o, _ in procs)], check=True)
        lib = ctypes.CDLL(str(so))
        for fn in ("advmil_flash_fwd", "advmil_flash_bwd_dq", "advmil_flash_bwd_dkv"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, "\n".join(logs), str(so))
    return libs


def sass_loop_counts(so_path, name_has):
    """For each kernel of the library whose name holds every string of
    `name_has`: each loop of `cuobjdump -sass` (a backward branch's range)
    that holds an FFMA, with its counts of instructions, FFMA, LDS, LDS.64,
    LDS.128 and MUFU, none of them counting the loops nested in it again."""
    tool = osp.join(osp.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        if not all(x in name for x in name_has):
            continue
        insns = [(int(a, 16), op) for a, op, _ in _SASS_INSN.findall(body)]
        spans = set()
        for a, op, rest in _SASS_INSN.findall(body):
            m = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and m and int(m.group(1), 16) < int(a, 16):
                spans.add((int(m.group(1), 16), int(a, 16)))
        loops = []
        for lo, hi in sorted(spans):
            inner = [(l2, h2) for l2, h2 in spans if lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)]
            c = {"FFMA": 0, "LDS": 0, "LDS.64": 0, "LDS.128": 0, "MUFU": 0}
            for addr, op in insns:
                if lo <= addr <= hi and not any(l2 <= addr <= h2 for l2, h2 in inner):
                    base = op.split(".")[0]
                    if base in ("FFMA", "MUFU"):
                        c[base] += 1
                    elif base == "LDS":
                        c["LDS" + (".128" if ".128" in op else ".64" if ".64" in op else "")] += 1
            lds = c["LDS"] + c["LDS.64"] + c["LDS.128"]
            if c["FFMA"]:
                own = sum(lo <= a <= hi and not any(l2 <= a <= h2 for l2, h2 in inner)
                          for a, _ in insns)
                loops.append(dict(c, instructions=own,
                                  ffma_per_shared_load=round(c["FFMA"] / max(lds, 1), 2)))
        out[name] = loops
    return out


def f32_inputs(B, Lq, Lk, H, Dh, kind, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(B, Lq, H, Dh, device=dev, generator=g) for _ in range(2))
    k, v = (torch.randn(B, Lk, H, Dh, device=dev, generator=g) for _ in range(2))
    mask = torch.ones(B, Lk, device=dev)
    if kind == "masked":              # chip_smoke.py phase 3
        mask[0, Lk - 300:] = 0.0
        mask[1] = 0.0
    elif kind == "tail":              # chip_smoke.py phase 3's eval bag
        mask[0, Lk - 300:] = 0.0
    elif kind == "holes":             # a masked tile inside bag 0, a ragged tail, a masked bag
        if Lk >= 200:
            mask[0, 64:128] = 0.0
            mask[0, 185:197] = 0.0
        mask[0, Lk - 7:] = 0.0
        if B > 1:
            mask[-1] = 0.0
    return q, k, v, do, mask


def f32_lse(q, k, mask):
    """The forward's lse [B*H, Lq] from the plain logits (a fully masked row:
    -1e30, which the kernels never exponentiate)."""
    B, Lq, H, Dh = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(Dh), k)
    logits = logits.masked_fill(mask[:, None, None, :] <= 0, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    return torch.where(torch.isfinite(lse), lse, torch.full_like(lse, -1e30)).reshape(B * H, Lq)


def f32_call(lib, which, ops, p, seed, outs):
    """One launch of `lib`'s forward ("fwd": outs = out, lse; qs as the
    wrapper scales q), dQ or dK/dV on the backward's operands `ops`."""
    ptrs, sizes = attn._bwd_args(ops)
    if which == "fwd":
        ptrs = tuple(ops[n].data_ptr() for n in ("qs", "k", "v", "mask"))
    fn = {"fwd": lib.advmil_flash_fwd, "dq": lib.advmil_flash_bwd_dq,
          "dkv": lib.advmil_flash_bwd_dkv}[which]
    rc = fn(*ptrs, *(o.data_ptr() for o in outs), *sizes, *attn._dropout_args(p, seed),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{which}: CUDA error {rc}")
    return outs


def f32_operands(B, Lq, Lk, H, Dh, kind, p, dev):
    q, k, v, do, mask = f32_inputs(B, Lq, Lk, H, Dh, kind, dev, Lq + Lk + Dh)
    seed = 0x1234_5678_9ABC_DEF0 if p else None
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attn.masked_attention_reference(*leaves, mask, p, seed)
    want = torch.autograd.grad(out, leaves, do)
    ops = attn.flash_bwd_inputs(q, k, v, mask, out.detach(), f32_lse(q, k, mask), do)
    return ops, mask, seed, want, out


def f32_check(name, lib, case, p, dev):
    """One build on one case, forward and backward: (ok, largest share of the
    f32 bound)."""
    B, Lq, Lk, H, Dh, kind = case
    ops, mask, seed, want, out = f32_operands(B, Lq, Lk, H, Dh, kind, p, dev)
    new = lambda: (torch.empty(B, Lq, H, Dh, device=dev), torch.empty(B, Lk, H, Dh, device=dev),  # noqa: E731
                   torch.empty(B, Lk, H, Dh, device=dev), torch.empty(B, Lq, H, Dh, device=dev),
                   torch.empty(B * H, Lq, device=dev))
    a, b = new(), new()
    for outs in (a, b):
        f32_call(lib, "fwd", ops, p, seed, outs[3:])
        f32_call(lib, "dq", ops, p, seed, outs[:1])
        f32_call(lib, "dkv", ops, p, seed, outs[1:3])
    torch.cuda.synchronize()
    got = (a[0] / math.sqrt(Dh), a[1], a[2], a[3], a[4])
    want = tuple(want) + (out.detach(), ops["lse"])
    shares, ok = {}, all(torch.equal(x, y) for x, y in zip(a, b))
    bit_for_bit = ok
    masked_bag = B > 1 and kind not in ("real", "tail")
    if masked_bag:                    # its lse: -1e30 + log(1e-30)
        ok = ok and bool((a[4][-H:] < -9e29).all())
    for tag, x, y in zip(("dq", "dk", "dv", "out", "lse"), got, want):
        shares[tag] = float(((x - y).abs() / (F32_TOL + F32_TOL * y.abs())).max())
        ok = ok and bool(torch.isfinite(x).all()) and shares[tag] <= 1.0
        if masked_bag and tag != "lse":
            ok = ok and bool((x[-1] == 0).all())
    for x in got[1:3]:                # a masked key gets no gradient
        ok = ok and bool((x.permute(0, 2, 3, 1)[(mask == 0)[:, None, None, :].expand(
            B, H, Dh, Lk)] == 0).all())
    emit(check=f"f32 {name}: B={B} Lq={Lq} Lk={Lk} H={H} Dh={Dh} {kind} p={p}", ok=ok,
         two_calls_bit_for_bit=bit_for_bit, share_of_f32_bound=shares)
    return ok, max(shares.values())


def f32_keep_bits(name, lib, dev):
    """Against the torch Philox (which chip_smoke.py holds to the keep-mask
    kernel bit for bit): q = 0 gives uniform probabilities (lse = log L).
    With v = I, out[i, j] is non-zero exactly where (i, j) was kept; with
    dO = I, dV[j, i] is; with k = I, out = 0 (dvec 0) and v = dO = e_0,
    dQ[i, j] is."""
    BH, L, Dh, p, seed = 6, 128, 128, 0.4, (1 << 63) + 99
    q = torch.zeros(1, L, BH, Dh, device=dev)
    eye = torch.eye(L, device=dev)[None, :, None, :].expand(1, L, BH, Dh).contiguous()
    e0 = torch.zeros_like(eye)
    e0[..., 0] = 1.0
    mask = torch.ones(1, L, device=dev)
    keep = philox.keep_mask_plain(seed, BH, L, L, p, device=dev)    # [BH, Lq, Lk]
    lse = torch.full((BH, L), math.log(L), device=dev)
    out = attn.masked_attention_reference(q, eye, eye, mask, p, seed)
    fwd, fwd_lse = torch.empty_like(eye), torch.empty(BH, L, device=dev)
    f32_call(lib, "fwd", attn.flash_bwd_inputs(q, eye, eye, mask, out, lse, eye), p, seed,
             (fwd, fwd_lse))
    dk, dv = torch.empty_like(eye), torch.empty_like(eye)
    f32_call(lib, "dkv", attn.flash_bwd_inputs(q, eye, eye, mask, out, lse, eye), p, seed, (dk, dv))
    dq = torch.empty_like(eye)
    f32_call(lib, "dq", attn.flash_bwd_inputs(q, eye, e0, mask, torch.zeros_like(q), lse, e0),
             p, seed, (dq,))
    torch.cuda.synchronize()
    fwd_ok = torch.equal((fwd[0] != 0).permute(1, 0, 2).float(), keep)
    dkv_ok = torch.equal((dv[0] != 0).permute(1, 2, 0).float(), keep)
    dq_ok = torch.equal((dq[0] != 0).permute(1, 0, 2).float(), keep)
    emit(check=f"f32 {name}: dropout keep bits against the torch Philox",
         forward_bit_exact=fwd_ok, dkv_bit_exact=dkv_ok, dq_bit_exact=dq_ok)
    return fwd_ok and dkv_ok and dq_ok


def f32_times(libs, reps, dev, card):
    """The forward, dQ and dK/dV of every build in turns, beside SDPA's
    forward and backward (TF32 off); at F32_FWD_SHAPES the forward alone."""
    runs = [(case, p, True) for case in F32_SHAPES for p in (0.25, 0.0)]
    runs += [(case, 0.0, False) for case in F32_FWD_SHAPES]
    for case, p, bwd in runs:
        B, Lq, Lk, H, Dh, kind = case
        ops, mask, seed, _, _ = f32_operands(B, Lq, Lk, H, Dh, kind, p, dev)
        q = ops["qs"] * math.sqrt(Dh)
        out, lse = torch.empty(B, Lq, H, Dh, device=dev), torch.empty(B * H, Lq, device=dev)
        dq = torch.empty(B, Lq, H, Dh, device=dev)
        dk, dv = torch.empty(B, Lk, H, Dh, device=dev), torch.empty(B, Lk, H, Dh, device=dev)
        arms = {}
        for name, (lib, _, _) in libs.items():
            arms[f"{name}_fwd"] = lambda lib=lib: f32_call(lib, "fwd", ops, p, seed, (out, lse))
            if bwd:
                arms[f"{name}_dq"] = lambda lib=lib: f32_call(lib, "dq", ops, p, seed, (dq,))
                arms[f"{name}_dkv"] = lambda lib=lib: f32_call(lib, "dkv", ops, p, seed, (dk, dv))
        arms["sdpa_fwd"] = sdpa(q, ops["k"], ops["v"], mask, p)
        if bwd:
            arms["sdpa_bwd"] = sdpa(q, ops["k"], ops["v"], mask, p, ops["do"])
        for fn in arms.values():
            fn()
        torch.cuda.synchronize()
        order = list(arms) + list(arms)[::-1]
        times = {n: [] for n in arms}
        for n in order:
            times[n].append(event_ms(arms[n], reps))
        med = {n: statistics.median(v) for n, v in times.items()}
        pairs = Lq * int(mask.sum()) * H * Dh
        nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
        io_f = nb(q, ops["k"], ops["v"], mask, out, lse)
        io = nb(q, ops["k"], ops["v"], ops["do"], mask, ops["lse"]) + 4 * q.numel()  # + out
        bounds = {"fwd": max(io_f / 3.35e12, 4 * pairs / 67e12) * 1e3,
                  "dq": max((io + nb(dq)) / 3.35e12, 6 * pairs / 67e12) * 1e3,
                  "dkv": max((io + nb(dk, dv)) / 3.35e12, 8 * pairs / 67e12) * 1e3}
        rec = {f"{n}_ms": v for n, v in med.items()}
        for name in libs:
            for w in ("fwd", "dq", "dkv") if bwd else ("fwd",):
                rec[f"{name}_{w}_share_of_bound"] = bounds[w] / med[f"{name}_{w}"]
            rec[f"{name}_fwd_over_sdpa"] = med[f"{name}_fwd"] / med["sdpa_fwd"]
            if bwd:
                rec[f"{name}_dq_plus_dkv_over_sdpa"] = (med[f"{name}_dq"] + med[f"{name}_dkv"]) \
                    / med["sdpa_bwd"]
        emit(time=f"f32 B={B} L={Lq} H={H} Dh={Dh} p={p} {kind}, real keys {int(mask.sum())}",
             card=card, bound_fwd_ms=bounds["fwd"],
             **({"bound_dq_ms": bounds["dq"], "bound_dkv_ms": bounds["dkv"]} if bwd else {}),
             spread_ms={n: [min(v), max(v)] for n, v in times.items()}, **rec)


def run_f32(args, dev, card):
    trees = {} if args.only_other else {"kernel": str(CSRC)}
    if args.mutants:
        trees = {n: str(f32_csrc(CSRC, n, ch)) for n, ch in F32_MUTANTS.items()}
    else:
        if args.other_csrc:
            trees["other"] = args.other_csrc
        for n in filter(None, (args.variants or "").split(",")):
            trees[n] = str(f32_csrc(CSRC, n, F32_VARIANTS[n]))
        for n in filter(None, (args.other_variants or "").split(",")):
            trees[f"other_{n}"] = str(f32_csrc(args.other_csrc, f"other_{n}",
                                               F32_PARENT_VARIANTS[n]))
    libs = f32_libs(trees)
    emit(card=card, torch=torch.__version__, cuda=torch.version.cuda, builds=list(libs))
    for name, (_, log, so) in libs.items():
        for needle in ("flash_fwd", "flash_bwd_d"):
            for kname, used, spill in ptxas_lines(log, needle):
                if "f32_kernel" in kname or "IfLi" in kname:
                    emit(build=name, ptxas=kname, used=used, spill=spill)
            for kname, loops in sass_loop_counts(so, (needle, "Li48E")).items():
                if "mma" not in kname:
                    emit(build=name, sass=kname, loops=loops)
    ok = True
    if args.mutants:
        for name, (lib, _, _) in libs.items():
            caught = []
            for p in (0.0, 0.25):
                good, share = f32_check(name, lib, F32_CHECKS[0], p, dev)
                caught.append(not good)
            emit(mutant=name, change=[c[2] for c in F32_MUTANTS[name]],
                 caught_at_p=dict(zip(("0", "0.25"), caught)))
            ok = ok and any(caught)
        if not ok:
            raise SystemExit("an f32 mutant passed the f32 bound")
        return ok
    wrong = lambda n: n not in ("kernel", "other")  # noqa: E731  variants: only timed
    for name, (lib, _, _) in libs.items():
        if wrong(name):
            continue
        for case in F32_CHECKS:
            for p in (0.0, 0.25):
                ok = f32_check(name, lib, case, p, dev)[0] and ok
        ok = f32_keep_bits(name, lib, dev) and ok
    emit(all_f32_checks_ok=ok)
    if not args.no_time:
        f32_times(libs, args.reps, dev, card)
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-time", action="store_true", help="build and check only")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variant", choices=sorted(VARIANTS),
                    help="time a build of the bf16 kernels without their exponentials (a "
                         "clamped FMA instead) or without their mma.sync products (wrong "
                         "results: the checks are skipped), with 8-warp forward and dQ "
                         "blocks always (wide) or never (narrow), or with dQ's 8-warp blocks "
                         "one to an SM")
    ap.add_argument("--mutants", action="store_true",
                    help="build each fault of MUTANTS (F32_MUTANTS with --f32) and report "
                         "which bound catches it")
    ap.add_argument("--f32", action="store_true",
                    help="the f32 kernels of flash_fwd.cu and flash_bwd.cu: ptxas, SASS loop "
                         "counts, checks against the f32 bound, times beside SDPA's forward and "
                         "backward")
    ap.add_argument("--other-csrc", help="with --f32: another source tree timed in the same turns")
    ap.add_argument("--only-other", action="store_true",
                    help="with --f32: leave the package's own build out")
    ap.add_argument("--variants", help="with --f32: builds of F32_VARIANTS, comma-separated")
    ap.add_argument("--other-variants",
                    help="with --f32: builds of the --other-csrc tree with F32_PARENT_VARIANTS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(osp.join(ROOT, "chiprun_out"), exist_ok=True)
    if args.f32:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        try:
            ok = run_f32(args, dev, card)
        finally:
            name = f"profile_torch_flash_f32{'_mutants' if args.mutants else ''}.jsonl"
            with open(osp.join(ROOT, "chiprun_out", name), "w") as f:
                for rec in OUT:
                    f.write(json.dumps(rec) + "\n")
            for tmp in Path(ROOT, "chiprun_out").glob("flash_f32_*"):
                shutil.rmtree(tmp, ignore_errors=True)
        if not ok:
            raise SystemExit("an f32 flash kernel check failed")
        return
    if args.mutants:
        caught = run_mutants(dev)
        with open(osp.join(ROOT, "chiprun_out", "profile_torch_flash_mutants.jsonl"), "w") as f:
            for rec in OUT:
                f.write(json.dumps(rec) + "\n")
        if not caught:
            raise SystemExit("a mutant passed rounded_tol")
        return
    wrong = args.variant in ("no_exp", "no_mma")
    tmp = build_changed(args.variant, VARIANTS[args.variant]) if args.variant else None
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.load()
    emit(card=card, torch=torch.__version__, cuda=torch.version.cuda, variant=args.variant,
         build_seconds=_build.build_info["seconds"])
    for name, used, spill in ptxas_lines(_build.build_info.get("log", ""), "flash"):
        if "Li48E" in name or "spill" in spill and " 0 bytes spill stores" not in spill:
            emit(ptxas=name, used=used, spill=spill)

    ok = True
    cases = [] if wrong else [(2, 1024, 1024, 8, 48, "ragged"), (2, 2048, 2048, 8, 48, "interior"),
             (3, 130, 130, 2, 16, "ragged"), (2, 77, 77, 4, 64, "ragged"),
             (2, 200, 200, 1, 128, "ragged"), (2, 300, 200, 2, 32, "holes"),
             (2, 100, 333, 3, 48, "holes"), (1, 64, 4096, 2, 48, "interior"),
             (1, 4096, 4096, 8, 48, "ragged"),
             (2, 1, 65, 2, 48, "ragged")]
    if not wrong:
        ok = check_keep_bits(dev)
    for case in cases:
        for p in (0.0, 0.25):
            ok = all(check_case(*case, p, dev)) and ok
    if not wrong:
        emit(all_checks_ok=ok)

    if not args.no_time:
        for B, L, p in ((1, 2048, 0.0), (2, 1024, 0.25), (2, 1024, 0.0), (1, 4096, 0.0),
                        (1, 4096, 0.25)):
            time_case(B, L, 8, 48, p, args.reps, dev, card)
        time_case(4, 2048, 8, 48, 0.0, args.reps, dev, card, masked_bag=False, tail=1)
        time_case(4, 2048, 8, 48, 0.25, args.reps, dev, card, masked_bag=False, tail=1)
        kernel_times(dev, card)
    if tmp is not None:
        shutil.rmtree(tmp, ignore_errors=True)
    name = f"profile_torch_flash{'_' + args.variant if args.variant else ''}.jsonl"
    with open(osp.join(ROOT, "chiprun_out", name), "w") as f:
        for rec in OUT:
            f.write(json.dumps(rec) + "\n")
    if not ok:
        raise SystemExit("a flash kernel check failed")


if __name__ == "__main__":
    main()
