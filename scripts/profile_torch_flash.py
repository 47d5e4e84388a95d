#!/usr/bin/env python3
"""Check and time the flash attention kernels of advmil_tpu_torch on one GPU.

    python3 scripts/profile_torch_flash.py [--no-time] [--reps 20]
    python3 scripts/profile_torch_flash.py --variant no_exp|no_mma|wide|narrow
    python3 scripts/profile_torch_flash.py --mutants

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
"""
import argparse
import json
import os
import os.path as osp
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
                    help="build each fault of MUTANTS and report which bound catches it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(osp.join(ROOT, "chiprun_out"), exist_ok=True)
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
