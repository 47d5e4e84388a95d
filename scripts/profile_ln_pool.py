#!/usr/bin/env python3
"""Device time of the LN-pool backward (#2, `ln_relu_region_mean_bwd`) and of
its POOL = false instantiation (#4, `ln_relu_bwd`; both `csrc/ln_pool.cu`) at
phase 3's shapes, against other builds of the same source in the same turns,
on one CUDA GPU.

    python3 scripts/profile_ln_pool.py [--other-csrc DIR] [--variants a,b]
                                       [--other-variants a,b] [--only-other]
                                       [--f32] [--reps 20]
    python3 scripts/profile_ln_pool.py --mutants

Inputs are `chip_smoke.py` phase 3's: h [32,768, D] (D = 384, G's
embedding, and 128, D's), scale ~ 1 + 0.1 N, bias ~ 0.1 N, g [2,048, D], all
from N(0, 1) and cast to bf16 (and f32 with `--f32`); g is zeroed for the
regions with a ReLU input within 2e-5 of 0, where a rounding may flip the
ReLU mask. Each build is `ln_pool.cu` alone, compiled by nvcc into a library
of its own under `chiprun_out/ln_pool_builds/` (all builds at once; ptxas
registers, shared memory and spills printed), and called through its C
entry points. A build whose entry point takes g in f32 only (the kernels
before their redesign) is timed with the wrapper's cast of g inside the
call, as the op ran it, and also without (`..._nocast`).

First every build that computes the right function is checked: dh against
the plain version's autograd dh (f32 within 1e-5; bf16 within the plain
bound, 2e-2 + 2e-2 relative, and within `ln_pool.bwd_tol`), dscale / dbias
within 1e-3 + 1e-4 relative, two calls bit for bit. Then each build's call
is timed in turns (a, b, c, c, b, a; CUDA events behind a spin kernel,
medians of 2 x `--reps` calls), #4 at M = 32,768, D = 768 and 384 beside it,
and one more round under torch.profiler splits each call into its launches:
the cast, the main kernel and the tail that sums the block partials.

`--other-csrc DIR`: another source tree (e.g. the parent commit's
`advmil_tpu_torch/csrc`, unpacked with `git archive` into a git-ignored
directory) built and timed beside the package's; `--only-other` leaves the
package's out. `--variants`: builds of the package's `ln_pool.cu` with one
textual change each (`VARIANTS`); `--other-variants`: the same for the other
tree (`PARENT_VARIANTS`, written for the kernels before their redesign). A
variant marked `wrong` computes something else and is only timed.

`--mutants`: three faulty builds of the package's `ln_pool.cu` (`MUTANTS`:
the m2 term dropped at one column in 16, the last row of each region
skipped, one block's partial left out of dscale), checked in bf16 at M =
32,768, D = 384 with dh filled with NaN first; fails unless `bwd_tol` (or,
for dscale, the 1e-3 + 1e-4 bound) catches every one, and records whether
the plain 2e-2 bound does.

JSON lines go to stdout and to `chiprun_out/profile_ln_pool.jsonl`.
"""
import argparse
import ctypes
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
OUT_DIR = osp.join(ROOT, "chiprun_out")
BUILD_ROOT = osp.join(OUT_DIR, "ln_pool_builds")
M = 32768

OUT = []

# ---------------------------------------------------------------------------
# textual changes of ln_pool.cu: name -> ([(old, new), ...], wrong)
# ---------------------------------------------------------------------------

_P_SHUFFLES = [("      const float mu = warp_sum(s) * inv_d;", "      const float mu = s * inv_d;"),
               ("      const float inv = rsqrtf(warp_sum(q) * inv_d + eps);",
                "      const float inv = rsqrtf(q * inv_d + eps);"),
               ("      m1 = warp_sum(m1) * inv_d;\n      m2 = warp_sum(m2) * inv_d;",
                "      m1 *= inv_d;\n      m2 *= inv_d;")]
_SHUFFLES = [("s += x[e];\n    const float mu = warp_sum(s) * inv_d;",
              "s += x[e];\n    const float mu = s * inv_d;"),
             ("const float d = e / V < nch ? x[e] - mu : 0.f;\n      q += d * d;\n    }\n"
              "    const float inv = rsqrtf(warp_sum(q) * inv_d + eps);",
              "const float d = e / V < nch ? x[e] - mu : 0.f;\n      q += d * d;\n    }\n"
              "    const float inv = rsqrtf(q * inv_d + eps);"),
             ("    m1 = warp_sum(m1) * inv_d;\n    m2 = warp_sum(m2) * inv_d;",
              "    m1 *= inv_d;\n    m2 *= inv_d;")]
PARENT_VARIANTS = {
    # the tail that sums the block partials is not launched
    "no_tail": ([("  sum_partials_kernel<<<(D + 255) / 256, 256, 0, stream>>>(",
                  "  if (nblocks < 0) sum_partials_kernel<<<(D + 255) / 256, 256, 0, stream>>>(")],
                True),
    # the four warp reductions of each row replaced by the lane's own sums
    "no_shuffles": (_P_SHUFFLES, True),
    # everything but the stores of dh
    "no_store": ([("        if (j < nc) drow[lane + 32 * j] =",
                   "        if (j < nc && inv == 1.2345e-30f) drow[lane + 32 * j] =")], True),
}
_STORE = "      store_v<V>(drow + col(j), o);"
VARIANTS = {
    "no_tail": ([("  return cudaLaunchKernelEx(&cfg, sum_partials_kernel,",
                  "  if (nblocks > 0) return cudaSuccess;\n"
                  "  return cudaLaunchKernelEx(&cfg, sum_partials_kernel,")], True),
    # the tail launched after the main kernel ends, not as a programmatic dependent launch
    "no_pdl": ([("attr[0].val.programmaticStreamSerializationAllowed = 1;",
                 "attr[0].val.programmaticStreamSerializationAllowed = 0;")], False),
    # registers capped for 3 blocks an SM (85), not 2
    "min_blocks3": ([("static constexpr int kMinBlocks = kKeep ? 2 : 1;",
                      "static constexpr int kMinBlocks = kKeep ? 3 : 1;")], False),
    # 2 rows of a warp's share staged ahead, not 4
    "stages2": ([("static constexpr int kStages = kKeep ? 4 : 2;",
                  "static constexpr int kStages = 2;")], False),
    # scale, bias and gx not kept in registers: read from shared memory / recomputed
    "no_keep": ([("static constexpr bool kKeep = E <= 12;",
                  "static constexpr bool kKeep = false;")], False),
    "no_shuffles": (_SHUFFLES, True),
    "no_store": ([(_STORE, "      if (o[0] == 1.2345e-30f) store_v<V>(drow + col(j), o);")], True),
}
MUTANTS = {
    "the m2 term dropped at one column in 16": [
        ("o[k2] = inv * (gxe - m1 - x[e] * m2);",
         "o[k2] = inv * (gxe - m1 - (((col(j) + k2) & 15) == 0 ? 0.f : x[e] * m2));")],
    "the last row of each region skipped": [
        ("    float s = 0.f;\n#pragma unroll\n    for (int e = 0; e < E; ++e) s += x[e];",
         "    if (r % kRegion == kRegion - 1) continue;\n    float s = 0.f;\n#pragma unroll\n"
         "    for (int e = 0; e < E; ++e) s += x[e];")],
    "one block's partial left out of dscale": [
        ("      part[static_cast<size_t>(blockIdx.x) * D + c] = a;",
         "      part[static_cast<size_t>(blockIdx.x) * D + c] = (which == 0 && blockIdx.x == 1) "
         "? 0.f : a;")],
}

# ---------------------------------------------------------------------------


def emit(**rec):
    print(json.dumps(rec), flush=True)
    OUT.append(rec)


def patched_tree(name, csrc, changes):
    """A copy of `csrc` under the build root in which each `old` of
    `changes` (in ln_pool.cu) reads `new`; each `old` must occur once."""
    tmp = Path(BUILD_ROOT) / f"src_{name}"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.copytree(csrc, tmp)
    text = (tmp / "ln_pool.cu").read_text()
    for old, new in changes:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to change occurs {text.count(old)} times")
        text = text.replace(old, new)
    (tmp / "ln_pool.cu").write_text(text)
    return tmp


def build_all(trees):
    """{name: csrc dir} -> {name: (ctypes lib, g_any)}: ln_pool.cu of each
    tree compiled alone, every nvcc started at once. g_any: the backward's
    entry point takes g in its storage dtype (a g_dtype argument)."""
    from advmil_tpu_torch.ops import _build
    nvcc = _build._nvcc()
    jobs = {}
    for name, csrc in trees.items():
        so = Path(BUILD_ROOT) / f"lib_{name}.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(Path(csrc) / "ln_pool.cu")]
        jobs[name] = (so, csrc, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    libs = {}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (so, csrc, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        g_any = "int g_dtype" in (Path(csrc) / "ln_pool.cu").read_text()
        lib = ctypes.CDLL(str(so))
        lib.advmil_ln_relu_region_mean_bwd.argtypes = \
            [P] * 8 + [I] * (4 if g_any else 3) + [F, P]
        lib.advmil_ln_relu_bwd.argtypes = [P] * 8 + [I, I, I, F, P]
        lib.advmil_ln_pool_bwd_blocks.argtypes = [I]
        for fn in (lib.advmil_ln_relu_region_mean_bwd, lib.advmil_ln_relu_bwd,
                   lib.advmil_ln_pool_bwd_blocks):
            fn.restype = I
        libs[name] = (lib, g_any)
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and ("bwd" in ln or "partials" in ln):
                emit(build=name, ptxas=ln.split("'")[1],
                     used=" ".join(x.strip() for x in lines[i + 1:i + 4]
                                   if "Used" in x or "spill" in x or "stack" in x))
        warn = sorted({ln.strip() for ln in lines if "arning" in ln})
        if warn:
            emit(build=name, ptxas_warnings=warn)
    return libs


def bwd_of(entry, g, h, scale, bias, pool=True, cast=True, fill_nan=False):
    """(dh, dscale, dbias) from a build's backward (#2, or #4 with pool
    False). A build that takes g in f32 only gets g cast here, with `cast`
    (as its wrapper did), else g must be f32 already."""
    import torch
    from advmil_tpu_torch.ops import _build
    lib, g_any = entry
    Mr, D = h.shape
    dh = torch.full_like(h, float("nan")) if fill_nan else torch.empty_like(h)
    dsc = torch.empty(D, dtype=torch.float32, device=h.device)
    dbi = torch.empty(D, dtype=torch.float32, device=h.device)
    part = torch.empty((2, lib.advmil_ln_pool_bwd_blocks(Mr), D), dtype=torch.float32,
                       device=h.device)
    common = [g.data_ptr(), h.data_ptr(), scale.data_ptr(), bias.data_ptr(), dh.data_ptr(),
              dsc.data_ptr(), dbi.data_ptr(), part.data_ptr(), Mr, D,
              _build.DTYPE_CODES[h.dtype]]
    if not pool:
        rc = lib.advmil_ln_relu_bwd(*common, 1e-6, _build.stream_of(h))
    elif g_any:
        rc = lib.advmil_ln_relu_region_mean_bwd(*common, _build.DTYPE_CODES[g.dtype], 1e-6,
                                                _build.stream_of(h))
    else:
        if g.dtype != torch.float32:
            if not cast:
                raise ValueError("this build takes g in f32")
            g = g.float()
            common[0] = g.data_ptr()
        rc = lib.advmil_ln_relu_region_mean_bwd(*common, 1e-6, _build.stream_of(h))
    if rc != 0:
        raise RuntimeError(f"ln_pool backward: CUDA error {rc}")
    return dh, dsc, dbi


def inputs(dev, D, dtype, pool=True):
    import torch

    import chip_smoke
    g = torch.Generator(device=dev).manual_seed(D)
    h = torch.randn(M, D, device=dev, generator=g)
    scale = 1.0 + 0.1 * torch.randn(D, device=dev, generator=g)
    bias = 0.1 * torch.randn(D, device=dev, generator=g)
    rows = M // 16 if pool else M
    gout = torch.randn(rows, D, device=dev, generator=g)
    h = h.to(dtype)
    gout = chip_smoke.away_from_relu_edge(chip_smoke.pre_relu(h.float(), scale, bias), gout,
                                          M // rows).to(dtype)
    return gout, h, scale, bias


def reference(gout, h, scale, bias):
    import torch
    from advmil_tpu_torch.ops import ln_pool
    leaves = [t.detach().clone().requires_grad_(True) for t in (h, scale, bias)]
    return torch.autograd.grad(ln_pool.ln_relu_region_mean_plain(*leaves), leaves, gout)


def check(name, entry, args, ref):
    """Shares of the plain and the tight bound (bf16) or of 1e-5 (f32) for
    dh, of 1e-3 + 1e-4 relative for dscale / dbias; two calls bit for bit."""
    import torch

    import chip_smoke
    from advmil_tpu_torch.ops import ln_pool
    got = bwd_of(entry, *args, fill_nan=True)
    again = bwd_of(entry, *args)
    torch.cuda.synchronize()
    share = chip_smoke.share_of
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    f32 = args[1].dtype == torch.float32
    plain = share(got[0], ref[0], 1e-5, 0.0) if f32 else share(got[0], ref[0], 2e-2, 2e-2)
    tight = None if f32 else share(got[0], ref[0], **ln_pool.bwd_tol(ref[0]))
    sums = max(share(a, b, 1e-3, 1e-4) for a, b in zip(got[1:], ref[1:]))
    rec = dict(check=f"{name} M={M} D={args[1].shape[1]} {str(args[1].dtype)[6:]}",
               share_of_plain=plain, share_of_tight=tight, share_of_sums_bound=sums,
               bit_for_bit=same,
               ok=same and plain <= 1 and sums <= 1 and (tight is None or tight <= 1))
    emit(**rec)
    return rec


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


def turns(arms, reps):
    order = list(arms) + list(arms)[::-1]
    times = {n: [] for n in arms}
    for n in order:
        times[n] += event_ms(arms[n], reps)
    return {n: statistics.median(v) for n, v in times.items()}


def launches_apart(arms, reps):
    """Device ms per call of each arm, by launch (torch.profiler): the cast
    of g, the main kernel, the tail and any other."""
    import chip_smoke
    out = {}
    for n, fn in arms.items():
        parts = {"cast": 0.0, "main": 0.0, "tail": 0.0, "other": 0.0}
        for key, ms in chip_smoke.device_ms_by_kernel(fn, reps).items():
            part = ("tail" if "partials" in key else "main" if "ln_relu" in key else
                    "cast" if "copy" in key else "other")
            parts[part] += ms
        out[n] = parts
    return out


def run(args, card, dev):
    import torch
    from advmil_tpu_torch.ops import _build
    pkg = _build.CSRC
    trees = {} if args.only_other else {"kernel": pkg}
    if args.other_csrc:
        trees["other_csrc"] = args.other_csrc
    wrong = set()
    for name in filter(None, (args.variants or "").split(",")):
        changes, bad = VARIANTS[name]
        trees[name] = patched_tree(name, pkg, changes)
        wrong |= {name} if bad else set()
    for name in filter(None, (args.other_variants or "").split(",")):
        changes, bad = PARENT_VARIANTS[name]
        trees[f"other_{name}"] = patched_tree(f"other_{name}", args.other_csrc or pkg, changes)
        wrong |= {f"other_{name}"} if bad else set()
    libs = build_all(trees)
    ok = True
    for dtype in ((torch.bfloat16, torch.float32) if args.f32 else (torch.bfloat16,)):
        for D in (384, 128):
            a = inputs(dev, D, dtype)
            ref = reference(*a)
            for name, entry in libs.items():
                if name not in wrong:
                    ok = check(name, entry, a, ref)["ok"] and ok
            del ref
            g32 = a[0].float()
            arms = {}
            for n, e in libs.items():
                arms[n] = lambda e=e: bwd_of(e, *a)
                if not e[1] and dtype != torch.float32:
                    arms[f"{n}_nocast"] = lambda e=e: bwd_of(e, g32, *a[1:])
            med = turns(arms, args.reps)
            apart = launches_apart(arms, args.reps)
            g_bytes = a[0].numel() * a[0].element_size()
            hd = a[1].numel() * a[1].element_size()
            for n in arms:
                emit(time=f"{n} #2 M={M} D={D} {str(dtype)[6:]}", card=card, ms=med[n],
                     launches_ms=apart[n], bound_ms=(2 * hd + g_bytes + 16 * D) / 3.35e9,
                     bound_f32_g_ms=(2 * hd + 4 * a[0].numel() + 16 * D) / 3.35e9)
            del a, g32, arms
        for D in (768, 384):   # #4, ln_relu's backward (POOL = false)
            a = inputs(dev, D, dtype, pool=False)
            arms = {n: (lambda e=e: bwd_of(e, *a, pool=False)) for n, e in libs.items()}
            med = turns(arms, args.reps)
            hd = a[1].numel() * a[1].element_size()
            for n in arms:
                emit(time=f"{n} #4 M={M} D={D} {str(dtype)[6:]}", card=card, ms=med[n],
                     bound_ms=(3 * hd + 16 * D) / 3.35e9)
            del a, arms
    if not ok:
        raise SystemExit("a check failed")


def run_mutants(dev):
    import torch
    from advmil_tpu_torch.ops import _build
    trees = {f"mutant{i}": patched_tree(f"mutant{i}", _build.CSRC, ch)
             for i, ch in enumerate(MUTANTS.values())}
    libs = build_all(trees)
    a = inputs(dev, 384, torch.bfloat16)
    ref = reference(*a)
    caught_all = True
    for (desc, _), name in zip(MUTANTS.items(), libs):
        rec = check(f"mutant '{desc}'", libs[name], a, ref)
        # NaN compares false: a share that is not <= 1 is outside the bound
        caught = not (rec["share_of_tight"] <= 1 and rec["share_of_sums_bound"] <= 1)
        emit(mutant=desc, caught_by_tight_bound=caught,
             passes_plain_bound=bool(rec["share_of_plain"] <= 1),
             sums_caught=not rec["share_of_sums_bound"] <= 1)
        caught_all = caught_all and caught
    if not caught_all:
        raise SystemExit("a mutant passed bwd_tol")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other-csrc", help="another csrc tree, built and timed in the same turns")
    ap.add_argument("--only-other", action="store_true", help="leave the package's build out")
    ap.add_argument("--variants", help="comma-separated names of VARIANTS")
    ap.add_argument("--other-variants", help="comma-separated names of PARENT_VARIANTS, applied "
                                             "to --other-csrc")
    ap.add_argument("--mutants", action="store_true", help="build the three faulty kernels")
    ap.add_argument("--f32", action="store_true", help="also check and time f32")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    import chip_smoke
    card = chip_smoke.phase_device()
    dev = torch.device("cuda")
    os.makedirs(OUT_DIR, exist_ok=True)
    try:
        if args.mutants:
            run_mutants(dev)
        else:
            run(args, card, dev)
    finally:
        with open(osp.join(OUT_DIR, "profile_ln_pool.jsonl"), "w") as f:
            for rec in OUT:
                f.write(json.dumps(rec) + "\n")
        shutil.rmtree(BUILD_ROOT, ignore_errors=True)


if __name__ == "__main__":
    main()
