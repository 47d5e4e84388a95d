#!/usr/bin/env python3
"""Device time of the LN-pool kernels of `csrc/ln_pool.cu` at phase 3's
shapes, against other builds of the same source in the same turns, on one
CUDA GPU: the backward (#2, `ln_relu_region_mean_bwd`, and its POOL = false
instantiation #4, `ln_relu_bwd`) or, with `--fwd`, the forward (#1,
`ln_relu_region_mean`, and #3, `ln_relu`).

    python3 scripts/profile_ln_pool.py [--fwd] [--other-csrc DIR] [--variants a,b]
                                       [--other-variants a,b] [--only-other]
                                       [--f32] [--reps 20]
    python3 scripts/profile_ln_pool.py [--fwd] --mutants

Backward inputs are `chip_smoke.py` phase 3's: h [32,768, D] (D = 384, G's
embedding, and 128, D's), scale ~ 1 + 0.1 N, bias ~ 0.1 N, g [2,048, D], all
from N(0, 1) and cast to bf16 (and f32 with `--f32`); g is zeroed for the
regions with a ReLU input within 2e-5 of 0, where a rounding may flip the
ReLU mask. Forward inputs: h [32,768, D] ~ N(0, 1), #1 at D = 384 and 128,
#3 at D = 768, 384 and 128. Each build is `ln_pool.cu` alone, compiled by
nvcc into a library of its own under `BUILD_ROOT` (all builds at once;
ptxas registers, shared memory and spills printed), and called through its
C entry points. A build whose backward entry point takes
g in f32 only (the backward before its redesign) is timed with the
wrapper's cast of g inside the call, as the op ran it, and also without
(`..._nocast`).

First every build that computes the right function is checked: the
backward's dh against the plain version's autograd dh (f32 within 1e-5;
bf16 within the plain bound, 2e-2 + 2e-2 relative, and within
`ln_pool.bwd_tol`), dscale / dbias within 1e-3 + 1e-4 relative; the
forward's output against the plain version (f32 within 1e-5; bf16 within
the plain bound and `ln_pool.fwd_tol`); two calls bit for bit. Then each
build's call is timed in turns (a, b, c, c, b, a; CUDA events behind a spin
kernel, medians of 2 x `--reps` calls) three ways: with the inputs in L2 (as
phase 3 times them), and out of L2 after a 128 MB write followed by a 128 MB
read of another buffer (`ms_l2_cold`, the time the byte bound is read
against) or after the write alone (`ms_l2_dirty`: the call then also writes
back the dirty lines it evicts). The forward's turns hold `torch.amax(h)`, one
PyTorch call that reads h once, as a yardstick; the backward's calls are
split into their launches by torch.profiler (the cast, the main kernel, the
tail that sums the block partials).

`--other-csrc DIR`: another source tree (e.g. the parent commit's
`advmil_tpu_torch/csrc`, unpacked with `git archive` into a git-ignored
directory) built and timed beside the package's; `--only-other` leaves the
package's out. `--variants`: builds of the package's `ln_pool.cu` with one
textual change each (`VARIANTS`, with `--fwd` `FWD_VARIANTS`);
`--other-variants`: the same for the other tree (`PARENT_VARIANTS` /
`FWD_PARENT_VARIANTS`, written for the kernels before their redesigns). A
variant marked `wrong` computes something else and is only timed.

`--mutants`: three faulty builds of the package's backward (`MUTANTS`: the
m2 term dropped at one column in 16, the last row of each region skipped,
one block's partial left out of dscale), checked in bf16 at M = 32,768, D =
384 with dh filled with NaN first; fails unless `bwd_tol` (or, for dscale,
the 1e-3 + 1e-4 bound) catches every one. `--fwd --mutants`: four faulty
forwards (`FWD_MUTANTS`: the last row of each region left out, the first 32
columns left out of the mean, eps dropped, the variance taken without its
mean), checked in bf16 at M = 32,768, D = 384 and 128 on rows with a
per-row offset and one region of equal rows; fails unless `fwd_tol`
catches every one. Both record whether the plain 2e-2 bound does.

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
# the forward (#1; #3 is its POOL = false instantiation) before its redesign:
# one warp walks a region's 16 rows, lane l reads columns l, l + 32, ...
_PF_LOAD = ("    for (int j = 0; j < NC; ++j) {\n      x[j] = j < nc ? to_f32(row[lane + 32 * j]) : 0.f;\n"
            "      s += x[j];\n    }")
_PF_VEC4_LOAD = (
    "    for (int j = 0; j < NC; j += 4) {\n"
    "      if (j < nc) {\n"
    "        const T* p = row + (j >> 2) * 128 + lane * 4;\n"
    "        if constexpr (sizeof(T) == 4) {\n"
    "          const float4 f = *reinterpret_cast<const float4*>(p);\n"
    "          x[j] = f.x, x[j + 1] = f.y, x[j + 2] = f.z, x[j + 3] = f.w;\n"
    "        } else {\n"
    "          const uint2 u = *reinterpret_cast<const uint2*>(p);\n"
    "          x[j] = __uint_as_float(u.x << 16), x[j + 1] = __uint_as_float(u.x & 0xffff0000u);\n"
    "          x[j + 2] = __uint_as_float(u.y << 16), x[j + 3] = __uint_as_float(u.y & 0xffff0000u);\n"
    "        }\n"
    "      } else {\n"
    "        x[j] = x[j + 1] = x[j + 2] = x[j + 3] = 0.f;\n"
    "      }\n"
    "      s += x[j] + x[j + 1] + x[j + 2] + x[j + 3];\n"
    "    }")
_PF_COL = "(j >> 2) * 128 + lane * 4 + (j & 3)"
_PF_MU_AT = "      s += x[j];\n    }\n    const float mu = "
_PF_INV_AT = "x[j] - mu : 0.f;\n      q += d * d;\n    }\n    const float inv = "
_PF_MU = (_PF_MU_AT + "warp_sum(s) * inv_d;", _PF_MU_AT + "s * inv_d;")
_PF_INV = (_PF_INV_AT + "rsqrtf(warp_sum(q) * inv_d + eps);", _PF_INV_AT + "rsqrtf(q * inv_d + eps);")
_PF_POOL_STORE = "    if (j < nc) o[lane + 32 * j] = from_f32<T>(acc[j] * (1.f / kRegion));"
_PF_ROW_STORE = ("        out[(static_cast<size_t>(region) * kRegion + i) * D + lane + 32 * j] = "
                 "from_f32<T>(y);")
FWD_PARENT_VARIANTS = {
    # no statistics: no warp reductions, no rsqrt (y = relu(x * scale + bias))
    "loads_only": ([(_PF_MU[0], _PF_MU_AT + "0.f;"), (_PF_INV[0], _PF_INV_AT + "1.f;")], True),
    # the two warp reductions of each row replaced by the lane's own sums
    "no_shuffles": ([_PF_MU, _PF_INV], True),
    # everything but the stores (the pooled row; #3: each row)
    "no_store": ([(_PF_POOL_STORE, _PF_POOL_STORE.replace("if (j < nc)",
                                                          "if (j < nc && acc[j] == 1.2345e-30f)")),
                  (_PF_ROW_STORE, "        if (y == 1.2345e-30f)\n  " + _PF_ROW_STORE)], True),
    # 4 / 16 rows of the walk unrolled, not 2
    "unroll4": ([("#pragma unroll 2\n  for (int i = 0; i < kRegion;",
                  "#pragma unroll 4\n  for (int i = 0; i < kRegion;")], False),
    "unroll16": ([("#pragma unroll 2\n  for (int i = 0; i < kRegion;",
                   "#pragma unroll 16\n  for (int i = 0; i < kRegion;")], False),
    # lane l holds 4 adjacent columns of each 128: 8-byte (bf16) / 16-byte (f32)
    # loads; right where D % 128 == 0, the only shapes it is timed at
    "vec4": ([("    sc[j] = j < nc ? scale[lane + 32 * j] : 0.f;",
               f"    sc[j] = j < nc ? scale[{_PF_COL}] : 0.f;"),
              ("    bi[j] = j < nc ? bias[lane + 32 * j] : 0.f;",
               f"    bi[j] = j < nc ? bias[{_PF_COL}] : 0.f;"),
              (_PF_LOAD, _PF_VEC4_LOAD),
              (_PF_POOL_STORE, _PF_POOL_STORE.replace("o[lane + 32 * j]", f"o[{_PF_COL}]")),
              (_PF_ROW_STORE, _PF_ROW_STORE.replace("D + lane + 32 * j]", f"D + {_PF_COL}]"))],
             False),
    # a region's 16 rows over 4 warps (4 rows each), the pooled row summed
    # through shared memory; a timing probe (M % 32 == 0 at the timed shapes)
    "four_warps_a_region": ([
        ("  const int region = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);",
         "  const int region = blockIdx.x * (kWarpsPerBlock / 4) + (threadIdx.x >> 7);\n"
         "  const int quarter = (threadIdx.x >> 5) & 3;\n"
         "  __shared__ float s_acc[POOL ? kWarpsPerBlock : 1][POOL ? 32 * NC : 1];"),
        ("  const T* row = h + static_cast<size_t>(region) * kRegion * D;",
         "  const T* row = h + (static_cast<size_t>(region) * kRegion + 4 * quarter) * D;"),
        ("  for (int i = 0; i < kRegion; ++i, row += D) {",
         "  for (int i = 4 * quarter; i < 4 * quarter + 4; ++i, row += D) {"),
        (_PF_POOL_STORE,
         "    s_acc[threadIdx.x >> 5][lane + 32 * j] = acc[j];\n"
         "  __syncthreads();\n"
         "  if (quarter != 0) return;\n"
         "#pragma unroll\n"
         "  for (int j = 0; j < NC; ++j)\n"
         "    if (j < nc) {\n"
         "      const int w = threadIdx.x >> 5, c = lane + 32 * j;\n"
         "      o[c] = from_f32<T>((s_acc[w][c] + s_acc[w + 1][c] + s_acc[w + 2][c] + "
         "s_acc[w + 3][c]) * (1.f / kRegion));\n"
         "    }"),
        ("  const dim3 grid((regions + kWarpsPerBlock - 1) / kWarpsPerBlock);",
         "  const dim3 grid((4 * regions + kWarpsPerBlock - 1) / kWarpsPerBlock);")], True),
}

# the redesigned forward: its dispatch of the shapes whose D is whole chunks
_F128 = "if (D == 128) return run(launch_fwd_kernel<T, 4, 8, 4, RB, true, POOL>);"
_F384 = "if (D == 384) return run(launch_fwd_kernel<T, 4, 32, 3, RB, true, POOL>);"
# no statistics: no group sums, no rsqrt (mu = 0, inv = 1)
_F_NO_STATS = [("    group_sum<LPR>(s);\n", ""), ("    group_sum<LPR>(q);\n", ""),
               ("      const float mu = s[r] * inv_d;", "      const float mu = 0.f;"),
               ("inv[r] = rsqrtf(q[r] * inv_d + eps);", "inv[r] = 1.f;")]
# everything but the stores (#1: the pooled row; #3: each row)
_F_NO_STORE = [("    T* o = out + static_cast<size_t>(region) * D;",
                "    T* o = out + static_cast<size_t>(region) * D;\n"
                "    if (acc[0] != 1.2345e-30f) return;"),
               ("        } else if (row_of(p, r) < M) {",
                "        } else if (row_of(p, r) < M && y[0] == 1.2345e-30f) {")]
FWD_VARIANTS = {
    "no_stats": (_F_NO_STATS, True),
    "no_store": (_F_NO_STORE, True),
    # both: the kernel's own read of h, its 16-row sum and nothing else
    "read_only": (_F_NO_STATS + _F_NO_STORE, True),
    # the same grid and shared memory, every block returning at once
    "launch_only": ([("  const int sub = lane / LPR, gl = lane % LPR;",
                      "  if (M > 0) return;\n  const int sub = lane / LPR, gl = lane % LPR;")],
                    True),
    # twice the registers of loads ahead (K passes)
    "ahead48": ([("constexpr int kFwdAheadRegs = 24;", "constexpr int kFwdAheadRegs = 48;")], False),
    # each warp's rows (contiguous) first asked into L2 in one bulk prefetch
    "prefetch_l2": ([("  if (live) {\n#pragma unroll\n    for (int p = 0; p < K; ++p) fetch(p);",
                      "  if (live) {\n"
                      "    const int rows = min(kRegion, M - first);\n"
                      "    if (lane == 0 && rows > 0)\n"
                      "      asm volatile(\"cp.async.bulk.prefetch.L2.global [%0], %1;\\n\" ::\"l\"(\n"
                      "                       h + static_cast<size_t>(first) * D),\n"
                      "                   \"r\"(rows * D * static_cast<int>(sizeof(T))) : \"memory\");\n"
                      "#pragma unroll\n    for (int p = 0; p < K; ++p) fetch(p);")], False),
    # one row a lane a pass in bf16 too; four in bf16, two in f32
    "r1": ([("constexpr int RB = sizeof(T) == 2 ? 2 : 1;", "constexpr int RB = 1;")], False),
    "r4": ([("constexpr int RB = sizeof(T) == 2 ? 2 : 1;",
             "constexpr int RB = sizeof(T) == 2 ? 4 : 2;")], False),
    # a whole warp a row at D = 128, as at D = 384
    "lpr32": ([(_F128, _F128.replace("<T, 4, 8, 4,", "<T, 4, 32, 1,"))], False),
    # the chunk masks kept where D is whole chunks
    "masked": ([(f, f.replace("RB, true", "RB, false")) for f in (_F128, _F384)], False),
    # blocks of 8 warps, not 4
    "warps8": ([("constexpr int kFwdWarps = 4; ", "constexpr int kFwdWarps = 8; "),
                ("__launch_bounds__(32 * kFwdWarps, 4)", "__launch_bounds__(32 * kFwdWarps, 2)")],
               False),
}
FWD_MUTANTS = {
    "last row of each region left out": [
        ("          for (int k = 0; k < V; ++k) acc[j * V + k] += y[k];",
         "          for (int k = 0; k < V; ++k)\n"
         "            acc[j * V + k] += row_of(p, r) % kRegion == kRegion - 1 ? 0.f : y[k];")],
    "first 32 columns out of the mean": [
        ("      for (int e = 0; e < E; ++e) s[r] += x[r][e];",
         "      for (int e = 0; e < E; ++e) s[r] += col(e / V) + e % V < 32 ? 0.f : x[r][e];")],
    "eps dropped": [("inv[r] = rsqrtf(q[r] * inv_d + eps);", "inv[r] = rsqrtf(q[r] * inv_d);")],
    "variance without its mean": [
        ("        x[r][e] = (FULL || e / V < nch) ? x[r][e] - mu : 0.f;  // the deviation, kept\n"
         "        q[r] += x[r][e] * x[r][e];",
         "        q[r] += x[r][e] * x[r][e];\n"
         "        x[r][e] = (FULL || e / V < nch) ? x[r][e] - mu : 0.f;")],
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
        lib.advmil_ln_relu_region_mean.argtypes = [P] * 4 + [I, I, I, F, P]
        lib.advmil_ln_relu.argtypes = [P] * 4 + [I, I, I, F, P]
        for fn in (lib.advmil_ln_relu_region_mean_bwd, lib.advmil_ln_relu_bwd,
                   lib.advmil_ln_pool_bwd_blocks, lib.advmil_ln_relu_region_mean,
                   lib.advmil_ln_relu):
            fn.restype = I
        libs[name] = (lib, g_any)
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln:
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


def event_ms(fn, reps, before=None):
    """ms of each of `reps` calls (CUDA events behind a spin kernel); `before`
    (e.g. a write that flushes L2) runs ahead of each call, outside the events."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        torch.cuda._sleep(1_500_000)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def turns(arms, reps, before=None):
    order = list(arms) + list(arms)[::-1]
    times = {n: [] for n in arms}
    for n in order:
        times[n] += event_ms(arms[n], reps, before)
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


def builds(args):
    """({name: ctypes lib entry}, names of the builds that compute something
    else): the package's ln_pool.cu, --other-csrc's and the variants."""
    from advmil_tpu_torch.ops import _build
    pkg = _build.CSRC
    own, other = (FWD_VARIANTS, FWD_PARENT_VARIANTS) if args.fwd else (VARIANTS, PARENT_VARIANTS)
    trees = {} if args.only_other else {"kernel": pkg}
    if args.other_csrc:
        trees["other_csrc"] = args.other_csrc
    wrong = set()
    for name in filter(None, (args.variants or "").split(",")):
        changes, bad = own[name]
        trees[name] = patched_tree(name, pkg, changes)
        wrong |= {name} if bad else set()
    for name in filter(None, (args.other_variants or "").split(",")):
        changes, bad = other[name]
        trees[f"other_{name}"] = patched_tree(f"other_{name}", args.other_csrc or pkg, changes)
        wrong |= {f"other_{name}"} if bad else set()
    return build_all(trees), wrong


def run(args, card, dev, libs, wrong):
    """#2 and #4: every right build checked, then each timed in turns (with
    its inputs in L2 and out of it: `l2_flushes`), #2's calls split into
    their launches by torch.profiler."""
    import torch
    ok = True
    flushes = l2_flushes(dev)
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
            t = timed(arms, args.reps, flushes)
            apart = launches_apart(arms, args.reps)
            g_bytes = a[0].numel() * a[0].element_size()
            hd = a[1].numel() * a[1].element_size()
            b = (2 * hd + g_bytes + 16 * D) / 3.35e9
            for n, (warm, cold, dirty) in t.items():
                emit(time=f"{n} #2 M={M} D={D} {str(dtype)[6:]}", card=card, ms=warm,
                     ms_l2_cold=cold, ms_l2_dirty=dirty, launches_ms=apart[n], bound_ms=b,
                     share_cold=b / cold,
                     bound_f32_g_ms=(2 * hd + 4 * a[0].numel() + 16 * D) / 3.35e9)
            del a, g32, arms
        for D in (768, 384):   # #4, ln_relu's backward (POOL = false)
            a = inputs(dev, D, dtype, pool=False)
            arms = {n: (lambda e=e: bwd_of(e, *a, pool=False)) for n, e in libs.items()}
            t = timed(arms, args.reps, flushes)
            hd = a[1].numel() * a[1].element_size()
            b = (3 * hd + 16 * D) / 3.35e9
            for n, (warm, cold, dirty) in t.items():
                emit(time=f"{n} #4 M={M} D={D} {str(dtype)[6:]}", card=card, ms=warm,
                     ms_l2_cold=cold, ms_l2_dirty=dirty, bound_ms=b, share_cold=b / cold)
            del a, arms
    if not ok:
        raise SystemExit("a check failed")


def fwd_of(entry, h, scale, bias, pool=True, fill_nan=False):
    """The forward of a build: #1 ([M/16, D]) or, with pool False, #3 ([M, D])."""
    import torch
    from advmil_tpu_torch.ops import _build
    lib = entry[0]
    Mr, D = h.shape
    out = torch.empty((Mr // 16, D) if pool else (Mr, D), dtype=h.dtype, device=h.device)
    if fill_nan:
        out.fill_(float("nan"))
    fn = lib.advmil_ln_relu_region_mean if pool else lib.advmil_ln_relu
    rc = fn(h.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), Mr, D,
            _build.DTYPE_CODES[h.dtype], 1e-6, _build.stream_of(h))
    if rc != 0:
        raise RuntimeError(f"ln_pool forward: CUDA error {rc}")
    return out


def fwd_inputs(dev, M_, D, dtype, offset=0.0, flat_region=False):
    """h [M_, D] ~ N(0, 1) (plus a per-row offset ~ `offset` N(0, 1): rows of
    pre-LN activations do not have mean 0), scale ~ 1 + 0.1 N, bias ~ 0.1 N;
    with `flat_region`, region 1's rows are constant (variance 0, as rows of
    zero features through a dense layer's bias are)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1000 + D)
    h = torch.randn(M_, D, device=dev, generator=g)
    h += offset * torch.randn(M_, 1, device=dev, generator=g)
    if flat_region:
        h[16:32] = 0.25
    scale = 1.0 + 0.1 * torch.randn(D, device=dev, generator=g)
    bias = 0.1 * torch.randn(D, device=dev, generator=g)
    return h.to(dtype), scale, bias


def fwd_check(name, entry, args, pool=True):
    """Shares of the plain bound and of `ln_pool.fwd_tol` (bf16) or of 1e-5
    (f32) against the plain version on the same inputs; two calls bit for
    bit (the first into an output filled with NaN)."""
    import torch

    import chip_smoke
    from advmil_tpu_torch.ops import ln_pool
    h = args[0]
    want = (ln_pool.ln_relu_region_mean_plain if pool else ln_pool.ln_relu_plain)(*args)
    got = fwd_of(entry, *args, pool=pool, fill_nan=True)
    again = fwd_of(entry, *args, pool=pool)
    torch.cuda.synchronize()
    share = chip_smoke.share_of
    same = torch.equal(got, again)
    f32 = h.dtype == torch.float32
    plain = share(got, want, 1e-5, 0.0) if f32 else share(got, want, 2e-2, 2e-2)
    tight = None if f32 else share(got, want, **ln_pool.fwd_tol(want))
    rec = dict(check=f"{name} {'#1' if pool else '#3'} M={h.shape[0]} D={h.shape[1]} "
                     f"{str(h.dtype)[6:]}",
               share_of_plain=plain, share_of_tight=tight, bit_for_bit=same,
               ok=same and plain <= 1 and (tight is None or tight <= 1))
    emit(**rec)
    return rec


def l2_flushes(dev):
    """Two ways to take the inputs out of L2 before a call, outside the
    events: a 128 MB write, then a 128 MB read of another buffer, so that the
    write's dirty lines are back in memory before the call (`clean`: the time
    the byte bound is read against), and the write alone (`dirty`: the call
    then also writes back the lines it evicts)."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    other = torch.zeros(128 << 20, dtype=torch.uint8, device=dev)

    def clean():
        flush.zero_()
        other.max()
    return clean, flush.zero_


def timed(arms, reps, flushes):
    """{name: (ms with the inputs in L2, ms L2-clean, ms L2-dirty)}, each a
    median of turns."""
    warm = turns(arms, reps)
    cold = turns(arms, reps, before=flushes[0])
    dirty = turns(arms, reps, before=flushes[1])
    return {n: (warm[n], cold[n], dirty[n]) for n in arms}


def run_fwd(args, card, dev, libs, wrong):
    """#1 and #3: every right build checked, then each timed in turns with h
    in L2 (as phase 3 times it) and out of L2 (`l2_flushes`), beside one
    PyTorch call that reads h once (`torch.amax`, a yardstick)."""
    import torch
    ok = True
    flushes = l2_flushes(dev)

    shapes = [(True, 384), (True, 128), (False, 768), (False, 384), (False, 128)]
    for dtype in ((torch.bfloat16, torch.float32) if args.f32 else (torch.bfloat16,)):
        for pool, D in shapes:
            a = fwd_inputs(dev, M, D, dtype)
            for name, entry in libs.items():
                if name not in wrong:
                    ok = fwd_check(name, entry, a, pool)["ok"] and ok
            arms = {n: (lambda e=e: fwd_of(e, *a, pool=pool)) for n, e in libs.items()}
            arms["read_only_amax"] = lambda: torch.amax(a[0])  # reads h once: a yardstick
            t = timed(arms, args.reps, flushes)
            h = a[0]
            moved = h.numel() * h.element_size() * (1 + (1 / 16 if pool else 1)) + 8 * D
            b = moved / 3.35e9
            for n, (warm, cold, dirty) in t.items():
                emit(time=f"{n} {'#1' if pool else '#3'} M={M} D={D} {str(dtype)[6:]}",
                     card=card, ms=warm, ms_l2_cold=cold, ms_l2_dirty=dirty, bound_ms=b,
                     share_warm=b / warm, share_cold=b / cold, share_dirty=b / dirty)
            del a, arms
    if not ok:
        raise SystemExit("a check failed")


def run_fwd_mutants(dev):
    """Each of FWD_MUTANTS built and checked in bf16 at M = 32,768, D = 384
    and 128, on rows with a per-row offset and one region of constant rows;
    fails unless `fwd_tol` catches every one."""
    import torch
    from advmil_tpu_torch.ops import _build
    trees = {f"fmutant{i}": patched_tree(f"fmutant{i}", _build.CSRC, ch)
             for i, ch in enumerate(FWD_MUTANTS.values())}
    libs = build_all({"kernel": _build.CSRC, **trees})
    caught_all = True
    for D in (384, 128):
        a = fwd_inputs(dev, M, D, torch.bfloat16, offset=0.1, flat_region=True)
        if not fwd_check("kernel", libs["kernel"], a)["ok"]:
            raise SystemExit("the right kernel fails its bounds on the mutants' inputs")
        for desc, name in zip(FWD_MUTANTS, trees):
            rec = fwd_check(f"mutant '{desc}'", libs[name], a)
            # NaN compares false: a share that is not <= 1 is outside the bound
            caught = not rec["share_of_tight"] <= 1
            emit(mutant=desc, D=D, caught_by_fwd_tol=caught,
                 passes_plain_bound=bool(rec["share_of_plain"] <= 1))
            caught_all = caught_all and caught
    if not caught_all:
        raise SystemExit("a mutant passed fwd_tol")


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
    ap.add_argument("--fwd", action="store_true", help="the forward #1 and #3 in place of the "
                                                      "backward (variants: FWD_VARIANTS, "
                                                      "FWD_PARENT_VARIANTS; mutants: FWD_MUTANTS)")
    ap.add_argument("--mutants", action="store_true", help="build the faulty kernels")
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
            (run_fwd_mutants if args.fwd else run_mutants)(dev)
        else:
            (run_fwd if args.fwd else run)(args, card, dev, *builds(args))
    finally:
        with open(osp.join(OUT_DIR, "profile_ln_pool.jsonl"), "w") as f:
            for rec in OUT:
                f.write(json.dumps(rec) + "\n")
        shutil.rmtree(BUILD_ROOT, ignore_errors=True)


if __name__ == "__main__":
    main()
