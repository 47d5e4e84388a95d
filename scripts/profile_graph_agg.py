#!/usr/bin/env python3
"""Device time of the graph aggregation kernels at phase 3's shape, against
other builds of the same source in the same turns, on one CUDA GPU: the
banded kernels (#14 forward, #15 backward; `csrc/banded.cu`) or, with
`--knn`, the dense kNN kernels (#12 forward, #13 backward; `csrc/knn_agg.cu`).

    python3 scripts/profile_graph_agg.py [--other-csrc DIR] [--variants a,b]
                                         [--other-variants a,b] [--f32] [--reps 20]
    python3 scripts/profile_graph_agg.py --mutants
    python3 scripts/profile_graph_agg.py --knn [--other-csrc DIR] [--variants a,b]
                                         [--other-variants a,b] [--only-other]
    python3 scripts/profile_graph_agg.py --knn --mutants

Inputs are `chip_smoke.py` phase 3's: B = 2 bags of N = 16,384 nodes on
tissue-like 8-nearest-neighbour rasters (~48 wide), epn = 9, C = 384, y =
relu(randn) + 1e-7, t = 1.3, bf16 (and f32 with `--f32`). Each build is
`banded.cu` alone, compiled by nvcc into a library of its own under
`chiprun_out/graph_agg_builds/` (all builds at once; ptxas registers, shared
memory and spills are printed), and called through its C entry points: the
wrappers' casts are not timed.

First every build that computes the right function is checked at that shape:
out, dy and dt against `banded_core_plain` and its autograd backward, f32
within 1e-5 (dt 1e-4 relative), bf16 within the plain bound (2e-2 + 2e-2
relative) and within `banded_tol` (2^-7 relative + 2^-10 of the largest
value), and two backward calls bit for bit. Then the forward with its
statistics, the forward without them and the backward of every build are
timed in turns (a, b, c, c, b, a; CUDA events behind a spin kernel, medians
of 2 x `--reps` calls).

`--other-csrc DIR[,DIR2]`: other source trees (e.g. the parent commit's
`advmil_tpu_torch/csrc`, unpacked with `git archive` into a git-ignored
directory) built and timed beside the package's. Its C entry points may be
the earlier ones, which save (m, den, out32) in place of (lse, out32).
`--variants`: builds of the package's `banded.cu` with one textual change
each (`VARIANTS`); `--other-variants`: the same for the other tree
(`PARENT_VARIANTS`, written for the kernels before their redesign; applied
to the package's sources when no `--other-csrc` is given). A variant marked
`wrong` computes something else and is only timed.

`--mutants`: four faulty builds of the package's `banded.cu` (`MUTANTS`: a
slot dropped, the backward's offset sign flipped for one slot, the staged
window one row short, G2 without out), each checked in bf16; fails unless
`banded_tol` catches every one, and records whether the plain bound does.

`--knn`: the messages of phase 3 gathered from y by the dense tables
([2, 16,384, 9, 384]; a node without edges, masked slots holding 300.0),
then phase 37's residual rows of grid tables at W ~ 40, 60 and 220 ([2, U,
9, 384], U = 1,120-1,256), each in f32 and bf16; knn_agg.cu compiled alone
per build (ptxas lines of the epn = 9 and 16 instantiations). Every build that computes the right function is checked
at every shape: #12 and #13's dmessages against the plain version and its
autograd backward (f32 within 1e-5; bf16 within the plain 2e-2 bound and
`segment.knn_tol` / `segment.knn_bwd_tol`), dt within 1e-4 relative, two
backward calls bit for bit, nodes without edges and masked slots exactly 0;
then #12 / #13 are timed in turns. `KNN_VARIANTS` patch the package's
kernels, `KNN_PARENT_VARIANTS` the backward before its redesign (whose
entry point takes a 1,024-float dt scratch; both stay while PERF.md's
numbers for that kernel come from them, reproduced with `--other-csrc` on a
tree that still has it); `--only-other` times the other builds alone. With `--mutants`: three faulty forwards and three
faulty backwards (`KNN_MUTANTS`: a slot dropped, a slot's mask ignored, the
channel tail left unwritten; a slot dropped from dm, one block's dt partial
lost, dm's channel tail left unwritten), checked in bf16 at phase 3's shape
and at C = 38 (a channel tail), outputs filled with NaN first; fails unless
`knn_tol`, `knn_bwd_tol` or the dt bound catches every one.

JSON lines go to stdout and to `chiprun_out/profile_graph_agg.jsonl`
(`profile_graph_agg_knn.jsonl` with `--knn`).
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
BUILD_ROOT = osp.join(OUT_DIR, "graph_agg_builds")

OUT = []

# ---------------------------------------------------------------------------
# textual changes of banded.cu: name -> ([(old, new), ...], wrong)
# ---------------------------------------------------------------------------

_P_FWD_IDX = """    const long long bn = i / C;                 // b * N + n
    const int c = static_cast<int>(i - bn * C);
    const int b = static_cast<int>(bn / N);
    const int n = static_cast<int>(bn - static_cast<long long>(b) * N);"""
_P_BWD_IDX = """    const long long br = i / C;                 // b * N + r
    const int c = static_cast<int>(i - br * C);
    const int b = static_cast<int>(br / N);
    const int r = static_cast<int>(br - static_cast<long long>(b) * N);"""


def _idx(var, first, div):
    return (f"    const long long {var} = {div('i', 'C')};\n"
            f"    const int c = static_cast<int>(i - {var} * C);\n"
            f"    const int b = static_cast<int>({div(var, 'N')});\n"
            f"    const int {first} = static_cast<int>({var} - static_cast<long long>(b) * N);")


_DIV32 = lambda a, d: f"static_cast<unsigned>({a}) / static_cast<unsigned>({d})"  # noqa: E731
# divisions by compile-time constants become multiplications: right at C = 384, N = 16,384 only
_CONST = lambda a, d: f"{a} / {384 if d == 'C' else 16384}"  # noqa: E731
_P_SOFTMAX = "const SlotSoftmax sm = slot_softmax(v, on, epn, t, e);"
_P_EXP = "const float ex = expf(yr * t - m[j]);"
_P_STORE_F = ("    out[i] = from_f32<T>(o);\n    if (m_out != nullptr) {",
              "    if (o == 1.2345e-30f) out[i] = from_f32<T>(o);\n    if (o == 1.2345e-30f) {")
_P_STORE_32 = ("if (out32 != nullptr) out32[i] = o;", "if (o == 1.2345e-30f) out32[i] = o;")
_P_STORE_B = "    dy[i] = from_f32<T>(acc);"

PARENT_VARIANTS = {
    # the index of each element from 32-bit divisions in place of 64-bit ones
    "div32": ([(_P_FWD_IDX, _idx("bn", "n", _DIV32)), (_P_BWD_IDX, _idx("br", "r", _DIV32))],
              False),
    # no division routine at all (right at phase 3's shape only)
    "const_div": ([(_P_FWD_IDX, _idx("bn", "n", _CONST)), (_P_BWD_IDX, _idx("br", "r", _CONST))],
                  False),
    # the slot arrays unrolled to the 9 slots of the shape, not to 16
    "epn9": ([("graph_agg.cuh", "constexpr int kMaxEpn = 16;", "constexpr int kMaxEpn = 9;")],
             False),
    # every load and store, no softmax: the forward sums its slots, the backward skips exp
    "loads_only": ([(_P_SOFTMAX, "SlotSoftmax sm{0.f, 1.f, 0.f};\n    for (int s = 0; s < kMaxEpn; "
                                 "++s) sm.num += v[s];"),
                    (_P_EXP, "const float ex = yr - m[j];")], True),
    # everything but the stores of out and dy (and the forward's statistics)
    "no_store": ([_P_STORE_F, _P_STORE_32,
                  (_P_STORE_B, "    if (acc == 1.2345e-30f) dy[i] = from_f32<T>(acc);")], True),
}

_EXP_F = "const float e = fast_exp2(fmaf(v[j], t, -mx[j]) * kLog2e);"
_EXP_B = "const float p = fast_exp2(fmaf(yr[j], t, -lv[j]) * kLog2e);"
_SUMS_F = """          const float e = fast_exp2(fmaf(v[j], t, -mx[j]) * kLog2e);
          den[j] += e;
          num[j] = fmaf(e, v[j], num[j]);"""
_SUMS_B = """          const float p = fast_exp2(fmaf(yr[j], t, -lv[j]) * kLog2e);
          const float h = gv[j] * (yr[j] - ov[j]);
          acc[j] = fmaf(p, fmaf(t, h, gv[j]), acc[j]);
          wsum[j] = fmaf(p, h, wsum[j]);"""
_NEVER = "o[0] == 1.2345e-30f"
_STORES_F = [("store16<T>(out + at, pack16<T>(o), C - c0, vec);",
              f"if ({_NEVER}) store16<T>(out + at, pack16<T>(o), C - c0, vec);"),
             ("if (lse_out != nullptr) store_f32", f"if (lse_out != nullptr && {_NEVER}) store_f32"),
             ("if (out32 != nullptr) store_f32", f"if (out32 != nullptr && {_NEVER}) store_f32")]
_STORE_B = ("store16<T>(dy + at, pack16<T>(acc), C - c0, vec);",
            "if (acc[0] == 1.2345e-30f) store16<T>(dy + at, pack16<T>(acc), C - c0, vec);")
_PREFETCH_F = """      if (r0 + G::kRows < w.r_end) {
        stage_rows(r0 + G::kRows + hr, r0 + 2 * G::kRows + hr);"""
_PREFETCH_B = """if (r0 + G::kRows < w.r_end) stage_rows(r0 + G::kRows + hr, r0 + 2 * G::kRows + hr);"""
_GEOM_TPR = "static constexpr int kTpr = (kBwd && sizeof(T) == 2) ? 4 : 8;"

VARIANTS = {
    # the exponentials replaced by their arguments
    "no_exp": ([(_EXP_F, "const float e = fmaf(v[j], t, -mx[j]);"),
                (_EXP_B, "const float p = fmaf(yr[j], t, -lv[j]);")], True),
    # the loads and the stores, the softmax and its gradient replaced by sums
    "loads_only": ([(_SUMS_F, "          num[j] += v[j];"),
                    (_SUMS_B, "          acc[j] += gv[j] + ov[j] + lv[j];")], True),
    # everything but the stores
    "no_store": (_STORES_F + [_STORE_B], True),
    # every slot read from device memory (the ring is still loaded)
    "no_staging": ([("if (d >= -l && d <= h) bits |= 1u << s;",
                     "if (d >= -l && d <= h && max_span < 0) bits |= 1u << s;")], False),
    # bf16 backward with 8 threads a row (64 channels a block, 1 block per SM)
    "bwd_tpr8": ([(_GEOM_TPR, "static constexpr int kTpr = 8;")], False),
    # the backward reads the mask of a staged slot from device memory (no mask ring)
    "bwd_mask_global": ([("for (int i = tid; i < (n_hi - n_lo) * epn; i += kBandThreads) {",
                          "for (int i = tid; i < 0 * epn; i += kBandThreads) {"),
                         ("if (!(s_bm[q * epn + s] > 0.f)) continue;",
                          "if (!(bmask[(bag + n) * epn + s] > 0.f)) continue;")], False),
    # the staging pipeline alone: every row skips its compute (only timed)
    "stage_only": ([("      const int n = r0 + row;\n      if (n >= w.r_end || c0 >= C) continue;",
                     "      const int n = r0 + row;\n      if (n >= 0 || c0 >= C) continue;"),
                    ("      const int r = r0 + row;\n      if (r >= w.r_end || c0 >= C) continue;",
                     "      const int r = r0 + row;\n      if (r >= 0 || c0 >= C) continue;")],
                   True),
    # the compute alone: the ring is loaded for the first step only (stale rows after)
    "compute_only": ([("      if (r0 + G::kRows < w.r_end) {\n        stage_rows(",
                       "      if (r0 < 0) {\n        stage_rows("),
                      ("if (r0 + G::kRows < w.r_end) stage_rows(", "if (r0 < 0) stage_rows(")],
                     True),
}
MUTANTS = {
    "slot 3 dropped": [("if (bm[s] > 0.f && src >= 0 && src < N) on |= 1u << s;",
                        "if (bm[s] > 0.f && src >= 0 && src < N && s != 3) on |= 1u << s;")],
    "the backward's offset sign flipped for slot 3": [
        ("const int n = r - s_off[s];", "const int n = s == 3 ? r + s_off[s] : r - s_off[s];")],
    "the staged window one row short": [
        (_PREFETCH_F, _PREFETCH_F.replace("2 * G::kRows + hr)", "2 * G::kRows + hr - 1)")),
        (_PREFETCH_B, _PREFETCH_B.replace("2 * G::kRows + hr)", "2 * G::kRows + hr - 1)"))],
    "G2 without out": [("const float h = gv[j] * (yr[j] - ov[j]);",
                        "const float h = gv[j] * yr[j];")],
}


# knn_agg.cu: the backward before its redesign (one thread per element, grid-stride)
_KP_SOFTMAX = "    const SlotSoftmax sm = slot_softmax(v, on, epn, t, e);"
_KP_DM = "        dmsg[base + static_cast<long long>(s) * C] ="
KNN_PARENT_VARIANTS = {
    # the slot arrays unrolled to the 9 slots of the shape, not to 16
    "epn9": ([("graph_agg.cuh", "constexpr int kMaxEpn = 16;", "constexpr int kMaxEpn = 9;")],
             False),
    # no division routine at all (right at C = 384 only)
    "const_div": ([("    const long long r = i / C;\n"
                    "    const int c = static_cast<int>(i - r * C);",
                    "    const long long r = i / 384;\n"
                    "    const int c = static_cast<int>(i - r * 384);")], False),
    # no dt arithmetic (the partials and the second launch stay)
    "no_dt": ([("    dt += gi * dts;\n", "")], True),
    # every load and store, no softmax: the slots summed, alpha 1 on the mask
    "loads_only": ([(_KP_SOFTMAX, "    SlotSoftmax sm{0.f, 1.f, 0.f};\n    for (int s = 0; s < "
                                  "kMaxEpn; ++s) {\n      e[s] = on[s] ? 1.f : 0.f;\n      "
                                  "sm.num += v[s];\n    }")], True),
    # everything but the stores of dm
    "no_store": ([(_KP_DM, "        if (a == 1.2345e-30f) " + _KP_DM.strip())], True),
}
_KN_EXP = "      const float e = expf(v[j] * t - mx[j]);"
_KN_STORE = "  store16<T>(out + r * C + c0, pack16<T>(v), C - c0, vec);"
_KN_BITS = "bits |= (em[s] > 0.f ? 1u : 0u) << s;"
_KB_TERMS = """          const float a = expf(v[j] * t - mx[j]) * inv[j];
          d[j] = gv[j] * a * (1.f + t * (v[j] - o[j]));
          w[j] += a * v[j] * (v[j] - o[j]);"""
_KB_STORE = "      store_stream16<T>(dp + s * C, pack16<T>(d), C - c0, vec);"
_KB_PART = "part_dt[blockIdx.y * gridDim.x + blockIdx.x] = dt;"
KNN_VARIANTS = {
    # the exponentials of the softmax statistics (both kernels) replaced by their arguments
    "no_exp": ([(_KN_EXP, "      const float e = v[j] * t - mx[j];")], True),
    # plain cached loads of the messages (both kernels) in place of the streaming ones
    "ldg": ([("raw[s] = vec ? ld_stream16(mp + s * C)",
              "raw[s] = vec ? __ldg(reinterpret_cast<const uint4*>(mp + s * C))")], False),
    # everything but the forward's store
    "no_store": ([(_KN_STORE, "  if (v[0] == 1.2345e-30f) " + _KN_STORE.strip())], True),
    # every slot loaded and summed, no softmax (both kernels' statistics)
    "loads_only": ([(_KN_EXP, "      const float e = 1.f;")], True),
    # registers capped for 4 blocks of 256 threads an SM (bf16 takes 93 without)
    "min_blocks4": ([("__global__ void __launch_bounds__(kAggThreads)\nknn_agg_fwd_kernel(",
                      "__global__ void __launch_bounds__(kAggThreads, 4)\nknn_agg_fwd_kernel(")],
                    False),
    # one block width for every C: 32 threads of channels (both kernels)
    "tx32": ([("const int narrower[] = {16, 8};", "const int narrower[] = {32};")], False),
    # the backward's last pass without its exponentials
    "bwd_no_exp": ([(_KB_TERMS.split("\n")[0],
                     "          const float a = (v[j] * t - mx[j]) * inv[j];")], True),
    # the backward's loads, mask and stores, no arithmetic but a sum
    "bwd_loads_only": ([(_KB_TERMS, "          d[j] = v[j] + gv[j];\n          w[j] += v[j];")],
                       True),
    # everything but the backward's stores of dm
    "bwd_no_store": ([(_KB_STORE, "      if (d[0] == 1.2345e-30f) " + _KB_STORE.strip())], True),
    # dm by plain (write-back) stores in place of the streaming ones
    "plain_store": ([("st.global.cs.v4.u32", "st.global.v4.u32")], False),
    # the backward without its second launch (dt left unwritten)
    "no_dt_launch": ([("    if (err != cudaSuccess) return err;\n    sum_dt_partials_kernel<<<",
                       "    if (err != cudaSuccess || nblocks > 0) return err;\n"
                       "    sum_dt_partials_kernel<<<")], True),
    # the backward's last pass with exp2f (ex2.approx) in place of expf
    "bwd_fast_exp": ([(_KB_TERMS.split("\n")[0],
                       "          const float a = exp2f((v[j] * t - mx[j]) * 1.44269504f) * inv[j];")],
                     False),
    # registers capped for 3 blocks of 256 threads an SM in the backward
    "bwd_min_blocks3": ([("__global__ void __launch_bounds__(kAggThreads)\nknn_agg_bwd_kernel(",
                          "__global__ void __launch_bounds__(kAggThreads, 3)\n"
                          "knn_agg_bwd_kernel(")], False),
}
KNN_MUTANTS = {
    # the forward's (the mask bits are shared: the backward sees them too)
    "slot 3 dropped": [(_KN_BITS, "bits |= (em[s] > 0.f && s != 3 ? 1u : 0u) << s;")],
    "slot 5's mask ignored": [(_KN_BITS, "bits |= (em[s] > 0.f || s == 5 ? 1u : 0u) << s;")],
    "the channel tail left unwritten": [
        (_KN_STORE, "  if (vec || C - c0 >= kVec) " + _KN_STORE.strip())],
    # the backward's
    "slot 3 dropped from dm": [("      if ((on >> s) & 1u) {",
                                "      if (((on >> s) & 1u) && s != 3) {")],
    "one block's dt partial lost": [
        (_KB_PART, "part_dt[blockIdx.y * gridDim.x + blockIdx.x] = blockIdx.x == 7 ? 0.f : dt;")],
    "the channel tail of dm left unwritten": [
        (_KB_STORE, "      if (vec || C - c0 >= kVec) " + _KB_STORE.strip())],
}

# ---------------------------------------------------------------------------


def emit(**rec):
    print(json.dumps(rec), flush=True)
    OUT.append(rec)


def api_of(csrc):
    """'lse' for entry points that save (lse, out32), 'stats3' for the
    earlier ones that saved (m, den, out32)."""
    text = (Path(csrc) / "banded.cu").read_text()
    return "lse" if "void* lse" in text else "stats3"


def patched_tree(name, csrc, changes, source="banded.cu"):
    """A copy of `csrc` under the build root in which each `old` of
    `changes` reads `new`: (old, new) pairs in `source` or (file, old, new)
    triples; each `old` must occur once."""
    tmp = Path(BUILD_ROOT) / f"src_{name}"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.copytree(csrc, tmp)
    for change in changes:
        f, old, new = change if len(change) == 3 else (source, *change)
        text = (tmp / f).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to change occurs {text.count(old)} times in {f}")
        (tmp / f).write_text(text.replace(old, new))
    return tmp


def build_all(trees, source="banded.cu"):
    """{name: csrc dir} -> {name: (ctypes lib, api, ptxas log)}: `source` of
    each tree compiled alone, every nvcc started at once."""
    from advmil_tpu_torch.ops import _build
    nvcc = _build._nvcc()
    jobs = {}
    for name, csrc in trees.items():
        so = Path(BUILD_ROOT) / f"lib_{name}.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(Path(csrc) / source)]
        jobs[name] = (so, csrc, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, csrc, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        P, I = ctypes.c_void_p, ctypes.c_int
        if source == "banded.cu":
            api = api_of(csrc)
            npf, npb = (7, 10) if api == "lse" else (8, 11)
            lib.advmil_banded_fwd.argtypes = [P] * npf + [I] * 5 + [P]
            lib.advmil_banded_bwd.argtypes = [P] * npb + [I] * 5 + [P]
            lib.advmil_banded_fwd.restype = lib.advmil_banded_bwd.restype = I
        else:   # "knn": partials sized by advmil_knn_agg_bwd_blocks; "knn1024": the earlier one
            api = "knn" if "advmil_knn_agg_bwd_blocks" in (Path(csrc) / source).read_text() \
                else "knn1024"
            lib.advmil_knn_agg_fwd.argtypes = [P] * 4 + [I] * 4 + [P]
            lib.advmil_knn_agg_bwd.argtypes = [P] * 6 + [I, P] + [I] * 4 + [P] \
                if api == "knn" else [P] * 7 + [I] * 4 + [P]
            lib.advmil_knn_agg_fwd.restype = lib.advmil_knn_agg_bwd.restype = I
            if api == "knn":
                lib.advmil_knn_agg_bwd_blocks.argtypes = [I] * 3
                lib.advmil_knn_agg_bwd_blocks.restype = I
        libs[name] = (lib, api, log)
        lines = log.splitlines()
        kind = source.split("_")[0].split(".")[0]   # "banded" or "knn"
        for i, ln in enumerate(lines):
            if kind == "knn" and "Li" in ln and "Li9E" not in ln and "Li16E" not in ln:
                continue   # one kernel per slot count: the shape's (epn = 9) and 16 are printed
            if "Compiling entry function" in ln and kind in ln:
                emit(build=name, ptxas=ln.split("'")[1],
                     used=" ".join(x.strip() for x in lines[i + 1:i + 4]
                                   if "Used" in x or "spill" in x or "stack" in x))
        warn = sorted({ln.strip() for ln in lines if "arning" in ln})
        if warn:
            emit(build=name, ptxas_warnings=warn)
    return libs


def _ptr(x):
    return x.data_ptr() if x is not None else None


def fwd_of(entry, y, offs, bm, t, stats=True):
    """(out, stats) from a build's forward; stats in the build's own form
    ((lse, out32) or (m, den, out32)), None without them."""
    import torch
    from advmil_tpu_torch.ops import _build
    lib, api, _ = entry
    B, N, C = y.shape
    out = torch.empty_like(y)
    f32 = lambda: torch.empty(y.shape, dtype=torch.float32, device=y.device)  # noqa: E731
    n_stats = 2 if api == "lse" else 3
    st = None
    if stats:
        st = tuple(f32() for _ in range(n_stats - 1)) + (out if y.dtype == torch.float32 else f32(),)
    ptrs = [_ptr(s) for s in st] if st else [None] * n_stats
    if st and st[-1] is out:
        ptrs[-1] = None
    rc = lib.advmil_banded_fwd(y.data_ptr(), offs.data_ptr(), bm.data_ptr(), t.data_ptr(),
                               out.data_ptr(), *ptrs, B, N, C, bm.shape[2],
                               _build.DTYPE_CODES[y.dtype], _build.stream_of(y))
    if rc != 0:
        raise RuntimeError(f"advmil_banded_fwd: CUDA error {rc}")
    return out, st


def bwd_of(entry, y, offs, bm, t, st, g, partials):
    import torch
    from advmil_tpu_torch.ops import _build
    lib, _, _ = entry
    B, N, C = y.shape
    dy = torch.empty_like(y)
    dt = torch.zeros(1, dtype=torch.float32, device=y.device)
    rc = lib.advmil_banded_bwd(y.data_ptr(), offs.data_ptr(), bm.data_ptr(), t.data_ptr(),
                               *[s.data_ptr() for s in st], g.data_ptr(), dy.data_ptr(),
                               partials.data_ptr(), dt.data_ptr(), B, N, C, bm.shape[2],
                               _build.DTYPE_CODES[y.dtype], _build.stream_of(y))
    if rc != 0:
        raise RuntimeError(f"advmil_banded_bwd: CUDA error {rc}")
    return dy, dt


def inputs(dev, dtype):
    import numpy as np
    import torch

    import chip_smoke
    from advmil_tpu_torch.ops import segment as tseg
    B, N, epn, C = 2, 16384, 9, 384
    tabs, _ = chip_smoke._graph_kernel_inputs(B, N, epn, np.random.default_rng(3))
    g = torch.Generator(device=dev).manual_seed(0)
    y = (torch.relu(torch.randn(B, N, C, device=dev, generator=g)) + 1e-7).to(dtype)
    gout = torch.randn(B, N, C, device=dev, generator=g).to(dtype)
    offs = torch.from_numpy(tabs["band_offs"]).to(dev).int().contiguous()
    bm = torch.from_numpy(tabs["band_mask"]).to(dev).float().contiguous()
    t = torch.tensor([1.3], device=dev)
    part = torch.empty(tseg.DT_PARTIALS, dtype=torch.float32, device=dev)
    return y, offs, bm, t, gout, part


def reference(y, offs, bm, t, gout):
    import torch
    from advmil_tpu_torch.ops import banded as tband
    leaves = [y.detach().clone().requires_grad_(True), t.clone().requires_grad_(True)]
    out = tband.banded_core_plain(leaves[0], offs, bm, leaves[1])
    dy, dt = torch.autograd.grad(out, leaves, gout)
    return out.detach(), dy, dt


def check(name, entry, args, ref):
    """Shares of the plain and the tight bound (bf16) or of 1e-5 (f32)."""
    import torch

    import chip_smoke
    from advmil_tpu_torch.ops import banded as tband
    y, offs, bm, t, gout, part = args
    out, st = fwd_of(entry, y, offs, bm, t)
    dy, dt = bwd_of(entry, y, offs, bm, t, st, gout, part)
    dy2, dt2 = bwd_of(entry, y, offs, bm, t, st, gout, part)
    torch.cuda.synchronize()
    same = bool(torch.equal(dy, dy2) and torch.equal(dt, dt2))
    share = chip_smoke.share_of
    dt_share = float((dt - ref[2]).abs() / (1e-4 * ref[2].abs()))
    if y.dtype == torch.float32:
        plain = {"out": share(out, ref[0], 1e-5, 0.0), "dy": share(dy, ref[1], 1e-5, 0.0)}
        tight = {}
    else:
        plain = {"out": share(out, ref[0], 2e-2, 2e-2), "dy": share(dy, ref[1], 2e-2, 2e-2)}
        tight = {"out": share(out, ref[0], **tband.banded_tol(ref[0])),
                 "dy": share(dy, ref[1], **tband.banded_tol(ref[1]))}
    finite = bool(torch.isfinite(out).all() and torch.isfinite(dy).all())
    rec = dict(check=f"{name} {str(y.dtype)[6:]}", share_of_plain=plain, share_of_tight=tight,
               share_of_dt_bound=dt_share, dt=float(dt), dt_plain=float(ref[2]),
               bit_for_bit=same, finite=finite,
               ok=finite and same and _within(plain) and dt_share <= 1 and _within(tight))
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


def moved_bytes(y, offs, bm, st, with_stats, bwd):
    """Bytes the function must move: inputs read once, outputs written once."""
    import torch

    import chip_smoke
    base = chip_smoke.nbytes(y, offs, bm)
    if bwd:   # + g, dy and the statistics read
        return base + 2 * chip_smoke.nbytes(y) + chip_smoke.nbytes(*st)
    if y.dtype == torch.float32:   # the last statistic is out itself
        st = st[:-1]
    return base + chip_smoke.nbytes(y) + (chip_smoke.nbytes(*st) if with_stats else 0)


def run(args, card, dev):
    import torch
    from advmil_tpu_torch.ops import _build
    pkg = _build.CSRC
    trees = {"kernel": pkg}
    others = [d for d in (args.other_csrc or "").split(",") if d]
    base_other = others[0] if others else pkg
    for i, d in enumerate(others):
        trees["other_csrc" if i == 0 else f"other_csrc_{i + 1}"] = d
    wrong = set()
    for name in filter(None, (args.variants or "").split(",")):
        changes, bad = VARIANTS[name]
        trees[name] = patched_tree(name, pkg, changes)
        wrong |= {name} if bad else set()
    for name in filter(None, (args.other_variants or "").split(",")):
        changes, bad = PARENT_VARIANTS[name]
        trees[f"other_{name}"] = patched_tree(f"other_{name}", base_other, changes)
        wrong |= {f"other_{name}"} if bad else set()
    libs = build_all(trees)
    ok = True
    for dtype in ((torch.bfloat16, torch.float32) if args.f32 else (torch.bfloat16,)):
        a = inputs(dev, dtype)
        y, offs, bm, t, gout, part = a
        ref = reference(y, offs, bm, t, gout)
        for name, entry in libs.items():
            if name not in wrong:
                ok = check(name, entry, a, ref)["ok"] and ok
        del ref
        stats = {n: fwd_of(e, y, offs, bm, t)[1] for n, e in libs.items()}
        arms = {}
        for n, e in libs.items():
            arms[f"{n}_fwd"] = lambda e=e: fwd_of(e, y, offs, bm, t)
            arms[f"{n}_fwd_nostats"] = lambda e=e: fwd_of(e, y, offs, bm, t, stats=False)
            arms[f"{n}_bwd"] = lambda e=e, n=n: bwd_of(e, y, offs, bm, t, stats[n], gout, part)
        med = turns(arms, args.reps)
        for n, e in libs.items():
            st = stats[n]
            emit(time=f"{n} B=2 N=16384 epn=9 C=384 {str(dtype)[6:]}", card=card, api=e[1],
                 fwd_ms=med[f"{n}_fwd"], fwd_nostats_ms=med[f"{n}_fwd_nostats"],
                 bwd_ms=med[f"{n}_bwd"],
                 fwd_bound_ms=moved_bytes(y, offs, bm, st, True, False) / 3.35e9,
                 fwd_nostats_bound_ms=moved_bytes(y, offs, bm, st, False, False) / 3.35e9,
                 bwd_bound_ms=moved_bytes(y, offs, bm, st, True, True) / 3.35e9)
        del a, y, gout, stats, arms
    if not ok:
        raise SystemExit("a check failed")


def run_mutants(dev):
    import torch
    from advmil_tpu_torch.ops import _build
    trees = {f"mutant{i}": patched_tree(f"mutant{i}", _build.CSRC, ch)
             for i, ch in enumerate(MUTANTS.values())}
    libs = build_all(trees)
    a = inputs(dev, torch.bfloat16)
    ref = reference(*a[:4], a[4])
    caught_all = True
    for (desc, _), name in zip(MUTANTS.items(), libs):
        rec = check(f"mutant '{desc}'", libs[name], a, ref)
        caught = not (_within(rec["share_of_tight"]) and rec["share_of_dt_bound"] <= 1)
        emit(mutant=desc, caught_by_tight_bound=caught, finite=rec["finite"],
             passes_plain_bound=_within(rec["share_of_plain"]),
             dt_caught=not rec["share_of_dt_bound"] <= 1)
        caught_all = caught_all and caught
    if not caught_all:
        raise SystemExit("a mutant passed banded_tol")


# ---------------------------------------------------------------------------
# --knn: the dense kNN kernels #12 / #13
# ---------------------------------------------------------------------------

def knn_inputs(dev, dtype, C=384, N=16384):
    """Phase 3's messages: y gathered by the dense tables of two tissue
    graphs ([2, N, 9, C]; node 100 of each bag without edges), masked slots
    holding 300.0; the cotangent and t = 1.3."""
    import numpy as np
    import torch

    import chip_smoke
    B, epn = 2, 9
    tabs, _ = chip_smoke._graph_kernel_inputs(B, N, epn, np.random.default_rng(3))
    g = torch.Generator(device=dev).manual_seed(0)
    y = torch.relu(torch.randn(B, N, C, device=dev, generator=g)) + 1e-7
    esrc = torch.from_numpy(tabs["edge_src"]).to(dev).long()
    em = torch.from_numpy(tabs["edge_mask"]).to(dev).float().contiguous()
    msg = y[torch.arange(B, device=dev)[:, None, None], esrc]
    msg = torch.where(em[..., None] > 0, msg, torch.full_like(msg, 300.0)).to(dtype).contiguous()
    gout = torch.randn(B, N, C, device=dev, generator=g).to(dtype)
    t = torch.tensor([1.3], device=dev)
    return msg, em, t, gout


def grid_row_inputs(dev):
    """Phase 37's residual rows, as `chip_smoke.phase_grid_kernels` makes
    them (the same seeds and draws): for each W of `GRID_WIDTHS`, the
    messages of the grid tables' residual rows of two tissue slides gathered
    from y in f32 ([2, U, 9, 384], U = 1,120-1,256), their edge mask (the
    sentinel slots without edges), the cotangent and t = 1.3."""
    import numpy as np
    import torch

    import chip_smoke
    from advmil_tpu_torch.data.synthetic import tissue_grid_tables
    g = torch.Generator(device=dev).manual_seed(37)
    rng = np.random.default_rng(37)
    out = []
    for W, width, height in chip_smoke.GRID_WIDTHS:
        tabs = tissue_grid_tables([(width, height), (width - 2, height - 2)], rng)
        B, grid_n, C = 2, tabs["band_mask"].shape[1], 384
        y32 = torch.relu(torch.randn(B, grid_n, C, device=dev, generator=g)) + 1e-7
        g32 = torch.randn(B, grid_n, C, device=dev, generator=g)
        u_src = torch.from_numpy(tabs["band_usrc"]).to(dev).long()
        u_em = torch.from_numpy(tabs["band_uemask"]).to(dev).float().contiguous()
        U, epn = u_src.shape[1], u_src.shape[2]
        msg = torch.gather(y32, 1, u_src.reshape(B, -1, 1).expand(B, U * epn, C)
                           ).reshape(B, U, epn, C)
        out.append((W, msg, u_em, torch.tensor([1.3], device=dev), g32[:, :U].contiguous()))
    return out


def knn_fwd_of(entry, msg, em, t, fill_nan=False):
    import torch
    from advmil_tpu_torch.ops import _build
    lib = entry[0]
    B, N, epn, C = msg.shape
    out = torch.empty((B, N, C), dtype=msg.dtype, device=msg.device)
    if fill_nan:   # a row the kernel leaves unwritten then shows
        out.fill_(float("nan"))
    rc = lib.advmil_knn_agg_fwd(msg.data_ptr(), em.data_ptr(), t.data_ptr(), out.data_ptr(),
                                B * N, epn, C, _build.DTYPE_CODES[msg.dtype],
                                _build.stream_of(msg))
    if rc != 0:
        raise RuntimeError(f"advmil_knn_agg_fwd: CUDA error {rc}")
    return out


def knn_bwd_of(entry, msg, em, t, g, fill_nan=False):
    """(dm, dt) from a build's backward, its dt partials sized as the
    package's wrapper sizes them (1,024 for the earlier entry point)."""
    import torch
    from advmil_tpu_torch.ops import _build
    lib, api, _ = entry
    B, N, epn, C = msg.shape
    code = _build.DTYPE_CODES[msg.dtype]
    dm = torch.empty_like(msg)
    if fill_nan:   # a value the kernel leaves unwritten then shows
        dm.fill_(float("nan"))
    dt = torch.empty(1, dtype=torch.float32, device=msg.device)
    n_part = lib.advmil_knn_agg_bwd_blocks(B * N, C, code) if api == "knn" else 1024
    part = torch.empty(n_part, dtype=torch.float32, device=msg.device)
    ptrs = [msg.data_ptr(), em.data_ptr(), t.data_ptr(), g.data_ptr(), dm.data_ptr(),
            part.data_ptr()] + ([n_part] if api == "knn" else [])
    rc = lib.advmil_knn_agg_bwd(*ptrs, dt.data_ptr(), B * N, epn, C, code,
                                _build.stream_of(msg))
    if rc != 0:
        raise RuntimeError(f"advmil_knn_agg_bwd: CUDA error {rc}")
    return dm, dt


def knn_check(name, entry, args):
    """#12 / #13 against the plain version and its autograd backward:
    shares of the plain bound and of `knn_tol` / `knn_bwd_tol` (bf16) or of
    1e-5 (f32), dt within 1e-4 relative, two backward calls bit for bit, a
    node without edges and every masked slot exactly 0."""
    import torch

    import chip_smoke
    from advmil_tpu_torch.ops import segment as tseg
    msg, em, t, gout = args
    out = knn_fwd_of(entry, msg, em, t, fill_nan=True)
    dm, dt = knn_bwd_of(entry, msg, em, t, gout, fill_nan=True)
    dm2, dt2 = knn_bwd_of(entry, msg, em, t, gout)
    leaves = [msg.detach().clone().requires_grad_(True), t.clone().requires_grad_(True)]
    want = tseg.knn_edge_softmax_aggregate(leaves[0], em, leaves[1])
    want_dm, want_dt = torch.autograd.grad(want, leaves, gout)
    want = want.detach()
    torch.cuda.synchronize()
    share = chip_smoke.share_of
    if msg.dtype == torch.float32:
        plain = {"out": share(out, want, 1e-5, 0.0), "dm": share(dm, want_dm, 1e-5, 0.0)}
        tight = {}
    else:
        plain = {"out": share(out, want, 2e-2, 2e-2), "dm": share(dm, want_dm, 2e-2, 2e-2)}
        tight = {"out": share(out, want, **tseg.knn_tol(want)),
                 "dm": share(dm, want_dm, **tseg.knn_bwd_tol(want_dm))}
    dt_share = float((dt - want_dt).abs() / (1e-4 * want_dt.abs()))
    zero = bool((out[em.sum(-1) == 0] == 0).all() and (dm[em == 0] == 0).all())
    same = bool(torch.equal(dm, dm2) and torch.equal(dt, dt2))
    finite = bool(torch.isfinite(out).all() and torch.isfinite(dm).all()
                  and torch.isfinite(dt).all())
    rec = dict(check=f"{name} {'x'.join(map(str, msg.shape))} {str(msg.dtype)[6:]}",
               share_of_plain=plain, share_of_tight=tight, share_of_dt_bound=dt_share,
               dt=float(dt), dt_plain=float(want_dt), empty_and_masked_zero=zero,
               bit_for_bit=same, finite=finite,
               ok=finite and same and zero and _within(plain) and dt_share <= 1
               and _within(tight))
    emit(**rec)
    return rec


def _within(shares):
    """Every share <= 1 (NaN compares false, so a NaN share is outside)."""
    return all(v <= 1 for v in shares.values())


def run_knn(args, card, dev):
    import torch
    from advmil_tpu_torch.ops import _build
    pkg = _build.CSRC
    trees = {} if args.only_other else {"kernel": pkg}
    others = [d for d in (args.other_csrc or "").split(",") if d]
    base_other = others[0] if others else pkg
    for i, d in enumerate(others):
        trees["other_csrc" if i == 0 else f"other_csrc_{i + 1}"] = d
    wrong = set()
    for name in filter(None, (args.variants or "").split(",")):
        changes, bad = KNN_VARIANTS[name]
        trees[name] = patched_tree(name, pkg, changes, "knn_agg.cu")
        wrong |= {name} if bad else set()
    for name in filter(None, (args.other_variants or "").split(",")):
        changes, bad = KNN_PARENT_VARIANTS[name]
        trees[f"other_{name}"] = patched_tree(f"other_{name}", base_other, changes, "knn_agg.cu")
        wrong |= {f"other_{name}"} if bad else set()
    libs = build_all(trees, "knn_agg.cu")
    shapes = [(f"phase 3 B=2 N=16384 epn=9 C=384 {str(dt)[6:]}", lambda dt=dt: knn_inputs(dev, dt))
              for dt in (torch.float32, torch.bfloat16)]
    rows = grid_row_inputs(dev)
    shapes += [(f"phase 37 residual rows W~{W} B=2 U={m.shape[1]} epn=9 C=384 {str(dt)[6:]}",
                lambda m=m, e=e, t=t, g=g, dt=dt: (m.to(dt), e, t, g.to(dt)))
               for dt in (torch.float32, torch.bfloat16) for W, m, e, t, g in rows]
    ok = True
    for tag, make in shapes:
        a = make()
        msg, em, t, gout = a
        for name, entry in libs.items():
            if name not in wrong:
                ok = knn_check(name, entry, a)["ok"] and ok
        arms = {}
        for n, e in libs.items():
            arms[f"{n}_fwd"] = lambda e=e: knn_fwd_of(e, msg, em, t)
            arms[f"{n}_bwd"] = lambda e=e: knn_bwd_of(e, msg, em, t, gout)
        med = turns(arms, args.reps)
        out_b = msg.numel() // msg.shape[2] * msg.element_size()
        fwd_bytes = msg.numel() * msg.element_size() + em.numel() * 4 + out_b
        bwd_bytes = 2 * msg.numel() * msg.element_size() + em.numel() * 4 + out_b
        for n in libs:
            emit(time=f"{n} knn {tag}", card=card, fwd_ms=med[f"{n}_fwd"],
                 bwd_ms=med[f"{n}_bwd"], fwd_bound_ms=fwd_bytes / 3.35e9,
                 bwd_bound_ms=bwd_bytes / 3.35e9,
                 bwd_share_of_bound=bwd_bytes / 3.35e9 / med[f"{n}_bwd"])
        del a, msg, gout, arms
    if not ok:
        raise SystemExit("a check failed")


def run_knn_mutants(dev):
    import torch
    from advmil_tpu_torch.ops import _build
    trees = {f"mutant{i}": patched_tree(f"mutant{i}", _build.CSRC, ch, "knn_agg.cu")
             for i, ch in enumerate(KNN_MUTANTS.values())}
    libs = build_all(trees, "knn_agg.cu")
    shapes = [knn_inputs(dev, torch.bfloat16), knn_inputs(dev, torch.bfloat16, C=38, N=4096)]
    caught_all = True
    for (desc, _), name in zip(KNN_MUTANTS.items(), libs):
        recs = [knn_check(f"mutant '{desc}'", libs[name], a) for a in shapes]
        caught = any(not (_within(r["share_of_tight"]) and r["share_of_dt_bound"] <= 1)
                     for r in recs)
        emit(mutant=desc, caught_by_tight_bound=caught,
             dt_caught=any(not r["share_of_dt_bound"] <= 1 for r in recs),
             passes_plain_bound=all(_within(r["share_of_plain"]) for r in recs))
        caught_all = caught_all and caught
    if not caught_all:
        raise SystemExit("a mutant passed knn_tol / knn_bwd_tol / the dt bound")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other-csrc", help="other csrc trees (comma-separated), built and timed "
                                         "in the same turns")
    ap.add_argument("--variants", help="comma-separated names of VARIANTS")
    ap.add_argument("--other-variants", help="comma-separated names of PARENT_VARIANTS, applied "
                                             "to --other-csrc (or the package's sources)")
    ap.add_argument("--mutants", action="store_true", help="build the faulty kernels")
    ap.add_argument("--knn", action="store_true", help="the dense kNN kernels #12 / #13")
    ap.add_argument("--only-other", action="store_true",
                    help="--knn: time the other builds alone, not the package's")
    ap.add_argument("--f32", action="store_true", help="also check and time f32")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    import chip_smoke
    card = chip_smoke.phase_device()
    dev = torch.device("cuda")
    os.makedirs(OUT_DIR, exist_ok=True)
    try:
        if args.knn:
            run_knn_mutants(dev) if args.mutants else run_knn(args, card, dev)
        elif args.mutants:
            run_mutants(dev)
        else:
            run(args, card, dev)
    finally:
        name = "profile_graph_agg_knn.jsonl" if args.knn else "profile_graph_agg.jsonl"
        with open(osp.join(OUT_DIR, name), "w") as f:
            for rec in OUT:
                f.write(json.dumps(rec) + "\n")
        shutil.rmtree(BUILD_ROOT, ignore_errors=True)


if __name__ == "__main__":
    main()
