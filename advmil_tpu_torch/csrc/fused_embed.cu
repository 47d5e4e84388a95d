// Fused region patch embedding: Dense -> LayerNorm -> ReLU -> 16-row region
// mean in one kernel, and its backward.
//
// Replaces the Pallas TPU kernels of advmil_tpu/ops/fused_embed.py:
//   _fwd_kernel          out[r] = mean_{16 rows} relu(LN(x W + b) * scale + bias)
//   _bwd_dparams_kernel  dW = x^T dh, db = sum dh, dscale = sum gy * xhat, dbias = sum gy
//   _bwd_dx_kernel       dx = dh W^T
// for x [M, K] (f32 or bf16, M % 16 == 0), W [K, D] f32 rounded to x's type
// for the product, f32 accumulation, h = x W + b kept in f32 (never rounded),
// LN statistics in f32 with eps inside the rsqrt.
//
// Every matrix product is a hand-written kernel: the f32 ones here, true f32
// on the CUDA cores (no TF32, which keeps 10 bits of the mantissa); the bf16
// ones on the warpgroup tensor cores (wgmma + TMA, csrc/wgmma.cuh): the row
// kernel of the forward and of dh in fused_embed_rows.cu, dW = x^T dh in
// fused_embed_dw.cu, dx = dh W^T in fused_embed_dx.cu. No library GEMM is
// called. This file holds the f32 kernels, the ordered sums and the C entry
// points.
//
// What bounds the f32 kernels on the card (M = 32,768, K = 1,024, D = 384):
// the forward does 25.8 GFLOP, 385 us at the 67 TFLOP/s of the CUDA cores
// (its 151 MB take 45 us at 3.35 TB/s); the backward of the parameters does
// two products (recompute h, then x^T dh), dx one more. So the FFMA issue
// rate is the roof, and what keeps a product from it is every instruction
// beside the FFMAs: shared-memory loads first.
//
// Design of the f32 kernels: register-blocked products. Each thread holds a
// two-dimensional tile of accumulators and, per reduction step, loads its
// operands from shared memory 16 bytes at a time, a step ahead of their use:
// a value of W, dh or dx's operands feeds 8 FMAs, one of x 12 (4 at D <=
// 128), and a loop issues one shared load for every 10 (D <= 128) to 19 FFMA.
// - The row kernel (#9, and the dh half of #11): LN needs a whole row of h,
//   so one block owns 64 full rows; 8 warps, 2 down the rows and 4 across D.
//   A thread holds 8 rows (lr + 4 i of its warp's 32) x NJ groups of 4
//   adjacent columns, group j at column 32 (wc + 4 j) + 4 lc (lane = 8 lr +
//   lc): 96 accumulators at D = 384 (NJ = 3), under the 255 registers that
//   256 threads a block leave. x's tile stays row-major in shared memory (a
//   float4 holds 4 reduction steps of one row; rows 144 bytes apart, so the
//   4 rows one load instruction reads lie in 4 bank groups), W's k-major (8
//   lanes read 128 contiguous bytes). The LN statistics are two passes
//   (mean, then the centred square): a shuffle over the 8 lanes of a row,
//   then the 4 warps across D add their partials from shared memory in a
//   fixed order. The ReLU, the 16-row region mean (the 4 lanes lr of a
//   column hold its 16 rows) or, backward, dh and the per-block partials of
//   db / dscale / dbias run from registers. D <= 128 takes NJ = 1 (4 warps x
//   32 columns), other D NJ = 3 with the groups beyond D idle.
// - The product C = A B (#11's dW = x^T dh, and #10's dx = dh W^T): 128 x
//   128 output tiles, 256 threads of 8 x 8. An operand that is k-major in
//   device memory (both of dW) stays so in shared memory and a thread reads
//   two float4 of it per step (8 adjacent values in two runs of 4, 64 apart);
//   one that is k-contiguous (both of dx) stays row-major and a thread reads
//   4 steps of a row as one float4, its 8 rows or columns 16 apart (16 lanes
//   on 16 consecutive rows: every bank group twice, the least for 256 bytes).
// - The TPU backward carried dW [K, D] in scratch across its sequential grid
//   and recomputed h in both kernels. Here blocks run in any order, so the
//   row kernel runs once more in backward mode and writes dh [M, D] (in x's
//   type: traffic the TPU kernels avoided by recomputing twice) with
//   per-block partials of db / dscale / dbias; the product then forms dW =
//   x^T dh split over M into a fixed number of slabs, and dx = dh W^T reads
//   the same dh only when x needs a gradient.
// - No atomics: per-block and per-slab partials are summed by a last pass
//   in a fixed order, so the gradients are the same from run to run.
// - Tiles reach shared memory through cp.async (16 bytes a thread, zero fill
//   beyond the ragged edge) in a ring of 3 stages, one barrier per chunk, so
//   the loads of two chunks are in flight while one is multiplied.
// - Rows beyond M in the last block are zero-filled: h = b there, finite, and
//   they write nothing; an all-zero x row has var = 0 and rsqrt(0 + eps) is
//   finite, so a zero cotangent never meets a NaN.
#include "common.cuh"

namespace advmil {
namespace fe {

constexpr int kBK = 32;           // reduction chunk
constexpr int kRegion = 16;
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kRowThreads = 256;  // the row kernel: 8 warps, 2 down x 4 across D
constexpr int kRowsBM = 64;       // rows of x per block of the row kernel
constexpr int kWgmmaRowsBM = 128; // rows per block of the bf16 row kernel (fused_embed_rows.cu)
constexpr int kRowLdA = kBK + 4;  // x's shared rows: 144 bytes apart
constexpr int kThreads = 256;     // the product: 16 x 16 threads of 8 x 8
constexpr int kGM = 128;          // its output tile
constexpr int kGN = 128;
constexpr int kTargetBlocks = 264;  // blocks the dW product is split into (2 x 132 SMs)

// 16 bytes from device memory to shared memory without passing registers;
// with ok false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of a ROWS x COLS tile from device memory into shared memory,
// 16 bytes at a time, the same number of pieces for each of the THREADS
// threads (a constant count, so the loop unrolls and its offsets stay in
// registers from chunk to chunk); elements at or beyond (row_lim, col_lim) are
// zero-filled and not read. All addresses are 16-byte aligned: the wrappers
// check the bases, and every stride is a multiple of 4 elements.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, int dst_ld, const float* src, size_t src_ld,
                                          int row_lim, int col_lim) {
  constexpr int CV = COLS / 4;
  static_assert(ROWS * CV % THREADS == 0, "a tile's pieces must divide among the threads");
#pragma unroll
  for (int n = 0; n < ROWS * CV / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS;
    const int r = i / CV;
    const int c = (i - r * CV) * 4;
    const bool ok = r < row_lim && c < col_lim;
    cp_async16(dst + r * dst_ld + c, ok ? src + static_cast<size_t>(r) * src_ld + c : src, ok);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& v, int s) {  // s is a constant after unrolling
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}
__device__ __forceinline__ float& at(float4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// The row kernel (f32): h = x W + b for 64 rows, then the forward or the
// backward epilogue.
// ---------------------------------------------------------------------------

// Shared memory of the row kernel, in floats: a ring of kStages (x tile [64]
// [kRowLdA], W tile [kBK][WP]) stages, WP = 128 NJ the columns the block's
// groups span; then the epilogue's operands: scale, bias, b and, backward,
// the cotangent rows of the block's 4 regions already divided by 16; then
// the row statistics' exchange (mean, centred square, and backward the two
// means of dh's formula: 4 warps across D x 64 rows each). Backward, the
// column sums of the two warps down the rows meet over the idle ring.
struct RowSmem {
  int off_b, stage, off_p, off_red, floats;
};

__host__ __device__ inline RowSmem row_smem(int wp, bool bwd) {
  RowSmem s;
  s.off_b = kRowsBM * kRowLdA;
  s.stage = s.off_b + kBK * wp;
  s.off_p = kStages * s.stage;
  s.off_red = s.off_p + (bwd ? 3 + kRowsBM / kRegion : 3) * wp;
  s.floats = s.off_red + (bwd ? 4 : 2) * 4 * kRowsBM;
  return s;
}

// The full sums of the thread's 8 rows: its own columns' partials `v` are
// added over the 8 lanes of each row, then over the 4 warps across D in
// warp order through `red` (every lane of a row gets the same bits).
__device__ __forceinline__ void row_sums(float (&v)[8], float* red, int wr, int wc, int lr,
                                         int lc) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] += __shfl_xor_sync(0xffffffffu, v[i], 1);
    v[i] += __shfl_xor_sync(0xffffffffu, v[i], 2);
    v[i] += __shfl_xor_sync(0xffffffffu, v[i], 4);
  }
  const int r0 = 32 * wr + lr;
  if (lc == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red[wc * kRowsBM + r0 + 4 * i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + 4 * i;
    v[i] = ((red[r] + red[kRowsBM + r]) + red[2 * kRowsBM + r]) + red[3 * kRowsBM + r];
  }
}

// The sum of a float4 over the 4 lanes lr that share the lane's columns.
__device__ __forceinline__ void sum_over_lr(float4& v) {
#pragma unroll
  for (int o = 8; o <= 16; o <<= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    v.z += __shfl_xor_sync(0xffffffffu, v.z, o);
    v.w += __shfl_xor_sync(0xffffffffu, v.w, o);
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <int NJ, bool BWD>
__global__ void __launch_bounds__(kRowThreads, 1)
fused_rows_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, const float* __restrict__ scale,
                  const float* __restrict__ bias, const float* __restrict__ g,
                  float* __restrict__ out, float* __restrict__ partials, int M, int K, int D,
                  float eps) {
  constexpr int WP = 128 * NJ;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const RowSmem lay = row_smem(WP, BWD);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;    // warp row (32 rows), warp column
  const int lr = lane >> 3, lc = lane & 7;    // lane row (rows lr + 4 i), lane column
  const int row0 = blockIdx.x * kRowsBM;
  const int nk = K / kBK;
  const float inv_d = 1.f / static_cast<float>(D);
  auto stage_a = [&](int kt) { return smem + (kt % kStages) * lay.stage; };
  // chunk kt of x and W into its ring slot (W's columns beyond D zero-filled);
  // always one commit, so that the group count stays the chunk count
  auto prefetch = [&](int kt) {
    if (kt < nk) {
      float* As = stage_a(kt);
      load_tile<kRowsBM, kBK, kRowThreads>(As, kRowLdA, x + static_cast<size_t>(row0) * K +
                                           kt * kBK, K, M - row0, K - kt * kBK);
      load_tile<kBK, WP, kRowThreads>(As + lay.off_b, WP, w + static_cast<size_t>(kt) * kBK * D,
                                      D, K - kt * kBK, D);
    }
    cp_async_commit();
  };
  // chunk kt has landed for every thread, and every thread is done with chunk
  // kt - 1, whose slot the next prefetch overwrites
  auto advance = [&](int kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    prefetch(kt + kStages - 1);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) prefetch(st);
  // the epilogue's operands; the main loop's barriers come before their use
  float* Ps = smem + lay.off_p;
  for (int c = threadIdx.x; c < D; c += kRowThreads) {
    Ps[c] = scale[c];
    Ps[WP + c] = bias[c];
    Ps[2 * WP + c] = b[c];
  }
  if (BWD) {
    const int regions = M / kRegion;
    for (int idx = threadIdx.x; idx < (kRowsBM / kRegion) * D; idx += kRowThreads) {
      const int r = idx / D, c = idx - r * D;
      const int region = blockIdx.x * (kRowsBM / kRegion) + r;
      Ps[(3 + r) * WP + c] =
          region < regions ? g[static_cast<size_t>(region) * D + c] * (1.f / kRegion) : 0.f;
    }
  }

  // acc[i][j]: row 32 wr + lr + 4 i, columns col(j) .. + 3
  auto col = [&](int j) { return 32 * (wc + 4 * j) + 4 * lc; };
  float4 acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kt = 0; kt < nk; ++kt) {
    advance(kt);
    const float* arow = stage_a(kt) + (32 * wr + lr) * kRowLdA;
    const float* bcol = stage_a(kt) + lay.off_b + col(0);
    // operands in registers one step ahead: x's float4 of 4 steps a group
    // of 4 ahead, W's row one step ahead, so that each step's loads are in
    // flight while the step before it issues its FMAs
    float4 a[8], bv[NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = ld4(arow + 4 * i * kRowLdA);
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = ld4(bcol + 128 * j);
#pragma unroll
    for (int kq = 0; kq < kBK; kq += 4) {
      float4 an[8];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int kn = kq + s + 1;
        float4 bn[NJ];
        if (kn < kBK) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) bn[j] = ld4(bcol + kn * WP + 128 * j);
        }
        if (s == 0 && kq + 4 < kBK) {
#pragma unroll
          for (int i = 0; i < 8; ++i) an[i] = ld4(arow + 4 * i * kRowLdA + kq + 4);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = at(a[i], s);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            acc[i][j].x = fmaf(av, bv[j].x, acc[i][j].x);
            acc[i][j].y = fmaf(av, bv[j].y, acc[i][j].y);
            acc[i][j].z = fmaf(av, bv[j].z, acc[i][j].z);
            acc[i][j].w = fmaf(av, bv[j].w, acc[i][j].w);
          }
        }
        if (kn < kBK) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) bv[j] = bn[j];
        }
      }
      if (kq + 4 < kBK) {
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = an[i];
      }
    }
  }
  cp_async_wait<0>();

  // h = acc + b, then the row statistics; groups at or beyond D take no part
  float* red = smem + lay.off_red;
  bool live[NJ];
  float mu[8], inv[8];
#pragma unroll
  for (int j = 0; j < NJ; ++j) live[j] = 32 * (wc + 4 * j) < D;
#pragma unroll
  for (int i = 0; i < 8; ++i) mu[i] = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (live[j]) {
      const float4 bj = ld4(Ps + 2 * WP + col(j));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        add4(acc[i][j], bj);
        mu[i] += (acc[i][j].x + acc[i][j].y) + (acc[i][j].z + acc[i][j].w);
      }
    }
  }
  row_sums(mu, red, wr, wc, lr, lc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mu[i] *= inv_d;
    inv[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (live[j]) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dx = acc[i][j].x - mu[i], dy = acc[i][j].y - mu[i];
        const float dz = acc[i][j].z - mu[i], dw = acc[i][j].w - mu[i];
        inv[i] += (dx * dx + dy * dy) + (dz * dz + dw * dw);
      }
    }
  }
  row_sums(inv, red + 4 * kRowsBM, wr, wc, lr, lc);
#pragma unroll
  for (int i = 0; i < 8; ++i) inv[i] = rsqrtf(inv[i] * inv_d + eps);

  const int regions = M / kRegion;
  const int region0 = blockIdx.x * (kRowsBM / kRegion) + 2 * wr;  // rows i < 4; i >= 4: + 1
  if constexpr (!BWD) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (live[j]) {
        const float4 sc = ld4(Ps + col(j)), bi = ld4(Ps + WP + col(j));
        float4 rs[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int s = 0; s < 4; ++s)
            at(rs[i >> 2], s) +=
                fmaxf((at(acc[i][j], s) - mu[i]) * inv[i] * at(sc, s) + at(bi, s), 0.f);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum_over_lr(rs[h]);
          if (lr == 0 && region0 + h < regions)
            *reinterpret_cast<float4*>(out + static_cast<size_t>(region0 + h) * D + col(j)) =
                make_float4(rs[h].x * (1.f / kRegion), rs[h].y * (1.f / kRegion),
                            rs[h].z * (1.f / kRegion), rs[h].w * (1.f / kRegion));
        }
      }
    }
  } else {
    // gy = g / 16 where y > 0; dscale += gy xhat, dbias += gy; gx = gy scale;
    // dh = inv (gx - mean(gx) - xhat mean(gx xhat)); db += dh
    float4 sums[3][NJ];   // db, dscale, dbias of the thread's 8 rows
    float m1[8], m2[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) m1[i] = m2[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int q = 0; q < 3; ++q) sums[q][j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live[j]) {
        const float4 sc = ld4(Ps + col(j)), bi = ld4(Ps + WP + col(j));
        const float4 gr[2] = {ld4(Ps + (3 + 2 * wr) * WP + col(j)),
                              ld4(Ps + (4 + 2 * wr) * WP + col(j))};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float xh = (at(acc[i][j], s) - mu[i]) * inv[i];
            const float gy = xh * at(sc, s) + at(bi, s) > 0.f ? at(gr[i >> 2], s) : 0.f;
            at(sums[1][j], s) += gy * xh;
            at(sums[2][j], s) += gy;
            const float gx = gy * at(sc, s);
            m1[i] += gx;
            m2[i] += gx * xh;
            at(acc[i][j], s) = xh;
          }
        }
      }
    }
    row_sums(m1, red + 8 * kRowsBM, wr, wc, lr, lc);
    row_sums(m2, red + 12 * kRowsBM, wr, wc, lr, lc);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (live[j]) {
        const float4 sc = ld4(Ps + col(j)), bi = ld4(Ps + WP + col(j));
        const float4 gr[2] = {ld4(Ps + (3 + 2 * wr) * WP + col(j)),
                              ld4(Ps + (4 + 2 * wr) * WP + col(j))};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float4 d;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            // gy again from its definition: cheaper than keeping gx in registers
            const float xh = at(acc[i][j], s);
            const float gy = xh * at(sc, s) + at(bi, s) > 0.f ? at(gr[i >> 2], s) : 0.f;
            at(d, s) = inv[i] * (gy * at(sc, s) - m1[i] * inv_d - xh * (m2[i] * inv_d));
          }
          add4(sums[0][j], d);    // db, from the unrounded dh
          const int row = row0 + 32 * wr + lr + 4 * i;
          if (row < M) *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * D + col(j)) = d;
        }
      }
    }
    // the block's partials: the 4 lanes lr, then warp row 1 onto warp row 0,
    // over the idle ring (the row statistics' barriers come after every
    // thread's last read of it)
    float* Rs = smem;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 3; ++q) sum_over_lr(sums[q][j]);
    if (wr == 1 && lr == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (live[j])
#pragma unroll
          for (int q = 0; q < 3; ++q) *reinterpret_cast<float4*>(Rs + q * WP + col(j)) = sums[q][j];
    }
    __syncthreads();
    if (wr == 0 && lr == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (live[j]) {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            float4 p = sums[q][j];
            add4(p, ld4(Rs + q * WP + col(j)));
            *reinterpret_cast<float4*>(partials + (static_cast<size_t>(blockIdx.x) * 3 + q) * D +
                                       col(j)) = p;
          }
        }
      }
    }
  }
}

// out[c] = sum over rows of part[r, c], rows added in a fixed order: 8 row
// lanes stride over the rows, then their sums are added in lane order.
__global__ void sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out,
                                int nrows, int ncols) {
  __shared__ float red[8][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f;
  if (c < ncols)
    for (int r = threadIdx.y; r < nrows; r += 8) a += part[static_cast<size_t>(r) * ncols + c];
  red[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && c < ncols) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += red[k][threadIdx.x];
    out[c] = s;
  }
}

inline cudaError_t sum_rows(const float* part, float* out, int nrows, int ncols,
                            cudaStream_t stream) {
  sum_rows_kernel<<<(ncols + 31) / 32, dim3(32, 8), 0, stream>>>(part, out, nrows, ncols);
  return cudaGetLastError();
}

template <int NJ, bool BWD>
cudaError_t launch_rows_nj(const void* x, const void* w, const void* b, const void* scale,
                           const void* bias, const void* g, void* out, void* partials, int M,
                           int K, int D, float eps, cudaStream_t stream) {
  const int bytes = row_smem(128 * NJ, BWD).floats * 4;
  auto kernel = fused_rows_kernel<NJ, BWD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (M + kRowsBM - 1) / kRowsBM;
  kernel<<<blocks, kRowThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(g), static_cast<float*>(out), static_cast<float*>(partials), M,
      K, D, eps);
  return cudaGetLastError();
}

template <bool BWD>
cudaError_t launch_rows(const void* x, const void* w, const void* b, const void* scale,
                        const void* bias, const void* g, void* out, void* partials, int M,
                        int K, int D, float eps, cudaStream_t stream) {
  if (D <= 128)
    return launch_rows_nj<1, BWD>(x, w, b, scale, bias, g, out, partials, M, K, D, eps, stream);
  return launch_rows_nj<3, BWD>(x, w, b, scale, bias, g, out, partials, M, K, D, eps, stream);
}

// ---------------------------------------------------------------------------
// The f32 product C[m, n] = sum_k a(m, k) b(k, n) for dW and dx: 128 x 128
// output tiles (64-wide ones move 1.5 times the bytes from L2 for the same
// product), the reduction walked in chunks of 32, optionally split into
// slabs (blockIdx.z) that each write their own partial C.
// A_COL: a(m, k) = A[k * lda + m] (k-major), else A[m * lda + k];
// B_COL: b(k, n) = B[n * ldb + k], else B[k * ldb + n] (k-major).
// ---------------------------------------------------------------------------

// A thread's 8 indices (rows of C, or columns) within a tile, t its 16-way
// thread coordinate: in a k-major tile 4 t .. 4 t + 3 and 64 + 4 t .., else
// t + 16 i.
__device__ __forceinline__ int tile_index(bool kmajor, int t, int i) {
  return kmajor ? 4 * t + (i & 3) + 64 * (i >> 2) : t + 16 * i;
}

// The thread's 8 values for the reduction steps kq .. kq + 3 of a shared
// tile: k-major, tile[k * ld + index]: two float4 a step; else
// tile[index * ld + k]: one float4 (4 steps) an index.
template <bool KMAJOR>
__device__ __forceinline__ void frag8(const float* tile, int ld, int kq, int t,
                                      float (&f)[4][8]) {
  if constexpr (KMAJOR) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float4 lo = ld4(tile + (kq + s) * ld + 4 * t);
      const float4 hi = ld4(tile + (kq + s) * ld + 64 + 4 * t);
      f[s][0] = lo.x, f[s][1] = lo.y, f[s][2] = lo.z, f[s][3] = lo.w;
      f[s][4] = hi.x, f[s][5] = hi.y, f[s][6] = hi.z, f[s][7] = hi.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v = ld4(tile + (t + 16 * i) * ld + kq);
      f[0][i] = v.x, f[1][i] = v.y, f[2][i] = v.z, f[3][i] = v.w;
    }
  }
}

// shared floats of one operand tile: the larger of its two layouts
constexpr int kTileK = kBK * (kGM + 4);     // k-major: [kBK][128 + 4]
constexpr int kTileR = kGM * (kBK + 4);     // row-major: [128][kBK + 4]
constexpr int kTileFloats = kTileK > kTileR ? kTileK : kTileR;
constexpr int kGemmSmemBytes = kStages * 2 * kTileFloats * 4;  // kStages x (A, B)

template <bool A_COL, bool B_COL>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tile_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                 int Mc, int Nc, int Kr, size_t lda, size_t ldb, int slab_len) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  constexpr bool A_K = A_COL, B_K = !B_COL;   // which operands are k-major
  constexpr int sa_ld = A_K ? kGM + 4 : kBK + 4;
  constexpr int sb_ld = B_K ? kGN + 4 : kBK + 4;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int kbeg = blockIdx.z * slab_len;
  const int kend = min(Kr, kbeg + slab_len);
  C += static_cast<size_t>(blockIdx.z) * Mc * Nc;

  const int nk = (kend - kbeg + kBK - 1) / kBK;
  auto stage_a = [&](int kt) { return smem + (kt % kStages) * 2 * kTileFloats; };
  auto prefetch = [&](int kt) {   // always one commit: the group count is the chunk count
    if (kt < nk) {
      float* As = stage_a(kt);
      float* Bs = As + kTileFloats;
      const int k0 = kbeg + kt * kBK;
      if constexpr (A_K)
        load_tile<kBK, kGM, kThreads>(As, sa_ld, A + static_cast<size_t>(k0) * lda + m0, lda,
                                      kend - k0, Mc - m0);
      else
        load_tile<kGM, kBK, kThreads>(As, sa_ld, A + static_cast<size_t>(m0) * lda + k0, lda,
                                      Mc - m0, kend - k0);
      if constexpr (B_K)
        load_tile<kBK, kGN, kThreads>(Bs, sb_ld, B + static_cast<size_t>(k0) * ldb + n0, ldb,
                                      kend - k0, Nc - n0);
      else
        load_tile<kGN, kBK, kThreads>(Bs, sb_ld, B + static_cast<size_t>(n0) * ldb + k0, ldb,
                                      Nc - n0, kend - k0);
    }
    cp_async_commit();
  };
  auto advance = [&](int kt) {    // see the row kernel
    cp_async_wait<kStages - 2>();
    __syncthreads();
    prefetch(kt + kStages - 1);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) prefetch(st);

  // acc[i][c]: row tile_index(A_K, ty, i), column tile_index(B_K, tx, c)
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    advance(kt);
    const float* As = stage_a(kt);
    const float* Bs = As + kTileFloats;
    // the operands of 4 steps in registers, the next 4 loading while these
    // 4 issue their FMAs
    float a[4][8], bv[4][8];
    frag8<A_K>(As, sa_ld, 0, ty, a);
    frag8<B_K>(Bs, sb_ld, 0, tx, bv);
#pragma unroll
    for (int kq = 0; kq < kBK; kq += 4) {
      float an[4][8], bn[4][8];
      if (kq + 4 < kBK) {
        frag8<A_K>(As, sa_ld, kq + 4, ty, an);
        frag8<B_K>(Bs, sb_ld, kq + 4, tx, bn);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[s][i], bv[s][c], acc[i][c]);
      if (kq + 4 < kBK) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int i = 0; i < 8; ++i) a[s][i] = an[s][i], bv[s][i] = bn[s][i];
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tile_index(A_K, ty, i);
    if (m >= Mc) continue;
    float* crow = C + static_cast<size_t>(m) * Nc + n0;
    if constexpr (B_K) {
      // columns 4 tx .. + 3 and 64 + 4 tx ..: Nc % 4 == 0, so a float4 is all in or all out
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (n0 + 64 * h + 4 * tx < Nc)
          *reinterpret_cast<float4*>(crow + 64 * h + 4 * tx) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (n0 + tx + 16 * c < Nc) crow[tx + 16 * c] = acc[i][c];
    }
  }
}

// Slabs the f32 dW product is split into over M: enough blocks to fill the card,
// a function of the shapes alone (so the sum's order never changes).
__host__ inline void dw_split(int M, int K, int D, int* slabs, int* slab_len) {
  const int tiles = ((K + kGM - 1) / kGM) * ((D + kGN - 1) / kGN);
  int s = (kTargetBlocks + tiles - 1) / tiles;
  const int most = (M + 255) / 256;
  if (s > most) s = most;
  if (s < 1) s = 1;
  int len = (M + s - 1) / s;
  len = (len + kBK - 1) / kBK * kBK;
  *slab_len = len;
  *slabs = (M + len - 1) / len;
}

// dW [K, D] = x^T dh in f32 (into `out`, or slabs of partials; see dw_split):
// a(m = column of x, k = row) = x[row * K + m].
cudaError_t launch_dw(const void* x, const void* dh, float* out, int M, int K, int D,
                      int slab_len, int slabs, cudaStream_t stream) {
  auto kernel = gemm_tile_kernel<true, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kGemmSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((D + kGN - 1) / kGN, (K + kGM - 1) / kGM, slabs);
  kernel<<<grid, kThreads, kGemmSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dh), out, K, D, M,
      static_cast<size_t>(K), static_cast<size_t>(D), slab_len);
  return cudaGetLastError();
}

// dx [M, K] = dh W^T in f32: b(k = column of dh, n = row of W) = W[n * D + k].
cudaError_t launch_dx(const void* dh, const void* w, void* dx, int M, int K, int D,
                      cudaStream_t stream) {
  auto kernel = gemm_tile_kernel<false, true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kGemmSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((K + kGN - 1) / kGN, (M + kGM - 1) / kGM, 1);
  kernel<<<grid, kThreads, kGemmSmemBytes, stream>>>(
      static_cast<const float*>(dh), static_cast<const float*>(w), static_cast<float*>(dx), M, K,
      D, static_cast<size_t>(D), static_cast<size_t>(D), D);
  return cudaGetLastError();
}

// The bf16 kernels, on wgmma + TMA: the row kernel (forward, or dh and the
// blocks' partials of db / dscale / dbias; fused_embed_rows.cu), dW = x^T dh
// in slabs (fused_embed_dw.cu) and dx = dh W^T (fused_embed_dx.cu).
cudaError_t rows_wgmma(const void* x, const void* wt, const void* b, const void* scale,
                       const void* bias, const void* g, void* out, void* partials, int M,
                       int K, int D, float eps, bool bwd, cudaStream_t stream);
void dw_wgmma_split(int M, int K, int D, int* slabs, int* slab_len);
cudaError_t dw_wgmma(const void* x, const void* dh, float* out, int M, int K, int D,
                     int slab_len, int slabs, cudaStream_t stream);
cudaError_t dx_wgmma(const void* dh, const void* w, void* dx, int M, int K, int D,
                     cudaStream_t stream);

// The slabs of the dW product for these shapes and dtype (a function of them
// alone, so the order of its sums never changes).
inline void dw_slabs(int M, int K, int D, int dtype, int* slabs, int* slab_len) {
  if (dtype == kBF16) dw_wgmma_split(M, K, D, slabs, slab_len);
  else dw_split(M, K, D, slabs, slab_len);
}

}  // namespace fe
}  // namespace advmil

// Shape limits of every entry point (checked by the Python wrapper): M % 16
// == 0, M > 0, K % 32 == 0, D % 32 == 0, 32 <= D <= 384; x, dh, dx and w (W
// rounded to x's type by the caller) in one dtype (f32 or bf16), their bases
// aligned to 16 bytes; the forward and bwd_dh take w as [K, D] in f32 and
// transposed, [D, K], in bf16; dx takes [K, D] in both; b, scale, bias, g and
// every gradient of a parameter in f32. Each returns cudaGetLastError() after
// its last launch.

// x [M, K], w (see above), b / scale / bias [D] -> out [M / 16, D] in x's dtype.
extern "C" int advmil_fused_embed_fwd(const void* x, const void* w, const void* b,
                                      const void* scale, const void* bias, void* out, int M,
                                      int K, int D, int dtype, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32)
    return advmil::fe::launch_rows<false>(x, w, b, scale, bias, nullptr, out, nullptr, M, K, D,
                                          eps, s);
  if (dtype == advmil::kBF16)
    return advmil::fe::rows_wgmma(x, w, b, scale, bias, nullptr, out, nullptr, M, K, D, eps,
                                  false, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the row kernel for M rows of this dtype (f32 64 rows each, bf16
// 128): the backward's partials hold blocks * 3 * D floats.
extern "C" int advmil_fused_embed_row_blocks(int M, int dtype) {
  const int rows = dtype == advmil::kBF16 ? advmil::fe::kWgmmaRowsBM : advmil::fe::kRowsBM;
  return (M + rows - 1) / rows;
}

// g [M / 16, D] f32 and the forward's inputs -> dh [M, D] in x's dtype and
// sums [3, D] f32 = (db, dscale, dbias); partials: scratch (see above).
extern "C" int advmil_fused_embed_bwd_dh(const void* g, const void* x, const void* w,
                                         const void* b, const void* scale, const void* bias,
                                         void* dh, void* partials, void* sums, int M, int K,
                                         int D, int dtype, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == advmil::kF32)
    err = advmil::fe::launch_rows<true>(x, w, b, scale, bias, g, dh, partials, M, K, D, eps, s);
  else if (dtype == advmil::kBF16)
    err = advmil::fe::rows_wgmma(x, w, b, scale, bias, g, dh, partials, M, K, D, eps, true, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return err;
  return advmil::fe::sum_rows(static_cast<const float*>(partials), static_cast<float*>(sums),
                              advmil_fused_embed_row_blocks(M, dtype), 3 * D, s);
}

// Slabs of the dW product for these shapes and dtype: its partials hold
// slabs * K * D floats (unused when it is 1).
extern "C" int advmil_fused_embed_dw_slabs(int M, int K, int D, int dtype) {
  int slabs, slab_len;
  advmil::fe::dw_slabs(M, K, D, dtype, &slabs, &slab_len);
  return slabs;
}

// x [M, K], dh [M, D] (one dtype) -> dw [K, D] f32: the slabs' products, then
// their sum in slab order.
extern "C" int advmil_fused_embed_dw(const void* x, const void* dh, void* dw, void* partials,
                                     int M, int K, int D, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype != advmil::kF32 && dtype != advmil::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  int slabs, slab_len;
  advmil::fe::dw_slabs(M, K, D, dtype, &slabs, &slab_len);
  float* target = static_cast<float*>(slabs > 1 ? partials : dw);
  const cudaError_t err =
      dtype == advmil::kBF16
          ? advmil::fe::dw_wgmma(x, dh, target, M, K, D, slab_len, slabs, s)
          : advmil::fe::launch_dw(x, dh, target, M, K, D, slab_len, slabs, s);
  if (err != cudaSuccess || slabs == 1) return err;
  return advmil::fe::sum_rows(target, static_cast<float*>(dw), slabs, K * D, s);
}

// dh [M, D], w [K, D] (both x's dtype) -> dx [M, K] in x's dtype.
extern "C" int advmil_fused_embed_dx(const void* dh, const void* w, void* dx, int M, int K,
                                     int D, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32) return advmil::fe::launch_dx(dh, w, dx, M, K, D, s);
  if (dtype == advmil::kBF16) return advmil::fe::dx_wgmma(dh, w, dx, M, K, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
