// The row kernel of the fused region patch embedding in bf16, on wgmma: h =
// x W + b for 128 rows, then the forward epilogue (LayerNorm, ReLU, 16-row
// region mean) or the backward one (dh and the block's db / dscale / dbias).
//
// The bf16 instantiation of the ports of the Pallas TPU kernels
// advmil_tpu/ops/fused_embed.py:_fwd_kernel (forward, #9) and the dh half of
// :_bwd_dparams_kernel (#11; fused_embed_dw.cu forms dW from this dh).
// fused_embed.cu holds the f32 row kernel (plain FMAs), the C entry points and
// the shape limits. x [M, K] and W^T [D, K] (rounded to bf16 by the wrapper)
// are bf16, the product accumulates in f32, h is never rounded, the LayerNorm
// runs in f32 with eps inside the rsqrt, dh is rounded to bf16 once, and db is
// summed from the unrounded dh. No library GEMM is called.
//
// What bounds it on the card (M = 32,768, K = 1,024, D = 384): the product is
// 25.8 GFLOP, 0.026 ms at 989 TFLOP/s, against 68 MB of device memory (x 64
// MB), 0.020 ms at 3.35 TB/s: the tensor cores. The backward mode does the
// same product and writes dh, 25 MB more.
//
// Design. LN needs a row's every column, so a block owns 128 whole rows:
// two consumer warpgroups of 64 rows each, one producer warpgroup, and a
// cluster of kRowCluster blocks. The producer's elected lane streams K in chunks of 64
// through a ring of stages (full / empty mbarriers), each stage a TMA box of
// 128 rows x 64 of x (its own) and the D x 64 tile of W^T, of which every
// block of the cluster loads 1 / kRowCluster of the rows and multicasts them
// to all (W^T crosses from L2 once per cluster instead of once per block:
// with 128-row blocks that is 96 MB instead of 192 MB against x's 64 MB). A
// warpgroup multiplies its 64 rows by the whole tile, wgmma m64nNk16 from two
// shared-memory descriptors (N = 128 or 256, or 2 x 192 for D = 384), one
// chunk's group in flight while the previous chunk's stage is released. So
// one warpgroup owns a row's every column: 192 f32 accumulators a thread at D
// = 384, under the 232 registers a consumer thread takes from the producer
// warpgroup (setmaxnreg; without it a block of 9 warps leaves 168 a thread,
// and ptxas spilled 7.8 KB a thread and serialized the wgmmas, C7511). (The
// other way, two warpgroups sharing a row's columns at 96 a thread, needs
// four consumer warpgroups for 128 rows, 120 registers a thread, or 64-row
// blocks, which read W^T twice as often from L2.)
//
// The epilogue works on the accumulator fragment in registers, no h tile in
// shared memory: a warp holds 16 whole rows, which are exactly one region; a
// thread holds two rows (g and g + 8) at 2 columns of every n8 tile. A row's
// mean and variance are a sum over the thread's columns and a quad shuffle;
// columns beyond D (W^T's rows there are TMA's zero fill, b, scale and bias
// are 0 there) stay out of the variance by a warp-uniform test of each n8
// tile. A column's sum over the region's 16 rows (the forward's mean, the
// backward's db, dscale and dbias) is a reduce-scatter over the 8 row lanes,
// 8 values at a time in three shuffle rounds, after which lane (g, t) holds
// column 8 (j0 + g / 2) + 2 t + g % 2 of the four n8 tiles j0 ..: the forward
// writes the region's 64 contiguous bytes per four tiles from there. The
// backward first moves x-hat from the registers over the idle ring (see
// there), rounds dh to bf16 in registers, transposes 4 x 4 words within each
// quad and stores 16 bytes a lane (the dx kernel's epilogue); its warps'
// column sums meet in shared memory and the block adds them in warp order
// into its partials, which sum_rows adds in block order: no atomics, the same
// bits every run.
//
// The wgmmas stand in control flow that the compiler can prove uniform (the
// warp index through a shuffle, the barrier waits as one asm block each): a
// branch or a C++ polling loop around one makes ptxas serialize them (C7520).
// Rows beyond M are TMA's zero fill: h = b there, finite, and they write
// nothing.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; M = 32,768, K = 1,024, D = 384;
// scripts/profile_fused_embed.py --fwd --dparams --variants ...): forward
// 0.054 ms, of which the loads alone take 0.038 (each SM takes in 1 MB per
// 128 rows, three quarters of it W^T; the products hide under them, the
// epilogue, 0.015, does not). 2 stages 0.070, a cluster of 4 0.071; at D =
// 384 shared memory holds 3 stages. The backward mode 0.092, 0.058 without
// its epilogue; its first version ran the epilogue unrolled over the
// registers, spilled and took 0.156. The wmma kernel this replaced: 0.158
// forward, 0.185 backward mode.
#include "wgmma.cuh"

namespace advmil {
namespace fe {

constexpr int kRowBlockRows = 128;     // rows of x per block: two warpgroups of 64
constexpr int kRowCluster = 2;         // blocks that share each W^T tile
constexpr int kRowConsumerWarps = 8;
constexpr int kRowWgThreads = 32 * (kRowConsumerWarps + 4);  // and the producer warpgroup
constexpr int kProducerRegs = 40;      // registers a thread, after setmaxnreg
constexpr int kConsumerRegs = 232;
constexpr int kRowMaxStages = 6;
constexpr int kSmemLimit = 232448;     // dynamic shared memory a block may use
constexpr int kRegionRows = 16;
constexpr int kXBoxBytes = kRowBlockRows * wg::kRowBytes;    // 128 x 64 of x: 16 KB

// D padded to an instantiated width: 128, 256 or 384 columns.
inline int row_width(int D) { return D <= 128 ? 128 : D <= 256 ? 256 : 384; }

template <int DP>
struct RowShape {
  static constexpr int kPieces = DP == 384 ? 2 : 1;  // wgmmas per k-step
  static constexpr int kN = DP / kPieces;            // their width: 128, 192 or 256
  static constexpr int kTiles = kN / 8;              // n8 tiles of a piece
  static constexpr int kStageBytes = kXBoxBytes + DP * wg::kRowBytes;
};

// Shared memory: the ring, then b, scale, bias [DP] (0 beyond D) and, backward,
// the block's 8 regions' cotangent rows / 16 [8][DP] and one column sum of
// each consumer warp [8][DP], then the barriers.
__host__ __device__ constexpr int row_param_floats(int DP, bool bwd) {
  return (3 + (bwd ? 16 : 0)) * DP;
}
inline int row_stages(int DP, bool bwd) {
  const int fixed = wg::kTileAlign + 4 * row_param_floats(DP, bwd) + 16 * kRowMaxStages;
  const int s = (kSmemLimit - fixed) / (kXBoxBytes + DP * wg::kRowBytes);
  return s < kRowMaxStages ? s : kRowMaxStages;
}
inline int row_smem_bytes(int DP, bool bwd, int stages) {
  return wg::kTileAlign + stages * (kXBoxBytes + DP * wg::kRowBytes) +
         4 * row_param_floats(DP, bwd) + 16 * stages;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// v[0..7] of every lane (lane = 4 g + t): returns, in lane (g, t), the sum of
// v[g] over the 8 lanes of its t, added in a fixed order; three shuffle
// rounds of 4, 2 and 1 values (lanes 16, 8 and 4 apart).
__device__ __forceinline__ float sum_over_rows(float (&v)[8], int g) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool up = g & 4;
    const float send = up ? v[i] : v[i + 4];
    v[i] = (up ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool up = g & 2;
    const float send = up ? v[i] : v[i + 2];
    v[i] = (up ? v[i + 2] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const bool up = g & 1;
  const float send = up ? v[0] : v[1];
  return (up ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
}

__device__ __forceinline__ void consumer_barrier() {  // the 8 consumer warps only
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kRowConsumerWarps) : "memory");
}

template <int DP, bool BWD>
__global__ void __cluster_dims__(kRowCluster, 1, 1) __launch_bounds__(kRowWgThreads, 1)
rows_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w, const float* __restrict__ b,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  const float* __restrict__ g, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ partials, int M, int K, int D, int stages, float eps) {
  using S = RowShape<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t base = (raw + wg::kTileAlign - 1) & ~(wg::kTileAlign - 1u);
  unsigned char* smem = smem_raw + (base - raw);
  float* P = reinterpret_cast<float*>(smem + stages * S::kStageBytes);
  const uint32_t bar_full = base + stages * S::kStageBytes + 4 * row_param_floats(DP, BWD);
  const uint32_t bar_empty = bar_full + 8 * stages;
  const int chunks = (K + wg::kChunk - 1) / wg::kChunk;
  // the warp index through a shuffle, so that the compiler knows the role
  // branches below as warp-uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kRowBlockRows;  // may lie beyond M in a cluster's last block
  const uint32_t rank = wg::cluster_rank();

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(bar_full + 8 * s, 1);
      wg::mbar_init(bar_empty + 8 * s, kRowConsumerWarps * kRowCluster);
    }
    wg::mbar_init_fence();
  }
  for (int c = threadIdx.x; c < DP; c += kRowWgThreads) {
    P[c] = c < D ? b[c] : 0.f;
    P[DP + c] = c < D ? scale[c] : 0.f;
    P[2 * DP + c] = c < D ? bias[c] : 0.f;
  }
  if (BWD) {
    const int regions = M / kRegionRows;
    for (int i = threadIdx.x; i < 8 * DP; i += kRowWgThreads) {
      const int region = blockIdx.x * 8 + i / DP, c = i % DP;
      P[3 * DP + i] = region < regions && c < D
                          ? g[static_cast<size_t>(region) * D + c] * (1.f / kRegionRows)
                          : 0.f;
    }
  }
  wg::cluster_sync();  // barriers set up and P written, in every block of the cluster

  if (warp >= kRowConsumerWarps) {
    wg::regs_release<kProducerRegs>();
    if (warp == kRowConsumerWarps && lane == 0) {
      constexpr int kWRows = DP / kRowCluster;  // rows of W^T this block loads for all
      for (int kc = 0; kc < chunks; ++kc) {
        const int st = kc % stages;
        // every block's consumers have released this stage's previous chunk
        wg::mbar_wait(bar_empty + 8 * st, ((kc / stages) & 1) ^ 1);
        wg::mbar_arrive_expect_tx(bar_full + 8 * st, S::kStageBytes);
        const uint32_t sx = base + st * S::kStageBytes;
        wg::tma_load_2d(sx, &map_x, kc * wg::kChunk, m0, bar_full + 8 * st);
        wg::tma_load_2d_multicast(sx + kXBoxBytes + rank * kWRows * wg::kRowBytes, &map_w,
                                  kc * wg::kChunk, rank * kWRows, bar_full + 8 * st,
                                  static_cast<uint16_t>((1u << kRowCluster) - 1u));
      }
    }
    wg::cluster_sync();
    return;
  }
  wg::regs_claim<kConsumerRegs>();

  const int wgi = warp >> 2, g8 = lane >> 2, t = lane & 3;
  float acc[S::kPieces][S::kN / 2];
#pragma unroll
  for (int p = 0; p < S::kPieces; ++p)
#pragma unroll
    for (int i = 0; i < S::kN / 2; ++i) acc[p][i] = 0.f;

  for (int kc = 0; kc < chunks; ++kc) {
    const int st = kc % stages;
    wg::mbar_wait(bar_full + 8 * st, (kc / stages) & 1);
    const uint32_t sx = base + st * S::kStageBytes;
    const uint64_t da = wg::operand_desc(sx + wgi * 64 * wg::kRowBytes);
    const uint64_t db = wg::operand_desc(sx + kXBoxBytes);
    wg::wgmma_fence();
#pragma unroll
    for (int s = 0; s < wg::kChunk / 16; ++s) {  // K beyond the edge is zero fill
#pragma unroll
      for (int p = 0; p < S::kPieces; ++p)
        wg::wgmma<0, 0>(acc[p], da + 2 * s, db + 2 * s + ((p * S::kN * wg::kRowBytes) >> 4),
                        (kc | s) != 0);
    }
    wg::wgmma_commit();
    if (kc > 0) {  // the previous chunk's products are done: its stage is free
      wg::wgmma_wait<1>();
      if (lane < kRowCluster) wg::mbar_arrive_cluster(bar_empty + 8 * ((kc - 1) % stages), lane);
    }
  }
  wg::wgmma_wait<0>();
  if (lane < kRowCluster) wg::mbar_arrive_cluster(bar_empty + 8 * ((chunks - 1) % stages), lane);
#pragma unroll
  for (int p = 0; p < S::kPieces; ++p) wg::acc_fence(acc[p]);

  // ---- epilogue: rows r0 and r0 + 8, the warp's 16 rows being one region ----
  const float* Pb = P;
  const float* Psc = P + DP;
  const float* Pbi = P + 2 * DP;
  const int wrow = 64 * wgi + 16 * (warp & 3);  // the warp's first row in the block
  const int r0 = m0 + wrow + g8;
  const float inv_d = 1.f / static_cast<float>(D);
  float mu[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
#pragma unroll
  for (int p = 0; p < S::kPieces; ++p)
#pragma unroll
    for (int j = 0; j < S::kTiles; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(Pb + p * S::kN + 8 * j + 2 * t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[p][4 * j + 2 * r] += bv.x;
        acc[p][4 * j + 2 * r + 1] += bv.y;
        mu[r] += acc[p][4 * j + 2 * r] + acc[p][4 * j + 2 * r + 1];  // 0 beyond D
      }
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) mu[r] = quad_sum(mu[r]) * inv_d;
#pragma unroll
  for (int p = 0; p < S::kPieces; ++p)
#pragma unroll
    for (int j = 0; j < S::kTiles; ++j)
      if (p * S::kN + 8 * j < D) {  // columns beyond D stay out of the variance
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d = acc[p][4 * j + 2 * r + e] - mu[r];
            inv[r] += d * d;
          }
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = rsqrtf(quad_sum(inv[r]) * inv_d + eps);
  // x-hat in place
#pragma unroll
  for (int p = 0; p < S::kPieces; ++p)
#pragma unroll
    for (int j = 0; j < S::kTiles; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[p][4 * j + 2 * r + e] = (acc[p][4 * j + 2 * r + e] - mu[r]) * inv[r];

  if constexpr (!BWD) {
    // the region's mean of relu(x-hat * scale + bias): scale and bias are 0
    // beyond D, so those columns add 0
    const int region = (m0 + wrow) / kRegionRows;
    const bool live = region < M / kRegionRows;
#pragma unroll
    for (int p = 0; p < S::kPieces; ++p)
#pragma unroll
      for (int jc = 0; jc < S::kTiles / 4; ++jc) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * jc + i, c = p * S::kN + 8 * j + 2 * t;
          const float2 sc = *reinterpret_cast<const float2*>(Psc + c);
          const float2 bi = *reinterpret_cast<const float2*>(Pbi + c);
          v[2 * i] = fmaxf(acc[p][4 * j] * sc.x + bi.x, 0.f) +
                     fmaxf(acc[p][4 * j + 2] * sc.x + bi.x, 0.f);
          v[2 * i + 1] = fmaxf(acc[p][4 * j + 1] * sc.y + bi.y, 0.f) +
                         fmaxf(acc[p][4 * j + 3] * sc.y + bi.y, 0.f);
        }
        const float sum = sum_over_rows(v, g8);
        const int c = p * S::kN + 8 * (4 * jc + (g8 >> 1)) + 2 * t + (g8 & 1);
        if (live && c < D)
          out[static_cast<size_t>(region) * D + c] = __float2bfloat16(sum * (1.f / kRegionRows));
      }
  } else {
    // gy = cotangent behind the ReLU, gx = gy * scale; dh = inv (gx - mean gx
    // - x-hat mean(gx x-hat)). x-hat goes over the ring, which is idle once
    // both warpgroups are past their last product (128 x DP f32: the ring's
    // 3 stages at D = 384), each thread's values apart from the others', and
    // the passes below walk it in loops that are not unrolled: unrolled over
    // registers, the backward at D = 384 spilled and outgrew the instruction
    // cache (0.156 ms against 0.061 without this epilogue).
    constexpr int kT = DP / 8;  // n8 tiles of a row
    constexpr int kThreadsC = 32 * kRowConsumerWarps;
    const float* Pg = P + 3 * DP + (wrow / kRegionRows) * DP;  // the region's g / 16
    float* Wq = P + 11 * DP;  // [8 warps][DP]: one column sum of each warp
    float2* Xs = reinterpret_cast<float2*>(smem);  // [tile][row][thread]
    const int tid = threadIdx.x;
    consumer_barrier();
#pragma unroll
    for (int p = 0; p < S::kPieces; ++p)
#pragma unroll
      for (int j = 0; j < S::kTiles; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          Xs[(2 * (p * S::kTiles + j) + r) * kThreadsC + tid] =
              make_float2(acc[p][4 * j + 2 * r], acc[p][4 * j + 2 * r + 1]);
    // scale, bias or g / 16 of the columns 2 t, 2 t + 1 of n8 tile j
    auto par = [&](const float* a, int j) {
      return *reinterpret_cast<const float2*>(a + 8 * j + 2 * t);
    };
    // lane (g, t)'s column of four tiles, after sum_over_rows
    auto col_of = [&](int jc) { return 8 * (4 * jc + (g8 >> 1)) + 2 * t + (g8 & 1); };
    // the warps' column sums in Wq added in warp order: the block's partial of
    // quantity q (0: db, 1: dscale, 2: dbias)
    auto block_sum = [&](int q) {
      consumer_barrier();
      for (int c = tid; c < D; c += kThreadsC) {
        float a = 0.f;
#pragma unroll
        for (int wv = 0; wv < kRowConsumerWarps; ++wv) a += Wq[wv * DP + c];
        if (m0 < M) partials[(static_cast<size_t>(blockIdx.x) * 3 + q) * D + c] = a;
      }
      consumer_barrier();  // Wq is free again
    };
    float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
    for (int q = 1; q < 3; ++q) {  // dscale (and the rows' m1, m2), then dbias
#pragma unroll 1
      for (int jc = 0; jc < kT / 4; ++jc) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * jc + i;
          const float2 sc = par(Psc, j), bi = par(Pbi, j), gr = par(Pg, j);
          v[2 * i] = v[2 * i + 1] = 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 xh = Xs[(2 * j + r) * kThreadsC + tid];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x_ = e ? xh.y : xh.x, s_ = e ? sc.y : sc.x;
              const float gy = x_ * s_ + (e ? bi.y : bi.x) > 0.f ? (e ? gr.y : gr.x) : 0.f;
              if (q == 1) {
                m1[r] += gy * s_;
                m2[r] += gy * s_ * x_;
              }
              v[2 * i + e] += q == 1 ? gy * x_ : gy;
            }
          }
        }
        Wq[warp * DP + col_of(jc)] = sum_over_rows(v, g8);
      }
      block_sum(q);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m1[r] = quad_sum(m1[r]) * inv_d;
      m2[r] = quad_sum(m2[r]) * inv_d;
    }
#pragma unroll 1
    for (int jc = 0; jc < kT / 4; ++jc) {
      float d[4][2][2];  // dh of four n8 tiles: [tile][row][column]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * jc + i;
        const bool in = 8 * j < D;
        const float2 sc = par(Psc, j), bi = par(Pbi, j), gr = par(Pg, j);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 xh = Xs[(2 * j + r) * kThreadsC + tid];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x_ = e ? xh.y : xh.x, s_ = e ? sc.y : sc.x;
            const float gy = x_ * s_ + (e ? bi.y : bi.x) > 0.f ? (e ? gr.y : gr.x) : 0.f;
            d[i][r][e] = in ? inv[r] * (gy * s_ - m1[r] - x_ * m2[r]) : 0.f;
          }
        }
      }
      const int col = 8 * (4 * jc + t);  // lane t: the 8 columns of tile 4 jc + t
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = wg::pack_bf16x2(d[i][r][0], d[i][r][1]);
        wg::quad_transpose(w, t);
        const int row = r0 + 8 * r;
        if (row < M && col < D)
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * D + col) =
              make_uint4(w[0], w[1], w[2], w[3]);
      }
      float v[8];  // db, from the unrounded dh
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) v[2 * i + e] = d[i][0][e] + d[i][1][e];
      Wq[warp * DP + col_of(jc)] = sum_over_rows(v, g8);
    }
    block_sum(0);
  }
  wg::cluster_sync();
}

template <int DP, bool BWD>
cudaError_t launch_rows_wgmma(const CUtensorMap& map_x, const CUtensorMap& map_w, const void* b,
                              const void* scale, const void* bias, const void* g, void* out,
                              void* partials, int M, int K, int D, float eps,
                              cudaStream_t stream) {
  const int stages = row_stages(DP, BWD);
  const int bytes = row_smem_bytes(DP, BWD, stages);
  // the backward lays the block's 128 x DP f32 x-hat over the ring
  if (BWD && stages * RowShape<DP>::kStageBytes < kRowBlockRows * DP * 4)
    return cudaErrorInvalidValue;
  auto kernel = rows_wgmma_kernel<DP, BWD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (M + kRowBlockRows - 1) / kRowBlockRows;
  const int grid = (blocks + kRowCluster - 1) / kRowCluster * kRowCluster;  // whole clusters
  kernel<<<grid, kRowWgThreads, bytes, stream>>>(
      map_x, map_w, static_cast<const float*>(b), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(g),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partials), M, K, D, stages, eps);
  return cudaGetLastError();
}

// x [M, K] and wt = W^T [D, K] in bf16, b / scale / bias [D] f32. Forward:
// out [M / 16, D] bf16. Backward (g [M / 16, D] f32): out = dh [M, D] bf16 and
// partials [ceil(M / 128), 3, D] f32 (db, dscale, dbias of each block).
cudaError_t rows_wgmma(const void* x, const void* wt, const void* b, const void* scale,
                       const void* bias, const void* g, void* out, void* partials, int M,
                       int K, int D, float eps, bool bwd, cudaStream_t stream) {
  if (D > 384) return cudaErrorInvalidValue;
  const int DP = row_width(D);
  wg::EncodeTiledFn encode = nullptr;
  cudaError_t err = wg::encode_tiled_fn(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap map_x, map_w;
  err = wg::make_map_bf16(encode, &map_x, x, M, K, kRowBlockRows);
  if (err != cudaSuccess) return err;
  err = wg::make_map_bf16(encode, &map_w, wt, D, K, DP / kRowCluster);
  if (err != cudaSuccess) return err;
#define ADVMIL_ROWS(DPV, BWDV)                                                               \
  return launch_rows_wgmma<DPV, BWDV>(map_x, map_w, b, scale, bias, g, out, partials, M, K, D, \
                                      eps, stream)
  if (DP == 128) { if (bwd) ADVMIL_ROWS(128, true); ADVMIL_ROWS(128, false); }
  if (DP == 256) { if (bwd) ADVMIL_ROWS(256, true); ADVMIL_ROWS(256, false); }
  if (bwd) ADVMIL_ROWS(384, true);
  ADVMIL_ROWS(384, false);
#undef ADVMIL_ROWS
}

}  // namespace fe
}  // namespace advmil
