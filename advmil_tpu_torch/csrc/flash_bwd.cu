// Key-padding-masked flash attention, backward (FlashAttention-2 structure):
// dQ in one kernel, dK and dV in another, both recomputing the probabilities
// from the row logsumexp the forward wrote, so the [L, L] map never reaches
// device memory.
//
// Replaces the Pallas TPU kernels advmil_tpu/ops/attention.py:
// _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel (wrapper _bwd_call). With qs
// the pre-scaled queries, per (bh, i, j):
//   p_ij  = exp(qs_i . k_j - lse_i) where key j is real, else 0 (selected,
//           not multiplied: a fully masked row has lse ~ -1e30 and exp
//           overflows, so a mask multiply would give inf * 0 = NaN);
//   dp_ij = dO_i . v_j, times keep_ij / (1 - p) under dropout;
//   ds_ij = p_ij * (dp_ij - dvec_i), dvec_i = rowsum(dO_i * O_i) (computed by
//           the wrapper in torch, as the JAX package computes it outside
//           Pallas);
//   dQ_i = sum_j ds_ij k_j (the wrapper multiplies by 1/sqrt(Dh)),
//   dK_j = sum_i ds_ij qs_i, dV_j = sum_i p~_ij dO_i with p~ the dropped
//   probabilities p_ij keep_ij / (1 - p) (dV sees what O saw).
// keep_ij is the per-element Philox stream of philox.cuh with the forward's
// seed, so the three kernels agree bit for bit whatever their tiles.
//
// The kernels here serve f32 inputs with exact f32 FMAs on the CUDA cores (no
// TF32); for bf16 inputs dQ and dK / dV come from the tensor-core kernels of
// flash_dq_mma.cu and flash_dkv_mma.cu, which compute the same function.
//
// What bounds them on the card: the FMAs (2 L keys Dh flops each for S, dP
// and every second product: 3 products in dQ, 4 in dK/dV) at 67 TFLOP/s, and,
// as close behind, the shared-memory load instructions that feed them;
// exponentials and the Philox integer work are a few per cent. Device memory
// traffic is O(L Dh) per head: each streamed tile is read once per block.
//
// Design (both kernels): 256 threads a block. The block's 64 resident rows
// (queries for dQ, keys for dK/dV) are staged once, transposed d-major; the
// other side streams through a 2-stage cp.async ring of row-major tiles,
// rows Dh + 4 floats apart so that 8 neighbouring rows fall in 8 different
// bank groups. Each thread owns a register tile of scores: 4 consecutive
// resident rows x 8 streamed rows, S and dP side by side, and each step of d
// takes its operands with 16-byte shared loads (4 d at once per loaded row:
// 24 loads for 256 FFMA). P (and P~) and dS then go to shared memory and the
// second products run as register-blocked outer products: 4 rows x 8 to 16
// columns per thread, 16-byte loads, the step's keys (dQ) or queries (dK/dV)
// split over thread groups whose partial sums are added once at the end, in
// a fixed order. No atomics: two calls agree bit for bit.
//  - dQ: one block per (64 queries, bh); a step takes two key tiles of 64
//    (one at Dh = 128) from the compacted list of tiles with a real key
//    (mma.cuh::active_key_tiles, as the bf16 kernels), so masked tiles cost
//    nothing and a bag without a real key writes exact zeros. A thread's 8
//    keys are two aligned quads; lanes read the quads' rows in rotated order
//    ((j + kq / 2) % 4) so that the 8 rows of a load are 8 bank groups apart.
//  - dK/dV: one block per (64 keys, bh) over all query tiles (16 x 8 queries
//    a step; fewer at Dh = 64 / 128 to fit shared memory); a block whose keys
//    are all masked writes zeros and returns. Warps 0-3 form dV += P~^T dO,
//    warps 4-7 dK += dS^T qs, on the same step.
// Dropout: a thread's 4 keys of one query are the 4 words of one Philox
// block, so it draws one block per four elements and uses every word, in the
// stream's order (philox.cuh). Exponentials are exp2 of a log2e-scaled score
// (ex2.approx), as in the bf16 kernels.
#include "flash_f32.cuh"
#include "flash_mma.cuh"

namespace advmil {

// Per head dim; shared memory stays within the 227 KB of a block.
template <int DH>
struct F32Tiles {
  static constexpr int kPitch = DH + 4;  // streamed rows, floats apart
  // second-product columns a thread (fewer at small Dh, where the scores'
  // accumulators would crowd them into spills), and column groups
  static constexpr int kCW = DH <= 32 ? 8 : DH == 48 ? 12 : 16;
  static constexpr int kNCG = DH / kCW;
  // d a fully unrolled stretch of the score loop covers (longer ones spill)
  static constexpr int kDU = DH == 48 ? DH : DH == 16 ? 8 : 16;
  // dQ: key tiles of 64 a step; the step's keys split over kDqSplit groups
  static constexpr int kDqTiles = DH == 128 ? 1 : 2;
  static constexpr int kDqSplit = kF32Threads / (16 * kNCG);
  // dK/dV: queries a thread scores (16 x kTS a step); each half of the block
  // splits the step's queries over kQSplit groups
  static constexpr int kTS = DH == 128 ? 2 : DH == 64 ? 4 : 8;
  static constexpr int kQSplit = kF32Threads / 2 / (16 * kNCG);
};

template <int DH>
constexpr size_t dq_f32_smem_bytes() {
  using T = F32Tiles<DH>;
  constexpr int ks = kTile * T::kDqTiles;
  // sQt, sOt [DH][64]; sK, sV [stages][ks][pitch]; mask [stages][ks]; sDS [ks][68]; list
  constexpr size_t main = 2 * DH * kRes + 2 * kF32Stages * ks * T::kPitch + kF32Stages * ks +
                          ks * kDsPitch + kListWindow;
  constexpr size_t part = static_cast<size_t>(T::kDqSplit) * kRes * DH;  // after the loop
  return sizeof(float) * (main > part ? main : part);
}

template <int DH>
constexpr size_t dkv_f32_smem_bytes() {
  using T = F32Tiles<DH>;
  constexpr int bq = 16 * T::kTS;
  // sKt, sVt [DH][64]; sQ, sO [stages][bq][pitch]; lse, dvec [stages][bq]; sP, sS [bq][68]
  constexpr size_t main = 2 * DH * kRes + 2 * kF32Stages * bq * T::kPitch +
                          2 * kF32Stages * bq + 2 * bq * kDsPitch;
  constexpr size_t part = 2 * static_cast<size_t>(T::kQSplit) * kRes * DH;  // after the loop
  return sizeof(float) * (main > part ? main : part);
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ qs, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ mask, const float* __restrict__ lse,
                        const float* __restrict__ dvec, float* __restrict__ dq, int Lq, int Lk,
                        int H, DropoutArgs drop) {
  using T = F32Tiles<DH>;
  constexpr int NT = T::kDqTiles;
  constexpr int KSTEP = kTile * NT;  // keys a step
  constexpr int TK = 4 * NT;         // keys a thread scores: NT aligned quads
  constexpr int P = T::kPitch, CW = T::kCW, NCG = T::kNCG, SPLIT = T::kDqSplit;
  constexpr int KPER = KSTEP / SPLIT;
  constexpr int kWinKeys = kListWindow * kTile;
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;                          // [DH][64]
  float* sOt = sQt + DH * kRes;               // [DH][64]
  float* sK = sOt + DH * kRes;                // [stages][KSTEP][P]
  float* sV = sK + kF32Stages * KSTEP * P;    // [stages][KSTEP][P]
  float* sM = sV + kF32Stages * KSTEP * P;    // [stages][KSTEP]
  float* sDS = sM + kF32Stages * KSTEP;       // [KSTEP][kDsPitch], key-major
  int* sList = reinterpret_cast<int*>(sDS + KSTEP * kDsPitch);
  __shared__ int sCount;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kRes;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const size_t row_stride = static_cast<size_t>(H) * DH;
  const size_t qoff = (static_cast<size_t>(b) * Lq * H + hh) * DH;
  const float* kb = k + (static_cast<size_t>(b) * Lk * H + hh) * DH;
  const float* vb = v + (static_cast<size_t>(b) * Lk * H + hh) * DH;
  const float* mb = mask + static_cast<size_t>(b) * Lk;

  int n_active = active_key_tiles<kF32Threads / 32>(mb, min(Lk, kWinKeys), sList, &sCount,
                                                    warp, lane);
  if (n_active == 0 && Lk <= kWinKeys) {  // no real key: every p is 0, dQ = 0 exactly
    write_zero_rows<DH>(dq + qoff, row_stride, q0, Lq, tid);
    return;
  }
  load_transposed<DH>(sQt, qs + qoff, row_stride, q0, Lq, tid);
  load_transposed<DH>(sOt, dout + qoff, row_stride, q0, Lq, tid);

  // scores: a warp covers 4 query groups x 8 key quads; thread: queries
  // 4 qg .. 4 qg + 3, keys 4 kq .. 4 kq + 3 of each of the step's NT tiles
  const int qg = 4 * (warp >> 1) + (lane >> 3);
  const int kq = 8 * (warp & 1) + (lane & 7);
  const int rot = (kq >> 1) & 3;
  int koff[4];  // slot j of a quad holds key 4 kq + (j + rot) % 4
#pragma unroll
  for (int j = 0; j < 4; ++j) koff[j] = 4 * kq + ((j + rot) & 3);
  // dQ += dS K: thread (qg2, cg, ks): queries 4 qg2 .., columns cg CW .., keys ks KPER ..
  const int cg = tid % NCG, qg2 = (tid / NCG) % 16, ks = tid / (16 * NCG);

  const float* lse_b = lse + static_cast<size_t>(bh) * Lq;
  const float* dvec_b = dvec + static_cast<size_t>(bh) * Lq;
  bool rv[4];
  float ls[4], dvr[4];  // lse pre-scaled for exp2
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * qg + i;
    rv[i] = r < Lq;
    ls[i] = rv[i] ? lse_b[r] * kLog2e : 0.f;
    dvr[i] = rv[i] ? dvec_b[r] : 0.f;
  }
  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;

  for (int w0 = 0;;) {
    const int n_steps = (n_active + NT - 1) / NT;
    // One commit per call, with or without tiles, so that the group count
    // seen by cp_async_wait is the same in every thread and iteration.
    auto prefetch = [&](int step) {
      if (step < n_steps) {
        const int st = step % kF32Stages;
#pragma unroll
        for (int h = 0; h < NT; ++h) {
          const int e = NT * step + h;
          const bool have = e < n_active;
          const int key0 = have ? w0 + (sList[e] >> 1) * kTile : 0;
          float* tK = sK + (st * KSTEP + h * kTile) * P;
          float* tV = sV + (st * KSTEP + h * kTile) * P;
          load_rows_async<DH, kTile>(tK, kb, row_stride, key0, Lk, have, tid);
          load_rows_async<DH, kTile>(tV, vb, row_stride, key0, Lk, have, tid);
          if (tid < kTile) {
            const bool ok = have && key0 + tid < Lk;
            cp_async_4(sM + st * KSTEP + h * kTile + tid, ok ? mb + key0 + tid : mb, ok);
          }
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < kF32Stages - 1; ++s) prefetch(s);

    for (int a = 0; a < n_steps; ++a) {
      cp_async_wait<kF32Stages - 2>();  // step a's tiles have landed
      __syncthreads();                  // ... for every thread; step a - 1 is consumed
      prefetch(a + kF32Stages - 1);
      const int st = a % kF32Stages;
      const float* tK = sK + st * KSTEP * P;
      const float* tV = sV + st * KSTEP * P;
      const float* tM = sM + st * KSTEP;

      // S = qs K^T and dP = dO V^T on this thread's 4 queries x TK keys
      float s[4][TK], dp[4][TK];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
      for (int d0 = 0; d0 < DH; d0 += T::kDU) {
#pragma unroll
        for (int d = d0; d < d0 + T::kDU; d += 4) {
          float4 qv[4], ov[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qv[e] = lds4(sQt + (d + e) * kRes + 4 * qg);
            ov[e] = lds4(sOt + (d + e) * kRes + 4 * qg);
          }
#pragma unroll
          for (int j = 0; j < TK; ++j) {
            const int row = (j >> 2) * kTile + koff[j & 3];
            const float4 kv = lds4(tK + row * P + d);
            const float4 vv = lds4(tV + row * P + d);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float si = s[i][j], di = dp[i][j];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                si = fmaf(f4_at(qv[e], i), f4_at(kv, e), si);
                di = fmaf(f4_at(ov[e], i), f4_at(vv, e), di);
              }
              s[i][j] = si;
              dp[i][j] = di;
            }
          }
        }
      }

      // keep bits: one Philox block per (query, quad), bit j for slot j
      uint32_t keep[4][NT];
      if (DROP) {
#pragma unroll
        for (int h = 0; h < NT; ++h) {
          const int e = NT * a + h;
          const int tile = e < n_active ? sList[e] >> 1 : 0;
          const uint32_t quad = static_cast<uint32_t>(((w0 + tile * kTile) >> 2) + kq);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t n = keep_nibble(
                philox4x32_10(quad, static_cast<uint32_t>(q0 + 4 * qg + i),
                              static_cast<uint32_t>(bh), 0u, drop.seed_lo, drop.seed_hi),
                drop.threshold);
            keep[i][h] = ((n | (n << 4)) >> rot) & 0xFu;  // word (j + rot) % 4 at bit j
          }
        }
      }
      // dS = P o (dP - dvec), into sDS[key][query]; p selected by the key mask
      // and the query range, never multiplied (a masked row's lse is ~ -1e30)
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int row = (j >> 2) * kTile + koff[j & 3];
        const bool real = tM[row] > 0.f;
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = (real && rv[i]) ? fast_exp2(fmaf(s[i][j], kLog2e, -ls[i])) : 0.f;
          float dpv = dp[i][j];
          if (DROP) dpv = ((keep[i][j >> 2] >> (j & 3)) & 1u) ? dpv * drop.inv_keep : 0.f;
          ds[i] = p * (dpv - dvr[i]);
        }
        sts4(sDS + row * kDsPitch + 4 * qg, ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();

      // dQ += dS K over this thread's share of the step's keys
#pragma unroll 4
      for (int kk = ks * KPER; kk < (ks + 1) * KPER; ++kk) {
        const float4 d4 = lds4(sDS + kk * kDsPitch + 4 * qg2);
        float4 kr[CW / 4];
#pragma unroll
        for (int c = 0; c < CW / 4; ++c) kr[c] = lds4(tK + kk * P + cg * CW + 4 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CW; ++c)
            acc[i][c] = fmaf(f4_at(d4, i), f4_at(kr[c >> 2], c & 3), acc[i][c]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the step's tiles and the list are consumed
    w0 += kWinKeys;
    if (w0 >= Lk) break;
    n_active = active_key_tiles<kF32Threads / 32>(mb + w0, min(Lk - w0, kWinKeys), sList,
                                                  &sCount, warp, lane);
  }

  // the split's partial dQ tiles, then their sum in order
  float* part = smem;  // [SPLIT][64][DH]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; c += 4)
      sts4(part + (ks * kRes + 4 * qg2 + i) * DH + cg * CW + c, acc[i][c], acc[i][c + 1],
           acc[i][c + 2], acc[i][c + 3]);
  __syncthreads();
  write_summed_rows<DH>(dq + qoff, row_stride, q0, Lq, part, SPLIT, tid);
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ qs, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ mask, const float* __restrict__ lse,
                         const float* __restrict__ dvec, float* __restrict__ dk,
                         float* __restrict__ dv, int Lq, int Lk, int H, DropoutArgs drop) {
  using T = F32Tiles<DH>;
  constexpr int TS = T::kTS;
  constexpr int BQ = 16 * TS;  // queries a step
  constexpr int P = T::kPitch, CW = T::kCW, NCG = T::kNCG, QSPLIT = T::kQSplit;
  constexpr int QPER = BQ / QSPLIT;
  extern __shared__ __align__(16) float smem[];
  float* sKt = smem;                       // [DH][64]
  float* sVt = sKt + DH * kRes;            // [DH][64]
  float* sQ = sVt + DH * kRes;             // [stages][BQ][P]
  float* sO = sQ + kF32Stages * BQ * P;    // [stages][BQ][P]
  float* sL = sO + kF32Stages * BQ * P;    // [stages][BQ]
  float* sD = sL + kF32Stages * BQ;        // [stages][BQ]
  float* sP = sD + kF32Stages * BQ;        // [BQ][kDsPitch], query-major
  float* sS = sP + BQ * kDsPitch;          // [BQ][kDsPitch]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = blockIdx.x * kRes;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const size_t row_stride = static_cast<size_t>(H) * DH;
  const float* qb = qs + (static_cast<size_t>(b) * Lq * H + hh) * DH;
  const float* ob = dout + (static_cast<size_t>(b) * Lq * H + hh) * DH;
  const size_t koff = (static_cast<size_t>(b) * Lk * H + hh) * DH;
  const float* mb = mask + static_cast<size_t>(b) * Lk;
  const float* lse_b = lse + static_cast<size_t>(bh) * Lq;
  const float* dvec_b = dvec + static_cast<size_t>(bh) * Lq;

  // keys all masked: every p is 0, dK = dV = 0 exactly
  if (!__syncthreads_or(tid < kRes && k0 + tid < Lk && mb[k0 + tid] > 0.f)) {
    write_zero_rows<DH>(dk + koff, row_stride, k0, Lk, tid);
    write_zero_rows<DH>(dv + koff, row_stride, k0, Lk, tid);
    return;
  }

  const int n_steps = (Lq + BQ - 1) / BQ;
  auto prefetch = [&](int step) {  // one commit per call, as in dQ
    if (step < n_steps) {
      const int st = step % kF32Stages;
      const int r0 = step * BQ;
      load_rows_async<DH, BQ>(sQ + st * BQ * P, qb, row_stride, r0, Lq, true, tid);
      load_rows_async<DH, BQ>(sO + st * BQ * P, ob, row_stride, r0, Lq, true, tid);
      static_assert(2 * BQ <= kF32Threads, "one lse or dvec value a thread");
      if (tid < 2 * BQ) {
        const int r = tid % BQ;
        const bool ok = r0 + r < Lq;
        const float* src = (tid < BQ ? lse_b : dvec_b) + (ok ? r0 + r : 0);
        cp_async_4((tid < BQ ? sL : sD) + st * BQ + r, src, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) prefetch(s);
  load_transposed<DH>(sKt, k + koff, row_stride, k0, Lk, tid);
  load_transposed<DH>(sVt, v + koff, row_stride, k0, Lk, tid);

  // scores: a warp covers 4 key groups x 8 query groups; thread: keys
  // 4 kg .. 4 kg + 3 (one Philox block per query), queries qg + 16 m
  const int kg = 4 * (warp >> 1) + (lane >> 3);
  const int qg = 8 * (warp & 1) + (lane & 7);
  bool kreal[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + 4 * kg + j;
    kreal[j] = key < Lk && mb[key] > 0.f;
  }
  const uint32_t quad = static_cast<uint32_t>((k0 >> 2) + kg);
  // second products: warps 0-3 dV += P~^T dO, warps 4-7 dK += dS^T qs;
  // thread (kg2, cg, qsp): keys 4 kg2 .., columns cg CW .., queries qsp QPER ..
  const int half = warp >> 2;
  const int t2 = tid & (kF32Threads / 2 - 1);
  const int cg = t2 % NCG, kg2 = (t2 / NCG) % 16, qsp = t2 / (16 * NCG);
  const float* sA = half ? sS : sP;
  float acc[4][CW];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[j][c] = 0.f;

  for (int a = 0; a < n_steps; ++a) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();
    prefetch(a + kF32Stages - 1);
    const int st = a % kF32Stages;
    const float* tQ = sQ + st * BQ * P;
    const float* tO = sO + st * BQ * P;

    // S^T = K qs^T and dP^T = V dO^T on this thread's 4 keys x TS queries
    float s[4][TS], dp[4][TS];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int m = 0; m < TS; ++m) s[j][m] = dp[j][m] = 0.f;
#pragma unroll 1
    for (int d0 = 0; d0 < DH; d0 += T::kDU) {
#pragma unroll
      for (int d = d0; d < d0 + T::kDU; d += 4) {
        float4 kt[4], vt[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          kt[e] = lds4(sKt + (d + e) * kRes + 4 * kg);
          vt[e] = lds4(sVt + (d + e) * kRes + 4 * kg);
        }
#pragma unroll
        for (int m = 0; m < TS; ++m) {
          const float4 qv = lds4(tQ + (qg + 16 * m) * P + d);
          const float4 ov = lds4(tO + (qg + 16 * m) * P + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float sj = s[j][m], dj = dp[j][m];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sj = fmaf(f4_at(kt[e], j), f4_at(qv, e), sj);
              dj = fmaf(f4_at(vt[e], j), f4_at(ov, e), dj);
            }
            s[j][m] = sj;
            dp[j][m] = dj;
          }
        }
      }
    }

    // P~ and dS into sP / sS [query][key]
#pragma unroll
    for (int m = 0; m < TS; ++m) {
      const int row = qg + 16 * m;
      const int q = a * BQ + row;
      const bool qv = q < Lq;
      const float ls = sL[st * BQ + row] * kLog2e;
      const float dvv = sD[st * BQ + row];
      uint32_t keep = 0xFu;
      if (DROP)
        keep = keep_nibble(philox4x32_10(quad, static_cast<uint32_t>(q),
                                         static_cast<uint32_t>(bh), 0u, drop.seed_lo,
                                         drop.seed_hi),
                           drop.threshold);
      float pt[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (kreal[j] && qv) ? fast_exp2(fmaf(s[j][m], kLog2e, -ls)) : 0.f;
        float dpv = dp[j][m];
        pt[j] = p;
        if (DROP) {
          const bool kept = (keep >> j) & 1u;
          pt[j] = kept ? p * drop.inv_keep : 0.f;
          dpv = kept ? dpv * drop.inv_keep : 0.f;
        }
        ds[j] = p * (dpv - dvv);
      }
      sts4(sP + row * kDsPitch + 4 * kg, pt[0], pt[1], pt[2], pt[3]);
      sts4(sS + row * kDsPitch + 4 * kg, ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dV += P~^T dO (warps 0-3), dK += dS^T qs (warps 4-7)
    const float* tB = half ? tQ : tO;
#pragma unroll 4
    for (int i = qsp * QPER; i < (qsp + 1) * QPER; ++i) {
      const float4 a4 = lds4(sA + i * kDsPitch + 4 * kg2);
      float4 br[CW / 4];
#pragma unroll
      for (int c = 0; c < CW / 4; ++c) br[c] = lds4(tB + i * P + cg * CW + 4 * c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < CW; ++c)
          acc[j][c] = fmaf(f4_at(a4, j), f4_at(br[c >> 2], c & 3), acc[j][c]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // partial tiles [half][QSPLIT][64][DH], then each half's sum in order
  float* part = smem;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < CW; c += 4)
      sts4(part + ((half * QSPLIT + qsp) * kRes + 4 * kg2 + j) * DH + cg * CW + c, acc[j][c],
           acc[j][c + 1], acc[j][c + 2], acc[j][c + 3]);
  __syncthreads();
  write_summed_rows<DH>(dv + koff, row_stride, k0, Lk, part, QSPLIT, tid);
  write_summed_rows<DH>(dk + koff, row_stride, k0, Lk, part + QSPLIT * kRes * DH, QSPLIT, tid);
}

template <int DH, bool DROP>
cudaError_t launch_dq_f32(const BwdArgs& a, const DropoutArgs& drop, cudaStream_t stream) {
  constexpr size_t smem = dq_f32_smem_bytes<DH>();
  auto kernel = flash_bwd_dq_f32_kernel<DH, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kRes - 1) / kRes, a.B * a.H);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(a.qs), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.mask), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.dvec), static_cast<float*>(a.dq), a.Lq, a.Lk, a.H, drop);
  return cudaGetLastError();
}

template <int DH, bool DROP>
cudaError_t launch_dkv_f32(const BwdArgs& a, const DropoutArgs& drop, cudaStream_t stream) {
  constexpr size_t smem = dkv_f32_smem_bytes<DH>();
  auto kernel = flash_bwd_dkv_f32_kernel<DH, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + kRes - 1) / kRes, a.B * a.H);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(a.qs), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.mask), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.dvec), static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.Lq, a.Lk, a.H, drop);
  return cudaGetLastError();
}

// which: 0 = dQ, 1 = dK/dV
template <bool DROP>
cudaError_t dispatch_bwd_f32(int which, const BwdArgs& a, int Dh, const DropoutArgs& d,
                             cudaStream_t s) {
#define ADVMIL_BWD_CASE(DH)                                                          \
  case DH:                                                                           \
    return which == 0 ? launch_dq_f32<DH, DROP>(a, d, s) : launch_dkv_f32<DH, DROP>(a, d, s);
  switch (Dh) {
    ADVMIL_BWD_CASE(16)
    ADVMIL_BWD_CASE(32)
    ADVMIL_BWD_CASE(48)
    ADVMIL_BWD_CASE(64)
    ADVMIL_BWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef ADVMIL_BWD_CASE
}

int bwd_dtype(int which, const BwdArgs& a, int Dh, int dtype, int dropout,
              const DropoutArgs& d, cudaStream_t s) {
  if (dtype == kF32) {  // 16-byte loads and stores of rows
    const bool outs = which == 0 ? aligned16(a.dq) : aligned16(a.dk) && aligned16(a.dv);
    if (!(aligned16(a.qs) && aligned16(a.k) && aligned16(a.v) && aligned16(a.dout) && outs))
      return static_cast<int>(cudaErrorMisalignedAddress);
    return static_cast<int>(dropout ? dispatch_bwd_f32<true>(which, a, Dh, d, s)
                                    : dispatch_bwd_f32<false>(which, a, Dh, d, s));
  }
  if (dtype == kBF16)  // the tensor-core kernels of flash_dq_mma.cu / flash_dkv_mma.cu
    return static_cast<int>(which == 0 ? flash_dq_mma(a, Dh, dropout != 0, d, s)
                                       : flash_dkv_mma(a, Dh, dropout != 0, d, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace advmil

// Common arguments of both entry points: qs [B, Lq, H, Dh] (pre-scaled by
// 1/sqrt(Dh), as in the forward), k / v [B, Lk, H, Dh], dout [B, Lq, H, Dh], all
// f32 or all bf16, contiguous; mask [B, Lk] f32; lse and dvec [B*H, Lq] f32.
// Dh in {16, 32, 48, 64, 128}; B*H <= 65535 (checked by the Python wrapper).
// The dropout arguments are the forward's. Each returns cudaGetLastError()
// after its launch (f32: cudaErrorMisalignedAddress, without a launch, for a
// tensor not 16-byte aligned).

// dq [B, Lq, H, Dh] f32, not yet multiplied by 1/sqrt(Dh).
extern "C" int advmil_flash_bwd_dq(const void* qs, const void* k, const void* v,
                                   const void* dout, const void* mask, const void* lse,
                                   const void* dvec, void* dq, int B, int Lq, int Lk,
                                   int H, int Dh, int dtype, int dropout,
                                   unsigned seed_lo, unsigned seed_hi,
                                   unsigned threshold, float inv_keep, void* stream) {
  const advmil::BwdArgs a{qs, k, v, dout, mask, lse, dvec, dq, nullptr, nullptr,
                          B, Lq, Lk, H};
  const advmil::DropoutArgs d{seed_lo, seed_hi, threshold, inv_keep};
  return advmil::bwd_dtype(0, a, Dh, dtype, dropout, d, static_cast<cudaStream_t>(stream));
}

// dk, dv [B, Lk, H, Dh] f32.
extern "C" int advmil_flash_bwd_dkv(const void* qs, const void* k, const void* v,
                                    const void* dout, const void* mask, const void* lse,
                                    const void* dvec, void* dk, void* dv, int B, int Lq,
                                    int Lk, int H, int Dh, int dtype, int dropout,
                                    unsigned seed_lo, unsigned seed_hi,
                                    unsigned threshold, float inv_keep, void* stream) {
  const advmil::BwdArgs a{qs, k, v, dout, mask, lse, dvec, nullptr, dk, dv,
                          B, Lq, Lk, H};
  const advmil::DropoutArgs d{seed_lo, seed_hi, threshold, inv_keep};
  return advmil::bwd_dtype(1, a, Dh, dtype, dropout, d, static_cast<cudaStream_t>(stream));
}
