// Key-padding-masked flash attention, forward, with optional dropout on the
// attention probabilities.
//
// Replaces the Pallas TPU kernel advmil_tpu/ops/attention.py:_flash_fwd_kernel
// (wrapper masked_flash_attention -> _flash -> _fwd_call).
// For q [B, Lq, H, Dh] pre-scaled by 1/sqrt(Dh), k, v [B, Lk, H, Dh] and a key
// mask [B, Lk]:
//   out[b, i, h] = sum_j p_ij v[b, j, h] / max(sum_j p_ij, 1e-30),
//   p_ij = exp(q_i . k_j - m_i) if mask[b, j] > 0 else 0,
// computed with an online softmax (f32 running max, sum and accumulator), and
// lse[b*H + h, i] = m_i + log(max(sum_j p_ij, 1e-30)) in f32 for the backward.
// A query whose keys are all masked gets 0 (the same denominator clamp as the
// TPU kernel), never NaN.
//
// Dropout (DROP, p > 0): as torch's MultiheadAttention and the TPU kernel, it
// acts on the normalised probabilities: l_i keeps summing the undropped p_ij,
// and only the P.V contraction uses p_ij * keep_ij / (1 - p). keep_ij comes
// from the per-element Philox stream of philox.cuh (seeded per call by the
// wrapper), so the backward kernels regenerate the same bits. With DROP false
// the code is the p = 0 kernel unchanged.
//
// What bounds it on the card: at the ESAT shapes (Dh = 48, L ~ 1,024-2,048)
// the work is 4 * Lq * (real keys) * Dh flops per head, done here in f32 on
// the CUDA cores (no TF32) out of shared memory, so the FMAs at 67 TFLOP/s
// bound it, and close behind them the shared-memory load instructions that
// feed them (a 16-byte load for every 12-16 FMAs); device memory traffic is
// O(L Dh) per head (each streamed tile is read once per 64-query block). The
// TPU kernel's reason to pad Dh to 128 lanes does not apply: Dh = 48 is used
// as it is.
//
// Design (the f32 kernel; the dQ kernel of flash_bwd.cu with one product
// fewer and an online softmax in place of the lse): one block of 256 threads
// per (64 queries, batch * head). The queries are staged once, d-major; K, V
// and the mask stream through a 2-stage cp.async ring of row-major tiles,
// rows Dh + 4 floats apart. Before the loop the block lists the key tiles of
// 64 that hold a real key (mma.cuh::active_key_tiles, in windows of
// kListWindow tiles), and a step takes kNT of them: a tile without a real key
// adds exactly 0 to l and O and leaves m alone, so it is neither loaded nor
// computed, and a bag without a real key writes its zeros and its lse and
// does no product. Warp w scores its 8 queries against the step's keys, lanes
// l and l + 16 each over one half of Dh: a thread forms 8 queries x 4 kNT
// keys (aligned quads, read in rotated order ((j + kq / 2) % 4) so that the 8
// rows of a quarter-warp's load fall in 8 bank groups) with 16-byte shared
// loads only, 16 FMAs a load, and one shuffle a score gives it its own 4
// queries whole. Those 16 threads of a query group are one half-warp: a
// row's step max is 4 shuffles, and each thread keeps its own share of the
// row sum, rescaled with the row and added up once at the end. Scores are
// taken in log2 units (exp2 on ex2.approx, as in the bf16 kernels); lse =
// ln2 (m2 + log2 l). The dropped probabilities go to shared memory
// key-major, with each row's rescale factor beside them, and the same warp
// (after a warp barrier only) runs O += P~ V on its own 8 queries as
// register-blocked outer products (4 rows x kCW columns a thread) over a
// split of the step's keys into lane groups whose partial tiles are rescaled
// alike and summed once, in a fixed order, before the division by
// max(l, 1e-30). No atomics: two calls agree bit for bit. Dropout: a
// thread's 4 keys of one query are the 4 words of one Philox block, so it
// draws one block per four elements and uses every word, in the stream's
// order (philox.cuh). Inputs are read in the JAX layout [B, L, H, Dh]
// directly (no fold / transpose copies) and must be 16-byte aligned.
//
// bf16 inputs go to the tensor-core kernel of flash_fwd_mma.cu, which
// computes the same function.
#include "flash_f32.cuh"
#include "flash_mma.cuh"

namespace advmil {

constexpr float kLn2 = 0.6931471805599453f;

// Per head dim; shared memory stays within the 227 KB of a block.
template <int DH>
struct FwdTiles {
  static constexpr int kNT = DH == 128 ? 1 : 2;  // key tiles of 64 a step (one block an SM)
  static constexpr int kPitch = DH + 4;           // streamed rows, floats apart
  // P~ V columns a thread, column groups, and the split of a step's keys
  // over the lanes of a warp that share 4 rows and a column group
  static constexpr int kCW = DH <= 32 ? 8 : DH == 48 ? 12 : 16;
  static constexpr int kNCG = DH / kCW;
  static constexpr int kSplit = 16 / kNCG;
  // d a fully unrolled stretch of the score loop covers (of a thread's half)
  static constexpr int kDU = DH / 2 <= 32 ? DH / 2 : 16;
};

template <int DH>
constexpr size_t fwd_f32_smem_bytes() {
  using T = FwdTiles<DH>;
  constexpr int ks = kTile * T::kNT;
  // sQt [DH][64]; sK, sV [stages][ks][pitch]; mask [stages][ks]; sP [ks][68]; list
  constexpr size_t main = DH * kRes + 2 * kF32Stages * ks * T::kPitch + kF32Stages * ks +
                          ks * kDsPitch + kListWindow;
  constexpr size_t part = static_cast<size_t>(T::kSplit) * kRes * DH;  // after the loop
  return sizeof(float) * (main > part ? main : part);
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ mask,
                     float* __restrict__ out, float* __restrict__ lse, int Lq, int Lk, int H,
                     DropoutArgs drop) {
  using T = FwdTiles<DH>;
  constexpr int NT = T::kNT;
  constexpr int KSTEP = kTile * NT;  // keys a step
  constexpr int TK = 4 * NT;         // keys a thread scores: NT aligned quads
  constexpr int P = T::kPitch, CW = T::kCW, NCG = T::kNCG, SPLIT = T::kSplit;
  constexpr int KPER = KSTEP / SPLIT;
  constexpr int kWinKeys = kListWindow * kTile;
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;                        // [DH][64]
  float* sK = sQt + DH * kRes;              // [stages][KSTEP][P]
  float* sV = sK + kF32Stages * KSTEP * P;  // [stages][KSTEP][P]
  float* sM = sV + kF32Stages * KSTEP * P;  // [stages][KSTEP]
  float* sP = sM + kF32Stages * KSTEP;      // [KSTEP][kDsPitch], key-major
  int* sList = reinterpret_cast<int*>(sP + KSTEP * kDsPitch);
  __shared__ __align__(16) float sRow[kRes];  // a step's rescale factors; at the end 1 / l
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
  float* lse_b = lse + static_cast<size_t>(bh) * Lq;

  int n_active = active_key_tiles<kF32Threads / 32>(mb, min(Lk, kWinKeys), sList, &sCount,
                                                    warp, lane);
  if (n_active == 0 && Lk <= kWinKeys) {  // no real key: out = 0 exactly, lse = -1e30
    write_zero_rows<DH>(out + qoff, row_stride, q0, Lq, tid);
    if (tid < kRes && q0 + tid < Lq) lse_b[q0 + tid] = kMaskedScore;
    return;
  }
  load_transposed<DH>(sQt, q + qoff, row_stride, q0, Lq, tid);

  // scores: warp w takes queries 8 w .. 8 w + 7 against 16 key quads of each
  // of the step's NT tiles, lane l and l + 16 the two halves of d: a thread
  // forms 8 queries (its own 4 first, 4 qg .. 4 qg + 3 with qg = 2 w + half)
  // x keys 4 kq .. 4 kq + 3 of each tile over its half, then adds its
  // partner's half of its own 4 through one shuffle per score
  const int half = lane >> 4;
  const int qg = 2 * warp + half;
  const int kq = lane & 15;
  const int rot = (kq >> 1) & 3;
  int koff[4];  // slot j of a quad holds key 4 kq + (j + rot) % 4
#pragma unroll
  for (int j = 0; j < 4; ++j) koff[j] = 4 * kq + ((j + rot) & 3);
  // O += P~ V on the warp's own 8 queries, whose P~ its lanes wrote: thread
  // (rg, cg, ks): queries 4 rg .., columns cg CW .., keys ks KPER ..
  const int cg = lane % NCG, rg = 2 * warp + (lane / NCG) % 2, ks = lane / (2 * NCG);

  float m[4], l[4];  // running max (log2 units) and this thread's share of the row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskedScore;
    l[i] = 0.f;
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

      // S = qs K^T: 8 queries x TK keys over this thread's half of d, then
      // this thread's 4 queries whole
      float s8[8][TK];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) s8[i][j] = 0.f;
#pragma unroll 1
      for (int d0 = half * (DH / 2); d0 < (half + 1) * (DH / 2); d0 += T::kDU) {
#pragma unroll
        for (int d = d0; d < d0 + T::kDU; d += 4) {
          float4 qv[4][2];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qv[e][0] = lds4(sQt + (d + e) * kRes + 4 * qg);
            qv[e][1] = lds4(sQt + (d + e) * kRes + 4 * (qg ^ 1));
          }
#pragma unroll
          for (int j = 0; j < TK; ++j) {
            const float4 kv = lds4(tK + ((j >> 2) * kTile + koff[j & 3]) * P + d);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              float si = s8[i][j];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                si = fmaf(f4_at(qv[e][i >> 2], i & 3), f4_at(kv, e), si);
              s8[i][j] = si;
            }
          }
        }
      }
      float s[4][TK];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j)
          s[i][j] = s8[i][j] + __shfl_xor_sync(0xffffffffu, s8[4 + i][j], 16);

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
      // the online softmax: masked keys enter neither the max nor the sum
      // (selected, never multiplied); the step max over the half-warp
      bool real[TK];
#pragma unroll
      for (int j = 0; j < TK; ++j) real[j] = tM[(j >> 2) * kTile + koff[j & 3]] > 0.f;
      float alpha[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = kMaskedScore;
#pragma unroll
        for (int j = 0; j < TK; ++j) mx = real[j] ? fmaxf(mx, s[i][j]) : mx;
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float mn = fmaxf(m[i], mx * kLog2e);
        alpha[i] = fast_exp2(m[i] - mn);
        m[i] = mn;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          float p = real[j] ? fast_exp2(fmaf(s[i][j], kLog2e, -mn)) : 0.f;
          sum += p;
          if (DROP) p = ((keep[i][j >> 2] >> (j & 3)) & 1u) ? p * drop.inv_keep : 0.f;
          s[i][j] = p;
        }
        l[i] = l[i] * alpha[i] + sum;
      }
      // P~ into sP[key][query]; the rows' rescale factors into sRow
#pragma unroll
      for (int j = 0; j < TK; ++j)
        sts4(sP + ((j >> 2) * kTile + koff[j & 3]) * kDsPitch + 4 * qg, s[0][j], s[1][j],
             s[2][j], s[3][j]);
      if (kq == 0) sts4(sRow + 4 * qg, alpha[0], alpha[1], alpha[2], alpha[3]);
      __syncwarp();

      // O = alpha O + P~ V over this thread's share of the step's keys
      const float4 al = lds4(sRow + 4 * rg);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] *= f4_at(al, i);
#pragma unroll
      for (int kk = ks * KPER; kk < (ks + 1) * KPER; ++kk) {
        const float4 p4 = lds4(sP + kk * kDsPitch + 4 * rg);
        float4 vr[CW / 4];
#pragma unroll
        for (int c = 0; c < CW / 4; ++c) vr[c] = lds4(tV + kk * P + cg * CW + 4 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CW; ++c)
            acc[i][c] = fmaf(f4_at(p4, i), f4_at(vr[c >> 2], c & 3), acc[i][c]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the step's tiles, sP, sRow and the list are consumed
    w0 += kWinKeys;
    if (w0 >= Lk) break;
    n_active = active_key_tiles<kF32Threads / 32>(mb + w0, min(Lk - w0, kWinKeys), sList,
                                                  &sCount, warp, lane);
  }

  // the row sums over the half-warp; lse = ln2 (m2 + log2 l), and -1e30 (as
  // m + log(max(l, 1e-30)) gives it) where no key was real; 1 / l to sRow
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
  if (kq == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 4 * qg + i;
      if (r < Lq) lse_b[r] = l[i] > 0.f ? kLn2 * (m[i] + log2f(l[i])) : kMaskedScore;
    }
    sts4(sRow + 4 * qg, 1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f),
         1.f / fmaxf(l[2], 1e-30f), 1.f / fmaxf(l[3], 1e-30f));
  }
  // the split's partial tiles, then their sum in order, times 1 / l
  float* part = smem;  // [SPLIT][64][DH]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; c += 4)
      sts4(part + (ks * kRes + 4 * rg + i) * DH + cg * CW + c, acc[i][c], acc[i][c + 1],
           acc[i][c + 2], acc[i][c + 3]);
  __syncthreads();
  write_summed_rows<DH>(out + qoff, row_stride, q0, Lq, part, SPLIT, tid, sRow);
}

template <int DH, bool DROP>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v, const void* mask,
                           void* out, void* lse, int B, int Lq, int Lk, int H,
                           const DropoutArgs& drop, cudaStream_t stream) {
  constexpr size_t smem = fwd_f32_smem_bytes<DH>();
  auto kernel = flash_fwd_f32_kernel<DH, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kRes - 1) / kRes, B * H);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(mask), static_cast<float*>(out), static_cast<float*>(lse), Lq,
      Lk, H, drop);
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t dispatch_fwd_f32(const void* q, const void* k, const void* v, const void* mask,
                             void* out, void* lse, int B, int Lq, int Lk, int H, int Dh,
                             const DropoutArgs& d, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch_fwd_f32<16, DROP>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    case 32: return launch_fwd_f32<32, DROP>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    case 48: return launch_fwd_f32<48, DROP>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    case 64: return launch_fwd_f32<64, DROP>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    case 128: return launch_fwd_f32<128, DROP>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace advmil

// q [B, Lq, H, Dh] (pre-scaled), k / v [B, Lk, H, Dh], all f32 or all bf16 and
// contiguous; mask [B, Lk] f32; out [B, Lq, H, Dh] in q's dtype; lse [B*H, Lq]
// f32. Dh in {16, 32, 48, 64, 128}; B*H <= 65535; 0 < Lq, 0 < Lk <= 2^19
// (checked by the Python wrapper). dropout != 0 applies attention dropout
// with the Philox stream of (seed_hi << 32 | seed_lo): keep when bits >=
// threshold, kept probabilities scaled by inv_keep. Returns
// cudaGetLastError() after launch (f32: cudaErrorMisalignedAddress, without a
// launch, for a tensor not 16-byte aligned).
extern "C" int advmil_flash_fwd(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* lse, int B,
                                int Lq, int Lk, int H, int Dh, int dtype,
                                int dropout, unsigned seed_lo, unsigned seed_hi,
                                unsigned threshold, float inv_keep, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const advmil::DropoutArgs d{seed_lo, seed_hi, threshold, inv_keep};
  if (dtype == advmil::kF32) {  // 16-byte loads and stores of rows
    using advmil::aligned16;
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out)))
      return static_cast<int>(cudaErrorMisalignedAddress);
    return dropout ? advmil::dispatch_fwd_f32<true>(q, k, v, mask, out, lse, B, Lq, Lk, H, Dh, d, s)
                   : advmil::dispatch_fwd_f32<false>(q, k, v, mask, out, lse, B, Lq, Lk, H, Dh, d, s);
  }
  if (dtype == advmil::kBF16)
    return advmil::flash_fwd_mma(q, k, v, mask, out, lse, B, Lq, Lk, H, Dh, dropout != 0, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
