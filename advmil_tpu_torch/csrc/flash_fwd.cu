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
// What bounds it on the card: at the ESAT eval shapes (Dh = 48, L ~ 2048) the
// work is 4 * L^2 * Dh flops per head, done here in f32 on the CUDA cores out
// of shared memory, so shared-memory load bandwidth and FMA issue bound it,
// not device memory (each K/V tile is read once per 64-row query tile). The
// TPU kernel's reason to pad Dh to 128 lanes does not apply: Dh = 48 is used
// as it is.
//
// Design: one block per (64-row query tile, batch*head); 8 warps, each owning
// 8 query rows. The block loops over 64-row K/V tiles staged in shared memory
// as f32. Lane l scores keys l and l+32 of the tile for its warp's 8 rows, so
// the row max and row sum are warp shuffles; the probabilities go to a
// warp-private slice of shared memory and lane l accumulates output columns
// l, l+32, ... in registers. Inputs are read in the JAX layout [B, L, H, Dh]
// directly (no fold / transpose copies). Tensor cores (wgmma) and TMA are
// later work; f32 math here also meets the f32 tolerance of the tests.
//
// This kernel serves f32 inputs, whose exact f32 FMAs the f32 tolerances rest
// on. bf16 inputs go to the tensor-core kernel of flash_fwd_mma.cu, which
// computes the same function.
#include "common.cuh"
#include "flash_mma.cuh"
#include "philox.cuh"

namespace advmil {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr float kNegBig = -1e30f;

template <int DH>
constexpr size_t flash_smem_bytes() {
  // sQ [BQ][DH] + sK [BK][DH+1] + sV [BK][DH] + sP [BQ][BK] + sMask [BK]
  return sizeof(float) * (kBQ * DH + kBK * (DH + 1) + kBK * DH + kBQ * kBK + kBK);
}

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(32 * kWarps)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse,
                 int Lq, int Lk, int H, DropoutArgs drop) {
  constexpr int NCOL = (DH + 31) / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* sQ = smem;                        // [BQ][DH]
  float* sK = sQ + kBQ * DH;               // [BK][DH + 1] (padded: no bank conflicts)
  float* sV = sK + kBK * (DH + 1);         // [BK][DH]
  float* sP = sV + kBK * DH;               // [BQ][BK]
  float* sMask = sP + kBQ * kBK;           // [BK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const size_t row_stride = static_cast<size_t>(H) * DH;  // between sequence positions

  const T* qb = q + (static_cast<size_t>(b) * Lq * H + hh) * DH;
  const T* kb = k + (static_cast<size_t>(b) * Lk * H + hh) * DH;
  const T* vb = v + (static_cast<size_t>(b) * Lk * H + hh) * DH;
  const float* mb = mask + static_cast<size_t>(b) * Lk;

  for (int idx = tid; idx < kBQ * DH; idx += 32 * kWarps) {
    const int r = idx / DH, d = idx % DH;
    sQ[idx] = (q0 + r < Lq) ? to_f32(qb[(q0 + r) * row_stride + d]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NCOL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[i][c] = 0.f;
  }

  const int row0 = warp * kRowsPerWarp;
  for (int k0 = 0; k0 < Lk; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and sQ written, first pass)
    for (int idx = tid; idx < kBK * DH; idx += 32 * kWarps) {
      const int r = idx / DH, d = idx % DH;
      const bool in = k0 + r < Lk;
      const size_t g = static_cast<size_t>(k0 + r) * row_stride + d;
      sK[r * (DH + 1) + d] = in ? to_f32(kb[g]) : 0.f;
      sV[idx] = in ? to_f32(vb[g]) : 0.f;
    }
    if (tid < kBK) sMask[tid] = (k0 + tid < Lk && mb[k0 + tid] > 0.f) ? 1.f : 0.f;
    __syncthreads();

    // scores for keys (lane, lane + 32) of this warp's rows
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float k_a = sK[lane * (DH + 1) + d];
      const float k_b = sK[(lane + 32) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float qv = sQ[(row0 + i) * DH + d];
        s[i][0] = fmaf(qv, k_a, s[i][0]);
        s[i][1] = fmaf(qv, k_b, s[i][1]);
      }
    }
    const bool valid_a = sMask[lane] > 0.f;
    const bool valid_b = sMask[lane + 32] > 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float sa = valid_a ? s[i][0] : kNegBig;
      const float sb = valid_b ? s[i][1] : kNegBig;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(sa, sb)));
      const float alpha = expf(m[i] - m_new);
      const float pa = valid_a ? expf(sa - m_new) : 0.f;
      const float pb = valid_b ? expf(sb - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(pa + pb);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) acc[i][c] *= alpha;
      if (DROP) {
        const int r = q0 + row0 + i;
        sP[(row0 + i) * kBK + lane] =
            dropout_keep(drop, bh, r, k0 + lane) ? pa * drop.inv_keep : 0.f;
        sP[(row0 + i) * kBK + lane + 32] =
            dropout_keep(drop, bh, r, k0 + lane + 32) ? pb * drop.inv_keep : 0.f;
      } else {
        sP[(row0 + i) * kBK + lane] = pa;
        sP[(row0 + i) * kBK + lane + 32] = pb;
      }
    }
    __syncwarp();  // sP rows are private to this warp

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[NCOL];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const int col = lane + 32 * c;
        vv[c] = col < DH ? sV[j * DH + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float p = sP[(row0 + i) * kBK + j];
#pragma unroll
        for (int c = 0; c < NCOL; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  T* ob = out + (static_cast<size_t>(b) * Lq * H + hh) * DH;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = q0 + row0 + i;
    if (r >= Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / denom;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int col = lane + 32 * c;
      if (col < DH) ob[r * row_stride + col] = from_f32<T>(acc[i][c] * inv);
    }
    if (lane == 0) lse[static_cast<size_t>(bh) * Lq + r] = m[i] + logf(denom);
  }
}

template <typename T, int DH, bool DROP>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         const void* mask, void* out, void* lse, int B, int Lq,
                         int Lk, int H, const DropoutArgs& drop, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<DH>();
  auto kernel = flash_fwd_kernel<T, DH, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(out),
      static_cast<float*>(lse), Lq, Lk, H, drop);
  return cudaGetLastError();
}

template <typename T, bool DROP>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const void* mask, void* out, void* lse, int B, int Lq,
                        int Lk, int H, int Dh, const DropoutArgs& d, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch_flash<T, 16, DROP>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    case 32: return launch_flash<T, 32, DROP>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    case 48: return launch_flash<T, 48, DROP>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    case 64: return launch_flash<T, 64, DROP>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    case 128: return launch_flash<T, 128, DROP>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_drop(const void* q, const void* k, const void* v,
                          const void* mask, void* out, void* lse, int B, int Lq,
                          int Lk, int H, int Dh, const DropoutArgs& d, bool drop,
                          cudaStream_t s) {
  return drop ? dispatch_dh<T, true>(q, k, v, mask, out, lse, B, Lq, Lk, H, Dh, d, s)
              : dispatch_dh<T, false>(q, k, v, mask, out, lse, B, Lq, Lk, H, Dh, d, s);
}

}  // namespace advmil

// q [B, Lq, H, Dh] (pre-scaled), k / v [B, Lk, H, Dh], all f32 or all bf16 and
// contiguous; mask [B, Lk] f32; out [B, Lq, H, Dh] in q's dtype; lse [B*H, Lq]
// f32. Dh in {16, 32, 48, 64, 128}; B*H <= 65535; 0 < Lq, 0 < Lk <= 2^19
// (checked by the Python wrapper). dropout != 0 applies attention dropout
// with the Philox stream of (seed_hi << 32 | seed_lo): keep when bits >=
// threshold, kept probabilities scaled by inv_keep. Returns
// cudaGetLastError() after launch.
extern "C" int advmil_flash_fwd(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* lse, int B,
                                int Lq, int Lk, int H, int Dh, int dtype,
                                int dropout, unsigned seed_lo, unsigned seed_hi,
                                unsigned threshold, float inv_keep, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const advmil::DropoutArgs d{seed_lo, seed_hi, threshold, inv_keep};
  if (dtype == advmil::kF32)
    return advmil::dispatch_drop<float>(q, k, v, mask, out, lse, B, Lq, Lk, H, Dh, d,
                                        dropout != 0, s);
  if (dtype == advmil::kBF16)
    return advmil::flash_fwd_mma(q, k, v, mask, out, lse, B, Lq, Lk, H, Dh, dropout != 0, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
