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
// What bounds it on the card: like the forward, f32 FMAs on the CUDA cores out
// of shared memory (2 L^2 Dh for the scores, 2 L^2 Dh for dP, 2 L^2 Dh for
// each product per kernel), plus, with dropout, one Philox block per element
// (the 4 words of a block are not shared between lanes yet). Device memory
// traffic is O(L Dh) per (bh): each K/V (or Q/dO) tile is read once per tile
// of the other side.
//
// Design (both kernels): 8 warps of 32 lanes, 64-row tiles. The inputs are
// read in the JAX layout [B, L, H, Dh] (no fold / pad copies); tiles are
// staged in shared memory as f32, rows padded to Dh + 1 where lanes read
// different rows, so those reads are free of bank conflicts.
//  - dQ: one block per (64-query tile, bh) loops over 64-key tiles. A warp
//    owns 8 query rows; lane l scores keys l and l + 32, so dp and ds come
//    from the same register tile; ds goes to a warp-private slice of shared
//    memory and lane l accumulates dQ columns l, l + 32 in registers.
//  - dK/dV: one block per (64-key tile, bh) loops over 64-query tiles. A warp
//    owns 8 keys; lane l takes queries l and l + 32. p~ and ds go to shared
//    memory, then lane l accumulates columns l, l + 32 of dK and dV for its
//    warp's 8 keys: two accumulators of 8 x 2 floats, 32 registers, which
//    keeps the kernel clear of spills at Dh = 48.
// Register tiles of 8 x 2 scores keep the FMA pipes fed without tensor
// cores; wgmma / TMA are later work.
#include "common.cuh"
#include "philox.cuh"

namespace advmil {

constexpr int kBT = 64;  // rows of a query or key tile
constexpr int kBWarps = 8;
constexpr int kRowsW = kBT / kBWarps;  // rows (or keys) per warp

template <int DH>
constexpr size_t dq_smem_bytes() {
  // sQ [BT][DH] + sdO [BT][DH] + sK [BT][DH+1] + sV [BT][DH+1] + sDS [BT][BT] + sMask [BT]
  return sizeof(float) * (2 * kBT * DH + 2 * kBT * (DH + 1) + kBT * kBT + kBT);
}

template <int DH>
constexpr size_t dkv_smem_bytes() {
  // sQ [BT][DH+1] + sdO [BT][DH+1] + sK [BT][DH] + sV [BT][DH] + sPT, sDS [BT][BT]
  // + sLse, sDvec [BT]
  return sizeof(float) * (2 * kBT * (DH + 1) + 2 * kBT * DH + 2 * kBT * kBT + 2 * kBT);
}

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(32 * kBWarps)
flash_bwd_dq_kernel(const T* __restrict__ qs, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ mask, const float* __restrict__ lse,
                    const float* __restrict__ dvec, float* __restrict__ dq, int Lq,
                    int Lk, int H, DropoutArgs drop) {
  constexpr int NCOL = (DH + 31) / 32;
  extern __shared__ float smem[];
  float* sQ = smem;                       // [BT][DH]
  float* sdO = sQ + kBT * DH;             // [BT][DH]
  float* sK = sdO + kBT * DH;             // [BT][DH + 1]
  float* sV = sK + kBT * (DH + 1);        // [BT][DH + 1]
  float* sDS = sV + kBT * (DH + 1);       // [BT][BT], rows private to a warp
  float* sMask = sDS + kBT * kBT;         // [BT]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBT;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const size_t row_stride = static_cast<size_t>(H) * DH;
  const size_t qoff = (static_cast<size_t>(b) * Lq * H + hh) * DH;
  const size_t koff = (static_cast<size_t>(b) * Lk * H + hh) * DH;
  const float* mb = mask + static_cast<size_t>(b) * Lk;

  for (int idx = tid; idx < kBT * DH; idx += 32 * kBWarps) {
    const int r = idx / DH, d = idx % DH;
    const bool in = q0 + r < Lq;
    const size_t g = qoff + (q0 + r) * row_stride + d;
    sQ[idx] = in ? to_f32(qs[g]) : 0.f;
    sdO[idx] = in ? to_f32(dout[g]) : 0.f;
  }
  const int row0 = warp * kRowsW;
  float lse_r[kRowsW], dvec_r[kRowsW], acc[kRowsW][NCOL];
#pragma unroll
  for (int i = 0; i < kRowsW; ++i) {
    const int r = q0 + row0 + i;
    lse_r[i] = r < Lq ? lse[static_cast<size_t>(bh) * Lq + r] : 0.f;
    dvec_r[i] = r < Lq ? dvec[static_cast<size_t>(bh) * Lq + r] : 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += kBT) {
    __syncthreads();  // previous tile consumed (and sQ / sdO written, first pass)
    for (int idx = tid; idx < kBT * DH; idx += 32 * kBWarps) {
      const int r = idx / DH, d = idx % DH;
      const bool in = k0 + r < Lk;
      const size_t g = koff + (k0 + r) * row_stride + d;
      sK[r * (DH + 1) + d] = in ? to_f32(k[g]) : 0.f;
      sV[r * (DH + 1) + d] = in ? to_f32(v[g]) : 0.f;
    }
    if (tid < kBT) sMask[tid] = (k0 + tid < Lk && mb[k0 + tid] > 0.f) ? 1.f : 0.f;
    __syncthreads();

    float s[kRowsW][2], dp[kRowsW][2];
#pragma unroll
    for (int i = 0; i < kRowsW; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float k_a = sK[lane * (DH + 1) + d];
      const float k_b = sK[(lane + 32) * (DH + 1) + d];
      const float v_a = sV[lane * (DH + 1) + d];
      const float v_b = sV[(lane + 32) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsW; ++i) {
        const float qv = sQ[(row0 + i) * DH + d];
        const float ov = sdO[(row0 + i) * DH + d];
        s[i][0] = fmaf(qv, k_a, s[i][0]);
        s[i][1] = fmaf(qv, k_b, s[i][1]);
        dp[i][0] = fmaf(ov, v_a, dp[i][0]);
        dp[i][1] = fmaf(ov, v_b, dp[i][1]);
      }
    }
    const bool valid_a = sMask[lane] > 0.f;
    const bool valid_b = sMask[lane + 32] > 0.f;
#pragma unroll
    for (int i = 0; i < kRowsW; ++i) {
      const int r = q0 + row0 + i;
      const bool rv = r < Lq;
      const float pa = (valid_a && rv) ? expf(s[i][0] - lse_r[i]) : 0.f;
      const float pb = (valid_b && rv) ? expf(s[i][1] - lse_r[i]) : 0.f;
      float dpa = dp[i][0], dpb = dp[i][1];
      if (DROP) {
        dpa = dropout_keep(drop, bh, r, k0 + lane) ? dpa * drop.inv_keep : 0.f;
        dpb = dropout_keep(drop, bh, r, k0 + lane + 32) ? dpb * drop.inv_keep : 0.f;
      }
      sDS[(row0 + i) * kBT + lane] = pa * (dpa - dvec_r[i]);
      sDS[(row0 + i) * kBT + lane + 32] = pb * (dpb - dvec_r[i]);
    }
    __syncwarp();  // sDS rows are private to this warp

#pragma unroll 4
    for (int j = 0; j < kBT; ++j) {
      float kk[NCOL];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const int col = lane + 32 * c;
        kk[c] = col < DH ? sK[j * (DH + 1) + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsW; ++i) {
        const float ds = sDS[(row0 + i) * kBT + j];
#pragma unroll
        for (int c = 0; c < NCOL; ++c) acc[i][c] = fmaf(ds, kk[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsW; ++i) {
    const int r = q0 + row0 + i;
    if (r >= Lq) continue;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int col = lane + 32 * c;
      if (col < DH) dq[qoff + r * row_stride + col] = acc[i][c];
    }
  }
}

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(32 * kBWarps)
flash_bwd_dkv_kernel(const T* __restrict__ qs, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ mask, const float* __restrict__ lse,
                     const float* __restrict__ dvec, float* __restrict__ dk,
                     float* __restrict__ dv, int Lq, int Lk, int H, DropoutArgs drop) {
  constexpr int NCOL = (DH + 31) / 32;
  extern __shared__ float smem[];
  float* sQ = smem;                       // [BT][DH + 1]
  float* sdO = sQ + kBT * (DH + 1);       // [BT][DH + 1]
  float* sK = sdO + kBT * (DH + 1);       // [BT][DH]
  float* sV = sK + kBT * DH;              // [BT][DH]
  float* sPT = sV + kBT * DH;             // [BT keys][BT queries], rows private to a warp
  float* sDS = sPT + kBT * kBT;           // [BT keys][BT queries]
  float* sLse = sDS + kBT * kBT;          // [BT]
  float* sDvec = sLse + kBT;              // [BT]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = blockIdx.x * kBT;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const size_t row_stride = static_cast<size_t>(H) * DH;
  const size_t qoff = (static_cast<size_t>(b) * Lq * H + hh) * DH;
  const size_t koff = (static_cast<size_t>(b) * Lk * H + hh) * DH;
  const float* mb = mask + static_cast<size_t>(b) * Lk;

  for (int idx = tid; idx < kBT * DH; idx += 32 * kBWarps) {
    const int r = idx / DH, d = idx % DH;
    const bool in = k0 + r < Lk;
    const size_t g = koff + (k0 + r) * row_stride + d;
    sK[idx] = in ? to_f32(k[g]) : 0.f;
    sV[idx] = in ? to_f32(v[g]) : 0.f;
  }
  const int key0 = warp * kRowsW;  // this warp's keys in the tile
  bool kvalid[kRowsW];
  float acc_dk[kRowsW][NCOL], acc_dv[kRowsW][NCOL];
#pragma unroll
  for (int jj = 0; jj < kRowsW; ++jj) {
    const int key = k0 + key0 + jj;
    kvalid[jj] = key < Lk && mb[key] > 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc_dk[jj][c] = acc_dv[jj][c] = 0.f;
  }

  for (int q0 = 0; q0 < Lq; q0 += kBT) {
    __syncthreads();  // previous query tile consumed (and sK / sV written)
    for (int idx = tid; idx < kBT * DH; idx += 32 * kBWarps) {
      const int r = idx / DH, d = idx % DH;
      const bool in = q0 + r < Lq;
      const size_t g = qoff + (q0 + r) * row_stride + d;
      sQ[r * (DH + 1) + d] = in ? to_f32(qs[g]) : 0.f;
      sdO[r * (DH + 1) + d] = in ? to_f32(dout[g]) : 0.f;
    }
    if (tid < kBT) {
      const bool in = q0 + tid < Lq;
      sLse[tid] = in ? lse[static_cast<size_t>(bh) * Lq + q0 + tid] : 0.f;
      sDvec[tid] = in ? dvec[static_cast<size_t>(bh) * Lq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // scores and dP for this warp's keys x queries (lane, lane + 32)
    float s[kRowsW][2], dp[kRowsW][2];
#pragma unroll
    for (int jj = 0; jj < kRowsW; ++jj) s[jj][0] = s[jj][1] = dp[jj][0] = dp[jj][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float q_a = sQ[lane * (DH + 1) + d];
      const float q_b = sQ[(lane + 32) * (DH + 1) + d];
      const float o_a = sdO[lane * (DH + 1) + d];
      const float o_b = sdO[(lane + 32) * (DH + 1) + d];
#pragma unroll
      for (int jj = 0; jj < kRowsW; ++jj) {
        const float kd = sK[(key0 + jj) * DH + d];
        const float vd = sV[(key0 + jj) * DH + d];
        s[jj][0] = fmaf(q_a, kd, s[jj][0]);
        s[jj][1] = fmaf(q_b, kd, s[jj][1]);
        dp[jj][0] = fmaf(o_a, vd, dp[jj][0]);
        dp[jj][1] = fmaf(o_b, vd, dp[jj][1]);
      }
    }
    const int qa = q0 + lane, qb = q0 + lane + 32;
    const bool qa_in = qa < Lq, qb_in = qb < Lq;
    const float lse_a = sLse[lane], lse_b = sLse[lane + 32];
    const float dvec_a = sDvec[lane], dvec_b = sDvec[lane + 32];
#pragma unroll
    for (int jj = 0; jj < kRowsW; ++jj) {
      const int key = k0 + key0 + jj;
      const float pa = (kvalid[jj] && qa_in) ? expf(s[jj][0] - lse_a) : 0.f;
      const float pb = (kvalid[jj] && qb_in) ? expf(s[jj][1] - lse_b) : 0.f;
      float pta = pa, ptb = pb, dpa = dp[jj][0], dpb = dp[jj][1];
      if (DROP) {
        const bool ka = dropout_keep(drop, bh, qa, key);
        const bool kb = dropout_keep(drop, bh, qb, key);
        pta = ka ? pa * drop.inv_keep : 0.f;
        ptb = kb ? pb * drop.inv_keep : 0.f;
        dpa = ka ? dpa * drop.inv_keep : 0.f;
        dpb = kb ? dpb * drop.inv_keep : 0.f;
      }
      sPT[(key0 + jj) * kBT + lane] = pta;
      sPT[(key0 + jj) * kBT + lane + 32] = ptb;
      sDS[(key0 + jj) * kBT + lane] = pa * (dpa - dvec_a);
      sDS[(key0 + jj) * kBT + lane + 32] = pb * (dpb - dvec_b);
    }
    __syncwarp();  // sPT / sDS rows are private to this warp

#pragma unroll 2
    for (int i = 0; i < kBT; ++i) {
      float qv[NCOL], ov[NCOL];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const int col = lane + 32 * c;
        qv[c] = col < DH ? sQ[i * (DH + 1) + col] : 0.f;
        ov[c] = col < DH ? sdO[i * (DH + 1) + col] : 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < kRowsW; ++jj) {
        const float pt = sPT[(key0 + jj) * kBT + i];
        const float ds = sDS[(key0 + jj) * kBT + i];
#pragma unroll
        for (int c = 0; c < NCOL; ++c) {
          acc_dv[jj][c] = fmaf(pt, ov[c], acc_dv[jj][c]);
          acc_dk[jj][c] = fmaf(ds, qv[c], acc_dk[jj][c]);
        }
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < kRowsW; ++jj) {
    const int key = k0 + key0 + jj;
    if (key >= Lk) continue;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int col = lane + 32 * c;
      if (col < DH) {
        dk[koff + key * row_stride + col] = acc_dk[jj][c];
        dv[koff + key * row_stride + col] = acc_dv[jj][c];
      }
    }
  }
}

struct BwdArgs {
  const void *qs, *k, *v, *dout, *mask, *lse, *dvec;
  void *dq, *dk, *dv;
  int B, Lq, Lk, H;
};

template <typename T, int DH, bool DROP>
cudaError_t launch_dq(const BwdArgs& a, const DropoutArgs& drop, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DH>();
  auto kernel = flash_bwd_dq_kernel<T, DH, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kBT - 1) / kBT, a.B * a.H);
  kernel<<<grid, 32 * kBWarps, smem, stream>>>(
      static_cast<const T*>(a.qs), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.mask),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dvec),
      static_cast<float*>(a.dq), a.Lq, a.Lk, a.H, drop);
  return cudaGetLastError();
}

template <typename T, int DH, bool DROP>
cudaError_t launch_dkv(const BwdArgs& a, const DropoutArgs& drop, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DH>();
  auto kernel = flash_bwd_dkv_kernel<T, DH, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + kBT - 1) / kBT, a.B * a.H);
  kernel<<<grid, 32 * kBWarps, smem, stream>>>(
      static_cast<const T*>(a.qs), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.mask),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dvec),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Lq, a.Lk, a.H, drop);
  return cudaGetLastError();
}

// which: 0 = dQ, 1 = dK/dV
template <typename T, bool DROP>
cudaError_t dispatch_bwd(int which, const BwdArgs& a, int Dh, const DropoutArgs& d,
                         cudaStream_t s) {
#define ADVMIL_BWD_CASE(DH)                                                    \
  case DH:                                                                     \
    return which == 0 ? launch_dq<T, DH, DROP>(a, d, s) : launch_dkv<T, DH, DROP>(a, d, s);
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

template <typename T>
int bwd_entry(int which, const BwdArgs& a, int Dh, int dropout, const DropoutArgs& d,
              cudaStream_t s) {
  return static_cast<int>(dropout ? dispatch_bwd<T, true>(which, a, Dh, d, s)
                                  : dispatch_bwd<T, false>(which, a, Dh, d, s));
}

int bwd_dtype(int which, const BwdArgs& a, int Dh, int dtype, int dropout,
              const DropoutArgs& d, cudaStream_t s) {
  if (dtype == kF32) return bwd_entry<float>(which, a, Dh, dropout, d, s);
  if (dtype == kBF16) return bwd_entry<__nv_bfloat16>(which, a, Dh, dropout, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace advmil

// Common arguments of both entry points: qs [B, Lq, H, Dh] (pre-scaled by
// 1/sqrt(Dh), as in the forward), k / v [B, Lk, H, Dh], dout [B, Lq, H, Dh], all
// f32 or all bf16, contiguous; mask [B, Lk] f32; lse and dvec [B*H, Lq] f32.
// Dh in {16, 32, 48, 64, 128}; B*H <= 65535 (checked by the Python wrapper).
// The dropout arguments are the forward's. Each returns cudaGetLastError()
// after its launch.

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
