// Key-padding-masked flash attention, backward for dK and dV, bf16 on the
// tensor cores.
//
// The bf16 instantiation of the port of the Pallas TPU kernel
// advmil_tpu/ops/attention.py:_flash_bwd_dkv_kernel; flash_bwd.cu holds the
// f32 one, the dQ kernel and the C entry points, and states what is computed
// (p, dp, ds, dK_j = sum_i ds_ij qs_i, dV_j = sum_i p~_ij dO_i, with the
// forward's lse and the per-element Philox keep bits).
//
// What bounds it on the card: four products of 2 L^2 Dh flops per head and
// one exponential per score. As in the forward (see flash_fwd_mma.cu for the
// measurement) neither the exponentials nor the tensor cores alone are the
// limit: without its mma.sync products the kernel takes about a tenth less at
// the main path's shapes, and with dropout the Philox integer work adds
// 40-70%. Device memory is not the limit.
//
// Design: one block per (64-key tile, batch * head), 4 warps of 16 keys each,
// looping over 64-query tiles (qs, dO, lse, dvec in a 3-stage cp.async ring).
// (8 warps over 128 keys, which pay in the forward, gained under 6% here at
// any shape and lost 40% at the training shape.)
// The tiles are computed transposed, keys as the M rows: S^T = K qs^T and
// dP^T = V dO^T, with the K and V fragments loaded once and kept in
// registers (re-read from shared memory per query tile at Dh = 128, where
// they would not fit beside the accumulators). P^T (selected by the key mask
// and the query range, never multiplied), P~^T and dS^T = P^T o (dP^T keep /
// (1 - p) - dvec) are then in the accumulator layout, so rounded to bf16 they
// are the A operands of dV += P~^T dO and dK += dS^T qs, with dO and qs
// through ldmatrix.trans: nothing is transposed through shared memory. lse
// and dvec vary along the fragment's columns and are read per column pair.
// A block whose keys are all masked writes zeros and returns. With
// dropout one Philox block serves four elements (keep_bits_kq).
#include "flash_mma.cuh"
#include "mma.cuh"

namespace advmil {

constexpr int kDkvWarps = 4;  // warps per block

template <int DH>
constexpr size_t dkv_mma_smem_bytes() {
  // sK, sV + kMmaStages x (sQ + sdO) tiles + kMmaStages x (lse, dvec) of 64 floats
  return sizeof(__nv_bfloat16) *
             (2 * tile_elems<DH, 16 * kDkvWarps>() + tile_elems<DH>() * 2 * kMmaStages) +
         sizeof(float) * kMmaStages * 2 * kTile;
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(32 * kDkvWarps)
flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ qs, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ mask, const float* __restrict__ lse,
                     const float* __restrict__ dvec, float* __restrict__ dk,
                     float* __restrict__ dv, int Lq, int Lk, int H, DropoutArgs drop) {
  constexpr int KS = DH / 16;          // k-steps of the first products, n8 tile pairs of dK / dV
  constexpr int NT = kTile / 8;        // n8 tiles per query tile
  constexpr bool kFragsInRegs = DH <= 64;
  constexpr int kThreads = 32 * kDkvWarps;
  constexpr int kBK = 16 * kDkvWarps;         // keys per block
  constexpr int KF = kFragsInRegs ? KS : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + tile_elems<DH, kBK>();
  __nv_bfloat16* sQ = sV + tile_elems<DH, kBK>();           // [stages][64][pitch]
  __nv_bfloat16* sdO = sQ + kMmaStages * tile_elems<DH>();  // [stages][64][pitch]
  float* sLse = reinterpret_cast<float*>(sdO + kMmaStages * tile_elems<DH>());  // [stages][64]
  float* sDvec = sLse + kMmaStages * kTile;                                      // [stages][64]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const size_t row_stride = static_cast<size_t>(H) * DH;
  const size_t qoff = (static_cast<size_t>(b) * Lq * H + hh) * DH;
  const size_t koff = (static_cast<size_t>(b) * Lk * H + hh) * DH;
  const float* mb = mask + static_cast<size_t>(b) * Lk;
  const float* lse_b = lse + static_cast<size_t>(bh) * Lq;
  const float* dvec_b = dvec + static_cast<size_t>(bh) * Lq;
  const int key_g = k0 + warp * 16 + g;  // the key of c0 / c1; c2 / c3 are 8 keys below
  const bool kvalid0 = key_g < Lk && mb[key_g] > 0.f;
  const bool kvalid1 = key_g + 8 < Lk && mb[key_g + 8] > 0.f;

  // a tile without a real key: every p is 0, so dK = dV = 0 exactly
  if (!__syncthreads_or(kvalid0 || kvalid1)) {
    for (int idx = tid; idx < kBK * (DH / 4); idx += kThreads) {
      const int r = idx / (DH / 4), c = idx % (DH / 4);
      if (k0 + r < Lk) {
        const size_t at = koff + static_cast<size_t>(k0 + r) * row_stride + 4 * c;
        *reinterpret_cast<float4*>(dk + at) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dv + at) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  load_tile_async<DH, kBK, kThreads>(sK, k + koff, row_stride, k0, Lk, tid);
  load_tile_async<DH, kBK, kThreads>(sV, v + koff, row_stride, k0, Lk, tid);
  cp_async_commit();

  const int q_tiles = (Lq + kTile - 1) / kTile;
  // One commit per call, with or without a tile: uniform group counts.
  auto prefetch = [&](int a) {
    if (a < q_tiles) {
      const int q0 = a * kTile;
      const int st = a % kMmaStages;
      load_tile_async<DH, kTile, kThreads>(sQ + st * tile_elems<DH>(), qs + qoff, row_stride, q0,
                                           Lq, tid);
      load_tile_async<DH, kTile, kThreads>(sdO + st * tile_elems<DH>(), dout + qoff, row_stride,
                                           q0, Lq, tid);
      const int i = tid & (kTile - 1);
      const bool in = q0 + i < Lq;
      if (tid < kTile) cp_async_4(sLse + st * kTile + i, in ? lse_b + q0 + i : lse_b, in);
      else if (tid < 2 * kTile)
        cp_async_4(sDvec + st * kTile + i, in ? dvec_b + q0 + i : dvec_b, in);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int a = 0; a < kMmaStages - 1; ++a) prefetch(a);

  cp_async_wait<kMmaStages - 1>();  // the K and V tiles have landed
  __syncthreads();
  uint32_t kf[KF][4], vf[KF][4];
  if (kFragsInRegs) {
#pragma unroll
    for (int ks = 0; ks < KF; ++ks) {
      ldmatrix_x4(kf[ks], frag_addr_rows<DH>(sK, warp * 16, ks * 16, lane));
      ldmatrix_x4(vf[ks], frag_addr_rows<DH>(sV, warp * 16, ks * 16, lane));
    }
  }

  float acc_dk[2 * KS][4], acc_dv[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    acc_dk[n][0] = acc_dk[n][1] = acc_dk[n][2] = acc_dk[n][3] = 0.f;
    acc_dv[n][0] = acc_dv[n][1] = acc_dv[n][2] = acc_dv[n][3] = 0.f;
  }

  for (int a = 0; a < q_tiles; ++a) {
    cp_async_wait<kMmaStages - 2>();  // query tile a has landed
    __syncthreads();                  // ... for every thread, and tile a - 1 is consumed
    prefetch(a + kMmaStages - 1);
    const int q0 = a * kTile;
    const int st = a % kMmaStages;
    const __nv_bfloat16* tQ = sQ + st * tile_elems<DH>();
    const __nv_bfloat16* tO = sdO + st * tile_elems<DH>();
    const float* tL = sLse + st * kTile;
    const float* tD = sDvec + st * kTile;

    // S^T and dP^T: 16 keys x 64 queries per warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (!kFragsInRegs) {
        ldmatrix_x4(kf[0], frag_addr_rows<DH>(sK, warp * 16, ks * 16, lane));
        ldmatrix_x4(vf[0], frag_addr_rows<DH>(sV, warp * 16, ks * 16, lane));
      }
      const uint32_t(&ka)[4] = kf[kFragsInRegs ? ks : 0];
      const uint32_t(&va)[4] = vf[kFragsInRegs ? ks : 0];
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t f[4];
        ldmatrix_x4(f, frag_addr_nk<DH>(tQ, jp * 16, ks * 16, lane));
        mma_bf16(s[2 * jp], ka, f[0], f[1]);
        mma_bf16(s[2 * jp + 1], ka, f[2], f[3]);
        ldmatrix_x4(f, frag_addr_nk<DH>(tO, jp * 16, ks * 16, lane));
        mma_bf16(dp[2 * jp], va, f[0], f[1]);
        mma_bf16(dp[2 * jp + 1], va, f[2], f[3]);
      }
    }

    // P~^T into s, dS^T into dp
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int qa = q0 + 8 * j + 2 * t;  // the query of c0 / c2; c1 / c3 are the next one
      const float2 ls = *reinterpret_cast<const float2*>(tL + 8 * j + 2 * t);
      const float2 dvv = *reinterpret_cast<const float2*>(tD + 8 * j + 2 * t);
      const bool qa_in = qa < Lq, qb_in = qa + 1 < Lq;
      const float la = ls.x * kLog2e, lb = ls.y * kLog2e;
      // exp(s - lse) where key and query are real, else 0: selected, since a
      // fully masked row has lse ~ -1e30 and the exponential overflows
      const float p0 = (kvalid0 && qa_in) ? fast_exp2(fmaf(s[j][0], kLog2e, -la)) : 0.f;
      const float p1 = (kvalid0 && qb_in) ? fast_exp2(fmaf(s[j][1], kLog2e, -lb)) : 0.f;
      const float p2 = (kvalid1 && qa_in) ? fast_exp2(fmaf(s[j][2], kLog2e, -la)) : 0.f;
      const float p3 = (kvalid1 && qb_in) ? fast_exp2(fmaf(s[j][3], kLog2e, -lb)) : 0.f;
      float pt0 = p0, pt1 = p1, pt2 = p2, pt3 = p3;
      float d0 = dp[j][0], d1 = dp[j][1], d2 = dp[j][2], d3 = dp[j][3];
      if (DROP) {
        const uint32_t keep = keep_bits_kq(drop, bh, k0 + warp * 16, q0 + 8 * j, lane);
        pt0 = (keep & 1u) ? p0 * drop.inv_keep : 0.f;
        pt1 = (keep & 2u) ? p1 * drop.inv_keep : 0.f;
        pt2 = (keep & 4u) ? p2 * drop.inv_keep : 0.f;
        pt3 = (keep & 8u) ? p3 * drop.inv_keep : 0.f;
        d0 = (keep & 1u) ? d0 * drop.inv_keep : 0.f;
        d1 = (keep & 2u) ? d1 * drop.inv_keep : 0.f;
        d2 = (keep & 4u) ? d2 * drop.inv_keep : 0.f;
        d3 = (keep & 8u) ? d3 * drop.inv_keep : 0.f;
      }
      s[j][0] = pt0;
      s[j][1] = pt1;
      s[j][2] = pt2;
      s[j][3] = pt3;
      dp[j][0] = p0 * (d0 - dvv.x);
      dp[j][1] = p1 * (d1 - dvv.y);
      dp[j][2] = p2 * (d2 - dvv.x);
      dp[j][3] = p3 * (d3 - dvv.y);
    }

    // dV += P~^T dO, dK += dS^T qs over the tile's 64 queries
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < KS; ++np) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, frag_addr_rows<DH>(tO, kk * 16, np * 16, lane));
        mma_bf16(acc_dv[2 * np], pa, f[0], f[1]);
        mma_bf16(acc_dv[2 * np + 1], pa, f[2], f[3]);
        ldmatrix_x4_trans(f, frag_addr_rows<DH>(tQ, kk * 16, np * 16, lane));
        mma_bf16(acc_dk[2 * np], da, f[0], f[1]);
        mma_bf16(acc_dk[2 * np + 1], da, f[2], f[3]);
      }
    }
  }
  cp_async_wait<0>();

  if (key_g < Lk) {
    const size_t at = koff + static_cast<size_t>(key_g) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      *reinterpret_cast<float2*>(dk + at + 8 * n) = make_float2(acc_dk[n][0], acc_dk[n][1]);
      *reinterpret_cast<float2*>(dv + at + 8 * n) = make_float2(acc_dv[n][0], acc_dv[n][1]);
    }
  }
  if (key_g + 8 < Lk) {
    const size_t at = koff + static_cast<size_t>(key_g + 8) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      *reinterpret_cast<float2*>(dk + at + 8 * n) = make_float2(acc_dk[n][2], acc_dk[n][3]);
      *reinterpret_cast<float2*>(dv + at + 8 * n) = make_float2(acc_dv[n][2], acc_dv[n][3]);
    }
  }
}

template <int DH, bool DROP>
cudaError_t launch_dkv_mma(const BwdArgs& a, const DropoutArgs& drop, cudaStream_t stream) {
  constexpr size_t smem = dkv_mma_smem_bytes<DH>();
  auto kernel = flash_dkv_mma_kernel<DH, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + 16 * kDkvWarps - 1) / (16 * kDkvWarps), a.B * a.H);
  kernel<<<grid, 32 * kDkvWarps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.qs), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.mask), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.dvec), static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.Lq, a.Lk, a.H, drop);
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t dispatch_dkv_mma(const BwdArgs& a, int Dh, const DropoutArgs& d, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch_dkv_mma<16, DROP>(a, d, s);
    case 32: return launch_dkv_mma<32, DROP>(a, d, s);
    case 48: return launch_dkv_mma<48, DROP>(a, d, s);
    case 64: return launch_dkv_mma<64, DROP>(a, d, s);
    case 128: return launch_dkv_mma<128, DROP>(a, d, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t flash_dkv_mma(const BwdArgs& a, int Dh, bool dropout, const DropoutArgs& d,
                          cudaStream_t stream) {
  return dropout ? dispatch_dkv_mma<true>(a, Dh, d, stream)
                 : dispatch_dkv_mma<false>(a, Dh, d, stream);
}

}  // namespace advmil
