// Key-padding-masked flash attention, backward for dQ, bf16 on the tensor
// cores.
//
// The bf16 instantiation of the port of the Pallas TPU kernel
// advmil_tpu/ops/attention.py:_flash_bwd_dq_kernel; flash_bwd.cu holds the
// f32 one (exact f32 FMAs) and the C entry points, and states what is
// computed: with the forward's lse, dvec = rowsum(dO o O) and the per-element
// Philox keep bits, p = exp(qs . k - lse) selected by the key mask,
// dp = dO . v^T keep / (1 - p), dS = p o (dp - dvec), dQ = dS K in f32, not
// yet times 1 / sqrt(Dh).
//
// What bounds it on the card: three products of 2 L keys Dh flops per head
// and one exponential per score, against O(L Dh) bytes per head. As for the
// forward and dK/dV (see flash_fwd_mma.cu for the measurement) the limit is
// the whole instruction stream of a warp, not the tensor cores, the
// exponentials or device memory.
//
// Design: the query tile is the resident side, as in the forward. One block
// per (query tile, batch * head), 4 or 8 warps of 16 queries each; the same
// rule as the forward picks (mma.cuh: 8 warps once the 4-warp grid has
// kWideMinBlocksPerSm blocks per SM; measured for this kernel on an H100 by
// scripts/profile_torch_flash.py --variant wide | narrow, see PERF.md). The qs
// and dO fragments are loaded once and stay in registers (re-read from shared
// memory per key tile at Dh = 128, where they would not fit beside the
// accumulators); lse and dvec are per row of the fragment, two registers
// each. K, V and the mask tile of 64 keys arrive through the 3-stage cp.async
// ring. S = qs K^T and dP = dO V^T take K and V through ldmatrix; P, the keep
// bits and dS live on the accumulator fragment; dS is rounded to bf16 in
// registers and is the A operand of dQ += dS K, whose B operand is the same K
// tile through ldmatrix.trans. Nothing passes through shared memory between
// the products. Key tiles without a real key are skipped exactly, with the
// forward's compacted tile list and its flag for 64 real keys; a bag without
// a real key does no product and writes exact zeros. With dropout one Philox
// block serves four elements (keep_bits_qk). No atomics: dQ is a second
// launch beside dK/dV, each sum in a fixed order.
#include "flash_mma.cuh"
#include "mma.cuh"

namespace advmil {

template <int DH, int NW>
constexpr size_t dq_mma_smem_bytes(int key_tiles) {
  // sQ, sdO + kMmaStages x (sK + sV) tiles, kMmaStages x 64 mask floats, the tile list
  return sizeof(__nv_bfloat16) *
             (2 * tile_elems<DH, 16 * NW>() + tile_elems<DH>() * 2 * kMmaStages) +
         sizeof(float) * kMmaStages * kTile + sizeof(int) * key_tiles;
}

template <int DH, bool DROP, int NW>
__global__ void __launch_bounds__(32 * NW, DH > 64 ? 1 : 2)
flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ qs, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ mask, const float* __restrict__ lse,
                    const float* __restrict__ dvec, float* __restrict__ dq, int Lq, int Lk,
                    int H, DropoutArgs drop) {
  constexpr int KS = DH / 16;    // k-steps of the first products, n8 tile pairs of dQ
  constexpr int NT = kTile / 8;  // n8 tiles per key tile
  constexpr bool kFragsInRegs = DH <= 64;
  constexpr int KF = kFragsInRegs ? KS : 1;
  constexpr int kThreads = 32 * NW;
  constexpr int kBQ = 16 * NW;   // query rows per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + tile_elems<DH, kBQ>();
  __nv_bfloat16* sK = sdO + tile_elems<DH, kBQ>();          // [stages][64][pitch]
  __nv_bfloat16* sV = sK + kMmaStages * tile_elems<DH>();   // [stages][64][pitch]
  float* sMask = reinterpret_cast<float*>(sV + kMmaStages * tile_elems<DH>());  // [stages][64]
  int* sList = reinterpret_cast<int*>(sMask + kMmaStages * kTile);  // active key tiles
  __shared__ int sCount;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const size_t row_stride = static_cast<size_t>(H) * DH;
  const size_t qoff = (static_cast<size_t>(b) * Lq * H + hh) * DH;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Lk * H + hh) * DH;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Lk * H + hh) * DH;
  const float* mb = mask + static_cast<size_t>(b) * Lk;

  load_tile_async<DH, kBQ, kThreads>(sQ, qs + qoff, row_stride, q0, Lq, tid);
  load_tile_async<DH, kBQ, kThreads>(sdO, dout + qoff, row_stride, q0, Lq, tid);
  cp_async_commit();

  const int n_active = active_key_tiles<NW>(mb, Lk, sList, &sCount, warp, lane);

  const int row_g = q0 + warp * 16 + g;  // the query of c0 / c1; c2 / c3 are 8 rows below
  const bool rv0 = row_g < Lq, rv1 = row_g + 8 < Lq;
  float* dq_b = dq + qoff;

  // a bag without a real key: every p is 0, so dQ = 0 exactly
  if (n_active == 0) {
    cp_async_wait<0>();
    for (int idx = tid; idx < kBQ * (DH / 4); idx += kThreads) {
      const int r = idx / (DH / 4), c = idx % (DH / 4);
      if (q0 + r < Lq)
        *reinterpret_cast<float4*>(dq_b + static_cast<size_t>(q0 + r) * row_stride + 4 * c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  // One commit per call, with or without a tile, so that the group count
  // seen by cp_async_wait is the same in every thread and iteration.
  auto prefetch = [&](int a) {
    if (a < n_active) {
      const int k0 = (sList[a] >> 1) * kTile;
      const int st = a % kMmaStages;
      load_tile_async<DH, kTile, kThreads>(sK + st * tile_elems<DH>(), kb, row_stride, k0, Lk, tid);
      load_tile_async<DH, kTile, kThreads>(sV + st * tile_elems<DH>(), vb, row_stride, k0, Lk, tid);
      if (tid < kTile) cp_async_4(sMask + st * kTile + tid, k0 + tid < Lk ? mb + k0 + tid : mb,
                                  k0 + tid < Lk);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int a = 0; a < kMmaStages - 1; ++a) prefetch(a);

  // lse and dvec of this thread's two rows, pre-scaled for exp2
  const float* lse_b = lse + static_cast<size_t>(bh) * Lq;
  const float* dvec_b = dvec + static_cast<size_t>(bh) * Lq;
  const float ls0 = rv0 ? lse_b[row_g] * kLog2e : 0.f;
  const float ls1 = rv1 ? lse_b[row_g + 8] * kLog2e : 0.f;
  const float dv0 = rv0 ? dvec_b[row_g] : 0.f;
  const float dv1 = rv1 ? dvec_b[row_g + 8] : 0.f;

  cp_async_wait<kMmaStages - 1>();  // the qs and dO tiles have landed
  __syncthreads();
  uint32_t qf[KF][4], of[KF][4];
  if (kFragsInRegs) {
#pragma unroll
    for (int ks = 0; ks < KF; ++ks) {
      ldmatrix_x4(qf[ks], frag_addr_rows<DH>(sQ, warp * 16, ks * 16, lane));
      ldmatrix_x4(of[ks], frag_addr_rows<DH>(sdO, warp * 16, ks * 16, lane));
    }
  }

  float acc[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int a = 0; a < n_active; ++a) {
    cp_async_wait<kMmaStages - 2>();  // tile a has landed
    __syncthreads();                  // ... for every thread, and tile a - 1 is consumed
    prefetch(a + kMmaStages - 1);
    const int entry = sList[a];
    const int k0 = (entry >> 1) * kTile;
    const bool full = entry & 1;
    const int st = a % kMmaStages;
    const __nv_bfloat16* tK = sK + st * tile_elems<DH>();
    const __nv_bfloat16* tV = sV + st * tile_elems<DH>();
    const float* tM = sMask + st * kTile;

    // S and dP: 16 queries x 64 keys per warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (!kFragsInRegs) {
        ldmatrix_x4(qf[0], frag_addr_rows<DH>(sQ, warp * 16, ks * 16, lane));
        ldmatrix_x4(of[0], frag_addr_rows<DH>(sdO, warp * 16, ks * 16, lane));
      }
      const uint32_t(&qa)[4] = qf[kFragsInRegs ? ks : 0];
      const uint32_t(&oa)[4] = of[kFragsInRegs ? ks : 0];
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t f[4];
        ldmatrix_x4(f, frag_addr_nk<DH>(tK, jp * 16, ks * 16, lane));
        mma_bf16(s[2 * jp], qa, f[0], f[1]);
        mma_bf16(s[2 * jp + 1], qa, f[2], f[3]);
        ldmatrix_x4(f, frag_addr_nk<DH>(tV, jp * 16, ks * 16, lane));
        mma_bf16(dp[2 * jp], oa, f[0], f[1]);
        mma_bf16(dp[2 * jp + 1], oa, f[2], f[3]);
      }
    }

    // dS into s
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      bool real_a = true, real_b = true;  // the keys of c0 / c2 and of c1 / c3
      if (!full) {
        const float2 mk = *reinterpret_cast<const float2*>(tM + 8 * j + 2 * t);
        real_a = mk.x > 0.f;
        real_b = mk.y > 0.f;
      }
      // exp(s - lse) where key and query are real, else 0: selected, never
      // multiplied (a fully masked row has lse ~ -1e30 and the exponential
      // overflows)
      const float p0 = (real_a && rv0) ? fast_exp2(fmaf(s[j][0], kLog2e, -ls0)) : 0.f;
      const float p1 = (real_b && rv0) ? fast_exp2(fmaf(s[j][1], kLog2e, -ls0)) : 0.f;
      const float p2 = (real_a && rv1) ? fast_exp2(fmaf(s[j][2], kLog2e, -ls1)) : 0.f;
      const float p3 = (real_b && rv1) ? fast_exp2(fmaf(s[j][3], kLog2e, -ls1)) : 0.f;
      float d0 = dp[j][0], d1 = dp[j][1], d2 = dp[j][2], d3 = dp[j][3];
      if (DROP) {
        const uint32_t keep = keep_bits_qk(drop, bh, row_g, k0 + 8 * j, lane);
        d0 = (keep & 1u) ? d0 * drop.inv_keep : 0.f;
        d1 = (keep & 2u) ? d1 * drop.inv_keep : 0.f;
        d2 = (keep & 4u) ? d2 * drop.inv_keep : 0.f;
        d3 = (keep & 8u) ? d3 * drop.inv_keep : 0.f;
      }
      s[j][0] = p0 * (d0 - dv0);
      s[j][1] = p1 * (d1 - dv0);
      s[j][2] = p2 * (d2 - dv1);
      s[j][3] = p3 * (d3 - dv1);
    }

    // dQ += dS K over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < KS; ++np) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, frag_addr_rows<DH>(tK, kk * 16, np * 16, lane));
        mma_bf16(acc[2 * np], da, f[0], f[1]);
        mma_bf16(acc[2 * np + 1], da, f[2], f[3]);
      }
    }
  }
  cp_async_wait<0>();

  if (rv0) {
    float* at = dq_b + static_cast<size_t>(row_g) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
      *reinterpret_cast<float2*>(at + 8 * n) = make_float2(acc[n][0], acc[n][1]);
  }
  if (rv1) {
    float* at = dq_b + static_cast<size_t>(row_g + 8) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
      *reinterpret_cast<float2*>(at + 8 * n) = make_float2(acc[n][2], acc[n][3]);
  }
}

template <int DH, bool DROP, int NW>
cudaError_t launch_dq_mma(const BwdArgs& a, const DropoutArgs& drop, cudaStream_t stream) {
  const size_t smem = dq_mma_smem_bytes<DH, NW>((a.Lk + kTile - 1) / kTile);
  auto kernel = flash_dq_mma_kernel<DH, DROP, NW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + 16 * NW - 1) / (16 * NW), a.B * a.H);
  kernel<<<grid, 32 * NW, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.qs), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.mask), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.dvec), static_cast<float*>(a.dq), a.Lq, a.Lk, a.H, drop);
  return cudaGetLastError();
}

template <bool DROP, int NW>
cudaError_t dispatch_dq_mma(const BwdArgs& a, int Dh, const DropoutArgs& d, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch_dq_mma<16, DROP, NW>(a, d, s);
    case 32: return launch_dq_mma<32, DROP, NW>(a, d, s);
    case 48: return launch_dq_mma<48, DROP, NW>(a, d, s);
    case 64: return launch_dq_mma<64, DROP, NW>(a, d, s);
    case 128: return launch_dq_mma<128, DROP, NW>(a, d, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t flash_dq_mma(const BwdArgs& a, int Dh, bool dropout, const DropoutArgs& d,
                         cudaStream_t stream) {
  if (a.Lk > kMaxKeys) return cudaErrorInvalidValue;
  const long blocks = static_cast<long>((a.Lq + kTile - 1) / kTile) * a.B * a.H;
  bool wide = false;
  const cudaError_t err = use_wide_blocks(blocks, &wide);
  if (err != cudaSuccess) return err;
  if (wide)
    return dropout ? dispatch_dq_mma<true, 8>(a, Dh, d, stream)
                   : dispatch_dq_mma<false, 8>(a, Dh, d, stream);
  return dropout ? dispatch_dq_mma<true, 4>(a, Dh, d, stream)
                 : dispatch_dq_mma<false, 4>(a, Dh, d, stream);
}

}  // namespace advmil
