// Key-padding-masked flash attention, forward, bf16 on the tensor cores.
//
// The bf16 instantiation of the port of the Pallas TPU kernel
// advmil_tpu/ops/attention.py:_flash_fwd_kernel; flash_fwd.cu holds the f32
// one (exact f32 FMAs) and the C entry point, and states what is computed:
// out, and lse = m + log(max(l, 1e-30)) of the undropped weights, a fully
// masked query giving out = 0 and lse = -1e30 + log(1e-30). Dropout acts on
// the normalised probabilities with the per-element Philox stream of
// philox.cuh.
//
// What bounds it on the card: at Dh = 48 a score costs 192 tensor-core flops
// and one exponential, and an SM retires 16 exponentials a clock, so the
// design expected the exponentials to outlast the products and chose mma.sync
// (FlashAttention-2's register-resident structure) over wgmma, whose swizzle
// atoms Dh = 48 rows (96 bytes) do not fit unpadded. Measured on an H100
// (scripts/profile_torch_flash.py --variant): without its exponentials the
// kernel takes the same time, without its mma.sync products 7% (L = 2,048)
// to 11% (L = 4,096) less. What is left is everything else a warp executes
// (loads, ldmatrix, the softmax arithmetic: ~350 operations a warp and tile
// against 48 mma) and, on a large grid, the K and V tiles' way from L2 to
// shared memory, once per query tile. Device memory is not the limit.
//
// Design: one block per (query tile, batch * head), 4 or 8 warps of 16 query
// rows each (mma.cuh says when which). Q fragments are loaded once and stay
// in registers. K, V and the mask tile of 64 keys arrive through a 3-stage
// cp.async ring (16-byte chunks straight from the JAX layout [B, L, H, Dh];
// rows beyond L zero-filled).
// S = Q K^T takes K through ldmatrix, the online softmax runs in f32 on the
// accumulator fragment (a row lives in the 4 lanes of a quad), P is rounded
// to bf16 in registers and is the A operand of O += P V, with V through
// ldmatrix.trans: P never reaches shared memory. The row sum l adds the
// unrounded f32 p. Before the loop the block lists the key tiles that hold a
// real key: a tile without one adds exactly 0 to l and O and leaves m alone,
// so it is neither loaded nor computed, and a tile of 64 real keys skips the
// per-element mask. With dropout one Philox block serves four elements
// (keep_bits_qk).
#include "flash_mma.cuh"
#include "mma.cuh"

namespace advmil {

template <int DH, int NW>
constexpr size_t fwd_mma_smem_bytes(int key_tiles) {
  // sQ + kMmaStages x (sK + sV) tiles, kMmaStages x 64 mask floats, the tile list
  return sizeof(__nv_bfloat16) * (tile_elems<DH, 16 * NW>() + tile_elems<DH>() * 2 * kMmaStages) +
         sizeof(float) * kMmaStages * kTile + sizeof(int) * key_tiles;
}

template <int DH, bool DROP, int NW>
__global__ void __launch_bounds__(32 * NW, DH > 64 ? 1 : NW == 8 ? 2 : 3)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Lq, int Lk,
                     int H, DropoutArgs drop) {
  constexpr int KS = DH / 16;   // k-steps of Q K^T, and pairs of output n8 tiles
  constexpr int NT = kTile / 8;  // score n8 tiles per key tile
  constexpr int kThreads = 32 * NW;
  constexpr int kBQ = 16 * NW;   // query rows per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + tile_elems<DH, kBQ>();          // [stages][64][pitch]
  __nv_bfloat16* sV = sK + kMmaStages * tile_elems<DH>();  // [stages][64][pitch]
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
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Lq * H + hh) * DH;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Lk * H + hh) * DH;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Lk * H + hh) * DH;
  const float* mb = mask + static_cast<size_t>(b) * Lk;

  load_tile_async<DH, kBQ, kThreads>(sQ, qb, row_stride, q0, Lq, tid);
  cp_async_commit();

  const int n_active = active_key_tiles<NW>(mb, Lk, sList, &sCount, warp, lane);

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

  cp_async_wait<kMmaStages - 1>();  // the Q tile has landed
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qf[ks], frag_addr_rows<DH>(sQ, warp * 16, ks * 16, lane));

  float o[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kMaskedScore, m1 = kMaskedScore;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;                    // this thread's share of the row sums
  const int row_g = q0 + warp * 16 + g;

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

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, frag_addr_nk<DH>(tK, jp * 16, ks * 16, lane));
        mma_bf16(s[2 * jp], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[ks], kf[2], kf[3]);
      }
    }
    if (!full) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 mk = *reinterpret_cast<const float2*>(tM + 8 * j + 2 * t);
        if (!(mk.x > 0.f)) s[j][0] = s[j][2] = kMaskedScore;
        if (!(mk.y > 0.f)) s[j][1] = s[j][3] = kMaskedScore;
      }
    }
    float mx0 = kMaskedScore, mx1 = kMaskedScore;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = fast_exp2((m0 - mn0) * kLog2e), alpha1 = fast_exp2((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    const float ms0 = mn0 * kLog2e, ms1 = mn1 * kLog2e;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // exp(s - m), the masked elements selected to 0 (never multiplied)
      float p0 = fast_exp2(fmaf(s[j][0], kLog2e, -ms0));
      float p1 = fast_exp2(fmaf(s[j][1], kLog2e, -ms0));
      float p2 = fast_exp2(fmaf(s[j][2], kLog2e, -ms1));
      float p3 = fast_exp2(fmaf(s[j][3], kLog2e, -ms1));
      if (!full) {
        p0 = s[j][0] <= kMaskedScore ? 0.f : p0;
        p1 = s[j][1] <= kMaskedScore ? 0.f : p1;
        p2 = s[j][2] <= kMaskedScore ? 0.f : p2;
        p3 = s[j][3] <= kMaskedScore ? 0.f : p3;
      }
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      if (DROP) {
        const uint32_t keep = keep_bits_qk(drop, bh, row_g, k0 + 8 * j, lane);
        p0 = (keep & 1u) ? p0 * drop.inv_keep : 0.f;
        p1 = (keep & 2u) ? p1 * drop.inv_keep : 0.f;
        p2 = (keep & 4u) ? p2 * drop.inv_keep : 0.f;
        p3 = (keep & 8u) ? p3 * drop.inv_keep : 0.f;
      }
      s[j][0] = p0;
      s[j][1] = p1;
      s[j][2] = p2;
      s[j][3] = p3;
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < KS; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, frag_addr_rows<DH>(tV, kk * 16, np * 16, lane));
        mma_bf16(o[2 * np], pa, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / den0, inv1 = 1.f / den1;
  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * Lq * H + hh) * DH;
  if (row_g < Lq) {
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_g * row_stride + 8 * n + 2 * t) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (t == 0) lse[static_cast<size_t>(bh) * Lq + row_g] = m0 + logf(den0);
  }
  if (row_g + 8 < Lq) {
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + (row_g + 8) * row_stride + 8 * n + 2 * t) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
    if (t == 0) lse[static_cast<size_t>(bh) * Lq + row_g + 8] = m1 + logf(den1);
  }
}

template <int DH, bool DROP, int NW>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, const void* mask,
                           void* out, void* lse, int B, int Lq, int Lk, int H,
                           const DropoutArgs& drop, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem_bytes<DH, NW>((Lk + kTile - 1) / kTile);
  auto kernel = flash_fwd_mma_kernel<DH, DROP, NW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + 16 * NW - 1) / (16 * NW), B * H);
  kernel<<<grid, 32 * NW, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Lq, Lk, H, drop);
  return cudaGetLastError();
}

template <bool DROP, int NW>
cudaError_t dispatch_fwd_mma(const void* q, const void* k, const void* v, const void* mask,
                             void* out, void* lse, int B, int Lq, int Lk, int H, int Dh,
                             const DropoutArgs& d, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch_fwd_mma<16, DROP, NW>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    case 32: return launch_fwd_mma<32, DROP, NW>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    case 48: return launch_fwd_mma<48, DROP, NW>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    case 64: return launch_fwd_mma<64, DROP, NW>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    case 128: return launch_fwd_mma<128, DROP, NW>(q, k, v, mask, out, lse, B, Lq, Lk, H, d, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int NW>
cudaError_t dispatch_fwd_drop(const void* q, const void* k, const void* v, const void* mask,
                              void* out, void* lse, int B, int Lq, int Lk, int H, int Dh,
                              bool dropout, const DropoutArgs& d, cudaStream_t s) {
  return dropout ? dispatch_fwd_mma<true, NW>(q, k, v, mask, out, lse, B, Lq, Lk, H, Dh, d, s)
                 : dispatch_fwd_mma<false, NW>(q, k, v, mask, out, lse, B, Lq, Lk, H, Dh, d, s);
}

cudaError_t flash_fwd_mma(const void* q, const void* k, const void* v, const void* mask,
                          void* out, void* lse, int B, int Lq, int Lk, int H, int Dh,
                          bool dropout, const DropoutArgs& d, cudaStream_t stream) {
  if (Lk > kMaxKeys) return cudaErrorInvalidValue;
  const long blocks = static_cast<long>((Lq + kTile - 1) / kTile) * B * H;
  bool wide = false;
  const cudaError_t err = use_wide_blocks(blocks, &wide);
  if (err != cudaSuccess) return err;
  return wide ? dispatch_fwd_drop<8>(q, k, v, mask, out, lse, B, Lq, Lk, H, Dh, dropout, d, stream)
              : dispatch_fwd_drop<4>(q, k, v, mask, out, lse, B, Lq, Lk, H, Dh, dropout, d, stream);
}

}  // namespace advmil
