// Fused LayerNorm -> ReLU -> 16-row region mean, forward (and, as its
// POOL = false instantiation, the plain LayerNorm -> ReLU of
// advmil_tpu/ops/ln_pool.py:_lnrelu_fwd_kernel / _lnrelu_bwd_kernel).
//
// Replaces the Pallas TPU kernel advmil_tpu/ops/ln_pool.py:_fwd_kernel
// (wrapper ln_relu_region_mean). For h [M, D] (M % 16 == 0):
//   out[r, :] = mean_{i < 16} relu((h[16r+i, :] - mu) * rsqrt(var + 1e-6) * scale + bias)
// with mu / var over the row in f32 (flax's LayerNorm statistics and eps).
//
// What bounds it on the card: device-memory bandwidth. It reads M*D input
// values once and writes M*D/16; the arithmetic is ~10 flops per value, far
// below the H100's ~20 flop/byte ridge for f32 CUDA-core work.
//
// Design: one warp per region (16 consecutive rows). Each lane keeps D/32
// columns of the current row in registers, loaded lane-contiguous (lane l
// reads columns l, l+32, ...) so each warp load is coalesced. The row's mean
// and variance are two warp-shuffle reductions: no shared memory and no block
// barrier. The 16 normalised rows are summed in f32 registers and the pooled
// row is written once in the input dtype, so the normalised [M, D] activation
// never reaches device memory (what the TPU kernel also saves). A block holds
// 8 independent warps; at M = 32768 that is 2048 warps, enough loads in flight
// to cover memory latency.
#include "common.cuh"

namespace advmil {

constexpr int kRegion = 16;       // patches per 4x4 region
constexpr int kWarpsPerBlock = 8;

constexpr int kMaxBwdBlocks = 512;

// Blocks of the backward for M rows (see launch_bwd): one warp per region up
// to a cap, so the per-block partial sums stay few.
__host__ __device__ inline int ln_pool_bwd_blocks(int M) {
  const int regions = (M + kRegion - 1) / kRegion;
  const int want = (regions + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return want < 1 ? 1 : (want > kMaxBwdBlocks ? kMaxBwdBlocks : want);
}

// POOL = false is the plain LN -> ReLU (ln_relu below): the same warp walks
// the same 16 rows and writes each normalised row instead of their mean; M
// need not be a multiple of 16 there, so rows at or beyond M are skipped.
template <typename T, int NC, bool POOL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
ln_relu_region_mean_kernel(const T* __restrict__ h, const float* __restrict__ scale,
                           const float* __restrict__ bias, T* __restrict__ out,
                           int regions, int M, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int region = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (region >= regions) return;
  const int nc = D >> 5;  // columns per lane, <= NC
  float sc[NC], bi[NC], acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    sc[j] = j < nc ? scale[lane + 32 * j] : 0.f;
    bi[j] = j < nc ? bias[lane + 32 * j] : 0.f;
    acc[j] = 0.f;
  }
  const float inv_d = 1.f / static_cast<float>(D);
  const T* row = h + static_cast<size_t>(region) * kRegion * D;
#pragma unroll 2
  for (int i = 0; i < kRegion; ++i, row += D) {
    if (!POOL && region * kRegion + i >= M) break;  // warp-uniform
    float x[NC];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      x[j] = j < nc ? to_f32(row[lane + 32 * j]) : 0.f;
      s += x[j];
    }
    const float mu = warp_sum(s) * inv_d;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float d = j < nc ? x[j] - mu : 0.f;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) * inv_d + eps);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float y = fmaxf((x[j] - mu) * inv * sc[j] + bi[j], 0.f);
      if (POOL) {
        acc[j] += y;
      } else if (j < nc) {
        out[(static_cast<size_t>(region) * kRegion + i) * D + lane + 32 * j] = from_f32<T>(y);
      }
    }
  }
  if (!POOL) return;
  T* o = out + static_cast<size_t>(region) * D;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (j < nc) o[lane + 32 * j] = from_f32<T>(acc[j] * (1.f / kRegion));
}

template <typename T, bool POOL>
cudaError_t launch(const void* h, const void* scale, const void* bias, void* out,
                   int M, int D, float eps, cudaStream_t stream) {
  const int regions = (M + kRegion - 1) / kRegion;
  const dim3 grid((regions + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  const int nc = D / 32;
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, stream>>>(static_cast<const T*>(h),
                                       static_cast<const float*>(scale),
                                       static_cast<const float*>(bias),
                                       static_cast<T*>(out), regions, M, D, eps);
  };
  if (nc <= 4) args(ln_relu_region_mean_kernel<T, 4, POOL>);
  else if (nc <= 12) args(ln_relu_region_mean_kernel<T, 12, POOL>);
  else args(ln_relu_region_mean_kernel<T, 32, POOL>);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward.
//
// Replaces the Pallas TPU kernel advmil_tpu/ops/ln_pool.py:_bwd_kernel
// (custom-VJP rule _bwd_rule). For g [M/16, D] f32, per row x of region r:
//   xhat = (x - mu) * inv, gy = (xhat * scale + bias > 0) ? g[r] / 16 : 0,
//   gx = gy * scale, dh = inv * (gx - mean(gx) - xhat * mean(gx * xhat)),
//   dscale = sum over rows of gy * xhat, dbias = sum over rows of gy.
// The LN statistics are recomputed, as on the TPU, instead of saved.
//
// What bounds it on the card: device-memory bandwidth (it reads h and writes
// dh, M*D values each, plus M*D/16 of g); ~25 flops per value.
//
// Design: one warp per region, lane-contiguous columns in registers, as the
// forward. The TPU kernel carried dscale / dbias across its sequential grid
// in scratch; here blocks run in parallel, so each block reduces its warps'
// sums through shared memory in a fixed order and writes one partial row
// [nblocks, D], and a second kernel sums the partials over blocks in a fixed
// order. No atomics: the sums are the same from run to run. The grid is
// capped and each warp strides over regions, so the partial buffer stays
// small (at most kMaxBwdBlocks rows).
// ---------------------------------------------------------------------------

// POOL = false is ln_relu's backward: g is [M, D] in its storage dtype G (one
// cotangent row per row of h, read once, not upcast in device memory) and is
// not divided by 16; rows at or beyond M are skipped.
template <typename T, typename G, int NC, bool POOL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
ln_relu_region_mean_bwd_kernel(const G* __restrict__ g, const T* __restrict__ h,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias, T* __restrict__ dh,
                               float* __restrict__ part_dscale,
                               float* __restrict__ part_dbias, int regions, int M,
                               int D, float eps) {
  __shared__ float s_red[kWarpsPerBlock][32 * NC];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nc = D >> 5;
  float sc[NC], bi[NC], dsc[NC], dbi[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    sc[j] = j < nc ? scale[lane + 32 * j] : 0.f;
    bi[j] = j < nc ? bias[lane + 32 * j] : 0.f;
    dsc[j] = 0.f;
    dbi[j] = 0.f;
  }
  const float inv_d = 1.f / static_cast<float>(D);
  for (int region = blockIdx.x * kWarpsPerBlock + warp; region < regions;
       region += gridDim.x * kWarpsPerBlock) {
    float gr[NC];
    if (POOL) {
      const G* gp = g + static_cast<size_t>(region) * D;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        gr[j] = j < nc ? to_f32(gp[lane + 32 * j]) * (1.f / kRegion) : 0.f;
    }
    const size_t base = static_cast<size_t>(region) * kRegion * D;
    for (int i = 0; i < kRegion; ++i) {
      if (!POOL) {
        if (region * kRegion + i >= M) break;  // warp-uniform
        const G* gp = g + base + static_cast<size_t>(i) * D;
#pragma unroll
        for (int j = 0; j < NC; ++j) gr[j] = j < nc ? to_f32(gp[lane + 32 * j]) : 0.f;
      }
      const T* row = h + base + static_cast<size_t>(i) * D;
      float x[NC];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        x[j] = j < nc ? to_f32(row[lane + 32 * j]) : 0.f;
        s += x[j];
      }
      const float mu = warp_sum(s) * inv_d;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float d = j < nc ? x[j] - mu : 0.f;
        q += d * d;
      }
      const float inv = rsqrtf(warp_sum(q) * inv_d + eps);
      float gx[NC];
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        x[j] = j < nc ? (x[j] - mu) * inv : 0.f;          // xhat
        const float gy = (x[j] * sc[j] + bi[j] > 0.f) ? gr[j] : 0.f;
        dsc[j] += gy * x[j];
        dbi[j] += gy;
        gx[j] = gy * sc[j];
        m1 += gx[j];
        m2 += gx[j] * x[j];
      }
      m1 = warp_sum(m1) * inv_d;
      m2 = warp_sum(m2) * inv_d;
      T* drow = dh + base + static_cast<size_t>(i) * D;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if (j < nc) drow[lane + 32 * j] = from_f32<T>(inv * (gx[j] - m1 - x[j] * m2));
    }
  }
  // block partials of dscale / dbias: warps reduced in a fixed order, one
  // shared buffer used twice (2 x 8 x 1024 floats would exceed 48 KB at D=1024)
  for (int which = 0; which < 2; ++which) {
    if (which) __syncthreads();
#pragma unroll
    for (int j = 0; j < NC; ++j) s_red[warp][lane + 32 * j] = which ? dbi[j] : dsc[j];
    __syncthreads();
    float* part = which ? part_dbias : part_dscale;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsPerBlock; ++w) a += s_red[w][c];
      part[static_cast<size_t>(blockIdx.x) * D + c] = a;
    }
  }
}

// dscale[c] = sum over blocks of part[b, c] (and dbias), summed in block order.
__global__ void sum_partials_kernel(const float* __restrict__ part_dscale,
                                    const float* __restrict__ part_dbias,
                                    float* __restrict__ dscale, float* __restrict__ dbias,
                                    int nblocks, int D) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < nblocks; ++k) {
    a += part_dscale[static_cast<size_t>(k) * D + c];
    b += part_dbias[static_cast<size_t>(k) * D + c];
  }
  dscale[c] = a;
  dbias[c] = b;
}

template <typename T, typename G, bool POOL>
cudaError_t launch_bwd(const void* g, const void* h, const void* scale, const void* bias,
                       void* dh, void* dscale, void* dbias, void* partials, int M, int D,
                       float eps, cudaStream_t stream) {
  const int regions = (M + kRegion - 1) / kRegion;
  const int nblocks = ln_pool_bwd_blocks(M);
  float* part_dscale = static_cast<float*>(partials);
  float* part_dbias = part_dscale + static_cast<size_t>(nblocks) * D;
  const int nc = D / 32;
  auto args = [&](auto kernel) {
    kernel<<<nblocks, 32 * kWarpsPerBlock, 0, stream>>>(
        static_cast<const G*>(g), static_cast<const T*>(h),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<T*>(dh), part_dscale, part_dbias, regions, M, D, eps);
  };
  if (nc <= 4) args(ln_relu_region_mean_bwd_kernel<T, G, 4, POOL>);
  else if (nc <= 12) args(ln_relu_region_mean_bwd_kernel<T, G, 12, POOL>);
  else args(ln_relu_region_mean_bwd_kernel<T, G, 32, POOL>);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<(D + 255) / 256, 256, 0, stream>>>(
      part_dscale, part_dbias, static_cast<float*>(dscale), static_cast<float*>(dbias),
      nblocks, D);
  return cudaGetLastError();
}

}  // namespace advmil

// Rows of each partial buffer the backward needs for M rows: the caller
// allocates 2 * rows * D floats.
extern "C" int advmil_ln_pool_bwd_blocks(int M) { return advmil::ln_pool_bwd_blocks(M); }

// g [M/16, D] f32, h [M, D] (f32 or bf16), scale / bias [D] f32 -> dh [M, D] in
// h's dtype, dscale / dbias [D] f32; partials: scratch of
// 2 * advmil_ln_pool_bwd_blocks(M) * D floats. Same shape limits as the
// forward. Returns cudaGetLastError() after the second launch.
extern "C" int advmil_ln_relu_region_mean_bwd(const void* g, const void* h,
                                              const void* scale, const void* bias,
                                              void* dh, void* dscale, void* dbias,
                                              void* partials, int M, int D, int dtype,
                                              float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32)
    return advmil::launch_bwd<float, float, true>(g, h, scale, bias, dh, dscale, dbias,
                                                  partials, M, D, eps, s);
  if (dtype == advmil::kBF16)
    return advmil::launch_bwd<__nv_bfloat16, float, true>(g, h, scale, bias, dh, dscale,
                                                          dbias, partials, M, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ln_relu's backward (replaces advmil_tpu/ops/ln_pool.py:_lnrelu_bwd_kernel):
// g and h [M, D] in one dtype (f32 or bf16), any M > 0 -> dh [M, D] in that
// dtype, dscale / dbias [D] f32; partials as above.
extern "C" int advmil_ln_relu_bwd(const void* g, const void* h, const void* scale,
                                  const void* bias, void* dh, void* dscale, void* dbias,
                                  void* partials, int M, int D, int dtype, float eps,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32)
    return advmil::launch_bwd<float, float, false>(g, h, scale, bias, dh, dscale, dbias,
                                                   partials, M, D, eps, s);
  if (dtype == advmil::kBF16)
    return advmil::launch_bwd<__nv_bfloat16, __nv_bfloat16, false>(
        g, h, scale, bias, dh, dscale, dbias, partials, M, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ln_relu's forward (replaces advmil_tpu/ops/ln_pool.py:_lnrelu_fwd_kernel):
// h [M, D] -> relu(LN(h) * scale + bias) [M, D] in h's dtype, any M > 0.
extern "C" int advmil_ln_relu(const void* h, const void* scale, const void* bias,
                              void* out, int M, int D, int dtype, float eps,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32)
    return advmil::launch<float, false>(h, scale, bias, out, M, D, eps, s);
  if (dtype == advmil::kBF16)
    return advmil::launch<__nv_bfloat16, false>(h, scale, bias, out, M, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// h [M, D] (f32 or bf16, contiguous), scale / bias [D] f32 -> out [M/16, D] in
// h's dtype. Requires M % 16 == 0, M > 0, D % 32 == 0, 32 <= D <= 1024
// (checked by the Python wrapper). Returns cudaGetLastError() after launch.
extern "C" int advmil_ln_relu_region_mean(const void* h, const void* scale,
                                          const void* bias, void* out, int M,
                                          int D, int dtype, float eps,
                                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32)
    return advmil::launch<float, true>(h, scale, bias, out, M, D, eps, s);
  if (dtype == advmil::kBF16)
    return advmil::launch<__nv_bfloat16, true>(h, scale, bias, out, M, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* advmil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
