// Fused LayerNorm -> ReLU -> 16-row region mean, forward.
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

template <typename T, int NC>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
ln_relu_region_mean_kernel(const T* __restrict__ h, const float* __restrict__ scale,
                           const float* __restrict__ bias, T* __restrict__ out,
                           int regions, int D, float eps) {
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
    for (int j = 0; j < NC; ++j) acc[j] += fmaxf((x[j] - mu) * inv * sc[j] + bi[j], 0.f);
  }
  T* o = out + static_cast<size_t>(region) * D;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (j < nc) o[lane + 32 * j] = from_f32<T>(acc[j] * (1.f / kRegion));
}

template <typename T>
cudaError_t launch(const void* h, const void* scale, const void* bias, void* out,
                   int M, int D, float eps, cudaStream_t stream) {
  const int regions = M / kRegion;
  const dim3 grid((regions + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  const int nc = D / 32;
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, stream>>>(static_cast<const T*>(h),
                                       static_cast<const float*>(scale),
                                       static_cast<const float*>(bias),
                                       static_cast<T*>(out), regions, D, eps);
  };
  if (nc <= 4) args(ln_relu_region_mean_kernel<T, 4>);
  else if (nc <= 12) args(ln_relu_region_mean_kernel<T, 12>);
  else args(ln_relu_region_mean_kernel<T, 32>);
  return cudaGetLastError();
}

}  // namespace advmil

// h [M, D] (f32 or bf16, contiguous), scale / bias [D] f32 -> out [M/16, D] in
// h's dtype. Requires M % 16 == 0, M > 0, D % 32 == 0, 32 <= D <= 1024
// (checked by the Python wrapper). Returns cudaGetLastError() after launch.
extern "C" int advmil_ln_relu_region_mean(const void* h, const void* scale,
                                          const void* bias, void* out, int M,
                                          int D, int dtype, float eps,
                                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32)
    return advmil::launch<float>(h, scale, bias, out, M, D, eps, s);
  if (dtype == advmil::kBF16)
    return advmil::launch<__nv_bfloat16>(h, scale, bias, out, M, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* advmil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
