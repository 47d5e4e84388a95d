// Shared helpers for the port's hand-written kernels: dtype codes shared with
// the Python wrappers, f32 <-> storage conversions, warp reductions and the
// device's SM count.
#pragma once

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace advmil {

// dtype codes passed from Python (ops/_build.py: DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The SM count of the current device, asked for once per device.
inline cudaError_t device_sm_count(int* sms) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> count[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  *sms = dev < kMaxDevices ? count[dev].load(std::memory_order_relaxed) : 0;
  if (*sms == 0) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) count[dev].store(*sms, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

}  // namespace advmil
