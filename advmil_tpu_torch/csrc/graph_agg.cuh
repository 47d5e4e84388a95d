// Shared pieces of the graph softmax-aggregation kernels (knn_agg.cu,
// banded.cu): 16-byte vectors of f32 or bf16 values and the fixed-order
// reduction of the temperature gradient.
//
// Numerics of the per-(node, channel) masked softmax over at most kMaxEpn
// incoming slots, in every kernel, as in the TPU kernels
// (advmil_tpu/ops/segment.py:_alpha_from_block,
// advmil_tpu/ops/banded_pallas.py:_banded_fwd_kernel): the max over real slots
// starts at -1e30 and is reset to 0 at <= -1e29 (a node without edges), the
// slot mask selects before exp, so a junk value in a masked slot never
// overflows into the result, and the denominator is clamped at 1e-16. A node
// without edges aggregates to exactly 0.
#pragma once

#include "common.cuh"
#include "mma.cuh"  // pack_bf16

namespace advmil {
namespace {

constexpr int kMaxEpn = 16;          // incoming slots per node the kernels take
constexpr int kAggThreads = 256;     // threads per block of every graph kernel
constexpr int kMaxAggBlocks = 1024;  // grid cap = dt partials of the banded backward
                                     // (ops/segment.py: DT_PARTIALS)

// 16 bytes of T as kVec floats, and back (bf16: round to nearest even).
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& w, float* v) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(u[k] << 16);
      v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __uint_as_float(u[k]);
  }
}
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* v) {
  if constexpr (sizeof(T) == 2) {
    return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                      pack_bf16(v[6], v[7]));
  } else {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
}

// The 16 bytes at p (kVec values of T, `valid` of them inside the row) from
// device memory: one vector load with `vec`, else element by element with
// zeros beyond the row.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, int valid, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  constexpr int kVec = 16 / sizeof(T);
  T e[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) e[j] = j < valid ? p[j] : from_f32<T>(0.f);
  uint4 w;
  memcpy(&w, e, 16);
  return w;
}
template <typename T>
__device__ __forceinline__ void store16(T* p, const uint4& w, int valid, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = w;
    return;
  }
  constexpr int kVec = 16 / sizeof(T);
  T e[kVec];
  memcpy(e, &w, 16);
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (j < valid) p[j] = e[j];
}
// Sum of v over the block, in a fixed order (warp butterfly, then warps in
// index order); the result is valid in the thread with linear index tid 0.
// Blocks of kAggThreads; every thread of the block calls it.
__device__ __forceinline__ float block_sum_fixed(float v, int tid) {
  __shared__ float s_warp[kAggThreads / 32];
  v = warp_sum(v);
  if ((tid & 31) == 0) s_warp[tid >> 5] = v;
  __syncthreads();
  float a = 0.f;
  if (tid == 0)
    for (int w = 0; w < kAggThreads / 32; ++w) a += s_warp[w];
  return a;
}
// The same for a 1-D block: valid in thread 0.
__device__ __forceinline__ float block_sum_fixed(float v) {
  return block_sum_fixed(v, threadIdx.x);
}

// dt[0] = sum of the n block partials, in a fixed order: one block; thread k
// sums partials k, k + 256, ... in turn, then the block sum. No atomics, so
// the temperature gradient is the same from run to run.
__global__ void __launch_bounds__(kAggThreads)
sum_dt_partials_kernel(const float* __restrict__ part, int n, float* __restrict__ dt) {
  float a = 0.f;
  for (int k = threadIdx.x; k < n; k += kAggThreads) a += part[k];
  a = block_sum_fixed(a);
  if (threadIdx.x == 0) dt[0] = a;
}

}  // namespace
}  // namespace advmil
