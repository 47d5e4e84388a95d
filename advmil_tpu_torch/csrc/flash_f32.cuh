// Building blocks of the f32 flash attention kernels on the CUDA cores
// (flash_fwd.cu: the forward; flash_bwd.cu: dQ and dK/dV): 256-thread
// blocks over 64 resident rows staged d-major, streamed tiles of row-major
// rows Dh + 4 floats apart in a cp.async ring, 16-byte shared loads and
// stores, the keep decisions of one Philox block, and the ordered sum of the
// partial output tiles that a block's thread groups leave behind.
#pragma once

#include "common.cuh"
#include "mma.cuh"
#include "philox.cuh"

namespace advmil {

constexpr int kF32Threads = 256;
constexpr int kRes = 64;            // resident rows of a block, 16 groups of 4
constexpr int kDsPitch = kRes + 4;  // P / dS tiles: rows of 64 floats, 4 apart
constexpr int kListWindow = 1024;   // key tiles listed at a time (forward, dQ)
constexpr int kF32Stages = 2;       // cp.async ring depth

__device__ __forceinline__ float f4_at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void sts4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
// The four keep decisions of one Philox block, bit w for word w.
__device__ __forceinline__ uint32_t keep_nibble(const Philox4& r, uint32_t thr) {
  return (r.x >= thr ? 1u : 0u) | (r.y >= thr ? 2u : 0u) | (r.z >= thr ? 4u : 0u) |
         (r.w >= thr ? 8u : 0u);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Rows r0 .. r0 + 63 of one head of a [L, H, DH] sequence (row 0 at `base`,
// rows `row_stride` floats apart) into a d-major tile [DH][64]; rows beyond L
// as zeros. Every thread of the block calls it.
template <int DH>
__device__ __forceinline__ void load_transposed(float* dst, const float* __restrict__ base,
                                                size_t row_stride, int r0, int L, int tid) {
#pragma unroll
  for (int i = 0; i < DH / 16; ++i) {
    const int idx = tid + kF32Threads * i;
    const int r = idx / (DH / 4), c = idx % (DH / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L)
      x = __ldg(reinterpret_cast<const float4*>(base + static_cast<size_t>(r0 + r) * row_stride) + c);
    dst[(4 * c + 0) * kRes + r] = x.x;
    dst[(4 * c + 1) * kRes + r] = x.y;
    dst[(4 * c + 2) * kRes + r] = x.z;
    dst[(4 * c + 3) * kRes + r] = x.w;
  }
}

// Start the copy of rows r0 .. r0 + ROWS - 1 of a [L, H, DH] sequence into a
// row-major tile of pitch DH + 4; rows beyond L, or all of them when `have`
// is false, are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void load_rows_async(float* tile, const float* __restrict__ base,
                                                size_t row_stride, int r0, int L, bool have,
                                                int tid) {
  static_assert(ROWS * DH / 4 % kF32Threads == 0, "a constant count of pieces a thread");
#pragma unroll
  for (int i = 0; i < ROWS * DH / 4 / kF32Threads; ++i) {
    const int idx = tid + kF32Threads * i;
    const int r = idx / (DH / 4), c = idx % (DH / 4);
    const bool ok = have && r0 + r < L;
    const float* src = ok ? base + static_cast<size_t>(r0 + r) * row_stride + 4 * c : base;
    cp_async_16(tile + r * (DH + 4) + 4 * c, src, ok);
  }
}

// Zeros for rows r0 .. r0 + 63 (those below L) of one head of `out`.
template <int DH>
__device__ __forceinline__ void write_zero_rows(float* out, size_t row_stride, int r0, int L,
                                                int tid) {
#pragma unroll
  for (int i = 0; i < DH / 16; ++i) {
    const int idx = tid + kF32Threads * i;
    const int r = idx / (DH / 4), c = idx % (DH / 4);
    if (r0 + r < L)
      reinterpret_cast<float4*>(out + static_cast<size_t>(r0 + r) * row_stride)[c] =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// out rows r0 .. r0 + 63 (those below L) = the sum of `parts` partial tiles
// [64][DH] at `part` (consecutive), added in order, then times row_scale[r]
// where a row scale is given.
template <int DH>
__device__ __forceinline__ void write_summed_rows(float* out, size_t row_stride, int r0, int L,
                                                  const float* part, int parts, int tid,
                                                  const float* row_scale = nullptr) {
#pragma unroll
  for (int i = 0; i < DH / 16; ++i) {
    const int idx = tid + kF32Threads * i;
    const int r = idx / (DH / 4), c = idx % (DH / 4);
    float4 s = lds4(part + r * DH + 4 * c);
    for (int p = 1; p < parts; ++p) {
      const float4 t = lds4(part + (p * kRes + r) * DH + 4 * c);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    if (row_scale) {
      const float f = row_scale[r];
      s.x *= f;
      s.y *= f;
      s.z *= f;
      s.w *= f;
    }
    if (r0 + r < L) reinterpret_cast<float4*>(out + static_cast<size_t>(r0 + r) * row_stride)[c] = s;
  }
}

}  // namespace advmil
