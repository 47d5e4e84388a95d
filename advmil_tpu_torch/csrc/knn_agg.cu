// Dense kNN softmax aggregation of GENConv, forward and backward.
//
// Replaces the Pallas TPU kernels advmil_tpu/ops/segment.py:_fused_agg_fwd_kernel
// and _fused_agg_bwd_kernel (wrapper fused_knn_softmax_aggregate). For
// messages m [R, epn, C] (R = bags x nodes, the gathered relu(x_src) + eps),
// edge mask [R, epn] and the temperature t, per row r and channel c:
//   alpha_s = softmax over the real slots s of t * m[r, s, c]
//   out[r, c] = sum_s alpha_s * m[r, s, c]
// and the backward for the cotangent g [R, C]:
//   dm[r, s, c] = g * alpha_s * (1 + t * (m_s - out)),
//   dt = sum over r, c of g * sum_s alpha_s * m_s * (m_s - out).
//
// What bounds it on the card: device-memory bandwidth. The forward reads
// R*epn*C values and writes R*C; the backward reads R*epn*C + R*C and writes
// R*epn*C; the arithmetic is a few flops and one exp per value.
//
// Design: one thread per (row, channel), grid-stride over R*C. Neighbouring
// threads hold neighbouring channels, so every slot's load is coalesced; the
// row's <= 16 slots sit in registers, and the softmax runs in f32 whatever
// the storage type (f32 or bf16). The TPU kernels padded epn to 8 and C to
// 128 for Mosaic's tiling; here any epn <= 16 and any C are read as they are.
// The TPU backward wrote dt as one (8, 128) tile per block and divided the sum
// by 1024; here each block writes one partial (a fixed-order block sum) and a
// second one-block kernel adds the partials in a fixed order: no atomics, so
// dt is the same from run to run.
#include "graph_agg.cuh"

namespace advmil {

template <typename T>
__global__ void __launch_bounds__(kAggThreads)
knn_agg_fwd_kernel(const T* __restrict__ msg, const float* __restrict__ emask,
                   const float* __restrict__ t_ptr, T* __restrict__ out, long long total,
                   int epn, int C) {
  const float t = t_ptr[0];
  for (long long i = blockIdx.x * static_cast<long long>(kAggThreads) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kAggThreads) {
    const long long r = i / C;
    const int c = static_cast<int>(i - r * C);
    const T* mp = msg + r * epn * C + c;
    const float* em = emask + r * epn;
    float v[kMaxEpn], e[kMaxEpn];
    bool on[kMaxEpn];
#pragma unroll
    for (int s = 0; s < kMaxEpn; ++s) {
      on[s] = s < epn && em[s] > 0.f;
      v[s] = s < epn ? to_f32(mp[static_cast<long long>(s) * C]) : 0.f;
    }
    const SlotSoftmax sm = slot_softmax(v, on, epn, t, e);
    out[i] = from_f32<T>(sm.num / fmaxf(sm.den, 1e-16f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kAggThreads)
knn_agg_bwd_kernel(const T* __restrict__ msg, const float* __restrict__ emask,
                   const float* __restrict__ t_ptr, const T* __restrict__ g,
                   T* __restrict__ dmsg, float* __restrict__ part_dt, long long total,
                   int epn, int C) {
  const float t = t_ptr[0];
  float dt = 0.f;
  for (long long i = blockIdx.x * static_cast<long long>(kAggThreads) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kAggThreads) {
    const long long r = i / C;
    const int c = static_cast<int>(i - r * C);
    const long long base = r * epn * C + c;
    const float* em = emask + r * epn;
    float v[kMaxEpn], e[kMaxEpn];
    bool on[kMaxEpn];
#pragma unroll
    for (int s = 0; s < kMaxEpn; ++s) {
      on[s] = s < epn && em[s] > 0.f;
      v[s] = s < epn ? to_f32(msg[base + static_cast<long long>(s) * C]) : 0.f;
    }
    const SlotSoftmax sm = slot_softmax(v, on, epn, t, e);
    const float inv = 1.f / fmaxf(sm.den, 1e-16f);
    const float o = sm.num * inv;
    const float gi = to_f32(g[i]);
    float dts = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxEpn; ++s) {
      if (s < epn) {
        const float a = e[s] * inv;   // 0 off the mask
        dmsg[base + static_cast<long long>(s) * C] =
            from_f32<T>(gi * a * (1.f + t * (v[s] - o)));
        dts += a * v[s] * (v[s] - o);
      }
    }
    dt += gi * dts;
  }
  dt = block_sum_fixed(dt);
  if (threadIdx.x == 0) part_dt[blockIdx.x] = dt;
}

template <typename T>
cudaError_t knn_fwd(const void* msg, const void* emask, const void* t, void* out, int rows,
                    int epn, int C, cudaStream_t stream) {
  const long long total = static_cast<long long>(rows) * C;
  knn_agg_fwd_kernel<T><<<agg_blocks(total), kAggThreads, 0, stream>>>(
      static_cast<const T*>(msg), static_cast<const float*>(emask),
      static_cast<const float*>(t), static_cast<T*>(out), total, epn, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t knn_bwd(const void* msg, const void* emask, const void* t, const void* g,
                    void* dmsg, void* partials, void* dt, int rows, int epn, int C,
                    cudaStream_t stream) {
  const long long total = static_cast<long long>(rows) * C;
  const int nblocks = agg_blocks(total);
  knn_agg_bwd_kernel<T><<<nblocks, kAggThreads, 0, stream>>>(
      static_cast<const T*>(msg), static_cast<const float*>(emask),
      static_cast<const float*>(t), static_cast<const T*>(g), static_cast<T*>(dmsg),
      static_cast<float*>(partials), total, epn, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_dt_partials_kernel<<<1, kAggThreads, 0, stream>>>(static_cast<const float*>(partials),
                                                        nblocks, static_cast<float*>(dt));
  return cudaGetLastError();
}

}  // namespace advmil

// msg [rows, epn, C] (f32 or bf16), emask [rows, epn] f32, t [1] f32 on the
// device -> out [rows, C] in msg's dtype. Requires rows * C > 0, 1 <= epn <= 16
// (checked by the Python wrapper). Returns cudaGetLastError() after launch.
extern "C" int advmil_knn_agg_fwd(const void* msg, const void* emask, const void* t,
                                  void* out, int rows, int epn, int C, int dtype,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32) return advmil::knn_fwd<float>(msg, emask, t, out, rows, epn, C, s);
  if (dtype == advmil::kBF16)
    return advmil::knn_fwd<__nv_bfloat16>(msg, emask, t, out, rows, epn, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward for g [rows, C] in msg's dtype: dmsg [rows, epn, C] in msg's
// dtype and dt [1] f32; partials: scratch of 1024 floats. Returns
// cudaGetLastError() after the second launch.
extern "C" int advmil_knn_agg_bwd(const void* msg, const void* emask, const void* t,
                                  const void* g, void* dmsg, void* partials, void* dt,
                                  int rows, int epn, int C, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32)
    return advmil::knn_bwd<float>(msg, emask, t, g, dmsg, partials, dt, rows, epn, C, s);
  if (dtype == advmil::kBF16)
    return advmil::knn_bwd<__nv_bfloat16>(msg, emask, t, g, dmsg, partials, dt, rows, epn,
                                          C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
