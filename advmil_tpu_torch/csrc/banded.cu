// Banded graph softmax aggregation of GENConv, forward and backward.
//
// Replaces the Pallas TPU kernels advmil_tpu/ops/banded_pallas.py:
// _banded_fwd_kernel and _banded_bwd_kernel (wrapper pallas_banded_aggregate).
// Raster-ordered spatial kNN graphs are near-banded: slot s of node n mostly
// reads source n + offs[s] for one offset per slot. For y [B, N, C] (the
// per-source messages relu(x) + eps), offs [B, epn] and band_mask [B, N, epn]
// (1 = the edge is real AND sits on its slot's band), per bag b, node n and
// channel c, with v_s = y[b, n + offs[b, s], c]:
//   out = sum_s softmax_s(t * v_s) * v_s    over the slots with band_mask > 0,
// saving m (the max of t * v_s, reset to 0 without a slot), den (the sum of
// exp(t * v_s - m)) and, for bf16 storage, out itself in f32 for the backward
// (the TPU kernel's backward read the bf16-rounded out; the f32 copy keeps
// dt's error at f32 rounding). Edges off the band are not
// handled here: the wrapper recomputes the rows that own one exactly and
// overwrites them (ops/banded.py).
//
// The backward, for the cotangent g [B, N, C] of out: row r received
// y[r] in slot s of node n = r - offs[s], so
//   dy[r] = sum_s e * (G1[n] * (1 + t * y[r]) - t * G2[n]),
//   dt   += e * y[r] * (G1[n] * y[r] - G2[n]),
// with e = exp(t * y[r] - m[n]), G1 = g / den and G2 = g * out / den. Each
// (n, s) lands in exactly one r, so dy is a gather: no scatter, no atomics.
//
// What bounds it on the card: device-memory bandwidth. The forward reads y
// about once (the epn neighbour rows of a node are near each other and stay in
// L1/L2) and writes out, m and den; the backward reads y and, per slot, m, den,
// g and out of the source row, and writes dy.
//
// Design: one thread per (bag, node, channel), grid-stride, neighbouring
// threads on neighbouring channels. The TPU kernel held a node block and its
// two neighbour blocks in VMEM, which bounded every |offset| by its 128-row
// block, and read clamped junk rows that band_mask 0 neutralised. Here a thread
// reads the neighbour's row from device memory directly, so any offset works,
// and it guards the source row itself (0 <= n + offs[s] < N): nothing outside
// the bag is ever read. dt is reduced per block and the partials summed in a
// fixed order by a second kernel, as in knn_agg.cu.
#include "graph_agg.cuh"

namespace advmil {

template <typename T>
__global__ void __launch_bounds__(kAggThreads)
banded_fwd_kernel(const T* __restrict__ y, const int* __restrict__ offs,
                  const float* __restrict__ bmask, const float* __restrict__ t_ptr,
                  T* __restrict__ out, float* __restrict__ m_out, float* __restrict__ den_out,
                  float* __restrict__ out32, long long total, int N, int C, int epn) {
  const float t = t_ptr[0];
  for (long long i = blockIdx.x * static_cast<long long>(kAggThreads) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kAggThreads) {
    const long long bn = i / C;                 // b * N + n
    const int c = static_cast<int>(i - bn * C);
    const int b = static_cast<int>(bn / N);
    const int n = static_cast<int>(bn - static_cast<long long>(b) * N);
    const int* ob = offs + b * epn;
    const float* bm = bmask + bn * epn;
    const T* yb = y + static_cast<long long>(b) * N * C + c;
    float v[kMaxEpn], e[kMaxEpn];
    bool on[kMaxEpn];
#pragma unroll
    for (int s = 0; s < kMaxEpn; ++s) {
      const int src = s < epn ? n + ob[s] : -1;
      on[s] = s < epn && bm[s] > 0.f && src >= 0 && src < N;
      v[s] = on[s] ? to_f32(yb[static_cast<long long>(src) * C]) : 0.f;
    }
    const SlotSoftmax sm = slot_softmax(v, on, epn, t, e);
    const float o = sm.num / fmaxf(sm.den, 1e-16f);
    out[i] = from_f32<T>(o);
    if (m_out != nullptr) {
      m_out[i] = sm.mx;
      den_out[i] = sm.den;
    }
    if (out32 != nullptr) out32[i] = o;
  }
}

template <typename T>
__global__ void __launch_bounds__(kAggThreads)
banded_bwd_kernel(const T* __restrict__ y, const int* __restrict__ offs,
                  const float* __restrict__ bmask, const float* __restrict__ t_ptr,
                  const float* __restrict__ m, const float* __restrict__ den,
                  const float* __restrict__ out, const T* __restrict__ g, T* __restrict__ dy,
                  float* __restrict__ part_dt, long long total, int N, int C, int epn) {
  const float t = t_ptr[0];
  float dt = 0.f;
  for (long long i = blockIdx.x * static_cast<long long>(kAggThreads) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kAggThreads) {
    const long long br = i / C;                 // b * N + r
    const int c = static_cast<int>(i - br * C);
    const int b = static_cast<int>(br / N);
    const int r = static_cast<int>(br - static_cast<long long>(b) * N);
    const long long bag = static_cast<long long>(b) * N;
    const float yr = to_f32(y[i]);
    float acc = 0.f, dts = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxEpn; ++s) {
      if (s >= epn) break;
      const int n = r - offs[b * epn + s];      // the node that read y[r] in slot s
      if (n < 0 || n >= N || !(bmask[(bag + n) * epn + s] > 0.f)) continue;
      const long long j = (bag + n) * C + c;
      const float ex = expf(yr * t - m[j]);
      const float g1 = to_f32(g[j]) / fmaxf(den[j], 1e-16f);
      const float g2 = g1 * out[j];
      acc += ex * (g1 * (1.f + t * yr) - t * g2);
      dts += ex * yr * (g1 * yr - g2);
    }
    dy[i] = from_f32<T>(acc);
    dt += dts;
  }
  dt = block_sum_fixed(dt);
  if (threadIdx.x == 0) part_dt[blockIdx.x] = dt;
}

template <typename T>
cudaError_t banded_fwd(const void* y, const void* offs, const void* bmask, const void* t,
                       void* out, void* m, void* den, void* out32, int B, int N, int C,
                       int epn, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * N * C;
  banded_fwd_kernel<T><<<agg_blocks(total), kAggThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const int*>(offs),
      static_cast<const float*>(bmask), static_cast<const float*>(t), static_cast<T*>(out),
      static_cast<float*>(m), static_cast<float*>(den), static_cast<float*>(out32), total, N,
      C, epn);
  return cudaGetLastError();
}

template <typename T>
cudaError_t banded_bwd(const void* y, const void* offs, const void* bmask, const void* t,
                       const void* m, const void* den, const void* out, const void* g,
                       void* dy, void* partials, void* dt, int B, int N, int C, int epn,
                       cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * N * C;
  const int nblocks = agg_blocks(total);
  banded_bwd_kernel<T><<<nblocks, kAggThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const int*>(offs),
      static_cast<const float*>(bmask), static_cast<const float*>(t),
      static_cast<const float*>(m), static_cast<const float*>(den),
      static_cast<const float*>(out), static_cast<const T*>(g), static_cast<T*>(dy),
      static_cast<float*>(partials), total, N, C, epn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_dt_partials_kernel<<<1, kAggThreads, 0, stream>>>(static_cast<const float*>(partials),
                                                        nblocks, static_cast<float*>(dt));
  return cudaGetLastError();
}

}  // namespace advmil

// y [B, N, C] (f32 or bf16), offs [B, epn] int32, bmask [B, N, epn] f32, t [1]
// f32 on the device -> out [B, N, C] in y's dtype; m, den [B, N, C] f32, or
// both null to skip them; out32 [B, N, C] f32 (out before rounding), or null.
// Requires B * N * C > 0, 1 <= epn <= 16 (checked by the Python wrapper).
// Returns cudaGetLastError() after launch.
extern "C" int advmil_banded_fwd(const void* y, const void* offs, const void* bmask,
                                 const void* t, void* out, void* m, void* den, void* out32,
                                 int B, int N, int C, int epn, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32)
    return advmil::banded_fwd<float>(y, offs, bmask, t, out, m, den, out32, B, N, C, epn, s);
  if (dtype == advmil::kBF16)
    return advmil::banded_fwd<__nv_bfloat16>(y, offs, bmask, t, out, m, den, out32, B, N, C,
                                             epn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward from the forward's m, den and out (all f32) for g [B, N, C] in
// y's dtype: dy [B, N, C] in y's dtype and dt [1] f32; partials: scratch of
// 1024 floats. Returns cudaGetLastError() after the second launch.
extern "C" int advmil_banded_bwd(const void* y, const void* offs, const void* bmask,
                                 const void* t, const void* m, const void* den,
                                 const void* out, const void* g, void* dy, void* partials,
                                 void* dt, int B, int N, int C, int epn, int dtype,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32)
    return advmil::banded_bwd<float>(y, offs, bmask, t, m, den, out, g, dy, partials, dt, B,
                                     N, C, epn, s);
  if (dtype == advmil::kBF16)
    return advmil::banded_bwd<__nv_bfloat16>(y, offs, bmask, t, m, den, out, g, dy, partials,
                                             dt, B, N, C, epn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
