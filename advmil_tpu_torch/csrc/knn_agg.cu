// Dense kNN softmax aggregation of GENConv, forward (#12) and backward (#13).
//
// Replaces the Pallas TPU kernels advmil_tpu/ops/segment.py:162
// (_fused_agg_fwd_kernel) and :167 (_fused_agg_bwd_kernel), wrapper
// fused_knn_softmax_aggregate. For messages m [R, epn, C] (R = bags x nodes,
// the gathered relu(x_src) + eps), edge mask [R, epn] and the temperature t,
// per row r and channel c:
//   alpha_s = softmax over the real slots s of t * m[r, s, c]
//   out[r, c] = sum_s alpha_s * m[r, s, c]
// and the backward for the cotangent g [R, C]:
//   dm[r, s, c] = g * alpha_s * (1 + t * (m_s - out)),
//   dt = sum over r, c of g * sum_s alpha_s * m_s * (m_s - out).
// The TPU kernels padded epn to 8 and C to 128 for Mosaic's tiling; here any
// epn <= 16 and any C are read as they are.
//
// The forward (#12). What bounds it on the card: device-memory bandwidth. It
// reads R*epn*C values and writes R*C (f32 at B=2 N=16,384 epn=9 C=384: 453 MB
// read, 50 MB written, 0.151 ms at 3.35 TB/s); per value it does one exp and
// a few flops. The earlier kernel (one thread per element in a grid-stride
// loop over 1,024 blocks, a 64-bit division per element, the slot arrays
// unrolled to 16 whatever epn, 4-byte loads, the row's mask re-read by every
// channel's thread) reached 47% of that bound: it was held by its instruction
// stream, not by its bytes.
//
// Design of the forward. A thread owns one row and 16 bytes of channels (4
// f32 or 8 bf16 values); a block is a 2-D tile of (kAggThreads / tx) rows by
// tx threads of channels, tx in {8, 16, 32} chosen by the launcher so that
// the row's 16-byte pieces fill the threads, and the grid's y covers the
// rest of the row. All index math is 32-bit from blockIdx / threadIdx: no
// division (the wrapper checks that R * epn * C fits in 31 bits). The kernel
// is instantiated for each epn from 1 to 16, so the slot loop unrolls to epn
// exactly; a thread issues all of its row's epn 16-byte loads (streaming:
// each message is read once, ld.global.nc.L1::no_allocate) before the
// softmax, and meanwhile one thread per row turns the row's mask into a
// bitmask in shared memory. The softmax runs in f32 with the numerics of
// slot_softmax (graph_agg.cuh), slots in slot order, and the result leaves in
// one 16-byte store. A C that is not a multiple of 16 bytes (or a pointer
// that is not 16-byte aligned) takes the element-by-element loads and stores
// of the same kernel, with the channel tail masked.
//   On an H100 SXM (700 W; scripts/profile_graph_agg.py --knn, phase 3's
// shape) it takes 0.176 ms in f32 (86% of the byte bound; the earlier kernel
// 0.317) and 0.099 ms in bf16 (76%; 0.354). Without its store the f32 kernel
// takes 0.1506 ms: the loads run at the memory rate. Without its exponentials
// it is 1% (f32) / 8% (bf16) faster; with cached loads in place of the
// streaming ones 2-3% faster. ptxas: 60 registers (f32, epn = 9) / 93 (bf16),
// no spills; the build log shows no warning.
//
// The backward (#13): one thread per (row, channel), grid-stride over R*C;
// the row's <= 16 slots sit in registers. The TPU backward wrote dt as one
// (8, 128) tile per block and divided the sum by 1024; here each block writes
// one partial (a fixed-order block sum) and a second one-block kernel adds the
// partials in a fixed order: no atomics, so dt is the same from run to run.
#include <cstdint>

#include "graph_agg.cuh"

namespace advmil {

// 16 bytes at p, read once: no L1 allocation, non-coherent path.
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// Forward: block (tx, kAggThreads / tx) = (16-byte pieces of channels, rows).
template <typename T, int EPN>
__global__ void __launch_bounds__(kAggThreads)
knn_agg_fwd_kernel(const T* __restrict__ msg, const float* __restrict__ emask,
                   const float* __restrict__ t_ptr, T* __restrict__ out, int rows, int C,
                   bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ unsigned s_on[kAggThreads / 8];  // one mask word per row of the tile
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * kVec;
  const bool live = r < rows && c0 < C;
  uint4 raw[EPN];
  if (live) {
    const T* mp = msg + r * EPN * C + c0;
#pragma unroll
    for (int s = 0; s < EPN; ++s)
      raw[s] = vec ? ld_stream16(mp + s * C) : load16<T>(mp + s * C, C - c0, false);
  }
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < blockDim.y) {
    const int rr = blockIdx.x * blockDim.y + tid;
    unsigned bits = 0;
    if (rr < rows) {
      const float* em = emask + rr * EPN;
#pragma unroll
      for (int s = 0; s < EPN; ++s) bits |= (em[s] > 0.f ? 1u : 0u) << s;
    }
    s_on[tid] = bits;
  }
  __syncthreads();
  if (!live) return;
  const unsigned on = s_on[threadIdx.y];
  const float t = t_ptr[0];
  float v[kVec], mx[kVec], den[kVec], num[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) mx[j] = -1e30f;
#pragma unroll
  for (int s = 0; s < EPN; ++s) {
    if (!((on >> s) & 1u)) continue;
    unpack16<T>(raw[s], v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) mx[j] = fmaxf(mx[j], v[j] * t);
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (mx[j] <= -1e29f) mx[j] = 0.f;
    den[j] = 0.f;
    num[j] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < EPN; ++s) {
    if (!((on >> s) & 1u)) continue;
    unpack16<T>(raw[s], v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float e = expf(v[j] * t - mx[j]);
      den[j] += e;
      num[j] += e * v[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = num[j] / fmaxf(den[j], 1e-16f);
  store16<T>(out + r * C + c0, pack16<T>(v), C - c0, vec);
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

// The forward for epn slots: the instantiation for exactly epn (1 .. kMaxEpn).
template <typename T, int EPN = 1>
cudaError_t knn_fwd(const void* msg, const void* emask, const void* t, void* out, int rows,
                    int epn, int C, cudaStream_t stream) {
  if constexpr (EPN > kMaxEpn) {
    return cudaErrorInvalidValue;
  } else {
    if (epn != EPN) return knn_fwd<T, EPN + 1>(msg, emask, t, out, rows, epn, C, stream);
    constexpr int kVec = 16 / sizeof(T);
    const int pieces = (C + kVec - 1) / kVec;  // 16-byte pieces of a row
    int tx = 32;                               // the width that leaves the fewest idle threads
    const int narrower[] = {16, 8};
    for (int w : narrower)
      if ((pieces + w - 1) / w * w < (pieces + tx - 1) / tx * tx) tx = w;
    const int ty = kAggThreads / tx;
    const bool vec = C % kVec == 0 && reinterpret_cast<uintptr_t>(msg) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const dim3 grid((rows + ty - 1) / ty, (pieces + tx - 1) / tx);
    knn_agg_fwd_kernel<T, EPN><<<grid, dim3(tx, ty), 0, stream>>>(
        static_cast<const T*>(msg), static_cast<const float*>(emask),
        static_cast<const float*>(t), static_cast<T*>(out), rows, C, vec);
    return cudaGetLastError();
  }
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
// and rows * epn * C < 2^31 (checked by the Python wrapper). Returns
// cudaGetLastError() after launch.
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
