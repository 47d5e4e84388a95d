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
// graph_agg.cuh's note, slots in slot order, and the result leaves in
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
// The backward (#13). What bounds it: device-memory bandwidth. It reads
// R*epn*C messages and R*C of g and writes R*epn*C of dm (f32 at B=2
// N=16,384 epn=9 C=384: 453 + 50 MB read, 453 MB written, 0.286 ms at 3.35
// TB/s); per message value it does one exp (recomputed) and ~12 flops.
//
// Design of the backward: the forward's. The same 2-D tile of (rows, 16-byte
// pieces) per block, the same 32-bit index math without a division, one
// instantiation per epn, and the mask bitmask in shared memory. A thread
// issues its row's epn streaming 16-byte message loads and the 16-byte load of
// g before any arithmetic, keeps the raw words in registers and unpacks them
// for each of three passes over the slots (max; den and num; dm and the dt
// terms), recomputing exp in the last one rather than holding epn x kVec
// exponentials. dm leaves in one 16-byte store a slot (st.global.cs: dm is
// written once and not read back by this kernel); a masked slot gets an
// exact 0. dt: each thread sums g * sum_s a_s m_s (m_s - out) over its
// channels in channel order, each block writes one partial (block_sum_fixed),
// and sum_dt_partials_kernel adds the partials in a fixed order: no atomics,
// so dt is the same from run to run. The grid has one partial per block, so
// the caller sizes the scratch from advmil_knn_agg_bwd_blocks.
//   The earlier kernel it replaces (one thread per (row, channel) in a
// grid-stride loop over 1,024 blocks, a 64-bit division per element, the slot
// arrays unrolled to 16 behind epn predicates, the row's mask re-read by
// every channel's thread, 4- or 2-byte scalar loads and stores) took 0.4606
// ms in f32 (62% of the bound) and 0.4484 ms in bf16 (32%): as slow in bf16
// as in f32 with half the bytes. Its variant builds (scripts/
// profile_graph_agg.py --knn --other-variants) put the loss in its structure,
// not its arithmetic: the slot arrays unrolled to 9 took 13% (f32) / 24%
// (bf16) off, no stores 20% / 9%, but the division by a constant only 2-3%,
// no dt arithmetic 1%, and no softmax at all 6% in bf16 (f32 9% slower).
//   On an NVIDIA H100 80GB HBM3 at 700.00 W (profile_graph_agg.py --knn, in
// turns with the earlier kernel) the backward takes 0.3406-0.3410 ms in f32 at
// phase 3's shape (84% of the bound; 1.35x) and 0.1907-0.1910 ms in bf16
// (75%; 2.35x); on phase 37's residual rows (f32, U = 1,120-1,256 a bag)
// 0.0319-0.0360 ms (61%; 1.24-1.30x). f32 is at the mixed read / write floor of this access
// pattern: the same loads and stores without the arithmetic take 0.3396 ms,
// the loads alone 0.1765 (the forward's rate). bf16 keeps 9% of arithmetic
// beyond that floor (0.1743): exp costs 7% of it, exp2f would take back 2%,
// and capping registers for 3 blocks an SM spills (0.2568). st.global.cs
// beats plain stores by 1% (f32) / 1.5% (bf16) at phase 3's shape and 1-3%
// (f32) on the residual rows. The second launch costs 0.003-0.004 ms (10% of
// a residual-row call): folding it into the first (a last-block ticket)
// needs a counter that is zero at every call, i.e. another launch (a
// memset) or state kept per stream, so it stays. ptxas: 79 registers (f32,
// epn = 9), 119 (f32, 16), 102 (bf16, 9), 147 (bf16, 16), no spills; 3 / 2
// blocks an SM at epn = 9.
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

// The 16 bytes at p (kVec values of T, `valid` of them inside the row),
// written once: a streaming (evict-first) vector store with `vec`, else
// element by element up to the end of the row.
template <typename T>
__device__ __forceinline__ void store_stream16(T* p, const uint4& w, int valid, bool vec) {
  if (vec) {
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(w.x),
                 "r"(w.y), "r"(w.z), "r"(w.w)
                 : "memory");
    return;
  }
  store16<T>(p, w, valid, false);
}

// Launch geometry of both kernels: block (tx, kAggThreads / tx) = (16-byte
// pieces of channels, rows), tx in {8, 16, 32} leaving the fewest idle
// threads; grid (row tiles, piece tiles).
template <typename T>
void knn_geom(int rows, int C, dim3* grid, dim3* block) {
  constexpr int kVec = 16 / sizeof(T);
  const int pieces = (C + kVec - 1) / kVec;  // 16-byte pieces of a row
  int tx = 32;
  const int narrower[] = {16, 8};
  for (int w : narrower)
    if ((pieces + w - 1) / w * w < (pieces + tx - 1) / tx * tx) tx = w;
  const int ty = kAggThreads / tx;
  *grid = dim3((rows + ty - 1) / ty, (pieces + tx - 1) / tx);
  *block = dim3(tx, ty);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The thread's 16 bytes of each of its row's EPN slots at mp (slot stride C),
// all issued before any is used; streaming loads on the vector path.
template <typename T, int EPN>
__device__ __forceinline__ void load_slots(const T* mp, int C, int valid, bool vec,
                                           uint4 (&raw)[EPN]) {
#pragma unroll
  for (int s = 0; s < EPN; ++s)
    raw[s] = vec ? ld_stream16(mp + s * C) : load16<T>(mp + s * C, valid, false);
}

// One thread per row of the block's tile turns the row's mask into a bitmask
// (bit s: slot s is a real edge) in s_on; then the block syncs. Every thread
// of the block calls it.
template <int EPN>
__device__ __forceinline__ void stage_mask_bits(const float* __restrict__ emask, int rows,
                                                unsigned* s_on) {
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
}

// The softmax statistics of a thread's kVec channels over the real slots of
// its row (the bits of on), slots in slot order: mx = max(v t) (0 without a
// real slot), den = sum e, num = sum e v, e = exp(v t - mx).
template <typename T, int EPN>
__device__ __forceinline__ void slot_stats(const uint4 (&raw)[EPN], unsigned on, float t,
                                           float* mx, float* den, float* num) {
  constexpr int kVec = 16 / sizeof(T);
  float v[kVec];
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
}

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
  if (live) load_slots<T, EPN>(msg + r * EPN * C + c0, C, C - c0, vec, raw);
  stage_mask_bits<EPN>(emask, rows, s_on);
  if (!live) return;
  float v[kVec], mx[kVec], den[kVec], num[kVec];
  slot_stats<T, EPN>(raw, s_on[threadIdx.y], t_ptr[0], mx, den, num);
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = num[j] / fmaxf(den[j], 1e-16f);
  store16<T>(out + r * C + c0, pack16<T>(v), C - c0, vec);
}

template <typename T, int EPN>
__global__ void __launch_bounds__(kAggThreads)
knn_agg_bwd_kernel(const T* __restrict__ msg, const float* __restrict__ emask,
                   const float* __restrict__ t_ptr, const T* __restrict__ g,
                   T* __restrict__ dmsg, float* __restrict__ part_dt, int rows, int C,
                   bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ unsigned s_on[kAggThreads / 8];
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * kVec;
  const bool live = r < rows && c0 < C;
  uint4 raw[EPN], graw;
  if (live) {
    load_slots<T, EPN>(msg + r * EPN * C + c0, C, C - c0, vec, raw);
    graw = vec ? ld_stream16(g + r * C + c0) : load16<T>(g + r * C + c0, C - c0, false);
  }
  stage_mask_bits<EPN>(emask, rows, s_on);
  float dt = 0.f;
  if (live) {
    const unsigned on = s_on[threadIdx.y];
    const float t = t_ptr[0];
    float v[kVec], mx[kVec], inv[kVec], o[kVec], gv[kVec], w[kVec];
    slot_stats<T, EPN>(raw, on, t, mx, inv, o);  // inv, o hold den, num here
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      inv[j] = 1.f / fmaxf(inv[j], 1e-16f);
      o[j] *= inv[j];
      w[j] = 0.f;
    }
    unpack16<T>(graw, gv);
    T* dp = dmsg + r * EPN * C + c0;
#pragma unroll
    for (int s = 0; s < EPN; ++s) {
      float d[kVec];
      if ((on >> s) & 1u) {
        unpack16<T>(raw[s], v);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float a = expf(v[j] * t - mx[j]) * inv[j];
          d[j] = gv[j] * a * (1.f + t * (v[j] - o[j]));
          w[j] += a * v[j] * (v[j] - o[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) d[j] = 0.f;
      }
      store_stream16<T>(dp + s * C, pack16<T>(d), C - c0, vec);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) dt += gv[j] * w[j];
  }
  dt = block_sum_fixed(dt, threadIdx.y * blockDim.x + threadIdx.x);
  if (threadIdx.x == 0 && threadIdx.y == 0) part_dt[blockIdx.y * gridDim.x + blockIdx.x] = dt;
}

// The forward for epn slots: the instantiation for exactly epn (1 .. kMaxEpn).
template <typename T, int EPN = 1>
cudaError_t knn_fwd(const void* msg, const void* emask, const void* t, void* out, int rows,
                    int epn, int C, cudaStream_t stream) {
  if constexpr (EPN > kMaxEpn) {
    return cudaErrorInvalidValue;
  } else {
    if (epn != EPN) return knn_fwd<T, EPN + 1>(msg, emask, t, out, rows, epn, C, stream);
    dim3 grid, block;
    knn_geom<T>(rows, C, &grid, &block);
    const bool vec = C % (16 / sizeof(T)) == 0 && aligned16(msg) && aligned16(out);
    knn_agg_fwd_kernel<T, EPN><<<grid, block, 0, stream>>>(
        static_cast<const T*>(msg), static_cast<const float*>(emask),
        static_cast<const float*>(t), static_cast<T*>(out), rows, C, vec);
    return cudaGetLastError();
  }
}

// The backward for epn slots, then the fixed-order sum of its block partials.
template <typename T, int EPN = 1>
cudaError_t knn_bwd(const void* msg, const void* emask, const void* t, const void* g,
                    void* dmsg, void* partials, int n_partials, void* dt, int rows, int epn,
                    int C, cudaStream_t stream) {
  if constexpr (EPN > kMaxEpn) {
    return cudaErrorInvalidValue;
  } else {
    if (epn != EPN)
      return knn_bwd<T, EPN + 1>(msg, emask, t, g, dmsg, partials, n_partials, dt, rows, epn,
                                 C, stream);
    dim3 grid, block;
    knn_geom<T>(rows, C, &grid, &block);
    const int nblocks = static_cast<int>(grid.x * grid.y);
    if (nblocks > n_partials) return cudaErrorInvalidValue;  // scratch too small
    const bool vec = C % (16 / sizeof(T)) == 0 && aligned16(msg) && aligned16(g) &&
                     aligned16(dmsg);
    knn_agg_bwd_kernel<T, EPN><<<grid, block, 0, stream>>>(
        static_cast<const T*>(msg), static_cast<const float*>(emask),
        static_cast<const float*>(t), static_cast<const T*>(g), static_cast<T*>(dmsg),
        static_cast<float*>(partials), rows, C, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sum_dt_partials_kernel<<<1, kAggThreads, 0, stream>>>(static_cast<const float*>(partials),
                                                          nblocks, static_cast<float*>(dt));
    return cudaGetLastError();
  }
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

// The dt partials (blocks) the backward writes for rows x C in dtype; -1 for
// an unknown dtype.
extern "C" int advmil_knn_agg_bwd_blocks(int rows, int C, int dtype) {
  dim3 grid, block;
  if (dtype == advmil::kF32)
    advmil::knn_geom<float>(rows, C, &grid, &block);
  else if (dtype == advmil::kBF16)
    advmil::knn_geom<__nv_bfloat16>(rows, C, &grid, &block);
  else
    return -1;
  return static_cast<int>(grid.x * grid.y);
}

// The backward for g [rows, C] in msg's dtype: dmsg [rows, epn, C] in msg's
// dtype and dt [1] f32; partials: scratch of n_partials floats, at least
// advmil_knn_agg_bwd_blocks(rows, C, dtype) (else cudaErrorInvalidValue and
// nothing is launched). Same limits as the forward. Returns
// cudaGetLastError() after the second launch.
extern "C" int advmil_knn_agg_bwd(const void* msg, const void* emask, const void* t,
                                  const void* g, void* dmsg, void* partials, int n_partials,
                                  void* dt, int rows, int epn, int C, int dtype,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32)
    return advmil::knn_bwd<float>(msg, emask, t, g, dmsg, partials, n_partials, dt, rows, epn,
                                  C, s);
  if (dtype == advmil::kBF16)
    return advmil::knn_bwd<__nv_bfloat16>(msg, emask, t, g, dmsg, partials, n_partials, dt,
                                          rows, epn, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
