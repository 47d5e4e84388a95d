// Banded graph softmax aggregation of GENConv, forward (#14) and backward (#15).
//
// Replaces the Pallas TPU kernels advmil_tpu/ops/banded_pallas.py:89
// (_banded_fwd_kernel) and :123 (_banded_bwd_kernel), wrapper
// pallas_banded_aggregate. Raster-ordered spatial kNN graphs are near-banded:
// slot s of node n mostly reads source n + offs[s] for one offset per slot.
// For y [B, N, C] (the per-source messages relu(x) + eps), offs [B, epn] and
// band_mask [B, N, epn] (1 = the edge is real AND sits on its slot's band),
// per bag b, node n and channel c, with v_s = y[b, n + offs[b, s], c] over
// the slots with band_mask > 0 and a source inside the bag:
//   m = max_s t * v_s (0 without a slot), den = sum_s exp(t * v_s - m),
//   out = sum_s exp(t * v_s - m) * v_s / max(den, 1e-16),
// saving lse = m + log(max(den, 1e-16)) and, for bf16 storage, out in f32
// (out32: dt keeps f32 rounding) for the backward. A node without edges
// aggregates to exactly 0. Edges off the band are not handled here: the
// wrapper recomputes the rows that own one exactly and overwrites them
// (ops/banded.py).
//
// The backward, for the cotangent g [B, N, C] of out: row r was read by slot
// s of node n = r - offs[s] with the weight p = exp(t * y[r] - lse[n]), so
// with h = g[n] * (y[r] - out[n])
//   dy[r] = sum_s p * (g[n] + t * h),   dt += sum_s p * h * y[r].
// Each (n, s) lands in exactly one r, so dy is a gather: no scatter, no
// atomics. dt is a sum of per-block partials, added in a fixed order by a
// second kernel (graph_agg.cuh), so it is the same from run to run.
//
// What bounds it on the card. The bytes (bf16 at phase 3's shape, B=2
// N=16,384 epn=9 C=384: the forward moves 152 MB, 0.045 ms at 3.35 TB/s; the
// backward 177 MB, 0.053 ms) are not the limit: on an H100 SXM (700 W) the
// staging alone takes 0.016 / 0.067 ms of the kernels' 0.103 / 0.153, the
// compute alone 0.106 / 0.132 (scripts/profile_graph_agg.py, `stage_only`,
// `compute_only`). The instruction stream is: per slot a backward thread
// runs ~115 instructions for its 8 channels (one exp and ~9 more per
// element, the rest the slot's row, mask and five 16-byte shared loads);
// the exponentials themselves cost 2-6%. Saving lse in place of (m, den) took
// 50 MB off each kernel. ptxas: no spills; forward 64 / 55 registers (bf16 /
// f32), backward 72 / 54; the build log shows no warning.
//
// The earlier kernels (one thread per element, 64-bit index divisions, slot
// arrays unrolled to 16, per-slot gathers of m, den, out and g from L2) took
// 0.40 / 0.60 ms: the forward lost 37% to the 16-slot unroll, the backward
// 35% to the divisions and most of the rest to the gathers.
//
// Design. A block owns one bag, one chunk of channels (16 bytes a thread, 8
// bf16 or 4 f32 values) and a segment of consecutive rows, which it walks in
// steps of kRows rows; the grid holds one wave of resident blocks (4 an SM
// for the forward, 2 for the backward, whose ring is larger). The rows
// that the staged slots read for a step (its window: the step's rows widened
// by the smallest and the largest offset) sit in a ring of kRing rows in
// shared memory, loaded by 16-byte cp.async once per block: while a step is
// computed, the rows that the next step adds are in flight. Rows outside the
// bag are zero-filled, and the slot's own range check keeps them out. The
// index math is 32-bit from the unit number: no division per element. The
// offsets, the staged window and the mask rows of the window are in shared
// memory too; a thread loops over the epn slots (not a fixed 16), once for
// the max and once for the sums, with the softmax in f32 in registers, and
// stores with 16-byte vector stores.
//   The forward's ring holds y; the backward's holds, per source row of the
//   window, g, out32, lse and the mask row, so that the per-node terms are read
//   from device memory once per block, not once per slot.
//   Any offset works: a slot whose offset lies outside the span the ring can
//   stage (kMaxSpan) reads its row straight from device memory. The span is
//   taken from offs inside the kernel: the wrapper does not sync.
//   C need not be a multiple of 16 bytes: then the loads and stores go element
//   by element (synchronous staging), with the same ring.
#include <atomic>

#include "graph_agg.cuh"
#include "mma.cuh"  // cp.async, fast_exp2, kLog2e

namespace advmil {
namespace {

constexpr int kBandThreads = kAggThreads;  // 256: block_sum_fixed's block size
constexpr float kLn2 = 0.6931471805599453f;

// Geometry of the forward (kBwd false) or backward kernel for storage T.
template <typename T, bool kBwd>
struct BandGeom {
  static constexpr int kVec = 16 / sizeof(T);             // channels a thread holds
  static constexpr int kTpr = (kBwd && sizeof(T) == 2) ? 4 : 8;  // threads per row
  static constexpr int kChunk = kVec * kTpr;               // channels a block holds
  static constexpr int kRows = kBandThreads / kTpr;        // rows per step
  static constexpr int kRing = 256;                        // staged rows (power of 2)
  static constexpr int kMaxSpan = kRing - 2 * kRows;       // window + next step's rows
  // forward: 37 KB of shared memory, registers capped at 64 for 4 blocks an
  // SM; backward: 96 KB, 2 blocks an SM
  static constexpr int kBlocksPerSm = kBwd ? 2 : 4;
  // shared memory: the ring (y, or g + out32 + lse), then the mask rows
  static constexpr size_t kRingBytes =
      static_cast<size_t>(kRing) * kChunk * (kBwd ? sizeof(T) + 2 * sizeof(float) : sizeof(T));
  static constexpr size_t kMaskRows = kBwd ? kRing : 2 * kRows;
  static constexpr size_t kSmem = kRingBytes + kMaskRows * kMaxEpn * sizeof(float);
};

__device__ __forceinline__ float fast_log(float x) {  // lg2.approx: 2^-22 absolute
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y * kLn2;
}

// n f32 values (n = 4 or 8) from device memory into v / from v to device memory
template <int n>
__device__ __forceinline__ void load_f32(const float* p, float* v, int valid, bool vec) {
#pragma unroll
  for (int k = 0; k < n / 4; ++k) unpack16<float>(load16<float>(p + 4 * k, valid - 4 * k, vec),
                                                  v + 4 * k);
}
template <int n>
__device__ __forceinline__ void store_f32(float* p, const float* v, int valid, bool vec) {
#pragma unroll
  for (int k = 0; k < n / 4; ++k) store16<float>(p + 4 * k, pack16<float>(v + 4 * k),
                                                 valid - 4 * k, vec);
}

// Start the copy of 16 bytes (kVec values of T, `valid` of them inside the
// row; none: zero-fill) into shared memory: cp.async with `vec`, else a
// synchronous element copy. Either is visible after the next wait + barrier.
template <typename T>
__device__ __forceinline__ void stage16(T* dst, const T* src, const T* base, int valid,
                                        bool vec) {
  if (vec) {
    cp_async_16(dst, valid > 0 ? src : base, valid > 0);
    return;
  }
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < kVec; ++j) dst[j] = j < valid ? src[j] : from_f32<T>(0.f);
}

// What a block does for one unit: bag b, channel chunk, rows [r_begin, r_end).
struct Unit {
  int b, c_base, r_begin, r_end;
};

__device__ __forceinline__ Unit unit_of(int u, int chunks, int segs, int seg_rows, int chunk,
                                        int N) {
  Unit w;
  const int rest = u / chunks;
  w.c_base = (u - rest * chunks) * chunk;
  w.b = rest / segs;
  w.r_begin = (rest - w.b * segs) * seg_rows;
  w.r_end = min(N, w.r_begin + seg_rows);
  return w;
}

// The staged window of a step, as offsets from its rows: [-hl, rows + hr),
// for d_s = sign * offs[s] (the row a slot reads relative to the row being
// computed); slots with -hl <= d_s <= hr are staged (bit s of the result),
// the others read device memory. hl + hr <= max_span.
__device__ __forceinline__ unsigned staged_slots(const int* s_off, int epn, int sign,
                                                 int max_span, int* hl, int* hr) {
  int lo = 0, hi = 0;
  for (int s = 0; s < epn; ++s) {
    lo = min(lo, sign * s_off[s]);
    hi = max(hi, sign * s_off[s]);
  }
  int l = -lo, h = hi;
  if (l + h > max_span) {
    l = min(l, max_span / 2);
    h = min(h, max_span - l);
  }
  unsigned bits = 0;
  for (int s = 0; s < epn; ++s) {
    const int d = sign * s_off[s];
    if (d >= -l && d <= h) bits |= 1u << s;
  }
  *hl = l;
  *hr = h;
  return bits;
}

template <typename T>
__global__ void __launch_bounds__(kBandThreads, BandGeom<T, false>::kBlocksPerSm)
banded_fwd_kernel(const T* __restrict__ y, const int* __restrict__ offs,
                  const float* __restrict__ bmask, const float* __restrict__ t_ptr,
                  T* __restrict__ out, float* __restrict__ lse_out, float* __restrict__ out32,
                  int N, int C, int epn, int chunks, int segs, int seg_rows, int units,
                  bool vec) {
  using G = BandGeom<T, false>;
  constexpr int kVec = G::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_y = reinterpret_cast<T*>(smem);                           // kRing x kChunk
  float* s_bm = reinterpret_cast<float*>(smem + G::kRingBytes);  // 2 steps x kRows x epn
  __shared__ int s_off[kMaxEpn];
  const float t = t_ptr[0];
  const int tid = threadIdx.x, row = tid / G::kTpr, part = tid % G::kTpr;

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_of(u, chunks, segs, seg_rows, G::kChunk, N);
    __syncthreads();  // the previous unit is done with s_off and the ring
    if (tid < epn) s_off[tid] = offs[w.b * epn + tid];
    __syncthreads();
    int hl, hr;
    const unsigned staged = staged_slots(s_off, epn, 1, G::kMaxSpan, &hl, &hr);
    const T* yb = y + static_cast<size_t>(w.b) * N * C;
    const float* bmb = bmask + static_cast<size_t>(w.b) * N * epn;
    const int c0 = w.c_base + part * kVec;  // this thread's channels: c0 .. c0 + kVec - 1

    // y rows [r_lo, r_hi) of the bag into the ring (zeros outside the bag)
    auto stage_rows = [&](int r_lo, int r_hi) {
      for (int i = tid; i < (r_hi - r_lo) * G::kTpr; i += kBandThreads) {
        const int r = r_lo + i / G::kTpr, p = i % G::kTpr;
        const int c = w.c_base + p * kVec;
        const bool in = r >= 0 && r < N;
        stage16<T>(s_y + (r & (G::kRing - 1)) * G::kChunk + p * kVec,
                   yb + static_cast<size_t>(in ? r : 0) * C + c, y, in ? C - c : 0, vec);
      }
    };
    // the mask rows of the step at rows [r0, r0 + kRows) into buffer `buf`
    auto stage_mask = [&](int r0, int buf) {
      const int n = min(G::kRows, N - r0) * epn;
      float* dst = s_bm + buf * G::kRows * kMaxEpn;
      const float* src = bmb + static_cast<size_t>(r0) * epn;
      for (int i = tid; i < n; i += kBandThreads) cp_async_4(dst + i, src + i, true);
    };

    int r0 = w.r_begin;
    stage_rows(r0 - hl, r0 + G::kRows + hr);
    stage_mask(r0, 0);
    cp_async_commit();
    for (int step = 0; r0 < w.r_end; ++step, r0 += G::kRows) {
      cp_async_wait<0>();
      __syncthreads();  // this step's rows have landed; the last step is done with the rows
                        // the next one's loads overwrite
      if (r0 + G::kRows < w.r_end) {
        stage_rows(r0 + G::kRows + hr, r0 + 2 * G::kRows + hr);
        stage_mask(r0 + G::kRows, (step + 1) & 1);
      }
      cp_async_commit();

      const int n = r0 + row;
      if (n >= w.r_end || c0 >= C) continue;
      const float* bm = s_bm + (step & 1) * G::kRows * kMaxEpn + row * epn;
      unsigned on = 0;
      for (int s = 0; s < epn; ++s) {
        const int src = n + s_off[s];
        if (bm[s] > 0.f && src >= 0 && src < N) on |= 1u << s;
      }
      auto slot = [&](int s, float* v) {
        const int src = n + s_off[s];
        uint4 raw;
        if ((staged >> s) & 1u)
          raw = *reinterpret_cast<const uint4*>(s_y + (src & (G::kRing - 1)) * G::kChunk +
                                                part * kVec);
        else
          raw = load16<T>(yb + static_cast<size_t>(src) * C + c0, C - c0, vec);
        unpack16<T>(raw, v);
      };
      float mx[kVec], den[kVec], num[kVec], v[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) mx[j] = -1e30f;
      for (int s = 0; s < epn; ++s) {
        if (!((on >> s) & 1u)) continue;
        slot(s, v);
#pragma unroll
        for (int j = 0; j < kVec; ++j) mx[j] = fmaxf(mx[j], v[j] * t);
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (mx[j] <= -1e29f) mx[j] = 0.f;
        den[j] = 0.f;
        num[j] = 0.f;
      }
      for (int s = 0; s < epn; ++s) {
        if (!((on >> s) & 1u)) continue;
        slot(s, v);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float e = fast_exp2(fmaf(v[j], t, -mx[j]) * kLog2e);
          den[j] += e;
          num[j] = fmaf(e, v[j], num[j]);
        }
      }
      float o[kVec], l[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = fmaxf(den[j], 1e-16f);
        o[j] = num[j] / d;
        l[j] = mx[j] + fast_log(d);
      }
      const size_t at = (static_cast<size_t>(w.b) * N + n) * C + c0;
      store16<T>(out + at, pack16<T>(o), C - c0, vec);
      if (lse_out != nullptr) store_f32<kVec>(lse_out + at, l, C - c0, vec);
      if (out32 != nullptr) store_f32<kVec>(out32 + at, o, C - c0, vec);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBandThreads, BandGeom<T, true>::kBlocksPerSm)
banded_bwd_kernel(const T* __restrict__ y, const int* __restrict__ offs,
                  const float* __restrict__ bmask, const float* __restrict__ t_ptr,
                  const float* __restrict__ lse, const float* __restrict__ out32,
                  const T* __restrict__ g, T* __restrict__ dy, float* __restrict__ part_dt,
                  int N, int C, int epn, int chunks, int segs, int seg_rows, int units,
                  bool vec) {
  using G = BandGeom<T, true>;
  constexpr int kVec = G::kVec;
  constexpr int kGp = G::kChunk * sizeof(T) / 16;  // 16-byte pieces of g per staged row
  constexpr int kFp = G::kChunk * 4 / 16;          // ... of out32 and of lse
  constexpr int kPieces = kGp + 2 * kFp;
  // A thread reads kVec / 4 pieces of an f32 row. With two (bf16), the pieces
  // of odd rows sit swapped in pairs, so that the two rows that one phase of a
  // 16-byte shared load covers fall on different banks.
  constexpr int kSwap = kVec / 4 - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_g = reinterpret_cast<T*>(smem);                           // kRing x kChunk each
  float* s_o = reinterpret_cast<float*>(s_g + G::kRing * G::kChunk);
  float* s_l = s_o + G::kRing * G::kChunk;
  float* s_bm = reinterpret_cast<float*>(smem + G::kRingBytes);  // kRing x epn
  __shared__ int s_off[kMaxEpn];
  const float t = t_ptr[0];
  const int tid = threadIdx.x, row = tid / G::kTpr, part = tid % G::kTpr;
  float dt = 0.f;

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_of(u, chunks, segs, seg_rows, G::kChunk, N);
    __syncthreads();
    if (tid < epn) s_off[tid] = offs[w.b * epn + tid];
    __syncthreads();
    int hl, hr;  // row r reads source n = r - offs[s]
    const unsigned staged = staged_slots(s_off, epn, -1, G::kMaxSpan, &hl, &hr);
    const size_t bag = static_cast<size_t>(w.b) * N;
    const int c0 = w.c_base + part * kVec;

    // the source rows [n_lo, n_hi): g, out32, lse and the mask row (zeros outside the bag)
    auto stage_rows = [&](int n_lo, int n_hi) {
      for (int i = tid; i < (n_hi - n_lo) * kPieces; i += kBandThreads) {
        const int n = n_lo + i / kPieces, p = i % kPieces;
        const bool in = n >= 0 && n < N;
        const size_t at = (bag + (in ? n : 0)) * C;
        const int q = (n & (G::kRing - 1)) * G::kChunk;
        if (p < kGp) {
          const int c = w.c_base + p * kVec;
          stage16<T>(s_g + q + p * kVec, g + at + c, g, in ? C - c : 0, vec);
        } else {
          const int k = p < kGp + kFp ? p - kGp : p - kGp - kFp;
          const int c = w.c_base + 4 * k;
          stage16<float>((p < kGp + kFp ? s_o : s_l) + q + 4 * (k ^ (n & kSwap)),
                         (p < kGp + kFp ? out32 : lse) + at + c, lse, in ? C - c : 0, vec);
        }
      }
      for (int i = tid; i < (n_hi - n_lo) * epn; i += kBandThreads) {
        const int k = i / epn, s = i - k * epn, n = n_lo + k;
        const bool in = n >= 0 && n < N;
        cp_async_4(s_bm + (n & (G::kRing - 1)) * epn + s,
                   bmask + (bag + (in ? n : 0)) * epn + s, in);
      }
    };

    int r0 = w.r_begin;
    stage_rows(r0 - hl, r0 + G::kRows + hr);
    cp_async_commit();
    for (; r0 < w.r_end; r0 += G::kRows) {
      cp_async_wait<0>();
      __syncthreads();
      if (r0 + G::kRows < w.r_end) stage_rows(r0 + G::kRows + hr, r0 + 2 * G::kRows + hr);
      cp_async_commit();

      const int r = r0 + row;
      if (r >= w.r_end || c0 >= C) continue;
      const size_t at = (bag + r) * C + c0;
      float yr[kVec], acc[kVec], wsum[kVec], gv[kVec], ov[kVec], lv[kVec];
      unpack16<T>(load16<T>(y + at, C - c0, vec), yr);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = wsum[j] = 0.f;
      for (int s = 0; s < epn; ++s) {
        const int n = r - s_off[s];  // the node that read y[r] in slot s
        if (n < 0 || n >= N) continue;
        if ((staged >> s) & 1u) {
          const int q = n & (G::kRing - 1);
          if (!(s_bm[q * epn + s] > 0.f)) continue;
          const int e = q * G::kChunk + part * kVec;
          unpack16<T>(*reinterpret_cast<const uint4*>(s_g + e), gv);
#pragma unroll
          for (int i = 0; i < kVec / 4; ++i) {
            const int at_i = e + 4 * (i ^ (n & kSwap));
            unpack16<float>(*reinterpret_cast<const uint4*>(s_o + at_i), ov + 4 * i);
            unpack16<float>(*reinterpret_cast<const uint4*>(s_l + at_i), lv + 4 * i);
          }
        } else {
          if (!(bmask[(bag + n) * epn + s] > 0.f)) continue;
          const size_t e = (bag + n) * C + c0;
          unpack16<T>(load16<T>(g + e, C - c0, vec), gv);
          load_f32<kVec>(out32 + e, ov, C - c0, vec);
          load_f32<kVec>(lse + e, lv, C - c0, vec);
        }
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float p = fast_exp2(fmaf(yr[j], t, -lv[j]) * kLog2e);
          const float h = gv[j] * (yr[j] - ov[j]);
          acc[j] = fmaf(p, fmaf(t, h, gv[j]), acc[j]);
          wsum[j] = fmaf(p, h, wsum[j]);
        }
      }
      store16<T>(dy + at, pack16<T>(acc), C - c0, vec);
#pragma unroll
      for (int j = 0; j < kVec; ++j) dt = fmaf(yr[j], wsum[j], dt);
    }
  }
  dt = block_sum_fixed(dt);
  if (threadIdx.x == 0) part_dt[blockIdx.x] = dt;
}

// SMs x resident blocks of `kernel` with `smem` bytes of dynamic shared
// memory on the current device, asked once per device (and the shared-memory
// limit raised for it).
template <typename K>
cudaError_t resident_blocks(K kernel, size_t smem, int* blocks) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cache[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int v = dev < kMaxDevices ? cache[dev].load(std::memory_order_relaxed) : 0;
  if (v == 0) {
    int sms = 0, per = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kBandThreads, smem);
    if (err != cudaSuccess) return err;
    v = sms * (per > 0 ? per : 1);
    if (dev < kMaxDevices) cache[dev].store(v, std::memory_order_relaxed);
  }
  *blocks = v;
  return cudaSuccess;
}

struct BandPlan {
  int chunks, segs, seg_rows, units, grid;
};

// Units (bag, channel chunk, segment of rows) for one wave of `resident`
// blocks, at most `max_grid` blocks.
template <typename G>
cudaError_t plan_units(int B, int N, int C, int resident, int max_grid, BandPlan* p) {
  p->chunks = (C + G::kChunk - 1) / G::kChunk;
  const long long pairs = static_cast<long long>(B) * p->chunks;
  const int steps = (N + G::kRows - 1) / G::kRows;
  long long segs = (resident + pairs - 1) / pairs;
  segs = segs < 1 ? 1 : (segs > steps ? steps : segs);
  const int seg_steps = static_cast<int>((steps + segs - 1) / segs);
  p->segs = (steps + seg_steps - 1) / seg_steps;
  p->seg_rows = seg_steps * G::kRows;
  const long long units = pairs * p->segs;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  p->units = static_cast<int>(units);
  p->grid = static_cast<int>(units < resident ? units : resident);
  if (p->grid > max_grid) p->grid = max_grid;
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
cudaError_t banded_fwd(const void* y, const void* offs, const void* bmask, const void* t,
                       void* out, void* lse, void* out32, int B, int N, int C, int epn,
                       cudaStream_t stream) {
  using G = BandGeom<T, false>;
  int resident = 0;
  cudaError_t err = resident_blocks(banded_fwd_kernel<T>, G::kSmem, &resident);
  if (err != cudaSuccess) return err;
  BandPlan p;
  err = plan_units<G>(B, N, C, resident, 1 << 30, &p);
  if (err != cudaSuccess) return err;
  const bool vec = C % G::kVec == 0 && aligned16(y) && aligned16(out) && aligned16(lse) &&
                   aligned16(out32);
  banded_fwd_kernel<T><<<p.grid, kBandThreads, G::kSmem, stream>>>(
      static_cast<const T*>(y), static_cast<const int*>(offs),
      static_cast<const float*>(bmask), static_cast<const float*>(t), static_cast<T*>(out),
      static_cast<float*>(lse), static_cast<float*>(out32), N, C, epn, p.chunks, p.segs,
      p.seg_rows, p.units, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t banded_bwd(const void* y, const void* offs, const void* bmask, const void* t,
                       const void* lse, const void* out32, const void* g, void* dy,
                       void* partials, void* dt, int B, int N, int C, int epn,
                       cudaStream_t stream) {
  using G = BandGeom<T, true>;
  int resident = 0;
  cudaError_t err = resident_blocks(banded_bwd_kernel<T>, G::kSmem, &resident);
  if (err != cudaSuccess) return err;
  BandPlan p;
  err = plan_units<G>(B, N, C, resident, kMaxAggBlocks, &p);
  if (err != cudaSuccess) return err;
  const bool vec = C % G::kVec == 0 && aligned16(y) && aligned16(lse) && aligned16(out32) &&
                   aligned16(g) && aligned16(dy);
  banded_bwd_kernel<T><<<p.grid, kBandThreads, G::kSmem, stream>>>(
      static_cast<const T*>(y), static_cast<const int*>(offs),
      static_cast<const float*>(bmask), static_cast<const float*>(t),
      static_cast<const float*>(lse), static_cast<const float*>(out32),
      static_cast<const T*>(g), static_cast<T*>(dy), static_cast<float*>(partials), N, C, epn,
      p.chunks, p.segs, p.seg_rows, p.units, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_dt_partials_kernel<<<1, kAggThreads, 0, stream>>>(static_cast<const float*>(partials),
                                                        p.grid, static_cast<float*>(dt));
  return cudaGetLastError();
}

}  // namespace
}  // namespace advmil

// y [B, N, C] (f32 or bf16), offs [B, epn] int32, bmask [B, N, epn] f32, t [1]
// f32 on the device -> out [B, N, C] in y's dtype; lse [B, N, C] f32, or null
// to skip it; out32 [B, N, C] f32 (out before rounding), or null. Requires
// B * N * C > 0, 1 <= epn <= 16 (checked by the Python wrapper). Returns
// cudaGetLastError() after launch.
extern "C" int advmil_banded_fwd(const void* y, const void* offs, const void* bmask,
                                 const void* t, void* out, void* lse, void* out32, int B, int N,
                                 int C, int epn, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32)
    return advmil::banded_fwd<float>(y, offs, bmask, t, out, lse, out32, B, N, C, epn, s);
  if (dtype == advmil::kBF16)
    return advmil::banded_fwd<__nv_bfloat16>(y, offs, bmask, t, out, lse, out32, B, N, C, epn,
                                             s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward from the forward's lse and out32 (both f32; out32 is out for
// f32) for g [B, N, C] in y's dtype: dy [B, N, C] in y's dtype and dt [1]
// f32; partials: scratch of 1024 floats. Returns cudaGetLastError() after the
// second launch.
extern "C" int advmil_banded_bwd(const void* y, const void* offs, const void* bmask,
                                 const void* t, const void* lse, const void* out32,
                                 const void* g, void* dy, void* partials, void* dt, int B, int N,
                                 int C, int epn, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32)
    return advmil::banded_bwd<float>(y, offs, bmask, t, lse, out32, g, dy, partials, dt, B, N,
                                     C, epn, s);
  if (dtype == advmil::kBF16)
    return advmil::banded_bwd<__nv_bfloat16>(y, offs, bmask, t, lse, out32, g, dy, partials,
                                             dt, B, N, C, epn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
