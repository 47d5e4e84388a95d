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
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"  // cp.async

namespace advmil {

constexpr int kRegion = 16;       // patches per 4x4 region
constexpr int kWarpsPerBlock = 8;

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
// Backward (#2; #4 is its POOL = false instantiation).
//
// Replaces the Pallas TPU kernel advmil_tpu/ops/ln_pool.py:74 (_bwd_kernel,
// custom-VJP rule _bwd_rule). For g [M/16, D], per row x of region r:
//   xhat = (x - mu) * inv, gy = (xhat * scale + bias > 0) ? g[r] / 16 : 0,
//   gx = gy * scale, dh = inv * (gx - mean(gx) - xhat * mean(gx * xhat)),
//   dscale = sum over rows of gy * xhat, dbias = sum over rows of gy.
// The LN statistics are recomputed, as on the TPU, instead of saved.
//
// What bounds it on the card: device-memory bandwidth. It reads h and writes
// dh, M*D values each, and reads M*D/16 of g (bf16 at M=32,768 D=384: 52 MB,
// 0.016 ms at 3.35 TB/s); ~25 flops per value. The earlier kernel took 0.057
// ms there in three launches: an aten cast of g to f32; one warp per region
// walking its 16 rows in turn (256 blocks, under two an SM, each row's four
// dependent warp reductions between its load and the next row's), with
// 2-byte loads; and a tail of (D + 255) / 256 blocks, each thread adding the
// 256 block partials of its column one after another.
//
// Design. g is read in its storage dtype (f32 or bf16; the conversion is
// exact), so the wrapper casts nothing. A lane holds V adjacent columns per
// chunk of 32 * V (V = 4 where D % 128 == 0: 8- or 16-byte accesses; else
// V = 1), up to NCH chunks. The grid holds as many 8-warp blocks as fit on
// the card at once (occupancy x SMs, at least 8 rows a warp), and each warp
// owns a contiguous share of the rows (the shares differ by at most one row).
// A warp stages its rows into a ring of shared memory by 16-byte cp.async,
// kStages rows ahead (with the region's g row where a region starts), so
// several rows are in flight while one row's four warp reductions run. Up to
// 12 values a lane, scale, bias and the row's gx stay in registers (126
// registers: two blocks an SM); the instruction stream, not the bytes, is what
// bounds the main kernel (without its four reductions it is 13% faster,
// without its stores 8%). Each block reduces its warps' dscale / dbias sums
// through shared memory in a fixed order into one partial row; then a tail
// of D / 32 x 2 blocks of 16 warps sums the partial rows (warp w adds rows w,
// w + 16, ... with eight loads in flight, then the 16 warp sums in order),
// launched as a programmatic dependent launch: its launch overlaps the main
// kernel's end and it waits (griddepcontrol.wait) for the partials. No
// atomics: the sums are the same from run to run.
//   On an H100 SXM (700 W; scripts/profile_ln_pool.py, M = 32,768, bf16)
// the call takes 0.030 ms at D = 384 (52% of the byte bound; the earlier
// kernel 0.051 with its cast) and 0.018 at D = 128 (0.030). ptxas: 119-126
// registers at D <= 384 (63 at D = 128), 222-254 for wider rows; no spills,
// no warning. Capping the registers for 3 blocks an SM spills and doubles the
// time.
// ---------------------------------------------------------------------------

constexpr int kBwdMinRowsPerWarp = 8;
constexpr int kMaxBwdBlocks = 1024;
constexpr int kTailWarps = 16;

// The most blocks (= partial rows) the backward launches for M rows: the
// caller allocates 2 * ln_pool_bwd_blocks(M) * D floats of partials.
inline int ln_pool_bwd_blocks(int M) {
  constexpr int kRows = kBwdMinRowsPerWarp * kWarpsPerBlock;
  const int want = (M + kRows - 1) / kRows;
  return want < 1 ? 1 : (want > kMaxBwdBlocks ? kMaxBwdBlocks : want);
}

// V values of T at p as f32, and back (V = 4: one 8- or 16-byte access).
template <int V, typename T>
__device__ __forceinline__ void load_v(const T* p, float* v) {
  if constexpr (V == 1) {
    v[0] = to_f32(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xffff0000u);
  }
}
template <int V, typename T>
__device__ __forceinline__ void store_v(T* p, const float* v) {
  if constexpr (V == 1) {
    p[0] = from_f32<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                              *reinterpret_cast<const uint32_t*>(&hi));
  }
}

// Geometry of the backward for V adjacent columns a lane in NCH chunks: E
// values of a row a lane holds. Up to 12 (D <= 384), scale, bias and each
// row's gx stay in registers and 4 rows of the warp's share are in flight;
// beyond, scale and bias are read from shared memory, gx is recomputed and 2
// rows are in flight, so that the registers and shared memory hold.
template <int V, int NCH>
struct BwdGeom {
  static constexpr int E = V * NCH;
  static constexpr bool kKeep = E <= 12;
  static constexpr int kStages = kKeep ? 4 : 2;
  static constexpr int kMinBlocks = kKeep ? 2 : 1;  // per SM: at most 128 registers
};

// Dynamic shared memory of a backward block: scale and bias, then each
// warp's ring of kStages h rows and its g rows (two region slots for the
// pooled backward, one per stage for ln_relu's), 16-byte aligned.
template <typename T, typename G, int V, int NCH, bool POOL>
__host__ __device__ constexpr size_t bwd_warp_bytes(int D) {
  return static_cast<size_t>(D) *
         (BwdGeom<V, NCH>::kStages * sizeof(T) + (POOL ? 2 : BwdGeom<V, NCH>::kStages) * sizeof(G));
}
template <typename T, typename G, int V, int NCH, bool POOL>
__host__ __device__ constexpr size_t bwd_smem_bytes(int D) {
  return 2 * sizeof(float) * D + kWarpsPerBlock * bwd_warp_bytes<T, G, V, NCH, POOL>(D);
}

// POOL = false is ln_relu's backward: g is [M, D] (one cotangent row per row
// of h, staged with it) and is not divided by 16.
template <typename T, typename G, int V, int NCH, bool POOL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, BwdGeom<V, NCH>::kMinBlocks)
ln_relu_region_mean_bwd_kernel(const G* __restrict__ g, const T* __restrict__ h,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias, T* __restrict__ dh,
                               float* __restrict__ part_dscale,
                               float* __restrict__ part_dbias, int M, int D, float eps) {
  constexpr int E = BwdGeom<V, NCH>::E;
  constexpr int S = BwdGeom<V, NCH>::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_sc = reinterpret_cast<float*>(smem);
  float* s_bi = s_sc + D;
  unsigned char* rings = smem + 2 * sizeof(float) * D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nch = D / (32 * V);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    s_sc[c] = scale[c];
    s_bi[c] = bias[c];
  }
  __syncthreads();
  const int hb = D * sizeof(T), gb = D * sizeof(G);  // bytes of a row
  unsigned char* ring = rings + warp * bwd_warp_bytes<T, G, V, NCH, POOL>(D);
  auto h_slot = [&](int k) { return reinterpret_cast<T*>(ring + (k % S) * hb); };
  auto g_slot = [&](int k) { return reinterpret_cast<G*>(ring + S * hb + k * gb); };
  // this warp's rows [r_lo, r_hi): a contiguous share of [0, M)
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  const long long wid = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  const int r_lo = static_cast<int>(wid * M / nwarps);
  const int n = static_cast<int>((wid + 1) * M / nwarps) - r_lo;
  auto copy_row = [&](void* dst, const void* src, int bytes) {
    for (int p = lane; p < bytes / 16; p += 32)
      cp_async_16(static_cast<unsigned char*>(dst) + 16 * p,
                  static_cast<const unsigned char*>(src) + 16 * p, true);
  };
  // stage row k of the share (and its g row: the region's, where one starts)
  auto issue = [&](int k) {
    if (k < n) {
      const int r = r_lo + k;
      copy_row(h_slot(k), h + static_cast<size_t>(r) * D, hb);
      if (!POOL)
        copy_row(g_slot(k % S), g + static_cast<size_t>(r) * D, gb);
      else if (k == 0 || r % kRegion == 0)
        copy_row(g_slot((r / kRegion) & 1), g + static_cast<size_t>(r / kRegion) * D, gb);
    }
    cp_async_commit();
  };
  auto col = [&](int j) { return j * 32 * V + lane * V; };  // first column of chunk j
  auto read_row = [&](const auto* row, float* v) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (j < nch) {
        load_v<V>(row + col(j), v + j * V);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[j * V + k] = 0.f;
      }
    }
  };

  constexpr bool kKeep = BwdGeom<V, NCH>::kKeep;
  float dsc[E], dbi[E], x[E], gr[E], gx[kKeep ? E : 1], sc[kKeep ? E : 1], bi[kKeep ? E : 1];
#pragma unroll
  for (int e = 0; e < E; ++e) dsc[e] = dbi[e] = 0.f;
  if constexpr (kKeep) {
    read_row(s_sc, sc);
    read_row(s_bi, bi);
  }
  // scale and bias of value e of the lane
  auto scale_of = [&](int e) {
    if constexpr (kKeep) return sc[e];
    else return s_sc[col(e / V) + e % V];
  };
  auto bias_of = [&](int e) {
    if constexpr (kKeep) return bi[e];
    else return s_bi[col(e / V) + e % V];
  };
  const float inv_d = 1.f / static_cast<float>(D);
#pragma unroll
  for (int k = 0; k < S - 1; ++k) issue(k);
  for (int k = 0; k < n; ++k) {
    issue(k + S - 1);  // into the slot row k - 1 left (read before the last __syncwarp)
    cp_async_wait<S - 1>();
    __syncwarp();      // row k has landed for every lane
    const int r = r_lo + k;
    read_row(h_slot(k), x);
    if (!POOL) {
      read_row(g_slot(k % S), gr);
    } else if (k == 0 || r % kRegion == 0) {
      read_row(g_slot((r / kRegion) & 1), gr);
#pragma unroll
      for (int e = 0; e < E; ++e) gr[e] *= 1.f / kRegion;
    }
    __syncwarp();      // every lane has read the slot before it is staged again
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) s += x[e];
    const float mu = warp_sum(s) * inv_d;
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float d = e / V < nch ? x[e] - mu : 0.f;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) * inv_d + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e / V >= nch) continue;
      x[e] = (x[e] - mu) * inv;  // xhat
      const float gy = (x[e] * scale_of(e) + bias_of(e) > 0.f) ? gr[e] : 0.f;
      dsc[e] += gy * x[e];
      dbi[e] += gy;
      const float gxe = gy * scale_of(e);
      if constexpr (kKeep) gx[e] = gxe;
      m1 += gxe;
      m2 += gxe * x[e];
    }
    m1 = warp_sum(m1) * inv_d;
    m2 = warp_sum(m2) * inv_d;
    T* drow = dh + static_cast<size_t>(r) * D;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (j >= nch) continue;
      float o[V];
#pragma unroll
      for (int k2 = 0; k2 < V; ++k2) {
        const int e = j * V + k2;
        float gxe;
        if constexpr (kKeep)
          gxe = gx[e];
        else
          gxe = ((x[e] * scale_of(e) + bias_of(e) > 0.f) ? gr[e] : 0.f) * scale_of(e);
        o[k2] = inv * (gxe - m1 - x[e] * m2);
      }
      store_v<V>(drow + col(j), o);
    }
  }
  cp_async_wait<0>();
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the tail may start
  // block partials of dscale / dbias: warps reduced in a fixed order, through
  // [kWarpsPerBlock][D] floats over the rings (every warp is done with its
  // own), used twice
  float* s_red = reinterpret_cast<float*>(rings);
  for (int which = 0; which < 2; ++which) {
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e / V < nch) s_red[warp * D + col(e / V) + e % V] = which ? dbi[e] : dsc[e];
    __syncthreads();
    float* part = which ? part_dbias : part_dscale;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsPerBlock; ++w) a += s_red[w * D + c];
      part[static_cast<size_t>(blockIdx.x) * D + c] = a;
    }
  }
}

// dscale[c] (blockIdx.y 0) or dbias[c] (1) = the sum over the nblocks partial
// rows, for the 32 columns of blockIdx.x, in a fixed order.
__global__ void __launch_bounds__(32 * kTailWarps)
sum_partials_kernel(const float* __restrict__ part_dscale,
                    const float* __restrict__ part_dbias, float* __restrict__ dscale,
                    float* __restrict__ dbias, int nblocks, int D) {
  __shared__ float s_sum[kTailWarps][32];
  // launched while the main kernel ends (programmatic dependent launch):
  // wait until its partials are written
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const float* part = (blockIdx.y ? part_dbias : part_dscale) + c;
  float a = 0.f;
  if (c < D) {
    constexpr int kIn = 8;  // loads in flight
    int k = warp;
    for (; k + (kIn - 1) * kTailWarps < nblocks; k += kIn * kTailWarps) {
      float p[kIn];
#pragma unroll
      for (int i = 0; i < kIn; ++i) p[i] = part[static_cast<size_t>(k + i * kTailWarps) * D];
#pragma unroll
      for (int i = 0; i < kIn; ++i) a += p[i];
    }
    for (; k < nblocks; k += kTailWarps) a += part[static_cast<size_t>(k) * D];
  }
  s_sum[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && c < D) {
    float b = 0.f;
#pragma unroll
    for (int w = 0; w < kTailWarps; ++w) b += s_sum[w][lane];
    (blockIdx.y ? dbias : dscale)[c] = b;
  }
}

template <typename T, typename G, int V, int NCH, bool POOL>
cudaError_t launch_bwd_kernel(const void* g, const void* h, const void* scale,
                              const void* bias, void* dh, void* dscale, void* dbias,
                              void* partials, int M, int D, float eps, cudaStream_t stream) {
  auto kernel = ln_relu_region_mean_bwd_kernel<T, G, V, NCH, POOL>;
  const size_t smem = bwd_smem_bytes<T, G, V, NCH, POOL>(D);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)   // dynamic shared memory beyond 48 KB is opted into
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kWarpsPerBlock,
                                                        smem);
  if (err == cudaSuccess) err = device_sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int cap = ln_pool_bwd_blocks(M);
  const int fit = (per_sm < 1 ? 1 : per_sm) * sms;
  const int nblocks = fit < cap ? fit : cap;
  float* part_dscale = static_cast<float*>(partials);
  float* part_dbias = part_dscale + static_cast<size_t>(cap) * D;
  kernel<<<nblocks, 32 * kWarpsPerBlock, smem, stream>>>(
      static_cast<const G*>(g), static_cast<const T*>(h), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(dh), part_dscale, part_dbias, M, D,
      eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the tail as a programmatic dependent launch: its launch overlaps the main
  // kernel's end, and it waits (griddepcontrol.wait) for the partials
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + 31) / 32, 2);
  cfg.blockDim = dim3(32 * kTailWarps);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, sum_partials_kernel, const_cast<const float*>(part_dscale),
                            const_cast<const float*>(part_dbias), static_cast<float*>(dscale),
                            static_cast<float*>(dbias), nblocks, D);
}

template <typename T, typename G, bool POOL>
cudaError_t launch_bwd(const void* g, const void* h, const void* scale, const void* bias,
                       void* dh, void* dscale, void* dbias, void* partials, int M, int D,
                       float eps, cudaStream_t stream) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  auto run = [&](auto kernel_launch) {
    return kernel_launch(g, h, scale, bias, dh, dscale, dbias, partials, M, D, eps, stream);
  };
  // rows are staged by 16-byte cp.async (the wrapper hands in 16-byte aligned rows)
  if (!aligned(g) || !aligned(h) || !aligned(dh)) return cudaErrorMisalignedAddress;
  if (D % 128 == 0) {
    if (D <= 128) return run(launch_bwd_kernel<T, G, 4, 1, POOL>);
    if (D <= 384) return run(launch_bwd_kernel<T, G, 4, 3, POOL>);
    return run(launch_bwd_kernel<T, G, 4, 8, POOL>);
  }
  if (D <= 128) return run(launch_bwd_kernel<T, G, 1, 4, POOL>);
  return run(launch_bwd_kernel<T, G, 1, 32, POOL>);
}

}  // namespace advmil

// Rows of each partial buffer the backward needs for M rows: the caller
// allocates 2 * rows * D floats.
extern "C" int advmil_ln_pool_bwd_blocks(int M) { return advmil::ln_pool_bwd_blocks(M); }

// g [M/16, D] (f32 or bf16: g_dtype), h [M, D] (f32 or bf16: dtype), scale /
// bias [D] f32 -> dh [M, D] in h's dtype, dscale / dbias [D] f32; partials:
// scratch of 2 * advmil_ln_pool_bwd_blocks(M) * D floats. Same shape limits as
// the forward. Returns cudaGetLastError() after the second launch.
extern "C" int advmil_ln_relu_region_mean_bwd(const void* g, const void* h,
                                              const void* scale, const void* bias,
                                              void* dh, void* dscale, void* dbias,
                                              void* partials, int M, int D, int dtype,
                                              int g_dtype, float eps, void* stream) {
  using advmil::kBF16;
  using advmil::kF32;
  using advmil::launch_bwd;
  using bf16 = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && g_dtype == kF32)
    return launch_bwd<float, float, true>(g, h, scale, bias, dh, dscale, dbias, partials, M, D,
                                          eps, s);
  if (dtype == kF32 && g_dtype == kBF16)
    return launch_bwd<float, bf16, true>(g, h, scale, bias, dh, dscale, dbias, partials, M, D,
                                         eps, s);
  if (dtype == kBF16 && g_dtype == kF32)
    return launch_bwd<bf16, float, true>(g, h, scale, bias, dh, dscale, dbias, partials, M, D,
                                         eps, s);
  if (dtype == kBF16 && g_dtype == kBF16)
    return launch_bwd<bf16, bf16, true>(g, h, scale, bias, dh, dscale, dbias, partials, M, D,
                                        eps, s);
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
