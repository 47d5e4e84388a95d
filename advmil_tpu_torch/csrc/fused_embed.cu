// Fused region patch embedding: Dense -> LayerNorm -> ReLU -> 16-row region
// mean in one kernel, and its backward.
//
// Replaces the Pallas TPU kernels of advmil_tpu/ops/fused_embed.py:
//   _fwd_kernel          out[r] = mean_{16 rows} relu(LN(x W + b) * scale + bias)
//   _bwd_dparams_kernel  dW = x^T dh, db = sum dh, dscale = sum gy * xhat, dbias = sum gy
//   _bwd_dx_kernel       dx = dh W^T
// for x [M, K] (f32 or bf16, M % 16 == 0), W [K, D] f32 rounded to x's type
// for the product, f32 accumulation, h = x W + b kept in f32 (never rounded),
// LN statistics in f32 with eps inside the rsqrt.
//
// Every matrix product is computed here: bf16 on the tensor cores through
// nvcuda::wmma (m16n16k16, f32 accumulators), f32 with plain FMAs (true f32,
// no TF32). No library GEMM is called.
//
// What bounds them on the card (M = 32,768, K = 1,024, D = 384, bf16): the
// forward does 25.8 GFLOP, 26 us at 989 TFLOP/s, against 68 MB or 20 us at
// 3.35 TB/s, so the tensor cores bound it; in f32 the 67 TFLOP/s of the CUDA
// cores do (385 us). The backward does two products for the parameters
// (recompute h, then x^T dh) and one more for dx.
//
// Design.
// - LN needs a whole row of h, so one block owns 128 full rows: a 128 x D
//   tile of f32 accumulators held in registers across 16 warps (D <= 384: 96
//   per thread, 512 threads: the whole register file), K walked in chunks of
//   32 through shared memory; W arrives already rounded to x's type (the wrapper casts it once per call; it
//   stays in L2: 0.75 MB in bf16). The bf16 kernels take W transposed,
//   [D, K]: the tensor cores' B fragment wants the reduction index contiguous,
//   and from a [K, D] tile wmma gathers it two bytes at a time (that alone
//   cost a quarter of the forward's time); the f32 FMA path keeps [K, D], which its
//   lane-contiguous columns read without bank conflicts. Every block reads
//   all of W from L2; 128-row blocks halve the 64-row version's 390 MB of
//   that. For the epilogue a warp holds 4 whole
//   rows at a time, lane-contiguous columns, as the LN-pool kernels do (the
//   wmma accumulators get there through a 64-row f32 tile in shared memory,
//   twice), so mean and variance are warp shuffles; four such 4-row sums make
//   one region.
// - The TPU backward carried dW [K, D] in scratch across its sequential grid
//   and recomputed h in both kernels. Here blocks run in any order, so the
//   row kernel runs once more in backward mode and writes dh [M, D] (in x's
//   type, M * D * 2 bytes = 25 MB in bf16: traffic the TPU kernels avoided by
//   recomputing twice) with per-block partials of db / dscale / dbias; a
//   tiled product then forms dW = x^T dh split over M into a fixed number of
//   slabs, and dx = dh W^T reads the same dh only when x needs a gradient.
// - No atomics: per-block and per-slab partials are summed by a last pass
//   in a fixed order, so the gradients are the same from run to run.
// - Tiles reach shared memory through cp.async (16 bytes a thread, zero fill
//   beyond the ragged edge) in a ring of 3 stages, one barrier per chunk, so
//   the loads of two chunks are in flight while one is multiplied. A first
//   version loaded synchronously through registers and spent its time
//   waiting on one load after another (bf16 forward at M = 32,768, D = 384:
//   0.55 ms then, 0.16 ms now, against 0.07 ms for cuBLAS + the LN-pool
//   kernel; NVIDIA H100 80GB HBM3, 700 W). TMA and wgmma come later.
// - Rows beyond M in the last block are zero-filled: h = b there, finite, and
//   they write nothing; an all-zero x row has var = 0 and rsqrt(0 + eps) is
//   finite, so a zero cotangent never meets a NaN.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace advmil {
namespace fe {

using namespace nvcuda;

constexpr int kThreads = 256;     // threads of the tiled products (8 warps)
constexpr int kRowThreads = 512;  // threads of the row kernel (16 warps)
constexpr int kRowWarps = 16;
constexpr int kBK = 32;           // reduction chunk
constexpr int kPad = 8;           // padding of shared rows, in elements
constexpr int kRowsBM = 128;      // rows of x per block of the row kernel
constexpr int kRegion = 16;
constexpr int kGM = 128;          // output tile of the plain products
constexpr int kGN = 128;
constexpr int kTargetBlocks = 264;  // blocks the dW product is split into (2 x 132 SMs)

constexpr int kStages = 3;        // cp.async ring depth

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&a);
  raw.y = *reinterpret_cast<const unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// 16 bytes from device memory to shared memory without passing registers;
// with ok false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of a rows x cols tile (cols a multiple of 16 bytes) from
// device memory into shared memory, 16 bytes a thread; elements at or beyond
// (row_lim, col_lim) are zero-filled and not read. All addresses are 16-byte
// aligned: the wrappers check the bases, and every stride is a multiple of 32
// elements.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int dst_ld, const T* src, size_t src_ld,
                                          int rows, int cols, int row_lim, int col_lim) {
  constexpr int V = 16 / sizeof(T);
  const int cv = cols / V;
  for (int i = threadIdx.x; i < rows * cv; i += blockDim.x) {
    const int r = i / cv;
    const int c = (i - r * cv) * V;
    const bool ok = r < row_lim && c < col_lim;
    cp_async16(dst + r * dst_ld + c, ok ? src + static_cast<size_t>(r) * src_ld + c : src, ok);
  }
}

// ---------------------------------------------------------------------------
// The row kernel: h = x W + b for 64 rows, then the forward or the backward
// epilogue.
// ---------------------------------------------------------------------------

// Shared memory of the row kernel: a ring of 3 (A tile, B tile) stages, over
// which the bf16 path lays the block's 128 x D f32 tile of h once the
// products are done, and over which both paths later lay the warps' partial
// sums; then the epilogue's operands: scale, bias and, backward, the
// cotangent rows of the block's 8 regions, already divided by 16 (in shared
// memory, not registers: beside 4 rows of h and the sums they would spill).
struct RowSmem {
  int off_b, stage, off_p, total;
};

__host__ __device__ inline RowSmem row_smem(int D, int elt, bool bf16, bool bwd) {
  RowSmem s;
  s.off_b = kRowsBM * (kBK + kPad) * elt;
  s.stage = s.off_b + (bf16 ? D * (kBK + kPad) : kBK * (D + kPad)) * elt;
  const int ring = kStages * s.stage;
  const int htile = bf16 ? kRowsBM * (D + kPad) * 4 : 0;
  s.off_p = ring > htile ? ring : htile;   // >= 16 warps x 3 x D floats of sums
  s.total = s.off_p + (bwd ? 2 + kRowsBM / kRegion : 2) * D * 4;
  return s;
}

// The LN / ReLU epilogue of four whole rows of h held by one warp (v[i][j]:
// row i, column lane + 32 j; the rows lie in one region). Forward: returns
// their ReLU sums in `acc` (the caller's slot of the region mean). Backward:
// writes their dh rows and adds to the warp's db / dscale / dbias sums.
template <typename T, int NC, bool BWD>
__device__ __forceinline__ void ln_rows4(float (&v)[4][NC], int nc, int lane, float inv_d,
                                         float eps, const float* sc, const float* bi,
                                         const float* gr, T* __restrict__ dh, int grow,
                                         bool live, int D, float (&acc)[3][NC]) {
  // sc, bi, gr: this lane's first column of scale, bias and the region's
  // cotangent row / 16 in shared memory; column j is 32 j further on
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) s += v[i][j];
    const float mu = warp_sum(s) * inv_d;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float d = j < nc ? v[i][j] - mu : 0.f;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) * inv_d + eps);
    if (!BWD) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if (j < nc) acc[0][j] += fmaxf((v[i][j] - mu) * inv * sc[32 * j] + bi[32 * j], 0.f);
    } else {
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (j < nc) {
          const float xh = (v[i][j] - mu) * inv;
          const float gy = (xh * sc[32 * j] + bi[32 * j] > 0.f) ? gr[32 * j] : 0.f;
          acc[1][j] += gy * xh;   // dscale
          acc[2][j] += gy;        // dbias
          const float gx = gy * sc[32 * j];
          m1 += gx;
          m2 += gx * xh;
          v[i][j] = xh;
        }
      }
      m1 = warp_sum(m1) * inv_d;
      m2 = warp_sum(m2) * inv_d;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        // gy again from its definition: cheaper than keeping gx in registers
        if (j < nc) {
          const float gy = (v[i][j] * sc[32 * j] + bi[32 * j] > 0.f) ? gr[32 * j] : 0.f;
          const float d = inv * (gy * sc[32 * j] - m1 - v[i][j] * m2);
          acc[0][j] += d;       // db, from the unrounded dh
          if (live) dh[static_cast<size_t>(grow + i) * D + lane + 32 * j] = from_f32<T>(d);
        }
      }
    }
  }
}

// Four rows of h, all of one region, into the epilogue; forward: acc[0]
// gathers their ReLU sums; backward: acc holds the warp's db / dscale / dbias.
template <typename T, int NC, bool BWD>
__device__ __forceinline__ void finish4(float (&v4)[4][NC], int grow, int rloc, const float* Ps,
                                        int nc, int lane, float inv_d, float eps,
                                        T* __restrict__ out, int M, int D,
                                        float (&acc)[3][NC]) {
  // rloc: the rows' region within the block; Ps: scale, bias, the regions' g / 16
  ln_rows4<T, NC, BWD>(v4, nc, lane, inv_d, eps, Ps + lane, Ps + D + lane,
                       Ps + (2 + rloc) * D + lane, out, grow, grow < M, D, acc);
}

// The epilogue's per-warp state, set after the products so that it does not
// sit in registers beside the accumulators: zeroed sums and the Dense bias.
template <int NC>
__device__ __forceinline__ void epilogue_state(float (&acc)[3][NC], float (&bb)[NC],
                                               const float* __restrict__ b, int nc, int lane) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    acc[0][j] = acc[1][j] = acc[2][j] = 0.f;
    bb[j] = j < nc ? b[lane + 32 * j] : 0.f;
  }
}

template <typename T, int NC, bool BWD>
__global__ void __launch_bounds__(kRowThreads)
fused_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ b, const float* __restrict__ scale,
                  const float* __restrict__ bias, const float* __restrict__ g,
                  T* __restrict__ out, float* __restrict__ partials, int M, int K, int D,
                  float eps) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const RowSmem lay = row_smem(D, sizeof(T), kBf16, BWD);
  float* Rs = reinterpret_cast<float*>(smem);  // over the ring, once it is idle
  const int lda = kBK + kPad, ldb = kBf16 ? kBK + kPad : D + kPad;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = D >> 5;
  const int row0 = blockIdx.x * kRowsBM;
  const int nk = K / kBK;
  const float inv_d = 1.f / static_cast<float>(D);
  auto stage_a = [&](int kt) { return reinterpret_cast<T*>(smem + (kt % kStages) * lay.stage); };
  auto stage_b = [&](int kt) {
    return reinterpret_cast<T*>(smem + (kt % kStages) * lay.stage + lay.off_b);
  };
  // chunk kt of x and W into its ring slot; always one commit, so that the
  // group count stays the chunk count
  auto prefetch = [&](int kt) {
    if (kt < nk) {
      load_tile(stage_a(kt), lda, x + static_cast<size_t>(row0) * K + kt * kBK, K, kRowsBM, kBK,
                M - row0, K - kt * kBK);
      if (kBf16)  // w is [D, K]
        load_tile(stage_b(kt), ldb, w + kt * kBK, K, D, kBK, D, K - kt * kBK);
      else        // w is [K, D]
        load_tile(stage_b(kt), ldb, w + static_cast<size_t>(kt) * kBK * D, D, kBK, D,
                  K - kt * kBK, D);
    }
    cp_async_commit();
  };
  // chunk kt has landed for every thread, and every thread is done with chunk
  // kt - 1, whose slot the next prefetch overwrites
  auto advance = [&](int kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    prefetch(kt + kStages - 1);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) prefetch(st);
  // the epilogue's operands; the main loop's barriers come before their use
  float* Ps = reinterpret_cast<float*>(smem + lay.off_p);
  for (int c = threadIdx.x; c < D; c += kRowThreads) {
    Ps[c] = scale[c];
    Ps[D + c] = bias[c];
  }
  if (BWD) {
    const int regions = M / kRegion;
    for (int idx = threadIdx.x; idx < (kRowsBM / kRegion) * D; idx += kRowThreads) {
      const int region = blockIdx.x * (kRowsBM / kRegion) + idx / D;
      Ps[2 * D + idx] = region < regions
                            ? g[static_cast<size_t>(region) * D + idx % D] * (1.f / kRegion)
                            : 0.f;
    }
  }
  float acc[3][NC], bb[NC];  // see epilogue_state

  if constexpr (kBf16) {
    // 16 warps as 4 x 4: warp (wr, wc) owns rows 32 wr .. + 32 and the 16-column
    // tiles wc * CT .. + CT (4 x CT x 16 = 32 NC columns)
    constexpr int CT = NC / 2;
    const int wr = warp >> 2, wc = warp & 3;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[2][CT];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int t = 0; t < CT; ++t) wmma::fill_fragment(cf[r][t], 0.f);
    for (int kt = 0; kt < nk; ++kt) {
      advance(kt);
      const T* As = stage_a(kt);
      const T* Bs = stage_b(kt);
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          wmma::load_matrix_sync(af[r], As + (32 * wr + 16 * r) * lda + ks, lda);
#pragma unroll
        for (int t = 0; t < CT; ++t) {
          const int col = (wc * CT + t) * 16;
          if (col < D) {  // warp-uniform
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
            wmma::load_matrix_sync(bf, Bs + col * ldb + ks, ldb);
#pragma unroll
            for (int r = 0; r < 2; ++r) wmma::mma_sync(cf[r][t], af[r], bf, cf[r][t]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    // the ring is idle: h goes over it, so that every warp gets 8 whole rows,
    // lane-contiguous columns, and no accumulator fragment stays in registers
    float* Hs = reinterpret_cast<float*>(smem);
    const int ldh = D + kPad;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const int col = (wc * CT + t) * 16;
        if (col < D)
          wmma::store_matrix_sync(Hs + (32 * wr + 16 * r) * ldh + col, cf[r][t], ldh,
                                  wmma::mem_row_major);
      }
    __syncthreads();
    epilogue_state<NC>(acc, bb, b, nc, lane);
#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
      float v4[4][NC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j)
          v4[i][j] = j < nc ? Hs[(8 * warp + 4 * grp + i) * ldh + lane + 32 * j] + bb[j] : 0.f;
      finish4<T, NC, BWD>(v4, row0 + 8 * warp + 4 * grp, warp / 2, Ps, nc, lane, inv_d, eps, out,
                          M, D, acc);
    }
  } else {
    // warp w owns rows 8 w .. + 8, every column (lane + 32 j)
    float v[8][NC];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) v[i][j] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      advance(kt);
      const T* As = stage_a(kt);
      const T* Bs = stage_b(kt);
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[(8 * warp + i) * lda + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          if (j < nc) {
            const float bv = Bs[kk * ldb + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i][j] = fmaf(a[i], bv, v[i][j]);
          }
        }
      }
    }
    cp_async_wait<0>();
    epilogue_state<NC>(acc, bb, b, nc, lane);
#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
      float v4[4][NC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) v4[i][j] = v[4 * grp + i][j] + bb[j];
      finish4<T, NC, BWD>(v4, row0 + 8 * warp + 4 * grp, warp / 2, Ps, nc, lane, inv_d, eps, out,
                          M, D, acc);
    }
  }

  // every warp holds the sums of its 8 rows (half a region); they meet in
  // shared memory, over the ring and h's tile, which nobody reads any more
  __syncthreads();
  constexpr int NQ = BWD ? 3 : 1;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (j < nc) Rs[(warp * NQ + q) * D + lane + 32 * j] = acc[q][j];
  __syncthreads();
  if constexpr (!BWD) {
    const int regions = M / kRegion;
    for (int idx = threadIdx.x; idx < (kRowsBM / kRegion) * D; idx += kRowThreads) {
      const int r = idx / D, c = idx - r * D;
      const int region = blockIdx.x * (kRowsBM / kRegion) + r;
      if (region < regions)
        out[static_cast<size_t>(region) * D + c] =
            from_f32<T>((Rs[(2 * r) * D + c] + Rs[(2 * r + 1) * D + c]) * (1.f / kRegion));
    }
  } else {
    // block partials of db / dscale / dbias: the warps' sums added in a fixed order
    for (int idx = threadIdx.x; idx < 3 * D; idx += kRowThreads) {
      float a = 0.f;
#pragma unroll
      for (int wv = 0; wv < kRowWarps; ++wv) a += Rs[wv * 3 * D + idx];
      partials[static_cast<size_t>(blockIdx.x) * 3 * D + idx] = a;
    }
  }
}

// out[c] = sum over rows of part[r, c], rows added in a fixed order: 8 row
// lanes stride over the rows, then their sums are added in lane order.
__global__ void sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out,
                                int nrows, int ncols) {
  __shared__ float red[8][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f;
  if (c < ncols)
    for (int r = threadIdx.y; r < nrows; r += 8) a += part[static_cast<size_t>(r) * ncols + c];
  red[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && c < ncols) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += red[k][threadIdx.x];
    out[c] = s;
  }
}

inline cudaError_t sum_rows(const float* part, float* out, int nrows, int ncols,
                            cudaStream_t stream) {
  sum_rows_kernel<<<(ncols + 31) / 32, dim3(32, 8), 0, stream>>>(part, out, nrows, ncols);
  return cudaGetLastError();
}

template <typename T, int NC, bool BWD>
cudaError_t launch_rows_nc(const void* x, const void* w, const void* b, const void* scale,
                           const void* bias, const void* g, void* out, void* partials, int M,
                           int K, int D, float eps, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int bytes = row_smem(D, sizeof(T), kBf16, BWD).total;
  auto kernel = fused_rows_kernel<T, NC, BWD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (M + kRowsBM - 1) / kRowsBM;
  kernel<<<blocks, kRowThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(g), static_cast<T*>(out), static_cast<float*>(partials), M, K,
      D, eps);
  return cudaGetLastError();
}

template <typename T, bool BWD>
cudaError_t launch_rows(const void* x, const void* w, const void* b, const void* scale,
                        const void* bias, const void* g, void* out, void* partials, int M,
                        int K, int D, float eps, cudaStream_t stream) {
  if (D <= 128)
    return launch_rows_nc<T, 4, BWD>(x, w, b, scale, bias, g, out, partials, M, K, D, eps,
                                     stream);
  return launch_rows_nc<T, 12, BWD>(x, w, b, scale, bias, g, out, partials, M, K, D, eps,
                                    stream);
}

// ---------------------------------------------------------------------------
// The plain tiled product C[m, n] = sum_k a(m, k) b(k, n) for dW and dx:
// 128 x 128 output tiles (64-wide ones move 1.5 times the bytes from L2 for
// the same product), the reduction walked in chunks of 32, optionally
// split into slabs (blockIdx.z) that each write their own partial C.
// A_COL: a(m, k) = A[k * lda + m], else A[m * lda + k];
// B_COL: b(k, n) = B[n * ldb + k], else B[k * ldb + n].
// ---------------------------------------------------------------------------

// shared elements of the A and B tiles: the larger of each one's two layouts
constexpr int kAsElems = kGM * (kBK + kPad) > kBK * (kGM + kPad) ? kGM * (kBK + kPad)
                                                                   : kBK * (kGM + kPad);
constexpr int kBsElems = kGN * (kBK + kPad) > kBK * (kGN + kPad) ? kGN * (kBK + kPad)
                                                                   : kBK * (kGN + kPad);

// kStages x (A tile, B tile); the bf16 path lays its f32 output tile over the
// ring once the products are done
__host__ __device__ inline int gemm_smem_bytes(int elt, bool bf16) {
  const int ring = kStages * (kAsElems + kBsElems) * elt;
  const int ctile = bf16 ? kGM * (kGN + kPad) * 4 : 0;
  return ring > ctile ? ring : ctile;
}

template <typename T, bool A_COL, bool B_COL, typename OutT>
__global__ void __launch_bounds__(kThreads)
gemm_tile_kernel(const T* __restrict__ A, const T* __restrict__ B, OutT* __restrict__ C,
                 int Mc, int Nc, int Kr, size_t lda, size_t ldb, int slab_len) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int sa_ld = A_COL ? kGM + kPad : kBK + kPad;
  constexpr int sb_ld = B_COL ? kBK + kPad : kGN + kPad;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int kbeg = blockIdx.z * slab_len;
  const int kend = min(Kr, kbeg + slab_len);
  C += static_cast<size_t>(blockIdx.z) * Mc * Nc;

  const int nk = (kend - kbeg + kBK - 1) / kBK;
  auto stage_a = [&](int kt) {
    return reinterpret_cast<T*>(smem) + (kt % kStages) * (kAsElems + kBsElems);
  };
  auto prefetch = [&](int kt) {   // always one commit: the group count is the chunk count
    if (kt < nk) {
      T* As = stage_a(kt);
      T* Bs = As + kAsElems;
      const int k0 = kbeg + kt * kBK;
      if (A_COL)
        load_tile(As, sa_ld, A + static_cast<size_t>(k0) * lda + m0, lda, kBK, kGM, kend - k0,
                  Mc - m0);
      else
        load_tile(As, sa_ld, A + static_cast<size_t>(m0) * lda + k0, lda, kGM, kBK, Mc - m0,
                  kend - k0);
      if (B_COL)
        load_tile(Bs, sb_ld, B + static_cast<size_t>(n0) * ldb + k0, ldb, kGN, kBK, Nc - n0,
                  kend - k0);
      else
        load_tile(Bs, sb_ld, B + static_cast<size_t>(k0) * ldb + n0, ldb, kBK, kGN, kend - k0,
                  Nc - n0);
    }
    cp_async_commit();
  };
  auto advance = [&](int kt) {    // see the row kernel
    cp_async_wait<kStages - 2>();
    __syncthreads();
    prefetch(kt + kStages - 1);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) prefetch(st);

  if constexpr (kBf16) {
    using ALayout = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
    using BLayout = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
    // 8 warps as 2 x 4: warp (wr, wc) owns rows 64 wr .. + 64, columns 32 wc .. + 32
    const int wr = warp >> 2, wc = warp & 3;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int t = 0; t < 2; ++t) wmma::fill_fragment(cf[r][t], 0.f);
    for (int kt = 0; kt < nk; ++kt) {
      advance(kt);
      const T* As = stage_a(kt);
      const T* Bs = As + kAsElems;
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> af[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 64 * wr + 16 * r;
          wmma::load_matrix_sync(af[r], A_COL ? As + ks * sa_ld + row : As + row * sa_ld + ks,
                                 sa_ld);
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int col = 32 * wc + 16 * t;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> bf;
          wmma::load_matrix_sync(bf, B_COL ? Bs + col * sb_ld + ks : Bs + ks * sb_ld + col,
                                 sb_ld);
#pragma unroll
          for (int r = 0; r < 4; ++r) wmma::mma_sync(cf[r][t], af[r], bf, cf[r][t]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is idle: the output tile goes over it
    float* Cs = reinterpret_cast<float*>(smem);
    constexpr int ldc = kGN + kPad;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int t = 0; t < 2; ++t)
        wmma::store_matrix_sync(Cs + (64 * wr + 16 * r) * ldc + 32 * wc + 16 * t, cf[r][t], ldc,
                                wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < kGM * (kGN / 4); i += kThreads) {
      const int r = i / (kGN / 4), c = (i - r * (kGN / 4)) << 2;
      if (m0 + r < Mc && n0 + c < Nc) {
        const float v[4] = {Cs[r * ldc + c], Cs[r * ldc + c + 1], Cs[r * ldc + c + 2],
                            Cs[r * ldc + c + 3]};
        store4(C + static_cast<size_t>(m0 + r) * Nc + n0 + c, v);
      }
    }
  } else {
    // warp w owns rows 16 w .. + 16, lane the columns lane + 32 c
    constexpr int NCOL = kGN / 32;
    float acc[16][NCOL];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int c = 0; c < NCOL; ++c) acc[i][c] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      advance(kt);
      const T* As = stage_a(kt);
      const T* Bs = As + kAsElems;
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float bv[NCOL];
#pragma unroll
        for (int c = 0; c < NCOL; ++c)
          bv[c] = B_COL ? Bs[(lane + 32 * c) * sb_ld + kk] : Bs[kk * sb_ld + lane + 32 * c];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float a = A_COL ? As[kk * sa_ld + 16 * warp + i] : As[(16 * warp + i) * sa_ld + kk];
#pragma unroll
          for (int c = 0; c < NCOL; ++c) acc[i][c] = fmaf(a, bv[c], acc[i][c]);
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int m = m0 + 16 * warp + i;
      if (m < Mc) {
#pragma unroll
        for (int c = 0; c < NCOL; ++c)
          if (n0 + lane + 32 * c < Nc)
            C[static_cast<size_t>(m) * Nc + n0 + lane + 32 * c] = from_f32<OutT>(acc[i][c]);
      }
    }
  }
}

// Slabs the dW product is split into over M: enough blocks to fill the card,
// a function of the shapes alone (so the sum's order never changes).
__host__ inline void dw_split(int M, int K, int D, int* slabs, int* slab_len) {
  const int tiles = ((K + kGM - 1) / kGM) * ((D + kGN - 1) / kGN);
  int s = (kTargetBlocks + tiles - 1) / tiles;
  const int most = (M + 255) / 256;
  if (s > most) s = most;
  if (s < 1) s = 1;
  int len = (M + s - 1) / s;
  len = (len + kBK - 1) / kBK * kBK;
  *slab_len = len;
  *slabs = (M + len - 1) / len;
}

// dW [K, D] f32 = x^T dh: a(m = column of x, k = row) = x[row * K + m].
template <typename T>
cudaError_t launch_dw(const void* x, const void* dh, void* dw, void* partials, int M, int K,
                      int D, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  int slabs, slab_len;
  dw_split(M, K, D, &slabs, &slab_len);
  const int bytes = gemm_smem_bytes(sizeof(T), kBf16);
  auto kernel = gemm_tile_kernel<T, true, false, float>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  float* target = static_cast<float*>(slabs > 1 ? partials : dw);
  const dim3 grid((D + kGN - 1) / kGN, (K + kGM - 1) / kGM, slabs);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(x),
                                            static_cast<const T*>(dh), target, K, D, M,
                                            static_cast<size_t>(K), static_cast<size_t>(D),
                                            slab_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return err;
  return sum_rows(target, static_cast<float*>(dw), slabs, K * D, stream);
}

// dx [M, K] in x's type = dh W^T: b(k = column of dh, n = row of W) = W[n * D + k],
// W already in x's type.
template <typename T>
cudaError_t launch_dx(const void* dh, const void* w, void* dx, int M, int K, int D,
                      cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int bytes = gemm_smem_bytes(sizeof(T), kBf16);
  auto kernel = gemm_tile_kernel<T, false, true, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((K + kGN - 1) / kGN, (M + kGM - 1) / kGM, 1);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(dh),
                                            static_cast<const T*>(w), static_cast<T*>(dx), M,
                                            K, D, static_cast<size_t>(D),
                                            static_cast<size_t>(D), D);
  return cudaGetLastError();
}

}  // namespace fe
}  // namespace advmil

// Shape limits of every entry point (checked by the Python wrapper): M % 16
// == 0, M > 0, K % 32 == 0, D % 32 == 0, 32 <= D <= 384; x, dh, dx and w (W
// rounded to x's type by the caller) in one dtype (f32 or bf16), their bases
// aligned to 16 bytes; the forward and bwd_dh take w as [K, D] in f32 and
// transposed, [D, K], in bf16; dx takes [K, D] in both; b, scale, bias, g and every gradient of a parameter in
// f32. Each returns cudaGetLastError() after its last launch.

// x [M, K], w (see above), b / scale / bias [D] -> out [M / 16, D] in x's dtype.
extern "C" int advmil_fused_embed_fwd(const void* x, const void* w, const void* b,
                                      const void* scale, const void* bias, void* out, int M,
                                      int K, int D, int dtype, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32)
    return advmil::fe::launch_rows<float, false>(x, w, b, scale, bias, nullptr, out, nullptr,
                                                 M, K, D, eps, s);
  if (dtype == advmil::kBF16)
    return advmil::fe::launch_rows<__nv_bfloat16, false>(x, w, b, scale, bias, nullptr, out,
                                                         nullptr, M, K, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the row kernel for M rows: the backward's partials hold
// blocks * 3 * D floats.
extern "C" int advmil_fused_embed_row_blocks(int M) {
  return (M + advmil::fe::kRowsBM - 1) / advmil::fe::kRowsBM;
}

// g [M / 16, D] f32 and the forward's inputs -> dh [M, D] in x's dtype and
// sums [3, D] f32 = (db, dscale, dbias); partials: scratch (see above).
extern "C" int advmil_fused_embed_bwd_dh(const void* g, const void* x, const void* w,
                                         const void* b, const void* scale, const void* bias,
                                         void* dh, void* partials, void* sums, int M, int K,
                                         int D, int dtype, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == advmil::kF32)
    err = advmil::fe::launch_rows<float, true>(x, w, b, scale, bias, g, dh, partials, M, K, D,
                                               eps, s);
  else if (dtype == advmil::kBF16)
    err = advmil::fe::launch_rows<__nv_bfloat16, true>(x, w, b, scale, bias, g, dh, partials,
                                                       M, K, D, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return err;
  return advmil::fe::sum_rows(static_cast<const float*>(partials), static_cast<float*>(sums),
                              advmil_fused_embed_row_blocks(M), 3 * D, s);
}

// Slabs of the dW product for these shapes: its partials hold slabs * K * D
// floats (unused when it is 1).
extern "C" int advmil_fused_embed_dw_slabs(int M, int K, int D) {
  int slabs, slab_len;
  advmil::fe::dw_split(M, K, D, &slabs, &slab_len);
  return slabs;
}

// x [M, K], dh [M, D] (one dtype) -> dw [K, D] f32.
extern "C" int advmil_fused_embed_dw(const void* x, const void* dh, void* dw, void* partials,
                                     int M, int K, int D, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32)
    return advmil::fe::launch_dw<float>(x, dh, dw, partials, M, K, D, s);
  if (dtype == advmil::kBF16)
    return advmil::fe::launch_dw<__nv_bfloat16>(x, dh, dw, partials, M, K, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dh [M, D], w [K, D] (both x's dtype) -> dx [M, K] in x's dtype.
extern "C" int advmil_fused_embed_dx(const void* dh, const void* w, void* dx, int M, int K,
                                     int D, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == advmil::kF32) return advmil::fe::launch_dx<float>(dh, w, dx, M, K, D, s);
  if (dtype == advmil::kBF16)
    return advmil::fe::launch_dx<__nv_bfloat16>(dh, w, dx, M, K, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
