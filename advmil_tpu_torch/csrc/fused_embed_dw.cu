// dW = x^T dh of the fused region patch embedding, bf16 on wgmma.
//
// The bf16 instantiation of the second half of the port of the Pallas TPU
// kernel advmil_tpu/ops/fused_embed.py:_bwd_dparams_kernel (#11): the row
// kernel (fused_embed_rows.cu) writes dh [M, D] in bf16, and this kernel forms
// dW [K, D] = x^T dh in f32 from it; fused_embed.cu holds the f32 product
// (plain FMAs), the C entry point and the ordered sum of the slabs. No library
// GEMM is called.
//
// What bounds it on the card (M = 32,768, K = 1,024, D = 384): 25.8 GFLOP,
// 0.026 ms at 989 TFLOP/s, against x (64 MB) + dh (25 MB) + dW (1.5 MB), 0.027
// ms at 3.35 TB/s: both, about equally. With the row kernel's backward mode
// (the same product once more, and dh's 25 MB written) #11 is two such
// products.
//
// Design. The reduction index is M, the row index of both operands, so both
// are MN-major for the tensor cores: a TMA box of 64 rows of M x 64 columns
// lands in shared memory as 64 reduction rows of 128 bytes, which a
// descriptor of an MN-major operand (wgmma.cuh: mn_operand_desc) reads with
// the transpose immediates of wgmma set. No element is gathered and nothing is
// transposed through registers.
// A block computes a 128 x CT tile of dW (rows: columns of x; columns:
// columns of dh) over one slab of M: two consumer warpgroups of 64 rows each
// and one producer warp, whose elected lane streams the slab in 64-row
// chunks through a ring of stages (full / empty mbarriers); each stage holds
// two 64 x 64 boxes of x and CT / 64 of dh. CT = 192 at D = 384 (96
// accumulators a thread): x crosses from device memory twice (once per
// column tile), dh K / 128 = 8 times from L2, and 8 k-tiles x 2 column tiles x
// 8 slabs make 128 blocks, one wave on 132 SMs. The slabs write their own f32
// partial dW, which sum_rows adds in slab order (12.6 MB each way at 8 slabs):
// no atomics, the same bits every run. Rows beyond M and columns beyond K or D
// are TMA's zero fill; they add nothing and nothing is stored there.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; M = 32,768, K = 1,024, D = 384;
// scripts/profile_fused_embed.py --dparams): 0.060 ms with the slabs' sum,
// the product alone 0.045 (570 TFLOP/s); 2 stages 0.100. The wmma product
// with 11 slabs that it replaced: 0.18. The slabs' sum is what a cluster
// adding the partials through distributed shared memory could save; that is
// not built (PERF.md).
#include "wgmma.cuh"

namespace advmil {
namespace fe {

constexpr int kDwTileRows = 128;     // rows of dW per block: two warpgroups of 64
constexpr int kDwChunkRows = 64;     // rows of M per stage
constexpr int kDwMaxStages = 6;
constexpr int kDwConsumerWarps = 8;
constexpr int kDwThreads = 32 * (kDwConsumerWarps + 1);  // and the producer warp
constexpr int kDwTargetBlocks = 132;                      // one block per SM
constexpr int kDwSmemLimit = 232448;
constexpr int kDwBoxBytes = kDwChunkRows * wg::kRowBytes;  // a 64 x 64 box: 8 KB

// Columns of dW per block: 128 for D <= 128, else 192.
inline int dw_cols(int D) { return D <= 128 ? 128 : 192; }

inline int dw_stage_bytes(int ct) { return (2 + ct / 64) * kDwBoxBytes; }
inline int dw_stages(int ct) {
  const int s = (kDwSmemLimit - wg::kTileAlign - 16 * kDwMaxStages) / dw_stage_bytes(ct);
  return s < kDwMaxStages ? s : kDwMaxStages;
}

// Slabs the product is split into over M: enough blocks for one wave, a
// function of the shapes alone (so the order of the sum never changes).
void dw_wgmma_split(int M, int K, int D, int* slabs, int* slab_len) {
  const int ct = dw_cols(D);
  const int tiles = ((K + kDwTileRows - 1) / kDwTileRows) * ((D + ct - 1) / ct);
  int s = kDwTargetBlocks / tiles;
  const int most = (M + 255) / 256;  // at least 256 rows a slab
  if (s > most) s = most;
  if (s < 1) s = 1;
  int len = (M + s - 1) / s;
  len = (len + kDwChunkRows - 1) / kDwChunkRows * kDwChunkRows;
  *slab_len = len;
  *slabs = (M + len - 1) / len;
}

template <int CT>
__global__ void __launch_bounds__(kDwThreads, 1)
dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_dh, float* __restrict__ out, int M,
                int K, int D, int slab_len, int stages) {
  constexpr int kStageBytes = (2 + CT / 64) * kDwBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (wg::smem_addr(smem_raw) + wg::kTileAlign - 1) & ~(wg::kTileAlign - 1u);
  const uint32_t bar_full = base + stages * kStageBytes;
  const uint32_t bar_empty = bar_full + 8 * stages;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kDwTileRows, d0 = blockIdx.y * CT;
  const int mb = blockIdx.z * slab_len;
  const int me = min(M, mb + slab_len);
  const int chunks = (me - mb + kDwChunkRows - 1) / kDwChunkRows;
  out += static_cast<size_t>(blockIdx.z) * K * D;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(bar_full + 8 * s, 1);
      wg::mbar_init(bar_empty + 8 * s, kDwConsumerWarps);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kDwConsumerWarps) {
    if (lane == 0) {
      for (int c = 0; c < chunks; ++c) {
        const int st = c % stages, m = mb + c * kDwChunkRows;
        const uint32_t sx = base + st * kStageBytes;
        wg::mbar_wait(bar_empty + 8 * st, ((c / stages) & 1) ^ 1);
        wg::mbar_arrive_expect_tx(bar_full + 8 * st, kStageBytes);
        wg::tma_load_2d(sx, &map_x, k0, m, bar_full + 8 * st);
        wg::tma_load_2d(sx + kDwBoxBytes, &map_x, k0 + 64, m, bar_full + 8 * st);
#pragma unroll
        for (int i = 0; i < CT / 64; ++i)
          wg::tma_load_2d(sx + (2 + i) * kDwBoxBytes, &map_dh, d0 + 64 * i, m, bar_full + 8 * st);
      }
    }
    return;
  }

  const int wgi = warp >> 2, g8 = lane >> 2, t = lane & 3;
  float acc[CT / 2];
#pragma unroll
  for (int i = 0; i < CT / 2; ++i) acc[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int st = c % stages;
    wg::mbar_wait(bar_full + 8 * st, (c / stages) & 1);
    const uint32_t sx = base + st * kStageBytes;
    // A = x^T: the warpgroup's 64 columns of x (one box); B = dh: CT / 64 boxes
    const uint64_t da = wg::mn_operand_desc(sx + wgi * kDwBoxBytes, kDwBoxBytes);
    const uint64_t db = wg::mn_operand_desc(sx + 2 * kDwBoxBytes, kDwBoxBytes);
    wg::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kDwChunkRows / 16; ++s)  // 16 reduction rows: 2,048 bytes
      wg::wgmma<1, 1>(acc, da + 128 * s, db + 128 * s, (c | s) != 0);
    wg::wgmma_commit();
    if (c > 0) {  // the previous chunk's products are done: its stage is free
      wg::wgmma_wait<1>();
      if (lane == 0) wg::mbar_arrive(bar_empty + 8 * ((c - 1) % stages));
    }
  }
  wg::wgmma_wait<0>();
  wg::acc_fence(acc);

  const int row = k0 + 64 * wgi + 16 * (warp & 3) + g8;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= K) continue;
    float* dst = out + static_cast<size_t>(row + 8 * r) * D;
#pragma unroll
    for (int j = 0; j < CT / 8; ++j) {
      const int col = d0 + 8 * j + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int CT>
cudaError_t launch_dw_wgmma(const CUtensorMap& map_x, const CUtensorMap& map_dh, float* out,
                            int M, int K, int D, int slab_len, int slabs, cudaStream_t stream) {
  const int stages = dw_stages(CT);
  const int bytes = wg::kTileAlign + stages * dw_stage_bytes(CT) + 16 * stages;
  auto kernel = dw_wgmma_kernel<CT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((K + kDwTileRows - 1) / kDwTileRows, (D + CT - 1) / CT, slabs);
  kernel<<<grid, kDwThreads, bytes, stream>>>(map_x, map_dh, out, M, K, D, slab_len, stages);
  return cudaGetLastError();
}

// x [M, K], dh [M, D] bf16 -> out [slabs, K, D] f32, slab s the product over
// rows s * slab_len .. (dw_wgmma_split gives both).
cudaError_t dw_wgmma(const void* x, const void* dh, float* out, int M, int K, int D,
                     int slab_len, int slabs, cudaStream_t stream) {
  wg::EncodeTiledFn encode = nullptr;
  cudaError_t err = wg::encode_tiled_fn(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap map_x, map_dh;
  err = wg::make_map_bf16(encode, &map_x, x, M, K, kDwChunkRows);
  if (err != cudaSuccess) return err;
  err = wg::make_map_bf16(encode, &map_dh, dh, M, D, kDwChunkRows);
  if (err != cudaSuccess) return err;
  if (dw_cols(D) == 128)
    return launch_dw_wgmma<128>(map_x, map_dh, out, M, K, D, slab_len, slabs, stream);
  return launch_dw_wgmma<192>(map_x, map_dh, out, M, K, D, slab_len, slabs, stream);
}

}  // namespace fe
}  // namespace advmil
