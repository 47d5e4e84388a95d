// dx = dh W^T of the fused region patch embedding, bf16 on wgmma.
//
// The bf16 instantiation of the port of the Pallas TPU kernel
// advmil_tpu/ops/fused_embed.py:_bwd_dx_kernel; fused_embed.cu holds the f32
// one (plain FMAs), the C entry point and the shape limits. dh [M, D] and W
// [K, D] (already rounded to bf16) are bf16, the sum over D runs in f32, dx
// [M, K] is rounded once to bf16. No library GEMM is called.
//
// What bounds it on the card (M = 32,768, K = 1,024, D = 384): 25.8 GFLOP
// over 92 MB of device memory, 280 flop / byte, right at the H100's ridge
// (295): 0.028 ms by bytes, 0.026 ms by operations. So neither mma.sync
// (about 60% of wgmma's rate) nor a second pass over the output is
// affordable. And one level down, the operand bytes that cross from L2 to
// shared memory (measured as the limit of the flash forward's large grids):
//   128 x 128 output tiles: dh crosses K / 128 = 8 times, W M / 128 = 256
//     times: 201 + 201 = 402 MB for a 92 MB product;
//   128 x 256 tiles: dh 4 times, W 256 times: 101 + 201 = 302 MB;
//   a resident 128-row dh panel, W streamed: dh once, W 256 times:
//     25 + 201 = 226 MB.
// The last is taken: D <= 384, so the panel is at most 96 KB. The blocks of
// a cluster share each W tile: every block loads 1 / kDxCluster of the tile's
// rows and the TMA unit multicasts them to all, which divides W's 201 MB by
// kDxCluster.
//
// Design: one block per 128 rows of dh, two consumer warpgroups and one
// producer warp; kDxCluster blocks form a cluster. The producer's elected
// lane loads the panel as ceil(D / 64) TMA boxes of 128 x 64, each onto its
// own mbarrier (the first products start when the first box has landed), and
// streams W in tiles of 128 rows x 64 through a ring of kDxStages stages
// (full / empty mbarriers), output tile after output tile. A stage's full
// barrier expects the whole tile (its own rows and the other blocks'); its
// empty barrier counts the consuming warps of every block of the cluster,
// which arrive on it across blocks, since a producer writes into all of them.
// The cluster meets once after the barriers' setup and once before any block
// leaves (its barriers still take arrivals).
//
// The warpgroups take the 128 x 128 output tiles in turns (ping-pong): one
// computes a whole tile, two wgmma m64n128k16 per k-step for the panel's two
// 64-row halves against the same W tile, both operands from shared memory
// (descriptors advance 32 bytes per k-step), one chunk's group in flight
// while the previous one's stage is released; meanwhile the other rounds,
// transposes and stores the tile before. So the tensor cores have work during
// every epilogue and the stores drain under the products. The turns are kept
// by two more mbarriers: a warpgroup starts a tile's products when the other
// has put the last of the tile before in flight. (That also keeps a warpgroup from
// waiting for round r of a stage whose round r - 1, the other warpgroup's,
// has not landed: the parity of such a wait would already read as complete.)
//
// The tensor maps are made on the host for each call by libcuda's
// cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda on the link
// line). TMA was taken over cp.async writing the swizzle by hand:
// it zero-fills rows beyond M and K and columns beyond D (D = 32 or 96 is not
// a multiple of the 64-element row: the last box is half zeros, which are
// multiplied like the rest), and costs the consumers no instruction. The
// epilogue rounds the accumulators to bf16 in registers, transposes 4 x 4
// words within each quad so that a lane holds 8 neighbouring columns, and
// stores 16 bytes a lane, 64 contiguous bytes a row: no tile in shared
// memory. Rows beyond M and columns beyond K are not stored.
//
// The wgmmas must stand in control flow that the compiler can prove uniform:
// no branch around one, the warp's role read through a shuffle, the barrier
// waits as one asm block each. Otherwise ptxas serializes them (C7520,
// "Potential Performance Loss"): on an H100 at M = 32,768, K = 1,024, D = 384
// that cost the design this one replaced (each warpgroup 64 rows of one 128 x
// 256 tile) 0.065 ms against 0.057, and ping-pong, tried first with that
// fault, 0.098 against the 0.051 it takes now (torch.matmul 0.052).
// scripts/profile_fused_embed.py --dx prints such warnings and times the
// kernel without its stores, its products or its loads, at other ring depths
// and cluster sizes (kDxStages 4 loses 9%, 8 gains nothing; no cluster loses
// 1-4%, one of 4 loses 25-33%).
#include "wgmma.cuh"

namespace advmil {
namespace fe {

constexpr int kDxBM = 128;          // rows of dh per block
constexpr int kDxBN = 128;          // columns of dx per output tile (rows of a W tile)
constexpr int kDxStages = 6;        // ring of W tiles
constexpr int kDxCluster = 2;       // blocks that share a W tile (a power of two, <= 8)
constexpr int kDxBoxRows = kDxBN / kDxCluster;  // rows of W a block loads for all
constexpr int kDxMaxChunks = 6;     // D <= 384
constexpr int kDxConsumerWarps = 8;  // two warpgroups
constexpr int kDxThreads = 32 * (kDxConsumerWarps + 1);  // and the producer warp
constexpr int kDxABytes = kDxBM * wg::kRowBytes;  // a 128 x 64 box of dh: 16 KB
constexpr int kDxBBytes = kDxBN * wg::kRowBytes;  // a 128 x 64 tile of W: 16 KB

inline int dx_smem_bytes(int D) {
  const int chunks = (D + wg::kChunk - 1) / wg::kChunk;
  // alignment slack + the panel + the ring + the barriers
  return wg::kTileAlign + chunks * kDxABytes + kDxStages * kDxBBytes +
         8 * (kDxMaxChunks + 2 * kDxStages + 2);
}

// One 64 x 128 accumulator fragment to dx: rows row_g and row_g + 8, columns
// col0 .. col0 + 127 (see wgmma.cuh for the fragment and the transpose).
__device__ __forceinline__ void store_fragment(const float (&acc)[64], __nv_bfloat16* dx, int M,
                                               int K, int row_g, int col0, int t) {
#pragma unroll
  for (int jj = 0; jj < kDxBN / 32; ++jj) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = wg::pack_bf16x2(acc[4 * (4 * jj + i) + 2 * half],
                               acc[4 * (4 * jj + i) + 2 * half + 1]);
      wg::quad_transpose(a, t);  // lane t now holds the 8 columns of n8 tile 4 jj + t
      const int row = row_g + 8 * half;
      const int col = col0 + 8 * (4 * jj + t);
      if (row < M && col < K)
        *reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * K + col) =
            make_uint4(a[0], a[1], a[2], a[3]);
    }
  }
}

__global__ void __cluster_dims__(kDxCluster, 1, 1) __launch_bounds__(kDxThreads, 1)
dx_wgmma_kernel(const __grid_constant__ CUtensorMap map_dh,
                const __grid_constant__ CUtensorMap map_w, __nv_bfloat16* __restrict__ dx, int M,
                int K, int D) {
  extern __shared__ unsigned char smem_raw[];
  const int chunks = (D + wg::kChunk - 1) / wg::kChunk;
  const int tiles = (K + kDxBN - 1) / kDxBN;
  const uint32_t sA = (wg::smem_addr(smem_raw) + wg::kTileAlign - 1) & ~(wg::kTileAlign - 1u);
  const uint32_t sB = sA + chunks * kDxABytes;          // [stages][128 rows][128 bytes]
  const uint32_t bar_panel = sB + kDxStages * kDxBBytes;  // [chunks]
  const uint32_t bar_full = bar_panel + 8 * kDxMaxChunks;  // [stages]
  const uint32_t bar_empty = bar_full + 8 * kDxStages;     // [stages]
  const uint32_t bar_turn = bar_empty + 8 * kDxStages;     // [2]: warpgroup w may start a tile
  // the warp index through a shuffle, so that the compiler knows the role
  // branches below as warp-uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kDxBM;  // may lie beyond M in a cluster's last blocks: all zeros
  const uint32_t rank = wg::cluster_rank();

  if (threadIdx.x == 0) {
    for (int kc = 0; kc < chunks; ++kc) wg::mbar_init(bar_panel + 8 * kc, 1);
    for (int s = 0; s < kDxStages; ++s) {
      wg::mbar_init(bar_full + 8 * s, 1);
      wg::mbar_init(bar_empty + 8 * s, 4 * kDxCluster);  // the warps of one warpgroup per block
    }
    wg::mbar_init(bar_turn, 4);
    wg::mbar_init(bar_turn + 8, 4);
    wg::mbar_init_fence();
  }
  wg::cluster_sync();
  // From here to the last line producers and consumers meet only at the mbarriers.

  if (warp == kDxConsumerWarps) {
    if (lane == 0) {
      int it = 0;
      for (int nt = 0; nt < tiles; ++nt) {
        for (int kc = 0; kc < chunks; ++kc, ++it) {
          if (nt == 0) {  // the panel's box goes ahead of the first W tile that meets it
            wg::mbar_arrive_expect_tx(bar_panel + 8 * kc, kDxABytes);
            wg::tma_load_2d(sA + kc * kDxABytes, &map_dh, kc * wg::kChunk, m0,
                            bar_panel + 8 * kc);
          }
          const int st = it % kDxStages;
          // every block's consumers have released this stage's previous tile
          // (at once for the first round)
          wg::mbar_wait(bar_empty + 8 * st, ((it / kDxStages) & 1) ^ 1);
          wg::mbar_arrive_expect_tx(bar_full + 8 * st, kDxBBytes);
          wg::tma_load_2d_multicast(
              sB + st * kDxBBytes + rank * kDxBoxRows * wg::kRowBytes, &map_w, kc * wg::kChunk,
              nt * kDxBN + rank * kDxBoxRows, bar_full + 8 * st,
              static_cast<uint16_t>((1u << kDxCluster) - 1u));
        }
      }
    }
    wg::cluster_sync();
    return;
  }

  const int wgi = warp >> 2;  // consumer warpgroup: output tiles wgi, wgi + 2, ...
  const int g = lane >> 2, t = lane & 3;
  const int row_g = m0 + 16 * (warp & 3) + g;  // the row of d[4 j], d[4 j + 1] in the upper half
  float acc0[64], acc1[64];                    // rows 0 .. 63 and 64 .. 127 of the panel
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;

  for (int nt = wgi; nt < tiles; nt += 2) {
    // my turn: the other warpgroup has tile nt - 1 in flight (its (nt - 1) / 2-th)
    if (nt > 0) wg::mbar_wait(bar_turn + 8 * wgi, ((nt - 1) >> 1) & 1);
    int prev = 0;
    for (int kc = 0; kc < chunks; ++kc) {
      const int it = nt * chunks + kc;
      const int st = it % kDxStages;
      wg::mbar_wait(bar_panel + 8 * kc, 0);  // passes at once after the first tile
      wg::mbar_wait(bar_full + 8 * st, (it / kDxStages) & 1);
      const uint64_t da = wg::operand_desc(sA + kc * kDxABytes);
      const uint64_t db = wg::operand_desc(sB + st * kDxBBytes);
      wg::wgmma_fence();
#pragma unroll
      for (int s = 0; s < wg::kChunk / 16; ++s) {  // a half-empty last box multiplies its zeros
        wg::wgmma<0, 0>(acc0, da + 2 * s, db + 2 * s, (kc | s) != 0);
        wg::wgmma<0, 0>(acc1, da + 2 * s + (64 * wg::kRowBytes >> 4), db + 2 * s, (kc | s) != 0);
      }
      wg::wgmma_commit();
      if (kc > 0) {  // the previous chunk's products are done: its stage is free
        wg::wgmma_wait<1>();
        if (lane < kDxCluster) wg::mbar_arrive_cluster(bar_empty + 8 * prev, lane);
      }
      prev = st;
    }
    if (lane == 0) wg::mbar_arrive(bar_turn + 8 * (wgi ^ 1));  // the other's turn
    wg::wgmma_wait<0>();
    if (lane < kDxCluster) wg::mbar_arrive_cluster(bar_empty + 8 * prev, lane);
    wg::acc_fence(acc0);
    wg::acc_fence(acc1);
    store_fragment(acc0, dx, M, K, row_g, nt * kDxBN, t);
    store_fragment(acc1, dx, M, K, row_g + 64, nt * kDxBN, t);
  }
  wg::cluster_sync();
}

// dh [M, D], w [K, D], dx [M, K], all bf16 and contiguous, bases aligned to
// 16 bytes, D <= 384 and K multiples of 32 (fused_embed.cu states the limits).
cudaError_t dx_wgmma(const void* dh, const void* w, void* dx, int M, int K, int D,
                     cudaStream_t stream) {
  if (D > kDxMaxChunks * wg::kChunk) return cudaErrorInvalidValue;
  wg::EncodeTiledFn encode = nullptr;
  cudaError_t err = wg::encode_tiled_fn(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap map_dh, map_w;
  err = wg::make_map_bf16(encode, &map_dh, dh, M, D, kDxBM);
  if (err != cudaSuccess) return err;
  err = wg::make_map_bf16(encode, &map_w, w, K, D, kDxBoxRows);
  if (err != cudaSuccess) return err;
  const int bytes = dx_smem_bytes(D);
  err = cudaFuncSetAttribute(dx_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (M + kDxBM - 1) / kDxBM;
  const int grid = (blocks + kDxCluster - 1) / kDxCluster * kDxCluster;  // whole clusters
  dx_wgmma_kernel<<<grid, kDxThreads, bytes, stream>>>(
      map_dh, map_w, static_cast<__nv_bfloat16*>(dx), M, K, D);
  return cudaGetLastError();
}

}  // namespace fe
}  // namespace advmil
