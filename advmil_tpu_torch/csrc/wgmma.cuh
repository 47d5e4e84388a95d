// Building blocks of the Hopper warpgroup products of the fused embedding
// (fused_embed_dx.cu, fused_embed_rows.cu, fused_embed_dw.cu): TMA tile loads
// into the 128-byte-swizzled layout, for one block or multicast to the blocks
// of a cluster, mbarriers, the shared-memory matrix descriptors of K-major and
// MN-major operands, wgmma.mma_async m64nNk16 (bf16 in, f32 in registers) and
// its fences, and the way from an accumulator fragment to 16-byte stores.
//
// Layout of an operand tile in shared memory, as a TMA box of 64-element rows
// writes it: rows of 64 bf16 = 128 bytes, row r at byte 128 r of a tile
// whose base is a multiple of 1024; within a row the eight 16-byte units sit
// at unit ^ (r % 8). That is what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
// writes and what a descriptor with layout type 1 reads; 8 rows (1024 bytes)
// are one period of the pattern, so a tile may start at any multiple of 8
// rows.
// - K-major operand (the reduction index contiguous, as dh [M, D] and W
//   [K, D] are for dx = dh W^T, or x [M, K] and W^T [D, K] for h = x W): a
//   row is one row of the operand, 64 reduction elements; a k-step of 16
//   elements moves the descriptor's start by 32 bytes.
// - MN-major operand (the row index of the product contiguous, as x [M, K]
//   and dh [M, D] are for dW = x^T dh, whose reduction index is M): a row is
//   one reduction index, 64 neighbouring output rows (or columns); a k-step
//   of 16 reduction rows moves the start by 2,048 bytes, and 64-wide blocks
//   of the operand's other index lie `lbo` bytes apart.
//
// Accumulator fragment of m64nNk16 (f32), thread = warp w of the warpgroup,
// lane = 4 g + t: d[4 j], d[4 j + 1] = C[16 w + g][8 j + 2 t, + 1] and
// d[4 j + 2], d[4 j + 3] the same columns 8 rows below: the mma.sync
// m16n8k16 fragment (mma.cuh), tiled over j.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked

#include "common.cuh"

namespace advmil {
namespace wg {

constexpr int kChunk = 64;         // reduction elements of a tile row (128 bytes)
constexpr int kRowBytes = 128;
constexpr int kTileAlign = 1024;   // 8 rows: the swizzle pattern's period

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers (8 bytes of shared memory each, addressed as shared::cta) ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}
// After the inits, before any thread or TMA unit uses a barrier (follow it
// with a block barrier).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// The same arrival on the barrier at the same place in block `cta` of this
// block's cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar), "r"(cta)
      : "memory");
}
// Wait until the phase of parity `parity` is complete (a new barrier counts
// as having completed the phase of parity 1). The polling loop lies inside
// one asm block: a C++ loop with a per-thread exit reads as divergence to the
// compiler, which then serializes every wgmma.mma_async that follows (ptxas
// C7520). A wait that outlasts 2^26 polls traps: a fault in the protocol then
// shows as a launch error, not as a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 polls;\n"
      "mov.u32 polls, 0;\n"
      "MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra MBAR_DONE;\n"
      "add.u32 polls, polls, 1;\n"
      "setp.gt.u32 p, polls, 0x4000000;\n"
      "@p trap;\n"
      "bra MBAR_WAIT;\n"
      "MBAR_DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---- clusters ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster: what was written before is
// visible after, and no block passes before all have arrived.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// ---- warp roles ----

// Move registers between the warpgroups of a block (every warp of a
// warpgroup executes it): a producer gives up what its consumers take. The
// 4 sub-partitions of an SM each hold 16,384 registers and one warp of each
// warpgroup. A block launches with 168 a thread for 384 threads, and the
// consumers take only what the producer gives up: 128 (168 - P) >= 256 (C -
// 168), as 40 + 232 + 232 or 24 + 240 + 240 (32 + 240 + 240 hung the card).
template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- TMA ----

// Start the copy of the box at (c0, c1) of a 2-d tensor map (c0 along the
// contiguous dimension) into shared memory at `dst`; the box's bytes, those
// zero-filled beyond the tensor's edge included, complete on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The same copy delivered to every block of the cluster whose bit is set in
// `cta_mask`, at `dst` and `bar` of each block's own shared memory.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                      int c1, uint32_t bar, uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "h"(cta_mask)
      : "memory");
}

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime so that
// the library links without -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled_fn(EncodeTiledFn* fn) {
  void* sym = nullptr;
  const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault);
  if (err != cudaSuccess) return err;
  if (sym == nullptr) return cudaErrorSymbolNotFound;
  *fn = reinterpret_cast<EncodeTiledFn>(sym);
  return cudaSuccess;
}

// The map of a row-major bf16 matrix [rows, cols] (cols contiguous, a
// multiple of 8; base aligned to 16 bytes) read in boxes of box_rows x 64
// elements into the 128-byte-swizzled layout; elements beyond either edge
// read as 0.
inline cudaError_t make_map_bf16(EncodeTiledFn encode, CUtensorMap* map, const void* base,
                                 int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {kChunk, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- wgmma ----

// Descriptor of a K-major operand tile in the layout above, starting at
// shared address `addr` (row 0 of the rows to multiply, plus 32 bytes per
// k-step): start >> 4 in bits 0-13, the leading offset (unused with a
// swizzle) 1 in bits 16-29, 1024 bytes between 8-row groups in bits 32-45,
// layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(kTileAlign >> 4) << 32) | (1ull << 62);
}

// Descriptor of an MN-major operand tile in the layout above: the leading
// offset is the distance between 64-wide blocks of the operand's M or N index
// (one TMA box each), the stride offset the 1024 bytes between groups of 8
// reduction rows, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t mn_operand_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16) |
         (static_cast<uint64_t>(kTileAlign >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define ADVMIL_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ADVMIL_D16(i) ADVMIL_D4(i), ADVMIL_D4(i + 4), ADVMIL_D4(i + 8), ADVMIL_D4(i + 12)

// d (64 x N, f32) = a (64 x 16) b^T (N x 16) + (accumulate ? d : 0), both
// operands bf16 from shared memory; N = 128, 192 or 256, chosen by the size of
// d (N / 2 accumulators a thread). TA / TB: 0 for a K-major operand
// (operand_desc), 1 for an MN-major one (mn_operand_desc). Asynchronous: fence
// before, commit and wait after.
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : ADVMIL_D16(0), ADVMIL_D16(16), ADVMIL_D16(32), ADVMIL_D16(48)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[96], uint64_t desc_a, uint64_t desc_b,
                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : ADVMIL_D16(0), ADVMIL_D16(16), ADVMIL_D16(32), ADVMIL_D16(48), ADVMIL_D16(64),
        ADVMIL_D16(80)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : ADVMIL_D16(0), ADVMIL_D16(16), ADVMIL_D16(32), ADVMIL_D16(48), ADVMIL_D16(64),
        ADVMIL_D16(80), ADVMIL_D16(96), ADVMIL_D16(112)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

#undef ADVMIL_D16
#undef ADVMIL_D4

// The compiler knows the accumulators as written where the wgmma was started,
// not where it completed: after the wait, pass them through here before the
// first read.
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- from a fragment to 16-byte stores ----

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a[i] of lane t (of a quad) holds columns 2 t, 2 t + 1 of n8 tile i, one
// row. Afterwards a[0..3] of lane t are the 8 columns of tile t in order: a
// 4 x 4 transpose over the quad in two shuffle rounds.
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int t) {
#pragma unroll
  for (int bit = 0; bit < 2; ++bit) {
    const bool up = (t >> bit) & 1;
#pragma unroll
    for (int lo = 0; lo < 4; ++lo) {
      if (lo & (1 << bit)) continue;
      const int hi = lo | (1 << bit);
      const uint32_t got = __shfl_xor_sync(0xffffffffu, up ? a[lo] : a[hi], 1 << bit);
      if (up) a[lo] = got; else a[hi] = got;
    }
  }
}

}  // namespace wg
}  // namespace advmil
