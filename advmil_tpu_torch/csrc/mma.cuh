// Building blocks of the tensor-core flash attention kernels
// (flash_fwd_mma.cu, flash_dkv_mma.cu): cp.async tile loads, ldmatrix,
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), and the attention-dropout keep
// bits laid out for an accumulator fragment.
//
// Fragment layout of mma.m16n8k16, with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//                           a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9];
//   B (16 x 8):             b0 = B[2t, 2t+1][g],  b1 = B[2t+8, 2t+9][g];
//   C (16 x 8, f32):        c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
// Two neighbouring n8 accumulator tiles, rounded to bf16, are therefore the A
// operand of a following product over those 16 columns: the probabilities
// never pass through shared memory.
//
// Tiles are 64 rows of DH bf16 values in shared memory, rows DH + 8 elements
// apart: the pitch is an odd number of 16-byte units for every DH that is a
// multiple of 16, so the 8 row addresses of an ldmatrix fall on 8 different
// bank groups.
#pragma once

#include "common.cuh"
#include "philox.cuh"

namespace advmil {

constexpr int kTile = 64;          // rows of a tile in the cp.async ring
constexpr int kMmaStages = 3;      // cp.async ring depth
// A forward or dQ block has 4 or 8 warps, each owning 16 query rows. 8 warps halve
// the times the K and V tiles cross from L2 to shared memory, which is what
// bounds a large grid; 4 warps give a small grid twice the blocks to spread.
// The launcher takes 8 warps once the 4-warp grid has this many blocks per SM.
constexpr int kWideMinBlocksPerSm = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedScore = -1e30f;
constexpr int kMaxKeys = 1 << 19;  // the forward keeps one int per key tile in shared memory

template <int DH>
__host__ __device__ constexpr int tile_pitch() { return DH + 8; }
template <int DH, int ROWS = kTile>
__host__ __device__ constexpr int tile_elems() { return ROWS * tile_pitch<DH>(); }

// Whether a grid of `blocks` 4-warp blocks should run as half as many 8-warp
// blocks on the current device, whose SM count is asked for once.
inline cudaError_t use_wide_blocks(long blocks, bool* wide) {
  int sms = 0;
  const cudaError_t err = device_sm_count(&sms);
  if (err != cudaSuccess) return err;
  *wide = blocks >= static_cast<long>(kWideMinBlocksPerSm) * sms;
  return cudaSuccess;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from device memory to shared memory without passing
// registers; with ok false nothing is read and the bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  const int bytes = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool ok) {
  const int bytes = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of rows r0 .. r0 + ROWS - 1 of a [L, H, DH] sequence (one
// head: `base` points at row 0, rows `row_stride` elements apart) into a tile,
// by a block of THREADS threads; rows beyond L are zero-filled.
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* tile,
                                                const __nv_bfloat16* base,
                                                size_t row_stride, int r0, int L, int tid) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < ROWS * kChunks; idx += THREADS) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = r0 + r < L;
    const __nv_bfloat16* src = ok ? base + static_cast<size_t>(r0 + r) * row_stride + c * 8 : base;
    cp_async_16(tile + r * tile_pitch<DH>() + c * 8, src, ok);
  }
}

// Which key tiles of 64 hold a real key: warp by warp the flags (1: a real
// key, 2: 64 of them) go into `list` (one int per key tile, shared memory),
// then warp 0 compacts them in place into the tiles to visit, in order, as
// entries 2 * tile + (all 64 keys real). Returns their number through `count`
// (one int of shared memory). Every thread of a block of NW warps calls it.
template <int NW>
__device__ __forceinline__ int active_key_tiles(const float* __restrict__ mb, int Lk, int* list,
                                                int* count, int warp, int lane) {
  const int key_tiles = (Lk + kTile - 1) / kTile;
#pragma unroll 4  // independent loads: let them overlap
  for (int tt = warp; tt < key_tiles; tt += NW) {
    const int c0 = tt * kTile + lane, c1 = c0 + 32;
    const bool v0 = c0 < Lk && mb[c0] > 0.f;
    const bool v1 = c1 < Lk && mb[c1] > 0.f;
    const unsigned any = __ballot_sync(0xffffffffu, v0 || v1);
    const unsigned all = __ballot_sync(0xffffffffu, v0 && v1);
    if (lane == 0) list[tt] = any ? (all == 0xffffffffu ? 2 : 1) : 0;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < key_tiles; base += 32) {
      const int tt = base + lane;
      const int flag = tt < key_tiles ? list[tt] : 0;
      __syncwarp();
      const unsigned act = __ballot_sync(0xffffffffu, flag != 0);
      if (flag) list[n + __popc(act & ((1u << lane) - 1u))] = 2 * tt + (flag == 2 ? 1 : 0);
      n += __popc(act);
      __syncwarp();
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// Four 8 x 8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and register i of lane (g, t) receives M_i[g][2t, 2t+1], or with
// trans M_i[2t, 2t+1][g].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b for one m16n8k16 step.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special function unit (ex2.approx: 2 ulp; a large negative x
// gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand over the 16 columns of two neighbouring accumulator tiles.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Address of this lane's row for ldmatrix_x4 over a 16 x 16 block of a tile
// whose rows are the MMA's M or K index and whose columns are contiguous:
// registers 0..3 = (rows 0-7, cols 0-7), (rows 8-15, cols 0-7), (rows 0-7,
// cols 8-15), (rows 8-15, cols 8-15). This is the A operand of a row-major
// tile, and with trans the B operands (b0, b1) of two neighbouring n8 tiles
// from a [k][n] tile.
template <int DH>
__device__ __forceinline__ const __nv_bfloat16* frag_addr_rows(const __nv_bfloat16* tile,
                                                               int row0, int col0, int lane) {
  return tile + (row0 + (lane & 15)) * tile_pitch<DH>() + col0 + (lane >> 4) * 8;
}

// The same for the B operands of two neighbouring n8 tiles from a [n][k] tile
// (scores: rows are keys, columns the head dim): registers 0..3 = (n 0-7,
// k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15).
template <int DH>
__device__ __forceinline__ const __nv_bfloat16* frag_addr_nk(const __nv_bfloat16* tile, int n0,
                                                             int k0, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * tile_pitch<DH>() + k0 +
         ((lane >> 3) & 1) * 8;
}

// Keep bits of an accumulator tile whose rows are queries and whose columns
// are keys (the forward): bit e is set when element c[e] is kept. row_g is the
// query of c0 / c1 (c2 / c3 are 8 rows below), col8 the key of the tile's
// column 0 (a multiple of 8). The thread's two keys 2t, 2t + 1 are words
// 2 (t % 2), + 1 of one Philox block, and its lane neighbour (t ^ 1) needs the
// other two words of the same blocks: the even lane computes the block of row
// g, the odd lane that of row g + 8, and they swap halves. One Philox block
// per four elements.
__device__ __forceinline__ uint32_t keep_bits_qk(const DropoutArgs& d, int bh, int row_g,
                                                 int col8, int lane) {
  const int t = lane & 3;
  const bool odd = t & 1;
  const Philox4 r = philox4x32_10(static_cast<uint32_t>(col8 + 2 * t) >> 2,
                                  static_cast<uint32_t>(row_g + (odd ? 8 : 0)),
                                  static_cast<uint32_t>(bh), 0u, d.seed_lo, d.seed_hi);
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 1);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 1);
  const uint32_t w0 = odd ? got0 : r.x, w1 = odd ? got1 : r.y;  // row g
  const uint32_t w2 = odd ? r.z : got0, w3 = odd ? r.w : got1;  // row g + 8
  return (w0 >= d.threshold ? 1u : 0u) | (w1 >= d.threshold ? 2u : 0u) |
         (w2 >= d.threshold ? 4u : 0u) | (w3 >= d.threshold ? 8u : 0u);
}

// Keep bits of a transposed accumulator tile (dK/dV): rows are keys, columns
// queries. key16 is the key of the warp's row 0 (a multiple of 16), q8 the
// query of the tile's column 0. The four lanes with the same t and the same
// g / 4 hold keys 4a .. 4a + 3, the four words of one Philox block, for each
// of the four (query, key half) pairs of c0..c3: lane i = g % 4 computes the
// block of pair i, and a 4 x 4 transpose over two shuffle rounds hands every
// lane word i of all four blocks. One Philox block per four elements.
__device__ __forceinline__ uint32_t keep_bits_kq(const DropoutArgs& d, int bh, int key16, int q8,
                                                 int lane) {
  const int g = lane >> 2, t = lane & 3, i = g & 3;
  const bool o1 = i & 1, o2 = i & 2;
  const int query = q8 + 2 * t + (o1 ? 1 : 0);
  const int key = key16 + (g & ~3) + (o2 ? 8 : 0);
  const Philox4 r = philox4x32_10(static_cast<uint32_t>(key) >> 2, static_cast<uint32_t>(query),
                                  static_cast<uint32_t>(bh), 0u, d.seed_lo, d.seed_hi);
  // round 1, partner i ^ 1: keep the words of my parity, send the others
  const uint32_t k0 = o1 ? r.y : r.x, k1 = o1 ? r.w : r.z;
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, o1 ? r.x : r.y, 4);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, o1 ? r.z : r.w, 4);
  // now (k0, k1) = words (i & 1, (i & 1) + 2) of block i, (r0, r1) of block i ^ 1
  // round 2, partner i ^ 2: keep word i, send word i ^ 2
  const uint32_t mine_a = o2 ? k1 : k0, mine_b = o2 ? r1 : r0;  // blocks i, i ^ 1
  const uint32_t got_a = __shfl_xor_sync(0xffffffffu, o2 ? k0 : k1, 8);  // block i ^ 2
  const uint32_t got_b = __shfl_xor_sync(0xffffffffu, o2 ? r0 : r1, 8);  // block i ^ 3
  return ((mine_a >= d.threshold ? 1u : 0u) << i) |
         ((mine_b >= d.threshold ? 1u : 0u) << (i ^ 1)) |
         ((got_a >= d.threshold ? 1u : 0u) << (i ^ 2)) |
         ((got_b >= d.threshold ? 1u : 0u) << (i ^ 3));
}

}  // namespace advmil
