// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11) and the attention-dropout keep decision built on it.
//
// Replaces the TPU core PRNG of advmil_tpu/ops/attention.py:_dropout_keep,
// whose bits cannot be reproduced off the TPU. The port's stream is defined
// per element, never per tile: the element (bh, row, col) of a [BH, Lq, Lk]
// attention map takes word col % 4 of
//   philox4x32_10(counter = (col / 4, row, bh, 0), key = (seed_lo, seed_hi)),
// and is kept when that word >= threshold = min(floor(p * 2^32), 2^32 - 1)
// (the TPU kernel's rule, attention.py:77). So the flash forward, both
// backward kernels, the keep-mask kernel and the plain torch version
// (ops/philox.py) see the same bits whatever their tile shapes.
#pragma once

#include <cstdint>

namespace advmil {

struct Philox4 {
  uint32_t x, y, z, w;
};

__host__ __device__ __forceinline__ uint32_t mulhi32(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
#endif
}

// Counter (c0..c3), key (k0, k1): ten rounds, the key bumped between rounds,
// as Random123's philox4x32_R(10, ...) and cuRAND's curand_Philox4x32_10.
__host__ __device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                         uint32_t c2, uint32_t c3,
                                                         uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = mulhi32(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = mulhi32(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return {c0, c1, c2, c3};
}

// The 32 random bits of attention element (bh, row, col).
__device__ __forceinline__ uint32_t dropout_bits(uint32_t seed_lo, uint32_t seed_hi,
                                                 int bh, int row, int col) {
  const Philox4 r = philox4x32_10(static_cast<uint32_t>(col) >> 2,
                                  static_cast<uint32_t>(row),
                                  static_cast<uint32_t>(bh), 0u, seed_lo, seed_hi);
  switch (col & 3) {
    case 0: return r.x;
    case 1: return r.y;
    case 2: return r.z;
    default: return r.w;
  }
}

// Dropout parameters passed by value to the attention kernels.
struct DropoutArgs {
  uint32_t seed_lo, seed_hi;
  uint32_t threshold;  // keep when bits >= threshold
  float inv_keep;      // 1 / (1 - p), applied to kept probabilities
};

__device__ __forceinline__ bool dropout_keep(const DropoutArgs& d, int bh, int row,
                                             int col) {
  return dropout_bits(d.seed_lo, d.seed_hi, bh, row, col) >= d.threshold;
}

}  // namespace advmil
