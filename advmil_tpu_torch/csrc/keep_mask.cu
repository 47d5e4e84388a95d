// Materialised attention-dropout keep mask, the tests' oracle.
//
// Replaces the Pallas TPU kernel advmil_tpu/ops/attention.py:_keep_mask_kernel
// (wrapper dropout_keep_mask_oracle): out[bh, i, j] = 1.0 where element
// (bh, i, j) of the Philox stream of philox.cuh is kept, else 0.0. The flash
// kernels never read it; it exists so that the dropout paths can be held
// against a materialising reference bit for bit.
//
// What bounds it on the card: the f32 writes (4 bytes per element) and the
// Philox rounds (one 4x32 block per 4 elements). Design: one thread per 4
// consecutive columns of a row, i.e. per Philox counter, so no random word is
// computed twice; a grid-stride loop over the [BH * Lq * ceil(Lk/4)] groups.
#include "common.cuh"
#include "philox.cuh"

namespace advmil {

__global__ void keep_mask_kernel(float* __restrict__ out, int BH, int Lq, int Lk,
                                 DropoutArgs d) {
  const int groups = (Lk + 3) >> 2;
  const long long total = static_cast<long long>(BH) * Lq * groups;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       g < total; g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int cg = static_cast<int>(g % groups);
    const long long rowid = g / groups;  // bh * Lq + row
    const int row = static_cast<int>(rowid % Lq);
    const int bh = static_cast<int>(rowid / Lq);
    const Philox4 r = philox4x32_10(static_cast<uint32_t>(cg), static_cast<uint32_t>(row),
                                    static_cast<uint32_t>(bh), 0u, d.seed_lo, d.seed_hi);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    float* o = out + rowid * Lk + 4 * cg;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * cg + c < Lk) o[c] = w[c] >= d.threshold ? 1.f : 0.f;
  }
}

}  // namespace advmil

// out [BH, Lq, Lk] f32 (contiguous). seed = (seed_hi << 32) | seed_lo; keep
// when the element's bits >= threshold. Returns cudaGetLastError() after
// launch.
extern "C" int advmil_keep_mask(void* out, int BH, int Lq, int Lk, unsigned seed_lo,
                                unsigned seed_hi, unsigned threshold, void* stream) {
  const long long groups = static_cast<long long>(BH) * Lq * ((Lk + 3) / 4);
  const int threads = 256;
  const long long want = (groups + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  advmil::DropoutArgs d{seed_lo, seed_hi, threshold, 1.f};
  advmil::keep_mask_kernel<<<blocks > 0 ? blocks : 1, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), BH, Lq, Lk, d);
  return static_cast<int>(cudaGetLastError());
}
