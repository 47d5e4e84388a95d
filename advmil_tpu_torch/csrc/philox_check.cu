// Self-check of philox.cuh against the CUDA toolkit's own Philox4x32-10
// (curand_Philox4x32_10 of curand_philox4x32_x.h): for n (counter, key) pairs
// derived from the index, both write their four output words. chip_smoke.py
// compares the two buffers word for word. Not on any model path.
#include "common.cuh"
#include "philox.cuh"

#if __has_include(<curand_kernel.h>)
#include <curand_kernel.h>
#define ADVMIL_HAVE_CURAND 1
#else
#define ADVMIL_HAVE_CURAND 0
#endif

namespace advmil {

__device__ __forceinline__ void check_inputs(int i, uint4& c, uint2& k) {
  const uint32_t u = static_cast<uint32_t>(i);
  c = make_uint4(u, u * 2654435761u, ~u, u ^ 0xA5A5A5A5u);
  k = make_uint2(u * 40503u + 1u, 0xFFFFFFFFu - u);
}

__global__ void philox_check_kernel(unsigned* __restrict__ ours,
                                    unsigned* __restrict__ ref, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint4 c;
  uint2 k;
  check_inputs(i, c, k);
  const Philox4 a = philox4x32_10(c.x, c.y, c.z, c.w, k.x, k.y);
  ours[4 * i + 0] = a.x;
  ours[4 * i + 1] = a.y;
  ours[4 * i + 2] = a.z;
  ours[4 * i + 3] = a.w;
#if ADVMIL_HAVE_CURAND
  const uint4 b = curand_Philox4x32_10(c, k);
  ref[4 * i + 0] = b.x;
  ref[4 * i + 1] = b.y;
  ref[4 * i + 2] = b.z;
  ref[4 * i + 3] = b.w;
#endif
}

}  // namespace advmil

// ours / ref: [n, 4] uint32. Returns cudaErrorNotSupported when the toolkit
// has no cuRAND device header, else cudaGetLastError() after launch.
extern "C" int advmil_philox_check(void* ours, void* ref, int n, void* stream) {
  if (!ADVMIL_HAVE_CURAND) return static_cast<int>(cudaErrorNotSupported);
  advmil::philox_check_kernel<<<(n + 255) / 256, 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(ours), static_cast<unsigned*>(ref), n);
  return static_cast<int>(cudaGetLastError());
}
