// Host-side entry points of the tensor-core (bf16) flash attention kernels,
// called from the C entry points in flash_fwd.cu and flash_bwd.cu.
#pragma once

#include "common.cuh"
#include "philox.cuh"

namespace advmil {

// Operands of the backward kernels (see flash_bwd.cu for the layouts).
struct BwdArgs {
  const void *qs, *k, *v, *dout, *mask, *lse, *dvec;
  void *dq, *dk, *dv;
  int B, Lq, Lk, H;
};

// flash_fwd_mma.cu: bf16 q, k, v, out; f32 mask and lse.
cudaError_t flash_fwd_mma(const void* q, const void* k, const void* v, const void* mask,
                          void* out, void* lse, int B, int Lq, int Lk, int H, int Dh,
                          bool dropout, const DropoutArgs& d, cudaStream_t stream);

// flash_dq_mma.cu: bf16 qs, k, v, dout; f32 mask, lse, dvec, dq.
cudaError_t flash_dq_mma(const BwdArgs& a, int Dh, bool dropout, const DropoutArgs& d,
                         cudaStream_t stream);

// flash_dkv_mma.cu: bf16 qs, k, v, dout; f32 mask, lse, dvec, dk, dv.
cudaError_t flash_dkv_mma(const BwdArgs& a, int Dh, bool dropout, const DropoutArgs& d,
                          cudaStream_t stream);

}  // namespace advmil
