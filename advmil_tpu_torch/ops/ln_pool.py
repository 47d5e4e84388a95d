"""Fused LayerNorm -> ReLU -> 16-row region mean (forward).

Counterpart of `advmil_tpu/ops/ln_pool.py::ln_relu_region_mean`. The ESAT and
discriminator patch embeddings are Dense -> LayerNorm -> ReLU -> mean over
each 4x4 region; the matmul stays with torch and this op reads the pre-LN
rows once and writes only the 16x smaller pooled output.

Dispatch: a CPU tensor goes to `ln_relu_region_mean_plain`; a CUDA tensor
goes to the hand-written kernel `csrc/ln_pool.cu`, or raises. There is no
fallback from the kernel to the plain version.

Padding contract (as in the JAX package): callers pad bags in whole 16-patch
regions; fully padded regions produce finite values that the caller zeroes
with its region mask.
"""
from __future__ import annotations

import torch

from . import _build

S2 = 16          # patches per region (4x4)
LN_EPS = 1e-6    # flax LayerNorm default
LAUNCHES = 0     # kernel launches since the last reset (chip_smoke reads it)


def ln_relu_region_mean_plain(h: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 LN statistics like flax, output in h.dtype."""
    M, D = h.shape
    hf = h.float()
    mu = hf.mean(dim=-1, keepdim=True)
    var = ((hf - mu) ** 2).mean(dim=-1, keepdim=True)
    xhat = (hf - mu) * torch.rsqrt(var + LN_EPS)
    y = torch.relu(xhat * scale.float() + bias.float())
    return y.reshape(M // S2, S2, D).mean(dim=1).to(h.dtype)


def ln_relu_region_mean(h: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """[M, D] pre-LN rows -> [M/16, D] pooled regions (M % 16 == 0).

    mean over 16-row groups of relu(LayerNorm(h) * scale + bias), LN
    statistics in f32 with eps 1e-6. h is f32 or bf16; the kernel takes any D
    that is a multiple of 32 from 32 to 1024.
    """
    global LAUNCHES
    if h.device.type == "cpu":
        return ln_relu_region_mean_plain(h, scale, bias)
    if h.device.type != "cuda":
        raise ValueError(f"ln_relu_region_mean: unsupported device {h.device}")
    M, D = h.shape
    if M % S2 or D % 32 or not 32 <= D <= 1024:
        raise ValueError(f"ln_relu_region_mean: needs M % 16 == 0 and D a "
                         f"multiple of 32 in [32, 1024], got {(M, D)}")
    if h.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"ln_relu_region_mean: unsupported dtype {h.dtype}")
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    if scale.shape != (D,) or bias.shape != (D,):
        raise ValueError("ln_relu_region_mean: scale and bias must be [D]")
    _build.require_cuda("ln_relu_region_mean", h, scale, bias)
    out = torch.empty((M // S2, D), dtype=h.dtype, device=h.device)
    if M == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(h.device):
        rc = lib.advmil_ln_relu_region_mean(
            h.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            M, D, _build.DTYPE_CODES[h.dtype], LN_EPS, _build.stream_of(h))
    _build.check(rc, "ln_relu_region_mean")
    LAUNCHES += 1
    return out
