"""2-D sin-cos positional embedding of region coordinates (counterpart of
`advmil_tpu/ops/pe.py`): ESAT adds it to the region embeddings when the batch
carries coordinates (`use_coords_pe`)."""
from __future__ import annotations

import torch


def posemb_sincos_2d(y: torch.Tensor, x: torch.Tensor, dim: int,
                     temperature: float = 10000.0,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y, x: [..., L] coordinates -> [..., L, dim] (dim % 4 == 0), in the
    order sin x, cos x, sin y, cos y; omega runs over dim / 4 - 1."""
    if dim % 4:
        raise ValueError("feature dimension must be multiple of 4 for sincos emb")
    omega = torch.arange(dim // 4, dtype=torch.float32, device=y.device) / (dim // 4 - 1)
    # the power in f64, rounded to f32 before the reciprocal: that is bit for
    # bit what XLA's f32 pow gives the JAX package, where torch's f32 pow is off
    # by an ulp for some omega (times a coordinate of ~60, 4e-6 in the angle)
    omega = 1.0 / (temperature ** omega.double()).float()
    y = y[..., None].float() * omega
    x = x[..., None].float() * omega
    return torch.cat([x.sin(), x.cos(), y.sin(), y.cos()], dim=-1).to(dtype)


def to_relative_coord(coord: torch.Tensor) -> torch.Tensor:
    """coord [..., L, 2] -> coordinates shifted so that the minimum corner is
    the origin."""
    return coord - coord.min(dim=-2, keepdim=True).values


def compute_pe(coord: torch.Tensor, ndim: int = 384, step: int = 1,
               dtype: torch.dtype = torch.float32, origin=None) -> torch.Tensor:
    """Region coords [B, L, 2] -> positional embedding [B, L, ndim]: relative
    coordinates floor-divided by `step`, then `posemb_sincos_2d`. `origin`
    [B, 1, 2] replaces the minimum corner of `coord` (a bag split over
    several ranks passes the whole bag's)."""
    ncoord = to_relative_coord(coord) if origin is None else coord - origin
    y = torch.div(ncoord[..., 1], step, rounding_mode="floor")
    x = torch.div(ncoord[..., 0], step, rounding_mode="floor")
    return posemb_sincos_2d(y, x, ndim, dtype=dtype)
