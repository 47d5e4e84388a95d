"""Mask-correct reductions for padded bags (counterpart of
`advmil_tpu/ops/masked.py`): every softmax / mean over the instance axis
ignores padding, so a padded bag computes what the unpadded bag computes."""
from __future__ import annotations

import torch


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` restricted to mask==1 entries; masked entries get 0.
    Fully masked slices return all zeros instead of NaN (dummy tail bags)."""
    keep = mask.bool()
    s = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
    s_max = s.amax(dim=dim, keepdim=True)
    ex = torch.exp(s - s_max) * keep.to(scores.dtype)
    denom = ex.sum(dim=dim, keepdim=True)
    return ex / torch.clamp(denom, min=1e-30)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Mean over ``dim`` counting only mask==1 entries (mask broadcast to x)."""
    m = mask.to(x.dtype)
    total = (x * m).sum(dim=dim)
    count = m.sum(dim=dim)
    return total / torch.clamp(count, min=1.0)


def region_mask_from_patch_mask(mask: torch.Tensor, scale: int = 4) -> torch.Tensor:
    """[B, N] patch mask -> [B, N/s^2] region mask (valid if any patch is)."""
    B, N = mask.shape
    s2 = scale * scale
    return mask.reshape(B, N // s2, s2).bool().any(dim=-1)
