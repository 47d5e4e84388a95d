"""MIL encoder backbones. The port has ESAT (`DualTransHS`, bcb_mode
`patch`); the other modes come with later slices (ROADMAP A12, A13).

Call convention as in `advmil_tpu/models/backbones.py`: backbone(x, mask,
extra) with x [B, N, C] padded patch features and mask [B, N] (1 = real
patch); returns the bag embedding [B, dim_out].
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.masked import region_mask_from_patch_mask
from .layers import (XAVIER, AvgPoolPatchEmbedding, GAPool, Rngs,
                     TransformerEncoderLayer)


class DualTransHS(nn.Module):
    """Transformer-based ESAT: 4x4-region avg-pool patch embedding ->
    transformer encoder layer(s) -> global attention pooling."""

    def __init__(self, dims: Sequence[int], nhead: int = 8, num_layers: int = 1,
                 tra_backbone: str = "Transformer", dropout: float = 0.25,
                 use_pallas: bool = True, use_lnpool: bool = True,
                 flash_min_len: int = 512, dtype=torch.float32):
        super().__init__()
        dim_in, dim_hid, dim_out = dims
        assert dim_hid == dim_out
        assert tra_backbone in ("Transformer", "Identity")
        self.patch_embedding = AvgPoolPatchEmbedding(
            dim_in, dim_hid, use_lnpool=use_lnpool, dtype=dtype)
        self.num_layers = num_layers if tra_backbone == "Transformer" else 0
        for i in range(self.num_layers):
            self.add_module(f"encoder_{i}", TransformerEncoderLayer(
                dim_hid, nhead, dim_hid, dropout=dropout, use_pallas=use_pallas,
                flash_min_len=flash_min_len, dtype=dtype))
        self.pool = GAPool(dim_out, dim_out, dropout=dropout, dense_init=XAVIER,
                           dtype=dtype)

    def forward(self, x, mask, extra=None, rng: Rngs | None = None):
        if extra is not None:
            raise NotImplementedError("region-coordinate positional embedding "
                                      "is not ported yet (ROADMAP A2)")
        h = self.patch_embedding(x, mask)                 # [B, L, hid]
        rmask = region_mask_from_patch_mask(mask)         # [B, L]
        for i in range(self.num_layers):
            h = getattr(self, f"encoder_{i}")(h, rmask, rng)
        return self.pool(h, rmask, rng)


def load_backbone(mode: str, dims: Sequence[int], use_pallas: bool = True,
                  use_lnpool: bool = True, tra_backbone: str = "Transformer",
                  flash_min_len: int = 512, dtype=torch.float32) -> nn.Module:
    """Backbone factory with the reference's default hyperparameters (ESAT
    dropout 0.25, as `advmil_tpu/models/backbones.py::load_backbone`)."""
    dims = list(dims)[:3]
    if mode == "patch":
        return DualTransHS(dims, nhead=8, num_layers=1, tra_backbone=tra_backbone,
                           dropout=0.25,
                           use_pallas=use_pallas, use_lnpool=use_lnpool,
                           flash_min_len=flash_min_len, dtype=dtype)
    item = "A13" if mode == "graph" else "A12"
    raise NotImplementedError(f"backbone mode {mode!r} is not ported yet "
                              f"(ROADMAP {item})")
