"""Adversarial networks in eval mode: Generator, PrjDiscriminator and the
concat Discriminator (counterparts of `advmil_tpu/models/gan.py`).

The generator's Dense layers are xavier-initialised (its patch embedding
keeps torch init); the discriminator keeps torch defaults throughout.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.masked import masked_mean, region_mask_from_patch_mask
from .layers import (TORCH, AvgPoolPatchEmbedding, BottleneckMLP, Dense,
                     GAPool, MLPBlock, NoiseMLPHead, apply_out_scale)


class Generator(nn.Module):
    """backbone -> H [B, d] -> noise-MLP head -> out_scale.

    `embed` and `head` are separate so K-sample prediction runs the backbone
    once and only the small head over the K samples. The head's parameters
    live in `head_mlp` (flax names that subtree `head`; `bridge.py` maps it).
    """

    def __init__(self, backbone: nn.Module, dim_in: int, dim_out: int,
                 noise: Sequence[int], hops: int = 1, noise_dist: str = "uniform",
                 norm: bool = False, out_scale: str = "sigmoid",
                 dtype=torch.float32):
        super().__init__()
        self.backbone = backbone
        self.head_mlp = NoiseMLPHead(dim_in, dim_out, noise, hops=hops,
                                     norm=norm, noise_dist=noise_dist, dtype=dtype)
        self.out_scale = out_scale

    def embed(self, x, mask, extra=None):
        return self.backbone(x, mask, extra)

    def head(self, H, *, zero_noise: bool = False,
             generator: torch.Generator | None = None):
        h = self.head_mlp(H, zero_noise=zero_noise, generator=generator)
        return apply_out_scale(h, self.out_scale)

    def forward(self, x, mask, extra=None, *, zero_noise: bool = False,
                generator: torch.Generator | None = None):
        return self.head(self.embed(x, mask, extra), zero_noise=zero_noise,
                         generator=generator)


class EmbedXLayer(nn.Module):
    """Discriminator X tower: region avg-pool embedding -> bottleneck fc1 ->
    GAPool -> bottleneck fc2. Returns (bag [B, C'], instances [B, L, C'],
    region mask [B, L])."""

    def __init__(self, in_dim: int, out_dim: int, use_lnpool: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.embedding = AvgPoolPatchEmbedding(in_dim, out_dim,
                                               use_lnpool=use_lnpool, dtype=dtype)
        self.fc1 = BottleneckMLP(out_dim, dtype)
        self.pool = GAPool(out_dim, out_dim, TORCH, dtype)
        self.fc2 = BottleneckMLP(out_dim, dtype)

    def forward(self, x, mask):
        emb = self.embedding(x, mask)                       # [B, L, C']
        rmask = region_mask_from_patch_mask(mask)
        fc_ins = self.fc1(emb)
        fc_bag = self.fc2(self.pool(fc_ins, rmask))
        return fc_bag, fc_ins, rmask


class EmbedYLayer(nn.Module):
    """Discriminator t tower: MLP in_dim -> hid_dims."""

    def __init__(self, in_dim: int, hid_dims: Sequence[int], norm: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.n = len(hid_dims)
        d_in = in_dim
        for i, d_out in enumerate(hid_dims):
            self.add_module(f"mlp_{i}", MLPBlock(d_in, d_out, layer_norm=norm,
                                                 dense_init=TORCH, dtype=dtype))
            d_in = d_out

    def forward(self, t):
        for i in range(self.n):
            t = getattr(self, f"mlp_{i}")(t)
        return t


class PrjDiscriminator(nn.Module):
    """Projection discriminator. inner_product 'bag': <hid_x, hid_t>;
    'instance' (RLIP): per-region <emb_ins, hid_t>, masked mean over regions.
    Optional projection residual through hid_x ('x') or hid_t ('y')."""

    def __init__(self, netx_in_dim: int, netx_out_dim: int, nety_in_dim: int,
                 nety_hid_dims: Sequence[int], prj_path: str = "x",
                 inner_product: str = "bag", nety_norm: bool = False,
                 use_lnpool: bool = True, dtype=torch.float32):
        super().__init__()
        assert inner_product in ("bag", "instance")
        self.prj_path, self.inner_product = prj_path, inner_product
        self.net_pair_one = EmbedXLayer(netx_in_dim, netx_out_dim,
                                        use_lnpool=use_lnpool, dtype=dtype)
        self.net_pair_two = EmbedYLayer(nety_in_dim, nety_hid_dims,
                                        norm=nety_norm, dtype=dtype)
        if prj_path == "x":
            self.prj_layer = Dense(netx_out_dim, 1, TORCH, dtype)
        elif prj_path == "y":
            self.prj_layer = Dense(nety_hid_dims[-1], 1, TORCH, dtype)
        else:
            self.prj_layer = None

    def forward(self, x, t, mask):
        hid_t = self.net_pair_two(t)
        hid_x, emb_ins, rmask = self.net_pair_one(x, mask)
        if self.inner_product == "bag":
            out = (hid_t * hid_x).sum(dim=-1, keepdim=True)          # [B, 1]
        else:
            out_ins = (emb_ins * hid_t[:, None, :]).sum(dim=-1)     # [B, L]
            out = masked_mean(out_ins[..., None], rmask[..., None], dim=-2)
        if self.prj_path == "x":
            out = out + self.prj_layer(hid_x)
        elif self.prj_path == "y":
            out = out + self.prj_layer(hid_t)
        return out


class Discriminator(nn.Module):
    """Concat-fusion discriminator: fc([hid_x, hid_t])."""

    def __init__(self, netx_in_dim: int, netx_out_dim: int, nety_in_dim: int,
                 nety_hid_dims: Sequence[int], nety_norm: bool = False,
                 use_lnpool: bool = True, dtype=torch.float32):
        super().__init__()
        self.net_pair_one = EmbedXLayer(netx_in_dim, netx_out_dim,
                                        use_lnpool=use_lnpool, dtype=dtype)
        self.net_pair_two = EmbedYLayer(nety_in_dim, nety_hid_dims,
                                        norm=nety_norm, dtype=dtype)
        self.fc = Dense(netx_out_dim + nety_hid_dims[-1], 1, TORCH, dtype)

    def forward(self, x, t, mask):
        hid_t = self.net_pair_two(t)
        hid_x, _, _ = self.net_pair_one(x, mask)
        return self.fc(torch.cat([hid_x, hid_t], dim=-1))
