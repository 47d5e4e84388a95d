"""Survival networks: the adversarial Generator, PrjDiscriminator and the
concat Discriminator, and the baseline SurvNet (counterparts of
`advmil_tpu/models/gan.py`).

The generator's Dense layers are xavier-initialised (its patch embedding
keeps torch init); the discriminator keeps torch defaults throughout.

Both discriminators take `t` as one tensor or as a pair `(t_real, t_fake)`:
the pair is scored in one call that computes the dropout-free patch
embedding of `x` once (one read of the features forward, one summed
cotangent backward), while every dropout layer after it draws its own mask
per pair element, as the reference's two train-mode calls do.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.masked import masked_mean, region_mask_from_patch_mask
from .layers import (TORCH, XAVIER, BottleneckMLP, Dense, GAPool, MLPBlock,
                     NoiseMLPHead, Rngs, apply_out_scale, make_embedding_layer)


class Generator(nn.Module):
    """backbone -> H [B, d] -> noise-MLP head -> out_scale.

    `embed` and `head` are separate so K-sample prediction runs the backbone
    once and only the small head over the K samples. The head's parameters
    live in `head_mlp` (flax names that subtree `head`; `bridge.py` maps it).
    `dropout` is the head's (cfg `gen_dropout`); the backbone has its own.
    """

    def __init__(self, backbone: nn.Module, dim_in: int, dim_out: int,
                 noise: Sequence[int], hops: int = 1, noise_dist: str = "uniform",
                 norm: bool = False, dropout: float = 0.25,
                 out_scale: str = "sigmoid", dtype=torch.float32):
        super().__init__()
        self.backbone = backbone
        self.head_mlp = NoiseMLPHead(dim_in, dim_out, noise, hops=hops,
                                     norm=norm, dropout=dropout,
                                     noise_dist=noise_dist, dtype=dtype)
        self.out_scale = out_scale

    def embed(self, x, mask, extra=None, rng: Rngs | None = None):
        return self.backbone(x, mask, extra, rng)

    def head(self, H, *, zero_noise: bool = False,
             generator: torch.Generator | None = None, rng: Rngs | None = None):
        h = self.head_mlp(H, zero_noise=zero_noise, generator=generator, rng=rng)
        return apply_out_scale(h, self.out_scale)

    def forward(self, x, mask, extra=None, *, zero_noise: bool = False,
                generator: torch.Generator | None = None, rng: Rngs | None = None):
        return self.head(self.embed(x, mask, extra, rng), zero_noise=zero_noise,
                         generator=generator, rng=rng)


class EmbedXLayer(nn.Module):
    """Discriminator X tower: region patch embedding (`backbone` avgpool or
    gapool, `ksize` 1 or 3; dropout-free either way) -> bottleneck fc1 ->
    GAPool -> bottleneck fc2. Returns (bag [B, C'], instances [B, L, C'],
    region mask [B, L], patch embedding [B, L, C']); pass the last back as
    `emb` to score the same x again without recomputing it."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.25,
                 ksize: int = 1, backbone: str = "avgpool",
                 use_lnpool: bool = True, dtype=torch.float32):
        super().__init__()
        self.embedding = make_embedding_layer(backbone, in_dim, out_dim, ksize=ksize,
                                              use_lnpool=use_lnpool, dtype=dtype)
        self.fc1 = BottleneckMLP(out_dim, dropout, dtype)
        self.pool = GAPool(out_dim, out_dim, dropout, TORCH, dtype)
        self.fc2 = BottleneckMLP(out_dim, dropout, dtype)

    def forward(self, x, mask, rng: Rngs | None = None, emb=None):
        if emb is None:
            emb = self.embedding(x, mask)                   # [B, L, C']
        rmask = region_mask_from_patch_mask(mask)
        fc_ins = self.fc1(emb, rng)
        fc_bag = self.fc2(self.pool(fc_ins, rmask, rng), rng)
        return fc_bag, fc_ins, rmask, emb


class EmbedYLayer(nn.Module):
    """Discriminator t tower: MLP in_dim -> hid_dims."""

    def __init__(self, in_dim: int, hid_dims: Sequence[int], norm: bool = False,
                 dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.n = len(hid_dims)
        d_in = in_dim
        for i, d_out in enumerate(hid_dims):
            self.add_module(f"mlp_{i}", MLPBlock(d_in, d_out, layer_norm=norm,
                                                 dropout=dropout, dense_init=TORCH,
                                                 dtype=dtype))
            d_in = d_out

    def forward(self, t, rng: Rngs | None = None):
        for i in range(self.n):
            t = getattr(self, f"mlp_{i}")(t, rng)
        return t


class PrjDiscriminator(nn.Module):
    """Projection discriminator. inner_product 'bag': <hid_x, hid_t>;
    'instance' (RLIP): per-region <emb_ins, hid_t>, masked mean over regions.
    Optional projection residual through hid_x ('x') or hid_t ('y')."""

    def __init__(self, netx_in_dim: int, netx_out_dim: int, nety_in_dim: int,
                 nety_hid_dims: Sequence[int], prj_path: str = "x",
                 inner_product: str = "bag", netx_dropout: float = 0.25,
                 nety_norm: bool = False, nety_dropout: float = 0.0,
                 netx_ksize: int = 1, netx_backbone: str = "avgpool",
                 use_lnpool: bool = True, dtype=torch.float32):
        super().__init__()
        assert inner_product in ("bag", "instance")
        self.prj_path, self.inner_product = prj_path, inner_product
        self.net_pair_one = EmbedXLayer(netx_in_dim, netx_out_dim, netx_dropout,
                                        ksize=netx_ksize, backbone=netx_backbone,
                                        use_lnpool=use_lnpool, dtype=dtype)
        self.net_pair_two = EmbedYLayer(nety_in_dim, nety_hid_dims,
                                        norm=nety_norm, dropout=nety_dropout,
                                        dtype=dtype)
        if prj_path == "x":
            self.prj_layer = Dense(netx_out_dim, 1, TORCH, dtype)
        elif prj_path == "y":
            self.prj_layer = Dense(nety_hid_dims[-1], 1, TORCH, dtype)
        else:
            self.prj_layer = None

    def forward(self, x, t, mask, rng: Rngs | None = None):
        outs, emb = [], None
        for tt in (t if isinstance(t, tuple) else (t,)):
            hid_t = self.net_pair_two(tt, rng)
            hid_x, emb_ins, rmask, emb = self.net_pair_one(x, mask, rng, emb)
            if self.inner_product == "bag":
                out = (hid_t * hid_x).sum(dim=-1, keepdim=True)          # [B, 1]
            else:
                out_ins = (emb_ins * hid_t[:, None, :]).sum(dim=-1)     # [B, L]
                out = masked_mean(out_ins[..., None], rmask[..., None], dim=-2)
            if self.prj_path == "x":
                out = out + self.prj_layer(hid_x)
            elif self.prj_path == "y":
                out = out + self.prj_layer(hid_t)
            outs.append(out)
        return tuple(outs) if isinstance(t, tuple) else outs[0]


class Discriminator(nn.Module):
    """Concat-fusion discriminator: fc([hid_x, hid_t])."""

    def __init__(self, netx_in_dim: int, netx_out_dim: int, nety_in_dim: int,
                 nety_hid_dims: Sequence[int], netx_dropout: float = 0.25,
                 nety_norm: bool = False, nety_dropout: float = 0.0,
                 netx_ksize: int = 1, netx_backbone: str = "avgpool",
                 use_lnpool: bool = True, dtype=torch.float32):
        super().__init__()
        self.net_pair_one = EmbedXLayer(netx_in_dim, netx_out_dim, netx_dropout,
                                        ksize=netx_ksize, backbone=netx_backbone,
                                        use_lnpool=use_lnpool, dtype=dtype)
        self.net_pair_two = EmbedYLayer(nety_in_dim, nety_hid_dims,
                                        norm=nety_norm, dropout=nety_dropout,
                                        dtype=dtype)
        self.fc = Dense(netx_out_dim + nety_hid_dims[-1], 1, TORCH, dtype)

    def forward(self, x, t, mask, rng: Rngs | None = None):
        outs, emb = [], None
        for tt in (t if isinstance(t, tuple) else (t,)):
            hid_t = self.net_pair_two(tt, rng)
            hid_x, _, _, emb = self.net_pair_one(x, mask, rng, emb)
            outs.append(self.fc(torch.cat([hid_x, hid_t], dim=-1)))
        return tuple(outs) if isinstance(t, tuple) else outs[0]


class SurvNet(nn.Module):
    """Baseline survival net: backbone -> H [B, d] -> noise-free MLP head
    (`out_layer`) -> sigmoid, or the head's output as is (`out_scale`
    none). As in the JAX package the output stays in the compute dtype (no
    f32 cast, unlike the Generator's), so under bf16 the supervised loss
    runs in bf16 too. There is no `embed` / `head` split: evaluation runs
    the whole forward."""

    def __init__(self, backbone: nn.Module, dim_in: int, dim_out: int, hops: int = 1,
                 norm: bool = False, dropout: float = 0.25, out_scale: str = "none",
                 dense_init: str = XAVIER, dtype=torch.float32):
        super().__init__()
        if out_scale not in ("sigmoid", "none"):
            raise ValueError(f"SurvNet out_scale must be sigmoid / none, got {out_scale!r}")
        self.backbone = backbone
        self.out_layer = NoiseMLPHead(dim_in, dim_out, (0,) * (1 + hops), hops=hops,
                                      norm=norm, dropout=dropout, dense_init=dense_init,
                                      dtype=dtype)
        self.out_scale = out_scale

    def forward(self, x, mask, extra=None, rng: Rngs | None = None):
        h = self.out_layer(self.backbone(x, mask, extra, rng), zero_noise=True, rng=rng)
        return torch.sigmoid(h) if self.out_scale == "sigmoid" else h
