"""Shared layers of the ESAT path in eval mode: flax-compatible Dense and
LayerNorm, MLP blocks, global attention pooling, the region patch embedding,
the masked transformer encoder and the noise-MLP generator head.

Counterparts of `advmil_tpu/models/layers.py`, with the flax names kept as
module attribute names so a flax parameter tree maps onto the `state_dict`
key for key (`bridge.py`). Dropout is the identity in eval and is not ported
here (training comes with ROADMAP slice 2).

Mixed precision mirrors flax's explicit casts rather than `torch.autocast`:
a Dense casts its input, weight and bias to the compute dtype; a LayerNorm
computes its statistics in f32 and returns the compute dtype; predictions
are cast to f32 before the output nonlinearity. Parameters stay f32.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import masked_flash_attention
from ..ops.ln_pool import LN_EPS, S2, ln_relu_region_mean
from ..ops.masked import masked_mean, masked_softmax

XAVIER = "xavier"   # xavier-uniform weight, zero bias (generator nets)
TORCH = "torch"     # torch Linear default U(+-1/sqrt(fan_in)) (discriminator nets)


def compute_dtype_of(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision in ("bf16", "bfloat16") else torch.float32


class Dense(nn.Module):
    """flax `nn.Dense(dtype=compute_dtype)`: weight [out, in] f32, computed
    in the compute dtype. Parameters are drawn by `reset_parameters`."""

    def __init__(self, in_features: int, out_features: int, init: str = XAVIER,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if init not in (XAVIER, TORCH):
            raise ValueError(f"unknown dense init {init}")
        self.in_features, self.out_features = in_features, out_features
        self.init, self.dtype = init, dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        if self.init == XAVIER:
            nn.init.xavier_uniform_(self.weight, generator=generator)
            self.bias.zero_()
        else:
            bound = 1.0 / math.sqrt(self.in_features)
            nn.init.uniform_(self.weight, -bound, bound, generator=generator)
            nn.init.uniform_(self.bias, -bound, bound, generator=generator)

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(dtype=compute_dtype)`: eps 1e-6, f32 statistics."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), LN_EPS)
        return y.to(self.dtype)


def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Draw every Dense's parameters from one CPU generator seeded with
    `seed`, in module registration order (the port's own init; it does not
    reproduce jax.random draws)."""
    g = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, Dense):
            m.reset_parameters(g)
    return model


class MLPBlock(nn.Module):
    """Dense (+LayerNorm) + ReLU (+Dropout, identity in eval)."""

    def __init__(self, dim_in: int, dim_out: int, layer_norm: bool = False,
                 dense_init: str = XAVIER, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(dim_in, dim_out, dense_init, dtype)
        self.LayerNorm_0 = LayerNorm(dim_out, dtype) if layer_norm else None

    def forward(self, x):
        x = self.Dense_0(x)
        if self.LayerNorm_0 is not None:
            x = self.LayerNorm_0(x)
        return torch.relu(x)


class BottleneckMLP(nn.Module):
    """Dense(d -> d/2) + ReLU + Dense(d/2 -> d), torch init (discriminator)."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(dim, dim // 2, TORCH, dtype)
        self.Dense_1 = Dense(dim // 2, dim, TORCH, dtype)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


class GAPool(nn.Module):
    """Global attention pooling [B, N, d] -> [B, d]:
    attn = masked_softmax(fc2(tanh(fc1(x)) * sigmoid(score(x)))); out = attn @ x."""

    def __init__(self, in_dim: int, hid_dim: int, dense_init: str = XAVIER,
                 dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(in_dim, hid_dim, dense_init, dtype)
        self.score = Dense(in_dim, hid_dim, dense_init, dtype)
        self.fc2 = Dense(hid_dim, 1, dense_init, dtype)

    def forward(self, x, mask):
        emb = torch.tanh(self.fc1(x))
        scr = torch.sigmoid(self.score(x))
        rep = self.fc2(emb * scr)
        attn = masked_softmax(rep[..., 0], mask, dim=-1)       # [B, N]
        return torch.einsum("bn,bnd->bd", attn, x.to(attn.dtype))


class AvgPoolPatchEmbedding(nn.Module):
    """[B, N, C] -> [B, N/16, out_dim]: pointwise Dense + LN + ReLU, then the
    mean over each 4x4 region of 16 consecutive patches (ksize 1).

    At out_dim % 128 == 0 with `use_lnpool` (the JAX package's gate) the
    LN + ReLU + region mean runs as one fused op (`ops.ln_pool`), whose
    fully padded regions are zeroed here with the region mask.
    """

    def __init__(self, in_dim: int, out_dim: int, use_lnpool: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.out_dim = out_dim
        self.use_lnpool = use_lnpool
        # torch init in G and D alike (Conv2d origin in the reference)
        self.Dense_0 = Dense(in_dim, out_dim, TORCH, dtype)
        self.LayerNorm_0 = LayerNorm(out_dim, dtype)

    def forward(self, x, mask):
        B, N, _ = x.shape
        L = N // S2
        h = self.Dense_0(x)
        if self.use_lnpool and self.out_dim % 128 == 0:
            out = ln_relu_region_mean(h.reshape(B * N, self.out_dim),
                                      self.LayerNorm_0.weight,
                                      self.LayerNorm_0.bias)
            out = out.reshape(B, L, self.out_dim)
            rmask = mask.reshape(B, L, S2).bool().any(dim=-1)
            return out * rmask[..., None].to(out.dtype)
        h = torch.relu(self.LayerNorm_0(h)).reshape(B, L, S2, self.out_dim)
        return masked_mean(h, mask.reshape(B, L, S2)[..., None], dim=-2)


def _masked_mha(q, k, v, mask, use_pallas: bool, flash_min_len: int):
    """Key-padding-masked attention, q/k/v [B, L, H, Dh], mask [B, L].

    At or above the eval gate, max(flash_min_len, 2048) regions as in the
    JAX package, the flash op runs (kernel on the card). Below it, the plain
    branch: fully masked queries softmax to uniform garbage here, which the
    caller's final `x * mask` removes.
    """
    B, L, H, Dh = q.shape
    if use_pallas and L >= max(int(flash_min_len), 2048):
        return masked_flash_attention(q, k, v, mask)
    scale = 1.0 / torch.tensor(math.sqrt(Dh), dtype=torch.float32).to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale.to(q.device)
    logits = logits.masked_fill(~mask[:, None, None, :].bool(),
                                torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class TransformerEncoderLayer(nn.Module):
    """Post-LN transformer encoder layer (torch TransformerEncoderLayer with
    relu, batch_first, norm_first=False) with a key-padding mask; xavier
    init (generator)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 use_pallas: bool = True, flash_min_len: int = 512,
                 dtype=torch.float32):
        super().__init__()
        self.nhead = nhead
        self.use_pallas, self.flash_min_len = use_pallas, flash_min_len
        self.in_proj = Dense(d_model, 3 * d_model, XAVIER, dtype)
        self.out_proj = Dense(d_model, d_model, XAVIER, dtype)
        self.norm1 = LayerNorm(d_model, dtype)
        self.linear1 = Dense(d_model, dim_feedforward, XAVIER, dtype)
        self.linear2 = Dense(dim_feedforward, d_model, XAVIER, dtype)
        self.norm2 = LayerNorm(d_model, dtype)

    def forward(self, x, mask):
        B, L, D = x.shape
        H = self.nhead
        q, k, v = self.in_proj(x).split(D, dim=-1)
        q, k, v = (t.reshape(B, L, H, D // H) for t in (q, k, v))
        attn = _masked_mha(q, k, v, mask, self.use_pallas, self.flash_min_len)
        x = x + self.out_proj(attn.reshape(B, L, D))
        x = self.norm1(x)
        x = x + self.linear2(torch.relu(self.linear1(x)))
        x = self.norm2(x)
        return x * mask[..., None].to(x.dtype)


def get_hop_dims(d: int, hops: int) -> list:
    res, cur = [], d
    for _ in range(hops):
        cur = cur // 2
        if cur > 1:
            res.append(cur)
        else:
            break
    return res


class NoiseMLPHead(nn.Module):
    """MLP head with optional per-layer noise concatenation: layer i's input
    doubles when noise[i] == 1. Hidden dims halve dim_in for `hops` steps;
    the last layer is a bare Dense. Xavier init (generator)."""

    def __init__(self, dim_in: int, dim_out: int, noise: Sequence[int],
                 hops: int = 1, norm: bool = False, noise_dist: str = "uniform",
                 dtype=torch.float32):
        super().__init__()
        assert len(noise) == hops + 1
        if noise_dist not in ("uniform", "gaussian"):
            raise NotImplementedError(noise_dist)
        self.noise, self.noise_dist = tuple(noise), noise_dist
        hid_dims = get_hop_dims(dim_in, hops)
        in_dims = [dim_in] + hid_dims
        out_dims = hid_dims + [dim_out]
        self.num_layers = len(hid_dims) + 1
        for i in range(self.num_layers):
            fan_in = in_dims[i] * (2 if self.noise[i] == 1 else 1)
            if i == self.num_layers - 1:
                layer = Dense(fan_in, out_dims[i], XAVIER, dtype)
            else:
                layer = MLPBlock(fan_in, out_dims[i], layer_norm=norm,
                                 dense_init=XAVIER, dtype=dtype)
            self.add_module(f"mlp_{i}", layer)

    def forward(self, h, *, zero_noise: bool,
                generator: torch.Generator | None = None):
        for i in range(self.num_layers):
            if self.noise[i] == 1:
                if zero_noise:
                    noise = torch.zeros_like(h)
                elif self.noise_dist == "uniform":
                    noise = torch.rand(h.shape, generator=generator,
                                       device=h.device).to(h.dtype)
                else:
                    noise = torch.randn(h.shape, generator=generator,
                                        device=h.device).to(h.dtype)
                h = torch.cat([h, noise], dim=-1)
            h = getattr(self, f"mlp_{i}")(h)
        return h


def apply_out_scale(h, out_scale: str):
    h = h.float()  # predictions stay f32 under bf16 compute
    if out_scale == "sigmoid":
        return torch.sigmoid(h)
    if out_scale == "exp":
        return torch.exp(h)
    return h
