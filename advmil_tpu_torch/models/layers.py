"""Shared layers of the ESAT path: flax-compatible Dense and LayerNorm,
dropout, MLP blocks, global attention pooling, the region patch embeddings
(mean or attention pooled, pointwise or 3x3 convolution, optionally one fused
op), the masked transformer encoder and the noise-MLP generator head.

Counterparts of `advmil_tpu/models/layers.py`, with the flax names kept as
module attribute names so a flax parameter tree maps onto the `state_dict`
key for key (`bridge.py`). `.train()` / `.eval()` take the place of flax's
`deterministic`. In train mode every random draw comes from the explicit
generators of an `Rngs` passed down through `forward` (`rng=`): dropout masks
and noise from its device generator, the flash kernels' per-call Philox seeds
from its CPU generator. Dropout is plain Bernoulli (the JAX package's
default path; its u8 byte masks are ROADMAP A15 and not ported).

Under a dp x inst grid (`parallel/mesh.py`) every rank holds its rows of
the batch and, with inst > 1, its whole regions of each bag. The reductions
over a bag's instances (the attention's keys, `GAPool`'s and ABMIL's
attention pooling, the discriminator's region mean) then run over the inst
group (`parallel/comm.py`); dropout masks and noise are drawn at the global
shape and cut to the rank's block (`mesh.rand_global`), the single-process
draws for the same elements.

Mixed precision mirrors flax's explicit casts rather than `torch.autocast`:
a Dense casts its input, weight and bias to the compute dtype; a LayerNorm
computes its statistics in f32 and returns the compute dtype; predictions
are cast to f32 before the output nonlinearity. Parameters stay f32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (masked_flash_attention, masked_flash_attention_inst,
                             rank_seed)
from ..ops.fused_embed import fused_region_embedding
from ..ops.ln_pool import LN_EPS, S2, ln_relu_region_mean
from ..ops.masked import masked_mean, masked_softmax
from ..parallel import comm, mesh

XAVIER = "xavier"   # xavier-uniform weight, zero bias (generator nets)
TORCH = "torch"     # torch Linear default U(+-1/sqrt(fan_in)) (discriminator nets)
PT041 = "pt041"     # pytorch-0.4.1-style U(+-0.5/sqrt(fan_in)) (Cox baselines)


@dataclass
class Rngs:
    """The generators of one train-mode forward. `device` draws dropout masks
    (and is the noise generator) on the tensors' device; `host` is a CPU
    generator that draws each flash call's 64-bit Philox seed, so no draw
    waits for the card."""
    device: torch.Generator
    host: torch.Generator

    def flash_seed(self) -> int:
        return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=self.host).item())


class Dropout(nn.Module):
    """flax `Dropout` through `mask_dropout`'s default path: in train mode each
    element is kept with probability 1 - rate (Bernoulli, from `rng.device`)
    and scaled by 1 / (1 - rate) in x's dtype; the identity in eval mode or at
    rate 0. Dim 0 of x is the batch; `inst_dim` names the dim that holds
    the rank's share of the instance axis, if any (for `mesh.rand_global`)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, rng: Rngs | None, inst_dim: int | None = None):
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if rng is None:
            raise ValueError("train-mode dropout needs explicit generators (rng=Rngs)")
        keep = mesh.rand_global(x.shape, rng.device, x.device, inst_dim=inst_dim) >= self.rate
        # made on the device: a host tensor copied over would wait for the stream
        scale = torch.full((), 1.0 - self.rate, dtype=x.dtype, device=x.device)
        return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


def set_dropout_rates(model: nn.Module, rate: float = 0.0) -> nn.Module:
    """Set the rate of every Dropout in `model` (attention dropout included);
    rate 0 makes train mode deterministic, as the parity checks need."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = float(rate)
    return model


def compute_dtype_of(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision in ("bf16", "bfloat16") else torch.float32


class Dense(nn.Module):
    """flax `nn.Dense(dtype=compute_dtype)`: weight [out, in] f32, computed
    in the compute dtype. Parameters are drawn by `reset_parameters`."""

    def __init__(self, in_features: int, out_features: int, init: str = XAVIER,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if init not in (XAVIER, TORCH, PT041):
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
            bound = (1.0 if self.init == TORCH else 0.5) / math.sqrt(self.in_features)
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


class RegionConv(nn.Module):
    """flax `nn.Conv(out, (k, k), padding="SAME")` over the 4x4 grid of each
    region: [R, 4, 4, C] -> [R, 4, 4, out]. Weight [out, in, k, k] (torch's
    OIHW; flax keeps HWIO, `bridge.py` permutes), torch Conv2d's default init
    U(+-1 / sqrt(in * k * k)) for weight and bias. As in flax, where the layer
    sets no dtype, the convolution runs in the promotion of input and
    parameters: f32."""

    def __init__(self, in_dim: int, out_dim: int, ksize: int):
        super().__init__()
        if ksize % 2 != 1:
            raise ValueError(f"region convolution needs an odd kernel size, got {ksize}")
        self.in_dim, self.ksize = in_dim, ksize
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim, ksize, ksize))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        bound = 1.0 / math.sqrt(self.in_dim * self.ksize ** 2)
        nn.init.uniform_(self.weight, -bound, bound, generator=generator)
        nn.init.uniform_(self.bias, -bound, bound, generator=generator)

    def forward(self, x):
        h = F.conv2d(x.float().permute(0, 3, 1, 2), self.weight, self.bias,
                     padding=self.ksize // 2)
        return h.permute(0, 2, 3, 1)


def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Draw every Dense's and RegionConv's parameters from one CPU generator
    seeded with `seed`, in module registration order (the port's own init; it
    does not reproduce jax.random draws)."""
    g = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, (Dense, RegionConv)):
            m.reset_parameters(g)
    return model


class MLPBlock(nn.Module):
    """Dense (+LayerNorm) + ReLU + Dropout."""

    def __init__(self, dim_in: int, dim_out: int, layer_norm: bool = False,
                 dropout: float = 0.25, dense_init: str = XAVIER,
                 dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(dim_in, dim_out, dense_init, dtype)
        self.LayerNorm_0 = LayerNorm(dim_out, dtype) if layer_norm else None
        self.drop = Dropout(dropout)

    def forward(self, x, rng: Rngs | None = None):
        x = self.Dense_0(x)
        if self.LayerNorm_0 is not None:
            x = self.LayerNorm_0(x)
        return self.drop(torch.relu(x), rng)


class BottleneckMLP(nn.Module):
    """Dense(d -> d/2) + ReLU + Dropout + Dense(d/2 -> d), torch init
    (discriminator)."""

    def __init__(self, dim: int, dropout: float = 0.25, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(dim, dim // 2, TORCH, dtype)
        self.Dense_1 = Dense(dim // 2, dim, TORCH, dtype)
        self.drop = Dropout(dropout)

    def forward(self, x, rng: Rngs | None = None, inst_dim: int | None = None):
        return self.Dense_1(self.drop(torch.relu(self.Dense_0(x)), rng, inst_dim))


def attention_pool(scores, mask, x):
    """sum over n of masked_softmax(scores)[b, n] * x[b, n] -> [B, d]
    (scores and mask [B, N], x [B, N, d]). Under an inst grid N is the
    rank's share of the bag: the softmax's max, its denominator and the sum
    run over the inst group (the max outside autograd: a softmax does not
    depend on its shift)."""
    keep = mask.bool()
    s = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
    s_max = comm.inst_max(s.amax(dim=-1, keepdim=True))
    ex = torch.exp(s - s_max) * keep.to(scores.dtype)
    denom = comm.inst_sum(ex.sum(dim=-1, keepdim=True))
    attn = ex / torch.clamp(denom, min=1e-30)
    return comm.inst_sum(torch.einsum("bn,bnd->bd", attn, x.to(attn.dtype)))


def instance_mean(x, mask):
    """`masked_mean(x, mask, dim=-2)` over a bag's instances (x [B, N, c],
    mask broadcast to it), over the inst group under an inst grid."""
    m = mask.to(x.dtype)
    total = comm.inst_sum((x * m).sum(dim=-2))
    count = comm.inst_sum(m.sum(dim=-2))
    return total / torch.clamp(count, min=1.0)


class GAPool(nn.Module):
    """Global attention pooling [B, N, d] -> [B, d]:
    emb = Dropout(tanh(fc1(x))); scr = Dropout(sigmoid(score(x)));
    attn = masked_softmax(fc2(emb * scr)); out = attn @ x. `over_bag`: N is
    a bag's instance axis (pooled over the inst group under an inst grid);
    False for the pool inside each 16-patch region, which stays local."""

    def __init__(self, in_dim: int, hid_dim: int, dropout: float = 0.25,
                 dense_init: str = XAVIER, dtype=torch.float32, over_bag: bool = True):
        super().__init__()
        self.fc1 = Dense(in_dim, hid_dim, dense_init, dtype)
        self.score = Dense(in_dim, hid_dim, dense_init, dtype)
        self.fc2 = Dense(hid_dim, 1, dense_init, dtype)
        self.drop = Dropout(dropout)
        self.over_bag = over_bag

    def forward(self, x, mask, rng: Rngs | None = None):
        emb = self.drop(torch.tanh(self.fc1(x)), rng, inst_dim=1)
        scr = self.drop(torch.sigmoid(self.score(x)), rng, inst_dim=1)
        rep = self.fc2(emb * scr)
        if self.over_bag:
            return attention_pool(rep[..., 0], mask, x)
        attn = masked_softmax(rep[..., 0], mask, dim=-1)       # [B, N]
        return torch.einsum("bn,bnd->bd", attn, x.to(attn.dtype))


class GatedAttention(nn.Module):
    """Gated attention scores [..., N, dim_l] -> [..., N, n_classes]:
    attention_c(Dropout(tanh(attention_a(x))) * Dropout(sigmoid(attention_b(x))));
    the caller takes the masked softmax over N. As in the JAX package, the
    dropout rate is 0.25 whenever `dropout` is non-zero. `inst_dim`: the dim
    that holds the rank's share of the instance axis (None where every rank
    holds N whole, as DeepAttnMISL's clusters)."""

    def __init__(self, dim_l: int, dim_d: int, dropout: float = 0.25,
                 n_classes: int = 1, dense_init: str = XAVIER, dtype=torch.float32):
        super().__init__()
        self.attention_a = Dense(dim_l, dim_d, dense_init, dtype)
        self.attention_b = Dense(dim_l, dim_d, dense_init, dtype)
        self.attention_c = Dense(dim_d, n_classes, dense_init, dtype)
        self.drop = Dropout(0.25 if dropout else 0.0)

    def forward(self, x, rng: Rngs | None = None, inst_dim: int | None = 1):
        a = self.drop(torch.tanh(self.attention_a(x)), rng, inst_dim=inst_dim)
        b = self.drop(torch.sigmoid(self.attention_b(x)), rng, inst_dim=inst_dim)
        return self.attention_c(a * b)


class _PatchProjection(nn.Module):
    """Base of the patch embeddings: the per-patch projection under flax's
    auto-names, `Dense_0` (ksize 1, pointwise) or `Conv_0` (a ksize x ksize
    convolution over each region's 4x4 grid), then `LayerNorm_0`; torch init
    in G and D alike (Conv2d origin in the reference)."""

    def __init__(self, in_dim: int, out_dim: int, ksize: int, dtype):
        super().__init__()
        self.out_dim, self.dtype, self.ksize = out_dim, dtype, ksize
        if ksize == 1:
            self.Dense_0 = Dense(in_dim, out_dim, TORCH, dtype)
        else:
            self.Conv_0 = RegionConv(in_dim, out_dim, ksize)
        self.LayerNorm_0 = LayerNorm(out_dim, dtype)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, C] -> [B, N, out_dim], before the LayerNorm."""
        if self.ksize == 1:
            return self.Dense_0(x)
        B, N, C = x.shape
        return self.Conv_0(x.reshape(B * N // S2, 4, 4, C)).reshape(B, N, self.out_dim)


class AvgPoolPatchEmbedding(_PatchProjection):
    """[B, N, C] -> [B, N/16, out_dim]: per-patch Dense (ksize 1) or ksize x
    ksize convolution over each region's 4x4 grid (stride 1, SAME padding),
    LN, ReLU, then the mean over each 4x4 region of 16 consecutive patches.

    Three routes, the JAX package's gates:
    - `use_fused` at ksize 1: Dense + LN + ReLU + region mean as one op
      (`ops.fused_embed`), under the same parameter names `Dense_0` /
      `LayerNorm_0`;
    - else, at out_dim % 128 == 0 with `use_lnpool`: the projection, then
      LN + ReLU + region mean as one op (`ops.ln_pool`);
    - else the plain layers and a masked mean.
    The two fused ops average whole regions; their fully padded regions are
    zeroed here with the region mask.
    """

    def __init__(self, in_dim: int, out_dim: int, ksize: int = 1,
                 use_fused: bool = False, use_lnpool: bool = True,
                 dtype=torch.float32):
        super().__init__(in_dim, out_dim, ksize, dtype)
        self.use_fused = bool(use_fused) and ksize == 1
        self.use_lnpool = use_lnpool

    def forward(self, x, mask):
        B, N, C = x.shape
        L = N // S2
        ln = self.LayerNorm_0
        if self.use_fused:
            out = fused_region_embedding(x.reshape(B * N, C).to(self.dtype),
                                         self.Dense_0.weight.t(), self.Dense_0.bias,
                                         ln.weight, ln.bias)
        else:
            h = self.project(x)
            if not (self.use_lnpool and self.out_dim % 128 == 0):
                h = torch.relu(ln(h)).reshape(B, L, S2, self.out_dim)
                return masked_mean(h, mask.reshape(B, L, S2)[..., None], dim=-2)
            out = ln_relu_region_mean(h.reshape(B * N, self.out_dim), ln.weight, ln.bias)
            out = out.to(self.dtype)
        out = out.reshape(B, L, self.out_dim)
        rmask = mask.reshape(B, L, S2).bool().any(dim=-1)
        return out * rmask[..., None].to(out.dtype)


class GAPoolPatchEmbedding(_PatchProjection):
    """The patch embedding that pools each 4x4 region with global attention
    instead of a mean: projection (as above), LN, ReLU, then a dropout-free
    `GAPool` (`pool`) over the 16 patches of every region."""

    def __init__(self, in_dim: int, out_dim: int, ksize: int = 1, dtype=torch.float32):
        super().__init__(in_dim, out_dim, ksize, dtype)
        self.pool = GAPool(out_dim, out_dim, 0.0, TORCH, dtype, over_bag=False)

    def forward(self, x, mask):
        B, N, _ = x.shape
        L = N // S2
        h = torch.relu(self.LayerNorm_0(self.project(x))).reshape(B * L, S2, self.out_dim)
        pooled = self.pool(h, mask.reshape(B * L, S2))
        return pooled.reshape(B, L, self.out_dim)


def make_embedding_layer(backbone: str, in_dim: int, out_dim: int, ksize: int = 1,
                         use_fused: bool = False, use_lnpool: bool = True,
                         dtype=torch.float32) -> nn.Module:
    """Embedding-layer factory: `avgpool` or `gapool` (cfg
    `disc_netx_backbone`; ESAT's `emb_backbone`)."""
    if backbone == "gapool":
        return GAPoolPatchEmbedding(in_dim, out_dim, ksize=ksize, dtype=dtype)
    if backbone == "avgpool":
        return AvgPoolPatchEmbedding(in_dim, out_dim, ksize=ksize, use_fused=use_fused,
                                     use_lnpool=use_lnpool, dtype=dtype)
    raise NotImplementedError(f"{backbone} has not implemented.")


def _masked_mha(q, k, v, mask, use_pallas: bool, flash_min_len: int,
                attn_drop: Dropout, rng: Rngs | None):
    """Key-padding-masked attention, q/k/v [B, L, H, Dh], mask [B, L].

    The JAX package's gate: the flash op (kernels on the card) runs at or
    above `flash_min_len` regions in train mode and max(flash_min_len, 2048)
    in eval mode; in train mode its dropout runs inside the kernels, seeded
    from `rng.host`. Below the gate, the plain branch, with Bernoulli dropout
    on the probabilities in train mode: fully masked queries softmax to
    uniform garbage here, which the caller's final `x * mask` removes.

    Under an inst grid L is the rank's share of the regions: the gate reads
    the bag's whole region count (L * inst), the flash op is the
    sequence-parallel one (local query rows against the gathered keys) and
    the plain branch gathers K / V / mask. Each rank's flash seed is
    `rank_seed` of the drawn one.
    """
    B, L, H, Dh = q.shape
    training = attn_drop.training
    min_len = int(flash_min_len) if training else max(int(flash_min_len), 2048)
    g = mesh.grid()
    ig = mesh.inst_grid()
    if use_pallas and L * (ig.inst if ig else 1) >= min_len:
        p = attn_drop.rate if training else 0.0
        if p > 0.0 and rng is None:
            raise ValueError("train-mode attention dropout needs explicit "
                             "generators (rng=Rngs)")
        seed = rng.flash_seed() if p > 0.0 else None
        dp_rank = g.dp_rank if g is not None else 0
        if ig is not None:
            return masked_flash_attention_inst(q, k, v, mask, ig.inst_group, dropout_p=p,
                                               seed=seed, dp_rank=dp_rank)
        return masked_flash_attention(q, k, v, mask, dropout_p=p,
                                      seed=rank_seed(seed, dp_rank=dp_rank))
    if ig is not None:
        k, v = comm.inst_gather(k), comm.inst_gather(v)
        mask = comm.all_gather(mask, 1, ig.inst_group)
    # 1/sqrt(Dh) rounded to q's dtype as flax does, made on the device (a
    # host tensor copied over would wait for the stream)
    scale = float(1.0 / torch.tensor(math.sqrt(Dh), dtype=torch.float32).to(q.dtype))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * torch.full(
        (), scale, dtype=q.dtype, device=q.device)
    logits = logits.masked_fill(~mask[:, None, None, :].bool(),
                                torch.finfo(logits.dtype).min)
    probs = attn_drop(torch.softmax(logits, dim=-1), rng, inst_dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class TransformerEncoderLayer(nn.Module):
    """Post-LN transformer encoder layer (torch TransformerEncoderLayer with
    relu, batch_first, norm_first=False) with a key-padding mask. The packed
    in-projection is always xavier (torch MultiheadAttention's); the other
    Dense layers take `dense_init`."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.25, use_pallas: bool = True,
                 flash_min_len: int = 512, dense_init: str = XAVIER,
                 dtype=torch.float32):
        super().__init__()
        self.nhead = nhead
        self.use_pallas, self.flash_min_len = use_pallas, flash_min_len
        self.in_proj = Dense(d_model, 3 * d_model, XAVIER, dtype)
        self.out_proj = Dense(d_model, d_model, dense_init, dtype)
        self.norm1 = LayerNorm(d_model, dtype)
        self.linear1 = Dense(d_model, dim_feedforward, dense_init, dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dense_init, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.attn_drop = Dropout(dropout)   # on the attention probabilities
        self.drop = Dropout(dropout)        # residual and feed-forward

    def forward(self, x, mask, rng: Rngs | None = None):
        B, L, D = x.shape
        H = self.nhead
        q, k, v = self.in_proj(x).split(D, dim=-1)
        q, k, v = (t.reshape(B, L, H, D // H) for t in (q, k, v))
        attn = _masked_mha(q, k, v, mask, self.use_pallas, self.flash_min_len,
                           self.attn_drop, rng)
        x = x + self.drop(self.out_proj(attn.reshape(B, L, D)), rng, inst_dim=1)
        x = self.norm1(x)
        ff = self.drop(torch.relu(self.linear1(x)), rng, inst_dim=1)
        x = x + self.drop(self.linear2(ff), rng, inst_dim=1)
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
    the last layer is a bare Dense. Xavier init (generator) unless
    `dense_init` says otherwise."""

    def __init__(self, dim_in: int, dim_out: int, noise: Sequence[int],
                 hops: int = 1, norm: bool = False, dropout: float = 0.25,
                 noise_dist: str = "uniform", dense_init: str = XAVIER,
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
                layer = Dense(fan_in, out_dims[i], dense_init, dtype)
            else:
                layer = MLPBlock(fan_in, out_dims[i], layer_norm=norm,
                                 dropout=dropout, dense_init=dense_init, dtype=dtype)
            self.add_module(f"mlp_{i}", layer)

    def forward(self, h, *, zero_noise: bool,
                generator: torch.Generator | None = None,
                rng: Rngs | None = None):
        """`generator` draws the noise; `rng` the train-mode dropout. h is
        [B, d], or [K, B, d] for K noise samples; the noise of a dp rank is
        its rows of the global draw (`mesh.rand_global` over dim -2)."""
        for i in range(self.num_layers):
            if self.noise[i] == 1:
                if zero_noise:
                    noise = torch.zeros_like(h)
                else:
                    noise = mesh.rand_global(
                        h.shape, generator, h.device, batch_dim=-2,
                        normal=self.noise_dist == "gaussian").to(h.dtype)
                h = torch.cat([h, noise], dim=-1)
            layer = getattr(self, f"mlp_{i}")
            h = layer(h) if i == self.num_layers - 1 else layer(h, rng)
        return h


def apply_out_scale(h, out_scale: str):
    h = h.float()  # predictions stay f32 under bf16 compute
    if out_scale == "sigmoid":
        return torch.sigmoid(h)
    if out_scale == "exp":
        return torch.exp(h)
    return h
