"""Plain PyTorch f32 reference of the adversarial survival models: the
generator (ESAT or PatchGCN backbone, noise-MLP head), the projection
discriminator, the losses, Adam and the 30-sample evaluation.

One bag at a time, unpadded, in float32 with TF32 off. Parameters are a dict
name -> tensor under the program's state-dict names (the interface, as a
checkpoint's). Random draws are handed in per site (`Draws`): uniform
tensors already cut to this bag, or a flash seed whose keep mask is worked
out here (`philox.py`).

Layer equations (AdvMIL, Liu et al. 2023; ESAT = one post-LN transformer
layer over 4x4-region embeddings, then gated attention pooling):

- patch embedding: Dense -> LayerNorm (eps 1e-6) -> ReLU -> mean over the 16
  patches of each region;
- ESAT: x += Drop(out_proj(MHA(x))); x = LN1(x); x += Drop(W2 Drop(ReLU(W1 x)));
  x = LN2(x); attention dropout on the softmax probabilities;
- GAPool: a = softmax(fc2(Drop(tanh(fc1 x)) * Drop(sigmoid(score x)))) over
  the instances; out = sum a x;
- head: Drop(ReLU(mlp_0 H)), then mlp_1 of it concatenated with U[0, 1)
  noise, sigmoid;
- D: hid_x from the region tower (bottleneck, GAPool, bottleneck), hid_t from
  the t tower; score = mean over regions of <ins, hid_t> + prj(hid_x).

`mm` selects the precision the forward is computed in: None for f32; for
another dtype every product's operands and every stored activation (the
outputs of products, norms, nonlinearities, dropout, residual sums, pools and
the attention's logits and probabilities) are rounded to it, forward and
backward, as a program computing in that precision holds them: bf16 both
ways (the program's own precision, a witness), or fp8, e4m3 forward and e5m2
backward with a per-tensor amax scale (the control, one step below bf16).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import philox

LN_EPS = 1e-6
S2 = 16
NHEAD = 8


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype`, back in f32; an fp8 format with a per-tensor
    amax scale, as fp8 computation takes its tensors."""
    if dtype.itemsize > 1:
        return x.to(dtype).to(torch.float32)
    scale = torch.finfo(dtype).max / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Round(torch.autograd.Function):
    """Rounds the forward value to `fwd` and the incoming gradient to `bwd`."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


def _q(x: torch.Tensor, mm) -> torch.Tensor:
    """x as a computation in precision `mm` holds it: unchanged for None
    (f32); bf16 both ways; fp8 as e4m3 forward and e5m2 backward (the usual
    fp8 training recipe's two formats)."""
    if mm is None:
        return x
    if mm == torch.bfloat16:
        return _Round.apply(x, torch.bfloat16, torch.bfloat16)
    return _Round.apply(x, torch.float8_e4m3fn, torch.float8_e5m2)


def linear(p: dict, name: str, x: torch.Tensor, mm=None) -> torch.Tensor:
    return _q(_q(x, mm) @ _q(p[name + ".weight"], mm).t() + p[name + ".bias"], mm)


def layer_norm(p: dict, name: str, x: torch.Tensor, mm=None) -> torch.Tensor:
    return _q(F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"],
                           LN_EPS), mm)


def dropout(x: torch.Tensor, u, rate: float, mm=None) -> torch.Tensor:
    """x kept where u >= rate, scaled by 1 / (1 - rate); identity for u None."""
    if u is None or rate == 0.0:
        return x
    return _q(torch.where(u >= rate, x / (1.0 - rate), torch.zeros_like(x)), mm)


class Draws:
    """One bag's draws of one forward, by site name; an absent site (eval
    mode) is None."""

    def __init__(self, sites: dict | None = None):
        self.sites = sites or {}

    def __getitem__(self, name):
        return self.sites.get(name)


def region_embed(p: dict, prefix: str, x: torch.Tensor, mm=None) -> torch.Tensor:
    h = torch.relu(layer_norm(p, prefix + ".LayerNorm_0", linear(p, prefix + ".Dense_0", x, mm),
                              mm))
    return _q(h.reshape(-1, S2, h.shape[-1]).mean(dim=1), mm)


def gapool(p: dict, prefix: str, x: torch.Tensor, d: Draws, site: str, rate: float,
           mm=None) -> torch.Tensor:
    emb = dropout(_q(torch.tanh(linear(p, prefix + ".fc1", x, mm)), mm), d[site + ".emb"],
                  rate, mm)
    scr = dropout(_q(torch.sigmoid(linear(p, prefix + ".score", x, mm)), mm),
                  d[site + ".scr"], rate, mm)
    a = _q(torch.softmax(linear(p, prefix + ".fc2", _q(emb * scr, mm), mm)[:, 0], dim=0), mm)
    return _q(_q(a, mm) @ _q(x, mm), mm)


def attention(q, k, v, d: Draws, rate: float, bh0: int, mm=None):
    """q, k, v [n, H, Dh]; dropout on the probabilities from the site
    `attn`: a uniform tensor [H, n, n], or ("philox", seed) with bag row
    bh0 // H."""
    n, H, Dh = q.shape
    logits = _q(torch.einsum("qhd,khd->hqk", _q(q, mm), _q(k, mm)) / math.sqrt(Dh), mm)
    probs = _q(torch.softmax(logits, dim=-1), mm)
    site = d["attn"]
    if site is not None:
        if isinstance(site, tuple):
            keep = torch.stack([philox.keep_mask(site[1], bh0 + h, n, rate, q.device)
                                for h in range(H)])
            probs = torch.where(keep, probs / (1.0 - rate), torch.zeros_like(probs))
        else:
            probs = dropout(probs, site, rate)
    return _q(torch.einsum("hqk,khd->qhd", _q(probs, mm), _q(v, mm)), mm)


def esat_embed(p: dict, x: torch.Tensor, d: Draws, rate: float, b: int, mm=None,
               taps: dict | None = None):
    """ESAT backbone: x [n, C] -> H [d]. `b` is the bag's row in its batch
    (the flash keep mask's counter). With `taps`, the encoder layer's output
    [n / 16, D] is kept under "encoder"."""
    h = region_embed(p, "backbone.patch_embedding", x, mm)          # [L, D]
    L, D = h.shape
    e = "backbone.encoder_0"
    q, k, v = linear(p, e + ".in_proj", h, mm).split(D, dim=-1)
    q, k, v = (t.reshape(L, NHEAD, D // NHEAD) for t in (q, k, v))
    att = attention(q, k, v, d, rate, b * NHEAD, mm).reshape(L, D)
    h = layer_norm(p, e + ".norm1", _q(h + dropout(linear(p, e + ".out_proj", att, mm),
                                                  d["out_proj"], rate, mm), mm), mm)
    ff = dropout(torch.relu(linear(p, e + ".linear1", h, mm)), d["ff1"], rate, mm)
    h = layer_norm(p, e + ".norm2", _q(h + dropout(linear(p, e + ".linear2", ff, mm),
                                                  d["ff2"], rate, mm), mm), mm)
    if taps is not None:
        taps["encoder"] = h
    return gapool(p, "backbone.pool", h, d, "pool", rate, mm)


def head(p: dict, H: torch.Tensor, noise: torch.Tensor, drop_u, rate: float, mm=None):
    """H [..., d], noise [..., d/2] -> sigmoid output [..., 1]."""
    h = dropout(torch.relu(linear(p, "head_mlp.mlp_0.Dense_0", H, mm)), drop_u, rate, mm)
    return torch.sigmoid(linear(p, "head_mlp.mlp_1", torch.cat([h, _q(noise, mm)], -1), mm))


def disc(p: dict, emb: torch.Tensor, t: torch.Tensor, d: Draws, rate: float, mm=None):
    """Projection discriminator (instance inner product, projection through
    hid_x) of one bag's region embedding emb [L, c] and time t [1]."""
    o = "net_pair_one"
    ht = torch.relu(linear(p, "net_pair_two.mlp_0.Dense_0", _q(t, mm), mm))
    ht = torch.relu(linear(p, "net_pair_two.mlp_1.Dense_0", ht, mm))
    ins = linear(p, o + ".fc1.Dense_1", dropout(torch.relu(
        linear(p, o + ".fc1.Dense_0", emb, mm)), d["fc1"], rate, mm), mm)
    pooled = gapool(p, o + ".pool", ins, d, "pool", rate, mm)
    hid_x = linear(p, o + ".fc2.Dense_1", dropout(torch.relu(
        linear(p, o + ".fc2.Dense_0", pooled, mm)), d["fc2"], rate, mm), mm)
    return _q(_q(ins * ht, mm).sum(-1), mm).mean() + linear(p, "prj_layer", hid_x, mm)[0]


def disc_embed(p: dict, x: torch.Tensor, mm=None) -> torch.Tensor:
    return region_embed(p, "net_pair_one.embedding", x, mm)


def abs_plus(w: torch.Tensor) -> torch.Tensor:
    """|w| with the subgradient +1 at 0."""
    return torch.where(w >= 0, w, -w)


class Adam:
    """Adam (Kingma and Ba 2015), betas (0.9, 0.999), eps 1e-8, with coupled
    L2 `decay` (added to the gradient) on the leaves of two or more dims."""

    def __init__(self, params: dict, lr: float, decay: float = 0.0):
        self.p, self.lr, self.decay = params, lr, decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0
        self.first_grad = None

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        b1, b2 = 0.9, 0.999
        seen = {}
        for k, w in self.p.items():
            g = grads[k]
            if self.decay and w.dim() > 1:
                g = g + self.decay * w
            seen[k] = g.clone()
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k] / (1 - b2 ** self.t)).sqrt() + 1e-8
            w.sub_(self.lr / (1 - b1 ** self.t) * self.m[k] / denom)
        if self.first_grad is None:
            self.first_grad = seen
