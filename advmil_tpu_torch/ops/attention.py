"""Key-padding-masked flash attention (forward).

Counterpart of `advmil_tpu/ops/attention.py::masked_flash_attention`, with
the JAX layout: q [B, Lq, H, Dh], k / v [B, Lk, H, Dh], mask [B, Lk]
(1 = real key). Fully masked queries (dummy bags) return 0.

Dispatch: a CPU tensor goes to the plain `masked_attention_reference`; a
CUDA tensor goes to the hand-written kernel `csrc/flash_fwd.cu`, or raises.
In-kernel attention dropout (dropout_p > 0) comes with the training slice
(ROADMAP B2); eval never asks for it.
"""
from __future__ import annotations

import math

import torch

from . import _build

LAUNCHES = 0     # kernel launches since the last reset (chip_smoke reads it)
HEAD_DIMS = (16, 32, 48, 64, 128)   # head dims the kernel is built for


def masked_attention_reference(q, k, v, mask):
    """Plain version (materialises the logits), as
    `advmil_tpu.ops.attention.masked_attention_reference`."""
    Dh = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(Dh), dtype=q.dtype))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale.to(q.device)
    keep = mask[:, None, None, :].bool()
    logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1)
    probs = probs * keep.to(probs.dtype)            # dummy bags -> 0
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention_fwd(q, k, v, mask):
    """Launch the kernel: (out [B, Lq, H, Dh] in q.dtype, lse [B*H, Lq] f32).

    q is scaled by 1/sqrt(Dh) in its own dtype before the kernel, as the TPU
    path does.
    """
    global LAUNCHES
    B, Lq, H, Dh = q.shape
    Lk = k.shape[1]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: needs CUDA tensors, got {q.device}")
    if k.shape != (B, Lk, H, Dh) or v.shape != k.shape or mask.shape != (B, Lk):
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, mask "
                         f"{tuple(mask.shape)}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_fwd: q, k, v must all be f32 or all bf16")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {Dh} not in {HEAD_DIMS}")
    if B * H > 65535 or Lq == 0 or Lk == 0:
        raise ValueError(f"flash_attention_fwd: unsupported sizes B*H={B * H}, "
                         f"Lq={Lq}, Lk={Lk}")
    qs = (q * (1.0 / math.sqrt(Dh))).contiguous()
    k, v = k.contiguous(), v.contiguous()
    mk = mask.to(torch.float32).contiguous()
    _build.require_cuda("flash_attention_fwd", qs, k, v, mk)
    out = torch.empty_like(qs)
    lse = torch.empty((B * H, Lq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.advmil_flash_fwd(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), mk.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, Lq, Lk, H, Dh,
            _build.DTYPE_CODES[q.dtype], _build.stream_of(q))
    _build.check(rc, "flash_attention_fwd")
    LAUNCHES += 1
    return out, lse


def masked_flash_attention(q, k, v, mask, *, dropout_p: float = 0.0):
    """Softmax(QK^T / sqrt(Dh)) V with a key-padding mask, O(L) memory on the
    card. q: [B, Lq, H, Dh]; k, v: [B, Lk, H, Dh]; mask: [B, Lk]."""
    if dropout_p > 0.0:
        raise NotImplementedError("attention dropout inside the flash kernel "
                                  "is not ported yet (ROADMAP B2)")
    if q.device.type == "cpu":
        return masked_attention_reference(q, k, v, mask)
    return flash_attention_fwd(q, k, v, mask)[0]
