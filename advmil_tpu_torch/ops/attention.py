"""Key-padding-masked flash attention with in-kernel attention dropout,
forward and backward.

Counterpart of `advmil_tpu/ops/attention.py::masked_flash_attention`, with
the JAX layout: q [B, Lq, H, Dh], k / v [B, Lk, H, Dh], mask [B, Lk]
(1 = real key). Fully masked queries (dummy bags) return 0, with exactly zero
gradients.

Dropout (`dropout_p > 0`, training) acts on the normalised attention
probabilities, as torch's MultiheadAttention and the TPU kernels: the softmax
denominator sums the undropped weights and only the P.V contraction sees
p * keep / (1 - p). The keep mask is the per-element Philox stream of
`ops/philox.py` for the call's 64-bit `seed`, drawn by the caller on the
host.

Dispatch: a CPU tensor goes to the plain `masked_attention_reference`
(autograd through plain torch ops, with the materialised Philox mask); a
CUDA tensor goes to `MaskedFlashAttention`, whose forward is
`csrc/flash_fwd.cu` and whose backward is `csrc/flash_bwd.cu`, or raises.
For bf16 tensors the forward, the dQ and the dK/dV backward are the
tensor-core kernels of `csrc/flash_fwd_mma.cu`, `csrc/flash_dq_mma.cu` and
`csrc/flash_dkv_mma.cu` (behind the same entry points): they round P, the
dropped P and dS to bf16 before the second products, skip key tiles without
a real key, and compute the same function. `masked_attention_rounded` is the
plain version with those roundings: the oracle that holds the bf16 kernels
within `rounded_tol`, a bound far below the values compared, where the plain
version can only hold them within bf16's own noise.
"""
from __future__ import annotations

import math

import torch

from . import _build, philox

LAUNCHES = 0       # forward kernel launches since the last reset (chip_smoke reads it)
LAUNCHES_DROPOUT = 0   # of those, the launches with dropout_p > 0
LAUNCHES_DQ = 0    # dQ backward kernel launches
LAUNCHES_DKV = 0   # dK/dV backward kernel launches
HEAD_DIMS = (16, 32, 48, 64, 128)   # head dims the kernels are built for
MAX_KEYS = 1 << 19   # the bf16 forward lists its key tiles in shared memory (csrc/mma.cuh)


def masked_attention_reference(q, k, v, mask, dropout_p: float = 0.0,
                               seed: int | None = None):
    """Plain version (materialises the logits), as
    `advmil_tpu.ops.attention.masked_attention_reference`, plus the flash
    kernels' dropout: the Philox keep mask of `seed` on the probabilities."""
    B, Lq, H, Dh = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(float(Dh), dtype=q.dtype))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale.to(q.device)
    keep = mask[:, None, None, :].bool()
    logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1)
    probs = probs * keep.to(probs.dtype)            # dummy bags -> 0
    if dropout_p > 0.0:
        drop = philox.keep_mask_plain(seed, B * H, Lq, k.shape[1], dropout_p,
                                      device=q.device)
        probs = probs * drop.reshape(B, H, Lq, -1).to(probs.dtype) \
            * (1.0 / (1.0 - dropout_p))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def masked_attention_rounded(q, k, v, mask, dout=None, dropout_p: float = 0.0,
                             seed: int | None = None, fwd_out=None):
    """(out, dq, dk, dv) of the plain version (`out` alone without `dout`),
    forward and backward written out in f32 with the roundings of the bf16
    kernels: q is scaled in its own dtype; the forward rounds the
    unnormalised, dropped weights exp(s - m) to bf16 before P.V while the row
    sum adds them unrounded; the backward rounds the dropped probabilities
    (dV) and dS (dK and dQ) to bf16 before its second products. Masked keys
    are selected to 0, so a fully masked bag gives exact zeros.

    The backward's dvec = rowsum(dO * O) takes this function's own out, or
    `fwd_out`, the forward kernel's output that the backward kernels are
    given (`flash_bwd_inputs`): the two may differ by a bf16 ulp, and on a
    row whose softmax is saturated dS = P (dP - dvec) cancels to far below
    dP, so that ulp alone can move dQ and dK by a share of themselves."""
    B, Lq, H, Dh = q.shape
    f32 = torch.float32
    scale = 1.0 / math.sqrt(Dh)

    def rnd(t):
        return t.to(torch.bfloat16).to(f32)

    qs, kf, vf = (q * scale).to(f32), k.to(f32), v.to(f32)
    real = mask[:, None, None, :] > 0
    zero = torch.zeros((), dtype=f32, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    m = s.masked_fill(~real, -1e30).amax(dim=-1, keepdim=True)
    p_un = torch.where(real, torch.exp(s - m), zero)
    l = p_un.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    keep = 1.0
    if dropout_p > 0.0:
        keep = philox.keep_mask_plain(seed, B * H, Lq, k.shape[1], dropout_p,
                                      device=q.device).reshape(B, H, Lq, -1) \
            * (1.0 / (1.0 - dropout_p))
    out = torch.einsum("bhqk,bkhd->bqhd", rnd(p_un * keep), vf) / l.permute(0, 2, 1, 3)
    out = out.to(q.dtype)
    if dout is None:
        return out
    do = dout.to(q.dtype).to(f32)
    p = torch.where(real, torch.exp(s - (m + torch.log(l))), zero)
    o = out if fwd_out is None else fwd_out.to(q.dtype)
    dvec = (do * o.to(f32)).sum(-1).permute(0, 2, 1)[..., None]       # [B, H, Lq, 1]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, vf) * keep - dvec)
    dv = torch.einsum("bhqk,bqhd->bkhd", rnd(p * keep), do)
    dk = torch.einsum("bhqk,bqhd->bkhd", rnd(ds), qs)
    dq = torch.einsum("bhqk,bkhd->bqhd", rnd(ds), kf) * scale
    return out, dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rounded_tol(want) -> dict:
    """atol / rtol of a bf16 kernel's result against `want`, the same tensor
    from `masked_attention_rounded`. Relative: one bf16 ulp of the result (at
    most 2^-7) and a little. Absolute: the kernel's exponentials (ex2.approx)
    differ from the oracle's in the last bits, so here and there a P or dS
    rounds the other way, by one ulp of an element that may be among the
    largest; the result then moves by that ulp times an operand, which is
    bounded by one bf16 ulp of the largest result: 2^-7 of it. dQ and dK hold
    within it against the oracle fed the forward output the backward kernels
    were given (`masked_attention_rounded(..., fwd_out=)`): on trained
    weights, where a softmax row saturates and dS cancels, the oracle's own
    output, a bf16 ulp away here and there, moves them past it."""
    return dict(atol=float(want.detach().abs().max()) / 128, rtol=1e-2)


def _dropout_args(dropout_p: float, seed: int | None) -> list:
    """The kernels' trailing dropout arguments: on/off, seed lo / hi,
    threshold, 1 / (1 - p)."""
    if dropout_p <= 0.0:
        return [0, 0, 0, 0, 1.0]
    if not dropout_p < 1.0:
        raise ValueError(f"attention dropout must be < 1, got {dropout_p}")
    if seed is None:
        raise ValueError("attention dropout needs a seed for its Philox stream")
    lo, hi = philox.split_seed(seed)
    return [1, lo, hi, philox.threshold(dropout_p), 1.0 / (1.0 - dropout_p)]


def _check(name, q, k, v, mask):
    B, Lq, H, Dh = q.shape
    Lk = k.shape[1]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {q.device}")
    if k.shape != (B, Lk, H, Dh) or v.shape != k.shape or mask.shape != (B, Lk):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, mask {tuple(mask.shape)}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must all be f32 or all bf16")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {Dh} not in {HEAD_DIMS}")
    if B * H > 65535 or Lq == 0 or Lk == 0 or Lk > MAX_KEYS:
        raise ValueError(f"{name}: unsupported sizes B*H={B * H}, Lq={Lq}, Lk={Lk}")


def flash_attention_fwd(q, k, v, mask, dropout_p: float = 0.0,
                        seed: int | None = None):
    """Launch the forward kernel: (out [B, Lq, H, Dh] in q.dtype, lse [B*H, Lq]
    f32).

    q is scaled by 1/sqrt(Dh) in its own dtype before the kernel, as the TPU
    path does. The log-sum-exp is of the undropped weights.
    """
    global LAUNCHES, LAUNCHES_DROPOUT
    _check("flash_attention_fwd", q, k, v, mask)
    B, Lq, H, Dh = q.shape
    drop = _dropout_args(dropout_p, seed)
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
            out.data_ptr(), lse.data_ptr(), B, Lq, k.shape[1], H, Dh,
            _build.DTYPE_CODES[q.dtype], *drop, _build.stream_of(q))
    _build.check(rc, "flash_attention_fwd")
    LAUNCHES += 1
    LAUNCHES_DROPOUT += drop[0]
    return out, lse


def flash_bwd_inputs(q, k, v, mask, out, lse, dout) -> dict:
    """The backward kernels' operands: qs = q / sqrt(Dh) as in the forward,
    contiguous k, v, dO (in q's dtype), the f32 mask and lse, and dvec =
    rowsum(dO * O) [B*H, Lq] formed in f32, as the JAX package forms it outside
    its kernels."""
    _check("flash_attention_bwd", q, k, v, mask)
    B, Lq, H, Dh = q.shape
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (B * H, Lq):
        raise ValueError("flash_attention_bwd: out / dout / lse do not match q")
    dvec = (dout.float() * out.float()).sum(-1)                  # [B, Lq, H]
    ops = dict(qs=(q * (1.0 / math.sqrt(Dh))).contiguous(), k=k.contiguous(),
               v=v.contiguous(), do=dout.to(q.dtype).contiguous(),
               mask=mask.to(torch.float32).contiguous(),
               lse=lse.to(torch.float32).contiguous(),
               dvec=dvec.permute(0, 2, 1).reshape(B * H, Lq).contiguous())
    _build.require_cuda("flash_attention_bwd", *ops.values())
    return ops


def _bwd_args(ops: dict) -> tuple:
    B, Lq, H, Dh = ops["qs"].shape
    ptrs = tuple(ops[n].data_ptr() for n in ("qs", "k", "v", "do", "mask", "lse", "dvec"))
    sizes = (B, Lq, ops["k"].shape[1], H, Dh, _build.DTYPE_CODES[ops["qs"].dtype])
    return ptrs, sizes


def flash_bwd_dq(ops: dict, dropout_p: float = 0.0, seed: int | None = None):
    """Launch the dQ kernel: dq [B, Lq, H, Dh] f32, not yet times 1/sqrt(Dh)."""
    global LAUNCHES_DQ
    ptrs, sizes = _bwd_args(ops)
    dq = torch.empty(ops["qs"].shape, dtype=torch.float32, device=ops["qs"].device)
    with torch.cuda.device(dq.device):
        rc = _build.load().advmil_flash_bwd_dq(
            *ptrs, dq.data_ptr(), *sizes, *_dropout_args(dropout_p, seed),
            _build.stream_of(dq))
    _build.check(rc, "flash_attention_bwd (dq)")
    LAUNCHES_DQ += 1
    return dq


def flash_bwd_dkv(ops: dict, dropout_p: float = 0.0, seed: int | None = None):
    """Launch the dK/dV kernel: (dk, dv) [B, Lk, H, Dh] f32."""
    global LAUNCHES_DKV
    ptrs, sizes = _bwd_args(ops)
    dk = torch.empty(ops["k"].shape, dtype=torch.float32, device=ops["k"].device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(dk.device):
        rc = _build.load().advmil_flash_bwd_dkv(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *sizes,
            *_dropout_args(dropout_p, seed), _build.stream_of(dk))
    _build.check(rc, "flash_attention_bwd (dk, dv)")
    LAUNCHES_DKV += 1
    return dk, dv


def flash_attention_bwd(q, k, v, mask, out, lse, dout, dropout_p: float = 0.0,
                        seed: int | None = None):
    """Launch the two backward kernels: (dq, dk, dv) in the inputs' dtype.
    `out` and `lse` are the forward's results for the same (q, k, v, mask,
    dropout_p, seed)."""
    ops = flash_bwd_inputs(q, k, v, mask, out, lse, dout)
    dq = flash_bwd_dq(ops, dropout_p, seed) * (1.0 / math.sqrt(q.shape[-1]))
    dk, dv = flash_bwd_dkv(ops, dropout_p, seed)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class MaskedFlashAttention(torch.autograd.Function):
    """The op on the card: kernel forward (saving the lse), kernel backward
    (counterpart of the JAX package's `_flash` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, dropout_p, seed):
        out, lse = flash_attention_fwd(q, k, v, mask, dropout_p, seed)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.dropout_p, ctx.seed = dropout_p, seed
        return out

    @staticmethod
    @_build.first_order
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, dout,
                                         ctx.dropout_p, ctx.seed)
        return dq, dk, dv, None, None, None


def masked_flash_attention(q, k, v, mask, *, dropout_p: float = 0.0,
                           seed: int | None = None):
    """Softmax(QK^T / sqrt(Dh)) V with a key-padding mask and optional
    attention dropout, O(L) memory on the card. q: [B, Lq, H, Dh]; k, v:
    [B, Lk, H, Dh]; mask: [B, Lk]. `seed` (a 64-bit int) is required when
    dropout_p > 0. Differentiable in q, k and v on both devices."""
    _dropout_args(dropout_p, seed)               # validate on every device
    if q.device.type == "cpu":
        return masked_attention_reference(q, k, v, mask, dropout_p, seed)
    return MaskedFlashAttention.apply(q, k, v, mask, float(dropout_p), seed)


# ---------------------------------------------------------------------------
# sequence-parallel flash attention over an inst process group
# ---------------------------------------------------------------------------

INST_SEED_STRIDE = 7919   # inst rank r adds r * 7919, as in the JAX wrapper
DP_SEED_STRIDE = 104729   # dp rank r adds r * 104729


def rank_seed(seed: int | None, inst_rank: int = 0, dp_rank: int = 0) -> int | None:
    """The flash dropout seed of the rank at (dp_rank, inst_rank) of a dp x
    inst grid: its keep mask on the local query rows is the plain keep mask
    of this seed (rows 0 .. Lq-1 of the rank's own call), decorrelated
    across ranks, so bags of different dp ranks and the query rows of
    different inst ranks do not share keep masks."""
    if seed is None:
        return None
    return (int(seed) + inst_rank * INST_SEED_STRIDE + dp_rank * DP_SEED_STRIDE) % (1 << 64)


def _inst_operands(k, v, mask, group):
    from ..parallel import comm
    return (comm.all_gather(k, 1, group), comm.all_gather(v, 1, group),
            comm.all_gather(mask, 1, group))


class MaskedFlashAttentionInst(torch.autograd.Function):
    """The flash kernels on this rank's query rows against the keys of the
    whole inst group: the forward all-gathers K / V / mask over `group` and
    launches #5 with the rank's seed; the backward launches #6 / #7 on the
    local rows against the full keys and reduce-scatters the partial dK / dV
    (f32) over the group, the transpose of the all-gather."""

    @staticmethod
    def forward(ctx, q, k, v, mask, dropout_p, seed, group):
        kf, vf, mf = _inst_operands(k, v, mask, group)
        out, lse = flash_attention_fwd(q, kf, vf, mf, dropout_p, seed)
        ctx.save_for_backward(q, kf, vf, mf, out, lse)
        ctx.dropout_p, ctx.seed, ctx.group = dropout_p, seed, group
        return out

    @staticmethod
    @_build.first_order
    def backward(ctx, dout):
        from ..parallel import comm
        q, kf, vf, mf, out, lse = ctx.saved_tensors
        ops = flash_bwd_inputs(q, kf, vf, mf, out, lse, dout)
        dq = flash_bwd_dq(ops, ctx.dropout_p, ctx.seed) * (1.0 / math.sqrt(q.shape[-1]))
        dk, dv = flash_bwd_dkv(ops, ctx.dropout_p, ctx.seed)
        dk = comm.reduce_scatter(dk, 1, ctx.group).contiguous()
        dv = comm.reduce_scatter(dv, 1, ctx.group).contiguous()
        return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), None, None, None, None


def masked_attention_inst_reference(q, k, v, mask, group, dropout_p: float = 0.0,
                                    seed: int | None = None):
    """Plain version of `masked_flash_attention_inst` (`seed` is the rank's
    own, see `rank_seed`): the differentiable all-gather of K / V (backward:
    reduce-scatter) and the plain attention of the local rows."""
    from ..parallel import comm
    kf, vf = comm.gather(k, 1, group), comm.gather(v, 1, group)
    mf = comm.all_gather(mask, 1, group)
    return masked_attention_reference(q, kf, vf, mf, dropout_p, seed)


def masked_flash_attention_inst(q, k, v, mask, group, *, dropout_p: float = 0.0,
                                seed: int | None = None, dp_rank: int = 0):
    """Sequence-parallel masked attention (counterpart of the JAX package's
    `masked_flash_attention_inst`): q / k / v [B, L/m, H, Dh] and mask
    [B, L/m] are this rank's share of the instance axis, split over the m
    ranks of `group` in rank order; the output is this rank's query rows
    against all L keys. With dropout the rank's keep mask comes from
    `rank_seed(seed, group_rank, dp_rank)`. On the CPU the plain version, on
    the card the kernels, or raises."""
    import torch.distributed as tdist
    _dropout_args(dropout_p, seed)
    seed = rank_seed(seed, tdist.get_rank(group), dp_rank)
    if q.device.type == "cpu":
        return masked_attention_inst_reference(q, k, v, mask, group, dropout_p, seed)
    return MaskedFlashAttentionInst.apply(q, k, v, mask, float(dropout_p), seed, group)
