"""Softmax aggregation over a node's incoming kNN edges (GENConv, PatchGCN),
on the dense route, the host-side band tables of the banded route, and the
plain masked `segment_mean`.

Counterpart of `advmil_tpu/ops/segment.py`. A kNN graph has a bounded
in-degree, so the batcher lays each bag's edges out as a dense table:
`edge_src [N, epn]` (source node per incoming slot) and `edge_mask [N, epn]`
(1 = real edge). GENConv gathers the messages `relu(x)[edge_src] + eps` into
`[..., N, epn, C]` and aggregates each node and channel with a softmax over
its real slots at the learnable temperature t.

Dispatch of `fused_knn_softmax_aggregate`: a CPU tensor goes to the plain
`knn_edge_softmax_aggregate` (autograd through plain torch ops); a CUDA
tensor goes to `FusedKnnSoftmaxAggregate`, whose forward and backward are
the hand-written kernels of `csrc/knn_agg.cu`, or raises. There is no
fallback from the kernels to the plain version.

`build_band_tables` and `band_coverage` are numpy copies of the JAX
package's host functions (the port imports no JAX), used by the batcher's
pre-scan and tables.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

LAUNCHES = 0       # forward kernel launches since the last reset (chip_smoke reads it)
LAUNCHES_BWD = 0   # backward kernel launches since the last reset
MAX_EPN = 16       # incoming slots per node the kernels take (csrc/graph_agg.cuh)
DT_PARTIALS = 1024  # per-block dt partials a backward kernel writes at most
MAX_FWD_ELEMS = 2 ** 31 - 1  # the forward's 32-bit index math: rows * epn * C below this


def segment_mean(values: torch.Tensor, seg_ids: torch.Tensor, mask: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Masked per-segment mean of values [N, C] -> [num_segments, C]; rows
    with mask 0 join no segment; an empty segment gives zeros. A plain
    function (no JAX model calls it; DeepAttnMISL pools its clusters with a
    one-hot product)."""
    seg = torch.where(mask.bool(), seg_ids.long(),
                      torch.full_like(seg_ids.long(), num_segments))
    w = mask.to(values.dtype)
    total = torch.zeros((num_segments + 1, values.shape[-1]), dtype=values.dtype,
                        device=values.device).index_add_(0, seg, values * w[:, None])
    count = torch.zeros(num_segments + 1, dtype=values.dtype,
                        device=values.device).index_add_(0, seg, w)
    return (total / torch.clamp(count, min=1.0)[:, None])[:num_segments]


def knn_edge_softmax_aggregate(messages: torch.Tensor, edge_mask: torch.Tensor,
                               t: torch.Tensor) -> torch.Tensor:
    """Plain version: messages [..., epn, C], edge_mask [..., epn] (1 = real
    edge), t a one-element temperature -> [..., C] in messages' dtype.

    The softmax runs in f32, as the kernels do. A node without edges gives 0:
    the max over real slots is -inf there and is reset to 0, and the mask
    selects before exp. exp takes the masked logits, so a masked slot is
    exp(-inf) = 0 with a zero gradient, never an overflow."""
    m = messages.float()
    mb = edge_mask.bool()[..., None]
    masked = torch.where(mb, m * t.float().reshape(()), float("-inf"))
    mx = masked.amax(dim=-2, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros((), device=mx.device))
    ex = torch.exp(masked - mx)
    alpha = ex / ex.sum(dim=-2, keepdim=True).clamp_min(1e-16)
    return (alpha * m).sum(dim=-2).to(messages.dtype)


def knn_tol(want: torch.Tensor) -> dict:
    """atol / rtol of the bf16 forward kernel against the plain version on the
    same bf16 messages, rounded to bf16 (`knn_edge_softmax_aggregate`). Both
    compute the softmax and the weighted sum in f32 and round once; only the
    f32 rounding of the exponentials and sums differs. So a value may land one
    bf16 ulp away, on the other side of a rounding edge (2^-7 relative), and
    a weighted sum that cancels to near 0 keeps the f32 noise of its terms
    (2^-10 of the largest |value| absolute). A slot dropped or read from the
    wrong place moves a value by a share of the messages themselves."""
    return dict(rtol=2.0 ** -7, atol=float(want.detach().abs().max()) / 1024)


def _check(name: str, messages: torch.Tensor, edge_mask: torch.Tensor, t: torch.Tensor):
    if messages.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {messages.device}")
    if messages.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {messages.dtype}")
    if messages.dim() < 2 or edge_mask.shape != messages.shape[:-1]:
        raise ValueError(f"{name}: messages [..., epn, C] and edge_mask [..., epn], got "
                         f"{tuple(messages.shape)} and {tuple(edge_mask.shape)}")
    if not 1 <= messages.shape[-2] <= MAX_EPN:
        raise ValueError(f"{name}: the kernels take 1 to {MAX_EPN} slots per node, got "
                         f"{messages.shape[-2]}")
    if t.numel() != 1:
        raise ValueError(f"{name}: t must hold one element")


def _operands(messages, edge_mask, t):
    epn, C = messages.shape[-2:]
    rows = messages.numel() // (epn * C)
    return (messages.contiguous(), edge_mask.to(torch.float32).contiguous(),
            t.detach().to(torch.float32).reshape(1).contiguous(), rows, epn, C)


def fused_agg_fwd(messages: torch.Tensor, edge_mask: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: [..., epn, C] -> [..., C] in messages' dtype."""
    global LAUNCHES
    _check("fused_knn_softmax_aggregate", messages, edge_mask, t)
    msg, em, tt, rows, epn, C = _operands(messages, edge_mask, t)
    if msg.numel() > MAX_FWD_ELEMS:
        raise ValueError(f"fused_knn_softmax_aggregate: the kernel indexes rows * epn * C "
                         f"= {msg.numel()} values in 32 bits (at most {MAX_FWD_ELEMS})")
    _build.require_cuda("fused_knn_softmax_aggregate", msg, em, tt)
    out = torch.empty(messages.shape[:-2] + (C,), dtype=msg.dtype, device=msg.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(msg.device):
        rc = lib.advmil_knn_agg_fwd(msg.data_ptr(), em.data_ptr(), tt.data_ptr(),
                                    out.data_ptr(), rows, epn, C,
                                    _build.DTYPE_CODES[msg.dtype], _build.stream_of(msg))
    _build.check(rc, "fused_knn_softmax_aggregate")
    LAUNCHES += 1
    return out


def fused_agg_bwd(messages: torch.Tensor, edge_mask: torch.Tensor, t: torch.Tensor,
                  g: torch.Tensor):
    """Launch the backward kernel: (dmessages in messages' dtype, dt [1] f32)
    for the cotangent g [..., C] (taken in messages' dtype)."""
    global LAUNCHES_BWD
    _check("fused_knn_softmax_aggregate_bwd", messages, edge_mask, t)
    msg, em, tt, rows, epn, C = _operands(messages, edge_mask, t)
    if g.shape != messages.shape[:-2] + (C,):
        raise ValueError(f"fused_knn_softmax_aggregate_bwd: g {tuple(g.shape)} for "
                         f"messages {tuple(messages.shape)}")
    g = g.to(msg.dtype).contiguous()
    _build.require_cuda("fused_knn_softmax_aggregate_bwd", msg, em, tt, g)
    dmsg = torch.empty_like(msg)
    dt = torch.zeros(1, dtype=torch.float32, device=msg.device)
    if g.numel() == 0:
        return dmsg, dt
    partials = torch.empty(DT_PARTIALS, dtype=torch.float32, device=msg.device)
    lib = _build.load()
    with torch.cuda.device(msg.device):
        rc = lib.advmil_knn_agg_bwd(msg.data_ptr(), em.data_ptr(), tt.data_ptr(),
                                    g.data_ptr(), dmsg.data_ptr(), partials.data_ptr(),
                                    dt.data_ptr(), rows, epn, C,
                                    _build.DTYPE_CODES[msg.dtype], _build.stream_of(msg))
    _build.check(rc, "fused_knn_softmax_aggregate_bwd")
    LAUNCHES_BWD += 1
    return dmsg, dt


class FusedKnnSoftmaxAggregate(torch.autograd.Function):
    """The op on the card: kernel forward, kernel backward (counterpart of the
    JAX package's custom VJP `_fused_agg_vjp_fwd` / `_fused_agg_vjp_bwd`).
    Gradients go to the messages and to t."""

    @staticmethod
    def forward(ctx, messages, edge_mask, t):
        ctx.save_for_backward(messages, edge_mask, t)
        return fused_agg_fwd(messages, edge_mask, t)

    @staticmethod
    @_build.first_order
    def backward(ctx, g):
        messages, edge_mask, t = ctx.saved_tensors
        dmsg, dt = fused_agg_bwd(messages, edge_mask, t, g)
        return dmsg, None, dt.reshape(t.shape).to(t.dtype)


def fused_knn_softmax_aggregate(messages: torch.Tensor, edge_mask: torch.Tensor,
                                t: torch.Tensor) -> torch.Tensor:
    """messages [..., epn, C] (f32 or bf16), edge_mask [..., epn], t one
    element -> [..., C]: the kernels on CUDA, the plain version on the CPU.
    Differentiable in messages and t on both devices."""
    if messages.device.type == "cpu":
        return knn_edge_softmax_aggregate(messages, edge_mask, t)
    if messages.device.type != "cuda":
        raise ValueError(f"fused_knn_softmax_aggregate: unsupported device {messages.device}")
    return FusedKnnSoftmaxAggregate.apply(messages, edge_mask, t)


# ---------------------------------------------------------------------------
# host-side band tables (numpy; copies of advmil_tpu/ops/segment.py)
# ---------------------------------------------------------------------------

def build_band_tables(edge_src: np.ndarray, edge_mask: np.ndarray,
                      res_slots: int | None = None, multiple: int = 128):
    """Split a dense [N, epn] edge table into a banded part and residuals.

    Raster-ordered spatial kNN graphs are near-banded: for interior nodes,
    slot s points to n + o_s for one offset per slot. o_s is the modal offset
    of slot s's real edges; an edge is banded when it sits on its slot's band
    and in range, and every other real edge is a residual.

    Returns (offs [epn] int32, band_mask [N, epn] f32, res_node [R] int32,
    res_src [R] int32, res_mask [R] f32), R = res_slots or the residual count
    rounded up to `multiple`."""
    N, epn = edge_src.shape
    n_idx = np.arange(N, dtype=np.int64)[:, None]
    valid = edge_mask > 0
    d = edge_src.astype(np.int64) - n_idx
    offs = np.zeros(epn, np.int32)
    for s in range(epn):
        col = d[valid[:, s], s]
        if col.size:
            vals, counts = np.unique(col, return_counts=True)
            offs[s] = vals[np.argmax(counts)]
    target = n_idx + offs[None, :].astype(np.int64)
    banded = valid & (edge_src == target) & (target >= 0) & (target < N)
    rn, rs = np.nonzero(valid & ~banded)
    n_res = len(rn)
    if res_slots is None:
        res_slots = -(-max(n_res, 1) // multiple) * multiple
    assert n_res <= res_slots, f"need {n_res} residual slots, given {res_slots}"
    res_node = np.zeros(res_slots, np.int32)
    res_src = np.zeros(res_slots, np.int32)
    res_mask = np.zeros(res_slots, np.float32)
    res_node[:n_res] = rn
    res_src[:n_res] = edge_src[rn, rs]
    res_mask[:n_res] = 1.0
    return offs, banded.astype(np.float32), res_node, res_src, res_mask


def band_coverage(edge_src: np.ndarray, edge_mask: np.ndarray):
    """(banded fraction of the real edges, residual edges, residual rows,
    max |offset|) of a dense edge table: the batcher's pre-scan statistics."""
    offs, bmask, _, _, res_mask = build_band_tables(edge_src, edge_mask)
    n_valid = int((edge_mask > 0).sum())
    n_band = int(bmask.sum())
    n_rows = len(np.unique(np.nonzero((edge_mask > 0) & (bmask <= 0))[0]))
    return ((n_band / max(n_valid, 1)), int(res_mask.sum()), n_rows,
            int(np.abs(offs).max(initial=0)))
