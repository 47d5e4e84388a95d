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

`build_band_tables`, `band_coverage`, `build_band_tables_matched`,
`grid_layout` and `crop_empty_grid_lines` are numpy copies of the JAX
package's host functions (the port imports no JAX; the matched builder
without the residual edge lists of JAX's rolls path), used by the batcher's
pre-scans and tables. `grid_place` / `grid_take` move a batch between its
bag rows and the slides' bounding-box grids (the grid route), as gathers
both ways.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

LAUNCHES = 0       # forward kernel launches since the last reset (chip_smoke reads it)
LAUNCHES_BWD = 0   # backward kernel launches since the last reset
MAX_EPN = 16       # incoming slots per node the kernels take (csrc/graph_agg.cuh)
DT_PARTIALS = 1024  # per-block dt partials the banded backward (#15) writes at most
MAX_ELEMS = 2 ** 31 - 1  # the kernels' 32-bit index math: rows * epn * C below this


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


def knn_bwd_tol(want: torch.Tensor) -> dict:
    """atol / rtol of the bf16 backward kernel's dmessages against the plain
    version's autograd backward on the same bf16 messages and cotangent
    (rounded to bf16 once), of the same form as `knn_tol`. Both compute
    dm = g alpha_s (1 + t (m_s - out)) in f32 and round once; they differ only
    in the f32 rounding of the exponentials and of the sums behind alpha and
    out (a few f32 ulps each). So a value may land one bf16 ulp away, on the
    other side of a rounding edge (2^-7 relative). Where 1 + t (m_s - out)
    cancels to near 0, the factor keeps the f32 noise of its terms (~2^-22 of
    1 + t |m_s| + t |out|); that stays below 2^-10 of the largest |dm| (the
    absolute part) unless |g alpha_s| (1 + t |m_s| + t |out|) exceeds the
    largest |dm| 4,096-fold. A slot dropped or its mask ignored moves every
    alpha of the row by a share of itself (~1/epn), t dropped moves the
    factor by (t - 1)(m_s - out), and another row's out moves it by t times
    the gap between the two outs. The bound is `knn_tol`'s on purpose: the
    same two roundings set it; this name carries the backward's derivation."""
    return knn_tol(want)


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
    if messages.numel() > MAX_ELEMS:
        raise ValueError(f"{name}: the kernels index rows * epn * C = {messages.numel()} "
                         f"values in 32 bits (at most {MAX_ELEMS})")


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
    if g.numel() == 0:
        return dmsg, torch.zeros(1, dtype=torch.float32, device=msg.device)
    dt = torch.empty(1, dtype=torch.float32, device=msg.device)
    lib = _build.load()
    code = _build.DTYPE_CODES[msg.dtype]
    n_part = lib.advmil_knn_agg_bwd_blocks(rows, C, code)
    partials = torch.empty(n_part, dtype=torch.float32, device=msg.device)
    with torch.cuda.device(msg.device):
        rc = lib.advmil_knn_agg_bwd(msg.data_ptr(), em.data_ptr(), tt.data_ptr(),
                                    g.data_ptr(), dmsg.data_ptr(), partials.data_ptr(),
                                    n_part, dt.data_ptr(), rows, epn, C, code,
                                    _build.stream_of(msg))
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


def build_band_tables_matched(edge_src: np.ndarray, edge_mask: np.ndarray,
                              k: int | None = None):
    """Band tables by offset matching instead of slot position (the grid
    route's tables).

    `build_band_tables` gives slot s the modal offset of the edges that sit
    in column s, which depends on the kNN's neighbour order and collapses on
    tissue graphs (distance ties put one grid neighbour in different columns
    row to row). The aggregation does not depend on slot order, so this
    builder takes the k most frequent offsets of the whole table and sets band_mask[n, s] = 1 iff n + offs[s] is one of n's
    real sources, whatever column holds that edge. When fewer than k offsets
    occur, small distinct offsets fill the rest (a repeated offset would
    count an edge twice).

    Returns (offs [k] int32 sorted, band_mask [N, k] f32 slot space,
    edge_banded [N, epn] f32 edge space, for `build_u_tables`: the edges off
    the bands are the residual rows' u tables). The JAX builder's residual
    edge lists feed its rolls path, which the port does not have."""
    N, epn = edge_src.shape
    if k is None:
        k = epn
    n_idx = np.arange(N, dtype=np.int64)[:, None]
    valid = edge_mask > 0
    d = edge_src.astype(np.int64) - n_idx
    col = d[valid]
    if col.size:
        vals, counts = np.unique(col, return_counts=True)
        top = vals[np.argsort(-counts)[:k]]
    else:
        top = np.zeros(0, np.int64)
    if len(top) < k:
        pads = [o for o in range(-(k + 1), k + 2)
                if o not in set(top.tolist())][:k - len(top)]
        top = np.concatenate([top, np.asarray(pads, np.int64)])
    offs = np.sort(top).astype(np.int32)
    edge_banded = (valid & np.isin(d, offs)).astype(np.float32)
    hit = valid[:, :, None] & (d[:, :, None] == offs[None, None, :].astype(np.int64))
    target = n_idx + offs[None, :].astype(np.int64)
    band_mask = (hit.any(axis=1) & (target >= 0) & (target < N)).astype(np.float32)
    return offs, band_mask, edge_banded


def crop_empty_grid_lines(gidx: np.ndarray, W: int):
    """Drop the grid rows and columns that hold no patch from a slide's
    bounding-box grid: (row [N], col [N], W_cropped, H_cropped). Cells
    that were neighbours stay neighbours (no empty line lies between cells
    one apart), so banded edges keep their offsets, and the grid's area,
    which the banded kernels' work scales with, shrinks."""
    row, col = gidx // W, gidx % W
    ur, uc = np.unique(row), np.unique(col)
    return (np.searchsorted(ur, row), np.searchsorted(uc, col),
            int(len(uc)), int(len(ur)))


def grid_layout(coords: np.ndarray, tol: float = 0.25):
    """Snap a slide's patch coordinates [N, 2] (x, y) to their extraction
    grid: (grid_idx [N] int64 row-major cell, W, H), or None when the
    coordinates do not lie within `tol` steps of a regular grid or two
    patches share a cell. In the grid every neighbour sits at a constant
    offset (+-1, +-W, +-(W +- 1)), which compact numbering of a tissue mask
    loses."""
    if coords is None or coords.ndim != 2 or coords.shape[1] < 2:
        return None
    out_rc, dims = [], []
    for axis in range(2):
        v = coords[:, axis].astype(np.float64)
        lo = v.min()
        u = np.unique(v)
        if len(u) == 1:
            step = 1.0
        else:
            diffs = np.diff(u)
            step = float(np.min(diffs[diffs > 0]))
        idx = np.round((v - lo) / step)
        if np.max(np.abs((v - lo) / step - idx)) > tol:
            return None
        out_rc.append(idx.astype(np.int64))
        dims.append(int(idx.max()) + 1)
    col, row = out_rc
    W, H = dims
    gidx = row * W + col
    if len(np.unique(gidx)) != len(gidx):
        return None
    return gidx, W, H


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, i] = x[b, idx[b, i]] where idx[b, i] < x.shape[1], else 0:
    x [B, M, ...], idx [B, K] -> [B, K, ...] (a sentinel >= M gives 0)."""
    M = x.shape[1]
    valid = idx < M
    safe = idx.long().clamp(max=M - 1)
    tail = x.shape[2:]
    g = torch.gather(x, 1, safe.reshape(safe.shape + (1,) * len(tail)).expand(
        safe.shape + tail))
    return torch.where(valid.reshape(valid.shape + (1,) * len(tail)), g,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class _GridGather(torch.autograd.Function):
    """out = x gathered through `idx`; its backward gathers the cotangent
    through `inv`, the inverse map of the same bijection."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        return _take_rows(x, idx)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return _take_rows(g, inv), None, None


def grid_place(y: torch.Tensor, gidx: torch.Tensor, ginv: torch.Tensor) -> torch.Tensor:
    """Bag rows -> grid cells as a gather: y [B, N, ...], gidx [B, N] (the
    grid cell of each row; sentinel >= G on padded rows), ginv [B, G] (the
    row of each cell; sentinel >= N on cells without tissue) -> [B, G, ...],
    0 on empty cells. gidx and ginv are one bijection on the valid entries,
    so the backward is the gather through gidx: no scatter, no atomics."""
    return _GridGather.apply(y, ginv, gidx)


def grid_take(agg: torch.Tensor, gidx: torch.Tensor, ginv: torch.Tensor) -> torch.Tensor:
    """Grid cells -> bag rows, the inverse of `grid_place`: agg [B, G, ...]
    -> [B, N, ...], 0 on padded rows; the backward gathers through ginv."""
    return _GridGather.apply(agg, gidx, ginv)
