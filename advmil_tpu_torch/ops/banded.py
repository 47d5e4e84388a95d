"""Banded softmax aggregation of GENConv for near-banded (raster-ordered
spatial kNN) graphs, and its host-side residual-row tables.

Counterpart of `advmil_tpu/ops/banded_pallas.py::pallas_banded_aggregate`.
The batcher decomposes each bag's dense edge table into per-slot offsets
`offs [epn]` and `band_mask [N, epn]` (the edges that sit on their slot's
band) plus the rows that own an edge off the band (`u_rows`, with their
full edge-table slices `u_src` / `u_emask` and the inverse map `u_inv`).
`banded_aggregate` then equals `knn_edge_softmax_aggregate` on the full
dense table: the banded core (`banded_core`) computes every row from its
banded edges without a gather, the rows in `u_rows` are recomputed exactly
from their gathered messages through `fused_knn_softmax_aggregate`, and
overwrite the core's values. Autograd splits the cotangent the same way:
overwritten rows go to the exact part and the rest to the core's backward,
which differentiates the pre-overwrite core output.

Dispatch of `banded_core`: a CPU tensor goes to `banded_core_plain`
(autograd through plain torch ops); a CUDA tensor goes to `BandedCore`,
whose forward and backward are the hand-written kernels of
`csrc/banded.cu`, or raises. The kernels stage a window of rows in shared
memory and read a row that lies outside it straight from device memory, so
unlike the TPU kernel (one 128-row block of neighbours) they take any
offset. The forward saves lse = m + log(den) and the f32 output for the
backward; `banded_core_stats_plain` and `banded_core_bwd_plain` are the
plain versions of that arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .segment import (DT_PARTIALS, MAX_EPN, fused_knn_softmax_aggregate,
                      knn_edge_softmax_aggregate)

LAUNCHES = 0       # forward kernel launches since the last reset (chip_smoke reads it)
LAUNCHES_BWD = 0   # backward kernel launches since the last reset


def _band_sources(offs: torch.Tensor, band_mask: torch.Tensor):
    """(src [B, N, epn] clamped into the bag, on [B, N, epn] bool): the source
    row n + offs[b, s] of each slot, and whether the slot is banded and its
    source lies inside the bag."""
    N = band_mask.shape[1]
    n = torch.arange(N, device=band_mask.device)
    src = n[None, :, None] + offs[:, None, :].long()
    on = (band_mask > 0) & (src >= 0) & (src < N)
    return src.clamp(0, N - 1), on


def banded_core_plain(y: torch.Tensor, offs: torch.Tensor, band_mask: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    """Plain version of the banded core: y [B, N, C], offs [B, epn],
    band_mask [B, N, epn] -> [B, N, C] in y's dtype, from the banded edges
    only (the dense softmax aggregation of the gathered band rows). The
    gather runs in f32, so its backward sums a row's slot gradients in f32
    and rounds once, as the kernel does."""
    return banded_core_stats_plain(y, offs, band_mask, t)[0]


def banded_core_stats_plain(y: torch.Tensor, offs: torch.Tensor, band_mask: torch.Tensor,
                            t: torch.Tensor):
    """Plain version of the forward kernel with its statistics: (out [B, N, C]
    in y's dtype, (lse, out32)), lse = m + log(max(den, 1e-16)) and out32 the
    output before its rounding, both [B, N, C] f32. m is the max of t * v over
    a node's banded slots (0 without one) and den the sum of exp(t * v - m),
    so exp(t * v - lse) is a slot's softmax weight; a node without edges has
    lse = log(1e-16) and is read by no slot of the backward."""
    B, N, C = y.shape
    src, on = _band_sources(offs, band_mask)
    msg = torch.gather(y.float(), 1, src.reshape(B, -1, 1).expand(B, src[0].numel(),
                                                                   C)).reshape(B, N, -1, C)
    mb = on[..., None]
    masked = torch.where(mb, msg * t.float().reshape(()), float("-inf"))
    m = masked.amax(dim=2)
    m = torch.where(torch.isfinite(m), m, torch.zeros((), device=m.device))
    ex = torch.exp(masked - m[:, :, None])
    den = ex.sum(dim=2).clamp_min(1e-16)
    out32 = (ex * msg).sum(dim=2) / den
    return out32.to(y.dtype), (m + torch.log(den), out32)


def banded_core_bwd_plain(y: torch.Tensor, offs: torch.Tensor, band_mask: torch.Tensor,
                          t: torch.Tensor, stats, g: torch.Tensor):
    """Plain version of the backward kernel, from the forward's statistics
    (lse, out32): (dy in y's dtype, dt [1] f32) for the cotangent g, in the
    kernel's gather form. Row r was read by slot s of node n = r - offs[s]
    (where n lies in the bag and band_mask[n, s] > 0) with the weight
    p = exp(t * y[r] - lse[n]); with h = g[n] * (y[r] - out[n]),
        dy[r] = sum_s p * (g[n] + t * h),   dt = sum_{r, s} p * h * y[r].
    Each (n, s) lands in exactly one row r: no scatter."""
    lse, out32 = stats
    B, N, C = y.shape
    epn = band_mask.shape[2]
    r = torch.arange(N, device=y.device)
    n = r[None, :, None] - offs[:, None, :].long()                    # [B, N, epn]
    nc = n.clamp(0, N - 1)
    on = (n >= 0) & (n < N) & (torch.gather(band_mask, 1, nc) > 0)
    yr, tt = y.float()[:, :, None], t.float().reshape(())
    idx = nc.reshape(B, -1, 1).expand(B, N * epn, C)
    at = lambda a: torch.gather(a.float(), 1, idx).reshape(B, N, epn, C)  # noqa: E731
    gn = at(g)
    p = torch.where(on[..., None], torch.exp(yr * tt - at(lse)), 0.0)
    h = gn * (yr - at(out32))
    dy = (p * (gn + tt * h)).sum(dim=2)
    dt = (p * h * yr).sum().reshape(1)
    return dy.to(y.dtype), dt


def banded_tol(want: torch.Tensor) -> dict:
    """atol / rtol of the bf16 kernels against the plain version on the same
    inputs (`banded_core_plain` and its autograd backward). Both compute in
    f32 and round once to bf16; only the order of the f32 sums differs. So a
    value may land one bf16 ulp away, on the other side of a rounding edge
    (2^-7 relative), and sums that cancel to near 0 keep the f32 noise of
    their terms (2^-10 of the largest |value| absolute). A slot dropped or
    read from the wrong row is off by a share of the values themselves."""
    return dict(rtol=2.0 ** -7, atol=float(want.detach().abs().max()) / 1024)


def _check(name, y, offs, band_mask, t):
    if y.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {y.device}")
    if y.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {y.dtype}")
    if y.dim() != 3 or band_mask.dim() != 3 or band_mask.shape[:2] != y.shape[:2] \
            or offs.shape != (y.shape[0], band_mask.shape[2]):
        raise ValueError(f"{name}: y [B, N, C], offs [B, epn], band_mask [B, N, epn], "
                         f"got {tuple(y.shape)}, {tuple(offs.shape)}, "
                         f"{tuple(band_mask.shape)}")
    if not 1 <= band_mask.shape[2] <= MAX_EPN:
        raise ValueError(f"{name}: the kernels take 1 to {MAX_EPN} slots per node")
    if t.numel() != 1:
        raise ValueError(f"{name}: t must hold one element")


def _operands(y, offs, band_mask, t):
    return (y.contiguous(), offs.to(torch.int32).contiguous(),
            band_mask.to(torch.float32).contiguous(),
            t.detach().to(torch.float32).reshape(1).contiguous())


def banded_core_fwd(y: torch.Tensor, offs: torch.Tensor, band_mask: torch.Tensor,
                    t: torch.Tensor, save_stats: bool = False):
    """Launch the forward kernel: (out [B, N, C] in y's dtype, stats), stats =
    (lse, out32) [B, N, C] f32 for the backward when `save_stats`, else None
    (as `banded_core_stats_plain`); out32 is out before its rounding to y's
    dtype (out itself for f32)."""
    global LAUNCHES
    _check("banded_core", y, offs, band_mask, t)
    y, offs, bm, tt = _operands(y, offs, band_mask, t)
    _build.require_cuda("banded_core", y, offs, bm, tt)
    B, N, C = y.shape
    out = torch.empty_like(y)
    stats = None
    if save_stats:
        f32 = lambda: torch.empty(y.shape, dtype=torch.float32, device=y.device)  # noqa: E731
        stats = (f32(), out if y.dtype == torch.float32 else f32())
    if y.numel() == 0:
        return out, stats
    lse = out32 = None   # null pointers: the kernel skips those stores
    if stats:
        lse = stats[0].data_ptr()
        out32 = None if stats[1] is out else stats[1].data_ptr()
    lib = _build.load()
    with torch.cuda.device(y.device):
        rc = lib.advmil_banded_fwd(y.data_ptr(), offs.data_ptr(), bm.data_ptr(),
                                   tt.data_ptr(), out.data_ptr(), lse, out32, B, N, C,
                                   bm.shape[2], _build.DTYPE_CODES[y.dtype],
                                   _build.stream_of(y))
    _build.check(rc, "banded_core")
    LAUNCHES += 1
    return out, stats


def banded_core_bwd(y, offs, band_mask, t, stats, g):
    """Launch the backward kernel from the forward's stats (lse, out32):
    (dy in y's dtype, dt [1] f32) for the cotangent g [B, N, C] (taken in
    y's dtype); `banded_core_bwd_plain` is its plain version."""
    global LAUNCHES_BWD
    _check("banded_core_bwd", y, offs, band_mask, t)
    y, offs, bm, tt = _operands(y, offs, band_mask, t)
    lse, out = (s.to(torch.float32).contiguous() for s in stats)
    if not (g.shape == out.shape == lse.shape == y.shape):
        raise ValueError("banded_core_bwd: g and the stats must have y's shape")
    g = g.to(y.dtype).contiguous()
    _build.require_cuda("banded_core_bwd", y, offs, bm, tt, lse, out, g)
    B, N, C = y.shape
    dy = torch.empty_like(y)
    dt = torch.zeros(1, dtype=torch.float32, device=y.device)
    if y.numel() == 0:
        return dy, dt
    partials = torch.empty(DT_PARTIALS, dtype=torch.float32, device=y.device)
    lib = _build.load()
    with torch.cuda.device(y.device):
        rc = lib.advmil_banded_bwd(y.data_ptr(), offs.data_ptr(), bm.data_ptr(),
                                   tt.data_ptr(), lse.data_ptr(), out.data_ptr(), g.data_ptr(),
                                   dy.data_ptr(), partials.data_ptr(), dt.data_ptr(), B, N, C,
                                   bm.shape[2], _build.DTYPE_CODES[y.dtype],
                                   _build.stream_of(y))
    _build.check(rc, "banded_core_bwd")
    LAUNCHES_BWD += 1
    return dy, dt


class BandedCore(torch.autograd.Function):
    """The banded core on the card: kernel forward, kernel backward.
    Gradients go to y and t. The forward writes the stats the backward
    reads (lse, f32 out) only when `save_stats`, i.e. when a backward can
    run."""

    @staticmethod
    def forward(ctx, y, offs, band_mask, t, save_stats):
        out, stats = banded_core_fwd(y, offs, band_mask, t, save_stats=save_stats)
        if save_stats:
            ctx.save_for_backward(y, offs, band_mask, t, *stats)
        return out

    @staticmethod
    def backward(ctx, g):
        y, offs, band_mask, t, *stats = ctx.saved_tensors
        dy, dt = banded_core_bwd(y, offs, band_mask, t, stats, g)
        return dy, None, None, dt.reshape(t.shape).to(t.dtype), None


def banded_core(y: torch.Tensor, offs: torch.Tensor, band_mask: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """The banded core: the kernels on CUDA, the plain version on the CPU."""
    if y.device.type == "cpu":
        return banded_core_plain(y, offs, band_mask, t)
    if y.device.type != "cuda":
        raise ValueError(f"banded_core: unsupported device {y.device}")
    grad = torch.is_grad_enabled() and (y.requires_grad or t.requires_grad)
    return BandedCore.apply(y, offs, band_mask, t, grad)


def banded_aggregate(y: torch.Tensor, offs: torch.Tensor, band_mask: torch.Tensor,
                     u_rows: torch.Tensor, u_src: torch.Tensor, u_emask: torch.Tensor,
                     u_inv: torch.Tensor, t: torch.Tensor,
                     use_kernels: bool = True) -> torch.Tensor:
    """The softmax aggregation of the full dense edge table, banded.

    y [B, N, C] per-source messages (relu(x) + eps); offs [B, epn] int;
    band_mask [B, N, epn]; u_rows [B, U] the rows owning an edge off the band
    (sentinel N pads); u_src / u_emask [B, U, epn] their full edge-table
    slices (sentinel slots have mask 0); u_inv [B, N] the slot of each row in
    u_rows (sentinel U elsewhere), which alone selects the overwritten rows
    (u_rows stays in the signature of the JAX op); t one element.
    `use_kernels` False takes the plain core on every device.
    Differentiable in y and t."""
    B, N, C = y.shape
    U = u_src.shape[1]
    core = banded_core if use_kernels else banded_core_plain
    exact = fused_knn_softmax_aggregate if use_kernels else knn_edge_softmax_aggregate
    out_b = core(y, offs, band_mask, t)
    # the residual rows' messages in f32: the gather's backward then sums a
    # row's gradients in f32 and rounds once, like the core's
    msg = torch.gather(y.float(), 1,
                       u_src.long().reshape(B, -1, 1).expand(B, u_src[0].numel(), C))
    out_u = exact(msg.reshape(B, U, -1, C), u_emask, t).to(y.dtype)   # [B, U, C]
    sel = (u_inv < U)[..., None]
    rows = u_inv.long().clamp(0, U - 1)[..., None].expand(B, N, C)
    return torch.where(sel, torch.gather(out_u, 1, rows), out_b)


# ---------------------------------------------------------------------------
# host-side residual-row tables (numpy; copies of advmil_tpu/ops/banded_pallas.py)
# ---------------------------------------------------------------------------

def build_u_tables(edge_src: np.ndarray, edge_mask: np.ndarray, band_mask: np.ndarray,
                   u_slots: int | None = None, multiple: int = 8):
    """Row-level residual tables: (u_rows [U] int32, sentinel N for padding,
    u_src [U, epn] int32 clipped into range, u_emask [U, epn] f32), the rows
    owning at least one real edge off the band, with their full edge-table
    slices, U = u_slots or the row count rounded up to `multiple`."""
    N, epn = edge_src.shape
    resid = (edge_mask > 0) & (band_mask <= 0)
    rows = np.unique(np.nonzero(resid)[0]).astype(np.int32)
    U = len(rows)
    if u_slots is None:
        u_slots = -(-max(U, 1) // multiple) * multiple
    assert U <= u_slots, f"need {U} residual-row slots, given {u_slots}"
    u_rows = np.full(u_slots, N, np.int32)
    u_src = np.zeros((u_slots, epn), np.int32)
    u_emask = np.zeros((u_slots, epn), np.float32)
    u_rows[:U] = rows
    u_src[:U] = np.clip(edge_src[rows], 0, max(N - 1, 0))
    u_emask[:U] = edge_mask[rows]
    return u_rows, u_src, u_emask


def build_u_inv(u_rows: np.ndarray, n_nodes: int) -> np.ndarray:
    """Inverse of u_rows: [N] int32, the slot of each residual row in u_rows,
    sentinel U elsewhere."""
    U = int(u_rows.shape[0])
    u_inv = np.full(n_nodes, U, np.int32)
    valid = u_rows < n_nodes
    u_inv[u_rows[valid]] = np.nonzero(valid)[0].astype(np.int32)
    return u_inv
