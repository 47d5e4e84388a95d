"""MIL encoder backbones: ABMIL (`bcb_mode: abmil`), DeepAttnMISL
(`bcb_mode: cluster`), ESAT (`DualTransHS`, bcb_mode `patch`) and PatchGCN
(`bcb_mode: graph`).

Call convention as in `advmil_tpu/models/backbones.py`: backbone(x, mask,
extra) with x [B, N, C] padded patch features and mask [B, N] (1 = real
patch); returns the bag embedding [B, dim_out]. ABMIL ignores `extra`. In
cluster mode `extra` is the patches' cluster ids [B, N] (int, -1 on
padding). In patch mode `extra` is None or the region coordinates [B, L, 2]
(`use_coords_pe`). In graph mode it is the batch's dict of graph tables
(data/bags.py): the band tables of the banded route, the grid-space band
tables and the grid maps of the grid route, or `edge_src` / `edge_mask` of
the dense route. `dense_init` selects the init of every
Dense except the patch embedding's (torch init), the packed attention
in-projection (xavier) and DeepAttnMISL's `phis` (see there), as in the
JAX factory.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.banded import banded_aggregate
from ..ops.masked import region_mask_from_patch_mask
from ..ops.segment import (fused_knn_softmax_aggregate, grid_place, grid_take,
                           knn_edge_softmax_aggregate)
from ..ops.pe import compute_pe
from ..parallel import comm, mesh
from .layers import (TORCH, XAVIER, Dense, Dropout, GAPool, GatedAttention, LayerNorm,
                     Rngs, TransformerEncoderLayer, attention_pool, make_embedding_layer)


class ABMIL(nn.Module):
    """Gated-attention MIL: `attn_fc` (Dense + ReLU + Dropout) per instance,
    gated attention scores (`gate`), a masked softmax over the instances,
    the attention-weighted sum (over the inst group under an inst grid),
    then `rho` (Dense + ReLU + Dropout)."""

    def __init__(self, dims: Sequence[int], dropout: float = 0.25,
                 dense_init: str = XAVIER, dtype=torch.float32):
        super().__init__()
        dim_in, dim_hid, dim_out = dims
        self.attn_fc = Dense(dim_in, dim_hid, dense_init, dtype)
        self.gate = GatedAttention(dim_hid, dim_hid, dropout=dropout,
                                   dense_init=dense_init, dtype=dtype)
        self.rho = Dense(dim_hid, dim_out, dense_init, dtype)
        self.drop = Dropout(dropout)

    def forward(self, x, mask, extra=None, rng: Rngs | None = None):
        h = self.drop(torch.relu(self.attn_fc(x)), rng, inst_dim=1)
        pooled = attention_pool(self.gate(h, rng)[..., 0], mask, h)
        return self.drop(torch.relu(self.rho(pooled)), rng)


class DeepAttnMISL(nn.Module):
    """Cluster MIL: `phis` (Dense + ReLU) per patch, the masked mean of each
    of the `num_clusters` clusters (an empty cluster gives 0 and still takes
    part in the softmax), `attn_fc` (Dense + ReLU + Dropout) per cluster,
    gated attention scores (`gate`), a softmax over the clusters and the
    attention-weighted sum.

    Init rule of the JAX package: the reference's `phis` is a Conv2d, which
    its xavier re-init (Linear only) leaves at torch's default, so under
    XAVIER `phis` draws torch's default init; under PT041 (which re-inits
    Conv2d too) it follows PT041.

    Under an inst grid `phis` runs on the rank's patches, the clusters'
    totals and counts are summed over the inst group before the division,
    and the rest runs on the bag's clusters, which every rank then holds
    whole."""

    def __init__(self, dims: Sequence[int], num_clusters: int = 8, dropout: float = 0.25,
                 dense_init: str = XAVIER, dtype=torch.float32):
        super().__init__()
        dim_in, dim_hid, dim_out = dims
        assert dim_hid == dim_out
        self.num_clusters = num_clusters
        self.phis = Dense(dim_in, dim_hid, TORCH if dense_init == XAVIER else dense_init,
                          dtype)
        self.attn_fc = Dense(dim_hid, dim_hid, dense_init, dtype)
        self.gate = GatedAttention(dim_hid, dim_hid, dropout=dropout,
                                   dense_init=dense_init, dtype=dtype)
        self.drop = Dropout(dropout)

    def forward(self, x, mask, extra, rng: Rngs | None = None):
        phi = torch.relu(self.phis(x))                                  # [B, N, hid]
        cid = torch.where(mask.bool(), extra.long(), torch.full_like(extra.long(), -1))
        # one-hot of -1 is all zeros: padding joins no cluster
        onehot = (cid[..., None] == torch.arange(self.num_clusters, device=x.device)
                  ).to(phi.dtype)                                       # [B, N, K]
        totals = comm.inst_sum(torch.einsum("bnk,bnd->bkd", onehot, phi))
        counts = comm.inst_sum(onehot.sum(dim=1))                       # [B, K]
        h_cluster = totals / torch.clamp(counts, min=1.0)[..., None]
        h = self.drop(torch.relu(self.attn_fc(h_cluster)), rng)
        attn = torch.softmax(self.gate(h, rng, inst_dim=None)[..., 0], dim=-1)   # [B, K]
        return torch.einsum("bk,bkd->bd", attn, h)


class DualTransHS(nn.Module):
    """Transformer-based ESAT: 4x4-region patch embedding -> optional 2-D
    sin-cos positional embedding of the region coordinates (`extra`
    [B, L, 2]) -> transformer encoder layer(s) -> global attention pooling.
    Under an inst grid the embedding and the positional embedding stay
    local (whole regions per rank); the attention and the pooling run over
    the inst group."""

    def __init__(self, dims: Sequence[int], nhead: int = 8, num_layers: int = 1,
                 emb_ksize: int = 1, emb_backbone: str = "avgpool",
                 tra_backbone: str = "Transformer", dropout: float = 0.25,
                 use_pallas: bool = True, use_fused_embed: bool = False,
                 use_lnpool: bool = True, flash_min_len: int = 512,
                 dense_init: str = XAVIER, dtype=torch.float32):
        super().__init__()
        dim_in, dim_hid, dim_out = dims
        assert dim_hid == dim_out
        assert tra_backbone in ("Transformer", "Identity")
        self.dim_hid = dim_hid
        self.patch_embedding = make_embedding_layer(
            emb_backbone, dim_in, dim_hid, ksize=emb_ksize, use_fused=use_fused_embed,
            use_lnpool=use_lnpool, dtype=dtype)
        self.num_layers = num_layers if tra_backbone == "Transformer" else 0
        for i in range(self.num_layers):
            self.add_module(f"encoder_{i}", TransformerEncoderLayer(
                dim_hid, nhead, dim_hid, dropout=dropout, use_pallas=use_pallas,
                flash_min_len=flash_min_len, dense_init=dense_init, dtype=dtype))
        self.pool = GAPool(dim_out, dim_out, dropout=dropout, dense_init=dense_init,
                           dtype=dtype)

    def forward(self, x, mask, extra=None, rng: Rngs | None = None):
        h = self.patch_embedding(x, mask)                 # [B, L, hid]
        rmask = region_mask_from_patch_mask(mask)         # [B, L]
        if extra is not None:                             # region coords [B, L, 2]
            origin = None
            if mesh.inst_grid() is not None:              # the whole bag's minimum corner
                origin = -comm.inst_max(-extra.amin(dim=-2, keepdim=True))
            pe = compute_pe(extra, ndim=self.dim_hid, dtype=h.dtype, origin=origin)
            h = h + pe * rmask[..., None].to(h.dtype)
        for i in range(self.num_layers):
            h = getattr(self, f"encoder_{i}")(h, rmask, rng)
        return self.pool(h, rmask, rng)


class GENConv(nn.Module):
    """GENConv with softmax aggregation and a learnable temperature t
    (DeeperGCN, torch_geometric semantics): m_j = relu(x_j) + eps; per node
    and channel, alpha = softmax over the incoming edges of t * m; out_i =
    MLP(x_i + sum alpha * m), MLP = Dense(C, 2C) -> LayerNorm -> ReLU ->
    Dense(2C, C).

    Three routes, chosen per batch by the batcher's tables: the banded route
    (`band_offs` present) aggregates without gathering the messages
    (ops/banded.py, kernels #14/#15 and, for the residual rows, #12/#13);
    the grid route (`band_gidx` present as well) places the messages on the
    slides' grids (`grid_place`), aggregates there as the banded route does
    and takes the result back to the bag rows (`grid_take`); the dense
    route gathers [B, N, epn, C] messages and aggregates them
    (ops/segment.py, kernels #12/#13). Given band tables without
    `band_gidx`, x is taken to lie on the grid already (PatchGCN's
    `grid_resident`). `use_pallas` False takes the plain versions on every
    device.

    Under an inst grid x holds the rank's block of node rows (of grid rows
    under `grid_resident`) and the input is all-gathered over the group
    (`comm.inst_gather`; its backward reduce-scatters). The dense route
    gathers messages for the rank's rows only (its `edge_src` rows, global
    indices); the banded and grid routes aggregate the whole bag, as their
    tables are the bag's, and keep the rank's rows."""

    def __init__(self, dim: int, eps: float = 1e-7, use_pallas: bool = True,
                 dense_init: str = XAVIER, dtype=torch.float32):
        super().__init__()
        self.eps, self.use_pallas = eps, use_pallas
        self.t = nn.Parameter(torch.ones(1))
        self.mlp0 = Dense(dim, 2 * dim, dense_init, dtype)
        self.mlp_norm = LayerNorm(2 * dim, dtype)
        self.mlp1 = Dense(2 * dim, dim, dense_init, dtype)

    def forward(self, x, graph: dict):
        xr = comm.inst_gather(torch.relu(x))          # the whole bag's rows
        if "band_offs" in graph:
            y = xr + self.eps
            if "band_gidx" in graph:
                y = grid_place(y, graph["band_gidx"], graph["band_ginv"])
            aggr = banded_aggregate(y, graph["band_offs"], graph["band_mask"],
                                    graph["band_urows"], graph["band_usrc"],
                                    graph["band_uemask"], graph["band_uinv"], self.t,
                                    use_kernels=self.use_pallas)
            if "band_gidx" in graph:
                aggr = grid_take(aggr, graph["band_gidx"], graph["band_ginv"])
            aggr = aggr[:, mesh.inst_slice(aggr.shape[1])]
        else:
            src = graph["edge_src"].long()                            # [B, n, epn]
            B, N, epn = src.shape
            # the messages in f32, as the banded route's residual rows: the
            # gather's backward then sums a row's gradients in f32 and rounds once
            msg = torch.gather(xr.float(), 1,
                               src.reshape(B, -1, 1).expand(B, N * epn, x.shape[-1]))
            msg = msg.reshape(B, N, epn, -1) + self.eps
            agg = fused_knn_softmax_aggregate if self.use_pallas else knn_edge_softmax_aggregate
            aggr = agg(msg, graph["edge_mask"], self.t).to(x.dtype)
        h = self.mlp0(x + aggr)
        return self.mlp1(torch.relu(self.mlp_norm(h)))


class DeepGCNBlock(nn.Module):
    """DeepGCNLayer(block='res'): Dropout(x + relu(LayerNorm(conv(x)))),
    dropout 0.1."""

    def __init__(self, dim: int, dropout: float = 0.1, use_pallas: bool = True,
                 dense_init: str = XAVIER, dtype=torch.float32):
        super().__init__()
        self.conv = GENConv(dim, use_pallas=use_pallas, dense_init=dense_init, dtype=dtype)
        self.norm = LayerNorm(dim, dtype)
        self.drop = Dropout(dropout)

    def forward(self, x, graph: dict, rng: Rngs | None = None):
        h = torch.relu(self.norm(self.conv(x, graph)))
        return self.drop(x + h, rng, inst_dim=1)


class PatchGCN(nn.Module):
    """Graph MIL encoder: Dense embedding, a bare GENConv then
    `num_layers - 1` DeepGCN blocks, the concatenation of every layer's
    output, `path_phi`, gated attention and a masked softmax over the nodes.

    The batch dimension goes into the aggregation ops directly (the JAX
    package vmaps one graph at a time with shared parameters); there is no
    loop over bags.

    `grid_resident` (grid route only): place the embedding on the grid rows
    once, run the whole stack there with no per-layer place / take, and pool
    over the grid rows with the mask placed through the same map. With
    dropout off it computes what the per-layer route computes; dropout
    draws at the grid's shape.

    Under an inst grid each rank holds its block of the bag's node rows
    (whole 16-row blocks; under `grid_resident`, once placed, its block of
    the grid's rows): `fc`, the convolutions' MLPs, the LayerNorms and
    `path_phi` run on those rows, GENConv gathers its input over the group,
    dropout draws at the global shape (`mesh.rand_global`), and the gated
    attention's softmax and sum run over the group (`attention_pool`)."""

    def __init__(self, dims: Sequence[int], num_layers: int = 1, dropout: float = 0.25,
                 use_pallas: bool = True, dense_init: str = XAVIER,
                 grid_resident: bool = False, dtype=torch.float32):
        super().__init__()
        dim_in, dim_hid, dim_out = dims
        self.num_layers = num_layers
        self.grid_resident = grid_resident
        self.fc = Dense(dim_in, dim_hid, dense_init, dtype)
        self.layer0_conv = GENConv(dim_hid, use_pallas=use_pallas, dense_init=dense_init,
                                   dtype=dtype)
        for i in range(1, num_layers):
            self.add_module(f"layer{i}", DeepGCNBlock(dim_hid, use_pallas=use_pallas,
                                                      dense_init=dense_init, dtype=dtype))
        self.path_phi = Dense(dim_hid * (1 + num_layers), dim_out, dense_init, dtype)
        self.gate = GatedAttention(dim_out, dim_out, dropout=dropout,
                                   dense_init=dense_init, dtype=dtype)
        self.drop = Dropout(dropout)

    def forward(self, x, mask, extra: dict, rng: Rngs | None = None):
        h = self.drop(torch.relu(self.fc(x)), rng, inst_dim=1)
        if self.grid_resident and "band_gidx" in extra:
            gidx, ginv = extra["band_gidx"], extra["band_ginv"]
            extra = {k: v for k, v in extra.items() if k not in ("band_gidx", "band_ginv")}
            h = grid_place(comm.inst_gather(h), gidx, ginv)
            h = h[:, mesh.inst_slice(h.shape[1])]
            mask = grid_place(comm.inst_gather(mask)[..., None], gidx, ginv)[..., 0]
            mask = mask[:, mesh.inst_slice(mask.shape[1])]
        cur = self.layer0_conv(h, extra)
        feats = [h, cur]
        for i in range(1, self.num_layers):
            cur = getattr(self, f"layer{i}")(cur, extra, rng)
            feats.append(cur)
        h_path = self.drop(torch.relu(self.path_phi(torch.cat(feats, dim=-1))), rng,
                           inst_dim=1)
        return attention_pool(self.gate(h_path, rng)[..., 0], mask, h_path)


def load_backbone(mode: str, dims: Sequence[int], dense_init: str = XAVIER,
                  use_pallas: bool = True, use_fused_embed: bool = False,
                  use_lnpool: bool = True, tra_backbone: str = "Transformer",
                  flash_min_len: int = 512, num_graph_layers: int = 1,
                  grid_resident: bool = False, dtype=torch.float32) -> nn.Module:
    """Backbone factory with the reference's default hyperparameters (dropout
    0.25, as `advmil_tpu/models/backbones.py::load_backbone`)."""
    dims = list(dims)[:3]
    if mode == "patch":
        return DualTransHS(dims, nhead=8, num_layers=1, tra_backbone=tra_backbone,
                           dropout=0.25, use_pallas=use_pallas,
                           use_fused_embed=use_fused_embed, use_lnpool=use_lnpool,
                           flash_min_len=flash_min_len, dense_init=dense_init,
                           dtype=dtype)
    if mode == "graph":
        return PatchGCN(dims, num_layers=num_graph_layers, dropout=0.25,
                        use_pallas=use_pallas, dense_init=dense_init,
                        grid_resident=grid_resident, dtype=dtype)
    if mode == "abmil":
        return ABMIL(dims, dropout=0.25, dense_init=dense_init, dtype=dtype)
    if mode == "cluster":
        return DeepAttnMISL(dims, num_clusters=8, dropout=0.25, dense_init=dense_init,
                            dtype=dtype)
    raise ValueError(f"unknown backbone mode {mode!r} (patch / graph / abmil / cluster)")
