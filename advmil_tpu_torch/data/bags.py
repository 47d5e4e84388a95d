"""Patient-level WSI bag dataset and bucketed padded batching, patch, abmil,
cluster and graph mode (counterpart of `advmil_tpu/data/bags.py`).

Bags are grouped into length buckets (multiples of 16, so padding forms whole
4x4 regions), padded to the bucket length and stacked into [B, N, C] batches
with masks. Ragged tail batches are filled with duplicates of the batch's
first bag carrying sample_mask=0. Batches come out in the same order, with
the same contents, as the JAX package's batcher under the same seed,
including the test-mode occlusion masks drawn per `__getitem__` from the one
`np.random.Generator` the handler passes in, and the shuffled training
order drawn from that generator in the same order as the JAX package.

Cluster mode (DeepAttnMISL) adds each patient's patch cluster ids, read
from `<path_cluster>/<pid>.npy` (one id per patch, in the order of the
concatenated features), shipped as `cluster_id` [B, N] int32, -1 on padding.

Graph mode (PatchGCN) adds each bag's kNN graph, read from per-slide
`<sid>.npz` files ([2, E] (dst, src) rows, as `tools/build_graphs.py`
writes them) or from the reference's torch_geometric `<sid>.pt` files
(`utils/io.py::read_geom_graph`; PyG rows are (src, dst)). The batcher
pre-scans every bag's graph once and picks one route for all of them:

- the banded route when at least 70% of the edges sit on per-slot constant
  offsets in the bags' own node order (raster spatial kNN graphs);
- else the grid route, when every slide's graph file holds its patch
  centroids on a regular grid: each slide is laid out on its bounding-box
  patch grid (empty rows and columns cropped, a patient's slides stacked
  vertically), where every grid neighbour is a constant offset. It engages
  when at least 70% of the edges sit on the offset-matched bands and the
  grids hold at most `grid_max_inflation` times the patches;
- else the dense route.

Per bag it ships, in `Batch.extra`, the band tables (`band_offs`,
`band_mask`, `band_urows`, `band_usrc`, `band_uemask`, `band_uinv`; on the
grid route in grid space, with the maps `band_gidx` (bag row -> grid cell,
`grid_n` on padded rows) and `band_ginv` (grid cell -> bag row, `bucket_n`
on empty cells); the JAX package's residual edge lists `res_*` feed its
rolls path, which the port does not have, and are not shipped) or the
dense `edge_src` / `edge_mask` tables, cached
by dataset index. On the grid route the kernels' work scales with the grid's
area, so each node bucket is split by grid area into batch groups with a
padded grid size each.
"""
from __future__ import annotations

import os.path as osp
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.banded import build_u_inv, build_u_tables
from ..ops.segment import (band_coverage, build_band_tables, build_band_tables_matched,
                           crop_empty_grid_lines, grid_layout)
from ..utils import tracing
from ..utils.func import random_mask_square_instance, sampling_data
from ..utils.io import (import_h5py, read_geom_graph, read_patch_coord, read_patch_feature,
                        retrieve_from_table)

BAND_KEYS = ("band_offs", "band_mask", "band_urows", "band_usrc", "band_uemask",
             "band_uinv")
GRID_KEYS = BAND_KEYS + ("band_gidx", "band_ginv")
DENSE_KEYS = ("edge_src", "edge_mask")


def default_buckets(max_n: int, min_bucket: int = 256,
                    growth: float = 2.0, n_multiple: int = 16) -> list:
    """Geometric bucket sizes (multiples of ``n_multiple``: 16, the 4x4
    region, times the inst rank count, so every padded N splits into whole
    regions per rank) covering max_n; the top bucket is clamped to max_n
    rounded up, and ``min_bucket`` stays a floor."""
    m = max(16, int(n_multiple))
    floor = -(-int(min_bucket) // m) * m
    top = max(-(-int(max_n) // m) * m, floor)
    sizes = []
    b = floor
    while b < top:
        sizes.append(b)
        b = max(b + m, -(-int(b * growth) // m) * m)
    sizes.append(top)
    return sizes


def dense_table(edge_index: np.ndarray, n_rows: int, epn: int, node_map=None):
    """(edge_src, edge_mask [n_rows, epn], dropped) of a dst-sorted [2, E]
    (dst, src) edge table: each node's first `epn` incoming edges in file
    order, one slot each; `dropped` counts the edges beyond them. With
    `node_map` the node ids are mapped through it (the grid cells)."""
    dst, src = edge_index[0], edge_index[1]
    pos = np.arange(dst.shape[0]) - np.searchsorted(dst, dst, side="left")
    keep = pos < epn
    dst, pos, src = dst[keep], pos[keep], src[keep]
    if node_map is not None:
        dst, src = node_map[dst], node_map[src]
    esrc = np.zeros((n_rows, epn), np.int32)
    em = np.zeros((n_rows, epn), np.float32)
    esrc[dst, pos] = src
    em[dst, pos] = 1.0
    return esrc, em, int((~keep).sum())


def grid_tables(edge_index: np.ndarray, rc: np.ndarray, W: int, grid_n: int, bucket_n: int,
                epn: int, u_slots: int | None = None):
    """(tables, dropped): one bag's tables on the grid route. Its nodes sit
    at the cells rc [N, 2] (row, col) of a W-wide grid padded to `grid_n`
    cells; the bag is padded to `bucket_n` rows. The offset-matched band
    tables and their u tables in grid space (`band_*`), the map
    `band_gidx` [bucket_n] (row -> cell, `grid_n` on padded rows) and its
    inverse `band_ginv` [grid_n] (cell -> row, `bucket_n` on empty cells)."""
    gidx = (rc[:, 0] * W + rc[:, 1]).astype(np.int64)
    esrc, em, dropped = dense_table(edge_index, grid_n, epn, gidx)
    offs, bmask, ebanded = build_band_tables_matched(esrc, em, k=epn)
    ur, us, ue = build_u_tables(esrc, em, ebanded, u_slots=u_slots)
    n = rc.shape[0]
    gfull = np.full(bucket_n, grid_n, np.int32)
    gfull[:n] = gidx
    ginv = np.full(grid_n, bucket_n, np.int32)
    ginv[gidx] = np.arange(n, dtype=np.int32)
    return dict(band_offs=offs, band_mask=bmask, band_urows=ur, band_usrc=us, band_uemask=ue,
                band_uinv=build_u_inv(ur, grid_n), band_gidx=gfull, band_ginv=ginv), dropped


class BagDataset:
    """Patient-level bags with labels: per patient the concatenated patch
    features of all their slides and the label (t, e), or (bin, censorship)
    under `time_format: quantile`, plus in cluster mode their patches'
    cluster ids, in graph mode their kNN graph (`edge_index` [2, E],
    dst-sorted) and in patch mode, with `coord_path`, their region
    coordinates."""

    def __init__(self, patient_ids: list, patch_path: str, label_path: str,
                 mode: str = "patch", read_format: str = "pt",
                 time_format: str = "ratio", time_bins: int = 4, ratio_sampling=None,
                 ratio_mask=None, graph_path=None, coord_path=None, edge_agg: str = "spatial",
                 rng: np.random.Generator | None = None, cache: bool = True,
                 cluster_path=None):
        assert mode in ("patch", "cluster", "graph", "abmil")
        assert edge_agg in ("spatial", "latent")
        self.mode = mode
        if ratio_sampling is not None:
            # `train_sampling`: a random subset of the patients, drawn from the
            # handler's generator before anything else draws from it here
            print(f"[dataset] Sampling with ratio_sampling = {ratio_sampling}")
            patient_ids, left = sampling_data(list(patient_ids), ratio_sampling, rng=rng)
            print(f"[dataset] Sampled {len(patient_ids)} patients, left {len(left)}")
        self.graph_path = graph_path
        self.coord_path = coord_path
        self.cluster_path = cluster_path
        self.edge_agg = edge_agg
        if ratio_mask is not None and ratio_mask > 1e-5:
            assert ratio_mask <= 1
            assert mode in ("patch", "abmil"), \
                "Only patch-style modes support instance masking."
            self.ratio_mask = float(ratio_mask)
        else:
            self.ratio_mask = None
        self.pids, self.pid2sid, self.pid2label = retrieve_from_table(
            patient_ids, label_path, ret=["pid", "pid2sid", "pid2label"],
            time_format=time_format, time_bins=time_bins)
        self.read_path = patch_path
        self.read_format = read_format
        self.rng = rng if rng is not None else np.random.default_rng()
        self._cache: dict | None = {} if cache else None
        print(f"[dataset] BagDataset({mode}): {len(self.pids)} patients")

    def __len__(self):
        return len(self.pids)

    def _path(self, sid) -> str:
        return osp.join(self.read_path, f"{sid}.{self.read_format}")

    def bag_size(self, index: int) -> int:
        """Patch count of a bag from the file headers (.npy, .h5, .pt; .npz
        reads the array), with no RNG draw."""
        total = 0
        for sid in self.pid2sid[self.pids[index]]:
            path = self._path(sid)
            if self.read_format == "npy":
                total += int(np.load(path, mmap_mode="r").shape[0])
            elif self.read_format == "npz":
                with np.load(path) as z:
                    total += int(z["features"].shape[0])
            elif self.read_format == "h5":
                with import_h5py(path).File(path, "r") as hf:
                    total += int(hf["features"].shape[0])
            else:
                t = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
                total += int(t.shape[0])
        return total

    def bag_sizes(self) -> np.ndarray:
        return np.array([self.bag_size(i) for i in range(len(self))])

    def _load(self, index: int) -> dict:
        pid = self.pids[index]
        feats = np.concatenate([read_patch_feature(self._path(sid))
                                for sid in self.pid2sid[pid]], axis=0)
        item = {"index": index, "pid": pid, "feats": feats.astype(np.float32),
                "label": np.asarray(self.pid2label[pid], np.float32)}
        if self.mode == "cluster":
            cids = np.load(osp.join(self.cluster_path, f"{pid}.npy"))
            assert cids.shape[0] == feats.shape[0]
            item["cluster_id"] = cids.astype(np.int32)
        elif self.mode == "graph":
            item["edge_index"] = self._load_edges(pid)
        elif self.mode == "patch" and self.coord_path:
            item["coords"] = np.concatenate(
                [read_patch_coord(self._coord_file(sid)) for sid in self.pid2sid[pid]], axis=0)
        return item

    def _coord_file(self, sid: str) -> str:
        for ext in ("h5", "npz", "npy"):
            path = osp.join(self.coord_path, f"{sid}.{ext}")
            if osp.exists(path):
                return path
        raise FileNotFoundError(f"no coord file for slide {sid} under "
                                f"{self.coord_path} (tried .h5/.npz/.npy)")

    def _graph_file(self, sid: str) -> dict:
        """The slide's graph as numpy arrays with its edges as (dst, src)
        rows: `<sid>.npz` as written, else the reference's `<sid>.pt` with
        its (src, dst) rows flipped (PyG aggregates at the target)."""
        path = osp.join(self.graph_path, f"{sid}.npz")
        if osp.exists(path):
            with np.load(path) as g:
                return dict(g)
        pt = osp.join(self.graph_path, f"{sid}.pt")
        if not osp.exists(pt):
            raise FileNotFoundError(f"no graph file {path} or {pt}")
        g = read_geom_graph(pt)
        for k in ("edge_index", "edge_latent"):
            if k in g:
                g[k] = g[k][::-1]
        return g

    def _read_graph(self, pid: str, with_grid: bool = False):
        """(edge_index, grid) of the patient from one read of each slide's
        graph file. edge_index [2, E] (dst, src): the slides' tables with
        each slide's node ids offset by the nodes before it, dst-sorted
        (stable). grid (with `with_grid`, else None): (rc [N, 2] int64
        (row, col) of each node, W, H), each slide's centroids snapped to
        their grid with its empty rows and columns cropped and the slides
        stacked vertically in the order of their node ids (edges never cross
        slides); None when a slide has no centroids or they are not on a
        regular grid."""
        key = "edge_index" if self.edge_agg == "spatial" else "edge_latent"
        edges, offset = [], 0
        rcs, row_off, wmax = ([] if with_grid else None), 0, 0
        for sid in self.pid2sid[pid]:
            g = self._graph_file(sid)
            edges.append(g[key].astype(np.int64) + offset)
            offset += int(g["num_nodes"])
            cent = g.get("centroid") if rcs is not None else None
            gl = None if cent is None else grid_layout(np.asarray(cent))
            if gl is None:
                rcs = None
                continue
            row, col, W, H = crop_empty_grid_lines(gl[0], gl[1])
            rcs.append(np.stack([row + row_off, col], axis=1))
            row_off += H
            wmax = max(wmax, W)
        ei = np.concatenate(edges, axis=1)
        if not np.all(np.diff(ei[0]) >= 0):
            ei = ei[:, np.argsort(ei[0], kind="stable")]
        grid = (np.concatenate(rcs, axis=0), wmax, row_off) if rcs else None
        return ei, grid

    def _load_edges(self, pid: str) -> np.ndarray:
        return self._read_graph(pid)[0]

    def peek_edges(self, index: int) -> np.ndarray:
        """Bag `index`'s edge table without loading its features (the
        batcher's pre-scan)."""
        return self._load_edges(self.pids[index])

    def peek_grid(self, index: int):
        """Bag `index`'s grid layout for the grid route, or None (see
        `_read_graph`)."""
        return self._read_graph(self.pids[index], with_grid=True)[1]

    def peek_graph(self, index: int):
        """(edge table, grid layout or None) of bag `index` from one read of
        its graph files: the grid pre-scan's input."""
        return self._read_graph(self.pids[index], with_grid=True)

    def __getitem__(self, index: int) -> dict:
        if self._cache is not None and index in self._cache:
            item = self._cache[index]
        else:
            item = self._load(index)
            if self._cache is not None:
                self._cache[index] = item
        if self.ratio_mask:
            item = dict(item)
            item["feats"] = random_mask_square_instance(
                item["feats"], self.ratio_mask, scale=4, mask_way="mask_zero",
                rng=self.rng)
        return item


def prepare_dataset(patient_ids: list, cfg: dict, **kws) -> BagDataset:
    """Build a BagDataset from the flat config (occlusion only in test mode,
    `ratio_sampling` only where the caller passes it)."""
    ratio_mask = kws.get("mask_ratio") if cfg.get("test") else None
    return BagDataset(
        patient_ids, cfg["path_patch"], cfg["path_label"], cfg["bcb_mode"],
        read_format=cfg["feat_format"], time_format=cfg["time_format"],
        time_bins=cfg.get("time_bins", 4), ratio_sampling=kws.get("ratio_sampling"),
        ratio_mask=ratio_mask,
        graph_path=cfg.get("path_graph"), cluster_path=cfg.get("path_cluster"),
        coord_path=cfg.get("path_coordx5") if cfg.get("use_coords_pe", False) else None,
        edge_agg=cfg.get("graph_edge_agg", "spatial"), rng=kws.get("rng"),
        cache=cfg.get("cache_bags", True))


@dataclass
class Batch:
    """One padded batch of numpy arrays."""
    idx: np.ndarray          # [B] dataset indices (tail fillers included)
    feats: np.ndarray        # [B, N, C]
    mask: np.ndarray         # [B, N] 1 = real patch
    label: np.ndarray        # [B, 2] (t, e)
    sample_mask: np.ndarray  # [B] 1 = real bag (0 = duplicated tail filler)
    extra: dict = field(default_factory=dict)   # graph tables, region coords or cluster ids


class BucketBatcher:
    """Groups bags into length buckets and emits fixed-shape padded batches.
    Per bucket of size Nb the batch size is clip(token_budget // Nb, 1,
    max_batch), rounded down to a multiple of `batch_multiple` (at least
    one multiple: the dp rank count); bucket sizes are multiples of
    `n_multiple` (16 times the inst rank count). In graph mode the route
    (banded, grid or dense) is fixed here, from one pre-scan of every bag's
    graph file."""

    def __init__(self, dataset: BagDataset, token_budget: int = 32768,
                 max_batch: int = 64, min_bucket: int = 256,
                 bucket_growth: float = 2.0, edges_per_node: int = 9,
                 banded: str = "auto", grid_max_inflation: float = 3.0,
                 batch_multiple: int = 1, n_multiple: int = 16):
        self.ds = dataset
        self.token_budget = token_budget
        self.max_batch = max_batch
        self.batch_multiple = int(batch_multiple)
        self.edges_per_node = edges_per_node
        self.prefetch_depth = 2    # set from cfg num_workers by the handler
        self.prefetch_workers = 1
        sizes = dataset.bag_sizes()
        self.buckets = default_buckets(int(sizes.max()), min_bucket,
                                       growth=bucket_growth, n_multiple=n_multiple)
        item_bucket = np.searchsorted(self.buckets, sizes)
        self._by_bucket: dict = {}
        for i, b in enumerate(item_bucket):
            self._by_bucket.setdefault(int(b), []).append(i)
        # graph mode: per-bag tables keyed by dataset index (static per bag),
        # following the dataset's cache policy; the route is fixed here
        self._tab_cache = {} if dataset._cache is not None else None
        self._warned_edge_truncation = False
        self.band_on = False
        self._band_u_slots = 0
        self.coverage = None
        self.grid_on = False
        self.grid_coverage = self.grid_inflation = None
        self._grid_max_inflation = float(grid_max_inflation)
        self._grid_u_slots = 0
        self._grid_rc: dict = {}        # dataset index -> (rc [N, 2], W, H)
        if dataset.mode == "graph" and banded != "off":
            self._scan_band(sizes)
        # [(bucket_n, grid_n or None, items)], sorted bucket order, ascending
        # dataset index inside a group
        self._groups = self._groups_list()

    def _scan_band(self, sizes):
        """Pre-scan every bag's graph once (edge files only): the banded route
        engages when the banded share of all real edges is >= 0.7, and fixes
        the residual-row slot count, so every batch has one table layout;
        else the grid route is tried."""
        band_edges = band_total = 0.0
        u_max = 0
        for i, n in enumerate(sizes):
            esrc, em, _ = dense_table(self.ds.peek_edges(i), int(n), self.edges_per_node)
            cov, _, nrows, _ = band_coverage(esrc, em)
            band_edges += cov * em.sum()
            band_total += em.sum()
            u_max = max(u_max, nrows)
        self.coverage = band_edges / max(band_total, 1)
        if self.coverage >= 0.7:
            self.band_on = True
            self._band_u_slots = -(-max(u_max, 1) // 8) * 8
            print(f"[batcher] banded graph route ON: coverage {self.coverage:.3f}, "
                  f"residual rows {self._band_u_slots}")
            return
        print(f"[batcher] banded graph route off: coverage {self.coverage:.3f} < 0.7 in "
              "the bags' node order; trying the slides' grid layout")
        if not self._scan_grid(sizes):
            print("[batcher] the dense route aggregates these graphs")

    def _scan_grid(self, sizes) -> bool:
        """Second pre-scan, after compact banding failed its gate: lay every
        bag out on its grid (`BagDataset.peek_graph`) and build its
        offset-matched band tables. The grid route engages when the banded
        share of the edges is >= 0.7 and the grids' cells number at most
        `grid_max_inflation` times the nodes; it fixes the residual row slot
        count. Returns whether it engaged."""
        band_edges = band_total = 0.0
        u_max = 0
        grid_sum = node_sum = 0
        for i, n in enumerate(sizes):
            edges, g = self.ds.peek_graph(i)
            if g is None or g[0].shape[0] != int(n):
                print("[batcher] grid-raster banding not engaged: a slide's graph file "
                      "holds no centroids on a regular grid")
                self._grid_rc.clear()
                return False
            rc, W, H = g
            self._grid_rc[i] = g
            esrc_g, em_g, _ = dense_table(edges, W * H, self.edges_per_node,
                                          rc[:, 0] * W + rc[:, 1])
            _, _, ebanded = build_band_tables_matched(esrc_g, em_g, k=self.edges_per_node)
            band_edges += float(ebanded.sum())
            band_total += float(em_g.sum())
            u_max = max(u_max, np.unique(np.nonzero((em_g > 0) & (ebanded <= 0))[0]).size)
            grid_sum += W * H
            node_sum += int(n)
        self.grid_coverage = band_edges / max(band_total, 1)
        self.grid_inflation = grid_sum / max(node_sum, 1)
        if self.grid_coverage < 0.7 or self.grid_inflation > self._grid_max_inflation:
            print(f"[batcher] grid-raster banding not engaged: coverage "
                  f"{self.grid_coverage:.3f}, inflation {self.grid_inflation:.2f}")
            self._grid_rc.clear()
            return False
        self.grid_on = True
        self._grid_u_slots = -(-max(u_max, 1) // 8) * 8
        print(f"[batcher] grid-raster banded streaming ON: coverage "
              f"{self.grid_coverage:.3f}, inflation {self.grid_inflation:.2f}, residual "
              f"rows {self._grid_u_slots}")
        return True

    def _graph_tables(self, it: dict, bucket_n: int, grid_n: int | None = None) -> dict:
        """The bag's padded graph tables for a bucket of `bucket_n` nodes (and
        on the grid route a padded grid of `grid_n` cells): the band tables
        on the banded and grid routes, else the dense edge tables. Cached by
        dataset index."""
        idx = int(it["index"])
        if self._tab_cache is not None:
            cached = self._tab_cache.get(idx)
            if (cached is not None and cached["_bucket_n"] == bucket_n
                    and cached["_grid_n"] == grid_n):
                return cached
        tabs = {"_bucket_n": bucket_n, "_grid_n": grid_n}
        if self.grid_on:
            rc, W, H = self._grid_rc[idx]
            assert grid_n is not None and W * H <= grid_n
            grid, dropped = grid_tables(it["edge_index"], rc, W, grid_n, bucket_n,
                                        self.edges_per_node, u_slots=self._grid_u_slots)
            tabs.update(grid)
        else:
            esrc, em, dropped = dense_table(it["edge_index"], bucket_n, self.edges_per_node)
            if self.band_on:
                offs, bmask, _, _, _ = build_band_tables(esrc, em)
                ur, us, ue = build_u_tables(esrc, em, bmask, u_slots=self._band_u_slots)
                tabs.update(band_offs=offs, band_mask=bmask, band_urows=ur, band_usrc=us,
                            band_uemask=ue, band_uinv=build_u_inv(ur, bucket_n))
            else:
                tabs.update(edge_src=esrc, edge_mask=em)
        if dropped and not self._warned_edge_truncation:
            self._warned_edge_truncation = True
            print(f"[batcher] WARNING: node in-degree exceeds {self.edges_per_node}; "
                  f"dropping {dropped} edges per bag (raise graph_edges_per_node)")
        if self._tab_cache is not None:
            self._tab_cache[idx] = tabs
        return tabs

    def batch_size_for(self, bucket_n: int) -> int:
        bb = int(np.clip(self.token_budget // bucket_n, 1, self.max_batch))
        m = self.batch_multiple
        return max(m, (bb // m) * m) if m > 1 else bb

    def _groups_list(self) -> list:
        """The batch groups [(bucket_n, grid_n, items)]. Off the grid route
        each node bucket is one group and grid_n is None. On it the kernels'
        work scales with the padded grid area, so each bucket's items, sorted
        by grid area, are cut (an exact DP over cuts at batch-size multiples)
        to minimise the sum over groups of (batches + 0.5) * batch size *
        grid_n, grid_n being the group's largest area rounded up to 128: one
        sprawling slide then pays for its own bounding box, and half a batch
        prices each extra shape. A group's items keep ascending index order,
        so a bucket that stays whole batches as off the grid route."""
        groups = []
        for b in sorted(self._by_bucket):
            items = self._by_bucket[b]
            bn = int(self.buckets[b])
            if not self.grid_on:
                groups.append((bn, None, list(items)))
                continue
            area = {i: int(self._grid_rc[i][1]) * int(self._grid_rc[i][2]) for i in items}
            order = sorted(items, key=lambda i: (area[i], i))
            bb = self.batch_size_for(bn)
            m = len(order)
            rup = lambda a: -(-max(a, 1) // 128) * 128  # noqa: E731
            pos = list(range(0, m, bb)) + [m]

            def seg_cost(s: int, e: int) -> float:      # items order[s:e]
                return (-(-(e - s) // bb) + 0.5) * bb * rup(area[order[e - 1]])

            best, cut = {0: 0.0}, {}
            for e in pos[1:]:
                best[e] = np.inf
                for s in pos:
                    if s >= e:
                        break
                    c = best[s] + seg_cost(s, e)
                    if c < best[e]:
                        best[e], cut[e] = c, s
            bounds, e = [], m
            while e > 0:
                bounds.append((cut[e], e))
                e = cut[e]
            for s, e in reversed(bounds):
                groups.append((bn, rup(area[order[e - 1]]), sorted(order[s:e])))
        return groups

    def num_batches(self) -> int:
        return sum(-(-len(items) // self.batch_size_for(bn)) for bn, _, items in self._groups)

    def _epoch_chunks(self, shuffle: bool = False,
                      rng: np.random.Generator | None = None) -> list:
        """The pass's (group, item chunk) schedule. With `shuffle`, the items
        of each bucket and then the chunks are shuffled by `rng` (numpy's
        global stream if None), draw for draw as the JAX package does."""
        chunks = []
        for gi, (bn, _, items) in enumerate(self._groups):
            items = list(items)
            if shuffle:
                (rng or np.random).shuffle(items)
            bb = self.batch_size_for(bn)
            for s in range(0, len(items), bb):
                chunks.append((gi, items[s:s + bb]))
        if shuffle:
            (rng or np.random).shuffle(chunks)
        return chunks

    def epoch_batches(self, shuffle: bool = False,
                      rng: np.random.Generator | None = None):
        """Yield Batch objects covering the dataset once (eval order unless
        `shuffle`)."""
        for gi, chunk in self._epoch_chunks(shuffle, rng):
            yield self._make_batch(gi, chunk)

    def prefetch(self, shuffle: bool = False,
                 rng: np.random.Generator | None = None,
                 depth: int | None = None, workers: int | None = None):
        """epoch_batches with host-side assembly overlapped with device work.

        workers <= 1: one background thread runs the pass serially.
        workers > 1: a thread pool assembles batches concurrently and yields
        them in the same order. With test-mode occlusion active the serial
        path is used, so the shared RNG's draws keep their order.
        """
        import queue
        import threading
        depth = max(2, self.prefetch_depth) if depth is None else depth
        workers = self.prefetch_workers if workers is None else workers
        if workers > 1 and self.ds.ratio_mask is None:
            yield from self._prefetch_pool(shuffle, rng, depth, workers)
            return
        q: queue.Queue = queue.Queue(maxsize=depth)
        sentinel = object()
        error: list = []
        stop = threading.Event()

        def worker():
            try:
                for b in self.epoch_batches(shuffle, rng):
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as exc:   # re-raised in the consumer
                error.append(exc)
            finally:
                q.put(sentinel)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            while th.is_alive():          # unblock a producer waiting on put
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                th.join(timeout=0.05)
        if error:
            raise error[0]

    def _prefetch_pool(self, shuffle: bool, rng, depth: int, workers: int):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        chunks = self._epoch_chunks(shuffle, rng)
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="advmil-loader") as ex:
            pending: deque = deque()
            it = iter(chunks)
            for gi, chunk in it:
                pending.append(ex.submit(self._make_batch, gi, chunk))
                if len(pending) >= workers + depth:
                    break
            for gi, chunk in it:
                yield pending.popleft().result()
                pending.append(ex.submit(self._make_batch, gi, chunk))
            while pending:
                yield pending.popleft().result()

    def _make_batch(self, group_i: int, item_ids: list) -> Batch:
        """The batch of `item_ids` (group `group_i`), traced on the worker
        that assembles it as the host span `assemble`, with its patch slots
        counted (`utils/tracing.py`): all of them, the real patches of the
        real bags, and the slots of the tail-filler rows."""
        with tracing.span("assemble", host_only=True):
            batch = self._assemble(group_i, item_ids)
        if tracing.ACTIVE:
            n_real = len(item_ids)
            rows, n = batch.mask.shape
            tracing.count("slots_total", rows * n)
            tracing.count("slots_real", batch.mask[:n_real].sum())
            tracing.count("slots_filler", (rows - n_real) * n)
        return batch

    def _assemble(self, group_i: int, item_ids: list) -> Batch:
        bucket_n, grid_n, _ = self._groups[group_i]
        bb = self.batch_size_for(bucket_n)
        n_real = len(item_ids)
        ids = list(item_ids) + [item_ids[0]] * (bb - n_real)
        items = [self.ds[i] for i in ids]
        C = items[0]["feats"].shape[1]
        feats = np.zeros((bb, bucket_n, C), np.float32)
        mask = np.zeros((bb, bucket_n), np.float32)
        label = np.zeros((bb, 2), np.float32)
        for j, it in enumerate(items):
            n = it["feats"].shape[0]
            assert n <= bucket_n
            feats[j, :n] = it["feats"]
            mask[j, :n] = 1.0
            label[j] = it["label"]
        sample_mask = np.zeros((bb,), np.float32)
        sample_mask[:n_real] = 1.0
        extra = {}
        if self.ds.mode == "cluster":
            cid = np.full((bb, bucket_n), -1, np.int32)
            for j, it in enumerate(items):
                cid[j, :it["feats"].shape[0]] = it["cluster_id"]
            extra["cluster_id"] = cid
        elif self.ds.mode == "graph":
            per = [self._graph_tables(it, bucket_n, grid_n) for it in items]
            keys = GRID_KEYS if self.grid_on else BAND_KEYS if self.band_on else DENSE_KEYS
            for k in keys:
                extra[k] = np.stack([t[k] for t in per])
        elif "coords" in items[0]:
            # region-level coordinates: one per 16 patches
            Lb = bucket_n // 16
            rc = np.zeros((bb, Lb, 2), np.float32)
            for j, it in enumerate(items):
                c = it["coords"]
                L = min(c.shape[0], Lb)
                rc[j, :L] = c[:L]
            extra["coords"] = rc
        return Batch(idx=np.asarray(ids, np.int32), feats=feats, mask=mask,
                     label=label, sample_mask=sample_mask, extra=extra)
