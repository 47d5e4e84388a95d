"""Patient-level WSI bag dataset and bucketed padded batching, patch, abmil
and graph mode (counterpart of `advmil_tpu/data/bags.py`).

Bags are grouped into length buckets (multiples of 16, so padding forms whole
4x4 regions), padded to the bucket length and stacked into [B, N, C] batches
with masks. Ragged tail batches are filled with duplicates of the batch's
first bag carrying sample_mask=0. Batches come out in the same order, with
the same contents, as the JAX package's batcher under the same seed,
including the test-mode occlusion masks drawn per `__getitem__` from the one
`np.random.Generator` the handler passes in, and the shuffled training
order drawn from that generator in the same order as the JAX package.

Graph mode (PatchGCN) adds each bag's kNN graph, read from per-slide
`<sid>.npz` files ([2, E] (dst, src) rows). The batcher pre-scans every
bag's graph once and picks one route for all of them: the banded route
when at least 70% of the edges sit on per-slot constant offsets (raster
spatial kNN graphs), else the dense route. Per bag it ships, in
`Batch.extra`, the band tables (`band_offs`, `band_mask`, `band_urows`,
`band_usrc`, `band_uemask`, `band_uinv`) or the dense `edge_src` /
`edge_mask` tables, cached by dataset index.
"""
from __future__ import annotations

import os.path as osp
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.banded import build_u_inv, build_u_tables
from ..ops.segment import band_coverage, build_band_tables
from ..utils.func import random_mask_square_instance
from ..utils.io import read_patch_coord, read_patch_feature, retrieve_from_table

BAND_KEYS = ("band_offs", "band_mask", "band_urows", "band_usrc", "band_uemask",
             "band_uinv")
DENSE_KEYS = ("edge_src", "edge_mask")


def default_buckets(max_n: int, min_bucket: int = 256,
                    growth: float = 2.0) -> list:
    """Geometric bucket sizes (multiples of 16) covering max_n; the top
    bucket is clamped to max_n rounded up, and ``min_bucket`` stays a
    floor."""
    m = 16
    floor = -(-int(min_bucket) // m) * m
    top = max(-(-int(max_n) // m) * m, floor)
    sizes = []
    b = floor
    while b < top:
        sizes.append(b)
        b = max(b + m, -(-int(b * growth) // m) * m)
    sizes.append(top)
    return sizes


class BagDataset:
    """Patient-level bags with labels: per patient the concatenated patch
    features of all their slides and the label (t, e), or (bin, censorship)
    under `time_format: quantile`, plus in graph mode their kNN graph
    (`edge_index` [2, E], dst-sorted) and in patch mode, with `coord_path`,
    their region coordinates."""

    def __init__(self, patient_ids: list, patch_path: str, label_path: str,
                 mode: str = "patch", read_format: str = "pt",
                 time_format: str = "ratio", time_bins: int = 4, ratio_mask=None,
                 graph_path=None, coord_path=None, edge_agg: str = "spatial",
                 rng: np.random.Generator | None = None, cache: bool = True):
        if mode not in ("patch", "abmil", "graph"):
            raise NotImplementedError(f"bag mode {mode!r} is not ported yet "
                                      "(ROADMAP A12)")
        assert edge_agg in ("spatial", "latent")
        self.mode = mode
        self.graph_path = graph_path
        self.coord_path = coord_path
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
        """Patch count of a bag from the file headers (no feature load, no
        RNG draw)."""
        total = 0
        for sid in self.pid2sid[self.pids[index]]:
            if self.read_format == "npy":
                total += int(np.load(self._path(sid), mmap_mode="r").shape[0])
            else:
                t = torch.load(self._path(sid), map_location="cpu", mmap=True,
                               weights_only=True)
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
        if self.mode == "graph":
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

    def _load_edges(self, pid: str) -> np.ndarray:
        """The patient's [2, E] (dst, src) edge table: the slides' tables
        with each slide's node ids offset by the nodes before it, dst-sorted
        (stable)."""
        key = "edge_index" if self.edge_agg == "spatial" else "edge_latent"
        edges, offset = [], 0
        for sid in self.pid2sid[pid]:
            path = osp.join(self.graph_path, f"{sid}.npz")
            if not osp.exists(path):
                if osp.exists(osp.join(self.graph_path, f"{sid}.pt")):
                    raise NotImplementedError(
                        f"{sid}.pt: reference geomData graph files are not read yet "
                        "(ROADMAP A13); write <sid>.npz graphs")
                raise FileNotFoundError(f"no graph file {path}")
            with np.load(path) as g:
                edges.append(g[key].astype(np.int64) + offset)
                offset += int(g["num_nodes"])
        ei = np.concatenate(edges, axis=1)
        if not np.all(np.diff(ei[0]) >= 0):
            ei = ei[:, np.argsort(ei[0], kind="stable")]
        return ei

    def peek_edges(self, index: int) -> np.ndarray:
        """Bag `index`'s edge table without loading its features (the
        batcher's pre-scan)."""
        return self._load_edges(self.pids[index])

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
    """Build a BagDataset from the flat config (occlusion only in test mode)."""
    ratio_mask = kws.get("mask_ratio") if cfg.get("test") else None
    return BagDataset(
        patient_ids, cfg["path_patch"], cfg["path_label"], cfg["bcb_mode"],
        read_format=cfg["feat_format"], time_format=cfg["time_format"],
        time_bins=cfg.get("time_bins", 4), ratio_mask=ratio_mask,
        graph_path=cfg.get("path_graph"),
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
    extra: dict = field(default_factory=dict)   # graph tables or region coords, [B, ...]


class BucketBatcher:
    """Groups bags into length buckets and emits fixed-shape padded batches.
    Per bucket of size Nb the batch size is clip(token_budget // Nb, 1,
    max_batch)."""

    def __init__(self, dataset: BagDataset, token_budget: int = 32768,
                 max_batch: int = 64, min_bucket: int = 256,
                 bucket_growth: float = 2.0, edges_per_node: int = 9,
                 banded: str = "auto"):
        self.ds = dataset
        self.token_budget = token_budget
        self.max_batch = max_batch
        self.edges_per_node = edges_per_node
        self.prefetch_depth = 2    # set from cfg num_workers by the handler
        self.prefetch_workers = 1
        sizes = dataset.bag_sizes()
        self.buckets = default_buckets(int(sizes.max()), min_bucket,
                                       growth=bucket_growth)
        item_bucket = np.searchsorted(self.buckets, sizes)
        by_bucket: dict = {}
        for i, b in enumerate(item_bucket):
            by_bucket.setdefault(int(b), []).append(i)
        # sorted bucket order, ascending dataset index inside a bucket
        self._groups = [(int(self.buckets[b]), by_bucket[b])
                        for b in sorted(by_bucket)]
        # graph mode: per-bag tables keyed by dataset index (static per bag),
        # following the dataset's cache policy; the route is fixed here
        self._tab_cache = {} if dataset._cache is not None else None
        self._warned_edge_truncation = False
        self.band_on = False
        self._band_u_slots = 0
        self.coverage = None
        if dataset.mode == "graph" and banded != "off":
            self._scan_band(sizes)

    def _dense_table(self, edge_index: np.ndarray, n_rows: int):
        """(edge_src, edge_mask [n_rows, epn], dropped): each node's first
        `edges_per_node` incoming edges in file order; edges beyond that are
        dropped."""
        epn = self.edges_per_node
        dst, src = edge_index[0], edge_index[1]
        pos = np.arange(dst.shape[0]) - np.searchsorted(dst, dst, side="left")
        keep = pos < epn
        esrc = np.zeros((n_rows, epn), np.int32)
        em = np.zeros((n_rows, epn), np.float32)
        esrc[dst[keep], pos[keep]] = src[keep]
        em[dst[keep], pos[keep]] = 1.0
        return esrc, em, int((~keep).sum())

    def _scan_band(self, sizes):
        """Pre-scan every bag's graph once (edge files only): the banded route
        engages when the banded share of all real edges is >= 0.7, and fixes
        the residual-row slot count, so every batch has one table layout."""
        band_edges = band_total = 0.0
        u_max = 0
        for i, n in enumerate(sizes):
            esrc, em, _ = self._dense_table(self.ds.peek_edges(i), int(n))
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
        else:
            print(f"[batcher] banded graph route off: coverage {self.coverage:.3f} < 0.7; "
                  "grid-raster banding is not ported (ROADMAP A13), so the dense "
                  "route aggregates these graphs")

    def _graph_tables(self, it: dict, bucket_n: int) -> dict:
        """The bag's padded graph tables for a bucket of `bucket_n` nodes:
        the band tables on the banded route, else the dense edge tables.
        Cached by dataset index."""
        idx = int(it["index"])
        if self._tab_cache is not None:
            cached = self._tab_cache.get(idx)
            if cached is not None and cached["_bucket_n"] == bucket_n:
                return cached
        esrc, em, dropped = self._dense_table(it["edge_index"], bucket_n)
        if dropped and not self._warned_edge_truncation:
            self._warned_edge_truncation = True
            print(f"[batcher] WARNING: node in-degree exceeds {self.edges_per_node}; "
                  f"dropping {dropped} edges per bag (raise graph_edges_per_node)")
        tabs = {"_bucket_n": bucket_n}
        if self.band_on:
            offs, bmask, _, _, _ = build_band_tables(esrc, em)
            ur, us, ue = build_u_tables(esrc, em, bmask, u_slots=self._band_u_slots)
            tabs.update(band_offs=offs, band_mask=bmask, band_urows=ur, band_usrc=us,
                        band_uemask=ue, band_uinv=build_u_inv(ur, bucket_n))
        else:
            tabs.update(edge_src=esrc, edge_mask=em)
        if self._tab_cache is not None:
            self._tab_cache[idx] = tabs
        return tabs

    def batch_size_for(self, bucket_n: int) -> int:
        return int(np.clip(self.token_budget // bucket_n, 1, self.max_batch))

    def _epoch_chunks(self, shuffle: bool = False,
                      rng: np.random.Generator | None = None) -> list:
        """The pass's (group, item chunk) schedule. With `shuffle`, the items
        of each bucket and then the chunks are shuffled by `rng` (numpy's
        global stream if None), draw for draw as the JAX package does."""
        chunks = []
        for gi, (bn, items) in enumerate(self._groups):
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
        bucket_n, _ = self._groups[group_i]
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
        if self.ds.mode == "graph":
            per = [self._graph_tables(it, bucket_n) for it in items]
            for k in (BAND_KEYS if self.band_on else DENSE_KEYS):
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
