"""Patient-level WSI bag dataset and bucketed padded batching, patch mode
(counterpart of `advmil_tpu/data/bags.py`).

Bags are grouped into length buckets (multiples of 16, so padding forms whole
4x4 regions), padded to the bucket length and stacked into [B, N, C] batches
with masks. Ragged tail batches are filled with duplicates of the batch's
first bag carrying sample_mask=0. Batches come out in the same order, with
the same contents, as the JAX package's batcher under the same seed,
including the test-mode occlusion masks drawn per `__getitem__` from the one
`np.random.Generator` the handler passes in, and the shuffled training
order drawn from that generator in the same order as the JAX package.
"""
from __future__ import annotations

import os.path as osp
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.func import random_mask_square_instance
from ..utils.io import read_patch_feature, retrieve_from_table


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
    """Patient-level bags with labels (patch mode): per patient the
    concatenated patch features of all their slides and the label (t, e)."""

    def __init__(self, patient_ids: list, patch_path: str, label_path: str,
                 mode: str = "patch", read_format: str = "pt",
                 time_format: str = "ratio", ratio_mask=None,
                 rng: np.random.Generator | None = None, cache: bool = True):
        if mode != "patch":
            raise NotImplementedError(f"bag mode {mode!r} is not ported yet "
                                      "(ROADMAP A12, A13)")
        self.mode = mode
        if ratio_mask is not None and ratio_mask > 1e-5:
            assert ratio_mask <= 1
            self.ratio_mask = float(ratio_mask)
        else:
            self.ratio_mask = None
        self.pids, self.pid2sid, self.pid2label = retrieve_from_table(
            patient_ids, label_path, ret=["pid", "pid2sid", "pid2label"],
            time_format=time_format)
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
        return {"index": index, "pid": pid, "feats": feats.astype(np.float32),
                "label": np.asarray(self.pid2label[pid], np.float32)}

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
        ratio_mask=ratio_mask, rng=kws.get("rng"),
        cache=cfg.get("cache_bags", True))


@dataclass
class Batch:
    """One padded batch of numpy arrays."""
    idx: np.ndarray          # [B] dataset indices (tail fillers included)
    feats: np.ndarray        # [B, N, C]
    mask: np.ndarray         # [B, N] 1 = real patch
    label: np.ndarray        # [B, 2] (t, e)
    sample_mask: np.ndarray  # [B] 1 = real bag (0 = duplicated tail filler)


class BucketBatcher:
    """Groups bags into length buckets and emits fixed-shape padded batches.
    Per bucket of size Nb the batch size is clip(token_budget // Nb, 1,
    max_batch)."""

    def __init__(self, dataset: BagDataset, token_budget: int = 32768,
                 max_batch: int = 64, min_bucket: int = 256,
                 bucket_growth: float = 2.0):
        self.ds = dataset
        self.token_budget = token_budget
        self.max_batch = max_batch
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
        return Batch(idx=np.asarray(ids, np.int32), feats=feats, mask=mask,
                     label=label, sample_mask=sample_mask)
