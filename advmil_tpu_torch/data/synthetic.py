"""Synthetic WSI-bag dataset writer for tests and chip runs.

The same on-disk layout and the same random draws as
`advmil_tpu/data/synthetic.py` (feature files per slide, a label csv with
patient_id / pathology_id / t / e, split .npz files, per-patient cluster ids
and region coords), written without pandas. A planted survival signal makes
the C-index learnable. With `with_graph` each slide also gets the JAX
writer's chain+skip graph (`graphs/<sid>.npz`: `edge_index` and
`edge_latent` [2, E] as (dst, src) rows, `num_nodes`); it draws nothing
from the RNG, so features and labels stay those of the JAX writer.

`region_counts` fixes each patient's bag size (in 4x4 regions of 16
patches) instead of drawing it, `test_pids` fixes the test split and
`train_pids` puts patients in the train split, so a caller can place long
bags (e.g. 2,048 regions) where a run needs them.
"""
from __future__ import annotations

import csv
import os
import os.path as osp

import numpy as np
import torch


def make_synthetic_dataset(root: str, n_patients: int = 40, dim: int = 1024,
                           min_regions: int = 8, max_regions: int = 64,
                           event_frac: float = 0.65, seed: int = 0,
                           n_clusters: int = 8, with_graph: bool = False,
                           n_folds: int = 1,
                           feat_format: str = "npy", time_noise: float = 5.0,
                           region_counts: list | None = None,
                           test_pids: list | None = None,
                           train_pids: list | None = None) -> dict:
    """Build a synthetic dataset under ``root``; returns a config-path dict."""
    rng = np.random.default_rng(seed)
    if region_counts is not None:
        n_patients = len(region_counts)
    feat_dir = osp.join(root, "feats")
    cluster_dir = osp.join(root, "clusters")
    coord_dir = osp.join(root, "coords")
    graph_dir = osp.join(root, "graphs")
    for d in [feat_dir, cluster_dir, coord_dir] + ([graph_dir] if with_graph else []):
        os.makedirs(d, exist_ok=True)

    rows = []
    pids = [f"P{i:04d}" for i in range(n_patients)]
    for i, pid in enumerate(pids):
        n_regions = (int(rng.integers(min_regions, max_regions + 1))
                     if region_counts is None else int(region_counts[i]))
        n = n_regions * 16
        signal = rng.uniform(-1.0, 1.0)
        feats = rng.normal(0, 1, size=(n, dim)).astype(np.float32)
        feats[:, :8] += signal
        t = float(np.clip(50.0 * (1.0 + signal) + rng.normal(0, time_noise),
                          1.0, 120.0))
        e = int(rng.uniform() < event_frac)
        sid = f"S{i:04d}"
        if feat_format == "pt":
            torch.save(torch.from_numpy(feats), osp.join(feat_dir, f"{sid}.pt"))
        else:
            np.save(osp.join(feat_dir, f"{sid}.npy"), feats)
        rows.append((sid, pid, e, t))
        # cluster ids: drawn (and written) so the RNG stream stays the JAX
        # writer's; the first n_clusters ids are overwritten to keep every
        # cluster non-empty, consuming no extra draws
        cids = rng.integers(0, n_clusters, size=n).astype(np.int64)
        if n >= n_clusters:
            cids[:n_clusters] = np.arange(n_clusters)
        np.save(osp.join(cluster_dir, f"{pid}.npy"), cids)
        side = int(np.ceil(np.sqrt(n_regions)))
        region_xy = np.stack(np.unravel_index(np.arange(n_regions), (side, side)),
                             axis=1).astype(np.float32)
        np.savez(osp.join(coord_dir, f"{sid}.npz"), coords=region_xy)
        if with_graph:
            ei = chain_skip_graph(n)
            np.savez(osp.join(graph_dir, f"{sid}.npz"), edge_index=ei, edge_latent=ei,
                     num_nodes=np.asarray(n))

    table_path = osp.join(root, "labels.csv")
    with open(table_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["pathology_id", "patient_id", "e", "t"])
        w.writerows(rows)

    split_paths = []
    order = rng.permutation(n_patients)
    n_test = max(2, n_patients // 5)
    n_val = max(2, n_patients // 5)
    fixed = None
    if test_pids is not None:
        fixed = [pids.index(p) for p in test_pids]
        last = [pids.index(p) for p in train_pids or []]
        order = np.asarray(fixed + [i for i in order if i not in fixed + last] + last)
        n_test = len(fixed)
    for fold in range(n_folds):
        rolled = order if fixed is not None else np.roll(order, fold * n_test)
        test = rolled[:n_test]
        val = rolled[n_test:n_test + n_val]
        train = rolled[n_test + n_val:]
        p = osp.join(root, f"split-fold{fold}.npz")
        np.savez(p, train_patients=np.asarray([pids[i] for i in train]),
                 val_patients=np.asarray([pids[i] for i in val]),
                 test_patients=np.asarray([pids[i] for i in test]))
        split_paths.append(p)

    return {
        "path_patch": feat_dir,
        "path_label": table_path,
        "path_cluster": cluster_dir,
        "path_coordx5": coord_dir,
        "path_graph": graph_dir if with_graph else None,
        "feat_format": feat_format,
        "data_split_path": osp.join(root, "split-fold{}.npz"),
        "split_paths": split_paths,
        "pids": pids,
    }


def chain_skip_graph(n: int) -> np.ndarray:
    """The JAX writer's symmetric spatial graph over n nodes: node a receives
    from a - 1, a + 1, a - 4 and a + 4 (those in range), as a dst-sorted
    [2, E] int64 (dst, src) table."""
    a = np.repeat(np.arange(n), 4)
    b = a + np.tile(np.asarray([-1, 1, -4, 4]), n)
    keep = (b >= 0) & (b < n)
    return np.stack([a[keep], b[keep]]).astype(np.int64)


def tissue_coords(rng: np.random.Generator, width: int, height: int, hole_share: float = 0.04,
                  patch: int = 256) -> np.ndarray:
    """CLAM-like patch coordinates [N, 2] (x, y, pixels) of one slide: the
    cells of a width x height grid of `patch`-pixel patches inside an
    ellipse that fills the grid (its centre moved by up to a tenth of each
    side), less a share `hole_share` of cells at random (background holes),
    in raster order (row by row)."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    cy = height / 2 + rng.uniform(-0.1, 0.1) * height
    cx = width / 2 + rng.uniform(-0.1, 0.1) * width
    inside = ((yy - cy) / (height / 2)) ** 2 + ((xx - cx) / (width / 2)) ** 2 <= 1.0
    inside &= rng.random((height, width)) >= hole_share
    ys, xs = np.nonzero(inside)
    return (np.stack([xs, ys], 1) * patch).astype(np.float32)


def tissue_grid_tables(shapes, rng: np.random.Generator, epn: int = 9) -> dict:
    """The grid route's tables of one slide per (width, height) of `shapes`
    (a tissue mask `tissue_coords(rng, width, height)`, its 8-nearest-neighbour
    graph from the port's graph tool, laid out on its cropped grid), padded
    to one grid size and one residual-row count as the batcher pads a batch:
    the `band_*` arrays [B, ...] plus `cropped_widths`."""
    from ..data.bags import grid_tables
    from ..ops.segment import crop_empty_grid_lines, grid_layout
    from ..tools.build_graphs import build_graph
    slides = []
    for w, h in shapes:
        coords = tissue_coords(rng, w, h)
        g = build_graph(coords, np.zeros((len(coords), 1), np.float32),
                        use_device_for_feats=False)
        gl = grid_layout(coords)
        row, col, Wc, Hc = crop_empty_grid_lines(gl[0], gl[1])
        slides.append((g["edge_index"], np.stack([row, col], 1), Wc, Hc))
    grid_n = -(-max(w * h for _, _, w, h in slides) // 128) * 128
    bucket_n = -(-max(len(rc) for _, rc, _, _ in slides) // 16) * 16

    def tables(u_slots=None):
        return [grid_tables(e, rc, w, grid_n, bucket_n, epn, u_slots=u_slots)[0]
                for e, rc, w, _ in slides]

    u_slots = -(-max(int((t["band_urows"] < grid_n).sum()) for t in tables()) // 8) * 8
    tabs = tables(u_slots)
    out = {k: np.stack([t[k] for t in tabs]) for k in tabs[0]}
    out["cropped_widths"] = [w for _, _, w, _ in slides]
    return out
