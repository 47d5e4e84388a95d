"""Offline WSI graph construction for PatchGCN (counterpart of
`advmil_tpu/tools/build_graphs.py`).

Per slide, the 8-nearest-neighbour edges (radius 9 with the patch itself)
over the patch coordinates (spatial, `edge_index`) and over the patch
features (latent, `edge_latent`), saved as `<slide>.npz` with edge_index
[2, E] and edge_latent [2, E] as (dst, src) rows, centroid [N, 2] and
num_nodes: the files `bcb_mode: graph` reads (`path_graph`), whose
centroids give the grid route its layout.

The spatial kNN runs on the host (`native.knn_l2`, exact, C++); the feature
kNN (1,024-d) runs on the card as a blocked product and top-k
(`knn_l2_device`), unless `--cpu-feats`. Both are exact; on distance ties
the two may keep different neighbours.

    python -m advmil_tpu_torch.tools.build_graphs --coords DIR --feats DIR \\
        --save DIR [--radius 9] [--feat-format pt] [--cpu-feats]

`--coords` holds one coordinate file per slide (`.h5` as CLAM writes it,
`.npz` or `.npy`), `--feats` the slide's features `<slide>.<feat-format>`.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
import torch

from ..native import knn_l2
from ..utils.io import read_patch_coord, read_patch_feature

COORD_EXTS = (".h5", ".npz", ".npy")


def knn_l2_device(X: np.ndarray, k: int, block: int = 2048, device="cuda") -> np.ndarray:
    """Exact kNN indices [n, min(k, n)] of the rows of X [n, d] on `device`,
    nearest first: per block of `block` query rows, the squared distances
    |q|^2 + |x|^2 - 2 q x^T in f32 (one matrix product) and their k
    smallest. The point itself comes first (distance ~0)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("knn_l2_device: CUDA is not available (pass device='cpu')")
    Xt = torch.as_tensor(np.ascontiguousarray(X, np.float32)).to(dev)
    n = Xt.shape[0]
    k = min(int(k), n)
    norms = (Xt * Xt).sum(dim=1)
    out = torch.empty((n, k), dtype=torch.int64, device=dev)
    for s in range(0, n, block):
        e = min(n, s + block)
        d2 = norms[s:e, None] + norms[None, :] - 2.0 * (Xt[s:e] @ Xt.T)
        out[s:e] = torch.topk(d2, k, dim=1, largest=False).indices
    return out.cpu().numpy().astype(np.int32)


def edges_from_knn(idx: np.ndarray) -> np.ndarray:
    """[n, k] neighbour table (the point itself at column 0) -> [2, n * (k - 1)]
    (dst, src) rows, without the self edge."""
    n, k = idx.shape
    a = np.repeat(np.arange(n), k - 1)
    b = idx[:, 1:].reshape(-1)
    return np.stack([a, b]).astype(np.int64)


def build_graph(coords: np.ndarray, feats: np.ndarray, radius: int = 9,
                use_device_for_feats: bool = True, device="cuda") -> dict:
    """One slide's graph: the spatial kNN of `coords` [N, 2] on the host, the
    latent kNN of `feats` [N, C] on `device` (on the host below 257 patches
    or without `use_device_for_feats`), and the centroids."""
    assert coords.shape[0] == feats.shape[0]
    n = coords.shape[0]
    spatial_idx = knn_l2(coords.astype(np.float32), min(radius, n))
    if use_device_for_feats and n > 256:
        latent_idx = knn_l2_device(feats.astype(np.float32), min(radius, n), device=device)
    else:
        latent_idx = knn_l2(feats.astype(np.float32), min(radius, n))
    return {"edge_index": edges_from_knn(spatial_idx),
            "edge_latent": edges_from_knn(latent_idx),
            "centroid": coords.astype(np.float32),
            "num_nodes": np.asarray(n)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coords", required=True, help="dir of per-slide coordinates "
                    "(.h5 / .npz / .npy)")
    ap.add_argument("--feats", required=True, help="dir of per-slide feature files")
    ap.add_argument("--save", required=True, help="output dir for the graph .npz files")
    ap.add_argument("--radius", type=int, default=9)
    ap.add_argument("--feat-format", default="pt")
    ap.add_argument("--cpu-feats", action="store_true",
                    help="the feature kNN on the host too (C++)")
    args = ap.parse_args(argv)
    os.makedirs(args.save, exist_ok=True)
    files = sorted(f for f in os.listdir(args.coords) if osp.splitext(f)[1] in COORD_EXTS)
    for i, fname in enumerate(files):
        sid = osp.splitext(fname)[0]
        coords = read_patch_coord(osp.join(args.coords, fname))
        feats = read_patch_feature(osp.join(args.feats, f"{sid}.{args.feat_format}"))
        g = build_graph(coords, feats, radius=args.radius, use_device_for_feats=not args.cpu_feats)
        np.savez(osp.join(args.save, f"{sid}.npz"), **g)
        print(f"[{i + 1}/{len(files)}] {sid}: N={int(g['num_nodes'])} "
              f"E={g['edge_index'].shape[1]}")


if __name__ == "__main__":
    main()
