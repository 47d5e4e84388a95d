"""Offline per-patient patch clustering for DeepAttnMISL (counterpart of
`advmil_tpu/tools/cluster_patches.py`).

All slides of a patient are concatenated (in table order) and clustered
into k clusters (seed 42); `<patient>.npy` holds one cluster id per patch,
the files `bcb_mode: cluster` reads (`path_cluster`). `--backend native`
(the default here) is the C++ k-means of `native/` (kmeans++ seeding, then
Lloyd), which gives the JAX package's native labels; `--backend sklearn`
is scikit-learn's KMeans(random_state=42), the reference's clustering,
imported only then.

    python -m advmil_tpu_torch.tools.cluster_patches --table CSV --feats DIR \\
        --save DIR [--clusters 8] [--feat-format pt] [--backend native]
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from ..native import kmeans
from ..utils.io import _read_table, read_patch_feature


def cluster_patient(feats: np.ndarray, k: int, backend: str = "native",
                    seed: int = 42) -> np.ndarray:
    """Cluster ids [N] int64 of one patient's patches."""
    if backend == "native":
        labels, _ = kmeans(feats, k, seed=seed)
        return labels.astype(np.int64)
    if backend != "sklearn":
        raise ValueError(f"unknown backend {backend!r} (native | sklearn)")
    try:
        from sklearn.cluster import KMeans
    except ImportError as exc:
        raise ImportError("--backend sklearn needs scikit-learn, which is not "
                          "installed; --backend native needs nothing") from exc
    return KMeans(n_clusters=k, random_state=seed).fit_predict(feats).astype(np.int64)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--table", required=True,
                    help="csv with patient_id / pathology_id columns")
    ap.add_argument("--feats", required=True)
    ap.add_argument("--save", required=True)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--feat-format", default="pt")
    ap.add_argument("--backend", default="native", choices=["native", "sklearn"])
    args = ap.parse_args(argv)
    os.makedirs(args.save, exist_ok=True)
    rows, _ = _read_table(args.table)
    groups: dict = {}
    for r in rows:
        groups.setdefault(r["patient_id"], []).append(r["pathology_id"])
    done = 0
    for pid in sorted(groups):
        paths = [p for p in (osp.join(args.feats, f"{sid}.{args.feat_format}")
                             for sid in groups[pid]) if osp.exists(p)]
        if not paths:
            print(f"[skip] no feature files for patient {pid}")
            continue
        feats = np.concatenate([read_patch_feature(p) for p in paths], axis=0)
        if len(feats) < args.clusters:
            print(f"[skip] patient {pid}: {len(feats)} < {args.clusters} patches")
            continue
        labels = cluster_patient(feats, args.clusters, backend=args.backend)
        np.save(osp.join(args.save, f"{pid}.npy"), labels)
        done += 1
        print(f"processed {done}/{len(groups)}.")


if __name__ == "__main__":
    main()
