"""Host-side I/O: label tables, split files, patch features and coordinates,
reference-format graph files, predictions.

The same file contracts as `advmil_tpu.utils.io` (csv label tables with
patient_id, pathology_id, t, e; npz split files; .pt / .npy / .npz / .h5
feature files and .npy / .npz / .h5 coordinate files, as CLAM writes them;
torch_geometric `geomData` graph pickles; the prediction CSV and its
`_dist.npz`), written with `csv` and numpy. `.h5` files are read through
h5py, imported when one is opened: without h5py such a read raises an error
that names it.
"""
from __future__ import annotations

import csv
import os.path as osp

import numpy as np
import torch


def _read_table(table_path: str) -> tuple[list, dict]:
    """(rows, columns) of a csv label table; every cell stays a string."""
    with open(table_path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        columns = list(reader.fieldnames or [])
    return rows, columns


def compute_discrete_label(rows: list, column_t: str = "t", column_e: str = "e",
                           bins: int = 4, pid_column: str = "patient_id"):
    """Discrete-time labels of every table row: (y_t [n] int bin index,
    y_c [n] censorship 1 - e), `pd.qcut` / `pd.cut` as the JAX package
    applies them, in numpy:

    - the bin edges are the linear-interpolated quantiles of t over the
      event patients, one row per patient (its first row in the table); the
      quantile levels are linspace(0, 1, bins + 1), each one that is not
      exact in binary moved up by one ulp (pandas' qcut); repeated edges
      raise, as qcut's do;
    - the first and last edges are widened to 1e-5 past the table-wide min
      and max of t;
    - every row's t falls in [edge_k, edge_k+1) (right=False).
    """
    t = np.array([float(r[column_t]) for r in rows], np.float64)
    e = np.array([float(r[column_e]) for r in rows], np.float64)
    first: dict = {}
    for i, r in enumerate(rows):
        first.setdefault(r[pid_column], i)
    pat = np.array(list(first.values()), np.int64)
    evt_t = t[pat][e[pat] == 1]
    qs = np.linspace(0, 1, bins + 1)
    qs = np.where(bins * qs != np.arange(bins + 1), np.nextafter(qs, 1), qs)
    edges = np.quantile(evt_t, qs, method="linear")
    if len(np.unique(edges)) < len(edges) and len(edges) != 2:
        raise ValueError(f"Bin edges must be unique: {edges!r}")
    edges[0] = t.min() - 1e-5
    edges[-1] = t.max() + 1e-5
    return np.searchsorted(edges, t, side="right") - 1, 1.0 - e


def retrieve_from_table(patient_ids, table_path,
                        ret=("pid", "pid2sid", "pid2label"),
                        pid_column: str = "patient_id", time_format: str = "origin",
                        time_bins: int = 4):
    """Returns the requested mappings among pid / sid / pid2sid / sid2pid /
    pid2label / sid2label, after applying the time-format transform.

    'ratio' divides t by the table-wide max; 'origin' keeps raw t;
    'quantile' gives (bin index, censorship) from `compute_discrete_label`
    with `time_bins` bins. Slide ids are returned as strings (they only ever
    name feature files).
    """
    assert time_format in ["origin", "ratio", "quantile"]
    for r in ret:
        assert r in ["pid", "sid", "pid2sid", "sid2pid", "pid2label", "sid2label"]

    rows, columns = _read_table(table_path)
    for c in [pid_column, "pathology_id", "t", "e"]:
        assert c in columns, f"label table missing column {c}"

    patient_ids = [str(p) for p in patient_ids]
    pid_set = set(patient_ids)
    max_time = max(float(r["t"]) for r in rows)
    pid2loc: dict = {}
    for i, r in enumerate(rows):
        if r[pid_column] in pid_set:
            pid2loc.setdefault(r[pid_column], []).append(i)
    if time_format == "quantile":
        y_t, y_c = compute_discrete_label(rows, bins=time_bins, pid_column=pid_column)

    def label(i):
        if time_format == "quantile":
            return (float(y_t[i]), float(y_c[i]))
        t = float(rows[i]["t"])
        if time_format == "ratio":
            t = 1.0 * t / max_time
        return (t, float(rows[i]["e"]))

    pid, sid = [], []
    pid2sid, pid2label, sid2pid, sid2label = {}, {}, {}, {}
    for p in patient_ids:
        if p not in pid2loc:
            print(f"[Warning] Patient ID {p} not found in table {table_path}.")
            continue
        pid.append(p)
        for _i in pid2loc[p]:
            r = rows[_i]
            _sid = r["pathology_id"]
            pid2sid.setdefault(p, []).append(_sid)
            if p not in pid2label:
                pid2label[p] = label(_i)
            sid.append(_sid)
            sid2pid[_sid] = p
            sid2label[_sid] = label(_i)

    scope = {"pid": pid, "sid": sid, "pid2sid": pid2sid, "pid2label": pid2label,
             "sid2pid": sid2pid, "sid2label": sid2label}
    return [scope[r] for r in ret]


def read_maxt_from_table(path: str, at_column: str = "t") -> float:
    rows, _ = _read_table(path)
    return max(float(r[at_column]) for r in rows)


def import_h5py(path: str):
    """The h5py module, or an ImportError that names h5py and `path`."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(f"{path}: reading .h5 files needs the h5py package, "
                          "which is not installed") from exc
    return h5py


def read_patch_feature(path: str) -> np.ndarray:
    """Read an [N, C] patch-feature matrix from .pt, .npy, .npz (key
    `features`) or .h5 (dataset `features`) as float32."""
    ext = osp.splitext(path)[1]
    if ext == ".pt":
        x = torch.load(path, map_location="cpu", weights_only=True)
        return x.float().numpy()
    if ext == ".npy":
        return np.asarray(np.load(path), dtype=np.float32)
    if ext == ".npz":
        with np.load(path) as z:
            return np.asarray(z["features"], dtype=np.float32)
    if ext == ".h5":
        with import_h5py(path).File(path, "r") as hf:
            return np.asarray(hf["features"][:], dtype=np.float32)
    raise ValueError(f"Unsupported feature format {ext}")


def read_patch_coord(path: str) -> np.ndarray:
    """Read an [L, 2] coordinate matrix from .npy, .npz (key `coords`) or
    .h5 (dataset `coords`)."""
    ext = osp.splitext(path)[1]
    if ext == ".npy":
        return np.load(path)
    if ext == ".npz":
        with np.load(path) as z:
            return z["coords"]
    if ext == ".h5":
        with import_h5py(path).File(path, "r") as hf:
            return np.asarray(hf["coords"][:])
    raise ValueError(f"Unsupported coord format {ext}")


class _GeomStub:
    """Stands in for every pickled torch_geometric class: keeps the pickled
    attributes without importing torch_geometric."""

    def __init__(self, *args, **kwargs):
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, tuple):  # (dict_state, slots_state)
            for part in state:
                if part:
                    self.__dict__.update(part)
        elif isinstance(state, dict):
            self.__dict__.update(state)


def read_geom_graph(path: str) -> dict:
    """Read a reference-format torch_geometric `geomData` graph `.pt` without
    torch_geometric: every `torch_geometric.*` class in the pickle is read as
    a `_GeomStub`. PyG < 2 keeps the attributes in the object's `__dict__`,
    PyG >= 2 in a `_store` mapping; both are read.

    Returns numpy arrays edge_index [2, E], edge_latent [2, E] and centroid
    [N, 2] (a missing field is an absent key; PyG rows are (source,
    target)), plus num_nodes, the rows of x, when x is present. The features
    x are not returned (the port reads them from the feature files), and a
    zip-format file (torch.save's default) is memory-mapped, so they are not
    read from disk either."""
    import pickle
    import zipfile

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith("torch_geometric"):
                return _GeomStub
            return super().find_class(module, name)

    shim = type("pickle_shim", (), {"Unpickler": _Unpickler,
                                    "load": staticmethod(pickle.load),
                                    "dump": staticmethod(pickle.dump)})
    obj = torch.load(path, map_location="cpu", pickle_module=shim, weights_only=False,
                     mmap=zipfile.is_zipfile(path))
    attrs = dict(getattr(obj, "__dict__", {}) or {})
    store = attrs.pop("_store", None)
    if store is not None:
        inner = getattr(store, "__dict__", None) or {}
        attrs.update(inner.get("_mapping", inner))
    out = {}
    for k in ("edge_index", "edge_latent", "centroid"):
        v = attrs.get(k)
        if v is None:
            continue
        out[k] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    if attrs.get("x") is not None:
        out["num_nodes"] = int(attrs["x"].shape[0])
    return out


def read_datasplit_npz(path: str):
    data_npz = np.load(path)
    pids_train = [str(s) for s in data_npz["train_patients"]]
    pids_val = [str(s) for s in data_npz["val_patients"]]
    pids_test = ([str(s) for s in data_npz["test_patients"]]
                 if "test_patients" in data_npz else None)
    return pids_train, pids_val, pids_test


def _write_csv(path: str, header: list, columns: list):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for row in zip(*columns):
            w.writerow([str(v) for v in row])


def save_prediction(patient_id, y_true, y_pred, dist_pred, save_path: str):
    """Continuous model -> csv [patient_id, t, e, pred_t] (+ _dist.npz of the
    sampling distribution); discrete -> csv [patient_id, t, e, risk, surf_*]."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_pred.ndim == 1:
        y_pred = y_pred[:, None]
    if dist_pred is not None:
        dist_pred = np.squeeze(np.asarray(dist_pred))
        assert len(patient_id) == len(dist_pred)
    assert len(patient_id) == len(y_true) == len(y_pred)

    if y_pred.shape[1] == 1:
        _write_csv(save_path, ["patient_id", "t", "e", "pred_t"],
                   [list(patient_id), y_true[:, 0], y_true[:, 1], y_pred[:, 0]])
        if dist_pred is not None:
            np.savez(save_path[:-4] + "_dist.npz", patient_id=patient_id,
                     pred_dist=dist_pred)
    else:
        bins = y_pred.shape[1]
        survival = np.cumprod(1 - y_pred, axis=1)
        risk = np.sum(survival, axis=1)
        _write_csv(save_path,
                   ["patient_id", "t", "e", "risk"]
                   + [f"surf_{i + 1}" for i in range(bins)],
                   [list(patient_id), y_true[:, 0], 1 - y_true[:, 1], risk]
                   + [survival[:, i] for i in range(bins)])
