"""The readers and offline tools of advmil_tpu_torch against advmil_tpu on
the CPU: reference-format torch_geometric `.pt` graphs (PyG 1 and 2
pickles), `.h5` / `.npz` features and coordinates, the C++ kNN and k-means,
the feature kNN (`knn_l2_device`, here on the CPU), `build_graph` and its
CLI, `cluster_patches --backend native` and `big_to_small_patching`.
"""
import csv
import os
import os.path as osp
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from advmil_tpu import native as jnative
from advmil_tpu.data.bags import BagDataset as JBagDataset
from advmil_tpu.tools import big_to_small_patching as jb2s
from advmil_tpu.tools import build_graphs as jbg
from advmil_tpu.tools import cluster_patches as jcp
from advmil_tpu.utils import io as jio
from advmil_tpu_torch import native as tnative
from advmil_tpu_torch.data.bags import BagDataset
from advmil_tpu_torch.data.synthetic import tissue_coords
from advmil_tpu_torch.tools import big_to_small_patching as tb2s
from advmil_tpu_torch.tools import build_graphs as tbg
from advmil_tpu_torch.tools import cluster_patches as tcp
from advmil_tpu_torch.utils import io as tio
from tests import test_data

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
# the JAX package's writer of reference-format graphs (a class imported by
# name here would be collected again)
save_geom_pt = test_data.TestGeomPtIngestion._save_geom_pt


# ---------------------------------------------------------------------------
# (a) readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("style", ["pyg1", "pyg2"])
def test_read_geom_graph_equals_jax(tmp_path, style):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(9, 4)).astype(np.float32)
    ei = rng.integers(0, 9, size=(2, 20)).astype(np.int64)
    el = rng.integers(0, 9, size=(2, 18)).astype(np.int64)
    cen = rng.normal(size=(9, 2)).astype(np.float32)
    p = str(tmp_path / "s.pt")
    save_geom_pt(p, x, ei, el, cen, style=style)
    got, want = tio.read_geom_graph(p), jio.read_geom_graph(p)
    # every field but the features, which the port reads from the feature files
    assert set(want) == {"x", "edge_index", "edge_latent", "centroid", "num_nodes"}
    assert set(got) == set(want) - {"x"} and want["num_nodes"] == 9
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
        assert np.asarray(v).dtype == np.asarray(want[k]).dtype, k
    assert "torch_geometric" not in sys.modules


@pytest.fixture(scope="module")
def pt_graphs(tmp_path_factory):
    """Two patients as reference-format .pt graphs: P0 with two tissue
    slides (PyG 1), P1 with one (PyG 2); PyG rows are (src, dst)."""
    root = tmp_path_factory.mktemp("ptg")
    (root / "feats").mkdir()
    (root / "graphs").mkdir()
    rng = np.random.default_rng(3)
    rows = []
    for pid, sid, w, style in (("P0", "S0", 14, "pyg1"), ("P0", "S1", 11, "pyg1"),
                               ("P1", "S2", 17, "pyg2")):
        coords = tissue_coords(rng, w, w - 3)
        n = len(coords)
        x = rng.normal(size=(n, 8)).astype(np.float32)
        np.save(root / "feats" / f"{sid}.npy", x)
        g = tbg.build_graph(coords, x, use_device_for_feats=False)
        save_geom_pt(str(root / "graphs" / f"{sid}.pt"), x, g["edge_index"][::-1].copy(),
                     g["edge_latent"][::-1].copy(), coords, style=style)
        rows.append([pid, sid, "3.0", "1"])
    with open(root / "labels.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "pathology_id", "t", "e"])
        w.writerows(rows)
    return root


@pytest.mark.parametrize("edge_agg", ["spatial", "latent"])
def test_dataset_reads_pt_graphs_as_jax(pt_graphs, edge_agg):
    """`_load_edges` (flipped to (dst, src), offset per slide, dst-sorted)
    and `peek_grid` (two slides stacked) equal the JAX dataset's."""
    kw = dict(mode="graph", read_format="npy", time_format="ratio", edge_agg=edge_agg,
              graph_path=str(pt_graphs / "graphs"))
    args = (["P0", "P1"], str(pt_graphs / "feats"), str(pt_graphs / "labels.csv"))
    tds, jds = BagDataset(*args, **kw), JBagDataset(*args, **kw)
    for i in range(2):
        np.testing.assert_array_equal(tds.peek_edges(i), jds.peek_edges(i))
        np.testing.assert_array_equal(tds[i]["edge_index"], jds[i]["edge_index"])
        (trc, tW, tH), (jrc, jW, jH) = tds.peek_grid(i), jds.peek_grid(i)
        np.testing.assert_array_equal(trc, jrc)
        assert (tW, tH) == (jW, jH)
    assert np.all(np.diff(tds.peek_edges(0)[0]) >= 0)


def test_graph_file_without_centroids_has_no_grid(pt_graphs, tmp_path):
    """An .npz graph without `centroid` loads its edges but gives no grid
    layout (the batcher then keeps the dense route), as in JAX."""
    g = tio.read_geom_graph(str(pt_graphs / "graphs" / "S2.pt"))
    (tmp_path / "g").mkdir()
    np.savez(tmp_path / "g" / "S2.npz", edge_index=g["edge_index"][::-1],
             edge_latent=g["edge_latent"][::-1], num_nodes=np.asarray(g["num_nodes"]))
    kw = dict(mode="graph", read_format="npy", graph_path=str(tmp_path / "g"))
    args = (["P1"], str(pt_graphs / "feats"), str(pt_graphs / "labels.csv"))
    tds, jds = BagDataset(*args, **kw), JBagDataset(*args, **kw)
    assert tds.peek_grid(0) is None and jds.peek_grid(0) is None
    np.testing.assert_array_equal(tds.peek_edges(0), jds.peek_edges(0))


def test_h5_and_npz_features_and_coords_equal_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 16)).astype(np.float32)
    c = (rng.integers(0, 50, size=(40, 2)) * 256).astype(np.int64)
    with h5py.File(tmp_path / "a.h5", "w") as hf:
        hf["features"], hf["coords"] = x, c
    np.savez(tmp_path / "a.npz", features=x, coords=c)
    for ext in ("h5", "npz"):
        p = str(tmp_path / f"a.{ext}")
        for got, want in ((tio.read_patch_feature(p), jio.read_patch_feature(p)),
                          (tio.read_patch_coord(p), jio.read_patch_coord(p))):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tio.read_patch_coord(str(tmp_path / "a.h5"))
    with pytest.raises(ImportError, match="h5py"):
        tio.read_patch_feature(str(tmp_path / "a.h5"))


# ---------------------------------------------------------------------------
# (b) the C++ kNN / k-means and the feature kNN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,k", [(300, 2, 9), (257, 32, 5), (40, 3, 40)])
def test_native_knn_and_kmeans_equal_jax(n, d, k):
    """Same source, same flags: the same neighbours in the same order (ties
    included: integer grid coordinates), the same labels and centroids."""
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, d)).astype(np.float32)
    np.testing.assert_array_equal(tnative.knn_l2(X, k), jnative.knn_l2(X, k))
    grid = tissue_coords(rng, 20, 15)
    np.testing.assert_array_equal(tnative.knn_l2(grid, 9), jnative.knn_l2(grid, 9))
    for a, b in zip(tnative.kmeans(X, 4, seed=7), jnative.kmeans(X, 4, seed=7)):
        np.testing.assert_array_equal(a, b)


def test_knn_l2_device_on_cpu_equals_jax_as_sets():
    """The blocked product + top-k on the CPU against JAX's `knn_l2_device`
    and the C++ kNN: each row's neighbour set (distances without ties),
    the point itself first."""
    X = np.random.default_rng(2).normal(size=(700, 64)).astype(np.float32)
    got = tbg.knn_l2_device(X, 9, block=256, device="cpu")
    want = jbg.knn_l2_device(X, 9, block=256)
    host = tnative.knn_l2(X, 9)
    assert got.shape == want.shape == (700, 9) and got.dtype == np.int32
    assert (got[:, 0] == np.arange(700)).all()
    for a in (want, host):
        assert all(set(r) == set(s) for r, s in zip(got, a))


# ---------------------------------------------------------------------------
# (c) the tools: build_graphs, cluster_patches, big_to_small_patching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_side,device_feats", [(12, False), (24, True)])
def test_build_graph_equals_jax(n_side, device_feats):
    """The graph of a tissue slide: spatial edges and centroids equal; latent
    edges equal (C++ on both, < 257 patches) or, through the feature kNN on
    the CPU here against JAX's, equal as per-node sets."""
    rng = np.random.default_rng(n_side)
    coords = tissue_coords(rng, n_side + 3, n_side)
    feats = rng.normal(size=(len(coords), 32)).astype(np.float32)
    assert (len(coords) > 256) == device_feats
    got = tbg.build_graph(coords, feats, device="cpu")
    want = jbg.build_graph(coords, feats)
    assert set(got) == set(want)
    for k in ("edge_index", "centroid", "num_nodes"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if not device_feats:
        np.testing.assert_array_equal(got["edge_latent"], want["edge_latent"])
    else:
        n = len(coords)
        for e in (got["edge_latent"], want["edge_latent"]):
            assert (e[0] == np.repeat(np.arange(n), 8)).all()
        assert all(set(a) == set(b) for a, b in zip(got["edge_latent"][1].reshape(n, 8),
                                                    want["edge_latent"][1].reshape(n, 8)))


def _run(mod, args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-m", mod, *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_tool_clis_write_what_jax_writes(tmp_path, monkeypatch):
    """`build_graphs` (coordinates as CLAM's .h5, --cpu-feats) and
    `cluster_patches --backend native` from the command line, in a fresh
    interpreter without JAX, against the JAX tools' functions on the same
    files."""
    rng = np.random.default_rng(4)
    for d in ("coords", "feats", "graphs", "clusters"):
        (tmp_path / d).mkdir()
    rows = []
    for i, (w, h) in enumerate(((14, 10), (20, 16), (9, 9))):
        coords = tissue_coords(rng, w, h)
        with h5py.File(tmp_path / "coords" / f"S{i}.h5", "w") as hf:
            hf["coords"] = coords.astype(np.int64)
        torch.save(torch.from_numpy(rng.normal(size=(len(coords), 16)).astype(np.float32)),
                   tmp_path / "feats" / f"S{i}.pt")
        rows.append([f"P{i // 2}", f"S{i}", "1.0", "1"])
    with open(tmp_path / "labels.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "pathology_id", "t", "e"])
        w.writerows(rows)
    out = _run("advmil_tpu_torch.tools.build_graphs",
               ["--coords", "coords", "--feats", "feats", "--save", "graphs", "--cpu-feats"],
               tmp_path)
    assert "[3/3] S2" in out
    out = _run("advmil_tpu_torch.tools.cluster_patches",
               ["--table", "labels.csv", "--feats", "feats", "--save", "clusters",
                "--clusters", "4", "--backend", "native"], tmp_path)
    assert "processed 2/2." in out
    for i in range(3):
        coords = jio.read_patch_coord(str(tmp_path / "coords" / f"S{i}.h5"))
        feats = jio.read_patch_feature(str(tmp_path / "feats" / f"S{i}.pt"))
        want = jbg.build_graph(coords, feats, use_device_for_feats=False)
        with np.load(tmp_path / "graphs" / f"S{i}.npz") as got:
            assert set(got.files) == set(want)
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    for pid, sids in (("P0", ("S0", "S1")), ("P1", ("S2",))):
        feats = np.concatenate([jio.read_patch_feature(str(tmp_path / "feats" / f"{s}.pt"))
                                for s in sids])
        np.testing.assert_array_equal(np.load(tmp_path / "clusters" / f"{pid}.npy"),
                                      jcp.cluster_patient(feats, 4, backend="native"))
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        tcp.cluster_patient(feats, 4, backend="sklearn")


def test_big_to_small_patching_equals_jax(tmp_path):
    """CLAM's level-L .h5 coordinates expanded to the 4x4 patches of level
    L - 1: the coordinates and their attributes as the JAX tool writes them;
    the process list is copied along."""
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(6)
    for i in range(2):
        with h5py.File(src / f"S{i}.h5", "w") as hf:
            d = hf.create_dataset("coords", data=(rng.integers(0, 40, size=(12 + i, 2))
                                                  * 1024).astype(np.int64))
            for k, v in (("downsample", np.asarray([1.0, 1.0])),
                         ("downsampled_level_dim", np.asarray([4000, 3000])),
                         ("level_dim", np.asarray([4000, 3000])), ("name", f"S{i}"),
                         ("patch_level", 1), ("patch_size", 256)):
                d.attrs[k] = v
    (src / "notes.txt").write_text("x")
    (src / "process_list_autogen.csv").write_text("slide_id\nS0\nS1\n")
    tb2s.process_coords(str(src), str(tmp_path / "port"))
    jb2s.process_coords(str(src), str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "S0.h5", "S1.h5", "process_list_autogen.csv"]
    np.testing.assert_array_equal(tb2s.get_scaled_matrix(256, 256),
                                  jb2s.get_scaled_matrix(256, 256))
    for i in range(2):
        with h5py.File(tmp_path / "port" / f"S{i}.h5") as a, \
                h5py.File(tmp_path / "jax" / f"S{i}.h5") as b:
            np.testing.assert_array_equal(a["coords"][:], b["coords"][:])
            assert a["coords"].dtype == b["coords"].dtype and a["coords"].shape == (16 * (12 + i), 2)
            assert set(a["coords"].attrs) == set(b["coords"].attrs)
            for k in b["coords"].attrs:
                va, vb = a["coords"].attrs[k], b["coords"].attrs[k]
                if k == "save_path":
                    assert osp.basename(va) == "port" and osp.basename(vb) == "jax"
                else:
                    np.testing.assert_array_equal(va, vb, err_msg=k)
