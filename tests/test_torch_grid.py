"""The grid route of advmil_tpu_torch's graph path (grid-raster banding of
tissue-masked slide graphs) against advmil_tpu on the CPU in f32: the host
grid functions bit for bit, `grid_place` / `grid_take` with their
gradients, GENConv's grid branch (per layer and on grid-resident input),
PatchGCN's `grid_resident` against the per-layer route, the batcher's grid
tables in shuffled order, and a 2-epoch `exec`.

The slides are tissue masks on a patch grid (`tests/test_grid_banding.py`'s
`_tissue_graph`, gw 10-24, and `_block_slide`), with their spatial kNN
graphs from the JAX package's graph tool. The JAX side takes its jnp paths
on the CPU (the rolls aggregation with the residual edge lists); the port
its plain versions of the kernels. Dropout and noise are off on both sides
where values are compared, as in tests/test_torch_graph.py.
"""
import csv
import glob
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advmil_tpu.data.bags import BagDataset as JBagDataset
from advmil_tpu.data.bags import BucketBatcher as JBucketBatcher
from advmil_tpu.models import backbones as jbb
from advmil_tpu.models import layers as jlayers
from advmil_tpu.ops import segment as jseg
from advmil_tpu_torch import bridge
from advmil_tpu_torch.data.bags import BagDataset, BucketBatcher
from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
from advmil_tpu_torch.models import backbones as tbb
from advmil_tpu_torch.models import layers as tl
from advmil_tpu_torch.ops import segment as tseg
from advmil_tpu_torch.train import baseline as tbaseline
from advmil_tpu_torch.train import handler as thandler
from tests.test_grid_banding import _block_slide, _tissue_graph
from tests.test_torch_baseline import _cfg as _base_cfg
from tests.test_torch_graph import _cfg, _grads_match, _read_pred, _write_yaml, raster_graph

TOL = 1e-5


def _tissue_slide(seed, gw):
    """(coords [N, 2] px, edge_index [2, E] (dst, src) dst-sorted, N) of a
    tissue-masked slide on a gw x gw patch grid."""
    coords, esrc, em, n = _tissue_graph(seed=seed, gw=gw)
    dst, slot = np.nonzero(em > 0)
    return coords, np.stack([dst, esrc[dst, slot]]).astype(np.int64), n


def _write_slide(root, sid, slide, dim, rng):
    coords, ei, n = slide
    np.save(osp.join(root, "feats", f"{sid}.npy"), rng.normal(size=(n, dim)).astype(np.float32))
    np.savez(osp.join(root, "graphs", f"{sid}.npz"), edge_index=ei, edge_latent=ei,
             centroid=coords, num_nodes=np.asarray(n))


@pytest.fixture(scope="module")
def tissue(tmp_path_factory):
    """11 patients: six tissue slides (gw 10-24), two patients with two
    slides each (stacked on one grid), and the JAX test's one-bucket case
    of four compact and four sprawling slides (`_block_slide`) that the area
    DP splits into two groups."""
    root = str(tmp_path_factory.mktemp("tissue"))
    for d in ("feats", "graphs"):
        os.makedirs(osp.join(root, d))
    rng = np.random.default_rng(0)
    patients = [[_tissue_slide(20 + i, gw)] for i, gw in enumerate((10, 14, 18, 24, 12, 16))]
    patients += [[_tissue_slide(40, 12), _tissue_slide(41, 13)],
                 [_tissue_slide(42, 11), _tissue_slide(43, 15)]]
    blocks = [([(10, 10)], 9, 20)] * 2 + [([(5, 5), (15, 15), (25, 25), (35, 35)], 5.5, 40)] * 2
    patients += [[_block_slide(c, r, gw, seed=i)] for i, (c, r, gw) in enumerate(blocks)]
    rows, pids = [], []
    for p, slides in enumerate(patients):
        pid = f"p{p:02d}"
        pids.append(pid)
        for s, slide in enumerate(slides):
            sid = f"{pid}_s{s}"
            _write_slide(root, sid, slide, 8, rng)
            rows.append([pid, sid, f"{1.0 + p:.1f}", str(p % 2)])
    table = osp.join(root, "labels.csv")
    with open(table, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "pathology_id", "t", "e"])
        w.writerows(rows)
    return {"root": root, "pids": pids, "table": table}


def _datasets(t):
    kw = dict(mode="graph", read_format="npy", time_format="ratio",
              graph_path=osp.join(t["root"], "graphs"))
    feats = osp.join(t["root"], "feats")
    return (BagDataset(t["pids"], feats, t["table"], **kw),
            JBagDataset(t["pids"], feats, t["table"], **kw))


# ---------------------------------------------------------------------------
# (a) host functions, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,gw", [(0, 10), (3, 16), (5, 24)])
def test_grid_host_functions_equal_jax(seed, gw):
    """`grid_layout`, `crop_empty_grid_lines` and `build_band_tables_matched`
    (JAX's offsets, band mask and banded edges; the port ships no residual
    edge lists) on a tissue slide's graph laid out on its grid; and the grid
    refusals."""
    coords, esrc, em, n = _tissue_graph(seed=seed, gw=gw)
    got, want = tseg.grid_layout(coords), jseg.grid_layout(coords)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    gidx, W, H = got
    crop = tseg.crop_empty_grid_lines(gidx, W)
    for a, b in zip(crop, jseg.crop_empty_grid_lines(gidx, W)):
        np.testing.assert_array_equal(a, b)
    row, col, Wc, Hc = crop
    g2 = row * Wc + col
    esrc_g = np.zeros((Wc * Hc, em.shape[1]), np.int32)
    em_g = np.zeros_like(esrc_g, dtype=np.float32)
    r, s = np.nonzero(em > 0)
    esrc_g[g2[r], s], em_g[g2[r], s] = g2[esrc[r, s]], 1.0
    a = tseg.build_band_tables_matched(esrc_g, em_g, k=8)
    b = jseg.build_band_tables_matched(esrc_g, em_g, k=8)[:3]
    assert len(a) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    assert a[2].sum() >= 0.7 * em_g.sum()
    for bad in (np.random.default_rng(0).normal(size=(30, 2)).astype(np.float32),
                np.concatenate([coords, coords[:1]])):
        assert tseg.grid_layout(bad) is None and jseg.grid_layout(bad) is None


# ---------------------------------------------------------------------------
# (b) grid_place / grid_take against the JAX custom VJPs
# ---------------------------------------------------------------------------

def _maps(rng, B, N, G, n_real):
    """Per bag a random injection of its n_real rows into G cells; padded
    rows carry the sentinel G, empty cells the sentinel N."""
    gidx = np.full((B, N), G, np.int32)
    ginv = np.full((B, G), N, np.int32)
    for b in range(B):
        cells = rng.choice(G, size=n_real[b], replace=False)
        gidx[b, :n_real[b]] = cells
        ginv[b, cells] = np.arange(n_real[b])
    return gidx, ginv


def test_grid_place_and_take_match_jax_with_gradients():
    rng = np.random.default_rng(1)
    B, N, G, C = 2, 40, 70, 6
    gidx, ginv = _maps(rng, B, N, G, [40, 31])
    y = rng.normal(size=(B, N, C)).astype(np.float32)
    a = rng.normal(size=(B, G, C)).astype(np.float32)
    wp = rng.normal(size=(B, G, C)).astype(np.float32)
    wt = rng.normal(size=(B, N, C)).astype(np.float32)
    for fn, jfn, x, w in ((tseg.grid_place, jseg.grid_place, y, wp),
                          (tseg.grid_take, jseg.grid_take, a, wt)):
        tx = torch.tensor(x, requires_grad=True)
        out = fn(tx, torch.from_numpy(gidx), torch.from_numpy(ginv))
        (out * torch.from_numpy(w)).sum().backward()

        def jloss(xx, f=jfn):
            return jnp.sum(jax.vmap(f)(xx, jnp.asarray(gidx), jnp.asarray(ginv)) * w)

        jout = jax.jit(jax.vmap(jfn))(jnp.asarray(x), jnp.asarray(gidx), jnp.asarray(ginv))
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tx.grad.numpy(),
                                      np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x))))
    # the two are inverse on the valid rows; padded rows come back 0
    back = tseg.grid_take(tseg.grid_place(torch.from_numpy(y), torch.from_numpy(gidx),
                                          torch.from_numpy(ginv)),
                          torch.from_numpy(gidx), torch.from_numpy(ginv))
    np.testing.assert_array_equal(back[0].numpy(), y[0])
    np.testing.assert_array_equal(back[1, :31].numpy(), y[1, :31])
    assert bool((back[1, 31:] == 0).all())


# ---------------------------------------------------------------------------
# (c) GENConv's grid branch and PatchGCN against flax
# ---------------------------------------------------------------------------

GRID_KW = dict(token_budget=1024, min_bucket=256, edges_per_node=8, grid_max_inflation=3.5)


@pytest.fixture(scope="module")
def grid_batch(tissue):
    """The first eval batch of the grid route (3 bags of the tissue patients,
    the last a duplicate tail filler): the port's, and JAX's `batch.extra`
    for the flax side (it adds the residual edge lists of JAX's rolls
    path)."""
    tds, jds = _datasets(tissue)
    b = BucketBatcher(tds, **GRID_KW)
    assert b.grid_on and not b.band_on
    batch = next(iter(b.epoch_batches()))
    jbatch = next(iter(JBucketBatcher(jds, **GRID_KW).epoch_batches()))
    assert batch.feats.shape[0] >= 2 and "band_gidx" in batch.extra
    np.testing.assert_array_equal(batch.idx, jbatch.idx)
    return batch, jbatch.extra


def _jax_band(ex, resident=False):
    band = {"offs": ex["band_offs"], "mask": ex["band_mask"], "res_node": ex["res_node"],
            "res_src": ex["res_src"], "res_mask": ex["res_mask"], "u_rows": ex["band_urows"],
            "u_src": ex["band_usrc"], "u_emask": ex["band_uemask"], "u_inv": ex["band_uinv"]}
    if not resident:
        band.update(gidx=ex["band_gidx"], ginv=ex["band_ginv"])
    return band


@pytest.mark.parametrize("resident", [False, True])
def test_genconv_grid_branch_matches_flax(grid_batch, resident):
    """Per layer (place, banded aggregation in grid space, take back, with
    the padded bag rows' sentinels) and on grid-resident input (band tables
    without the maps): output within 1e-5, every gradient within 2e-5."""
    batch, jextra = grid_batch
    ex = batch.extra
    B, N = batch.feats.shape[:2]
    G = ex["band_mask"].shape[1]
    C = 12
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, G if resident else N, C)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jex = {k: jnp.asarray(v) for k, v in jextra.items()}
    band = _jax_band(jex, resident)
    jmod = jbb.GENConv(C, use_pallas=True)

    def japply(params, xx):
        return jax.vmap(lambda xb, bb: jmod.apply({"params": params}, xb, None, None, None,
                                                  None, bb, deterministic=True))(xx, band)

    @jax.jit        # one compile, not one per eager op
    def jinit(bb):
        p = jmod.init(jax.random.PRNGKey(0), jnp.zeros(x.shape[1:]), None, None, None, None,
                      jax.tree_util.tree_map(lambda v: v[0], bb), deterministic=True)["params"]
        return jax.tree_util.tree_map(lambda a: a * 1.1 + 0.05, p)

    jparams = jinit(band)
    tmod = tbb.GENConv(C).eval()
    tmod.load_state_dict(bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, jparams)))
    drop = ("band_gidx", "band_ginv") if resident else ()
    tex = {k: torch.from_numpy(v) for k, v in ex.items() if k not in drop}
    tx = torch.tensor(x, requires_grad=True)
    np.testing.assert_allclose(tmod(tx, tex).detach().numpy(),
                               np.asarray(jax.jit(japply)(jparams, jnp.asarray(x))), atol=TOL)
    _grads_match(tmod, jparams, lambda: (tmod(tx, tex) * torch.from_numpy(w)).sum(),
                 lambda p, xx: jnp.sum(japply(p, xx) * w), ([tx], [jnp.asarray(x)]),
                 tol=2e-5)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(jlayers, "mask_dropout", lambda rng, rate, x: x)


def test_patchgcn_grid_route_matches_flax(grid_batch, no_jax_dropout):
    """The backbone on the grid route, 2 layers, train mode with dropout off,
    against flax: output within 1e-5, every gradient within 2e-5 (the
    grid-resident stack equals this one in the next test, as the JAX
    package's own test pins it for flax)."""
    batch, jextra = grid_batch
    ex, mask = batch.extra, batch.mask
    B, N, C = batch.feats.shape
    x = batch.feats
    w = np.random.default_rng(5).normal(size=(B, 16)).astype(np.float32)
    jmod = jbb.PatchGCN([C, 16, 16], num_layers=2)
    jex = {k: jnp.asarray(v) for k, v in jextra.items()}
    @jax.jit        # one compile, not one per eager op
    def jinit(xx, ex):
        p = jmod.init({"params": jax.random.PRNGKey(1)}, xx, jnp.asarray(mask), ex,
                      deterministic=True)["params"]
        return jax.tree_util.tree_map(lambda a: a * 1.1 + 0.05, p)

    jparams = jinit(jnp.asarray(x), jex)
    tmod = tbb.load_backbone("graph", [C, 16, 16], num_graph_layers=2)
    tmod.load_state_dict(bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, jparams)))
    tl.set_dropout_rates(tmod.train(), 0.0)
    tex = {k: torch.from_numpy(v) for k, v in ex.items()}
    tx, tmask = torch.tensor(x, requires_grad=True), torch.from_numpy(mask)

    def japply(p, xx):
        return jmod.apply({"params": p}, xx, jnp.asarray(mask), jex, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(2)})

    np.testing.assert_allclose(tmod(tx, tmask, tex).detach().numpy(),
                               np.asarray(jax.jit(japply)(jparams, jnp.asarray(x))), atol=TOL)
    _grads_match(tmod, jparams, lambda: (tmod(tx, tmask, tex) * torch.from_numpy(w)).sum(),
                 lambda p, xx: jnp.sum(japply(p, xx) * w), ([tx], [jnp.asarray(x)]), tol=2e-5)


def test_patchgcn_grid_resident_equals_the_per_layer_route(grid_batch):
    """Same weights, dropout off: grid_resident's forward and gradients equal
    the per-layer place / take route's."""
    batch = grid_batch[0]
    C = batch.feats.shape[2]
    tex = {k: torch.from_numpy(v) for k, v in batch.extra.items()}
    mask = torch.from_numpy(batch.mask)
    res = []
    for resident in (False, True):
        m = tl.init_parameters(tbb.load_backbone("graph", [C, 16, 16], num_graph_layers=3,
                                                 grid_resident=resident), seed=3)
        tl.set_dropout_rates(m.train(), 0.0)
        x = torch.tensor(batch.feats, requires_grad=True)
        out = m(x, mask, tex)
        out.square().sum().backward()
        res.append([out.detach(), x.grad] + [p.grad for p in m.parameters()])
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# (d) the batcher's grid tables against the JAX batcher
# ---------------------------------------------------------------------------

def test_batcher_grid_tables_match_jax(tissue, capsys):
    """Both batchers on the tissue patients: the grid route engages after
    compact banding fails; the same groups (the area DP splits the bucket of
    the block slides) and, over an eval pass and two shuffled epochs from
    one seed on each side, the same batches: every key of JAX's
    `batch.extra` but the residual edge lists `res_*` of its rolls path
    shipped and equal, dtype included."""
    tds, jds = _datasets(tissue)
    tb = BucketBatcher(tds, **GRID_KW)
    out = capsys.readouterr().out
    jb = JBucketBatcher(jds, **GRID_KW)
    assert tb.grid_on and jb._grid_on and not tb.band_on and not jb._band_on
    assert tb.coverage < 0.7 <= tb.grid_coverage and tb.grid_inflation <= 3.5
    assert "grid-raster banded streaming ON" in out and "coverage" in out
    assert tb._groups == jb._groups_list()
    assert tb.num_batches() == jb.num_batches()
    assert len({bn for bn, _, _ in tb._groups}) < len(tb._groups)   # a bucket was split
    assert tb._grid_u_slots == jb._grid_u_slots
    trng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    runs = [(list(tb.epoch_batches()), list(jb.epoch_batches()))]
    runs += [(list(tb.epoch_batches(shuffle=True, rng=trng)),
              list(jb.epoch_batches(shuffle=True, rng=jrng))) for _ in range(2)]
    assert [b.idx.tolist() for b in runs[1][0]] != [b.idx.tolist() for b in runs[2][0]]
    for tbs, jbs in runs:
        assert len(tbs) == len(jbs) == tb.num_batches()
        for a, b in zip(tbs, jbs):
            np.testing.assert_array_equal(a.idx, b.idx)
            np.testing.assert_array_equal(a.feats, b.feats)
            np.testing.assert_array_equal(a.sample_mask, b.sample_mask)
            assert set(a.extra) == {k for k in b.extra if not k.startswith("res_")}
            for k, v in a.extra.items():
                np.testing.assert_array_equal(v, b.extra[k], err_msg=k)
                assert v.dtype == b.extra[k].dtype, k
            n = a.mask.sum(1).astype(int)
            G = a.extra["band_mask"].shape[1]
            for j in range(len(a.idx)):     # sentinels: padded rows, empty cells
                assert (a.extra["band_gidx"][j, n[j]:] == G).all()
                assert (a.extra["band_ginv"][j] < a.feats.shape[1]).sum() == n[j]


def test_bag_sizes_of_h5_npz_and_pt_features_agree(tissue, tmp_path):
    """`bag_size` from the file headers, and the features read, for the same
    bags written as .npy, .npz, .h5 and .pt."""
    import h5py
    tds, _ = _datasets(tissue)
    want = tds.bag_sizes()
    for fmt in ("npz", "h5", "pt"):
        d = tmp_path / fmt
        d.mkdir()
        for pid in tissue["pids"]:
            for sid in tds.pid2sid[pid]:
                x = np.load(osp.join(tissue["root"], "feats", f"{sid}.npy"))
                if fmt == "npz":
                    np.savez(d / f"{sid}.npz", features=x)
                elif fmt == "h5":
                    with h5py.File(d / f"{sid}.h5", "w") as hf:
                        hf["features"] = x
                else:
                    torch.save(torch.from_numpy(x), d / f"{sid}.pt")
        ds = BagDataset(tissue["pids"], str(d), tissue["table"], mode="graph",
                        read_format=fmt, graph_path=osp.join(tissue["root"], "graphs"))
        np.testing.assert_array_equal(ds.bag_sizes(), want)
        np.testing.assert_array_equal(ds[3]["feats"], tds[3]["feats"])


# ---------------------------------------------------------------------------
# (e) exec on the grid route against the JAX handler; grid_resident runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tissue_synth(tmp_path_factory):
    """24 patients of the synthetic table with their slides replaced by
    tissue slides (gw 10, as the JAX package's training equivalence test)."""
    root = str(tmp_path_factory.mktemp("tissue_synth"))
    paths = make_synthetic_dataset(root, n_patients=24, dim=32, min_regions=2,
                                   max_regions=6, seed=8, with_graph=True)
    rng = np.random.default_rng(0)
    for i, f in enumerate(sorted(glob.glob(osp.join(root, "graphs", "*.npz")))):
        _write_slide(root, osp.basename(f)[:-4], _tissue_slide(40 + i, 10), 32, rng)
    return paths


def test_grid_exec_matches_jax(tissue_synth, tmp_path, monkeypatch, no_jax_dropout):
    """2 epochs of the adversarial `exec` on the grid route from the JAX
    run's initial weights: prediction CSVs and C-indices within 1e-4."""
    from advmil_tpu.config import with_defaults as j_with_defaults
    from advmil_tpu.train.handler import AdvHandler as JaxHandler
    from advmil_tpu_torch.main import main as port_main

    over = dict(feat_format="npy", batch_token_budget=2048)
    jh = JaxHandler(j_with_defaults(_cfg(tissue_synth, tmp_path, "jax", rng_impl="threefry",
                                         **over)))
    init = {42: bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, jh.params_G)),
            43: bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, jh.params_D))}
    jm = jh.exec()

    def from_jax_init(model, seed):
        model.load_state_dict(init[seed])
        return tl.set_dropout_rates(model, 0.0)

    monkeypatch.setattr(thandler, "init_parameters", from_jax_init)
    yaml_path = str(tmp_path / "port.yaml")
    _write_yaml(yaml_path, _cfg(tissue_synth, tmp_path, "port", device="cpu", **over))
    [(th, tm)] = port_main(["--config", yaml_path, "--handler", "adv"])
    assert th.loaders["train"][1].grid_on
    for split in ("train", "validation", "test"):
        name = f"train_best_pred_{split}.csv"
        jp = _read_pred(osp.join(str(tmp_path / "jax"), name))
        tp = _read_pred(osp.join(str(tmp_path / "port"), name))
        assert sorted(tp) == sorted(jp) and np.ptp(list(tp.values())) > 0
        np.testing.assert_allclose([tp[k] for k in sorted(jp)], [jp[k] for k in sorted(jp)],
                                   atol=1e-4, err_msg=split)
        assert abs(dict(tm[split])["cindex"] - dict(jm[split])["cindex"]) <= 1e-4


def test_grid_resident_runs_on_both_handlers(tissue_synth, tmp_path, monkeypatch):
    """`graph_grid_resident: True` through both handlers' `exec` (1 epoch,
    dropout off) on the grid route: the flag reaches PatchGCN and each
    writes finite predictions (the stack's values against the per-layer
    route: the test above)."""
    from advmil_tpu_torch.config import with_defaults

    def dropout_off(model, seed):
        return tl.set_dropout_rates(tl.init_parameters(model, seed), 0.0)

    monkeypatch.setattr(thandler, "init_parameters", dropout_off)
    monkeypatch.setattr(tbaseline, "init_parameters", dropout_off)
    preds = {}
    for name, cls, make in (("adv", thandler.AdvHandler, _cfg),
                            ("base", tbaseline.BaselineHandler, _base_cfg)):
        cfg = make(tissue_synth, tmp_path, name, device="cpu", feat_format="npy", epochs=1,
                   bcb_mode="graph", bcb_dims="32-16-16", pdh_dims="16-1",
                   graph_grid_resident=True)
        h = cls(with_defaults(cfg))
        h.exec()
        assert h.loaders["train"][1].grid_on
        assert (h.model if name == "base" else h.gen_model).backbone.grid_resident
        preds[name] = _read_pred(osp.join(str(tmp_path / name), "train_best_pred_test.csv"))
    assert preds["adv"] and sorted(preds["adv"]) == sorted(preds["base"])
    assert np.all(np.isfinite([v for p in preds.values() for v in p.values()]))


# ---------------------------------------------------------------------------
# (f) a repeated edge, route by route against the JAX package
# ---------------------------------------------------------------------------

def _repeat_an_edge(esrc, em, node):
    """The tables with `node`'s second real neighbour replaced by its first:
    the (node, src) pair listed twice. Returns (tables, slot of the copy)."""
    esrc, em = esrc.copy(), em.copy()
    slots = [s for s in range(esrc.shape[1]) if em[node, s] > 0 and esrc[node, s] != node]
    esrc[node, slots[1]] = esrc[node, slots[0]]
    return esrc, em, slots[1]


def _genconv_pair(C, x, port_ex, jax_ex, route, paths=("pallas", "jnp")):
    """GENConv from the same weights on both sides: {"port": output, path:
    the JAX output} for each JAX path: "pallas", the path the JAX package
    takes on the TPU (`pallas_banded_aggregate`, `fused_knn_softmax_aggregate`),
    here in interpret mode; "jnp", its path elsewhere (the residual edge
    lists' rolls, the jnp softmax chain)."""
    import functools
    from advmil_tpu.ops import banded_pallas as jbp
    jex = {k: jnp.asarray(v) for k, v in jax_ex.items()}
    band = _jax_band(jex) if route == "grid" else (
        {"offs": jex["band_offs"], "mask": jex["band_mask"], "res_node": jex["res_node"],
         "res_src": jex["res_src"], "res_mask": jex["res_mask"],
         "u_rows": jex["band_urows"], "u_src": jex["band_usrc"],
         "u_emask": jex["band_uemask"], "u_inv": jex["band_uinv"]}
        if route == "banded" else None)
    es, em = jex.get("edge_src"), jex.get("edge_mask")
    jmod = jbb.GENConv(C, use_pallas=True)
    axes = tuple(None if a is None else 0 for a in (es, em, band))

    def japply(params, xx, es, em, band):
        return jax.vmap(lambda xb, eb, mb, bb: jmod.apply(
            {"params": params}, xb, eb, mb, None, None, bb, deterministic=True),
            in_axes=(0,) + axes)(xx, es, em, band)

    # the parameters do not depend on the route: init on a 4-node dense graph
    jparams = jmod.init(jax.random.PRNGKey(0), jnp.zeros((4, C)), jnp.zeros((4, 1), jnp.int32),
                        jnp.ones((4, 1)), None, None, None, deterministic=True)["params"]
    jparams = jax.tree_util.tree_map(lambda a: a * 1.1 + 0.05, jparams)
    tmod = tbb.GENConv(C).eval()
    tmod.load_state_dict(bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, jparams)))
    tex = {k: torch.from_numpy(v) for k, v in port_ex.items()}
    out = {"port": tmod(torch.from_numpy(x), tex).detach().numpy()}
    for path in paths:
        with pytest.MonkeyPatch.context() as mp:
            if path == "pallas":
                mp.setattr(jbb, "pallas_available", lambda: True)
                mp.setattr(jbb, "pallas_banded_aggregate",
                           functools.partial(jbp.pallas_banded_aggregate, interpret=True))
                mp.setattr(jbb, "fused_knn_softmax_aggregate",
                           functools.partial(jseg.fused_knn_softmax_aggregate, interpret=True))
            # a new function per path: jit caches by function, not by the patches
            out[path] = np.asarray(jax.jit(lambda *a: japply(*a))(jparams, jnp.asarray(x), es,
                                                                   em, band))
    return out


def _route_tables(route, esrc, em, N):
    """(port extra, JAX extra) of one [N, epn] table on the dense or banded
    route, each built by its own package's builders."""
    from advmil_tpu_torch.ops import banded as tbanded
    esrc, em = esrc[None], em[None]
    if route == "dense":
        ex = {"edge_src": esrc, "edge_mask": em}
        return ex, dict(ex)
    offs, bmask, *_ = tseg.build_band_tables(esrc[0], em[0], res_slots=128)
    u_slots = 8 * (1 + tseg.band_coverage(esrc[0], em[0])[2] // 8)
    u = tbanded.build_u_tables(esrc[0], em[0], bmask, u_slots=u_slots)
    port = {"band_offs": offs[None], "band_mask": bmask[None], "band_urows": u[0][None],
            "band_usrc": u[1][None], "band_uemask": u[2][None],
            "band_uinv": tbanded.build_u_inv(u[0], N)[None]}
    joffs, jbmask, rn, rs, rm = jseg.build_band_tables(esrc[0], em[0], res_slots=128)
    jx = dict(port, band_offs=joffs[None], band_mask=jbmask[None], res_node=rn[None],
              res_src=rs[None], res_mask=rm[None])
    return port, jx


def _grid_tables(tmp_path, slides):
    """The grid route's first batch for `slides` (coords, edge_index, n) in
    both packages' batchers: (port batch, JAX extra)."""
    root = str(tmp_path)
    for d in ("feats", "graphs"):
        os.makedirs(osp.join(root, d), exist_ok=True)
    rng = np.random.default_rng(0)
    rows = []
    for p, slide in enumerate(slides):
        _write_slide(root, f"p{p:02d}_s0", slide, 8, rng)
        rows.append([f"p{p:02d}", f"p{p:02d}_s0", f"{1.0 + p:.1f}", str(p % 2)])
    table = osp.join(root, "labels.csv")
    with open(table, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "pathology_id", "t", "e"])
        w.writerows(rows)
    tds, jds = _datasets({"root": root, "pids": [r[0] for r in rows], "table": table})
    tb = BucketBatcher(tds, **GRID_KW)
    assert tb.grid_on and not tb.band_on
    batch = next(iter(tb.epoch_batches()))
    jbatch = next(iter(JBucketBatcher(jds, **GRID_KW).epoch_batches()))
    np.testing.assert_array_equal(batch.idx, jbatch.idx)
    return batch, jbatch.extra


@pytest.mark.parametrize("route", ["dense", "banded", "grid"])
def test_repeated_edge_matches_jax_route_by_route(tmp_path, route):
    """A node that lists the same (dst, src) pair twice, through one GENConv
    from the same weights, the port's route against the JAX package's same
    route, each side with its own table builders: within 1e-5 of the path
    the JAX package takes on the TPU (its Pallas kernels, here in interpret
    mode), which the port's kernels translate; on the same graph without
    the copy, within 1e-5 of its jnp path. Whether the copy counts (the
    node's output moves against the graph without it): twice on the
    dense route (two slots) and on the banded route (one banded slot, one
    residual edge: `build_band_tables` bands by slot position), in the port
    and in both JAX paths. On the grid route the copy's offset is banded
    (`build_band_tables_matched` ORs both copies into one slot) and the
    node also has an edge off the bands, so it is a residual row: the port
    and the JAX Pallas path recompute it from its full edge slice (twice),
    the JAX jnp path adds the band's one slot to the residual edge list
    (once). The two JAX paths disagree as the port's dense and grid routes
    do: the precondition (sources unique per node,
    `advmil_tpu/ops/segment.py:502-503`) is the JAX package's own."""
    C = 12
    rng = np.random.default_rng(8)
    if route == "grid":
        coords, ei, n = _tissue_slide(20, 12)
        dst, src = ei
        node = int(np.bincount(dst).argmax())
        first, second = np.nonzero(dst == node)[0][:2]
        src_rep = src.copy()
        src_rep[second] = src[first]
        other = _tissue_slide(21, 13)
        graphs = {"repeated": (coords, np.stack([dst, src_rep]), n),
                  "without": (coords, np.stack([np.delete(dst, second),
                                                np.delete(src, second)]), n)}
        tables = {k: _grid_tables(tmp_path / k, [g, other]) for k, g in graphs.items()}
        batch = tables["repeated"][0]
        x = rng.normal(size=batch.feats.shape[:2] + (C,)).astype(np.float32)
        row = int(np.nonzero(batch.idx == 0)[0][0])
        tables = {k: (b.extra, jx) for k, (b, jx) in tables.items()}
    else:
        N, node, row = 96, 20, 0
        esrc, em = raster_graph(N, 8, rng, epn=9, irregular=6, empty=(3,))
        rep_src, rep_em, slot = _repeat_an_edge(esrc, em, node)
        plain_em = rep_em.copy()
        plain_em[node, slot] = 0.0
        x = rng.normal(size=(1, N, C)).astype(np.float32)
        tables = {k: _route_tables(route, rep_src, m, N)
                  for k, m in (("repeated", rep_em), ("without", plain_em))}
    rep = _genconv_pair(C, x, *tables["repeated"], route)
    plain = _genconv_pair(C, x, *tables["without"], route, paths=("jnp",))
    np.testing.assert_allclose(rep["port"], rep["pallas"], atol=TOL)
    np.testing.assert_allclose(plain["port"], plain["jnp"], atol=TOL)
    gap = {k: float(np.abs(rep[k][row, node] - plain["jnp"][row, node]).max())
           for k in ("port", "pallas", "jnp")}
    twice = {k: g > 1e-3 for k, g in gap.items()}
    assert twice == {"port": True, "pallas": True, "jnp": route != "grid"}, gap
