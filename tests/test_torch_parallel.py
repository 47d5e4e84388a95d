"""Data and instance parallelism of advmil_tpu_torch (`parallel/`) on the CPU
against advmil_tpu's sharded runs and the port's own single-process run.

The port's ranks are gloo processes on 127.0.0.1 (two spawns: a 4-rank
world holding a 1x4 and a 2x2 dp x inst grid, and a 2-rank dp world); their
rank-side code is `tests/torch_dist_workers.py`, which imports no JAX. The
JAX side runs in this process on the 8 virtual CPU devices of
`tests/conftest.py` (`make_mesh(8)`, `make_mesh_2d(2, 4)`), its Pallas
kernels in interpret mode as `tests/test_instance_parallel.py` runs them.
Dropout and noise are off on both sides, as in `tests/test_torch_train.py`.

Tolerances: the sequence-parallel attention against JAX's in f32 within
`f32_tol` (2^-16 of the largest value, plus 1e-5 relative: the f32 form of
`ops/attention.rounded_tol`); the models at the JAX package's own
instance-parallel tolerances (2e-5 forward, 3e-5 gradients); parameters
after a training step within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advmil_tpu.config import with_defaults as j_with_defaults
from advmil_tpu.data.bags import BucketBatcher as JBucketBatcher
from advmil_tpu.models import layers as jlayers
from advmil_tpu_torch import bridge
from advmil_tpu_torch.config import with_defaults
from advmil_tpu_torch.data.bags import BucketBatcher, prepare_dataset
from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
from advmil_tpu_torch.ops import attention as tattn
from advmil_tpu_torch.main import handler_class
from advmil_tpu_torch.parallel import launch
from advmil_tpu_torch.train.common import graph_banded
from tests import torch_dist_workers as workers
from tests.test_torch_baseline import _cfg as base_cfg
from tests.test_torch_train import _cfg as adv_cfg, _np_tree


def f32_tol(want) -> dict:
    return dict(atol=float(np.abs(want).max()) * 2.0 ** -16, rtol=1e-5)


# ---------------------------------------------------------------------------
# the batcher's multiples
# ---------------------------------------------------------------------------

def test_batcher_multiples_match_jax(tmp_path):
    """batch_multiple 8 and n_multiple 16 * 4: the same groups, bucket sizes
    and batch sizes as the JAX package's batcher; with 1 and 16 the batches
    are what they were."""
    from advmil_tpu.data.bags import BagDataset as JBagDataset
    paths = make_synthetic_dataset(str(tmp_path), n_patients=24, dim=16, min_regions=2,
                                   max_regions=40, seed=3, feat_format="pt")
    pids = [f"P{i:04d}" for i in range(24)]
    tds = prepare_dataset(pids, {"path_patch": paths["path_patch"],
                                 "path_label": paths["path_label"], "bcb_mode": "patch",
                                 "feat_format": "pt", "time_format": "ratio"})
    jds = JBagDataset(pids, paths["path_patch"], paths["path_label"], mode="patch",
                      read_format="pt", time_format="ratio")
    for kw in ({"batch_multiple": 8, "n_multiple": 64}, {}):
        tb = BucketBatcher(tds, token_budget=2048, min_bucket=64, bucket_growth=1.5, **kw)
        jb = JBucketBatcher(jds, token_budget=2048, min_bucket=64, bucket_growth=1.5, **kw)
        assert tb.buckets == jb.buckets
        assert all(n % kw.get("n_multiple", 16) == 0 for n in tb.buckets)
        assert [tb.batch_size_for(n) for n in tb.buckets] == \
            [jb.batch_size_for(n) for n in jb.buckets]
        tbs, jbs = list(tb.epoch_batches()), list(jb.epoch_batches())
        assert len(tbs) == len(jbs)
        for a, b in zip(tbs, jbs):
            np.testing.assert_array_equal(a.idx, b.idx)
            np.testing.assert_array_equal(a.feats, b.feats)
            np.testing.assert_array_equal(a.sample_mask, b.sample_mask)
            assert len(a.idx) % kw.get("batch_multiple", 1) == 0


# ---------------------------------------------------------------------------
# inputs, references, and the two spawns
# ---------------------------------------------------------------------------

FLASH = dict(B=4, L=128, H=4, Dh=32)


def _flash_inputs():
    rng = np.random.default_rng(5)
    B, L, H, Dh = FLASH["B"], FLASH["L"], FLASH["H"], FLASH["Dh"]
    d = {n: rng.normal(size=(B, L, H, Dh)).astype(np.float32) for n in ("q", "k", "v", "w")}
    mask = np.ones((B, L), np.float32)
    mask[0, 75:] = 0.0         # ragged: padding spans inst shards unevenly
    mask[2, 20:] = 0.0         # real keys on the first shard only
    mask[3] = 0.0              # a fully masked bag
    d["mask"] = mask
    return d


def _jax_flash(d):
    """JAX's masked_flash_attention_inst on make_mesh_2d(2, 4), p = 0:
    out and the gradients of sum(out * w)."""
    from advmil_tpu.ops.attention import masked_flash_attention_inst
    from advmil_tpu.parallel.mesh import make_mesh_2d
    mesh = make_mesh_2d(2, 4)
    mask, w = jnp.asarray(d["mask"]), jnp.asarray(d["w"])

    def loss(q, k, v):
        out = masked_flash_attention_inst(q, k, v, mask, mesh, interpret=True)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(d[n]) for n in ("q", "k", "v")))
    return {"out": np.asarray(out), **{n: np.asarray(g) for n, g in
                                       zip(("dq", "dk", "dv"), grads)}}


# model cases: JAX module, port spec, inputs with N = 192 (12 regions)
MODEL_DIMS = (64, 32, 32)


BAG_NODES = (192, 88, 64, 32)      # bag 3 lies on the first inst shard only


def _grid_graph(n, W, rng):
    """A bag of n nodes on a W-wide grid with a tenth of the cells empty:
    (rc [n, 2], dst-sorted [2, E] edges from each node's occupied 8
    neighbours and, for one node in ten, a node half the bag away (a
    residual row); no edge twice)."""
    cells = np.sort(rng.choice(int(n * 1.1) + W, size=n, replace=False))
    rc = np.stack([cells // W, cells % W], 1)
    at = {int(c): i for i, c in enumerate(cells)}
    edges = []
    for i, (r, c) in enumerate(rc):
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                j = at.get(int((r + dr) * W + c + dc)) if 0 <= c + dc < W else None
                if (dr or dc) and j is not None:
                    edges.append((i, j))
        far = (i + n // 2) % n
        if i % 10 == 3 and (i, far) not in edges and far != i:
            edges.append((i, far))
    return rc, np.asarray(edges, np.int64).T


def _graph_inputs(route, rng):
    """(port tables, JAX tables) of the bags of BAG_NODES on one route. The
    dense and banded routes' raster graphs span the padded rows too (as in
    tests/test_torch_graph.py); the grid route's JAX side is the dense route
    of the same graphs (the grid route computes the same aggregation)."""
    from tests.test_torch_graph import _graph_extras
    B, N = len(BAG_NODES), BAG_NODES[0]
    if route in ("dense", "banded"):
        return _graph_extras(B, N, 9, rng, route)
    from advmil_tpu_torch.data.bags import dense_table, grid_tables
    W = 14
    graphs = [_grid_graph(n, W, rng) for n in BAG_NODES]
    grid_n = -(-max(int(rc[:, 0].max() + 1) * W for rc, _ in graphs) // 128) * 128
    tabs = [grid_tables(e, rc, W, grid_n, N, 9, u_slots=32)[0] for rc, e in graphs]
    port = {k: np.stack([t[k] for t in tabs]) for k in tabs[0]}
    dense = [dense_table(e, N, 9)[:2] for _, e in graphs]
    return port, {"edge_src": np.stack([d[0] for d in dense]),
                  "edge_mask": np.stack([d[1] for d in dense])}


def _model_inputs(seed, coords=False, t=False, graph=None, cluster=False):
    rng = np.random.default_rng(seed)
    B, N, C = len(BAG_NODES), BAG_NODES[0], 64
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = np.zeros((B, N), np.float32)
    for b, n in enumerate(BAG_NODES):
        mask[b, :n] = 1.0
    d = {"x": x * mask[..., None], "mask": mask}
    if coords:
        d["coords"] = rng.integers(0, 40, size=(B, N // 16, 2)).astype(np.float32)
    if t:
        d["t"] = rng.uniform(0.1, 1.0, size=(B, 1)).astype(np.float32)
    if graph:
        d["graph"], d["jax_graph"] = _graph_inputs(graph, rng)
    if cluster:
        d["cluster_id"] = np.where(mask > 0, rng.integers(0, 8, size=(B, N)),
                                   -1).astype(np.int32)
    return d


_DISC_KW = dict(netx_in_dim=64, netx_out_dim=32, nety_in_dim=1, nety_hid_dims=(16, 32),
                prj_path="x", inner_product="instance")
MODEL_CASES = {
    "esat": ({"kind": "esat", "dims": MODEL_DIMS,
              "kw": {"nhead": 4, "flash_min_len": 2}}, {}),
    "esat_coords_pe": ({"kind": "esat", "dims": MODEL_DIMS,
                        "kw": {"nhead": 4, "flash_min_len": 2}}, {"coords": True}),
    "abmil": ({"kind": "abmil", "dims": MODEL_DIMS}, {}),
    "disc_rlip": ({"kind": "disc", "kw": _DISC_KW}, {"t": True}),
    "disc_rlip_ksize3_gapool": ({"kind": "disc", "kw": dict(_DISC_KW, netx_ksize=3,
                                                            netx_backbone="gapool")},
                                {"t": True}),
    "graph_dense": ({"kind": "graph", "dims": MODEL_DIMS, "kw": {"num_graph_layers": 2}},
                    {"graph": "dense"}),
    "graph_banded": ({"kind": "graph", "dims": MODEL_DIMS, "kw": {"num_graph_layers": 2}},
                     {"graph": "banded"}),
    "graph_grid": ({"kind": "graph", "dims": MODEL_DIMS, "kw": {"num_graph_layers": 2}},
                   {"graph": "grid"}),
    "graph_grid_resident": ({"kind": "graph", "dims": MODEL_DIMS,
                             "kw": {"num_graph_layers": 2, "grid_resident": True}},
                            {"graph": "grid"}),
    "cluster": ({"kind": "cluster", "dims": MODEL_DIMS}, {"cluster": True}),
}


def _jax_model(spec, d):
    """(flax variables as a torch state_dict, reference): the JAX
    single-device model's initial weights, and a function that computes its
    eval-mode output and every parameter gradient of sum(out^2) as
    (out, {torch name: grad})."""
    from advmil_tpu.models import backbones as jbb
    from advmil_tpu.models import gan as jgan
    kw = dict(spec.get("kw", {}))
    x, mask = jnp.asarray(d["x"]), jnp.asarray(d["mask"])
    if spec["kind"] == "disc":
        m = jgan.PrjDiscriminator(**kw)
        args = (x, jnp.asarray(d["t"]), mask)
    elif spec["kind"] in ("graph", "cluster"):
        kw.pop("grid_resident", None)       # with dropout off, the per-layer route
        m = jbb.load_backbone(spec["kind"], list(spec["dims"]), **kw)
        extra = ({k: jnp.asarray(v) for k, v in d["jax_graph"].items()}
                 if spec["kind"] == "graph" else jnp.asarray(d["cluster_id"]))
        args = (x, mask, extra)
    else:
        kw.pop("flash_min_len", None)
        m = (jbb.DualTransHS(spec["dims"], use_pallas=False, **kw) if spec["kind"] == "esat"
             else jbb.ABMIL(spec["dims"], **kw))
        args = (x, mask, jnp.asarray(d["coords"]) if "coords" in d else None)
    key = jax.random.PRNGKey(3)
    params = m.init({"params": key, "dropout": key}, *args, deterministic=True)["params"]

    def loss(params):
        out = m.apply({"params": params}, *args, deterministic=True)
        return jnp.sum(out ** 2), out

    def reference():
        (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        return np.asarray(out), {k: v.numpy() for k, v in
                                 bridge.flax_to_torch(_np_tree(g)).items()}
    return bridge.flax_to_torch(_np_tree(params)), reference


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """36 patients of 4-16 regions (one 256-patch bucket), dim 64."""
    root = str(tmp_path_factory.mktemp("par_data"))
    return make_synthetic_dataset(root, n_patients=36, dim=64, min_regions=4,
                                  max_regions=16, seed=5, feat_format="pt", with_graph=True)


def _batches(cfg, n):
    """The first n global batches of 8 bags (N = 256) in eval order (on the
    config's graph route)."""
    ds = prepare_dataset([f"P{i:04d}" for i in range(36)], cfg)
    batches = list(BucketBatcher(ds, token_budget=2048,
                                 banded=graph_banded(cfg)).epoch_batches())[:n]
    assert all(len(b.idx) == 8 and b.feats.shape[1] == 256 for b in batches)
    return batches


# step cases: name -> (handler, config overrides, micro-batches, JAX meshes to
# compare with, grids to run on). The modes without a JAX reference here are
# held to the port's single process (each is held to JAX single-device in
# its own test file). The `*_dropout` cases keep the configs' dropout rates
# (and G's noise) on: below the flash gate every mask is drawn at the global
# shape and cut to the rank's block, so the grid's step is the single
# process's step.
_COX = dict(task="surv_cox", bcb_dims="64-64-64", pdh_dims="64-1", opt_net_lr=0.00008)
_DISC = dict(task="disc_gansurv", time_format="quantile", gen_dims="128-4",
             disc_nety_in_dim=4)
STEP_CASES = {
    "adv": ("adv", {}, 1, {"dp8": {"dp_devices": 8},
                           "2x4": {"dp_devices": 2, "inst_devices": 4}}, ("2x1", "2x2")),
    "cox": ("base", _COX, 1, {"dp8": {"dp_devices": 8}}, ("2x1", "2x2")),
    "accum": ("adv", {"accum_steps": 2}, 2, {"dp8": {"dp_devices": 8}}, ("2x1", "2x2")),
    "disc_hidden_labels": ("adv", _DISC, 1, {}, ("2x1", "2x2")),
    "adahessian_nll": ("base", dict(task="surv_nll", bcb_dims="64-64-64", pdh_dims="64-4",
                                    opt_net="adahessian"), 1, {}, ("2x1", "2x2")),
    "adv_dropout": ("adv", dict(gen_noi_noise="0-1", times_test_sample=3, flash_min_len=512),
                    1, {}, ("2x1", "2x2")),
    "abmil_dropout": ("base", dict(flash_min_len=512), 1, {}, ("2x1", "2x2")),
    "graph": ("base", dict(bcb_mode="graph", bcb_dims="64-16-16", pdh_dims="16-1"), 1, {},
              ("2x1", "2x2")),
    "graph_dense": ("base", dict(bcb_mode="graph", bcb_dims="64-16-16", pdh_dims="16-1",
                                 graph_banded="off"), 1, {}, ("2x2",)),
    "cluster": ("adv", dict(bcb_mode="cluster", bcb_dims="64-128-128"), 1, {},
                ("2x1", "2x2")),
    "graph_dropout": ("base", dict(bcb_mode="graph", bcb_dims="64-16-16", pdh_dims="16-1"),
                      1, {}, ("2x2",)),
    "cluster_dropout": ("adv", dict(bcb_mode="cluster", bcb_dims="64-128-128",
                                    gen_noi_noise="0-1", times_test_sample=3), 1, {},
                        ("2x2",)),
}


def _make_cfg(synth, tmp_path, handler, over):
    make = adv_cfg if handler == "adv" else base_cfg
    if handler == "base":
        over = dict({"bcb_dims": "64-64-64", "pdh_dims": "64-1"}, **over)
    else:
        over = dict(over, path_cluster=synth["path_cluster"])
    return lambda name, **o: make(synth, tmp_path, name, **over, **o)


def _port_weights(handler, h):
    """A handler's weights as the port's state dicts (a JAX handler's
    through the bridge)."""
    if hasattr(h, "state"):
        if handler == "adv":
            return {"G": bridge.flax_to_torch(_np_tree(h.state.params_G)),
                    "D": bridge.flax_to_torch(_np_tree(h.state.params_D))}
        return {"net": bridge.flax_to_torch(_np_tree(h.state.params))}
    nets = {"G": h.gen_model, "D": h.disc_model} if handler == "adv" else {"net": h.model}
    return {k: {n: v.clone() for n, v in m.state_dict().items()} for k, m in nets.items()}


def _visible(batches):
    """Label visibility per batch: every third bag's label hidden."""
    return [(np.arange(len(b.idx)) % 3 != 0).astype(np.float32) for b in batches]


def _run_jax_steps(jh, batches):
    for batch in batches:
        dev = {"feats": batch.feats, "mask": batch.mask, "label": batch.label,
               "sample_mask": batch.sample_mask, "visible": np.ones_like(batch.sample_mask)}
        jh.state, _, _ = jh.train_step(jh.state, jh._ship(dev))


@pytest.fixture(scope="module")
def runs(synth, tmp_path_factory):
    """Every reference, and both spawns' results. The cases go to the two
    spawned worlds first; the references are computed here while the ranks
    run."""
    from concurrent.futures import ThreadPoolExecutor
    from advmil_tpu.train.baseline import BaselineHandler as JBase
    from advmil_tpu.train.handler import AdvHandler as JAdv
    tmp = tmp_path_factory.mktemp("par_runs")
    out = {"flash_inputs": _flash_inputs(), "jax_models": {}, "steps": {}}
    cases4, cases2, later = [], [], []
    for name, grid in (("1x4", (1, 4)), ("2x2", (2, 2))):
        cases4.append({"kind": "flash", "name": f"flash_{name}", "dp": grid[0],
                       "inst": grid[1], "inputs": out["flash_inputs"], "p": 0.0,
                       "seed": None})
    cases4.append({"kind": "flash", "name": "flash_2x2_dropout", "dp": 2, "inst": 2,
                   "inputs": out["flash_inputs"], "p": 0.25, "seed": 987654321})
    for i, (name, (spec, inp)) in enumerate(MODEL_CASES.items()):
        d = _model_inputs(10 + i, **inp)
        weights, reference = _jax_model(spec, d)
        later.append(lambda name=name, reference=reference:
                     out["jax_models"].__setitem__(name, reference()))
        cases4.append({"kind": "model", "name": f"model_{name}", "dp": 2, "inst": 2,
                       "model": spec, "weights": weights, "inputs": d})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "mask_dropout", lambda rng, rate, x: x)
        for name, (handler, over, n, meshes, grids) in STEP_CASES.items():
            make = _make_cfg(synth, tmp, handler, over)
            jcls = JAdv if handler == "adv" else JBase
            cfg1 = with_defaults(make(f"p1_{name}", device="cpu"))
            # every JAX handler of a case starts from the same seeded weights
            jhs = {m: jcls(j_with_defaults(make(f"j_{name}_{m}", rng_impl="threefry", **o)))
                   for m, o in meshes.items()}
            weights = _port_weights(handler, next(iter(jhs.values())) if jhs
                                    else handler_class(handler)(cfg1))
            batches = _batches(cfg1, n)
            step = {"kind": "step", "handler": handler, "weights": weights,
                    "batches": batches,
                    "visible": _visible(batches) if name.startswith("disc") else None,
                    "dropout": name.endswith("_dropout")}

            def reference(name=name, handler=handler, jhs=jhs, step=step, make=make):
                jax_after = {}
                for m, jh in jhs.items():
                    _run_jax_steps(jh, step["batches"])
                    jax_after[m] = _port_weights(handler, jh)
                single = workers.step_case(torch.device("cpu"), dict(
                    step, cfg=make(f"p1s_{name}", device="cpu")))
                out["steps"][name] = {"jax": jax_after, "single": single,
                                      "init": step["weights"]}
            later.append(reference)
            for grid in grids:
                dp, inst = (int(x) for x in grid.split("x"))
                (cases4 if dp * inst == 4 else cases2).append(dict(
                    step, name=f"step_{name}_{grid}",
                    cfg=make(f"p_{name}_{grid}", device="cpu", dp_devices=dp,
                             inst_devices=inst)))
        with ThreadPoolExecutor(2) as ex:
            world4 = ex.submit(launch.run_ranks, workers.run_cases, ["cpu"] * 4, (cases4,))
            world2 = ex.submit(launch.run_ranks, workers.run_cases, ["cpu"] * 2, (cases2,))
            out["jax_flash"] = _jax_flash(out["flash_inputs"])
            for fn in later:
                fn()
            out["world4"], out["world2"] = world4.result(), world2.result()
    return out


# ---------------------------------------------------------------------------
# the sequence-parallel attention op
# ---------------------------------------------------------------------------

def _assemble(results, name, key, shape):
    """The global tensor from every rank's local block of a flash case."""
    full = np.zeros(shape, np.float32)
    B, L = shape[:2]
    for r in results:
        res = r[name]
        dp = 2 if "2x2" in name else 1
        inst = 4 // dp
        rows = slice(res["dp_rank"] * B // dp, (res["dp_rank"] + 1) * B // dp)
        cols = slice(res["inst_rank"] * L // inst, (res["inst_rank"] + 1) * L // inst)
        full[rows, cols] = res[key]
    return full


@pytest.mark.parametrize("grid", ["1x4", "2x2"])
def test_flash_inst_matches_jax(runs, grid):
    """Output and dQ / dK / dV of the port's masked_flash_attention_inst
    (gathered K / V, reduce-scattered dK / dV) against JAX's on a 2x4 mesh,
    p = 0, with a ragged and a fully masked bag."""
    shape = tuple(FLASH[k] for k in ("B", "L", "H", "Dh"))
    for key in ("out", "dq", "dk", "dv"):
        got = _assemble(runs["world4"], f"flash_{grid}", key, shape)
        want = runs["jax_flash"][key]
        np.testing.assert_allclose(got, want, err_msg=key, **f32_tol(want))
    assert np.all(_assemble(runs["world4"], f"flash_{grid}", "out", shape)[3] == 0.0)


def test_flash_inst_dropout_uses_the_rank_seed(runs):
    """p = 0.25: each rank's output is the plain attention of its local rows
    against the gathered keys under the keep mask of seed + inst_rank * 7919."""
    d = runs["flash_inputs"]
    B, L = FLASH["B"], FLASH["L"]
    for r in runs["world4"]:
        res = r["flash_2x2_dropout"]
        rows = slice(res["dp_rank"] * B // 2, (res["dp_rank"] + 1) * B // 2)
        cols = slice(res["inst_rank"] * L // 2, (res["inst_rank"] + 1) * L // 2)
        q = torch.from_numpy(d["q"][rows, cols])
        k, v, m = (torch.from_numpy(d[n][rows]) for n in ("k", "v", "mask"))
        want = tattn.masked_attention_reference(
            q, k, v, m, 0.25, 987654321 + res["inst_rank"] * tattn.INST_SEED_STRIDE).numpy()
        np.testing.assert_allclose(res["out"], want, **f32_tol(want))
        undropped = tattn.masked_attention_reference(q, k, v, m).numpy()
        assert np.abs(res["out"] - undropped).max() > 1e-2
    outs = [r["flash_2x2_dropout"]["out"] for r in runs["world4"]]
    assert np.abs(outs[0] - outs[1]).max() > 1e-2   # inst ranks 0 / 1: other masks


# ---------------------------------------------------------------------------
# models on a 2x2 grid against the JAX single-device model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_on_2x2_grid_matches_jax(runs, name):
    """Forward (train mode without dropout: the flash op on the local rows,
    and eval mode: the plain branch on gathered K / V) and every parameter
    gradient of sum(out^2), summed over the world."""
    want, wgrads = runs["jax_models"][name]
    res = runs["world4"][0][f"model_{name}"]
    for r in runs["world4"][1:]:
        np.testing.assert_array_equal(r[f"model_{name}"]["out"], res["out"])
    np.testing.assert_allclose(res["out"], want, atol=2e-5)
    np.testing.assert_allclose(res["out_eval"], want, atol=2e-5)
    assert set(res["grads"]) == set(wgrads)
    for k, g in wgrads.items():
        np.testing.assert_allclose(res["grads"][k], g, atol=3e-5, err_msg=k)


# ---------------------------------------------------------------------------
# training steps on a dp 2 and a 2x2 grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,grid", [(n, g) for n, c in STEP_CASES.items() for g in c[4]])
def test_step_on_grid_matches_single_process_and_jax(runs, name, grid):
    """One f32 step (accum: two micro-steps, one update) from the same
    weights on the same global batch of 8 bags: every parameter within 1e-5
    of the port's single-process step and, where the case names meshes, of
    the JAX handler's step on make_mesh(8) (and, for the adversarial step,
    make_mesh_2d(2, 4)); the losses equal on every rank. The cases without a
    JAX mesh: disc_gansurv with a third of the labels hidden, AdaHessian
    (its double backward through the collectives), ESAT and ABMIL with
    dropout and noise on (every dropout site of the encoder, the attention
    probabilities, the discriminator's instance MLP and its GAPool, ABMIL's
    gated attention), graph mode (dp 2 and 2x2 on the banded route, 2x2 on
    the dense route) and cluster mode (dp 2 and 2x2), both also on 2x2 with
    dropout on (PatchGCN's node-row draws, DeepAttnMISL's cluster-level
    ones, which every inst rank draws whole)."""
    world = runs["world4"] if grid == "2x2" else runs["world2"]
    res = world[0][f"step_{name}_{grid}"]
    for r in world[1:]:
        assert r[f"step_{name}_{grid}"]["metrics"] == res["metrics"]
    ref = runs["steps"][name]
    for a, b in zip(res["metrics"], ref["single"]["metrics"]):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6, err_msg=k)
    single = ref["single"]
    for net, sd in single["grads"].items():
        assert set(res["grads"][net]) == set(sd)
        for k, v in sd.items():
            np.testing.assert_allclose(res["grads"][net][k], v, atol=1e-6, rtol=1e-5,
                                       err_msg=f"gradient {net} {k}")
    for what, want in [("single", single["params"])] + \
            [(f"jax {m}", w) for m, w in ref["jax"].items()]:
        for net, sd in want.items():
            for k, v in sd.items():
                got, v = res["params"][net][k], np.asarray(v)
                if single["nu"] is not None and k in single["nu"]:
                    # AdaHessian's first step is lr * g / |h|: its relative
                    # error is that of g plus that of the Hessian diagonal
                    # estimate h, which divides; a step that is large where
                    # |h| is small carries it (bound: twice the measured sum)
                    h_s, h_g = np.sqrt(single["nu"][k]), np.sqrt(res["nu"][k])
                    np.testing.assert_allclose(h_g, h_s, rtol=1e-3, atol=1e-7,
                                               err_msg=f"Hessian diagonal {k}")
                    g_s, g_g = single["grads"][net][k], res["grads"][net][k]
                    rel = (np.abs(h_g - h_s) / np.maximum(h_s, 1e-30)
                           + np.abs(g_g - g_s) / np.maximum(np.abs(g_s), 1e-30))
                    step = np.abs(v - ref["init"][net][k].numpy())
                    assert np.all(np.abs(got - v) <= 1e-5 + 2 * step * rel), k
                    continue
                np.testing.assert_allclose(got, v, atol=1e-5, err_msg=f"{what} {net} {k}")
    for net, sd in ref["init"].items():       # the step moved every network
        assert max(np.abs(res["params"][net][k] - v.numpy()).max() for k, v in sd.items()) > 0
