"""The baseline slice of advmil_tpu_torch against advmil_tpu on the CPU in
f32: ABMIL and SurvNet, the three supervised losses with their gradients,
the quantile labels, the pt041 init, the Cox evaluator, three baseline
steps for each (task, backbone) pair, a 2-epoch `exec` + `exec_test`, and
the CLI's dispatch and refusals.

As in tests/test_torch_train.py, dropout is off on both sides for the step
and `exec` comparisons: the JAX package's `mask_dropout` is monkeypatched
to the identity and every port `Dropout` rate is set to 0. Weights cross
with `bridge.flax_to_torch`.
"""
import csv
import os
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from advmil_tpu import losses as jlosses
from advmil_tpu.config import with_defaults as j_with_defaults
from advmil_tpu.eval.evaluator import CoxSurvEvaluator as JCox
from advmil_tpu.models import backbones as jbb
from advmil_tpu.models import gan as jgan
from advmil_tpu.models import layers as jlayers
from advmil_tpu.utils import io as jio
from advmil_tpu_torch import bridge
from advmil_tpu_torch import losses as tlosses
from advmil_tpu_torch.config import with_defaults
from advmil_tpu_torch.data.bags import BucketBatcher, prepare_dataset
from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
from advmil_tpu_torch.eval.evaluator import CoxSurvEvaluator
from advmil_tpu_torch.models import backbones as tbb
from advmil_tpu_torch.models import gan as tgan
from advmil_tpu_torch.models import layers as tl
from advmil_tpu_torch.train import baseline as tbaseline
from advmil_tpu_torch.train import handler as thandler
from advmil_tpu_torch.utils import io as tio

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
ATOL, RTOL = 1e-5, 1e-4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, dict(params))


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(jlayers, "mask_dropout", lambda rng, rate, x: x)


def _bag(B, N, C, seed, lengths):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = np.zeros((B, N), np.float32)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1.0
    return x * mask[..., None], mask


# ---------------------------------------------------------------------------
# ABMIL and SurvNet
# ---------------------------------------------------------------------------

def _survnets(out_scale, pdh, dense_init, C=48, D=64):
    dim_in, dim_out = pdh
    jm = jgan.SurvNet(backbone=jbb.load_backbone("abmil", [C, D, D], dense_init=dense_init),
                      dim_in=dim_in, dim_out=dim_out, out_scale=out_scale,
                      dense_init=dense_init)
    tm = tgan.SurvNet(tbb.load_backbone("abmil", [C, D, D], dense_init=dense_init),
                      dim_in, dim_out, out_scale=out_scale, dense_init=dense_init)
    return jm, tm


@pytest.mark.parametrize("out_scale,pdh,init", [("sigmoid", (64, 1), "xavier"),
                                                ("sigmoid", (64, 4), "xavier"),
                                                ("none", (64, 1), "pt041")])
def test_abmil_survnet_forward_matches_flax(out_scale, pdh, init):
    x, mask = _bag(3, 40, 48, seed=len(init) + pdh[1], lengths=[40, 13, 0])
    jm, tm = _survnets(out_scale, pdh, init)
    v = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                jnp.asarray(x), jnp.asarray(mask), None, deterministic=True)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(mask), None, deterministic=True)
    H = jm.backbone.apply({"params": v["params"]["backbone"]}, jnp.asarray(x),
                          jnp.asarray(mask), None, deterministic=True)
    tm.load_state_dict(bridge.flax_to_torch(_np_tree(v["params"])))
    tm.eval()
    got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(tm.backbone(torch.from_numpy(x), torch.from_numpy(mask))
                               .detach().numpy(), np.asarray(H), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert got.shape == (3, pdh[1])
    assert np.ptp(got[:2].detach().numpy()) > 0
    if out_scale == "sigmoid":
        assert bool(((got > 0) & (got < 1)).all())


def test_abmil_survnet_bf16_tracks_flax_bf16():
    """bf16 compute on both sides, the same weights: within the port's bf16
    bound on predictions (2e-2, tests/test_torch_slice.py), and the output
    stays bf16 as the JAX SurvNet's does."""
    x, mask = _bag(3, 40, 48, seed=9, lengths=[40, 21, 5])
    jlayers.set_compute_dtype("bf16")
    try:
        jm, _ = _survnets("sigmoid", (64, 4), "xavier")
        v = jm.init({"params": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)},
                    jnp.asarray(x), jnp.asarray(mask), None, deterministic=True)
        want = jm.apply(v, jnp.asarray(x), jnp.asarray(mask), None, deterministic=True)
    finally:
        jlayers.set_compute_dtype("f32")
    assert want.dtype == jnp.bfloat16
    tm = tgan.SurvNet(tbb.load_backbone("abmil", [48, 64, 64], dtype=torch.bfloat16),
                      64, 4, out_scale="sigmoid", dtype=torch.bfloat16)
    tm.load_state_dict(bridge.flax_to_torch(_np_tree(v["params"])))
    got = tm.eval()(torch.from_numpy(x).bfloat16(), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def test_load_backbone_modes():
    """abmil and cluster by name; the JAX factory's fall-through is not
    copied: an unknown mode is an error."""
    assert isinstance(tbb.load_backbone("abmil", [8, 4, 4]), tbb.ABMIL)
    assert isinstance(tbb.load_backbone("cluster", [8, 4, 4]), tbb.DeepAttnMISL)
    with pytest.raises(ValueError, match="unknown backbone"):
        tbb.load_backbone("abmll", [8, 4, 4])


# ---------------------------------------------------------------------------
# the three supervised losses, values and gradients
# ---------------------------------------------------------------------------

def _loss_case(seed, B=11, T=None):
    rng = np.random.default_rng(seed)
    if T is None:
        pred = rng.uniform(0.05, 0.95, size=B).astype(np.float32)
        t = rng.uniform(size=B).astype(np.float32)
    else:
        pred = rng.uniform(0.05, 0.95, size=(B, T)).astype(np.float32)
        t = rng.integers(0, T, size=B).astype(np.float32)
    t[3] = t[5] = t[8]                       # tied times
    e = (rng.uniform(size=B) > 0.4).astype(np.float32)
    e[3], e[5] = 1.0, 0.0
    w = np.ones(B, np.float32)
    w[-3:] = 0.0                             # padded tail fillers
    return pred, t, e, w


def _check_loss(jfn, tfn, pred, t, e, w):
    jl_, jg = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(t), jnp.asarray(e),
                                                  weight=None if w is None else jnp.asarray(w)))(
        jnp.asarray(pred))
    tp = torch.tensor(pred, requires_grad=True)
    tl_ = tfn(tp, torch.from_numpy(t), torch.from_numpy(e),
              weight=None if w is None else torch.from_numpy(w))
    tl_.backward()
    np.testing.assert_allclose(float(tl_.detach()), float(jl_), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), atol=ATOL, rtol=RTOL)
    assert np.abs(np.asarray(jg)).max() > 0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("which", ["mse", "mse_censored", "mle", "mle_alpha", "ple"])
def test_supervised_losses_match_jax(which, weighted):
    if which.startswith("mse"):
        inc = which == "mse_censored"
        jfn = lambda p, t, e, weight: jlosses.mse_loss(p, t, e, inc, weight=weight)  # noqa: E731
        tfn = lambda p, t, e, weight: tlosses.mse_loss(p, t, e, inc, weight=weight)  # noqa: E731
        case = _loss_case(1)
    elif which.startswith("mle"):
        a = 0.4 if which == "mle_alpha" else 0.0
        jfn = lambda p, t, e, weight: jlosses.surv_mle_loss(p, t, e, alpha=a, weight=weight)  # noqa: E731,E501
        tfn = lambda p, t, e, weight: tlosses.surv_mle_loss(p, t, e, alpha=a, weight=weight)  # noqa: E731,E501
        case = _loss_case(2, T=4)
    else:
        jfn, tfn = jlosses.surv_ple_loss, tlosses.surv_ple_loss
        pred, t, e, w = _loss_case(3)
        pred = pred * 30.0 - 12.0            # some above the clip at 10
        case = pred, t, e, w
    pred, t, e, w = case
    _check_loss(jfn, tfn, pred, t, e, w if weighted else None)


def test_mle_loss_cur_alpha_matches_jax():
    pred, t, e, _ = _loss_case(4, T=4)
    got = tlosses.surv_mle_loss(torch.from_numpy(pred), torch.from_numpy(t),
                                torch.from_numpy(e), alpha=0.5, cur_alpha=0.0)
    want = jlosses.surv_mle_loss(jnp.asarray(pred), jnp.asarray(t), jnp.asarray(e),
                                 alpha=0.5, cur_alpha=0.0)
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# quantile labels
# ---------------------------------------------------------------------------

def _tied_table(path):
    """Tied times across patients and a patient with two slides."""
    rows = [("s0", "p0", 1, 5.0), ("s1", "p0", 1, 5.0), ("s2", "p1", 1, 5.0),
            ("s3", "p2", 0, 3.0), ("s4", "p3", 1, 9.0), ("s5", "p4", 1, 2.0),
            ("s6", "p5", 0, 12.0), ("s7", "p6", 1, 9.0), ("s8", "p7", 1, 7.0),
            ("s9", "p8", 1, 2.0), ("s10", "p9", 0, 5.0)]
    with open(path, "w") as f:
        f.write("pathology_id,patient_id,e,t\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")
    return [r[1] for r in rows]


@pytest.mark.parametrize("table", ["nlst", "tied"])
def test_quantile_labels_match_jax(table, tmp_path):
    if table == "nlst":
        path = osp.join(REPO, "table", "nlst_path_full.csv")
        pids = [str(p) for p in pd.read_csv(path, dtype={"patient_id": str})["patient_id"]]
    else:
        path = str(tmp_path / "tied.csv")
        pids = _tied_table(path)
    df = pd.read_csv(path, dtype={"patient_id": str})
    for bins in (3, 4):
        jdf, _ = jio.compute_discrete_label(df, bins=bins)
        y_t, y_c = tio.compute_discrete_label(tio._read_table(path)[0], bins=bins)
        np.testing.assert_array_equal(y_t, jdf["y_t"].to_numpy())
        np.testing.assert_array_equal(y_c, jdf["y_c"].to_numpy())
        assert len(np.unique(y_t)) == bins or table == "tied"   # ties can empty a bin
        ret = ["pid", "pid2sid", "pid2label", "sid2label"]
        want = jio.retrieve_from_table(pids, path, ret=ret, time_format="quantile",
                                       time_bins=bins)
        got = tio.retrieve_from_table(pids, path, ret=ret, time_format="quantile",
                                      time_bins=bins)
        assert got[0] == want[0]
        assert got[2] == want[2] and got[3] == {str(k): v for k, v in want[3].items()}


def test_quantile_labels_refuse_repeated_edges(tmp_path):
    """Too many ties for the bins: qcut's repeated edges raise on both sides."""
    path = str(tmp_path / "tied.csv")
    _tied_table(path)
    df = pd.read_csv(path, dtype={"patient_id": str})
    with pytest.raises(ValueError, match="unique"):
        jio.compute_discrete_label(df, bins=6)
    with pytest.raises(ValueError, match="unique"):
        tio.compute_discrete_label(tio._read_table(path)[0], bins=6)


# ---------------------------------------------------------------------------
# pt041 init and the Cox evaluator
# ---------------------------------------------------------------------------

def test_pt041_init_ranges():
    """U(+-0.5 / sqrt(fan_in)) on weight and bias, as the JAX initializers
    draw (the streams differ, so the ranges are held, not the values); a
    pt041 SurvNet uses it in every Dense, the packed in-projection and the
    patch embedding keep xavier / torch init as in the JAX factory."""
    d = tl.Dense(400, 300, tl.PT041)
    d.reset_parameters(torch.Generator().manual_seed(0))
    bound = 0.5 / np.sqrt(400)
    for p in (d.weight, d.bias):
        a = p.detach().abs()
        assert float(a.max()) <= bound and float(a.max()) > 0.95 * bound
    jk = jlayers.pt041_kernel_init(jax.random.PRNGKey(0), (400, 300))
    jb = jlayers.pt041_bias_init_for(400)(jax.random.PRNGKey(1), (300,))
    for a in (jk, jb):
        assert 0.95 * bound < float(jnp.abs(a).max()) <= bound

    m = tbaseline.build_survnet(with_defaults({
        "precision": "f32", "bcb_mode": "abmil", "bcb_dims": "16-8-8", "pdh_dims": "8-1"}),
        "none", tl.PT041)
    assert {d.init for d in m.modules() if isinstance(d, tl.Dense)} == {tl.PT041}
    tl.init_parameters(m, 7)
    assert float(m.backbone.rho.bias.detach().abs().min()) > 0
    esat = tbb.load_backbone("patch", [16, 128, 128], dense_init=tl.PT041)
    inits = {n: d.init for n, d in esat.named_modules() if isinstance(d, tl.Dense)}
    assert inits.pop("patch_embedding.Dense_0") == tl.TORCH
    assert inits.pop("encoder_0.in_proj") == tl.XAVIER
    assert set(inits.values()) == {tl.PT041}


def test_cox_evaluator_matches_jax():
    rng = np.random.default_rng(11)
    y = np.stack([rng.uniform(1, 100, 23), (rng.uniform(size=23) > 0.3)], 1).astype(np.float32)
    y[4, 0] = y[7, 0]
    y_hat = rng.normal(size=(23, 1)).astype(np.float32)
    want = JCox(ple_loss=jlosses.surv_ple_loss).compute({"y": y, "y_hat": y_hat},
                                                         ["c_index", "loss_ple"])
    got = CoxSurvEvaluator(ple_loss=tlosses.surv_ple_loss).compute(
        {"y": y, "y_hat": y_hat}, ["c_index", "loss_ple"])
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k


# ---------------------------------------------------------------------------
# three baseline steps and the whole exec against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """36 patients of 4-16 regions with chain+skip graphs: one 256-patch
    bucket, so each JAX step compiles once."""
    root = str(tmp_path_factory.mktemp("base_data"))
    return make_synthetic_dataset(root, n_patients=36, dim=32, min_regions=4,
                                  max_regions=16, seed=8, feat_format="pt",
                                  with_graph=True)


def _cfg(paths, tmp_path, name, **over):
    """A baseline config at test size (tests/test_handlers_modes.py
    baseline_cfg's training settings)."""
    cfg = {
        "task": "surv_reg", "seed": 42, "save_path": str(tmp_path / name),
        "dataset": "synthetic", "path_patch": paths["path_patch"],
        "path_graph": paths["path_graph"], "path_cluster": paths["path_cluster"],
        "path_label": paths["path_label"], "path_coordx5": None, "feat_format": "pt",
        "time_format": "ratio", "time_bins": 4,
        "data_split_path": paths["data_split_path"], "data_split_seed": 0,
        "save_prediction": True, "train_sampling": None, "bcb_mode": "abmil",
        "bcb_dims": "32-64-64", "pdh_dims": "64-1", "mlp_hops": 1, "mlp_norm": False,
        "mlp_dropout": 0.25, "loss_use_censored": False, "loss_regl1_coef": 0.00001,
        "loss_mle_alpha": 0.0, "loss_recon_norm": "l1", "loss_recon_alpha": 0.0,
        "loss_recon_gamma": 0.0, "opt_net": "adam", "opt_net_lr": 0.0008,
        "opt_net_weight_decay": 0.0005, "epochs": 2, "es_patience": 30,
        "es_warmup": 0, "es_verbose": False, "es_start_epoch": 0,
        "monitor_metrics": "loss", "times_test_sample": 1, "test": False,
        "test_wandb_prj": None, "test_path": "test",
        "test_load_path": str(tmp_path / name),
        "test_save_path": str(tmp_path / (name + "-test-{}-{}")),
        "test_mask_ratio": 0.0, "test_sampling_times": 1, "batch_token_budget": 4096,
        "bucket_min": 256, "precision": "f32", "num_graph_layers": 2,
    }
    cfg.update(over)
    return cfg


_STEP_CASES = [("surv_reg", "abmil", {}),
               ("surv_cox", "abmil", {}),
               ("surv_nll", "abmil", {"pdh_dims": "64-4", "loss_mle_alpha": 0.2}),
               ("surv_reg", "patch", {"bcb_dims": "32-128-128", "pdh_dims": "128-1",
                                      "loss_use_censored": True}),
               ("surv_reg", "graph", {"bcb_dims": "32-16-16", "pdh_dims": "16-1",
                                      "graph_banded": "off"})]


@pytest.mark.parametrize("task,mode,over", _STEP_CASES,
                         ids=[f"{t}-{m}" for t, m, _ in _STEP_CASES])
def test_three_base_steps_match_jax(synth, tmp_path, no_jax_dropout, task, mode, over):
    """Three updates from the same weights on the same batches, at
    cfg_nlst_base's learning rate (8e-5): losses, train-mode predictions
    and every parameter within 1e-5."""
    from advmil_tpu.train.baseline import BaselineHandler as JaxHandler
    over = dict(over, opt_net_lr=0.00008)
    jh = JaxHandler(j_with_defaults(_cfg(synth, tmp_path, "jax", task=task, bcb_mode=mode,
                                         rng_impl="threefry", **over)))
    th = tbaseline.BaselineHandler(with_defaults(_cfg(synth, tmp_path, "port", task=task,
                                                      bcb_mode=mode, device="cpu", **over)))
    assert th.cfg["time_format"] == jh.cfg["time_format"]
    th.model.load_state_dict(bridge.flax_to_torch(_np_tree(jh.state.params)))
    tl.set_dropout_rates(th.model, 0.0)

    pids = [f"P{i:04d}" for i in range(36)]
    ds = prepare_dataset(pids, th.cfg)
    batcher = BucketBatcher(ds, token_budget=1024, banded="off")
    batches = list(batcher.epoch_batches())[:3]
    assert len(batches) == 3
    for batch in batches:
        jdev = {"feats": jnp.asarray(batch.feats), "mask": jnp.asarray(batch.mask),
                "label": jnp.asarray(batch.label),
                "sample_mask": jnp.asarray(batch.sample_mask),
                "visible": jnp.asarray(batch.sample_mask)}
        jdev.update({k: jnp.asarray(v) for k, v in batch.extra.items()})
        jh.state, jmet, jcol = jh.train_step(jh.state, jdev)
        tmet, tcol = th.train_step(th._ship(batch, train=True), th.train_rngs)
        for k in ("loss_supervision", "loss_total"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), atol=ATOL,
                                       rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(tcol["y_hat"].numpy(), np.asarray(jcol["y_hat"]),
                                   atol=ATOL, rtol=RTOL)
    assert float(jmet["loss_supervision"]) != 0.0
    want = bridge.flax_to_torch(_np_tree(jh.state.params))
    got = th.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=ATOL, err_msg=k)


def _read_pred(path):
    with open(path) as f:
        return {r["patient_id"]: float(r["pred_t"]) for r in csv.DictReader(f)}


def _write_yaml(path, cfg):
    """Floats positionally: YAML 1.1 reads `8e-05` (no dot) as a string."""
    def fmt(v):
        if v is None:
            return "null"
        return np.format_float_positional(v) if isinstance(v, float) else str(v)
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k}: {fmt(v)}\n")


def test_base_exec_and_exec_test_match_jax(synth, tmp_path, monkeypatch, no_jax_dropout):
    """surv_reg / abmil: 2 epochs of `exec` from the JAX run's initial
    weights through the port's CLI, then `exec_test` from each side's best
    checkpoint: prediction CSVs within 1e-5, C-indices within 1e-6."""
    from advmil_tpu.train.baseline import BaselineHandler as JaxHandler
    from advmil_tpu_torch.main import main as port_main

    jh = JaxHandler(j_with_defaults(_cfg(synth, tmp_path, "jax", rng_impl="threefry")))
    init = bridge.flax_to_torch(_np_tree(jh.params))
    jm = jh.exec()

    def from_jax_init(model, seed):
        model.load_state_dict(init)
        return tl.set_dropout_rates(model, 0.0)

    monkeypatch.setattr(tbaseline, "init_parameters", from_jax_init)
    yaml_path = str(tmp_path / "port.yaml")
    _write_yaml(yaml_path, _cfg(synth, tmp_path, "port", device="cpu"))
    [(th, tm)] = port_main(["--config", yaml_path, "--handler", "base"])
    assert th.device.type == "cpu" and len(th.train_timings) == 2
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for split in ("train", "validation", "test"):
        name = f"train_best_pred_{split}.csv"
        jp, tp = _read_pred(osp.join(jdir, name)), _read_pred(osp.join(tdir, name))
        assert sorted(tp) == sorted(jp) and np.ptp(list(tp.values())) > 0
        np.testing.assert_allclose([tp[k] for k in sorted(jp)], [jp[k] for k in sorted(jp)],
                                   atol=1e-5, err_msg=split)
        assert abs(dict(tm[split])["cindex"] - dict(jm[split])["cindex"]) <= 1e-6
    for f in ("train_model-best.ckpt", "train_model-last.ckpt", "train_metrics-best.txt"):
        assert osp.exists(osp.join(jdir, f)) and osp.exists(osp.join(tdir, f)), f
    bundle = torch.load(osp.join(tdir, "train_model-last.ckpt"), weights_only=True)
    assert bundle["epoch"] == 2 and bundle["opt_state"]["state"]

    jt = JaxHandler(j_with_defaults(_cfg(synth, tmp_path, "jax", rng_impl="threefry",
                                         test=True))).exec_test()
    _write_yaml(yaml_path, _cfg(synth, tmp_path, "port", device="cpu", test=True))
    [(th2, tt)] = port_main(["--config", yaml_path, "--handler", "base"])
    name = "test_mode_best_pred_exec-test.csv"
    jp = _read_pred(osp.join(str(tmp_path / "jax-test-0.0-0"), name))
    tp = _read_pred(osp.join(th2.save_dir, name))
    assert sorted(tp) == sorted(jp) and len(tp) > 0
    np.testing.assert_allclose([tp[k] for k in sorted(jp)], [jp[k] for k in sorted(jp)],
                               atol=1e-5)
    assert abs(dict(tt["exec-test"])["cindex"] - dict(jt["exec-test"])["cindex"]) <= 1e-6


def test_adv_handler_on_abmil_matches_jax(synth, tmp_path, no_jax_dropout):
    """The adversarial handler builds ABMIL through the same factory: one
    adversarial step against the JAX package."""
    from advmil_tpu.train.handler import AdvHandler as JaxHandler
    from tests.test_torch_train import _cfg as adv_cfg
    over = dict(bcb_mode="abmil", bcb_dims="32-64-64", gen_dims="64-1",
                disc_netx_in_dim=32, path_graph=None)
    jh = JaxHandler(j_with_defaults(adv_cfg(synth, tmp_path, "jax", rng_impl="threefry",
                                            **over)))
    th = thandler.AdvHandler(with_defaults(adv_cfg(synth, tmp_path, "port", device="cpu",
                                                   **over)))
    assert isinstance(th.gen_model.backbone, tbb.ABMIL)
    th.gen_model.load_state_dict(bridge.flax_to_torch(_np_tree(jh.state.params_G)))
    th.disc_model.load_state_dict(bridge.flax_to_torch(_np_tree(jh.state.params_D)))
    tl.set_dropout_rates(th.gen_model, 0.0)
    tl.set_dropout_rates(th.disc_model, 0.0)
    ds = prepare_dataset([f"P{i:04d}" for i in range(36)], th.cfg)
    batch = next(iter(BucketBatcher(ds, token_budget=4096).epoch_batches()))
    jdev = {"feats": jnp.asarray(batch.feats), "mask": jnp.asarray(batch.mask),
            "label": jnp.asarray(batch.label), "sample_mask": jnp.asarray(batch.sample_mask),
            "visible": jnp.ones_like(jnp.asarray(batch.sample_mask))}
    jh.state, jmet, _ = jh.train_step(jh.state, jdev)
    tmet, _ = th.train_step(th._ship(batch, train=True), th.train_rngs)
    for k in ("Loss_D", "Loss_G_total", "Loss_G_fake", "Loss_G_time"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    want = bridge.flax_to_torch(_np_tree(jh.state.params_G))
    for k, v in th.gen_model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# the CLI: the base handler end to end, its refusals, the repaired messages
# ---------------------------------------------------------------------------

def test_cli_base_handler_runs_without_jax(synth, tmp_path):
    """`python -m advmil_tpu_torch.main --handler base` trains (surv_nll on
    quantile labels) and runs test mode on the CPU in a fresh interpreter;
    no JAX module is loaded."""
    cfg = _cfg(synth, tmp_path, "cli", task="surv_nll", pdh_dims="64-4", device="cpu",
               epochs=1, test_sampling_times=3)
    train_yaml, test_yaml = str(tmp_path / "train.yaml"), str(tmp_path / "test.yaml")
    _write_yaml(train_yaml, cfg)
    _write_yaml(test_yaml, dict(cfg, test=True, test_mask_ratio=0.5))
    code = ("import sys\n"
            "from advmil_tpu_torch.main import main\n"
            f"main(['--config', {train_yaml!r}, '--handler', 'base'])\n"
            f"main(['--config', {test_yaml!r}, '--handler', 'base'])\n"
            "print('BAD', sorted(k for k in sys.modules if k.split('.')[0] in\n"
            "      ('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'advmil_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "BAD []" in r.stdout, r.stdout[-3000:]
    with open(osp.join(str(tmp_path / "cli-test-0.5-0"),
                       "test_mode_best_pred_exec-test.csv")) as f:
        rows = list(csv.DictReader(f))
    assert rows and set(rows[0]) == {"patient_id", "t", "e", "risk", "surf_1", "surf_2",
                                     "surf_3", "surf_4"}
    assert all(np.isfinite(float(r["risk"])) for r in rows)


@pytest.mark.parametrize("key,value,item", [("log_plot", True, "A9"),
                                            ("inst_devices", 2, "A14"),
                                            ("dp_devices", 2, "A14")])
def test_base_handler_refusals_name_the_roadmap(synth, tmp_path, key, value, item):
    """(cluster, the other optimizers and accumulation, refused here until
    their items were done, are held against JAX in test_torch_cluster.py and
    test_torch_optim.py; graph_grid_resident, refused until A13, runs in
    test_torch_grid.py.)"""
    # data parallelism runs; under it, inst_devices over graph / cluster is refused
    over = {key: value, **({"inst_devices": 2, "bcb_mode": "graph"} if key == "dp_devices"
                           else {"bcb_mode": "cluster"} if key == "inst_devices" else {})}
    cfg = with_defaults(_cfg(synth, tmp_path, "port", device="cpu", **over))
    with pytest.raises(NotImplementedError, match=item):
        tbaseline.BaselineHandler(cfg)


def test_task_refusals_name_the_handler(synth, tmp_path):
    """The adversarial handler runs disc_gansurv and names the baseline
    handler for a baseline task; the baseline handler names the adversarial
    one for both adversarial tasks and for semi-supervised training."""
    from tests.test_torch_train import _cfg as adv_cfg
    with pytest.raises(ValueError, match="--handler base"):
        thandler.AdvHandler(with_defaults(adv_cfg(synth, tmp_path, "a", device="cpu",
                                                  task="surv_reg")))
    h = thandler.AdvHandler(with_defaults(adv_cfg(
        synth, tmp_path, "a", device="cpu", task="disc_gansurv", time_format="quantile",
        gen_dims="128-4", disc_nety_in_dim=4, disc_netx_in_dim=32, bcb_dims="32-128-128")))
    assert h.evaluator.__class__.__name__ == "DiscSurvEvaluator"
    for over in ({"task": "cont_gansurv"}, {"task": "disc_gansurv"},
                 {"semi_training": True}):
        with pytest.raises(ValueError, match="--handler adv"):
            tbaseline.BaselineHandler(with_defaults(_cfg(synth, tmp_path, "b", device="cpu",
                                                         **over)))
