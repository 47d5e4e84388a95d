"""The adversarial handler's other training modes in advmil_tpu_torch against
advmil_tpu on the CPU in f32: disc_gansurv (hazards over quantile bins),
`train_sampling` and semi-supervised training (`exec_semi_sl`, UD+LD / UD /
LD with supervised pretraining), with the helpers they rest on: the label
mask of the discrete task, the labelled / unlabelled split, the k folds of
UD+LD and the config checks.

As in tests/test_torch_train.py, dropout and noise are off on both sides
(JAX `mask_dropout` monkeypatched to the identity, port `set_dropout_rates`,
`gen_noi_noise: 0-0`) and the port starts from the JAX run's initial
weights, carried across with `bridge.flax_to_torch`.
"""
import csv
import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advmil_tpu import config as jconfig
from advmil_tpu import losses as jlosses
from advmil_tpu.models import layers as jlayers
from advmil_tpu.utils import func as jfunc
from advmil_tpu_torch import bridge
from advmil_tpu_torch import config as tconfig
from advmil_tpu_torch import losses as tlosses
from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
from advmil_tpu_torch.models import layers as tl
from advmil_tpu_torch.train import baseline as tbaseline
from advmil_tpu_torch.train import handler as thandler
from advmil_tpu_torch.utils import func as tfunc
from advmil_tpu_torch.utils.io import read_datasplit_npz
from tests.test_torch_train import _cfg, _np_tree, _write_yaml

DISC = {"task": "disc_gansurv", "time_format": "quantile", "gen_dims": "128-4",
        "disc_nety_in_dim": 4}
SSL = {"semi_training": True, "ssl_num_labeled": 0.6, "ssl_kfold": 2,
       "ssl_resume_ckpt": "best", "ssl_es_patience": 30, "ssl_es_warmup": 5,
       "ssl_es_verbose": False, "ssl_es_start_epoch": 0}
_PATHS = {"path_patch": "/feats", "path_label": "/labels.csv",
          "data_split_path": "/split-{}.npz"}


# ---------------------------------------------------------------------------
# helpers: label mask, labelled split, k folds, config checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("censored", [False, True])
@pytest.mark.parametrize("bins", [2, 3, 4, 5, 6])
def test_get_label_mask_matches_jax(bins, censored):
    rng = np.random.default_rng(bins)
    t = rng.integers(0, bins, size=16).astype(np.float32)
    e = ((rng.uniform(size=16) > 0.5) if censored else np.ones(16)).astype(np.float32)
    want = jlosses.get_label_mask(jnp.asarray(t), jnp.asarray(e), bins)
    got = tlosses.get_label_mask(torch.from_numpy(t), torch.from_numpy(e), bins)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (16, bins)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    label, mask = (g.numpy() for g in got)
    events = e == 1
    np.testing.assert_array_equal(label[events].sum(axis=1), 1.0)    # one-hot at t
    np.testing.assert_array_equal(mask.sum(axis=1), t + 1)


@pytest.mark.parametrize("num", [7, 0.6])
@pytest.mark.parametrize("kind", ["RandomState", "Generator"])
def test_sampling_data_matches_jax(kind, num):
    data = [f"P{i:04d}" for i in range(23)]
    make = {"RandomState": np.random.RandomState, "Generator": np.random.default_rng}[kind]
    got = tfunc.sampling_data(data, num, rng=make(42))
    assert got == jfunc.sampling_data(data, num, rng=make(42))
    sampled, left = got
    assert len(sampled) == (7 if num == 7 else int(23 * 0.6))
    assert sorted(sampled + left) == data


@pytest.mark.parametrize("keep", [None, ["L3", "L1"]], ids=["no_keep", "keep"])
@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_get_kfold_pids_matches_jax(k, keep):
    pids = [f"U{i:02d}" for i in range(13)]
    got = tfunc.get_kfold_pids(pids, k, keep_pids=keep, random_state=7)
    assert got == jfunc.get_kfold_pids(pids, k, keep_pids=keep, random_state=7)
    n_keep = len(keep or [])
    assert len(got) == k and all(f[:n_keep] == (keep or []) for f in got)
    rest = [p for f in got for p in f[n_keep:]]
    assert sorted(rest) == pids                       # disjoint, and they cover pids


@pytest.mark.parametrize("mode,want", [("UD+LD", 3), ("LD", 0), ("UD", 0), ("none", 0)])
def test_ssl_es_warmup_is_forced_as_in_jax(mode, want, tmp_path):
    cfg = _cfg(_PATHS, tmp_path, "c", **dict(SSL, ssl_kfold=3), semi_training_mode=mode)
    t, j = tconfig.with_defaults(dict(cfg)), jconfig.with_defaults(dict(cfg))
    tconfig.check_configs(t)
    jconfig.check_configs(j)
    assert t["ssl_es_warmup"] == j["ssl_es_warmup"] == want
    with pytest.raises(AssertionError):
        tconfig.check_configs(dict(t, ssl_resume_ckpt="first"))


@pytest.mark.parametrize("bad", [{"time_format": "ratio"}, {"gen_out_scale": "none"},
                                 {"gen_dims": "128-3", "disc_nety_in_dim": 3}],
                         ids=["time_format", "out_scale", "bins"])
def test_disc_gansurv_checks_match_jax(bad, tmp_path):
    good = _cfg(_PATHS, tmp_path, "c", **DISC)
    tconfig.check_configs(tconfig.with_defaults(dict(good)))
    jconfig.check_configs(jconfig.with_defaults(dict(good)))
    for check, defaults in ((tconfig.check_configs, tconfig.with_defaults),
                            (jconfig.check_configs, jconfig.with_defaults)):
        with pytest.raises(AssertionError):
            check(defaults(dict(good, **bad)))


def test_modes_are_accepted_under_their_handlers(tmp_path):
    adv = tconfig.with_defaults(_cfg(_PATHS, tmp_path, "c", **DISC, **SSL,
                                     semi_training_mode="UD+LD", train_sampling=0.5))
    tconfig.check_configs(adv, "adv")
    base = dict(adv, task="surv_reg", train_sampling=10, semi_training=False)
    tconfig.check_configs(base, "base")
    with pytest.raises(ValueError, match="--handler adv"):
        tconfig.check_configs(dict(base, semi_training=True), "base")


# ---------------------------------------------------------------------------
# whole runs against the JAX handler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """36 patients of 4-16 regions (one 256-patch bucket, so each JAX step
    compiles once)."""
    root = str(tmp_path_factory.mktemp("ssl_data"))
    return make_synthetic_dataset(root, n_patients=36, dim=64, min_regions=4,
                                  max_regions=16, seed=5, feat_format="pt")


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(jlayers, "mask_dropout", lambda rng, rate, x: x)


def _read_rows(path):
    """{patient_id: [every other column as float]} of a prediction CSV."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return {r["patient_id"]: [float(v) for k, v in r.items() if k != "patient_id"]
            for r in rows}, list(rows[0])


def _run_both(synth, tmp_path, monkeypatch, entry, **over):
    """The JAX handler's `entry` (exec / exec_semi_sl), then the port's CLI on
    the same config from the JAX run's initial weights, dropout off."""
    from advmil_tpu.train.handler import AdvHandler as JaxHandler
    from advmil_tpu_torch.main import main as port_main

    jh = JaxHandler(jconfig.with_defaults(_cfg(synth, tmp_path, "jax", rng_impl="threefry",
                                               **over)))
    init = {42: bridge.flax_to_torch(_np_tree(jh.params_G)),
            43: bridge.flax_to_torch(_np_tree(jh.params_D))}
    jm = getattr(jh, entry)()

    def from_jax_init(model, seed):
        model.load_state_dict(init[seed])        # strict: no missing or unexpected key
        return tl.set_dropout_rates(model, 0.0)

    monkeypatch.setattr(thandler, "init_parameters", from_jax_init)
    yaml_path = str(tmp_path / "port.yaml")
    _write_yaml(yaml_path, _cfg(synth, tmp_path, "port", device="cpu", **over))
    [(th, tm)] = port_main(["--config", yaml_path, "--handler", "adv"])
    assert th.device.type == "cpu"
    return jh, jm, th, tm


def _same_outputs(jm, tm, tmp_path, group, ckpt, splits, columns=None):
    for split in splits:
        name = f"{group}_{ckpt}_pred_{split}.csv"
        (jp, jcols), (tp, tcols) = (_read_rows(osp.join(str(tmp_path / side), name))
                                    for side in ("jax", "port"))
        assert tcols == jcols and (columns is None or tcols == columns), name
        assert sorted(tp) == sorted(jp) and len(tp) > 0, name
        want = np.asarray([jp[k] for k in sorted(jp)])
        got = np.asarray([tp[k] for k in sorted(jp)])
        assert np.ptp(got[:, 2:], axis=0).max() > 0, name      # not constant
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
        if jm is not None:
            assert abs(dict(tm[split])["cindex"] - dict(jm[split])["cindex"]) <= 1e-4, split


def test_disc_gansurv_exec_matches_jax(synth, tmp_path, monkeypatch, no_jax_dropout):
    jh, jm, th, tm = _run_both(synth, tmp_path, monkeypatch, "exec", **DISC)
    assert len(th.train_timings) == 2 and th.nbins == 4
    _same_outputs(jm, tm, tmp_path, "train", "best", ("train", "validation", "test"),
                  ["patient_id", "t", "e", "risk", "surf_1", "surf_2", "surf_3", "surf_4"])
    for f in ("train_modelG-best.ckpt", "train_modelD-last.ckpt"):
        assert osp.exists(osp.join(str(tmp_path / "port"), f))
    assert not osp.exists(osp.join(str(tmp_path / "port"), "train_best_pred_test_dist.npz"))


def test_train_sampling_exec_matches_jax(synth, tmp_path, monkeypatch, no_jax_dropout):
    jh, jm, th, tm = _run_both(synth, tmp_path, monkeypatch, "exec", train_sampling=0.5)
    pids_train = read_datasplit_npz(synth["data_split_path"].format(0))[0]
    assert th.patient_id["train"] == jh.patient_id["train"]
    assert len(th.patient_id["train"]) == int(len(pids_train) * 0.5)
    _same_outputs(jm, tm, tmp_path, "train", "best", ("train", "validation", "test"))


def test_base_train_sampling_draws_as_jax(tmp_path):
    """The baseline handler samples its training patients from the same
    stream as the JAX one (the handler's default_rng(seed), first draw)."""
    from tests.test_torch_baseline import _cfg as base_cfg
    paths = make_synthetic_dataset(str(tmp_path / "data"), n_patients=36, dim=32,
                                   min_regions=4, max_regions=16, seed=8, feat_format="pt")
    h = tbaseline.BaselineHandler(tconfig.with_defaults(base_cfg(
        paths, tmp_path, "b", device="cpu", train_sampling=9, epochs=1)))
    h.exec()
    pids_train = read_datasplit_npz(paths["data_split_path"].format(0))[0]
    want, _ = jfunc.sampling_data(pids_train, 9, rng=np.random.default_rng(42))
    assert h.patient_id["train"] == [p for p in want]
    assert len(h.train_timings) == 1


_SSL_CASES = {
    # UD+LD: the warmup is forced to ssl_kfold = 2, so a best checkpoint needs
    # a third epoch (fold 0 again)
    "UD+LD": ({"semi_training_mode": "UD+LD", "ssl_epochs": 3}, "semitrain_LD_UD"),
    "UD": ({"semi_training_mode": "UD", "ssl_epochs": 2}, "semitrain_UD"),
    "LD+pretrain": ({"semi_training_mode": "LD", "ssl_epochs": 2, "ssl_first_phase": True},
                    "semitrain_LD"),
}


@pytest.mark.parametrize("case", list(_SSL_CASES))
def test_exec_semi_sl_matches_jax(case, synth, tmp_path, monkeypatch, capsys,
                                  no_jax_dropout):
    over, run_name = _SSL_CASES[case]
    jh, jm, th, tm = _run_both(synth, tmp_path, monkeypatch, "exec_semi_sl", **SSL, **over)
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("PARITY_SSL_LABELED_JSON=")]
    assert len(printed) == 2 and printed[0] == printed[1]
    pids_train = read_datasplit_npz(synth["data_split_path"].format(0))[0]
    perm = np.random.RandomState(42).permutation(len(pids_train))
    labeled = [pids_train[i] for i in perm[:int(len(pids_train) * 0.6)]]
    assert th.patient_id["label_visible"] == jh.patient_id["label_visible"] == set(labeled)
    for k, v in jh.patient_id.items():
        assert th.patient_id[k] == v, k                    # folds, splits, labelled sets
    splits = ("labeled_train", "unlabeled_train", "validation", "test")
    _same_outputs(jm, tm, tmp_path, run_name, "best", splits)
    n_lab = len(labeled)
    if case == "UD+LD":
        folds = [th.patient_id[f"fold{i}_mixed_train"] for i in range(2)]
        assert all(f[:n_lab] == labeled for f in folds)
        assert not set(folds[0][n_lab:]) & set(folds[1][n_lab:])
        assert th.train_visible == [n_lab] * 3
    elif case == "UD":
        assert th.train_visible == [0, 0]                   # every label hidden
    else:
        assert th.train_visible == [n_lab] * 2
        assert len(th.train_timings) == 4                   # 2 pretraining + 2 epochs
        _same_outputs(None, None, tmp_path, "pretrain", "last", splits)
        for f in ("pretrain_modelG-last.ckpt", "pretrain_last_pred_test.csv"):
            assert osp.exists(osp.join(str(tmp_path / "port"), f)), f
    for net in "GD":
        for ck in ("best", "last"):
            assert osp.exists(osp.join(str(tmp_path / "port"), f"{run_name}_model{net}-{ck}.ckpt"))
