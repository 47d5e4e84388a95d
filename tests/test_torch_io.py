"""Host side of the port against advmil_tpu: the config reader on the repo's
YAML files, label tables, split files, prediction CSVs, the synthetic
dataset writer, and the bucketed batcher batch for batch (test-mode
occlusion masks included)."""
import csv
import glob
import os.path as osp

import numpy as np
import pytest

from advmil_tpu import config as jconfig
from advmil_tpu.data import bags as jbags
from advmil_tpu.data.synthetic import make_synthetic_dataset as j_make_synthetic
from advmil_tpu.utils import io as jio
from advmil_tpu_torch import config as tconfig
from advmil_tpu_torch.data import bags as tbags
from advmil_tpu_torch.data.synthetic import make_synthetic_dataset as t_make_synthetic
from advmil_tpu_torch.utils import io as tio

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = sorted(glob.glob(osp.join(REPO, "config", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=osp.basename)
def test_config_reader_matches_yaml(path):
    import yaml
    with open(path) as f:
        raw = yaml.load(f, Loader=yaml.FullLoader)
    got = tconfig.read_yaml(path)
    assert got == raw
    full, jfull = tconfig.get_config(path), jconfig.get_config(path)
    assert {k: full[k] for k in raw} == {k: jfull[k] for k in raw}
    assert full["device"] == "cuda"          # the port's default, never implicit


def test_config_reader_scalars(tmp_path):
    import yaml
    p = tmp_path / "c.yaml"
    p.write_text("a: 1e-5\nb: 1.0e-5\nc: yes\nd: ~\ne:\nf: 'x # y'  # note\n"
                 "g: [1, two, 3.5]\nh:\n- 0\n- 1\ni: 0x1f\nj: -7\nk: off\n")
    with open(p) as f:
        assert tconfig.read_yaml(str(p)) == yaml.load(f, Loader=yaml.FullLoader)


def _nlst_test_cfg(**over):
    cfg = tconfig.get_config(osp.join(REPO, "config", "cfg_nlst.yaml"))
    cfg.update(test=True, device="cpu", data_split_seed=0)
    cfg.update(over)
    return cfg


# refused, naming `item`, until their items were done: graph mode (A13),
# inst_devices over graph / cluster (A14 rest), log_plot (A9)
_UNPORTED_WITH = {("bcb_mode", "graph"): {"inst_devices": 2},
                  ("dist_num_processes", 2): {"inst_devices": 2, "bcb_mode": "graph"},
                  ("inst_devices", 2): {"bcb_mode": "cluster"},
                  ("dp_devices", 2): {"inst_devices": 2, "bcb_mode": "graph"}}


@pytest.mark.parametrize("key,value,item", [
    ("bcb_mode", "graph", "A14"), ("log_plot", True, "A9"),
    ("dist_num_processes", 2, "A14"), ("inst_devices", 2, "A14"),
    ("dp_devices", 2, "A14")])
def test_check_configs_rejects_unported_modes(key, value, item):
    """Each combination here was refused, naming `item`, until that item was
    done: all pass the checks now. The one refusal left names its item:
    AdaHessian through the patch / graph kernels on the card (A19)."""
    tconfig.check_configs(_nlst_test_cfg())
    over = {key: value, **_UNPORTED_WITH.get((key, value), {})}
    tconfig.check_configs(_nlst_test_cfg(**{key: value}))
    tconfig.check_configs(_nlst_test_cfg(**over))
    a19 = dict(over, bcb_mode="graph", device="cuda", opt_net="adahessian")
    with pytest.raises(NotImplementedError, match="A19"):
        tconfig.check_configs(_nlst_test_cfg(**a19), "base")


@pytest.mark.parametrize("key,value", [
    ("use_fused_embedding", True), ("use_coords_pe", True), ("disc_netx_ksize", 3),
    ("disc_netx_backbone", "gapool")])
def test_check_configs_accepts_the_patch_embedding_family(key, value):
    """Keys the port used to reject: each is read now (the models they build
    are held against flax in test_torch_fused.py)."""
    cfg = _nlst_test_cfg(path_coordx5="/coords", **{key: value})
    tconfig.check_configs(cfg)
    assert tconfig.PORT_DEFAULTS["use_fused_embedding"] is False    # the JAX default
    with pytest.raises(ValueError):
        tconfig.check_configs(_nlst_test_cfg(disc_netx_backbone="maxpool"))
    with pytest.raises(ValueError, match="path_coordx5"):
        tconfig.check_configs(_nlst_test_cfg(use_coords_pe=True, path_coordx5=None))


def test_check_configs_keeps_reference_checks():
    with pytest.raises(AssertionError):
        tconfig.check_configs(_nlst_test_cfg(gen_out_scale="exp"))
    with pytest.raises(ValueError, match="device"):
        tconfig.check_configs(_nlst_test_cfg(device="gpu"))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tsynth"))
    return t_make_synthetic(root, n_patients=20, dim=32, min_regions=2,
                            max_regions=40, seed=3, feat_format="pt")


def test_synthetic_writer_matches_jax_writer(synth, tmp_path):
    ref = j_make_synthetic(str(tmp_path), n_patients=20, dim=32, min_regions=2,
                           max_regions=40, seed=3, feat_format="pt", with_graph=False)
    for i in (0, 7, 19):
        np.testing.assert_array_equal(
            tio.read_patch_feature(osp.join(synth["path_patch"], f"S{i:04d}.pt")),
            jio.read_patch_feature(osp.join(ref["path_patch"], f"S{i:04d}.pt")))
    for a, b in zip(synth["split_paths"], ref["split_paths"]):
        assert jio.read_datasplit_npz(a) == jio.read_datasplit_npz(b)
    pids = synth["pids"]
    assert (tio.retrieve_from_table(pids, synth["path_label"], time_format="ratio")
            == jio.retrieve_from_table(pids, ref["path_label"], time_format="ratio"))


def _table_pids(path):
    with open(path) as f:
        all_pids = [r["patient_id"] for r in csv.DictReader(f)]
    return sorted(set(all_pids))[:40] + ["no-such-patient"]


# the JAX reader cannot take ratio time on an integer `t` column (pandas
# refuses the float write into an int64 column), so tcga_brca runs origin
@pytest.mark.parametrize("table,time_format", [
    ("nlst_path_full.csv", "ratio"), ("nlst_path_full.csv", "origin"),
    ("tcga_brca_path_full.csv", "origin")])
def test_retrieve_from_table_matches_jax(table, time_format):
    path = osp.join(REPO, "table", table)
    pids = _table_pids(path)
    got = tio.retrieve_from_table(pids, path, time_format=time_format)
    want = jio.retrieve_from_table(pids, path, ret=["pid", "pid2sid", "pid2label"],
                                   time_format=time_format)
    assert got[0] == want[0]
    assert got[1] == {p: [str(s) for s in v] for p, v in want[1].items()}
    assert got[2] == want[2]
    assert tio.read_maxt_from_table(path) == jio.read_maxt_from_table(path)


def test_retrieve_ratio_on_integer_times():
    path = osp.join(REPO, "table", "tcga_brca_path_full.csv")
    pids = _table_pids(path)
    _, ratio = tio.retrieve_from_table(pids, path, ret=["pid", "pid2label"],
                                       time_format="ratio")
    origin = tio.retrieve_from_table(pids, path, ret=["pid2label"],
                                     time_format="origin")[0]
    t_max = tio.read_maxt_from_table(path)
    assert ratio == {p: (t / t_max, e) for p, (t, e) in origin.items()}


def test_read_datasplit_npz_matches_jax():
    for path in sorted(glob.glob(osp.join(REPO, "data_split", "*-fold0.npz"))):
        assert tio.read_datasplit_npz(path) == jio.read_datasplit_npz(path)


@pytest.mark.parametrize("with_dist", [False, True])
def test_save_prediction_matches_jax(tmp_path, with_dist):
    rng = np.random.default_rng(4)
    pids = [f"P{i}" for i in range(6)]
    y = np.stack([rng.uniform(size=6), rng.integers(0, 2, 6)], 1).astype(np.float32)
    pred = rng.uniform(size=(6, 1)).astype(np.float32)
    dist = rng.uniform(size=(6, 5, 1)).astype(np.float32) if with_dist else None
    a, b = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    tio.save_prediction(pids, y, pred, dist, a)
    jio.save_prediction(pids, y, pred, dist, b)
    ra, rb = (list(csv.reader(open(p))) for p in (a, b))
    assert ra[0] == rb[0] and [r[0] for r in ra] == [r[0] for r in rb]
    np.testing.assert_allclose(np.asarray([r[1:] for r in ra[1:]], float),
                               np.asarray([r[1:] for r in rb[1:]], float), atol=1e-7)
    assert osp.exists(a[:-4] + "_dist.npz") == with_dist
    if with_dist:
        da, db = np.load(a[:-4] + "_dist.npz"), np.load(b[:-4] + "_dist.npz")
        np.testing.assert_array_equal(da["pred_dist"], db["pred_dist"])


def _batch_fields(b):
    return [b.idx, b.feats, b.mask, b.label, b.sample_mask]


@pytest.mark.parametrize("mask_ratio,workers", [(0.5, 1), (0.0, 3)])
def test_batcher_matches_jax_batch_for_batch(synth, mask_ratio, workers):
    cfg = {"path_patch": synth["path_patch"], "path_label": synth["path_label"],
           "bcb_mode": "patch", "feat_format": "pt", "time_format": "ratio",
           "time_bins": 4, "test": True, "cache_bags": True}
    pids = synth["pids"]
    tds = tbags.prepare_dataset(pids, cfg, mask_ratio=mask_ratio,
                                rng=np.random.default_rng(42))
    jds = jbags.prepare_dataset(pids, dict(cfg), mask_ratio=mask_ratio,
                                rng=np.random.default_rng(42))
    kw = dict(token_budget=1024, max_batch=8, min_bucket=256)
    tb, jb = tbags.BucketBatcher(tds, **kw), jbags.BucketBatcher(jds, **kw)
    assert tb.buckets == jb.buckets
    got = list(tb.prefetch(workers=workers))
    want = list(jb.prefetch(shuffle=False, workers=workers))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        for a, b in zip(_batch_fields(g), _batch_fields(w)):
            np.testing.assert_array_equal(a, b)
    assert any(g.sample_mask.min() == 0 for g in got)        # tail fillers


@pytest.mark.parametrize("max_n,growth", [(3400, 2.0), (100, 2.0), (5000, 1.5)])
def test_default_buckets_match_jax(max_n, growth):
    assert (tbags.default_buckets(max_n, 256, growth)
            == jbags.default_buckets(max_n, 256, growth))


def _eval_data(seed, bins=1):
    rng = np.random.default_rng(seed)
    n = 24
    y = np.stack([rng.uniform(0.05, 1.0, n), rng.integers(0, 2, n)], 1).astype(np.float32)
    y[0, 1] = 1.0
    shape = (n, 1) if bins == 1 else (n, bins)
    return {"y": y, "y_hat": rng.uniform(size=shape).astype(np.float32),
            "f_fake": rng.normal(size=(n,)).astype(np.float32)}


@pytest.mark.parametrize("which", ["bce", "hinge", "wasserstein"])
def test_cont_evaluator_matches_jax(which):
    import functools
    from advmil_tpu import losses as jlosses
    from advmil_tpu.eval.evaluator import ContSurvEvaluator as JCont
    from advmil_tpu_torch import losses as tlosses
    from advmil_tpu_torch.eval.evaluator import ContSurvEvaluator as TCont
    data = _eval_data(seed=len(which))
    metrics = ["c_index", "loss_recon", "loss_recon_org", "loss_fake_netD",
               "loss_fake_netG", "avg_fake", "event_t_rae", "nonevent_t_rae",
               "event_t_nre", "nonevent_t_nre"]
    kw = dict(alpha=0.3, gamma=0.0, norm="l1")
    got = TCont(end_time=1.0, recon_loss=functools.partial(tlosses.recon_loss, **kw),
                disc_loss=functools.partial(tlosses.real_fake_loss, which=which)
                ).compute(dict(data), metrics)
    want = JCont(end_time=1.0, recon_loss=functools.partial(jlosses.recon_loss, **kw),
                 disc_loss=functools.partial(jlosses.real_fake_loss, which=which)
                 ).compute(dict(data), metrics)
    assert got.keys() == want.keys()
    for k in metrics:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k
    assert got["c_index"] == want["c_index"]


def test_disc_evaluator_matches_jax():
    from advmil_tpu.eval.evaluator import DiscSurvEvaluator as JDisc
    from advmil_tpu_torch.eval.evaluator import DiscSurvEvaluator as TDisc
    data = _eval_data(seed=9, bins=4)
    metrics = ["c_index", "loss_fake_netG", "avg_fake"]
    got = TDisc().compute(dict(data), metrics)
    want = JDisc().compute(dict(data), metrics)
    for k in metrics:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def test_save_prediction_discrete_matches_jax(tmp_path):
    data = _eval_data(seed=10, bins=4)
    pids = [f"P{i}" for i in range(len(data["y"]))]
    a, b = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    tio.save_prediction(pids, data["y"], data["y_hat"], None, a)
    jio.save_prediction(pids, data["y"], data["y_hat"], None, b)
    ra, rb = (list(csv.reader(open(p))) for p in (a, b))
    assert ra[0] == rb[0] and [r[0] for r in ra] == [r[0] for r in rb]
    np.testing.assert_allclose(np.asarray([r[1:] for r in ra[1:]], float),
                               np.asarray([r[1:] for r in rb[1:]], float), rtol=1e-6)
