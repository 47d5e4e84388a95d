"""The whole test-mode slice against advmil_tpu on the CPU in f32.

advmil_tpu's AdvHandler (precision f32, rng_impl threefry) saves its G/D
checkpoints and runs exec_test; the bridge converts the checkpoints; the
port runs the same test mode through `advmil_tpu_torch.main` with
`device: cpu`. Predictions must agree per patient and the C-index must
match. A subprocess checks that the port imports nothing of JAX."""
import csv
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from advmil_tpu.config import with_defaults as j_with_defaults
from advmil_tpu_torch import bridge
from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
from advmil_tpu_torch.train import checkpoint as tckpt

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _cfg(paths, tmp_path, **over):
    cfg = {
        "task": "cont_gansurv", "seed": 42, "save_path": str(tmp_path / "run"),
        "dataset": "synthetic", "path_patch": paths["path_patch"],
        "path_label": paths["path_label"], "path_coordx5": None,
        "feat_format": "pt", "time_format": "ratio", "time_bins": 4,
        "data_split_path": paths["data_split_path"], "data_split_seed": 0,
        "save_prediction": True, "bcb_mode": "patch", "bcb_dims": "64-128-128",
        "gen_dims": "128-1", "gen_noi_noise": "0-1",
        "gen_noi_noise_dist": "uniform", "gen_noi_hops": 1, "gen_norm": False,
        "gen_dropout": 0.6, "gen_out_scale": "sigmoid", "disc_type": "prj",
        "disc_netx_in_dim": 64, "disc_netx_out_dim": 128, "disc_netx_ksize": 1,
        "disc_netx_backbone": "avgpool", "disc_netx_dropout": 0.25,
        "disc_nety_in_dim": 1, "disc_nety_hid_dims": "16-128",
        "disc_nety_norm": False, "disc_nety_dropout": 0.0, "disc_prj_path": "x",
        "disc_prj_iprd": "instance", "loss_gan_coef": 0.004, "loss_netD": "bce",
        "loss_regl1_coef": 0.00001, "loss_mle_alpha": 0.0,
        "loss_recon_norm": "l1", "loss_recon_alpha": 0.0,
        "loss_recon_gamma": 0.0, "opt_netG": "adam", "opt_netG_lr": 0.00008,
        "opt_netG_weight_decay": 0.0005, "opt_netD_lr": 0.00008, "epochs": 1,
        "es_patience": 30, "es_warmup": 5, "es_verbose": False,
        "es_start_epoch": 0, "gen_updates": 1, "monitor_metrics": "loss",
        "times_test_sample": 30, "test": False, "test_wandb_prj": None,
        "test_path": "test", "test_load_path": str(tmp_path / "run"),
        "test_save_path": str(tmp_path / "jax-test-{}-{}"),
        "test_mask_ratio": 0.8, "test_sampling_times": 1,
        "test_zero_noise": True, "batch_token_budget": 4096, "bucket_min": 256,
        "precision": "f32", "rng_impl": "threefry",
    }
    cfg.update(over)
    return cfg


def _write_yaml(path, cfg):
    def fmt(v):
        if v is None:
            return "null"
        return str(v)
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k}: {fmt(v)}\n")


def _read_pred(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return [r["patient_id"] for r in rows], np.asarray(
        [[float(r["t"]), float(r["e"]), float(r["pred_t"])] for r in rows])


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice_data"))
    return make_synthetic_dataset(root, n_patients=36, dim=64, min_regions=4,
                                  max_regions=40, seed=5, feat_format="pt")


def test_exec_test_matches_jax(synth, tmp_path):
    from flax import serialization
    from advmil_tpu.train.handler import AdvHandler as JaxHandler
    from advmil_tpu_torch.main import main as port_main

    # JAX: checkpoints of a fresh run, then its test mode
    cfg = _cfg(synth, tmp_path)
    JaxHandler(j_with_defaults(dict(cfg))).save_model(1, "best", "train")
    jm = JaxHandler(j_with_defaults(_cfg(synth, tmp_path, test=True))).exec_test()

    # bridge the checkpoints into the port's format
    port_run = tmp_path / "port-run"
    for net in ("G", "D"):
        with open(osp.join(cfg["save_path"], f"train_model{net}-best.ckpt"), "rb") as f:
            bundle = serialization.msgpack_restore(f.read())
        tckpt.save_checkpoint(str(port_run / f"train_model{net}-best.ckpt"),
                              int(bundle["epoch"]),
                              bridge.flax_to_torch(bundle["params"]))

    # the port through its CLI entry point, on the CPU
    port_cfg = _cfg(synth, tmp_path, test=True, device="cpu",
                    test_load_path=str(port_run),
                    test_save_path=str(tmp_path / "port-test-{}-{}"))
    del port_cfg["rng_impl"]
    yaml_path = str(tmp_path / "port.yaml")
    _write_yaml(yaml_path, port_cfg)
    [(handler, tm)] = port_main(["--config", yaml_path, "--handler", "adv"])
    assert handler.device.type == "cpu"

    name = "test_mode_best_pred_exec-test.csv"
    jpids, jrows = _read_pred(osp.join(str(tmp_path / "jax-test-0.8-0"), name))
    tpids, trows = _read_pred(osp.join(str(tmp_path / "port-test-0.8-0"), name))
    assert tpids == jpids and len(tpids) == len(handler.patient_id["exec-test"])
    np.testing.assert_array_equal(trows[:, :2], jrows[:, :2])
    np.testing.assert_allclose(trows[:, 2], jrows[:, 2], atol=1e-5)
    assert np.ptp(trows[:, 2]) > 0          # predictions are not constant
    t_ci, j_ci = dict(tm["exec-test"])["cindex"], dict(jm["exec-test"])["cindex"]
    assert abs(t_ci - j_ci) <= 1e-6
    assert osp.exists(osp.join(str(tmp_path / "port-test-0.8-0"),
                               "test_mode_metrics-best.txt"))


def test_exec_and_other_modes_name_the_roadmap(synth, tmp_path):
    """exec is ported (tests/test_torch_train.py). As in the JAX package, a
    run whose warm-up outlasts its epochs saves no best checkpoint, and the
    final evaluation says so; the modes still missing name their item."""
    from advmil_tpu_torch.config import with_defaults
    from advmil_tpu_torch.train.handler import AdvHandler
    cfg = _cfg(synth, tmp_path, device="cpu", es_warmup=5)    # epochs: 1
    del cfg["rng_impl"]
    h = AdvHandler(with_defaults(cfg))
    with pytest.raises(FileNotFoundError):
        h.load_params("best", "train", load=True)     # nothing saved yet
    with pytest.raises(FileNotFoundError, match="es_warmup"):
        h.exec()
    assert osp.exists(osp.join(cfg["save_path"], "train_modelG-last.ckpt"))
    with pytest.raises(NotImplementedError, match="A11"):
        h.exec_semi_sl()
    with pytest.raises(NotImplementedError, match="A12"):
        AdvHandler(with_defaults(dict(cfg, bcb_mode="cluster")))


def test_port_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import advmil_tpu_torch, advmil_tpu_torch.main\n"
        "for m in pkgutil.walk_packages(advmil_tpu_torch.__path__, 'advmil_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'yaml', 'h5py', 'advmil_tpu'))\n"
        "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def test_bf16_test_mode_tracks_f32(synth, tmp_path):
    """precision bf16 (flax-style casts) on the CPU: same checkpoints, the
    predictions stay within bf16 rounding of the f32 run."""
    from advmil_tpu_torch.config import with_defaults
    from advmil_tpu_torch.train.handler import AdvHandler
    base = _cfg(synth, tmp_path, device="cpu")
    del base["rng_impl"]
    AdvHandler(with_defaults(dict(base))).save_model(0, "best", "train")
    preds = {}
    for prec in ("f32", "bf16"):
        cfg = with_defaults(dict(base, test=True, precision=prec,
                                 test_save_path=str(tmp_path / f"{prec}-{{}}-{{}}")))
        h = AdvHandler(cfg)
        h.exec_test()
        _, rows = _read_pred(osp.join(h.save_dir, "test_mode_best_pred_exec-test.csv"))
        preds[prec] = rows[:, 2]
        assert next(h.gen_model.backbone.pool.fc1.parameters()).dtype == torch.float32
    np.testing.assert_allclose(preds["bf16"], preds["f32"], atol=2e-2)
    assert not np.array_equal(preds["bf16"], preds["f32"])


def test_device_is_never_chosen_implicitly():
    from advmil_tpu_torch.train.common import resolve_device
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("gpu")
