"""Write the JAX checkpoint fixture that `chip_smoke.py` reads on the card,
where JAX is not installed: a JAX package run directory and the JAX
package's own numbers for it.

    JAX_PLATFORMS=cpu python scripts/make_jax_ckpt_fixture.py [--out tests/data/jax_ckpt]

The model is the narrowest adversarial one that still runs the LN-pool
kernel #1 on the card: G on ABMIL 16-32-32, D's X tower the patch embedding
16 -> 128 (#1 at D = 128 in test mode, #2 in a training step), f32. The
JAX handler (opt_flatten: false, dropout off, zero noise) takes one step
on the first batch of a 12-patient synthetic dataset, halves G's injected
learning rate, saves `train_model{G,D}-best.ckpt`, then records

- the step it takes next, on the second batch: its losses, G's parameters
  after it, and the eval-mode outputs of G and D on that batch after it
  (`expected.npz`);
- its test mode from the run directory (`test/test_mode_best_pred_exec-test.csv`,
  on the training split without occlusion).

The dataset (`data/`, 16-d features as .npy) and the config
(`config.json`, paths relative to the fixture) are written beside them.
The files stay under 1 MB together.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil
import sys

import numpy as np

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

LOSSES = ("Loss_D", "Loss_G_total", "Loss_G_fake", "Loss_G_time", "D_real")


def fixture_cfg(out: str) -> dict:
    """The run's config; data paths relative to the fixture directory."""
    return {
        "task": "cont_gansurv", "seed": 42, "save_path": "run", "dataset": "synthetic",
        "path_patch": "data/feats", "path_label": "data/labels.csv", "path_coordx5": None,
        "feat_format": "npy", "time_format": "ratio", "time_bins": 4,
        "data_split_path": "data/split-fold{}.npz", "data_split_seed": 0,
        "save_prediction": True, "bcb_mode": "abmil", "bcb_dims": "16-32-32",
        "gen_dims": "32-1", "gen_noi_noise": "0-0", "gen_noi_noise_dist": "uniform",
        "gen_noi_hops": 1, "gen_norm": False, "gen_dropout": 0.6,
        "gen_out_scale": "sigmoid", "disc_type": "prj", "disc_netx_in_dim": 16,
        "disc_netx_out_dim": 128, "disc_netx_ksize": 1, "disc_netx_backbone": "avgpool",
        "disc_netx_dropout": 0.25, "disc_nety_in_dim": 1, "disc_nety_hid_dims": "16-128",
        "disc_nety_norm": False, "disc_nety_dropout": 0.0, "disc_prj_path": "x",
        "disc_prj_iprd": "instance", "loss_gan_coef": 0.004, "loss_netD": "bce",
        "loss_regl1_coef": 0.00001, "loss_mle_alpha": 0.0, "loss_recon_norm": "l1",
        "loss_recon_alpha": 0.0, "loss_recon_gamma": 0.0, "opt_netG": "adam",
        "opt_netG_lr": 0.001, "opt_netG_weight_decay": 0.0005, "opt_netD_lr": 0.001,
        "epochs": 1, "es_patience": 30, "es_warmup": 0, "es_verbose": False,
        "es_start_epoch": 0, "gen_updates": 1, "monitor_metrics": "loss",
        "times_test_sample": 1, "test": False, "test_wandb_prj": None,
        "test_path": "train", "test_load_path": "run", "test_save_path": "test",
        "test_mask_ratio": 0.0, "test_sampling_times": 1, "test_zero_noise": True,
        "batch_token_budget": 256, "bucket_min": 32, "precision": "f32",
    }


def resolve(cfg: dict, root: str) -> dict:
    """The config with its relative paths under `root`."""
    keys = ("save_path", "path_patch", "path_label", "data_split_path", "test_load_path",
            "test_save_path")
    return dict(cfg, **{k: osp.join(root, cfg[k]) for k in keys})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=osp.join(ROOT, "tests", "data", "jax_ckpt"))
    args = ap.parse_args()
    import jax
    from advmil_tpu.config import with_defaults
    from advmil_tpu.models import layers as jlayers
    from advmil_tpu.train.handler import AdvHandler
    from advmil_tpu_torch import bridge
    from advmil_tpu_torch.data.bags import BucketBatcher, prepare_dataset
    from advmil_tpu_torch.data.synthetic import make_synthetic_dataset

    out = args.out
    shutil.rmtree(out, ignore_errors=True)
    paths = make_synthetic_dataset(osp.join(out, "data"), n_patients=12, dim=16,
                                   min_regions=1, max_regions=3, seed=3, feat_format="npy")
    for d in ("clusters", "coords"):
        shutil.rmtree(osp.join(out, "data", d), ignore_errors=True)
    os.remove(osp.join(out, "data", "split-fold0.npz"))
    pids = [f"P{i:04d}" for i in range(12)]
    # every patient in each split: test mode runs on the training split
    np.savez(osp.join(out, "data", "split-fold0.npz"), train_patients=np.asarray(pids),
             val_patients=np.asarray(pids[:4]), test_patients=np.asarray(pids[4:]))
    assert paths["path_patch"] == osp.join(out, "data", "feats")
    cfg = fixture_cfg(out)
    with open(osp.join(out, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1, sort_keys=True)
    full = resolve(cfg, out)

    jlayers.mask_dropout = lambda rng, rate, x: x           # dropout off
    jh = AdvHandler(with_defaults(dict(full, rng_impl="threefry", opt_flatten=False)))
    ds = prepare_dataset(pids, dict(full, bcb_mode="abmil"))
    batches = list(BucketBatcher(ds, token_budget=full["batch_token_budget"],
                                 min_bucket=full["bucket_min"]).epoch_batches())
    assert len(batches) >= 2, len(batches)

    def dev(b):
        return jh._ship({"feats": b.feats, "mask": b.mask, "label": b.label,
                         "sample_mask": b.sample_mask,
                         "visible": np.ones_like(b.sample_mask)})
    jh.state, _, _ = jh.train_step(jh.state, dev(batches[0]))
    jh._set_lr(cfg["opt_netG_lr"] * 0.5)
    jh.save_model(1, "best", "train")
    for f in os.listdir(full["save_path"]):
        if not f.endswith("-best.ckpt"):
            os.remove(osp.join(full["save_path"], f))

    b = batches[1]
    jh.state, met, _ = jh.train_step(jh.state, dev(b))
    g_after = bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, jh.state.params_G))
    x, mask = jax.numpy.asarray(b.feats), jax.numpy.asarray(b.mask)
    y_hat = jh.gen_model.apply({"params": jh.state.params_G}, x, mask, None,
                               zero_noise=True, deterministic=True)
    d_out = jh.disc_model.apply({"params": jh.state.params_D}, x,
                                jax.numpy.asarray(b.label[:, :1]), mask, deterministic=True)
    expected = {f"loss/{k}": np.float32(met[k]) for k in LOSSES}
    expected.update({f"G/{k}": v.numpy() for k, v in g_after.items()})
    expected.update(y_hat_after=np.asarray(y_hat, np.float32).reshape(-1),
                    d_after=np.asarray(d_out, np.float32).reshape(-1),
                    batch_idx=np.asarray(b.idx))
    np.savez(osp.join(out, "expected.npz"), **expected)

    AdvHandler(with_defaults(dict(full, test=True, rng_impl="threefry"))).exec_test()
    test_dir = full["test_save_path"]
    for f in os.listdir(test_dir):
        if f != "test_mode_best_pred_exec-test.csv":
            os.remove(osp.join(test_dir, f))
    size = sum(osp.getsize(osp.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
    print(f"fixture written to {out}: {size} bytes")
    assert size <= 1 << 20, size


if __name__ == "__main__":
    main()
