"""Write the JAX checkpoint fixtures that `chip_smoke.py` reads on the card,
where JAX is not installed: JAX package run directories and the JAX
package's own numbers for them.

    JAX_PLATFORMS=cpu python scripts/make_jax_ckpt_fixture.py [--out tests/data/jax_ckpt]
        [--runs adam,flat,lookahead_accum,base_opts,orbax]

`adam` (the top directory) is the narrowest adversarial model that still
runs the LN-pool kernel #1 on the card: G on ABMIL 16-32-32, D's X tower the
patch embedding 16 -> 128 (#1 at D = 128 in test mode, #2 in a training
step), f32. The JAX handler (opt_flatten: false, dropout off, zero noise)
takes one step on the first batch of a 12-patient synthetic dataset, halves
G's injected learning rate, saves `train_model{G,D}-best.ckpt`, then records

- the step it takes next, on the second batch: its losses, G's parameters
  after it, and the eval-mode outputs of G and D on that batch after it
  (`expected.npz`);
- its test mode from the run directory (`test/test_mode_best_pred_exec-test.csv`,
  on the training split without occlusion).

The dataset (`data/`, 16-d features as .npy) and the config
(`config.json`, paths relative to the fixture) are written beside them.
Rewriting `adam` rewrites the dataset and removes the other runs.

The other runs share that dataset; each is a directory of its own with its
`config.json` (data paths relative to the top directory, `save_path`
relative to its own), `run/` and `expected.npz` (the next step's losses,
parameters and eval outputs, and `batch_idx`, the bags of that step's
batch). D's X tower is 16 -> 32 in them: a 16 -> 128 tower's state alone
takes 855 KB a run under Adam and 1.14 MB under MultiSteps, and the new
files keep under 1 MB together. At 32 the tower takes the plain LN-pool
(the models run #1 at widths that are multiples of 128), so these runs
check the optimizer states; `chip_smoke.py`'s full-width check of the
fused layout runs #1 / #2.

- `flat/`: the adversarial handler at the JAX defaults (`opt_flatten`
  unset): G's and D's Adam state is one fused moment vector each;
- `lookahead_accum/`: `opt_netG: lookahead_radam`, `accum_steps: 2`, saved
  after three mini-steps (half an accumulator; G's and D's MultiSteps, G's
  Lookahead inside it), the next mini-step completing the accumulation;
- `base_opts/{sgd,adamp,adahessian}/`: the baseline handler on ABMIL
  16-32-32 with `opt_net` sgd (a fused `trace`), adamp (per tensor) and
  adahessian (its own state; the Rademacher z of the next step is drawn
  with numpy and recorded as `z/<parameter>`, which the port's step takes).

`orbax` writes `orbax/{adam,flat}/`: the `adam` and `flat` runs again with
`ckpt_backend: orbax`, each its `config.json` and `run/train_model{G,D}-
best.ckpt/` as orbax directories. The script asserts that the next step
from them equals the msgpack run's `expected.npz` bit for bit (and, for
`adam`, that the JAX test mode from the orbax directory writes the msgpack
run's prediction CSV), so those files serve both twins. They stay under
1 MB, a budget of their own (D's 16 -> 128 tower, whose state zstd does
not shrink, takes most of it).
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
BASE_LOSSES = ("loss_supervision", "loss_total")
RUNS = ("adam", "flat", "lookahead_accum", "base_opts", "orbax")
ORBAX_TWINS = ("adam", "flat")
BASE_OPTS = ("sgd", "adamp", "adahessian")
# D's X tower in the runs beside `adam` (the 1 MB budget; see above)
NARROW_D = {"disc_netx_out_dim": 32, "disc_nety_hid_dims": "16-32"}


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


def base_fixture_cfg(out: str, opt: str) -> dict:
    """A baseline run's config on the same data: ABMIL 16-32-32, surv_reg."""
    cfg = {k: v for k, v in fixture_cfg(out).items()
           if not k.startswith(("gen_", "disc_", "opt_net"))}
    # AdaHessian at 1e-3 diverges here (weights ~700 after two steps: its
    # step is lr * g / |Hessian diagonal|, and the loss is near-linear in
    # the last layers), where an f32 ulp is 6e-5; 1e-5 keeps them O(1-10)
    cfg.update(task="surv_reg", pdh_dims="32-1", mlp_hops=1, mlp_norm=False, mlp_dropout=0.25,
               loss_use_censored=False, opt_net=opt,
               opt_net_lr=1e-5 if opt == "adahessian" else 0.001,
               opt_net_weight_decay=0.0005)
    return cfg


DATA_KEYS = ("path_patch", "path_label", "data_split_path")
RUN_KEYS = ("save_path", "test_load_path", "test_save_path")


def resolve(cfg: dict, root: str, run_root: str | None = None) -> dict:
    """The config with its data paths under `root` and its run paths under
    `run_root` (default `root`)."""
    return dict(cfg, **{k: osp.join(root, cfg[k]) for k in DATA_KEYS},
                **{k: osp.join(run_root or root, cfg[k]) for k in RUN_KEYS})


def _write_data(out: str) -> None:
    from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
    shutil.rmtree(out, ignore_errors=True)
    paths = make_synthetic_dataset(osp.join(out, "data"), n_patients=12, dim=16,
                                   min_regions=1, max_regions=3, seed=3, feat_format="npy")
    for d in ("clusters", "coords"):
        shutil.rmtree(osp.join(out, "data", d), ignore_errors=True)
    os.remove(osp.join(out, "data", "split-fold0.npz"))
    # every patient in each split: test mode runs on the training split
    np.savez(osp.join(out, "data", "split-fold0.npz"), train_patients=np.asarray(PIDS),
             val_patients=np.asarray(PIDS[:4]), test_patients=np.asarray(PIDS[4:]))
    assert paths["path_patch"] == osp.join(out, "data", "feats")


PIDS = [f"P{i:04d}" for i in range(12)]


def _batches(full: dict) -> list:
    from advmil_tpu_torch.data.bags import BucketBatcher, prepare_dataset
    ds = prepare_dataset(PIDS, dict(full, bcb_mode="abmil"))
    batches = list(BucketBatcher(ds, token_budget=full["batch_token_budget"],
                                 min_bucket=full["bucket_min"]).epoch_batches())
    assert len(batches) >= 2, len(batches)
    return batches


def _dev(jh, b) -> dict:
    return jh._ship({"feats": b.feats, "mask": b.mask, "label": b.label,
                     "sample_mask": b.sample_mask, "visible": np.ones_like(b.sample_mask)})


def _torch_tree(tree) -> dict:
    import jax
    from advmil_tpu_torch import bridge
    return bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, tree))


def _keep_ckpts(save_path: str) -> None:
    for f in os.listdir(save_path):
        if not f.endswith("-best.ckpt"):
            path = osp.join(save_path, f)
            shutil.rmtree(path) if osp.isdir(path) else os.remove(path)


def _write_cfg(run_dir: str, cfg: dict) -> None:
    os.makedirs(run_dir, exist_ok=True)
    with open(osp.join(run_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1, sort_keys=True)


def adam_run(out: str) -> None:
    """The top directory: the dataset and the Adam pair (opt_flatten: false)
    with its test mode."""
    from advmil_tpu.config import with_defaults
    from advmil_tpu.train.handler import AdvHandler
    _write_data(out)
    cfg = fixture_cfg(out)
    _write_cfg(out, cfg)
    full = resolve(cfg, out)
    jh = AdvHandler(with_defaults(dict(full, rng_impl="threefry", opt_flatten=False)))
    batches = _batches(full)
    jh.state, _, _ = jh.train_step(jh.state, _dev(jh, batches[0]))
    jh._set_lr(cfg["opt_netG_lr"] * 0.5)
    jh.save_model(1, "best", "train")
    _keep_ckpts(full["save_path"])

    np.savez(osp.join(out, "expected.npz"), **_next_step(jh, batches[1], ("G",)))

    AdvHandler(with_defaults(dict(full, test=True, rng_impl="threefry"))).exec_test()
    test_dir = full["test_save_path"]
    for f in os.listdir(test_dir):
        if f != "test_mode_best_pred_exec-test.csv":
            os.remove(osp.join(test_dir, f))


def adv_run(out: str, name: str, before: list, **over) -> None:
    """An adversarial run `name`: mini-steps on the batches `before`, G's
    injected learning rate halved, saved; then the step on the next batch
    and the eval outputs after it in `expected.npz`."""
    from advmil_tpu.config import with_defaults
    from advmil_tpu.train.handler import AdvHandler
    run_dir = osp.join(out, name)
    shutil.rmtree(run_dir, ignore_errors=True)
    cfg = dict(fixture_cfg(out), **NARROW_D, **over)
    _write_cfg(run_dir, cfg)
    full = resolve(cfg, out, run_dir)
    jh = AdvHandler(with_defaults(dict(full, rng_impl="threefry")))
    batches = _batches(full)
    for i in before:
        jh.state, _, _ = jh.train_step(jh.state, _dev(jh, batches[i]))
    jh._set_lr(cfg["opt_netG_lr"] * 0.5)
    jh.save_model(1, "best", "train")
    _keep_ckpts(full["save_path"])
    b = batches[(before[-1] + 1) % len(batches)]
    np.savez(osp.join(run_dir, "expected.npz"), **_next_step(jh, b, ("G", "D")))


def _next_step(jh, b, nets) -> dict:
    """The JAX handler's step on batch `b`: its losses, the parameters of
    `nets` after it, and the eval-mode outputs of G and D on `b` after it."""
    import jax
    jh.state, met, _ = jh.train_step(jh.state, _dev(jh, b))
    x, mask = jax.numpy.asarray(b.feats), jax.numpy.asarray(b.mask)
    y_hat = jh.gen_model.apply({"params": jh.state.params_G}, x, mask, None,
                               zero_noise=True, deterministic=True)
    d_out = jh.disc_model.apply({"params": jh.state.params_D}, x,
                                jax.numpy.asarray(b.label[:, :1]), mask, deterministic=True)
    expected = {f"loss/{k}": np.float32(met[k]) for k in LOSSES}
    for net in nets:
        tree = {"G": jh.state.params_G, "D": jh.state.params_D}[net]
        expected.update({f"{net}/{k}": v.numpy() for k, v in _torch_tree(tree).items()})
    expected.update(y_hat_after=np.asarray(y_hat, np.float32).reshape(-1),
                    d_after=np.asarray(d_out, np.float32).reshape(-1),
                    batch_idx=np.asarray(b.idx))
    return expected


def orbax_run(out: str, twin: str) -> None:
    """`orbax/<twin>/`: the msgpack run `twin` (`adam`, the top directory,
    or `flat`) again with `ckpt_backend: orbax`: the same steps before the
    save, the save, then the same next step, which must equal the msgpack
    run's `expected.npz` bit for bit; for `adam`, the JAX test mode from
    the orbax directory must write the msgpack run's prediction CSV."""
    from advmil_tpu.config import with_defaults
    from advmil_tpu.train.handler import AdvHandler
    src = out if twin == "adam" else osp.join(out, twin)
    run_dir = osp.join(out, "orbax", twin)
    shutil.rmtree(run_dir, ignore_errors=True)
    with open(osp.join(src, "config.json")) as f:
        cfg = dict(json.load(f), ckpt_backend="orbax")
    _write_cfg(run_dir, cfg)
    full = resolve(cfg, out, run_dir)
    over = {"opt_flatten": False} if twin == "adam" else {}
    jh = AdvHandler(with_defaults(dict(full, rng_impl="threefry", **over)))
    batches = _batches(full)
    jh.state, _, _ = jh.train_step(jh.state, _dev(jh, batches[0]))
    jh._set_lr(cfg["opt_netG_lr"] * 0.5)
    jh.save_model(1, "best", "train")
    _keep_ckpts(full["save_path"])
    assert all(osp.isfile(osp.join(full["save_path"], f"train_model{n}-best.ckpt", "_METADATA"))
               for n in "GD")
    got = _next_step(jh, batches[1], ("G",) if twin == "adam" else ("G", "D"))
    want = np.load(osp.join(src, "expected.npz"))
    assert sorted(got) == sorted(want.files), (sorted(got), want.files)
    for k in want.files:
        assert np.array_equal(got[k], want[k]), f"orbax/{twin}: {k} differs from {src}"
    if twin == "adam":
        AdvHandler(with_defaults(dict(full, test=True, rng_impl="threefry"))).exec_test()
        name = "test_mode_best_pred_exec-test.csv"
        with open(osp.join(full["test_save_path"], name)) as f, \
                open(osp.join(out, "test", name)) as g:
            assert f.read() == g.read(), "orbax/adam: test mode differs from the msgpack run's"
        shutil.rmtree(full["test_save_path"])


def base_run(out: str, opt: str) -> None:
    """A baseline run of `opt_net: opt` under base_opts/: one step on batch
    0, the injected learning rate halved (AdaHessian has none), saved; then
    the step on batch 1 and the eval predictions after it. AdaHessian's
    Rademacher z are numpy draws (seed 5), made while a step traces; those
    of the step after the save are recorded."""
    import jax
    import jax.numpy as jnp
    from advmil_tpu.config import with_defaults
    from advmil_tpu.train.baseline import BaselineHandler
    from advmil_tpu_torch import bridge
    run_dir = osp.join(out, "base_opts", opt)
    shutil.rmtree(run_dir, ignore_errors=True)
    cfg = base_fixture_cfg(out, opt)
    _write_cfg(run_dir, cfg)
    full = resolve(cfg, out, run_dir)
    jh = BaselineHandler(with_defaults(dict(full, rng_impl="threefry")))
    batches = _batches(full)
    rng = np.random.default_rng(5)
    drawn = []

    def rademacher(key, shape, dtype=jnp.float32):
        z = rng.integers(0, 2, size=tuple(shape)).astype(np.float32) * 2 - 1
        drawn.append(z)
        return jnp.asarray(z, dtype)

    real = jax.random.rademacher
    jax.random.rademacher = rademacher       # called while a step traces
    try:
        jh.state, _, _ = jh.train_step(jh.state, _dev(jh, batches[0]))
        jh._set_lr(cfg["opt_net_lr"] * 0.5)
        jh.save_model(1, "best", "train")
        _keep_ckpts(full["save_path"])
        b = batches[1]
        first = list(drawn)
        drawn.clear()
        jh.state, met, _ = jh.train_step(jh.state, _dev(jh, b))
    finally:
        jax.random.rademacher = real
    z = {}
    if opt == "adahessian":     # a new trace draws new z; else the first trace's stay
        leaves, treedef = jax.tree_util.tree_flatten(jh.state.params)
        zs = drawn or first
        assert len(zs) == len(leaves), (len(zs), len(leaves))
        z = bridge.flax_to_torch(jax.tree_util.tree_unflatten(treedef, zs))
    pred = jh.model.apply({"params": jh.state.params}, jnp.asarray(b.feats),
                          jnp.asarray(b.mask), None, deterministic=True)
    expected = {f"loss/{k}": np.float32(met[k]) for k in BASE_LOSSES}
    expected.update({f"net/{k}": v.numpy() for k, v in _torch_tree(jh.state.params).items()})
    expected.update({f"z/{k}": v.numpy() for k, v in z.items()})
    expected.update(pred_after=np.asarray(pred, np.float32).reshape(-1),
                    batch_idx=np.asarray(b.idx))
    np.savez(osp.join(run_dir, "expected.npz"), **expected)


def _size(root: str, skip=()) -> int:
    return sum(osp.getsize(osp.join(d, f)) for d, _, fs in os.walk(root) for f in fs
               if not any(osp.join(d, f).startswith(osp.join(root, s) + os.sep) for s in skip))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=osp.join(ROOT, "tests", "data", "jax_ckpt"))
    ap.add_argument("--runs", default=",".join(RUNS),
                    help=f"comma-separated, of {RUNS}; `adam` rewrites the dataset")
    args = ap.parse_args()
    from advmil_tpu.models import layers as jlayers
    runs = args.runs.split(",")
    if not set(runs) <= set(RUNS):
        raise SystemExit(f"--runs: unknown {sorted(set(runs) - set(RUNS))}")
    out = args.out
    jlayers.mask_dropout = lambda rng, rate, x: x           # dropout off
    if "adam" in runs:
        adam_run(out)
    elif not osp.isdir(osp.join(out, "data")):
        raise SystemExit(f"{out}/data is missing: write the `adam` run first")
    if "flat" in runs:
        adv_run(out, "flat", [0])
    if "lookahead_accum" in runs:
        adv_run(out, "lookahead_accum", [0, 1, 2], opt_netG="lookahead_radam", accum_steps=2)
    for opt in BASE_OPTS if "base_opts" in runs else ():
        base_run(out, opt)
    for twin in ORBAX_TWINS if "orbax" in runs else ():
        orbax_run(out, twin)
    new = [r for r in RUNS[1:-1] if osp.isdir(osp.join(out, r))]
    old = _size(out, skip=new + ["orbax"])
    added, orbax = sum(_size(osp.join(out, r)) for r in new), _size(osp.join(out, "orbax"))
    print(f"fixtures written to {out}: {old} bytes (adam), {added} bytes ({', '.join(new)}), "
          f"{orbax} bytes (orbax)")
    assert max(old, added, orbax) <= 1 << 20, (old, added, orbax)


if __name__ == "__main__":
    main()
