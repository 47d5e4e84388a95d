"""The training slice of advmil_tpu_torch against advmil_tpu on the CPU in
f32: the gradients of the two kernel ops, the Philox dropout stream, the
training-side pieces (losses, optimizer, plateau LR, early stopping, the
shuffled batch order), three adversarial steps, and the whole `exec` run.

Dropout and noise cannot match between the frameworks draw for draw, so the
step and `exec` comparisons switch both off: the JAX package's
`mask_dropout` (every JAX dropout's single call site) is monkeypatched to
the identity, every port `Dropout` rate is set to 0, and the generator's
noise is configured off (`gen_noi_noise: 0-0`, `times_test_sample: 1`).
The JAX side runs its Pallas kernels in interpret mode, as its own tests do.
"""
import csv
import os
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from advmil_tpu import losses as jlosses
from advmil_tpu.config import with_defaults as j_with_defaults
from advmil_tpu.data.bags import BucketBatcher as JBucketBatcher
from advmil_tpu.models import layers as jlayers
from advmil_tpu.ops import attention as jattn
from advmil_tpu.ops import ln_pool as jlnp
from advmil_tpu.train.optim import ReduceLROnPlateau as JPlateau
from advmil_tpu.utils.func import EarlyStopping as JEarlyStopping
from advmil_tpu_torch import bridge
from advmil_tpu_torch import losses as tlosses
from advmil_tpu_torch.config import with_defaults
from advmil_tpu_torch.data.bags import BucketBatcher, prepare_dataset
from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
from advmil_tpu_torch.models import layers as tl
from advmil_tpu_torch.ops import attention as tattn
from advmil_tpu_torch.ops import ln_pool as tlnp
from advmil_tpu_torch.ops import philox as tphilox
from advmil_tpu_torch.train import handler as thandler
from advmil_tpu_torch.train.optim import ReduceLROnPlateau, adam_with_l2
from advmil_tpu_torch.utils.func import EarlyStopping

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


# ---------------------------------------------------------------------------
# kernel ops: gradients against the JAX custom VJPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [128, 384])
def test_ln_pool_gradients_match_jax(D):
    """dh, dscale, dbias of the port's op (autograd through the plain version
    on the CPU) against jax.vjp through the Pallas backward kernel; the last
    bag has fully padded regions, whose cotangent is 0 as the model's region
    mask makes it."""
    M = 512
    rng = np.random.default_rng(D)
    h = rng.normal(size=(M, D)).astype(np.float32)
    h[-64:] = 0.0                                   # 4 fully padded regions
    scale = (1.0 + rng.normal(0, 0.1, size=(D,))).astype(np.float32)
    bias = rng.normal(0, 0.1, size=(D,)).astype(np.float32)
    g = rng.normal(size=(M // 16, D)).astype(np.float32)
    g[-4:] = 0.0
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jlnp.ln_relu_region_mean, jnp.asarray(h),
                         jnp.asarray(scale), jnp.asarray(bias))
        want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    th, ts, tb = (torch.from_numpy(a).requires_grad_(True) for a in (h, scale, bias))
    tlnp.ln_relu_region_mean(th, ts, tb).backward(torch.from_numpy(g))
    for got, w in zip((th.grad, ts.grad, tb.grad), want):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5, rtol=1e-5)


def _attn_case(B, L, H, Dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, L, H, Dh)).astype(np.float32) for _ in range(4))
    mask = np.ones((B, L), np.float32)
    mask[0, L - 37:] = 0.0                  # ragged bag
    mask[-1] = 0.0                          # fully masked (dummy) bag
    return q, k, v, mask, do


@pytest.mark.parametrize("B,L,H,Dh", [(3, 300, 2, 16), (2, 130, 4, 48)])
def test_flash_gradients_match_jax(B, L, H, Dh):
    q, k, v, mask, do = _attn_case(B, L, H, Dh, seed=L)

    def jloss(q_, k_, v_):
        out = jattn.masked_flash_attention(q_, k_, v_, jnp.asarray(mask), interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    want = [np.asarray(a) for a in jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tattn.masked_flash_attention(tq, tk, tv, torch.from_numpy(mask))
    out.backward(torch.from_numpy(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5)
        assert np.all(got.numpy()[-1] == 0.0)          # dummy bag: exactly 0


# ---------------------------------------------------------------------------
# the Philox dropout stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answers(ctr, key, want):
    words = tphilox.philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


@pytest.mark.parametrize("p", [0.25, 0.6])
def test_keep_rate_is_one_minus_p(p):
    n = 1 << 20
    keep = tphilox.keep_mask_plain(2024, 4, 512, n // 2048, p)
    assert keep.numel() == n
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(float(keep.mean()) - (1 - p)) < 3 * sigma


def test_keep_mask_does_not_depend_on_the_tile_split():
    """Any tile of the mask, computed from its own counters, equals that tile
    of the whole mask: the kernels regenerate the same bits whatever their
    tiling."""
    seed, BH, Lq, Lk, p = 77, 3, 150, 131, 0.25
    full = tphilox.keep_mask_plain(seed, BH, Lq, Lk, p)
    lo, hi = tphilox.split_seed(seed)
    for (r0, r1), (c0, c1) in [((0, 64), (0, 64)), ((64, 150), (64, 131)),
                               ((5, 38), (3, 70)), ((149, 150), (130, 131))]:
        cols = torch.arange(c0, c1)[None, None, :]
        rows = torch.arange(r0, r1)[None, :, None]
        bhs = torch.arange(BH)[:, None, None]
        c0_, c1_, c2_ = torch.broadcast_tensors(cols // 4, rows, bhs)
        words = torch.stack(tphilox.philox4x32_10(c0_, c1_, c2_, torch.zeros((), dtype=torch.int64), lo, hi),
                            dim=-1)
        bits = torch.gather(words, -1, (cols % 4).expand(BH, r1 - r0, c1 - c0)[..., None])
        tile = (bits[..., 0] >= tphilox.threshold(p)).float()
        assert torch.equal(tile, full[:, r0:r1, c0:c1])


def test_flash_dropout_on_cpu_uses_the_materialised_mask():
    q, k, v, mask, _ = (torch.from_numpy(a) for a in _attn_case(2, 40, 2, 8, seed=3))
    p, seed = 0.25, 11
    got = tattn.masked_flash_attention(q, k, v, mask, dropout_p=p, seed=seed)
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / 8 ** 0.5
                          + (mask[:, None, None, :] - 1) * 1e30, dim=-1)
    probs = probs * mask[:, None, None, :]
    keep = tphilox.keep_mask_plain(seed, 4, 40, 40, p).reshape(2, 2, 40, 40)
    want = torch.einsum("bhqk,bkhd->bqhd", probs * keep / (1 - p), v)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    other = tattn.masked_flash_attention(q, k, v, mask, dropout_p=p, seed=seed + 1)
    assert not torch.allclose(got[0], other[0])
    with pytest.raises(ValueError, match="seed"):
        tattn.masked_flash_attention(q, k, v, mask, dropout_p=p)


def test_dropout_module_draws_from_its_generator():
    drop = tl.Dropout(0.25).train()
    x = torch.ones(4096)
    rngs = [tl.Rngs(torch.Generator().manual_seed(1), torch.Generator()) for _ in range(2)]
    a, b = drop(x, rngs[0]), drop(x, rngs[1])
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, float(torch.tensor(1.0) / 0.75)}
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.03
    with pytest.raises(ValueError, match="generators"):
        drop(x, None)
    assert torch.equal(drop.eval()(x, None), x)


# ---------------------------------------------------------------------------
# losses, optimizer, schedules, batch order
# ---------------------------------------------------------------------------

def test_weighted_losses_match_jax():
    rng = np.random.default_rng(4)
    real, fake, pred = (rng.normal(size=(9, 1)).astype(np.float32) for _ in range(3))
    t = rng.uniform(size=9).astype(np.float32)
    e = (rng.uniform(size=9) > 0.4).astype(np.float32)
    w1 = (rng.uniform(size=9) > 0.3).astype(np.float32)
    w2 = np.ones(9, np.float32)
    w2[-2:] = 0.0
    T = lambda a: torch.from_numpy(a)  # noqa: E731
    J = jnp.asarray
    for which in ("bce", "hinge", "wasserstein"):
        np.testing.assert_allclose(
            float(tlosses.real_fake_loss(T(real), T(fake), which, T(w1), T(w2))),
            float(jlosses.real_fake_loss(J(real), J(fake), which, J(w1), J(w2))),
            rtol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.recon_loss(T(pred[:, 0]), T(t), T(e), gamma=0.0, weight=T(w1))),
        float(jlosses.recon_loss(J(pred[:, 0]), J(t), J(e), gamma=0.0, weight=J(w1))),
        rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.fake_generator_loss(T(fake), T(w2))),
                               float(jlosses.fake_generator_loss(J(fake), J(w2))),
                               rtol=1e-6)
    assert float(tlosses._wmean(T(real), torch.zeros(9))) == 0.0
    params = [T(real), T(fake)]
    np.testing.assert_allclose(float(tlosses.loss_reg_l1(params, 1e-3)),
                               float(jlosses.loss_reg_l1([J(real), J(fake)], 1e-3)),
                               rtol=1e-6)


def test_adam_with_l2_decays_matrices_only():
    w = torch.nn.Parameter(torch.ones(3, 2))
    b = torch.nn.Parameter(torch.ones(2))
    opt = adam_with_l2([w, b], lr=0.1, weight_decay=0.5)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.5, 0.0]
    w.grad, b.grad = torch.zeros_like(w), torch.zeros_like(b)
    opt.step()
    assert torch.all(w < 1.0) and torch.equal(b.detach(), torch.ones(2))


def test_plateau_and_early_stopping_follow_jax():
    vals = [1.0, 0.9, 0.9, 0.95, 0.8999, 0.91, 0.92, 0.93, 0.94, 0.95, 0.96,
            0.97, 0.98, 0.99, 0.85, 0.86]
    tp, jp = ReduceLROnPlateau(patience=3), JPlateau(patience=3)
    te = EarlyStopping(warmup=1, patience=4, start_epoch=2)
    je = JEarlyStopping(warmup=1, patience=4, start_epoch=2)
    for epoch, v in enumerate(vals):
        assert tp.step(v) == jp.step(v)
        te(epoch, v)
        je(epoch, v)
        assert (te.if_save_checkpoint(), te.if_stop(), te.counter) == \
            (je.if_save_checkpoint(), je.if_stop(), je.counter)
    assert tp.scale < 1.0 and te.if_stop()


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """36 patients of 4-16 regions: one 256-patch bucket, so each JAX step
    compiles once."""
    root = str(tmp_path_factory.mktemp("train_data"))
    return make_synthetic_dataset(root, n_patients=36, dim=64, min_regions=4,
                                  max_regions=16, seed=5, feat_format="pt")


def test_shuffled_batch_order_matches_jax(synth):
    from advmil_tpu.data.bags import BagDataset as JBagDataset
    pids = [f"P{i:04d}" for i in range(36)]
    tds = prepare_dataset(pids, {"path_patch": synth["path_patch"],
                                 "path_label": synth["path_label"], "bcb_mode": "patch",
                                 "feat_format": "pt", "time_format": "ratio"})
    jds = JBagDataset(pids, synth["path_patch"], synth["path_label"], mode="patch",
                      read_format="pt", time_format="ratio")
    tb = BucketBatcher(tds, token_budget=1024, bucket_growth=1.5, min_bucket=64)
    jb = JBucketBatcher(jds, token_budget=1024, bucket_growth=1.5, min_bucket=64)
    trng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for workers in (1, 3):                       # serial and thread-pool loaders
        tbs = list(tb.prefetch(shuffle=True, rng=trng, workers=workers))
        jbs = list(jb.prefetch(shuffle=True, rng=jrng, workers=workers))
        assert len(tbs) == len(jbs) > 3
        for a, b in zip(tbs, jbs):
            np.testing.assert_array_equal(a.idx, b.idx)
            np.testing.assert_array_equal(a.feats, b.feats)
            np.testing.assert_array_equal(a.sample_mask, b.sample_mask)
    assert [b.idx.tolist() for b in tbs] != [b.idx.tolist() for b in tb.epoch_batches()]


# ---------------------------------------------------------------------------
# three adversarial steps and the whole exec against the JAX package
# ---------------------------------------------------------------------------

def _cfg(paths, tmp_path, name, **over):
    cfg = {
        "task": "cont_gansurv", "seed": 42, "save_path": str(tmp_path / name),
        "dataset": "synthetic", "path_patch": paths["path_patch"],
        "path_label": paths["path_label"], "path_coordx5": None,
        "feat_format": "pt", "time_format": "ratio", "time_bins": 4,
        "data_split_path": paths["data_split_path"], "data_split_seed": 0,
        "save_prediction": True, "bcb_mode": "patch", "bcb_dims": "64-128-128",
        "gen_dims": "128-1", "gen_noi_noise": "0-0",
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
        "opt_netG_weight_decay": 0.0005, "opt_netD_lr": 0.00008, "epochs": 2,
        "es_patience": 30, "es_warmup": 0, "es_verbose": False,
        "es_start_epoch": 0, "gen_updates": 1, "monitor_metrics": "loss",
        "times_test_sample": 1, "test": False, "test_wandb_prj": None,
        "test_path": "test", "test_load_path": str(tmp_path / name),
        "test_save_path": str(tmp_path / (name + "-test-{}-{}")),
        "test_mask_ratio": 0.8, "test_sampling_times": 1,
        "test_zero_noise": True, "batch_token_budget": 4096, "bucket_min": 256,
        "precision": "f32",
    }
    cfg.update(over)
    return cfg


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(jlayers, "mask_dropout", lambda rng, rate, x: x)


def _three_steps_match_jax(synth, tmp_path, visible_of=None, **over):
    """Three adversarial steps of the JAX handler and the port from the same
    weights on the same batches (`visible_of(i, batch)`: the [B] visibility
    of step i, default all 1): losses within rtol 1e-5, then every parameter
    of G and D within 1e-5."""
    from advmil_tpu.train.handler import AdvHandler as JaxHandler
    jh = JaxHandler(j_with_defaults(_cfg(synth, tmp_path, "jax", rng_impl="threefry", **over)))
    th = thandler.AdvHandler(with_defaults(_cfg(synth, tmp_path, "port", device="cpu", **over)))
    # strict loads: the bridge carries every tensor, the task's head widths included
    th.gen_model.load_state_dict(bridge.flax_to_torch(_np_tree(jh.state.params_G)))
    th.disc_model.load_state_dict(bridge.flax_to_torch(_np_tree(jh.state.params_D)))
    tl.set_dropout_rates(th.gen_model, 0.0)
    tl.set_dropout_rates(th.disc_model, 0.0)

    pids = [f"P{i:04d}" for i in range(36)]
    ds = prepare_dataset(pids, th.cfg)
    batches = list(BucketBatcher(ds, token_budget=4096).epoch_batches())[:3]
    for i, batch in enumerate(batches):
        visible = (np.ones_like(batch.sample_mask) if visible_of is None
                   else visible_of(i, batch))
        jdev = {"feats": jnp.asarray(batch.feats), "mask": jnp.asarray(batch.mask),
                "label": jnp.asarray(batch.label),
                "sample_mask": jnp.asarray(batch.sample_mask),
                "visible": jnp.asarray(visible)}
        jh.state, jmet, _ = jh.train_step(jh.state, jdev)
        tmet, _ = th.train_step(th._ship(batch, train=True, visible=visible), th.train_rngs)
        for k in ("Loss_D", "Loss_G_total", "Loss_G_fake", "Loss_G_time", "D_real"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5,
                                       err_msg=k)
    for model, jparams in ((th.gen_model, jh.state.params_G),
                           (th.disc_model, jh.state.params_D)):
        want = bridge.flax_to_torch(_np_tree(jparams))
        got = model.state_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5,
                                       err_msg=k)
    return th


def test_three_adversarial_steps_match_jax(synth, tmp_path, no_jax_dropout):
    _three_steps_match_jax(synth, tmp_path)


def test_three_disc_gansurv_steps_match_jax(synth, tmp_path, no_jax_dropout):
    """disc_gansurv: quantile bins, G's 4 hazards, D's Y tower on 4 inputs."""
    th = _three_steps_match_jax(synth, tmp_path, task="disc_gansurv",
                                time_format="quantile", gen_dims="128-4",
                                disc_nety_in_dim=4)
    assert th.gen_model.state_dict()["head_mlp.mlp_1.weight"].shape == (4, 64)
    assert th.disc_model.state_dict()["net_pair_two.mlp_0.Dense_0.weight"].shape == (16, 4)


@pytest.mark.parametrize("pattern", ["mixed", "none_visible"])
def test_three_steps_with_hidden_labels_match_jax(synth, tmp_path, no_jax_dropout, pattern):
    """cont_gansurv with per-sample label visibility (semi-supervised
    training): a mixed 0 / 1 vector, and all 0 in the last step, where the
    supervised loss's weights sum to 0 and the loss is exactly 0."""
    def visible_of(i, batch):
        v = (np.arange(len(batch.idx)) % 3 != 0).astype(np.float32)
        return np.zeros_like(v) if pattern == "none_visible" and i == 2 else v
    _three_steps_match_jax(synth, tmp_path, visible_of)


def _read_pred(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return {r["patient_id"]: float(r["pred_t"]) for r in rows}


def _write_yaml(path, cfg):
    """Floats positionally: YAML 1.1 reads `8e-05` (no dot) as a string."""
    def fmt(v):
        if v is None:
            return "null"
        return np.format_float_positional(v) if isinstance(v, float) else str(v)
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k}: {fmt(v)}\n")


def test_exec_matches_jax(synth, tmp_path, monkeypatch, no_jax_dropout):
    from advmil_tpu.train.handler import AdvHandler as JaxHandler
    from advmil_tpu_torch.main import main as port_main

    jh = JaxHandler(j_with_defaults(_cfg(synth, tmp_path, "jax", rng_impl="threefry")))
    init = {42: bridge.flax_to_torch(_np_tree(jh.params_G)),
            43: bridge.flax_to_torch(_np_tree(jh.params_D))}
    jm = jh.exec()

    def from_jax_init(model, seed):     # the port starts where the JAX run started
        model.load_state_dict(init[seed])
        return tl.set_dropout_rates(model, 0.0)

    monkeypatch.setattr(thandler, "init_parameters", from_jax_init)
    yaml_path = str(tmp_path / "port.yaml")
    _write_yaml(yaml_path, _cfg(synth, tmp_path, "port", device="cpu"))
    [(th, tm)] = port_main(["--config", yaml_path, "--handler", "adv"])
    assert th.device.type == "cpu" and len(th.train_timings) == 2

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for split in ("train", "validation", "test"):
        name = f"train_best_pred_{split}.csv"
        jp, tp = _read_pred(osp.join(jdir, name)), _read_pred(osp.join(tdir, name))
        assert sorted(tp) == sorted(jp) and len(tp) > 0
        assert np.ptp(list(tp.values())) > 0          # predictions are not constant
        np.testing.assert_allclose([tp[k] for k in sorted(jp)],
                                   [jp[k] for k in sorted(jp)], atol=1e-4, err_msg=split)
        assert abs(dict(tm[split])["cindex"] - dict(jm[split])["cindex"]) <= 1e-4
    for f in ("train_modelG-best.ckpt", "train_modelD-best.ckpt",
              "train_modelG-last.ckpt", "train_modelD-last.ckpt",
              "train_metrics-best.txt", "print_config.txt"):
        assert osp.exists(osp.join(jdir, f)) and osp.exists(osp.join(tdir, f)), f
    bundle = torch.load(osp.join(tdir, "train_modelG-last.ckpt"), weights_only=True)
    assert bundle["epoch"] == 2 and bundle["opt_state"]["state"]


def test_training_path_imports_no_jax():
    code = ("import sys\n"
            "import advmil_tpu_torch.main, advmil_tpu_torch.train.handler\n"
            "import advmil_tpu_torch.train.steps, advmil_tpu_torch.train.optim\n"
            "import advmil_tpu_torch.train.baseline, advmil_tpu_torch.losses\n"
            "import advmil_tpu_torch.utils.func, advmil_tpu_torch.data.bags\n"
            "import advmil_tpu_torch.ops.philox\n"
            "print('BAD', sorted(k for k in sys.modules if k.split('.')[0] in\n"
            "      ('jax', 'jaxlib', 'flax', 'optax', 'advmil_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


# graph_grid_resident, refused until ROADMAP A13, runs in test_torch_grid.py
_REFUSED_WITH = {"dist_num_processes": {"inst_devices": 2, "bcb_mode": "cluster"},
                 "inst_devices": {"bcb_mode": "graph"}}


@pytest.mark.parametrize("key,value,item", [("log_plot", True, "A9"),
                                            ("dist_num_processes", 2, "A14"),
                                            ("inst_devices", 2, "A14")])
def test_unported_training_options_name_the_roadmap(synth, tmp_path, key, value, item):
    # parallelism runs; under it, what is refused is inst_devices over cluster / graph
    over = {key: value, **_REFUSED_WITH.get(key, {})}
    cfg = with_defaults(_cfg(synth, tmp_path, "port", device="cpu", **over))
    with pytest.raises(NotImplementedError, match=item):
        thandler.AdvHandler(cfg)
