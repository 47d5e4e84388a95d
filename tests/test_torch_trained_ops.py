"""The port's ops on trained activations against the JAX package's Pallas ops.

The kernels' tight bounds were set on unit-normal rows; after training, LN
inputs carry per-row offsets, attention logits grow peaky and graph
messages spread over magnitudes. Here the port trains on the CPU for a few
epochs (f32, widths of 128 that the Pallas kernels take, a learning rate
high enough that the weights move), then one training-mode forward of G
and D with dropout off runs with the ops' inputs recorded by
`chip_smoke.recorded_calls`, the instrument of `chip_smoke.py` phase 40.
The same arrays go, as numpy, through the JAX package's ops with Pallas in
interpret mode, and the port's ops (their plain versions on the CPU) must
give the same values and gradients, within the f32 bounds the other
`test_torch_*` comparisons of these ops state. The cotangents are seeded
normal draws."""
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from advmil_tpu.ops import attention as jattn
from advmil_tpu.ops import fused_embed as jfe
from advmil_tpu.ops import ln_pool as jlnp
from advmil_tpu.ops import segment as jseg
from advmil_tpu_torch.config import check_configs, with_defaults
from advmil_tpu_torch.data.bags import prepare_dataset
from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
from advmil_tpu_torch.models import backbones as tbackbones
from advmil_tpu_torch.models import layers as tlayers
from advmil_tpu_torch.models.layers import set_dropout_rates
from advmil_tpu_torch.ops import attention as tattn
from advmil_tpu_torch.ops import fused_embed as tfe
from advmil_tpu_torch.ops import ln_pool as tlnp
from advmil_tpu_torch.ops import segment as tseg
from advmil_tpu_torch.train.handler import AdvHandler
from advmil_tpu_torch.utils.io import read_datasplit_npz

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
from chip_smoke import recorded_calls  # noqa: E402

# the ops as the model modules call them: (module, name)
RECORDED = ((tlayers, "ln_relu_region_mean"), (tlayers, "masked_flash_attention"),
            (tlayers, "fused_region_embedding"), (tbackbones, "fused_knn_softmax_aggregate"))


def _cfg(paths, root, name, **over):
    cfg = {
        "task": "cont_gansurv", "seed": 42, "save_path": str(root / name),
        "dataset": "synthetic", "path_patch": paths["path_patch"],
        "path_label": paths["path_label"], "path_coordx5": None,
        "feat_format": "pt", "time_format": "ratio", "time_bins": 4,
        "data_split_path": paths["data_split_path"], "data_split_seed": 0,
        "save_prediction": False, "bcb_mode": "patch", "bcb_dims": "128-128-128",
        "gen_dims": "128-1", "gen_noi_noise": "0-0",
        "gen_noi_noise_dist": "uniform", "gen_noi_hops": 1, "gen_norm": False,
        "gen_dropout": 0.0, "gen_out_scale": "sigmoid", "disc_type": "prj",
        "disc_netx_in_dim": 128, "disc_netx_out_dim": 128, "disc_netx_ksize": 1,
        "disc_netx_backbone": "avgpool", "disc_netx_dropout": 0.0,
        "disc_nety_in_dim": 1, "disc_nety_hid_dims": "16-128",
        "disc_nety_norm": False, "disc_nety_dropout": 0.0, "disc_prj_path": "x",
        "disc_prj_iprd": "instance", "loss_gan_coef": 0.004, "loss_netD": "bce",
        "loss_regl1_coef": 0.00001, "loss_mle_alpha": 0.0,
        "loss_recon_norm": "l1", "loss_recon_alpha": 0.0,
        "loss_recon_gamma": 0.0, "opt_netG": "adam", "opt_netG_lr": 0.002,
        "opt_netG_weight_decay": 0.0005, "opt_netD_lr": 0.002, "epochs": 3,
        "es_patience": 30, "es_warmup": 0, "es_verbose": False,
        "es_start_epoch": 0, "gen_updates": 1, "monitor_metrics": "loss",
        "times_test_sample": 1, "test": False, "test_wandb_prj": None,
        "test_path": "test", "test_load_path": str(root / name),
        "test_save_path": str(root / (name + "-test-{}-{}")),
        "test_mask_ratio": 0.0, "test_sampling_times": 1,
        "test_zero_noise": True, "batch_token_budget": 4096, "bucket_min": 256,
        "flash_min_len": 8, "precision": "f32", "device": "cpu",
    }
    cfg.update(over)
    return with_defaults(cfg)


def _arrays(args):
    return [a.detach().numpy().copy() if isinstance(a, torch.Tensor) else a for a in args]


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """op name -> (its recorded arguments as numpy, the weights' largest
    relative drift over training): two short trainings, the handler's
    adversarial step over the training split's shuffled batches (ESAT with
    the fused embedding and D's LN-pool tower; PatchGCN on the dense route),
    then one forward of G and D in train mode, dropout off, on the longest
    training batch."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # small steps: threads only contend with the other workers
    try:
        return _train_and_record(tmp_path_factory.mktemp("trained_ops"))
    finally:
        torch.set_num_threads(threads)


def _train_and_record(root):
    paths = make_synthetic_dataset(str(root / "data"), n_patients=36, dim=128, min_regions=8,
                                   max_regions=16, seed=9, feat_format="pt", with_graph=True)
    out = {}
    for name, over in (("esat", dict(use_fused_embedding=True)),
                       ("graph", dict(bcb_mode="graph", path_graph=paths["path_graph"],
                                      num_graph_layers=2, graph_banded="off"))):
        cfg = _cfg(paths, root, name, **over)
        check_configs(cfg, "adv")
        h = AdvHandler(cfg)
        nets = (h.gen_model, h.disc_model)
        w0 = [p.detach().clone() for m in nets for p in m.parameters() if p.dim() >= 2]
        batcher = h._make_bucket_batcher(
            prepare_dataset(read_datasplit_npz(cfg["data_split_path"].format(0))[0], cfg))
        for _ in range(cfg["epochs"]):
            for batch in batcher.prefetch(shuffle=True, rng=h.np_rng):
                h.train_step(h._ship(batch, train=True), h.train_rngs)
        drift = max(float((p.detach() - q).norm() / q.norm())
                    for p, q in zip((p for m in nets for p in m.parameters() if p.dim() >= 2),
                                    w0))
        b = h._ship(max(batcher.epoch_batches(), key=lambda b: b.feats.shape[1]), train=True)
        for m in nets:
            set_dropout_rates(m, 0.0)
            m.train()
        with recorded_calls(RECORDED) as calls, torch.no_grad():
            h.gen_model(b["feats"], b["mask"], b.get("extra"), zero_noise=True)
            h.disc_model(b["feats"], b["label"][:, :1], b["mask"])
        for op, cs in calls.items():
            if cs and op not in out:
                out[op] = (_arrays(cs[0][0]), dict(cs[0][1]), drift)
    return out


def _cotangent(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ln_relu_region_mean(args, kw):
    h, scale, bias = args
    g = _cotangent((h.shape[0] // 16, h.shape[1]), 1)
    with pltpu.force_tpu_interpret_mode():
        jout, vjp = jax.vjp(jlnp.ln_relu_region_mean, *(jnp.asarray(a) for a in (h, scale, bias)))
        jgrads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (h, scale, bias)]
    out = tlnp.ln_relu_region_mean(*leaves)
    out.backward(torch.from_numpy(g))
    return out, leaves, jout, jgrads, dict(atol=1e-5, rtol=1e-4), dict(atol=1e-5, rtol=1e-5)


def _masked_flash_attention(args, kw):
    q, k, v, mask = args
    assert kw.get("dropout_p", 0.0) == 0.0
    g = _cotangent(q.shape, 2)

    def jflash(q_, k_, v_):
        return jattn.masked_flash_attention(q_, k_, v_, jnp.asarray(mask), interpret=True)

    jout, vjp = jax.vjp(jflash, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tattn.masked_flash_attention(*leaves, torch.from_numpy(mask))
    out.backward(torch.from_numpy(g))
    return out, leaves, jout, jgrads, dict(atol=2e-5, rtol=0.0), dict(atol=1e-5, rtol=0.0)


def _fused_region_embedding(args, kw):
    x, w, b, scale, bias = args
    g = _cotangent((x.shape[0] // 16, w.shape[1]), 3)
    with pltpu.force_tpu_interpret_mode():
        jout, vjp = jax.vjp(jfe.fused_region_embedding, *(jnp.asarray(a) for a in args))
        jgrads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = tfe.fused_region_embedding(*leaves)
    out.backward(torch.from_numpy(g))
    return out, leaves, jout, jgrads, dict(atol=1e-5, rtol=1e-4), dict(atol=2e-4, rtol=1e-3)


def _fused_knn_softmax_aggregate(args, kw):
    msg, em, t = args
    epn, C = msg.shape[-2:]
    g = _cotangent(msg.shape[:-2] + (C,), 4)

    def jagg(m, tt):
        return jseg.fused_knn_softmax_aggregate(m, jnp.asarray(em.reshape(-1, epn)), tt, True)

    jout, vjp = jax.vjp(jax.jit(jagg), jnp.asarray(msg.reshape(-1, epn, C)),
                        jnp.asarray(t.reshape(())))
    jgrads = [a.reshape(s) for a, s in zip(vjp(jnp.asarray(g.reshape(-1, C))),
                                            (msg.shape, t.shape))]
    leaves = [torch.from_numpy(msg).requires_grad_(True), torch.from_numpy(t).requires_grad_(True)]
    out = tseg.fused_knn_softmax_aggregate(leaves[0], torch.from_numpy(em), leaves[1])
    out.backward(torch.from_numpy(g))
    # dt sums g alpha (m - out) m over every slot and channel: on trained
    # messages the sum is ill-conditioned (|terms| add to thousands of times
    # |dt|), so its bound is relative to the terms' absolute sum, at f32's eps
    m64, g64 = msg.astype(np.float64), g.astype(np.float64)
    logit = np.where(em[..., None] > 0, m64 * float(t.reshape(())), -np.inf)
    top = logit.max(axis=-2, keepdims=True)
    ex = np.exp(logit - np.where(np.isfinite(top), top, 0.0))
    alpha = ex / np.maximum(ex.sum(axis=-2, keepdims=True), 1e-16)
    out64 = (alpha * m64).sum(axis=-2, keepdims=True)
    dt_terms = float(np.abs(g64[..., None, :] * alpha * (m64 - out64) * m64).sum())
    return out, leaves, np.asarray(jout).reshape(out.shape), jgrads, \
        dict(atol=1e-5, rtol=0.0), [dict(atol=1e-5, rtol=1e-5),
                                    dict(atol=2.0 ** -23 * dt_terms, rtol=1e-5)]


CASES = {"ln_relu_region_mean": _ln_relu_region_mean,
         "masked_flash_attention": _masked_flash_attention,
         "fused_region_embedding": _fused_region_embedding,
         "fused_knn_softmax_aggregate": _fused_knn_softmax_aggregate}


@pytest.mark.parametrize("op", list(CASES))
def test_op_on_trained_inputs_matches_jax(recorded, op):
    """Values and every gradient of the op on the recorded trained inputs
    against the JAX package's Pallas op (interpret mode)."""
    assert op in recorded, f"{op} was not called on the trained forward"
    args, kw, drift = recorded[op]
    assert drift > 0.05, f"the weights moved by {drift:.3f} only: not a trained network"
    out, leaves, jout, jgrads, vtol, gtol = CASES[op](args, kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **vtol)
    gtols = gtol if isinstance(gtol, list) else [gtol] * len(leaves)
    for i, (leaf, want, tol) in enumerate(zip(leaves, jgrads, gtols)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), **tol,
                                   err_msg=f"{op}: gradient of argument {i}")
