"""The cluster backbone slice of advmil_tpu_torch against advmil_tpu on the
CPU in f32: DeepAttnMISL (forward and every gradient from bridged weights,
a masked tail and an empty cluster; its init rule), the cluster batches
against the JAX batcher, `rank_loss`, `segment_mean`, and 2-epoch `exec`
runs of both handlers with `bcb_mode: cluster`.

As in tests/test_torch_ssl.py, the `exec` runs switch dropout and noise
off on both sides (JAX `mask_dropout` monkeypatched to the identity, port
`set_dropout_rates`, `gen_noi_noise: 0-0`) and start the port from the JAX
run's initial weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advmil_tpu import config as jconfig
from advmil_tpu import losses as jlosses
from advmil_tpu.data import bags as jbags
from advmil_tpu.models import backbones as jbb
from advmil_tpu.ops import segment as jseg
from advmil_tpu_torch import bridge
from advmil_tpu_torch import losses as tlosses
from advmil_tpu_torch.data import bags as tbags
from advmil_tpu_torch.models import backbones as tbb
from advmil_tpu_torch.models import layers as tl
from advmil_tpu_torch.ops import segment as tseg
from advmil_tpu_torch.train import baseline as tbaseline
from tests.test_torch_ssl import _run_both, _same_outputs, no_jax_dropout, synth  # noqa: F401

ATOL, RTOL = 1e-5, 1e-4
CLUSTER = {"bcb_mode": "cluster", "bcb_dims": "64-128-128"}


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, dict(params))


def _cluster_bag(seed=0, B=3, N=48, C=24):
    """Bag 0 full, bag 1 with a masked tail, bag 2 with cluster 5 empty and
    ids past the tail that must not count (the mask decides)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 30:] = 0.0
    cid = rng.integers(0, 8, size=(B, N)).astype(np.int32)
    cid[2][cid[2] == 5] = 6
    cid[1, 30:] = 7
    return x, mask, cid


@pytest.mark.parametrize("init", ["xavier", "pt041"])
def test_deepattnmisl_matches_flax_with_gradients(init):
    """Forward within 1e-5 and the gradients of sum(out * w) in x and in
    every parameter within 1e-5 + 1e-4 relative."""
    x, mask, cid = _cluster_bag()
    D = 16
    jm = jbb.load_backbone("cluster", [24, D, D], dense_init=init)
    v = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                jnp.asarray(x), jnp.asarray(mask), jnp.asarray(cid), deterministic=True)
    w = np.random.default_rng(1).normal(size=(3, D)).astype(np.float32)

    def jloss(params, xx):
        out = jm.apply({"params": params}, xx, jnp.asarray(mask), jnp.asarray(cid),
                       deterministic=True)
        return jnp.sum(out * w), out

    (_, want), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    tm = tbb.load_backbone("cluster", [24, D, D], dense_init=init)
    assert isinstance(tm, tbb.DeepAttnMISL)
    tm.load_state_dict(bridge.flax_to_torch(_np_tree(v["params"])))
    xt = torch.tensor(x, requires_grad=True)
    got = tm.eval()(xt, torch.from_numpy(mask), torch.from_numpy(cid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert np.ptp(got.detach().numpy(), axis=0).max() > 0
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=ATOL, rtol=RTOL)
    assert float(xt.grad[1, 30:].abs().max()) == 0.0          # the masked tail
    want_g = bridge.flax_to_torch(_np_tree(jgp))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@torch.no_grad()
def test_deepattnmisl_empty_cluster_joins_the_softmax():
    """Bag 2 has no patch in cluster 5: its pooled row is 0, its attention
    weight is softmax(gate(relu(attn_fc(0)))) > 0, as in JAX; the output
    equals the hand-computed pooling."""
    x, mask, cid = _cluster_bag(2)
    tm = tl.init_parameters(tbb.load_backbone("cluster", [24, 16, 16]), 3).eval()
    xt, mt, ct = torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(cid)
    phi = torch.relu(tm.phis(xt))
    rows = []
    for k in range(8):
        sel = ((ct == k) & (mt > 0)).float()
        rows.append((sel[..., None] * phi).sum(1) / sel.sum(1).clamp(min=1)[..., None])
    h = torch.relu(tm.attn_fc(torch.stack(rows, 1)))
    attn = torch.softmax(tm.gate(h)[..., 0], dim=-1)
    assert float(attn[2, 5]) > 0 and float(torch.stack(rows, 1)[2, 5].abs().max()) == 0
    torch.testing.assert_close(tm(xt, mt, ct), torch.einsum("bk,bkd->bd", attn, h))


@torch.no_grad()
def test_deepattnmisl_init_rule():
    """Under XAVIER `phis` keeps torch's default (U(+-1/sqrt(fan_in)), bias
    non-zero) while the rest is xavier (zero bias); under PT041 every Dense
    is U(+-0.5/sqrt(fan_in))."""
    m = tl.init_parameters(tbb.load_backbone("cluster", [400, 64, 64]), 0)
    assert m.phis.init == tl.TORCH and float(m.phis.bias.abs().max()) > 0
    assert float(m.phis.weight.abs().max()) <= 1 / 20 and float(m.phis.weight.std()) > 0.02
    assert float(m.attn_fc.bias.abs().max()) == 0 and m.attn_fc.init == tl.XAVIER
    m = tl.init_parameters(tbb.load_backbone("cluster", [400, 64, 64], dense_init=tl.PT041), 0)
    assert m.phis.init == m.attn_fc.init == tl.PT041
    assert float(m.phis.weight.abs().max()) <= 0.5 / 20


def test_cluster_batches_match_jax_batch_for_batch(synth):
    cfg = {"path_patch": synth["path_patch"], "path_label": synth["path_label"],
           "path_cluster": synth["path_cluster"], "bcb_mode": "cluster",
           "feat_format": "pt", "time_format": "ratio", "time_bins": 4, "test": False,
           "cache_bags": True}
    pids = synth["pids"]
    tds = tbags.prepare_dataset(pids, cfg, rng=np.random.default_rng(4))
    jds = jbags.prepare_dataset(pids, dict(cfg), rng=np.random.default_rng(4))
    kw = dict(token_budget=1024, max_batch=8, min_bucket=64)
    tb, jb = tbags.BucketBatcher(tds, **kw), jbags.BucketBatcher(jds, **kw)
    got = list(tb.prefetch(shuffle=True, rng=np.random.default_rng(5)))
    want = list(jb.prefetch(shuffle=True, rng=np.random.default_rng(5)))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        for a, b in zip([g.idx, g.feats, g.mask, g.label, g.sample_mask,
                         g.extra["cluster_id"]],
                        [w.idx, w.feats, w.mask, w.label, w.sample_mask,
                         w.extra["cluster_id"]]):
            np.testing.assert_array_equal(a, b)
        assert g.extra["cluster_id"].dtype == np.int32
        assert np.all((g.extra["cluster_id"] == -1) == (g.mask == 0))


@pytest.mark.parametrize("add_weight", [False, True], ids=["mean", "add_weight"])
@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_rank_loss_matches_jax(norm, add_weight):
    """Values and gradients within 1e-6 + 1e-5 relative; with every sample
    censored there is no comparable pair and both give exactly 0."""
    rng = np.random.default_rng(len(norm) + add_weight)
    pred = rng.normal(size=13).astype(np.float32)
    t = rng.uniform(1, 50, size=13).astype(np.float32)
    e = (rng.uniform(size=13) > 0.4).astype(np.float32)
    for ee in (e, np.zeros_like(e)):
        kw = dict(gamma=0.7, norm=norm, add_weight=add_weight)
        want, jg = jax.value_and_grad(
            lambda p: jlosses.rank_loss(p, jnp.asarray(t), jnp.asarray(ee), **kw))(
                jnp.asarray(pred))
        pt = torch.tensor(pred, requires_grad=True)
        got = tlosses.rank_loss(pt, torch.from_numpy(t), torch.from_numpy(ee), **kw)
        got.backward()
        got = got.item()
        np.testing.assert_allclose(got, float(want), atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-5)
        if not ee.any():
            assert got == float(want) == 0.0
        else:
            assert got > 0


def test_segment_mean_matches_jax():
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(40, 6)).astype(np.float32)
    seg = rng.integers(0, 5, size=40).astype(np.int32)
    seg[seg == 3] = 4                                  # segment 3 empty
    mask = (rng.uniform(size=40) > 0.3).astype(np.float32)
    want = jseg.segment_mean(jnp.asarray(vals), jnp.asarray(seg), jnp.asarray(mask), 5)
    got = tseg.segment_mean(torch.from_numpy(vals), torch.from_numpy(seg),
                            torch.from_numpy(mask), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    assert float(got[3].abs().max()) == 0.0


def test_adv_cluster_exec_matches_jax(synth, tmp_path, monkeypatch,  # noqa: F811
                                      no_jax_dropout):
    """G on DeepAttnMISL (D's X tower the patch embedding, as in JAX), 2
    epochs: CSVs within 1e-4, C-indices within 1e-4."""
    jh, jm, th, tm = _run_both(synth, tmp_path, monkeypatch, "exec",
                               path_cluster=synth["path_cluster"], **CLUSTER)
    assert isinstance(th.gen_model.backbone, tbb.DeepAttnMISL)
    _same_outputs(jm, tm, tmp_path, "train", "best", ("train", "validation", "test"))


def test_base_cluster_exec_matches_jax(synth, tmp_path, monkeypatch,  # noqa: F811
                                       no_jax_dropout):
    """SurvNet on DeepAttnMISL, surv_nll (run_parity.cluster_cfg's task), 2
    epochs through the port's CLI: C-indices within 1e-4, predicted risks
    within 1e-4."""
    from advmil_tpu.train.baseline import BaselineHandler as JaxHandler
    from advmil_tpu_torch.main import main as port_main
    from tests.test_torch_baseline import _cfg, _write_yaml
    over = dict(CLUSTER, bcb_dims="64-64-64", task="surv_nll", pdh_dims="64-4")
    jh = JaxHandler(jconfig.with_defaults(_cfg(synth, tmp_path, "jax", rng_impl="threefry",
                                               **over)))
    init = bridge.flax_to_torch(_np_tree(jh.params))
    jm = jh.exec()

    def from_jax_init(model, seed):
        model.load_state_dict(init)
        return tl.set_dropout_rates(model, 0.0)

    monkeypatch.setattr(tbaseline, "init_parameters", from_jax_init)
    yaml_path = str(tmp_path / "port.yaml")
    _write_yaml(yaml_path, _cfg(synth, tmp_path, "port", device="cpu", **over))
    [(th, tm)] = port_main(["--config", yaml_path, "--handler", "base"])
    assert isinstance(th.model.backbone, tbb.DeepAttnMISL)
    for split in ("train", "validation", "test"):
        assert abs(dict(tm[split])["cindex"] - dict(jm[split])["cindex"]) <= 1e-4, split
    _same_outputs(None, None, tmp_path, "train", "best", ("validation", "test"))
