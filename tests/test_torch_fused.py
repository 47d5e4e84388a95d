"""The fused-embedding slice of advmil_tpu_torch against advmil_tpu on the
CPU in f32: the fused Dense+LN+ReLU+pool op and the plain LN+ReLU op (values
and gradients against the Pallas kernels in interpret mode), the positional
embedding, the patch-embedding family inside ESAT and the discriminator
(forward and every gradient against flax through the bridge), the region
coordinates' data path, and a 2-epoch `exec` plus `exec_test` with
`use_fused_embedding` and `use_coords_pe` against the JAX handler.

On the CPU the JAX layer takes its plain branch (`models/layers.py`: Dense,
LayerNorm, ReLU, masked mean) unless `pallas_available` is patched, and the
port's ops take their plain versions; both are the same function on bags
padded in whole regions.
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

from advmil_tpu.config import with_defaults as j_with_defaults
from advmil_tpu.data import bags as jbags
from advmil_tpu.models import backbones as jbb
from advmil_tpu.models import gan as jgan
from advmil_tpu.models import layers as jlayers
from advmil_tpu.ops import attention as jattn
from advmil_tpu.ops import fused_embed as jfe
from advmil_tpu.ops import ln_pool as jlnp
from advmil_tpu.ops import pe as jpe
from advmil_tpu_torch import bridge
from advmil_tpu_torch.config import with_defaults
from advmil_tpu_torch.data import bags as tbags
from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
from advmil_tpu_torch.models import backbones as tbb
from advmil_tpu_torch.models import gan as tgan
from advmil_tpu_torch.models import layers as tl
from advmil_tpu_torch.ops import fused_embed as tfe
from advmil_tpu_torch.ops import ln_pool as tlnp
from advmil_tpu_torch.ops import pe as tpe
from advmil_tpu_torch.train import handler as thandler
from advmil_tpu_torch.utils import io as tio

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


# ---------------------------------------------------------------------------
# the ops against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _embed_inputs(M, K, D, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[-16:] = 0.0                                   # a fully padded region
    w = (rng.normal(size=(K, D)) / np.sqrt(K)).astype(np.float32)
    b = rng.normal(0, 0.1, size=(D,)).astype(np.float32)
    scale = (1.0 + rng.normal(0, 0.1, size=(D,))).astype(np.float32)
    bias = rng.normal(0, 0.1, size=(D,)).astype(np.float32)
    g = rng.normal(size=(M // 16, D)).astype(np.float32)
    g[-1] = 0.0                                     # its cotangent, as the region mask makes it
    return x, w, b, scale, bias, g


@pytest.mark.parametrize("M", [256, 256 + 64, 48])   # one TPU block, ragged, tiny
def test_fused_region_embedding_matches_jax(M):
    """Values and all five gradients (autograd through the plain version, and
    the written-out backward) against the Pallas forward and VJP; atol 2e-4 /
    rtol 1e-3, the JAX package's own bound for this op's sums over M."""
    K = D = 128
    arrs = _embed_inputs(M, K, D, seed=M)
    *ins, g = arrs
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(jfe.fused_region_embedding, *(jnp.asarray(a) for a in ins))
        want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    got_out = tfe.fused_region_embedding(*leaves)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-4)
    got_out.backward(torch.from_numpy(g))
    explicit = tfe.fused_region_embedding_bwd_plain(
        torch.from_numpy(g), *(torch.from_numpy(a) for a in ins))
    for name, leaf, ex, w in zip(("dx", "dw", "db", "dscale", "dbias"), leaves, explicit, want):
        assert np.all(np.isfinite(w)), name
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=2e-4, rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(ex.numpy(), w, atol=2e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dx_from_its_own_dh_matches_jax(dtype):
    """`fused_region_embedding_bwd_dx_plain` (the oracle the card holds the dx
    kernel to) on the plain dh, rounded to x's dtype as the Pallas kernel
    rounds it, against the dx of the Pallas VJP: in f32 within this file's
    bound for the op's gradients, in bf16 within one bf16 ulp (`dx_tol`: 2^-7
    relative + 2^-8 of the largest |dx| where the sum cancels)."""
    M, K, D = 80, 128, 128
    x, w, b, scale, bias, g = _embed_inputs(M, K, D, seed=7)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jfe.fused_region_embedding, jnp.asarray(x).astype(jdt),
                         *(jnp.asarray(a) for a in (w, b, scale, bias)))
        want = torch.from_numpy(np.array(vjp(jnp.asarray(g).astype(jdt))[0].astype(jnp.float32)))
    tx, tw, tb, tsc, tbi, tg = (torch.from_numpy(a) for a in (x, w, b, scale, bias, g))
    tx, tg = tx.to(dtype), tg.to(dtype).float()       # the cotangent arrives in x's dtype
    dh, _, _ = tfe.fused_region_embedding_dh_plain(tg, tx, tw, tb, tsc, tbi)
    got = tfe.fused_region_embedding_bwd_dx_plain(dh.to(dtype), tw)
    assert got.dtype == dtype and bool((got[-16:] == 0).all())      # zero cotangent: exactly 0
    tol = dict(atol=2e-4, rtol=1e-3) if dtype == torch.float32 else tfe.dx_tol(want)
    torch.testing.assert_close(got.float(), want, **tol)
    assert torch.equal(got, tfe.fused_region_embedding_bwd_plain(tg, tx, tw, tb, tsc, tbi)[0])


def _share(got, want, atol, rtol):
    """The largest |got - want| as a share of atol + rtol |want| (1: at the bound)."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _plain_with_wide_variance(x, w, b, scale, bias, extra):
    """The forward with `extra` zero columns beyond D let into the variance
    (h there is 0; the mean still divides by D): the fault the bf16 row
    kernel's per-tile column test keeps out."""
    M, D = x.shape[0], w.shape[1]
    h = x.float() @ w.to(x.dtype).float() + b
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True) + extra * mu ** 2 / D
    y = torch.relu((h - mu) * torch.rsqrt(var + tlnp.LN_EPS) * scale + bias)
    return y.reshape(M // 16, 16, -1).mean(dim=1).to(x.dtype)


@pytest.mark.parametrize("bound", ["fwd_tol", "dh_tol", "dw_tol"])
def test_tight_bounds_hold_right_versions_and_catch_mutants(bound):
    """The bounds the card holds the bf16 row kernel (#9, dh of #11) and the
    dW product to. A right version stays inside: the JAX Pallas forward
    (interpret mode) against the plain forward; dh and dW = x^T dh formed in
    f64 and rounded as the kernels round, against the f32 plain versions. Each
    mutant of the card's `--mutants` falls outside: a 64-wide K chunk dropped
    for one 128-row tile (forward and dh), 8 zero columns beyond D in the
    variance at D = 96 with rows of mean 0.5 (which the plain bounds, 2e-2 +
    2e-2 relative, let pass), and 64 rows of M left out of dW. Compared on the
    real regions (the padded one's rows have the variance of b alone, which the
    variance mutant changes many times over), with the cotangent zeroed where a
    ReLU input lies within 2e-5 of 0 (a rounding flips the mask there)."""
    M, K, D = 512, 256, 96
    x, w, b, scale, bias, g = _embed_inputs(M, K, D, seed=11)
    b = b + 0.5                                          # rows of mean ~0.5
    tx, tw, tb, tsc, tbi, tg = (torch.from_numpy(a) for a in (x, w, b, scale, bias, g))
    h = tx.bfloat16().float() @ tw.bfloat16().float() + tb
    mu, var = h.mean(-1, keepdim=True), h.var(-1, unbiased=False, keepdim=True)
    near = (((h - mu) * torch.rsqrt(var + tlnp.LN_EPS) * tsc + tbi).abs() < 2e-5).any(dim=1)
    tg = tg * (~near.reshape(-1, 16).any(dim=1))[:, None]
    tx = tx.bfloat16()
    x_drop = tx.clone()
    x_drop[128:256, 64:128] = 0
    if bound == "fwd_tol":
        with pltpu.force_tpu_interpret_mode():
            jout = jfe.fused_region_embedding(jnp.asarray(x).astype(jnp.bfloat16),
                                              *(jnp.asarray(a) for a in (w, b, scale, bias)))
        want = tfe.fused_region_embedding_plain(tx, tw, tb, tsc, tbi)[:-1]
        right = torch.from_numpy(np.array(jout.astype(jnp.float32)))[:-1]
        wide = _plain_with_wide_variance(tx, tw, tb, tsc, tbi, 8)[:-1]
        assert _share(wide, want, 2e-2, 2e-2) <= 1.0      # the plain bound lets it pass
        mutants = [tfe.fused_region_embedding_plain(x_drop, tw, tb, tsc, tbi)[:-1], wide]
    elif bound == "dh_tol":
        dh = tfe.fused_region_embedding_dh_plain(tg, tx, tw, tb, tsc, tbi)[0]
        want = dh.bfloat16()
        right = tfe.fused_region_embedding_dh_plain(tg.double(), tx.double(),
                                                    tw.bfloat16().double(),
                                                    tb.double(), tsc.double(),
                                                    tbi.double())[0].bfloat16()
        mutants = [tfe.fused_region_embedding_dh_plain(tg, x_drop, tw, tb, tsc, tbi)[0].bfloat16()]
    else:
        dh = tfe.fused_region_embedding_dh_plain(tg, tx, tw, tb, tsc, tbi)[0].bfloat16()
        want = tx.float().t() @ dh.float()
        right = (tx.double().t() @ dh.double()).float()
        mutants = [tx[64:].float().t() @ dh[64:].float()]
    tol = getattr(tfe, bound)(want)
    assert _share(right, want, **tol) <= 0.5
    for mutant in mutants:
        assert _share(mutant, want, **tol) > 1.5


def test_fused_region_embedding_bf16_keeps_h_in_f32():
    """In bf16 the op rounds x and W only: it equals the f32 op on the rounded
    inputs up to the output's own rounding, which the unfused layer (Dense's
    output rounded before the LayerNorm) does not."""
    x, w, b, scale, bias, _ = (torch.from_numpy(a) for a in _embed_inputs(64, 128, 128, 1))
    got = tfe.fused_region_embedding(x.bfloat16(), w, b, scale, bias)
    assert got.dtype == torch.bfloat16
    want = tfe.fused_region_embedding(x.bfloat16().float(), w.bfloat16().float(), b, scale, bias)
    torch.testing.assert_close(got.float(), want.bfloat16().float(), atol=0.0, rtol=0.0)


@pytest.mark.parametrize("M,D", [(512, 128), (552, 256), (37, 128)])
def test_ln_relu_matches_jax(M, D):
    rng = np.random.default_rng(M + D)
    h = rng.normal(size=(M, D)).astype(np.float32)
    scale = (1.0 + rng.normal(0, 0.1, size=(D,))).astype(np.float32)
    bias = rng.normal(0, 0.1, size=(D,)).astype(np.float32)
    g = rng.normal(size=(M, D)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(jlnp.ln_relu, jnp.asarray(h), jnp.asarray(scale), jnp.asarray(bias))
        want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (h, scale, bias)]
    got = tlnp.ln_relu(*leaves)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    got.backward(torch.from_numpy(g))
    for name, leaf, w in zip(("dh", "dscale", "dbias"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=1e-5, rtol=1e-5, err_msg=name)
    assert tlnp.ln_relu(leaves[0].detach().bfloat16(), *leaves[1:]).dtype == torch.bfloat16


@pytest.mark.parametrize("ndim,step", [(384, 1), (32, 1), (64, 3)])
def test_compute_pe_matches_jax(ndim, step):
    rng = np.random.default_rng(ndim)
    coord = rng.integers(-5, 60, size=(3, 21, 2)).astype(np.float32)
    want = np.asarray(jpe.compute_pe(jnp.asarray(coord), ndim=ndim, step=step))
    got = tpe.compute_pe(torch.from_numpy(coord), ndim=ndim, step=step)
    assert got.shape == (3, 21, ndim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        tpe.posemb_sincos_2d(torch.zeros(2), torch.zeros(2), 30)


# ---------------------------------------------------------------------------
# the patch-embedding family against flax, forward and every gradient
# ---------------------------------------------------------------------------

def _bag(B, N, C, seed, lengths):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = np.zeros((B, N), np.float32)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1.0
    coords = rng.integers(0, 40, size=(B, N // 16, 2)).astype(np.float32)
    return x * mask[..., None], mask, coords


def _compare_with_flax(jmodel, tmodel, jargs, targs, seed):
    """Same bridged weights, same inputs: the outputs and the gradient of
    sum(out * cot) with respect to every parameter agree within 1e-5."""
    rngs = {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)}
    variables = jmodel.init(rngs, *jargs, deterministic=True)
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    want = jmodel.apply({"params": params}, *jargs, deterministic=True)
    cot = np.random.default_rng(seed).normal(size=want.shape).astype(np.float32)

    def loss(p):
        return jnp.sum(jmodel.apply({"params": p}, *jargs, deterministic=True) * cot)

    jgrads = bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params)))
    tmodel.load_state_dict(bridge.flax_to_torch(params))          # strict
    tmodel.eval()
    got = tmodel(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    (got * torch.from_numpy(cot)).sum().backward()
    tgrads = dict(tmodel.named_parameters())
    assert set(tgrads) == set(jgrads)
    for k, w in jgrads.items():
        assert tgrads[k].grad is not None, k
        np.testing.assert_allclose(tgrads[k].grad.numpy(), w.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    # the bridge round trip is exact for this tree (conv kernels, `pool` subtree)
    back = bridge.torch_to_flax(tmodel.state_dict())
    flat_b, flat_w = jax.tree_util.tree_leaves_with_path(back), \
        jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in flat_b] == [p for p, _ in flat_w]
    for (_, a), (_, b) in zip(flat_b, flat_w):
        np.testing.assert_array_equal(a, b)
    return params


@pytest.mark.parametrize("case", ["fused", "fused_pallas", "coords", "ksize3", "gapool",
                                  "gapool_ksize3"])
def test_esat_patch_embedding_family_matches_flax(case, monkeypatch):
    dims = [64, 128, 128] if case == "fused_pallas" else [64, 32, 32]
    x, mask, coords = _bag(3, 96, 64, seed=len(case), lengths=[96, 48, 0])
    kw = {"fused": dict(use_fused_embed=True), "fused_pallas": dict(use_fused_embed=True),
          "coords": dict(use_fused_embed=True), "ksize3": dict(emb_ksize=3),
          "gapool": dict(emb_backbone="gapool"),
          "gapool_ksize3": dict(emb_backbone="gapool", emb_ksize=3)}[case]
    jm = jbb.DualTransHS(dims, **kw)
    tm = tbb.DualTransHS(dims, **kw)
    extra = (coords,) if case == "coords" else ()
    jargs = (jnp.asarray(x), jnp.asarray(mask)) + tuple(jnp.asarray(e) for e in extra)
    targs = (torch.from_numpy(x), torch.from_numpy(mask)) + tuple(torch.from_numpy(e)
                                                                  for e in extra)
    if case == "fused_pallas":
        # the JAX layer's kernel branch, as its own tests reach it on the CPU
        monkeypatch.setattr(jattn, "pallas_available", lambda: True)
        with pltpu.force_tpu_interpret_mode():
            params = _compare_with_flax(jm, tm, jargs, targs, seed=3)
    else:
        params = _compare_with_flax(jm, tm, jargs, targs, seed=3)
    emb = params["patch_embedding"]
    assert ("Conv_0" in emb) == ("ksize3" in case) and ("pool" in emb) == ("gapool" in case)
    if case == "coords":                     # the coordinates change the output
        assert not torch.allclose(tm(*targs), tm(*targs[:2]))


@pytest.mark.parametrize("ksize,backbone", [(3, "avgpool"), (1, "gapool"), (3, "gapool")])
def test_discriminator_netx_options_match_flax(ksize, backbone):
    x, mask, _ = _bag(3, 64, 64, seed=7, lengths=[64, 48, 16])
    t = np.random.default_rng(8).uniform(size=(3, 1)).astype(np.float32)
    jm = jgan.PrjDiscriminator(64, 32, 1, (16, 32), prj_path="x", inner_product="instance",
                               netx_ksize=ksize, netx_backbone=backbone)
    tm = tgan.PrjDiscriminator(64, 32, 1, (16, 32), prj_path="x", inner_product="instance",
                               netx_ksize=ksize, netx_backbone=backbone)
    _compare_with_flax(jm, tm, (jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask)),
                       (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mask)), seed=5)
    with pytest.raises(NotImplementedError):
        tl.make_embedding_layer("maxpool", 64, 32)


# ---------------------------------------------------------------------------
# region coordinates: files, dataset, batcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """36 patients of 4-16 regions: one 256-patch bucket, so each JAX step
    compiles once."""
    root = str(tmp_path_factory.mktemp("fused_data"))
    return make_synthetic_dataset(root, n_patients=36, dim=64, min_regions=4,
                                  max_regions=16, seed=5, feat_format="pt")


def test_region_coords_reach_the_batch_as_in_jax(synth, tmp_path):
    pids = synth["pids"][:9]
    cfg = {"path_patch": synth["path_patch"], "path_label": synth["path_label"],
           "bcb_mode": "patch", "feat_format": "pt", "time_format": "ratio", "time_bins": 4,
           "path_coordx5": synth["path_coordx5"], "use_coords_pe": True}
    tds = tbags.prepare_dataset(pids, cfg)
    jds = jbags.prepare_dataset(pids, cfg)
    tb = list(tbags.BucketBatcher(tds, token_budget=1024, min_bucket=64).epoch_batches())
    jb = list(jbags.BucketBatcher(jds, token_budget=1024, min_bucket=64).epoch_batches())
    assert len(tb) == len(jb) > 1
    for a, b in zip(tb, jb):
        assert a.extra["coords"].shape == (a.feats.shape[0], a.feats.shape[1] // 16, 2)
        np.testing.assert_array_equal(a.extra["coords"], b.extra["coords"])
    assert "coords" not in tbags.prepare_dataset(pids, dict(cfg, use_coords_pe=False))[0]
    # .npy reads like .npz; .h5 names what it would need
    c = tio.read_patch_coord(osp.join(synth["path_coordx5"], "S0000.npz"))
    np.save(str(tmp_path / "c.npy"), c)
    np.testing.assert_array_equal(tio.read_patch_coord(str(tmp_path / "c.npy")), c)
    with pytest.raises(NotImplementedError, match="h5py"):
        tio.read_patch_coord(str(tmp_path / "c.h5"))
    with pytest.raises(ValueError):
        tio.read_patch_coord(str(tmp_path / "c.txt"))


# ---------------------------------------------------------------------------
# exec and exec_test with use_fused_embedding against the JAX handler
# ---------------------------------------------------------------------------

def _cfg(paths, tmp_path, name, **over):
    cfg = {
        "task": "cont_gansurv", "seed": 42, "save_path": str(tmp_path / name),
        "dataset": "synthetic", "path_patch": paths["path_patch"],
        "path_label": paths["path_label"], "path_coordx5": paths["path_coordx5"],
        "feat_format": "pt", "time_format": "ratio", "time_bins": 4,
        "data_split_path": paths["data_split_path"], "data_split_seed": 0,
        "save_prediction": True, "bcb_mode": "patch", "bcb_dims": "64-32-32",
        "gen_dims": "32-1", "gen_noi_noise": "0-0",
        "gen_noi_noise_dist": "uniform", "gen_noi_hops": 1, "gen_norm": False,
        "gen_dropout": 0.6, "gen_out_scale": "sigmoid", "disc_type": "prj",
        "disc_netx_in_dim": 64, "disc_netx_out_dim": 32, "disc_netx_ksize": 1,
        "disc_netx_backbone": "avgpool", "disc_netx_dropout": 0.25,
        "disc_nety_in_dim": 1, "disc_nety_hid_dims": "16-32",
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
        "precision": "f32", "use_fused_embedding": True, "use_coords_pe": True,
    }
    cfg.update(over)
    return cfg


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


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


def test_exec_and_exec_test_with_fused_embedding_match_jax(synth, tmp_path, monkeypatch):
    """A 2-epoch `exec`, then test mode from its best checkpoint, on both
    packages from the same initial weights with dropout and noise off:
    prediction CSVs and C-indices within 1e-4."""
    from advmil_tpu.train.handler import AdvHandler as JaxHandler
    from advmil_tpu_torch.main import main as port_main

    monkeypatch.setattr(jlayers, "mask_dropout", lambda rng, rate, x: x)
    jh = JaxHandler(j_with_defaults(_cfg(synth, tmp_path, "jax", rng_impl="threefry")))
    assert jh.gen_model.backbone.use_fused_embed
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
    assert th.gen_model.backbone.patch_embedding.use_fused
    assert not th.disc_model.net_pair_one.embedding.use_fused       # D keeps LN-pool
    batch = next(iter(th.loaders["train"][1].epoch_batches()))
    assert th._ship(batch)["extra"].shape == (batch.feats.shape[0], batch.feats.shape[1] // 16, 2)

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for split in ("train", "validation", "test"):
        name = f"train_best_pred_{split}.csv"
        jp, tp = _read_pred(osp.join(jdir, name)), _read_pred(osp.join(tdir, name))
        assert sorted(tp) == sorted(jp) and len(tp) > 0
        assert np.ptp(list(tp.values())) > 0
        np.testing.assert_allclose([tp[k] for k in sorted(jp)],
                                   [jp[k] for k in sorted(jp)], atol=1e-4, err_msg=split)
        assert abs(dict(tm[split])["cindex"] - dict(jm[split])["cindex"]) <= 1e-4

    # test mode: each package loads its own best checkpoint
    jt = JaxHandler(j_with_defaults(_cfg(synth, tmp_path, "jax", rng_impl="threefry",
                                         test=True))).exec_test()
    _write_yaml(yaml_path, _cfg(synth, tmp_path, "port", device="cpu", test=True))
    [(th2, tt)] = port_main(["--config", yaml_path, "--handler", "adv"])
    name = "test_mode_best_pred_exec-test.csv"
    jp = _read_pred(osp.join(str(tmp_path / "jax-test-0.8-0"), name))
    tp = _read_pred(osp.join(th2.save_dir, name))
    assert sorted(tp) == sorted(jp) and len(tp) > 0
    np.testing.assert_allclose([tp[k] for k in sorted(jp)], [jp[k] for k in sorted(jp)],
                               atol=1e-4)
    assert abs(dict(tt["exec-test"])["cindex"] - dict(jt["exec-test"])["cindex"]) <= 1e-4


def test_fused_slice_imports_no_jax():
    code = ("import sys\n"
            "import advmil_tpu_torch.ops.fused_embed, advmil_tpu_torch.ops.pe\n"
            "import advmil_tpu_torch.ops.ln_pool, advmil_tpu_torch.models.layers\n"
            "import advmil_tpu_torch.models.backbones, advmil_tpu_torch.models.gan\n"
            "import advmil_tpu_torch.data.bags, advmil_tpu_torch.train.handler\n"
            "print('BAD', sorted(k for k in sys.modules if k.split('.')[0] in\n"
            "      ('jax', 'jaxlib', 'flax', 'optax', 'advmil_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
