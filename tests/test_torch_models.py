"""advmil_tpu_torch.models against advmil_tpu.models on the CPU in f32: the
same seeded numpy inputs and the same (bridged) weights, padded batches,
eval mode. Includes the transformer layer at the 2,048-region eval gate,
where the JAX side runs its Pallas flash kernel in interpret mode and the
port its flash op (plain version on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advmil_tpu.models import backbones as jbb
from advmil_tpu.models import gan as jgan
from advmil_tpu.models import layers as jl
from advmil_tpu.train.steps import _median_lower as j_median_lower
from advmil_tpu_torch.bridge import flax_to_torch
from advmil_tpu_torch.models import backbones as tbb
from advmil_tpu_torch.models import gan as tgan
from advmil_tpu_torch.models import layers as tl
from advmil_tpu_torch.train.steps import _median_lower as t_median_lower

ATOL, RTOL = 1e-5, 1e-4


def _np_params(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables["params"]))


def _load(module, params):
    module.load_state_dict(flax_to_torch(params))
    return module.eval()


def _bag(B, N, C, seed, lengths):
    """Padded patch batch: bag b has lengths[b] patches (whole regions)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = np.zeros((B, N), np.float32)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1.0
    return x * mask[..., None], mask


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("out_dim", [128, 48])   # LN-pool gate on / off
def test_avgpool_patch_embedding(out_dim):
    x, mask = _bag(3, 64, 40, seed=out_dim, lengths=[64, 32, 0])
    jm = jl.AvgPoolPatchEmbedding(40, out_dim)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                deterministic=True)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(mask), deterministic=True)
    tm = _load(tl.AvgPoolPatchEmbedding(40, out_dim), _np_params(v))
    _close(tm(torch.from_numpy(x), torch.from_numpy(mask)), want)


@pytest.mark.parametrize("L", [40, 2048])
def test_transformer_encoder_layer(L, monkeypatch):
    if L >= 2048:
        monkeypatch.setenv("ADVMIL_FLASH_INTERPRET", "1")
    D, H = 32, 2
    rng = np.random.default_rng(L)
    x = rng.normal(size=(2, L, D)).astype(np.float32)
    mask = np.ones((2, L), np.float32)
    mask[1, L // 2:] = 0.0
    x = x * mask[..., None]
    jm = jl.TransformerEncoderLayer(D, H, D, dropout=0.25)
    v = jm.init({"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                jnp.asarray(x), jnp.asarray(mask), deterministic=True)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(mask), deterministic=True)
    tm = _load(tl.TransformerEncoderLayer(D, H, D), _np_params(v))
    _close(tm(torch.from_numpy(x), torch.from_numpy(mask)), want)


def _esat_models(C=64, D=128):
    jbackbone = jbb.load_backbone("patch", [C, D, D])
    jG = jgan.Generator(backbone=jbackbone, dim_in=D, dim_out=1, noise=(0, 1),
                        hops=1, dropout=0.6, out_scale="sigmoid")
    tG = tgan.Generator(tbb.load_backbone("patch", [C, D, D]), D, 1, (0, 1))
    return jG, tG


def test_dual_trans_hs_backbone():
    x, mask = _bag(3, 96, 64, seed=5, lengths=[96, 48, 0])
    jm = jbb.load_backbone("patch", [64, 128, 128])
    v = jm.init({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
                jnp.asarray(x), jnp.asarray(mask), deterministic=True)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(mask), deterministic=True)
    tm = _load(tbb.load_backbone("patch", [64, 128, 128]), _np_params(v))
    _close(tm(torch.from_numpy(x), torch.from_numpy(mask)), want)


def test_generator_embed_and_head_zero_noise():
    x, mask = _bag(3, 80, 64, seed=6, lengths=[80, 16, 64])
    jG, tG = _esat_models()
    v = jG.init({"params": jax.random.PRNGKey(5), "noise": jax.random.PRNGKey(6),
                 "dropout": jax.random.PRNGKey(7)}, jnp.asarray(x),
                jnp.asarray(mask), zero_noise=True, deterministic=True)
    H = jG.apply(v, jnp.asarray(x), jnp.asarray(mask), deterministic=True,
                 method=jG.embed)
    y = jG.apply(v, H, zero_noise=True, deterministic=True, method=jG.head)
    _load(tG, _np_params(v))
    tH = tG.embed(torch.from_numpy(x), torch.from_numpy(mask))
    _close(tH, H)
    _close(tG.head(tH, zero_noise=True), y)


@pytest.mark.parametrize("iprd,prj", [("instance", "x"), ("bag", "y")])
def test_prj_discriminator(iprd, prj):
    x, mask = _bag(3, 64, 64, seed=7, lengths=[64, 48, 16])
    t = np.random.default_rng(8).uniform(size=(3, 1)).astype(np.float32)
    jm = jgan.PrjDiscriminator(64, 128, 1, (16, 128), prj_path=prj,
                               inner_product=iprd)
    v = jm.init({"params": jax.random.PRNGKey(9), "dropout": jax.random.PRNGKey(10)},
                jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask), deterministic=True)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask),
                    deterministic=True)
    tm = _load(tgan.PrjDiscriminator(64, 128, 1, (16, 128), prj_path=prj,
                                     inner_product=iprd), _np_params(v))
    _close(tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mask)), want)


def test_concat_discriminator():
    x, mask = _bag(2, 32, 64, seed=9, lengths=[32, 16])
    t = np.random.default_rng(10).uniform(size=(2, 1)).astype(np.float32)
    jm = jgan.Discriminator(64, 128, 1, (16, 128))
    v = jm.init({"params": jax.random.PRNGKey(11), "dropout": jax.random.PRNGKey(12)},
                jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask), deterministic=True)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask),
                    deterministic=True)
    tm = _load(tgan.Discriminator(64, 128, 1, (16, 128)), _np_params(v))
    _close(tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mask)), want)


@pytest.mark.parametrize("K", [30, 4])
def test_median_lower_matches_jax(K):
    a = np.random.default_rng(K).normal(size=(K, 5, 1)).astype(np.float32)
    want = np.asarray(j_median_lower(jnp.asarray(a), axis=0))
    got = t_median_lower(torch.from_numpy(a), dim=0).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.allclose(got, np.quantile(a, 0.5, axis=0))   # lower, not mean


def test_noise_head_draws_from_the_generator():
    torch.manual_seed(0)
    head = tl.init_parameters(tl.NoiseMLPHead(16, 1, (0, 1)), seed=0).eval()
    h = torch.randn(4, 16)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = head(h, zero_noise=False, generator=g1)
    assert torch.equal(a, head(h, zero_noise=False, generator=g2))
    assert not torch.equal(a, head(h, zero_noise=True))
