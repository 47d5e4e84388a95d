"""advmil_tpu_torch.ops against advmil_tpu.ops: the plain versions of the two
ported kernels and the masked reductions, on the same seeded numpy inputs in
f32. The JAX side runs its Pallas kernels in interpret mode on the CPU, as
the JAX package's own tests do. The CUDA kernels themselves are held
against these plain versions on the card in test_torch_kernels.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from advmil_tpu.ops import attention as jattn
from advmil_tpu.ops import ln_pool as jlnp
from advmil_tpu.ops import masked as jmasked
from advmil_tpu_torch.ops import _build
from advmil_tpu_torch.ops import attention as tattn
from advmil_tpu_torch.ops import ln_pool as tlnp
from advmil_tpu_torch.ops import masked as tmasked


def _ln_inputs(M, D, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(M, D)).astype(np.float32)
    scale = (1.0 + rng.normal(0, 0.1, size=(D,))).astype(np.float32)
    bias = rng.normal(0, 0.1, size=(D,)).astype(np.float32)
    return h, scale, bias


@pytest.mark.parametrize("M,D", [(256, 128), (jlnp.BLK_ROWS + 48, 128),
                                 (512, 384), (jlnp.BLK_ROWS + 64, 384)])
def test_ln_relu_region_mean_matches_jax(M, D):
    h, scale, bias = _ln_inputs(M, D, seed=M + D)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jlnp.ln_relu_region_mean(
            jnp.asarray(h), jnp.asarray(scale), jnp.asarray(bias)))
    got = tlnp.ln_relu_region_mean(torch.from_numpy(h), torch.from_numpy(scale),
                                   torch.from_numpy(bias))
    assert got.shape == (M // 16, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


def test_ln_relu_region_mean_cpu_takes_plain_version():
    h, scale, bias = _ln_inputs(64, 128, seed=3)
    before = tlnp.LAUNCHES
    got = tlnp.ln_relu_region_mean(torch.from_numpy(h), torch.from_numpy(scale),
                                   torch.from_numpy(bias))
    want = tlnp.ln_relu_region_mean_plain(torch.from_numpy(h),
                                          torch.from_numpy(scale),
                                          torch.from_numpy(bias))
    assert torch.equal(got, want)
    assert tlnp.LAUNCHES == before          # the counter counts kernel launches
    with pytest.raises(ValueError):
        tlnp.ln_relu_region_mean(torch.empty(32, 128, device="meta"),
                                 torch.empty(128, device="meta"),
                                 torch.empty(128, device="meta"))


def _share(got, want, atol, rtol):
    """The largest |got - want| as a share of atol + rtol |want| (1: at the bound)."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _ln_pool_dh(g, h, scale, bias, m2_every=0):
    """dh of the LN-pool backward by its formula, in the dtype of the inputs;
    with `m2_every`, the xhat * mean(gx * xhat) term is dropped at every
    m2_every-th column (the card's structural mutant)."""
    mu = h.mean(-1, keepdim=True)
    inv = torch.rsqrt(((h - mu) ** 2).mean(-1, keepdim=True) + tlnp.LN_EPS)
    xh = (h - mu) * inv
    gr = (g / tlnp.S2).repeat_interleave(tlnp.S2, dim=0)
    gx = torch.where(xh * scale + bias > 0, gr, torch.zeros_like(gr)) * scale
    m1 = gx.mean(-1, keepdim=True)
    m2 = (gx * xh).mean(-1, keepdim=True)
    keep = torch.ones(h.shape[1], dtype=h.dtype)
    if m2_every:
        keep[::m2_every] = 0
    return inv * (gx - m1 - xh * m2 * keep)


@pytest.mark.parametrize("D", [128, 384])
def test_bwd_tol_holds_a_right_dh_and_catches_a_dropped_m2_term(D):
    """`ln_pool.bwd_tol`, the bound the card holds the bf16 backward kernel's
    dh to: dh by its formula in f64, rounded once to bf16, stays inside it
    against the plain version's autograd dh on the same bf16 h and g; the
    mutant of the card's `--mutants` (the m2 term dropped at one column in 16)
    falls outside, while the plain bound (2e-2 + 2e-2 relative) lets it pass.
    The cotangent has a training-like scale (0.25) and is zeroed for regions
    with a ReLU input within 2e-5 of 0, where a rounding may flip the mask."""
    h, scale, bias = (torch.from_numpy(a) for a in _ln_inputs(512, D, seed=D + 5))
    h = h.bfloat16()
    g = 0.25 * torch.from_numpy(np.random.default_rng(D).normal(size=(512 // 16, D)))
    xh = (h.float() - h.float().mean(-1, keepdim=True)) * torch.rsqrt(
        h.float().var(-1, unbiased=False, keepdim=True) + tlnp.LN_EPS)
    near = ((xh * scale + bias).abs() < 2e-5).any(dim=1).reshape(-1, 16).any(dim=1)
    g = (g * (~near)[:, None]).bfloat16()
    leaves = [t.clone().requires_grad_(True) for t in (h, scale, bias)]
    want = torch.autograd.grad(tlnp.ln_relu_region_mean_plain(*leaves), leaves, g)[0]
    assert want.dtype == torch.bfloat16
    tol = tlnp.bwd_tol(want)
    right = _ln_pool_dh(g.double(), h.double(), scale.double(), bias.double()).bfloat16()
    assert _share(right, want, **tol) <= 0.5
    mutant = _ln_pool_dh(g.float(), h.float(), scale, bias, m2_every=16).bfloat16()
    assert _share(mutant, want, 2e-2, 2e-2) <= 1.0
    assert _share(mutant, want, **tol) > 1.5


def _attn_inputs(B, L, H, Dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, L, H, Dh)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, L), np.float32)
    mask[0, L - 37:] = 0.0                  # ragged bag
    if B > 2:
        mask[2] = 0.0                       # fully masked (dummy) bag
    return q, k, v, mask


@pytest.mark.parametrize("B,L,H,Dh", [(3, 300, 2, 16), (2, 130, 4, 48)])
def test_flash_plain_matches_jax_flash(B, L, H, Dh):
    q, k, v, mask = _attn_inputs(B, L, H, Dh, seed=L)
    want = np.asarray(jattn.masked_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        interpret=True))
    got = tattn.masked_flash_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    if B > 2:
        assert np.all(got.numpy()[2] == 0.0)


def test_flash_reference_matches_jax_reference():
    q, k, v, mask = _attn_inputs(3, 40, 2, 8, seed=5)
    want = np.asarray(jattn.masked_attention_reference(
        *(jnp.asarray(a) for a in (q, k, v, mask))))
    got = tattn.masked_attention_reference(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def test_flash_dropout_is_not_ported():
    """Attention dropout is ported now (tests/test_torch_train.py); what stays
    refused is dropout without a seed for its Philox stream, or at p >= 1."""
    q, k, v, mask = (torch.from_numpy(a) for a in _attn_inputs(1, 8, 1, 8, seed=1))
    with pytest.raises(ValueError, match="seed"):
        tattn.masked_flash_attention(q, k, v, mask, dropout_p=0.1)
    with pytest.raises(ValueError, match="< 1"):
        tattn.masked_flash_attention(q, k, v, mask, dropout_p=1.0, seed=3)
    out = tattn.masked_flash_attention(q, k, v, mask, dropout_p=0.1, seed=3)
    assert out.shape == q.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("fully_masked", [False, True])
def test_masked_softmax_matches_jax(fully_masked):
    rng = np.random.default_rng(7)
    s = rng.normal(size=(3, 20)).astype(np.float32)
    m = (rng.uniform(size=(3, 20)) > 0.3).astype(np.float32)
    if fully_masked:
        m[1] = 0.0
    want = np.asarray(jmasked.masked_softmax(jnp.asarray(s), jnp.asarray(m)))
    got = tmasked.masked_softmax(torch.from_numpy(s), torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)


def test_masked_mean_and_region_mask_match_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 4, 16, 5)).astype(np.float32)
    m = np.ones((2, 64), np.float32)
    m[1, 32:] = 0.0
    want = np.asarray(jmasked.masked_mean(jnp.asarray(x),
                                          jnp.asarray(m.reshape(2, 4, 16, 1)), axis=-2))
    got = tmasked.masked_mean(torch.from_numpy(x),
                              torch.from_numpy(m.reshape(2, 4, 16, 1)), dim=-2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(
        tmasked.region_mask_from_patch_mask(torch.from_numpy(m)).numpy(),
        np.asarray(jmasked.region_mask_from_patch_mask(jnp.asarray(m))))


def test_build_names_library_by_source_hash(tmp_path, monkeypatch):
    """The library path is keyed on the sources; no nvcc means a raised
    error, never a silent plain fallback."""
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libadvmil_kernels_")
    assert p == _build.library_path()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
