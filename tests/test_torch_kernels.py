"""The hand-written CUDA kernels of advmil_tpu_torch against their plain
PyTorch versions, on the card, at the main path's shapes (f32 and bf16).

The file imports no JAX, so it also runs where only torch is installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
Without a CUDA device every test skips (the kernels have no CPU mode)."""
import numpy as np
import pytest
import torch

from advmil_tpu_torch.ops import attention as tattn
from advmil_tpu_torch.ops import ln_pool as tlnp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ln_inputs(M, D, seed, device):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(M, D)).astype(np.float32)
    scale = (1.0 + rng.normal(0, 0.1, size=(D,))).astype(np.float32)
    bias = rng.normal(0, 0.1, size=(D,)).astype(np.float32)
    return (torch.from_numpy(a).to(device) for a in (h, scale, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("M,D", [(32768, 384), (32768, 128), (48, 32), (16 * 7, 1024)])
def test_ln_pool_kernel_matches_plain(cuda_device, M, D, dtype, tol):
    h, scale, bias = _ln_inputs(M, D, seed=D, device=cuda_device)
    h = h.to(dtype)
    before = tlnp.LAUNCHES
    got = tlnp.ln_relu_region_mean(h, scale, bias)
    torch.cuda.synchronize()
    assert tlnp.LAUNCHES == before + 1 and got.dtype == dtype
    want = tlnp.ln_relu_region_mean_plain(h, scale, bias)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_ln_pool_kernel_refuses_bad_shapes(cuda_device):
    h, scale, bias = _ln_inputs(32, 100, seed=0, device=cuda_device)
    with pytest.raises(ValueError):
        tlnp.ln_relu_region_mean(h, scale, bias)          # D % 32 != 0


def _attn_inputs(B, L, H, Dh, device, seed=11):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, L, H, Dh, generator=g).to(device) for _ in range(3))
    mask = torch.ones(B, L, device=device)
    mask[0, L - 300 if L > 300 else L // 2:] = 0.0        # ragged bag
    if B > 1:
        mask[-1] = 0.0                                     # fully masked bag
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,L,H,Dh", [(2, 2048, 8, 48), (3, 130, 2, 16),
                                      (2, 77, 4, 64), (2, 200, 1, 128)])
def test_flash_kernel_matches_plain(cuda_device, B, L, H, Dh, dtype, tol):
    q, k, v, mask = _attn_inputs(B, L, H, Dh, cuda_device)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = tattn.LAUNCHES
    out, lse = tattn.flash_attention_fwd(q, k, v, mask)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == before + 1
    want = tattn.masked_attention_reference(q, k, v, mask)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0.0)
    assert torch.all(out[-1] == 0) and lse.shape == (B * H, L)
    # lse of the ragged bag is the log-sum-exp of its unmasked logits
    qs = (q[0] * (1.0 / Dh ** 0.5)).float()      # pre-scaled in its dtype
    s = torch.einsum("qhd,khd->hqk", qs, k[0].float())
    s = s.masked_fill(mask[0][None, None, :] == 0, float("-inf"))
    torch.testing.assert_close(lse[:H], torch.logsumexp(s, dim=-1),
                               atol=1e-4, rtol=0.0)


@pytest.mark.cuda
def test_flash_kernel_refuses_unbuilt_head_dim(cuda_device):
    q, k, v, mask = _attn_inputs(1, 64, 2, 40, cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tattn.flash_attention_fwd(q, k, v, mask)
