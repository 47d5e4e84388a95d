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


def _assert_tight(got, q, k, v, mask, dout=None, p=0.0, seed=None, fwd_out=None):
    """The bf16 tensor-core kernels against the plain version that rounds
    where they round, within `rounded_tol`: far below the values compared,
    so a dropped term of dS or a few keys never visited fail here, where the
    bounds against the plain version (as large as bf16's noise on the scores)
    can let them pass. `fwd_out`: the forward output the backward kernels
    were given, for the oracle's dvec (`masked_attention_rounded`)."""
    want = tattn.masked_attention_rounded(q, k, v, mask, dout, p, seed, fwd_out=fwd_out)
    want = (want,) if dout is None else want
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), **tattn.rounded_tol(b),
                                   msg=lambda m, n=name: f"{n} (rounding plain version): {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,L,H,Dh", [(2, 2048, 8, 48), (3, 130, 2, 16),
                                      (2, 77, 4, 64), (2, 200, 1, 128),
                                      (2, 150, 3, 32), (2, 4096, 2, 48)])
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
    if dtype == torch.bfloat16:
        _assert_tight((out,), q, k, v, mask)
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


# ---------------------------------------------------------------------------
# training: autograd Functions, backward kernels, in-kernel dropout
# ---------------------------------------------------------------------------

from advmil_tpu_torch.models import layers as tl   # noqa: E402
from advmil_tpu_torch.ops import philox as tphilox   # noqa: E402


@pytest.mark.cuda
def test_gradients_reach_the_embedding_and_in_proj_on_cuda(cuda_device):
    """Both kernel ops carry gradients on the card: the patch embedding's
    Dense_0 / LayerNorm_0 (through LN-pool) and the transformer's in_proj
    (through flash attention, train mode, L above the gate)."""
    torch.manual_seed(0)
    emb = tl.init_parameters(tl.AvgPoolPatchEmbedding(64, 128), seed=1).to(cuda_device)
    x = torch.randn(2, 256, 64, device=cuda_device)
    mask = torch.ones(2, 256, device=cuda_device)
    mask[1, 128:] = 0.0
    lnp_f, lnp_b = tlnp.LAUNCHES, tlnp.LAUNCHES_BWD
    emb(x, mask).square().sum().backward()
    assert tlnp.LAUNCHES == lnp_f + 1 and tlnp.LAUNCHES_BWD == lnp_b + 1
    assert emb.Dense_0.weight.grad.abs().sum() > 0
    assert emb.LayerNorm_0.weight.grad.abs().sum() > 0

    layer = tl.init_parameters(tl.TransformerEncoderLayer(96, 2, 96, flash_min_len=64),
                               seed=2).to(cuda_device).train()
    rngs = tl.Rngs(torch.Generator(device=cuda_device).manual_seed(3),
                   torch.Generator().manual_seed(4))
    h = torch.randn(2, 128, 96, device=cuda_device)
    rmask = torch.ones(2, 128, device=cuda_device)
    rmask[0, 100:] = 0.0
    before = (tattn.LAUNCHES, tattn.LAUNCHES_DQ, tattn.LAUNCHES_DKV)
    layer(h, rmask, rngs).square().sum().backward()
    assert (tattn.LAUNCHES, tattn.LAUNCHES_DQ, tattn.LAUNCHES_DKV) == tuple(
        n + 1 for n in before)
    assert layer.in_proj.weight.grad.abs().sum() > 0
    assert torch.isfinite(layer.in_proj.weight.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D", [(32768, 384), (32768, 128), (48, 32), (16 * 7, 1024)])
def test_ln_pool_bwd_kernel_matches_plain(cuda_device, M, D, dtype):
    h, scale, bias = _ln_inputs(M, D, seed=D + 1, device=cuda_device)
    h = h.to(dtype)
    h[-16:] = 0.0                                  # a fully padded region
    g = torch.randn(M // 16, D, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(5)).to(dtype)

    def grads(fn):
        hh, sc, bi = (t.detach().clone().requires_grad_(True) for t in (h, scale, bias))
        fn(hh, sc, bi).backward(g)
        return hh.grad, sc.grad, bi.grad

    before = tlnp.LAUNCHES_BWD
    got = grads(tlnp.ln_relu_region_mean)
    torch.cuda.synchronize()
    assert tlnp.LAUNCHES_BWD == before + 1
    want = grads(tlnp.ln_relu_region_mean_plain)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    for a, b in zip(got[1:], want[1:]):             # sums over M rows, f32 both
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-4)


def _flash_grads(fn, q, k, v, mask, dout):
    qq, kk, vv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(qq, kk, vv)
    out.backward(dout)
    return out.detach(), qq.grad, kk.grad, vv.grad


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.25])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,L,H,Dh", [(2, 1024, 8, 48), (3, 130, 2, 16), (2, 77, 4, 64),
                                      (2, 200, 1, 128), (2, 150, 3, 32), (2, 4096, 2, 48)])
def test_flash_fwd_bwd_kernels_match_plain(cuda_device, B, L, H, Dh, dtype, tol, p):
    q, k, v, mask = _attn_inputs(B, L, H, Dh, cuda_device)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    dout = torch.randn(q.shape, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(7)).to(dtype)
    seed = 0x1234_5678_9ABC_DEF0 if p else None
    before = (tattn.LAUNCHES, tattn.LAUNCHES_DQ, tattn.LAUNCHES_DKV)
    got = _flash_grads(lambda a, b, c: tattn.masked_flash_attention(
        a, b, c, mask, dropout_p=p, seed=seed), q, k, v, mask, dout)
    torch.cuda.synchronize()
    assert (tattn.LAUNCHES, tattn.LAUNCHES_DQ, tattn.LAUNCHES_DKV) == tuple(
        n + 1 for n in before)
    want = _flash_grads(lambda a, b, c: tattn.masked_attention_reference(
        a, b, c, mask, p, seed), q, k, v, mask, dout)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and torch.isfinite(a).all(), name
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol, msg=name)
        assert torch.all(a[-1] == 0), f"{name}: fully masked bag not exactly 0"
    if dtype == torch.bfloat16:
        _assert_tight(got, q, k, v, mask, dout, p, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.25])
def test_flash_bf16_backward_on_saturated_rows(cuda_device, p):
    """#6 / #7 on rows whose softmax is saturated: q and k scaled by 12, as
    the CPU case of tests/test_torch_attention.py scales them and as trained
    attention grows its logits. There dS = P (dP - dvec) cancels, and a bf16
    ulp between the forward kernel's output and the oracle's own moves dQ by
    a share of itself; so the oracle takes dvec from the output the backward
    kernels were given (`fwd_out`), and dQ, dK and dV are held within
    `rounded_tol` of it. A ragged bag and a fully masked one (exact zeros)."""
    B, L, H, Dh = 2, 1024, 8, 48
    rng = np.random.default_rng(11)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(B, L, H, Dh)).astype(np.float32))
                     for _ in range(4))
    q, k = (q * 12.0).bfloat16().to(cuda_device), (k * 12.0).bfloat16().to(cuda_device)
    v, dout = v.bfloat16().to(cuda_device), dout.bfloat16().to(cuda_device)
    mask = torch.ones(B, L, device=cuda_device)
    mask[0, L - 300:] = 0.0
    mask[1] = 0.0
    seed = 0x0BAD_5EED if p else None
    before = (tattn.LAUNCHES_DQ, tattn.LAUNCHES_DKV)
    got = _flash_grads(lambda a, b, c: tattn.masked_flash_attention(
        a, b, c, mask, dropout_p=p, seed=seed), q, k, v, mask, dout)
    torch.cuda.synchronize()
    assert (tattn.LAUNCHES_DQ, tattn.LAUNCHES_DKV) == tuple(n + 1 for n in before)
    for name, a in zip(("out", "dq", "dk", "dv"), got):
        assert bool(torch.isfinite(a).all()) and bool((a[1] == 0).all()), name
    _assert_tight(got, q, k, v, mask, dout, p, seed, fwd_out=got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.25])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,Lq,Lk,H,Dh", [(2, 300, 1024, 4, 48), (3, 1000, 200, 2, 32),
                                          (2, 1, 65, 2, 16),
                                          (4, 1024, 300, 8, 16),    # a grid of 8-warp blocks
                                          (2, 200, 333, 3, 48),     # odd tile count, ragged
                                          (2, 129, 450, 2, 128),    # Dh = 128: register limit
                                          (2, 64, 70000, 1, 16)])   # past one window of listed tiles
def test_flash_kernels_skip_masked_tiles_and_take_lq_unlike_lk(cuda_device, B, Lq, Lk, H, Dh,
                                                               dtype, tol, p):
    """Lq != Lk, and a mask with holes: a whole 64-key tile masked inside bag
    0 (every kernel skips it), a hole across a tile edge, a ragged
    tail and a fully masked last bag. Lq and Lk ragged against the f32
    kernels' steps too (dQ: 128 keys, two listed tiles, 64 at Dh = 128; dK/dV:
    128 queries, 32 at Dh = 128): Lk = 333 leaves bag 0 five real tiles, so
    its last dQ step holds one tile. Lk = 70,000 passes the 1,024 tiles (65,536
    keys) that the f32 forward and dQ list at a time: bag 0's real keys lie in
    both windows, the masked bag has none in either. Forward, dQ and dK/dV
    launched directly."""
    g = torch.Generator().manual_seed(Lq + Lk)
    q, dout = (torch.randn(B, Lq, H, Dh, generator=g).to(cuda_device).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, Lk, H, Dh, generator=g).to(cuda_device).to(dtype) for _ in range(2))
    mask = torch.ones(B, Lk, device=cuda_device)
    if Lk >= 200:
        mask[0, 64:128] = 0.0
        mask[0, 185:197] = 0.0
    mask[0, Lk - 7:] = 0.0
    mask[-1] = 0.0
    seed = 0xABCD_EF01_2345 if p else None
    out, lse = tattn.flash_attention_fwd(q, k, v, mask, p, seed)
    got = (out,) + tattn.flash_attention_bwd(q, k, v, mask, out, lse, dout, p, seed)
    torch.cuda.synchronize()
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ref = tattn.masked_attention_reference(*leaves, mask, p, seed)
    want = (ref.detach(),) + torch.autograd.grad(ref, leaves, dout)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and torch.isfinite(a).all(), name
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol, msg=name)
        assert torch.all(a[-1] == 0), f"{name}: fully masked bag not exactly 0"
    for name, a in (("dk", got[2]), ("dv", got[3])):
        assert torch.all(a[0][mask[0] == 0] == 0), f"{name}: a masked key got a gradient"
    if dtype == torch.bfloat16:
        _assert_tight(got, q, k, v, mask, dout, p, seed)
    assert torch.all(lse[-H:] == lse[-1, -1]) and float(lse[-1, -1]) < -9e29   # -1e30 + log(1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.25])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_flash_kernels_at_inst_rank_shapes(cuda_device, dtype, tol, p):
    """The shapes the sequence-parallel op gives the kernels on two inst
    ranks: each rank's 256 query rows against all 512 keys with the rank's
    seed (seed + rank * 7919), against the plain version; at p = 0 the
    ranks' outputs and dQ joined, and their dK / dV summed (the
    reduce-scatter's sum), against the unsharded launch."""
    B, L, Lq, H, Dh = 2, 512, 256, 4, 48
    g = torch.Generator().manual_seed(14)
    q, k, v, dout = (torch.randn(B, L, H, Dh, generator=g).to(cuda_device).to(dtype)
                     for _ in range(4))
    mask = torch.ones(B, L, device=cuda_device)
    mask[0, 300:] = 0.0            # rank 1's rows see a ragged bag
    mask[1, 64:128] = 0.0
    seed = 0x7E57 if p else None
    parts = []
    for r in range(2):
        rows = slice(r * Lq, (r + 1) * Lq)
        qr, dor = q[:, rows].contiguous(), dout[:, rows].contiguous()
        sr = tattn.rank_seed(seed, r)
        out, lse = tattn.flash_attention_fwd(qr, k, v, mask, p, sr)
        got = (out,) + tattn.flash_attention_bwd(qr, k, v, mask, out, lse, dor, p, sr)
        leaves = [t.detach().clone().requires_grad_(True) for t in (qr, k, v)]
        ref = tattn.masked_attention_reference(*leaves, mask, p, sr)
        want = (ref.detach(),) + torch.autograd.grad(ref, leaves, dor)
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                       msg=f"rank {r} {name}")
        if dtype == torch.bfloat16:
            _assert_tight(got, qr, k, v, mask, dor, p, sr)
        parts.append(got)
    if p == 0.0:
        full, lse = tattn.flash_attention_fwd(q, k, v, mask)
        full_g = tattn.flash_attention_bwd(q, k, v, mask, full, lse, dout)
        for name, a, b in (("out", torch.cat([x[0] for x in parts], 1), full),
                           ("dq", torch.cat([x[1] for x in parts], 1), full_g[0]),
                           ("dk", parts[0][2].float() + parts[1][2].float(), full_g[1]),
                           ("dv", parts[0][3].float() + parts[1][3].float(), full_g[2])):
            torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol, msg=name)
    else:      # the two ranks' seeds give other keep masks on the same rows
        other = tattn.flash_attention_fwd(q[:, :Lq].contiguous(), k, v, mask, p,
                                          tattn.rank_seed(seed, 1))[0]
        assert not torch.equal(parts[0][0], other)


@pytest.mark.cuda
def test_flash_inst_op_in_a_one_rank_group(cuda_device):
    """`masked_flash_attention_inst` on the card in a process group of one
    rank (the all-gather and the reduce-scatter are then the identity): the
    kernels' result and gradients, one launch of each kernel."""
    import torch.distributed as tdist
    from advmil_tpu_torch.parallel.launch import free_port
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                             world_size=1, rank=0)
    try:
        g = torch.Generator().manual_seed(3)
        q, k, v = (torch.randn(2, 300, 4, 48, generator=g).to(cuda_device).requires_grad_(True)
                   for _ in range(3))
        mask = torch.ones(2, 300, device=cuda_device)
        mask[1, 200:] = 0.0
        before = (tattn.LAUNCHES, tattn.LAUNCHES_DQ, tattn.LAUNCHES_DKV)
        out = tattn.masked_flash_attention_inst(q, k, v, mask, None)
        got = torch.autograd.grad(out.sum(), (q, k, v))
        assert (tattn.LAUNCHES, tattn.LAUNCHES_DQ, tattn.LAUNCHES_DKV) == \
            tuple(b + 1 for b in before)
        ref = tattn.masked_attention_reference(q, k, v, mask)
        want = torch.autograd.grad(ref.sum(), (q, k, v))
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    finally:
        tdist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.25, 0.6])
def test_flash_bf16_kernels_regenerate_the_keep_mask_bit_for_bit(cuda_device, p, dtype):
    """The forward and dK/dV kernels share one Philox block between four
    elements (bf16: between lanes; f32: a thread's four keys of one query,
    which the forward reads in a rotated order, as dQ does);
    their keep bits must still be the per-element stream that the keep-mask
    kernel writes (the dQ kernel has its own test below). With q = 0 the
    probabilities are uniform, so with v = I the forward's output, and with
    dO = I the dV of the same backward call that runs the dQ kernel, are
    non-zero exactly where an element was kept."""
    BH, L, Dh, seed = 6, 128, 128, (1 << 63) + 99
    q = torch.zeros(1, L, BH, Dh, device=cuda_device, dtype=dtype)
    eye = torch.eye(L, device=cuda_device, dtype=dtype)[None, :, None, :].expand(
        1, L, BH, Dh).contiguous()
    mask = torch.ones(1, L, device=cuda_device)
    keep = tphilox.keep_mask(seed, BH, L, L, p, device=cuda_device)          # [BH, Lq, Lk]
    before = (tattn.LAUNCHES_DROPOUT, tattn.LAUNCHES_DQ, tattn.LAUNCHES_DKV)
    out, lse = tattn.flash_attention_fwd(q, eye, eye, mask, p, seed)
    dq, dk, dv = tattn.flash_attention_bwd(q, eye, eye, mask, out, lse, eye, p, seed)
    torch.cuda.synchronize()
    assert (tattn.LAUNCHES_DROPOUT, tattn.LAUNCHES_DQ, tattn.LAUNCHES_DKV) == tuple(
        n + 1 for n in before)
    assert torch.equal((out[0] != 0).permute(1, 0, 2).float(), keep)        # out[i, h, j]
    assert torch.equal((dv[0] != 0).permute(1, 2, 0).float(), keep)         # dv[j, h, i]
    if dtype == torch.bfloat16:
        _assert_tight((out, dq, dk, dv), q, eye, eye, mask, eye, p, seed)
    else:
        want = _flash_grads(lambda a, b, c: tattn.masked_attention_reference(
            a, b, c, mask, p, seed), q, eye, eye, mask, eye)
        for name, a, b in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv), want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.25, 0.6])
def test_flash_bf16_dq_kernel_regenerates_the_keep_mask_bit_for_bit(cuda_device, p, dtype):
    """The dQ kernel shares one Philox block between four elements (bf16: two
    lanes, as the forward does; f32: a thread's quad of keys, read in a
    rotated order). With q = 0 the probabilities are uniform; k = I makes
    dQ[i, j] = dS[i, j]; an `out` of zeros makes dvec 0, and v = dO = e_0 makes
    every dP 1: dQ is then non-zero exactly where an element was kept."""
    BH, L, Dh, seed = 6, 128, 128, (1 << 63) + 99
    q = torch.zeros(1, L, BH, Dh, device=cuda_device, dtype=dtype)
    eye = torch.eye(L, device=cuda_device, dtype=dtype)[None, :, None, :].expand(
        1, L, BH, Dh).contiguous()
    e0 = torch.zeros_like(eye)
    e0[..., 0] = 1.0
    mask = torch.ones(1, L, device=cuda_device)
    keep = tphilox.keep_mask(seed, BH, L, L, p, device=cuda_device)          # [BH, Lq, Lk]
    _, lse = tattn.flash_attention_fwd(q, eye, e0, mask, p, seed)
    ops = tattn.flash_bwd_inputs(q, eye, e0, mask, torch.zeros_like(q), lse, e0)
    before = tattn.LAUNCHES_DQ
    dq = tattn.flash_bwd_dq(ops, p, seed)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES_DQ == before + 1
    assert torch.equal((dq[0] != 0).permute(1, 0, 2).float(), keep)         # dq[i, h, j]


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.25])
@pytest.mark.parametrize("all_real", [False, True])
def test_flash_f32_kernels_are_bit_for_bit_over_two_calls(cuda_device, p, all_real):
    """The f32 forward, dQ and dK/dV kernels add their partial sums (the
    split of a step's keys or queries over thread groups) in a fixed order
    and use no atomics: two calls on the same inputs agree bit for bit, out
    and lse as well as the gradients. Phase 3's shape of chip_smoke.py, its
    mask (a ragged bag, a fully masked bag) and with every key real."""
    B, L, H, Dh = 2, 1024, 8, 48
    rng = np.random.default_rng(22)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(B, L, H, Dh)).astype(np.float32))
                     .to(cuda_device) for _ in range(4))
    mask = torch.ones(B, L, device=cuda_device)
    if not all_real:
        mask[0, L - 300:] = 0.0
        mask[1] = 0.0
    seed = 0x22_5EED if p else None
    out, lse = tattn.flash_attention_fwd(q, k, v, mask, p, seed)
    ops = tattn.flash_bwd_inputs(q, k, v, mask, out, lse, dout)
    first = (out, lse, tattn.flash_bwd_dq(ops, p, seed)) + tattn.flash_bwd_dkv(ops, p, seed)
    second = tattn.flash_attention_fwd(q, k, v, mask, p, seed) + (
        tattn.flash_bwd_dq(ops, p, seed),) + tattn.flash_bwd_dkv(ops, p, seed)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), f"{name}: two calls differ"


@pytest.mark.cuda
def test_flash_refuses_more_keys_than_the_tile_list_holds(cuda_device):
    q = torch.zeros(1, 1, 1, 16, device=cuda_device)
    k = torch.zeros(1, tattn.MAX_KEYS + 1, 1, 16, device=cuda_device)
    with pytest.raises(ValueError, match="unsupported sizes"):
        tattn.flash_attention_fwd(q, k, k, torch.ones(1, tattn.MAX_KEYS + 1, device=cuda_device))


@pytest.mark.cuda
def test_flash_dropout_keeps_everything_at_tiny_p(cuda_device):
    """p so small that its threshold is 0 and 1/(1-p) rounds to 1 in f32: the
    dropout path keeps every element and must equal the p = 0 path bit for
    bit (the dropout plumbing adds nothing of its own)."""
    q, k, v, mask = _attn_inputs(2, 300, 2, 48, cuda_device)
    out0, lse0 = tattn.flash_attention_fwd(q, k, v, mask)
    out1, lse1 = tattn.flash_attention_fwd(q, k, v, mask, dropout_p=1e-12, seed=9)
    assert torch.equal(out0, out1) and torch.equal(lse0, lse1)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,Lq,Lk,p", [(16, 1024, 1024, 0.25), (3, 77, 130, 0.6),
                                        (1, 5, 3, 0.1)])
def test_keep_mask_kernel_is_bit_exact(cuda_device, BH, Lq, Lk, p):
    seed = (1 << 63) + 12345
    before = tphilox.LAUNCHES
    got = tphilox.keep_mask(seed, BH, Lq, Lk, p, device=cuda_device)
    torch.cuda.synchronize()
    assert tphilox.LAUNCHES == before + 1
    assert torch.equal(got, tphilox.keep_mask_plain(seed, BH, Lq, Lk, p, cuda_device))
    assert torch.equal(got.cpu(), tphilox.keep_mask_plain(seed, BH, Lq, Lk, p))


@pytest.mark.cuda
def test_philox_header_matches_curand(cuda_device):
    ours, ref = tphilox.check_against_curand(4096, cuda_device)
    assert torch.equal(ours, ref)


# ---------------------------------------------------------------------------
# the graph aggregation kernels (#12-#15) and GENConv on the card
# ---------------------------------------------------------------------------

from advmil_tpu_torch.models import backbones as tbb   # noqa: E402
from advmil_tpu_torch.ops import banded as tband   # noqa: E402
from advmil_tpu_torch.ops import segment as tseg   # noqa: E402

# f32: values and gradients 1e-5, dt 1e-4 relative (a sum over every node
# and channel); bf16: 2e-2 + 2e-2 relative (bf16 storage of both outputs)
_GRAPH_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
              torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _raster_tables(B, N, W, epn, seed, irregular=20):
    """B raster kNN bags of N nodes on a W-wide grid, with dropped and
    irregular edges and one node without edges: dense tables [B, N, epn] and
    the batcher's band tables, with sentinel u_rows slots."""
    rng = np.random.default_rng(seed)
    offs = [-W - 1, -W, -W + 1, -1, 0, 1, W - 1, W, W + 1][:epn]
    dense, band = [], []
    for b in range(B):
        esrc = np.zeros((N, epn), np.int32)
        em = np.zeros((N, epn), np.float32)
        for s, o in enumerate(offs):
            tgt = np.arange(N) + o
            ok = (tgt >= 0) & (tgt < N) & (rng.random(N) >= 0.05)
            esrc[ok, s], em[ok, s] = tgt[ok], 1.0
        for _ in range(irregular):
            n, s = rng.integers(N), rng.integers(epn)
            esrc[n, s], em[n, s] = rng.integers(N), 1.0
        em[7 + b] = 0.0
        dense.append((esrc, em))
        band.append(tseg.build_band_tables(esrc, em)[:2])
    u_slots = 8 + max(tseg.band_coverage(*d)[2] for d in dense)
    ut = [tband.build_u_tables(*d, bm, u_slots=u_slots) for d, (_, bm) in zip(dense, band)]
    tabs = {"edge_src": np.stack([d[0] for d in dense]),
            "edge_mask": np.stack([d[1] for d in dense]),
            "band_offs": np.stack([o for o, _ in band]),
            "band_mask": np.stack([bm for _, bm in band]),
            "band_urows": np.stack([u[0] for u in ut]),
            "band_usrc": np.stack([u[1] for u in ut]),
            "band_uemask": np.stack([u[2] for u in ut]),
            "band_uinv": np.stack([tband.build_u_inv(u[0], N) for u in ut])}
    assert (tabs["band_urows"] == N).any() and (tabs["band_urows"] < N).any()
    return tabs


def _op_grads(fn, x, t, g):
    xx = x.detach().clone().requires_grad_(True)
    tt = t.detach().clone().requires_grad_(True)
    out = fn(xx, tt)
    out.backward(g)
    return out.detach(), xx.grad, tt.grad


def _assert_graph_close(got, want, dtype):
    for name, a, b in zip(("out", "dx"), got[:2], want[:2]):
        assert a.dtype == dtype and torch.isfinite(a).all(), name
        torch.testing.assert_close(a.float(), b.float(), **_GRAPH_TOL[dtype],
                                   msg=lambda m, name=name: f"{name}: {m}")
    assert got[2].dtype == torch.float32 and got[2].shape == (1,)
    torch.testing.assert_close(got[2], want[2], atol=1e-4, rtol=1e-4,
                               msg=lambda m: f"dt: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,epn,C,skew", [(2, 4096, 9, 384, 0), (3, 77, 16, 40, 0),
                                            (1, 50, 1, 7, 0), (2, 2048, 16, 384, 0),
                                            (2, 1000, 9, 384, 4)])
def test_knn_agg_kernels_match_plain(cuda_device, B, N, epn, C, skew, dtype):
    """#12 / #13 against the plain op and its autograd backward, with nodes
    without edges (exactly 0) and masked slots holding large junk; bf16 also
    within `segment.knn_tol` / `segment.knn_bwd_tol`. epn = 16 at C = 384 is
    the backward's largest register set; `skew` = 4 starts the messages 4
    bytes off a 16-byte boundary (a slice of a larger buffer), so the kernels
    take their element-by-element path. Two backward calls give the same
    dmessages and dt bit for bit (dt: fixed-order partial sums)."""
    gen = torch.Generator(device=cuda_device).manual_seed(N)
    msg = torch.randn(B, N, epn, C, device=cuda_device, generator=gen).to(dtype)
    if skew:
        buf = torch.empty(msg.numel() + 16, dtype=dtype, device=cuda_device)
        at = skew // msg.element_size()
        msg = buf[at:at + msg.numel()].view(msg.shape).copy_(msg)
        assert msg.is_contiguous() and msg.data_ptr() % 16 == skew
    em = (torch.rand(B, N, epn, device=cuda_device, generator=gen) < 0.8).float()
    em[:, :3] = 0.0
    msg[:, 3:, -1] = torch.where(em[:, 3:, -1:] > 0, msg[:, 3:, -1], 300.0).to(dtype)
    g = torch.randn(B, N, C, device=cuda_device, generator=gen).to(dtype)
    t = torch.tensor([1.3], device=cuda_device)
    before = (tseg.LAUNCHES, tseg.LAUNCHES_BWD)
    got = _op_grads(lambda m, tt: tseg.fused_knn_softmax_aggregate(m, em, tt), msg, t, g)
    torch.cuda.synchronize()
    assert (tseg.LAUNCHES, tseg.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    want = _op_grads(lambda m, tt: tseg.knn_edge_softmax_aggregate(m, em, tt), msg, t, g)
    _assert_graph_close(got, want, dtype)
    assert torch.all(got[0][:, :3] == 0) and torch.all(got[1][em == 0] == 0)
    # the kernels on msg itself (the autograd leaf above is an aligned copy)
    direct = (tseg.fused_agg_fwd(msg, em, t), *tseg.fused_agg_bwd(msg, em, t, g))
    twice = tseg.fused_agg_bwd(msg, em, t, g)
    torch.cuda.synchronize()
    _assert_graph_close(direct, want, dtype)
    assert torch.equal(direct[1], twice[0]) and torch.equal(direct[2], twice[1])
    if dtype == torch.bfloat16:   # one rounding each from f32
        for res in (got, direct):
            assert _share(res[0], want[0], **tseg.knn_tol(want[0])) <= 1.0
            assert _share(res[1], want[1], **tseg.knn_bwd_tol(want[1])) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,W,C", [(2, 4096, 48, 384), (3, 150, 12, 40), (1, 30, 4, 7)])
def test_banded_kernels_match_plain(cuda_device, B, N, W, C, dtype):
    """#14 / #15 (the banded core) against the plain core and its autograd
    backward; then the whole banded op with residual rows, sentinel u_rows
    slots and a node without edges against its plain twin and against the
    dense op on the full edge tables."""
    tabs = {k: torch.from_numpy(v).to(cuda_device)
            for k, v in _raster_tables(B, N, W, 9, seed=N).items()}
    gen = torch.Generator(device=cuda_device).manual_seed(W)
    y = torch.randn(B, N, C, device=cuda_device, generator=gen).to(dtype)
    g = torch.randn(B, N, C, device=cuda_device, generator=gen).to(dtype)
    t = torch.tensor([0.8], device=cuda_device)
    offs, bm = tabs["band_offs"], tabs["band_mask"]
    before = (tband.LAUNCHES, tband.LAUNCHES_BWD)
    got = _op_grads(lambda yy, tt: tband.banded_core(yy, offs, bm, tt), y, t, g)
    torch.cuda.synchronize()
    assert (tband.LAUNCHES, tband.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    want = _op_grads(lambda yy, tt: tband.banded_core_plain(yy, offs, bm, tt), y, t, g)
    _assert_graph_close(got, want, dtype)
    if dtype == torch.bfloat16:   # one rounding each: within a bf16 ulp (banded_tol)
        for name, a, b in zip(("out", "dy"), got[:2], want[:2]):
            torch.testing.assert_close(a.float(), b.float(), **tband.banded_tol(b.float()),
                                       msg=lambda m, name=name: f"{name} (banded_tol): {m}")
    with torch.no_grad():   # no backward can run: the forward writes no stats
        torch.testing.assert_close(tband.banded_core(y, offs, bm, t), got[0], atol=0, rtol=0)

    u = [tabs[k] for k in ("band_urows", "band_usrc", "band_uemask", "band_uinv")]
    got = _op_grads(lambda yy, tt: tband.banded_aggregate(yy, offs, bm, *u, tt), y, t, g)
    want = _op_grads(lambda yy, tt: tband.banded_aggregate(yy, offs, bm, *u, tt,
                                                           use_kernels=False), y, t, g)
    _assert_graph_close(got, want, dtype)
    assert torch.all(got[0][torch.arange(B), 7 + torch.arange(B)] == 0)
    bidx = torch.arange(B, device=cuda_device)[:, None, None]
    dense = _op_grads(lambda yy, tt: tseg.knn_edge_softmax_aggregate(   # f32 gather
        yy.float()[bidx, tabs["edge_src"].long()], tabs["edge_mask"], tt).to(dtype), y, t, g)
    _assert_graph_close(got, dense, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width,height", [(42, 390), (228, 72)])
def test_banded_kernels_on_grid_tables(cuda_device, width, height, dtype):
    """#14 / #15 and the whole banded op on the grid route's tables of two
    tissue slides (epn 9, C=384): at width ~40 every offset lies inside the
    rows the kernels stage; at ~220 the offset span (~3W) is past all of
    them, so the +-W, +-(W +- 1) and +-2W slots read device memory. Against
    the plain versions (f32 1e-5; bf16 the plain bound and `banded_tol`);
    padded grid cells without edges are exactly 0."""
    from advmil_tpu_torch.data.synthetic import tissue_grid_tables
    tabs = tissue_grid_tables([(width, height), (width - 2, height - 2)],
                              np.random.default_rng(width))
    tabs = {k: torch.from_numpy(v).to(cuda_device) for k, v in tabs.items()
            if k.startswith("band_")}
    offs, bm = tabs["band_offs"], tabs["band_mask"]
    span = int((offs.max(1).values - offs.min(1).values).max())
    assert (span <= 128) if width < 100 else (span > 192)
    B, G, C = 2, bm.shape[1], 384
    gen = torch.Generator(device=cuda_device).manual_seed(height)
    y = (torch.relu(torch.randn(B, G, C, device=cuda_device, generator=gen)) + 1e-7).to(dtype)
    g = torch.randn(B, G, C, device=cuda_device, generator=gen).to(dtype)
    t = torch.tensor([1.3], device=cuda_device)
    got = _core_grads(y, offs, bm, t, g)
    want = _op_grads(lambda yy, tt: tband.banded_core_plain(yy, offs, bm, tt), y, t, g)
    torch.cuda.synchronize()
    _assert_graph_close(got, want, dtype)
    if dtype == torch.bfloat16:
        for name, a, b in zip(("out", "dy"), got[:2], want[:2]):
            torch.testing.assert_close(a.float(), b.float(), **tband.banded_tol(b.float()),
                                       msg=lambda m, name=name: f"{name} (banded_tol): {m}")
    u = [tabs[k] for k in ("band_urows", "band_usrc", "band_uemask", "band_uinv")]
    got = _op_grads(lambda yy, tt: tband.banded_aggregate(yy, offs, bm, *u, tt), y, t, g)
    want = _op_grads(lambda yy, tt: tband.banded_aggregate(yy, offs, bm, *u, tt,
                                                           use_kernels=False), y, t, g)
    _assert_graph_close(got, want, dtype)
    empty = (tabs["band_ginv"] >= tabs["band_gidx"].shape[1])         # cells without tissue
    assert bool((got[0][empty] == 0).all())


def _hand_bands(B, N, epn, far, seed):
    """offs [B, epn] different in every bag (with `far`: one slot at +600 and
    one at -300, beyond what the kernels stage), band_mask [B, N, epn] with
    ~15% of the slots off, slots whose source lies outside the bag, and node
    3 of every bag without edges."""
    rng = np.random.default_rng(seed)
    offs = np.stack([rng.choice(np.arange(-12, 13), size=epn, replace=False) for _ in range(B)])
    if far:
        offs[:, 0], offs[:, -1] = 600, -300
        offs[1:, 0] = 599
    bm = (rng.random((B, N, epn)) < 0.85).astype(np.float32)
    bm[:, 3] = 0.0
    return torch.from_numpy(offs.astype(np.int32)), torch.from_numpy(bm)


def _core_grads(y, offs, bm, t, g):
    return _op_grads(lambda yy, tt: tband.banded_core(yy, offs, bm, tt), y, t, g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,epn,C,far", [(2, 4096, 9, 40, True), (3, 20, 1, 8, False),
                                           (2, 100, 16, 12, False), (2, 1000, 16, 20, True),
                                           (1, 700, 5, 384, True)])
def test_banded_kernels_on_hand_made_bands(cuda_device, B, N, epn, C, far, dtype):
    """#14 / #15 on tables the batcher would not build: offsets that differ
    from bag to bag, offsets beyond the staged window (read from device
    memory), N below one step, epn 1 and 16, C not a multiple of 8 (element
    loads). Against the plain version (f32 1e-5; bf16 the plain bound and
    `banded_tol`); a node without edges is exactly 0 and passes no
    gradient; dy and dt are the same bit for bit in a second run."""
    offs, bm = (a.to(cuda_device) for a in _hand_bands(B, N, epn, far, seed=N + epn))
    gen = torch.Generator(device=cuda_device).manual_seed(C)
    y = torch.randn(B, N, C, device=cuda_device, generator=gen).to(dtype)
    g = torch.randn(B, N, C, device=cuda_device, generator=gen).to(dtype)
    t = torch.tensor([1.1], device=cuda_device)
    got = _core_grads(y, offs, bm, t, g)
    again = _core_grads(y, offs, bm, t, g)
    torch.cuda.synchronize()
    want = _op_grads(lambda yy, tt: tband.banded_core_plain(yy, offs, bm, tt), y, t, g)
    _assert_graph_close(got, want, dtype)
    if dtype == torch.bfloat16:
        for name, a, b in zip(("out", "dy"), got[:2], want[:2]):
            torch.testing.assert_close(a.float(), b.float(), **tband.banded_tol(b.float()),
                                       msg=lambda m, name=name: f"{name} (banded_tol): {m}")
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    assert torch.all(got[0][:, 3] == 0)
    g_empty = torch.zeros_like(g)
    g_empty[:, 3] = 1.0
    none = _core_grads(y, offs, bm, t, g_empty)
    assert torch.all(none[1] == 0) and torch.all(none[2] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_kernels_far_offsets_equal_near_ones(cuda_device, dtype):
    """A slot whose offset lies beyond the staged window (read from device
    memory) gives bit for bit what the same slot gives from the window. Bag 1
    holds bag 0's rows twice, the second copy S rows further on, so that its
    slot at offset 1 + S reads the rows that bag 0's slot at offset 1 reads;
    nodes 0 .. S - 1 have edges."""
    S, C = 900, 40
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    rows = torch.randn(S + 1, C, device=cuda_device, generator=gen)
    y = torch.zeros(2, 2 * S + 1, C, device=cuda_device)
    y[0, :S + 1] = rows
    y[1, :S], y[1, S + 1:] = rows[:S], rows[1:]
    y = y.to(dtype)
    bm = torch.zeros(2, 2 * S + 1, 2, device=cuda_device)
    bm[:, :S] = 1.0
    g = torch.randn(2, 2 * S + 1, C, device=cuda_device, generator=gen).to(dtype)
    g[1] = g[0]
    t = torch.tensor([1.2], device=cuda_device)
    # forward: slots (0, 1) in bag 0 against (0, 1 + S) in bag 1
    offs = torch.tensor([[0, 1], [0, 1 + S]], dtype=torch.int32, device=cuda_device)
    out = _core_grads(y, offs, bm, t, g)[0]
    # backward: one slot, 1 against 1 + S; row n + 1 of bag 0 is row n + 1 + S of bag 1
    offs1, bm1 = offs[:, 1:].contiguous(), bm[..., 1:].contiguous()
    got = _core_grads(y, offs1, bm1, t, g)
    torch.cuda.synchronize()
    assert torch.equal(out[1, :S], out[0, :S])
    assert torch.equal(got[1][1, S + 1:], got[1][0, 1:S + 1])
    assert torch.all(got[1][1, :S + 1] == 0) and torch.all(got[1][0, S + 1:] == 0)
    for o, b_ in ((offs, bm), (offs1, bm1)):
        want = _op_grads(lambda yy, tt, o=o, b_=b_: tband.banded_core_plain(yy, o, b_, tt),
                         y, t, g)
        _assert_graph_close(_core_grads(y, o, b_, t, g), want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["banded", "dense"])
def test_gradients_reach_genconv_t_fc_and_mlp0_on_cuda(cuda_device, route):
    """PatchGCN on the card in train mode: the aggregation kernels run
    forward and backward, and gradients reach GENConv's t, the embedding fc
    and mlp0 through them."""
    tabs = _raster_tables(2, 256, 16, 9, seed=1)
    keys = (tuple(k for k in tabs if k.startswith("band_")) if route == "banded"
            else ("edge_src", "edge_mask"))
    extra = {k: torch.from_numpy(tabs[k]).to(cuda_device) for k in keys}
    model = tl.init_parameters(tbb.load_backbone("graph", [64, 32, 32], num_graph_layers=2),
                               seed=3).to(cuda_device).train()
    rngs = tl.Rngs(torch.Generator(device=cuda_device).manual_seed(3),
                   torch.Generator().manual_seed(4))
    x = torch.randn(2, 256, 64, device=cuda_device)
    mask = torch.ones(2, 256, device=cuda_device)
    mask[1, 200:] = 0.0
    mods = (tband, tband) if route == "banded" else (tseg, tseg)
    before = (mods[0].LAUNCHES, mods[1].LAUNCHES_BWD)
    model(x, mask, extra, rngs).square().sum().backward()
    torch.cuda.synchronize()
    assert mods[0].LAUNCHES >= before[0] + 2 and mods[1].LAUNCHES_BWD >= before[1] + 2
    for p in (model.layer0_conv.t, model.layer1.conv.t, model.fc.weight,
              model.layer0_conv.mlp0.weight):
        assert p.grad is not None and torch.isfinite(p.grad).all()
        assert p.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# the fused patch embedding (Dense + LN + ReLU + pool) and the plain LN + ReLU
# ---------------------------------------------------------------------------

from advmil_tpu_torch.ops import fused_embed as tfe   # noqa: E402


def _away_from_relu_edge(pre: torch.Tensor, g: torch.Tensor, rows_per_g: int) -> torch.Tensor:
    """g with the rows zeroed whose ReLU input `pre` has an element within 2e-5
    of 0 (a few per cent of the regions): there a rounding difference flips the
    ReLU mask, and the gradients differ by the whole cotangent, whichever
    version is right."""
    near = (pre.abs() < 2e-5).any(dim=1)
    near = near.reshape(-1, rows_per_g).any(dim=1)
    return g * (~near)[:, None].to(g.dtype)


def _pre_relu(h32, scale, bias):
    mu = h32.mean(dim=-1, keepdim=True)
    var = ((h32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return (h32 - mu) * torch.rsqrt(var + 1e-6) * scale + bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("M,D", [(32768, 768), (32768, 384), (37, 64), (16, 1024)])
def test_ln_relu_kernels_match_plain(cuda_device, M, D, dtype, tol):
    h, scale, bias = _ln_inputs(M, D, seed=M + D, device=cuda_device)
    h = h.to(dtype)
    g = torch.randn(M, D, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(1)).to(dtype)
    g = _away_from_relu_edge(_pre_relu(h.float(), scale, bias), g, 1)
    f0, b0 = tlnp.LAUNCHES_LNRELU, tlnp.LAUNCHES_LNRELU_BWD
    leaves = [t.detach().clone().requires_grad_(True) for t in (h, scale, bias)]
    out = tlnp.ln_relu(*leaves)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (tlnp.LAUNCHES_LNRELU, tlnp.LAUNCHES_LNRELU_BWD) == (f0 + 1, b0 + 1)
    assert out.dtype == dtype and got[0].dtype == dtype and got[1].dtype == torch.float32
    pl = [t.detach().clone().requires_grad_(True) for t in (h, scale, bias)]
    ref = tlnp.ln_relu_plain(*pl)
    want = torch.autograd.grad(ref, pl, g)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
    for a, b in zip(got[1:], want[1:]):     # sums over M rows
        torch.testing.assert_close(a, b, atol=2e-3, rtol=1e-3)


def _embed_case(M, K, D, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=gen)
    if M >= 32:
        x[16:32] = 0.0                                  # a fully zero (padded) region
    w = torch.randn(K, D, generator=gen) / K ** 0.5
    b = 0.1 * torch.randn(D, generator=gen)
    scale = 1.0 + 0.1 * torch.randn(D, generator=gen)
    bias = 0.1 * torch.randn(D, generator=gen)
    g = torch.randn(M // 16, D, generator=gen)
    if M >= 32:
        g[1] = 0.0                                      # as the region mask makes it
    x, w, b, scale, bias, g = (t.to(device) for t in (x, w, b, scale, bias, g))
    x = x.to(dtype)
    h = x.float() @ w.to(dtype).float() + b
    return x, w, b, scale, bias, _away_from_relu_edge(_pre_relu(h, scale, bias), g, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,D", [(4096, 1024, 384), (4096, 1024, 128), (16 * 67, 128, 96),
                                   (48, 64, 32), (16, 32, 256), (16 * 67, 32, 160),
                                   (16 * 67, 64, 384), (16 * 9, 64, 32), (16 * 5, 32, 96)])
def test_fused_embed_kernels_match_plain(cuda_device, M, K, D, dtype):
    """#9, #11 and #10 through the autograd Function (x requires grad, so dx is
    launched) against the plain forward and the written-out backward; ragged M
    (M % 64 != 0: the f32 row kernel's blocks hold 64 rows, the bf16 one's
    128), D across the f32 kernel's 32-column groups (32 and 96 below its
    128-wide tiling, 160 with groups of the 384-wide one idle), K of one or two
    32-wide chunks, a zero region with a zero cotangent, and two calls equal
    bit for bit (no atomics)."""
    x, w, b, scale, bias, g = _embed_case(M, K, D, dtype, cuda_device)
    before = (tfe.LAUNCHES, tfe.LAUNCHES_BWD_DPARAMS, tfe.LAUNCHES_BWD_DX)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, b, scale, bias)]
    out = tfe.fused_region_embedding(*leaves)
    got = torch.autograd.grad(out, leaves, g.to(dtype))
    torch.cuda.synchronize()
    assert (tfe.LAUNCHES, tfe.LAUNCHES_BWD_DPARAMS, tfe.LAUNCHES_BWD_DX) == \
        tuple(n + 1 for n in before)
    assert out.dtype == dtype and got[0].dtype == dtype
    assert all(t.dtype == torch.float32 for t in got[1:])
    ref = tfe.fused_region_embedding_plain(x, w, b, scale, bias)
    want = tfe.fused_region_embedding_bwd_plain(g.to(dtype), x, w, b, scale, bias)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)
        tol = dict(atol=2e-4, rtol=1e-3)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
        tol = dict(atol=2e-2, rtol=2e-2)
    for name, a, e in zip(("dx", "dw", "db", "dscale", "dbias"), got, want):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a.float(), e.float(), **tol, msg=lambda m, n=name: f"{n}: {m}")
    if M >= 32:
        assert bool((got[0][16:32] == 0).all())         # zero cotangent -> dx exactly 0
    again = tfe.fused_region_embedding(*leaves)
    assert torch.equal(out, again)
    assert all(torch.equal(a, e) for a, e in zip(got, torch.autograd.grad(again, leaves,
                                                                          g.to(dtype))))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,D,dtype", [
    (32768, 1024, 384, torch.bfloat16), (4096, 1024, 128, torch.bfloat16),
    (16 * 67, 1024, 384, torch.bfloat16), (16 * 67, 128, 96, torch.bfloat16),
    (48, 64, 32, torch.bfloat16), (16, 32, 256, torch.bfloat16), (16 * 9, 288, 320, torch.bfloat16),
    (4096, 1024, 384, torch.float32), (16 * 67, 128, 96, torch.float32)])
def test_fused_embed_dx_kernel_matches_the_plain_product_of_its_own_dh(cuda_device, M, K, D,
                                                                        dtype):
    """#10 alone, on a given dh: against `fused_region_embedding_bwd_dx_plain`
    only the order of the f32 sum and the last rounding differ, so the bound is
    `dx_tol` (one bf16 ulp relative + 2^-8 of the largest |dx|), which a tile
    that loses a 64-wide chunk of D exceeds. Ragged M (not a multiple of 128),
    K below one 128-column tile, D that is no multiple of 64, and zero rows,
    whose dx is exactly 0."""
    gen = torch.Generator().manual_seed(M + K + D)
    dh = (torch.randn(M, D, generator=gen) / D ** 0.5).to(cuda_device).to(dtype)
    if M >= 32:
        dh[16:32] = 0.0
    w = torch.randn(K, D, generator=gen).to(cuda_device)
    before = tfe.LAUNCHES_BWD_DX
    got = tfe.fused_region_embedding_bwd_dx(dh, w)
    torch.cuda.synchronize()
    assert tfe.LAUNCHES_BWD_DX == before + 1
    assert got.dtype == dtype and got.shape == (M, K) and bool(torch.isfinite(got).all())
    want = tfe.fused_region_embedding_bwd_dx_plain(dh, w)
    torch.testing.assert_close(got.float(), want.float(), **tfe.dx_tol(want))
    if M >= 32:
        assert bool((got[16:32] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("M", [16 * 67, 32768])
@pytest.mark.parametrize("K", [64, 1024])
@pytest.mark.parametrize("D", [32, 96, 128, 384])
def test_fused_embed_bf16_kernels_within_their_tight_bounds(cuda_device, M, K, D):
    """#9 and #11 in bf16 (the wgmma row kernel, forward and backward mode,
    and the dW product): the forward within `fwd_tol` of the plain forward,
    dh within `dh_tol` of the plain dh rounded to bf16, dW within `dw_tol` of
    the plain product of the kernel's own dh, db / dscale / dbias within the
    plain bounds; a zero region with a zero cotangent gets a dh of exactly 0,
    and two calls give the same bits (no atomics). D = 32 and 96 leave part of
    the row kernel's columns and of TMA's boxes beyond D; M = 16 * 67 leaves
    the last block's rows beyond M."""
    x, w, b, scale, bias, g = _embed_case(M, K, D, torch.bfloat16, cuda_device)
    runs = [(tfe.fused_region_embedding_fwd(x, w, b, scale, bias),
             *tfe.fused_region_embedding_bwd_dparams(g, x, w, b, scale, bias)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, again in zip(*runs):
        assert torch.equal(a, again)
    out, dh, dw, db, dscale, dbias = runs[0]
    assert all(bool(torch.isfinite(t).all()) for t in runs[0])
    ref = tfe.fused_region_embedding_plain(x, w, b, scale, bias)
    torch.testing.assert_close(out.float(), ref.float(), **tfe.fwd_tol(ref))
    dh_ref = tfe.fused_region_embedding_dh_plain(g, x, w, b, scale, bias)[0].bfloat16()
    torch.testing.assert_close(dh.float(), dh_ref.float(), **tfe.dh_tol(dh_ref))
    own = x.float().t() @ dh.float()
    torch.testing.assert_close(dw, own, **tfe.dw_tol(own))
    want = tfe.fused_region_embedding_bwd_plain(g, x, w, b, scale, bias)
    for a, e in zip((db, dscale, dbias), want[2:]):
        torch.testing.assert_close(a, e, atol=2e-2, rtol=2e-2)
    assert bool((dh[16:32] == 0).all())


@pytest.mark.cuda
def test_wgmma_kernels_build_without_serialized_products(cuda_device, tmp_path):
    """The wgmma sources compiled as the library compiles them: ptxas reports
    no "Potential Performance Loss" (C7520: a branch, a C++ wait loop or a
    warp role read from threadIdx around a wgmma; C7511: too few registers
    for the wgmma pipeline), either of which serializes the products."""
    import subprocess
    from advmil_tpu_torch.ops import _build
    jobs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                              str(tmp_path / f"{name}.o"), str(_build.CSRC / f"{name}.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name in ("fused_embed_rows", "fused_embed_dw", "fused_embed_dx")]
    logs = [job.communicate()[0] for job in jobs]
    assert all(job.returncode == 0 for job in jobs), "\n".join(logs)
    for log in logs:
        assert "wgmma_kernel" in log                      # ptxas reported the kernels
        assert "Potential Performance Loss" not in log, log


@pytest.mark.cuda
def test_fused_embed_skips_dx_and_takes_empty_input(cuda_device):
    x, w, b, scale, bias, g = _embed_case(64, 64, 32, torch.float32, cuda_device)
    leaves = [x] + [t.detach().clone().requires_grad_(True) for t in (w, b, scale, bias)]
    n_dx = tfe.LAUNCHES_BWD_DX
    tfe.fused_region_embedding(*leaves).backward(g)
    assert tfe.LAUNCHES_BWD_DX == n_dx and leaves[1].grad is not None   # x is data: no dx
    empty = tfe.fused_region_embedding(x[:0], w, b, scale, bias)
    assert empty.shape == (0, 32)
    assert tlnp.ln_relu(x[:0, :32], scale, bias).shape == (0, 32)


@pytest.mark.cuda
def test_fused_embed_and_ln_relu_refuse_what_the_kernels_do_not_take(cuda_device):
    x, w, b, scale, bias, g = _embed_case(64, 64, 32, torch.float32, cuda_device)
    with pytest.raises(ValueError):
        tfe.fused_region_embedding(x[:40], w, b, scale, bias)             # M % 16
    with pytest.raises(ValueError):
        tfe.fused_region_embedding(x.half(), w, b, scale, bias)           # dtype
    with pytest.raises(ValueError):
        tfe.fused_region_embedding(x, w.bfloat16(), b, scale, bias)       # w not f32
    with pytest.raises(ValueError):
        tfe.fused_region_embedding(x, w, b.cpu(), scale, bias)            # device
    with pytest.raises(ValueError):
        tfe.fused_region_embedding(x, w[:, :20], b[:20], scale[:20], bias[:20])   # D % 32
    with pytest.raises(ValueError):
        tfe.fused_region_embedding(x, torch.zeros(64, 512, device=cuda_device),
                                   *(torch.zeros(512, device=cuda_device),) * 3)  # D > 384
    with pytest.raises(ValueError):
        tfe.fused_region_embedding_bwd_dparams(g[:2], x, w, b, scale, bias)       # g shape
    with pytest.raises(ValueError):
        tlnp.ln_relu(x[:, :20], scale[:20], bias[:20])                    # D % 32
    with pytest.raises(ValueError):
        tlnp.ln_relu_bwd(x[:8, :32], x[:, :32], scale, bias)              # g shape


@pytest.mark.cuda
def test_fused_patch_embedding_layer_on_cuda(cuda_device):
    """The layer with `use_fused` launches #9 / #11 (not #1 / #2), gives its
    Dense_0 and LayerNorm_0 their gradients, zeroes padded regions, and agrees
    with the unfused layer in f32."""
    fused = tl.init_parameters(tl.AvgPoolPatchEmbedding(64, 128, use_fused=True), seed=1)
    plain = tl.AvgPoolPatchEmbedding(64, 128)
    plain.load_state_dict(fused.state_dict())
    fused.to(cuda_device), plain.to(cuda_device)
    x = torch.randn(2, 256, 64, device=cuda_device)
    mask = torch.ones(2, 256, device=cuda_device)
    mask[1, 128:] = 0.0
    x = x * mask[..., None]
    n = (tfe.LAUNCHES, tfe.LAUNCHES_BWD_DPARAMS, tlnp.LAUNCHES, tlnp.LAUNCHES_BWD)
    out = fused(x, mask)
    out.square().sum().backward()
    assert (tfe.LAUNCHES, tfe.LAUNCHES_BWD_DPARAMS, tlnp.LAUNCHES, tlnp.LAUNCHES_BWD) == \
        (n[0] + 1, n[1] + 1, n[2], n[3])
    assert bool((out[1, 8:] == 0).all())
    ref = plain(x, mask)
    ref.square().sum().backward()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)
    for (k, p), q in zip(fused.named_parameters(), plain.parameters()):
        torch.testing.assert_close(p.grad, q.grad, atol=2e-4, rtol=1e-3, msg=k)


def _share(got, want, atol, rtol):
    """The largest |got - want| as a share of atol + rtol |want| (1: at the bound)."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


@pytest.mark.cuda
@pytest.mark.parametrize("M,D", [(32768, 384), (32768, 128), (16, 384), (48, 32), (16 * 7, 1024)])
def test_ln_pool_bwd_kernel_tight_and_deterministic(cuda_device, M, D):
    """#2 in bf16 against `ln_pool.bwd_tol` (one rounding of dh from f32),
    with the cotangent zeroed for regions with a ReLU input within 2e-5 of 0;
    g passed as bf16 and as f32 (the same values) gives bit-identical results,
    and two calls give bit-identical dscale / dbias (a fixed-order sum over
    the block partials). M = 16 is a single region."""
    h, scale, bias = _ln_inputs(M, D, seed=D + 3, device=cuda_device)
    h = h.bfloat16()
    g = torch.randn(M // 16, D, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(9))
    g = _away_from_relu_edge(_pre_relu(h.float(), scale, bias), g, 16).bfloat16()
    got = tlnp.ln_relu_region_mean_bwd(g, h, scale, bias)
    again = tlnp.ln_relu_region_mean_bwd(g, h, scale, bias)
    from_f32 = tlnp.ln_relu_region_mean_bwd(g.float(), h, scale, bias)
    leaves = [t.detach().clone().requires_grad_(True) for t in (h, scale, bias)]
    want = torch.autograd.grad(tlnp.ln_relu_region_mean_plain(*leaves), leaves, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, from_f32))
    assert _share(got[0], want[0], **tlnp.bwd_tol(want[0])) <= 1.0
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=2e-2, rtol=2e-2)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-4)


_FWD_SHAPES = [(32768, 384), (32768, 128), (48, 32), (16 * 9, 256), (16 * 7, 1024),
               (16 * 5, 416)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool,M,D", [(True, *s) for s in _FWD_SHAPES] +
                         [(False, *s) for s in _FWD_SHAPES + [(1001, 128), (37, 416)]])
def test_ln_pool_fwd_kernel_tight_and_deterministic(cuda_device, pool, M, D, dtype):
    """#1 (pool) and #3 against the plain version: bf16 within
    `ln_pool.fwd_tol` (one rounding from f32) and the plain 2e-2 bound, f32
    within 1e-5; two calls bit for bit (the 16-row sum in a fixed order), one
    launch each. D = 416 and 32 take the 2-byte path (D % 128 != 0), D = 128
    four rows a warp at once, D = 256 the 8-byte path with masked chunks;
    M = 1001 and 37 leave #3 a partial region."""
    h, scale, bias = _ln_inputs(M, D, seed=D + 7, device=cuda_device)
    h = h.to(dtype)
    fwd, plain = ((tlnp.ln_relu_region_mean_fwd, tlnp.ln_relu_region_mean_plain) if pool else
                  (tlnp.ln_relu_fwd, tlnp.ln_relu_plain))
    count = "LAUNCHES" if pool else "LAUNCHES_LNRELU"
    before = getattr(tlnp, count)
    got = fwd(h, scale, bias)
    again = fwd(h, scale, bias)
    want = plain(h, scale, bias)
    torch.cuda.synchronize()
    assert getattr(tlnp, count) == before + 2
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, again)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0.0)
    else:
        assert _share(got, want, **tlnp.fwd_tol(want)) <= 1.0
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [5, 300])
@pytest.mark.parametrize("C", [7, 40, 384])
@pytest.mark.parametrize("epn", [1, 9, 16])
def test_knn_fwd_kernel_every_slot_count_and_channel_tail(cuda_device, epn, C, N, dtype):
    """#12 (one instantiation per slot count) against the plain version: f32
    within 1e-5, bf16 within `segment.knn_tol` and the plain 2e-2 bound, at a
    channel count with a tail (7), without 16-byte rows in f32 (40 is, 7 is
    not) and the path's (384); N = 5 is less than one tile of rows. Nodes
    without edges give exactly 0, and junk in masked slots never leaks."""
    gen = torch.Generator(device=cuda_device).manual_seed(epn * 1000 + C + N)
    msg = (1.0 + 0.5 * torch.randn(2, N, epn, C, device=cuda_device, generator=gen))
    em = (torch.rand(2, N, epn, device=cuda_device, generator=gen) < 0.8).float()
    em[:, 1] = 0.0
    msg = torch.where(em[..., None] > 0, msg, torch.full_like(msg, 300.0)).to(dtype)
    t = torch.tensor([1.3], device=cuda_device)
    before = tseg.LAUNCHES
    out = tseg.fused_agg_fwd(msg, em, t)
    want = tseg.knn_edge_softmax_aggregate(msg, em, t)
    torch.cuda.synchronize()
    assert tseg.LAUNCHES == before + 1 and out.dtype == dtype and out.shape == (2, N, C)
    assert bool((out[:, 1] == 0).all()) and bool(torch.isfinite(out).all())
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    else:
        assert _share(out, want, **tseg.knn_tol(want)) <= 1.0
        torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# gradient accumulation, the optimizers and the cluster step, card against CPU
# (chip_smoke.py phases 26 and 29 at test size; no kernel runs on these paths)
# ---------------------------------------------------------------------------

from advmil_tpu_torch import losses as tlosses   # noqa: E402
from advmil_tpu_torch.models import gan as tgan   # noqa: E402
from advmil_tpu_torch.train import optim as topt   # noqa: E402
from advmil_tpu_torch.train.steps import make_base_train_step   # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adam", "adafactor", "lookahead_radam", "sgdp"])
def test_multisteps_on_card_matches_cpu(cuda_device, name):
    """MultiSteps(k = 3) over 7 mini-steps of the same gradients (a fixed
    function of the parameters): parameters within 1e-6 + 1e-5 relative of
    the CPU's at every mini-step, bit-unchanged between inner steps."""
    rng = np.random.default_rng(3)
    shapes = [(130, 136), (6, 5), (5,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    a = [rng.uniform(0.5, 1.5, size=s).astype(np.float32) for s in shapes]
    c = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(7)]
    trails = {}
    for dev in (cuda_device, torch.device("cpu")):
        params = [torch.tensor(v, device=dev, requires_grad=True) for v in p0]
        opt = topt.MultiSteps(topt.create_optimizer(name, params, 1e-2, weight_decay=5e-4), 3)
        trail = []
        for t in range(7):
            for p, ai, ci in zip(params, a, c[t]):
                p.grad = torch.from_numpy(ai).to(dev) * p.detach() + torch.from_numpy(ci).to(dev)
            opt.step()
            trail.append([p.detach().cpu().clone() for p in params])
        assert opt.gradient_step == 2 and opt.mini_step == 1
        trails[dev.type] = trail
    for t, (got, want) in enumerate(zip(trails["cuda"], trails["cpu"])):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)
        if (t + 1) % 3:
            prev = trails["cuda"][t - 1] if t else [torch.from_numpy(v) for v in p0]
            assert all(torch.equal(g, q) for g, q in zip(got, prev))


@pytest.mark.cuda
@pytest.mark.parametrize("opt_name", ["adam", "adahessian"])
def test_cluster_base_step_on_card_matches_cpu(cuda_device, opt_name):
    """One surv_nll step of a SurvNet on DeepAttnMISL (a masked tail, an
    empty cluster), dropout off, from the same weights (AdaHessian with the
    same z): loss within 1e-6 relative, parameters within 1e-5 (AdaHessian:
    plus |update| * the Hessian diagonal's card-vs-CPU difference / |h|)."""
    rng = np.random.default_rng(5)
    B, N, C = 3, 64, 48
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 40:] = 0
    cid = rng.integers(0, 8, size=(B, N)).astype(np.int32)
    cid[2][cid[2] == 3] = 4
    label = np.stack([rng.integers(0, 4, size=B), rng.integers(0, 2, size=B)], 1)
    ref = tl.init_parameters(tgan.SurvNet(tbb.load_backbone("cluster", [C, 32, 32]), 32, 4,
                                          out_scale="sigmoid"), 0)
    zs = topt.rademacher_like(list(ref.parameters()), torch.Generator().manual_seed(1))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = tgan.SurvNet(tbb.load_backbone("cluster", [C, 32, 32]), 32, 4,
                             out_scale="sigmoid")
        model.load_state_dict(ref.state_dict())
        tl.set_dropout_rates(model.to(dev), 0.0)
        params = list(model.parameters())
        opt = (topt.AdaHessian(params, 8e-5, weight_decay=5e-4) if opt_name == "adahessian"
               else topt.create_optimizer(opt_name, params, 8e-5, weight_decay=5e-4))
        seen = {}

        def z_fn(ps, gen, seen=seen):
            seen["z"] = [z.to(p.device) for z, p in zip(zs, ps)]
            return seen["z"]

        step = make_base_train_step(model, opt, task="surv_nll", l1_coef=1e-5,
                                    sup_loss_fn=tlosses.surv_mle_loss,
                                    z_fn=z_fn)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in (
            ("feats", x), ("mask", mask), ("extra", cid),
            ("label", label.astype(np.float32)), ("sample_mask", np.ones(B, np.float32)))}
        rngs = tl.Rngs(device=torch.Generator(device=dev).manual_seed(0),
                       host=torch.Generator().manual_seed(1))
        metrics, _ = step(batch, rngs)
        h = None
        if opt_name == "adahessian":
            h = [st["nu"].detach().cpu().sqrt() / (1 - 0.999) ** 0.5
                 for st in (opt.state[p] for p in params)]
        out[dev.type] = (float(metrics["loss_total"]),
                         {n: p.detach().cpu() for n, p in model.named_parameters()}, h)
    (lc, pc, hc), (lh, ph, hh) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-6 * abs(lh)
    start = ref.state_dict()
    h_diff = max(float((a - b).abs().max()) for a, b in zip(hc, hh)) if hc else 0.0
    for i, n in enumerate(ph):
        upd = (ph[n] - start[n]).abs()
        allowed = 1e-5 + (upd * h_diff / (hh[i] + 1e-8) if hh else 0.0)
        assert bool(((pc[n] - ph[n]).abs() <= allowed).all()), n


@pytest.mark.cuda
def test_second_order_step_through_patch_kernels_raises(cuda_device):
    """A second-order (AdaHessian) base step on the patch backbone (width
    128, so the LN-pool kernel #1 is on the path) builds its double
    backward through kernel #2's backward, which refuses create_graph: the
    step raises instead of stepping on a Hessian diagonal that misses the
    kernel's share."""
    rng = np.random.default_rng(13)
    B, N, C = 2, 64, 64
    mask = np.ones((B, N), np.float32)
    mask[1, 48:] = 0
    model = tl.init_parameters(tgan.SurvNet(tbb.load_backbone("patch", [C, 128, 128]), 128, 4,
                                            out_scale="sigmoid"), 0).to(cuda_device)
    tl.set_dropout_rates(model, 0.0)
    opt = topt.AdaHessian(list(model.parameters()), 8e-5, weight_decay=5e-4)
    step = make_base_train_step(model, opt, task="surv_nll", l1_coef=1e-5,
                                sup_loss_fn=tlosses.surv_mle_loss)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in (
        ("feats", rng.normal(size=(B, N, C)).astype(np.float32)), ("mask", mask),
        ("label", np.array([[1, 1], [2, 0]], np.float32)),
        ("sample_mask", np.ones(B, np.float32)))}
    rngs = tl.Rngs(device=torch.Generator(device=cuda_device).manual_seed(0),
                   host=torch.Generator().manual_seed(1))
    before = tlnp.LAUNCHES
    start = [p.detach().clone() for p in model.parameters()]
    with pytest.raises(RuntimeError, match="no double backward"):
        step(batch, rngs)
    assert tlnp.LAUNCHES == before + 1
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), start))
