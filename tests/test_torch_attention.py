"""The port's attention op on the CPU against the JAX package, on the masks
the tensor-core kernels treat specially: a run of 64 masked keys inside a real
bag (a key tile the kernels skip) and a fully masked bag; the plain version
with the bf16 kernels' roundings (the oracle of the card tests) against the
f32 reference; and the Philox words a fragment's column pair shares.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advmil_tpu.ops import attention as jattn
from advmil_tpu_torch.ops import attention as tattn
from advmil_tpu_torch.ops import philox as tphilox


def _case(B, L, H, Dh, seed):
    """Bag 0 real with keys 64..127 and a ragged tail masked, the last bag
    fully masked, any bag between them whole."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, L, H, Dh)).astype(np.float32) for _ in range(4))
    mask = np.ones((B, L), np.float32)
    mask[0, 64:128] = 0.0
    mask[0, L - 21:] = 0.0
    mask[-1] = 0.0
    return q, k, v, mask, do


SHAPES = [(2, 300, 2, 16), (3, 200, 4, 48)]


@pytest.mark.parametrize("B,L,H,Dh", SHAPES)
def test_plain_forward_matches_jax_flash_on_a_masked_interior_tile(B, L, H, Dh):
    q, k, v, mask, _ = _case(B, L, H, Dh, seed=L)
    want = np.asarray(jattn.masked_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), interpret=True))
    got = tattn.masked_flash_attention(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)      # f32, other summation order
    assert np.all(got[-1] == 0.0) and np.all(want[-1] == 0.0)     # dummy bag: exactly 0


@pytest.mark.parametrize("B,L,H,Dh", SHAPES)
def test_plain_gradients_match_jax_flash_on_a_masked_interior_tile(B, L, H, Dh):
    q, k, v, mask, do = _case(B, L, H, Dh, seed=L + 1)

    def jloss(q_, k_, v_):
        out = jattn.masked_flash_attention(q_, k_, v_, jnp.asarray(mask), interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    want = [np.asarray(a) for a in jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tattn.masked_flash_attention(tq, tk, tv, torch.from_numpy(mask)).backward(
        torch.from_numpy(do))
    for name, got, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5, rtol=0, err_msg=name)
        assert np.all(got.numpy()[-1] == 0.0), name              # dummy bag: exactly 0
    for got in (tk.grad, tv.grad):                                # masked keys get nothing
        assert np.all(got.numpy()[0][mask[0] == 0] == 0.0)


@pytest.mark.parametrize("p", [0.0, 0.25])
@pytest.mark.parametrize("B,L,H,Dh", SHAPES)
def test_rounded_plain_version_stays_within_the_bf16_bounds(B, L, H, Dh, p):
    """`masked_attention_rounded` (P, the dropped P and dS rounded to bf16 as
    the tensor-core kernels round them, dS for dQ as for dK) on bf16 inputs
    against the f32 reference on the same values: 3e-2 abs + rel, the card
    tests' bf16 bound, forward and all three gradients, with the materialised
    Philox mask at p = 0.25. Without dropout (the JAX package draws another
    stream) the oracle's gradients also stay within that bound of the JAX
    flash VJP in interpret mode on the same values, which the reference's
    gradients match within 1e-5."""
    q, k, v, mask, do = (torch.from_numpy(a) for a in _case(B, L, H, Dh, seed=L + 2))
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    seed = 0x5EED if p else None
    got = tattn.masked_attention_rounded(q, k, v, mask, do, p, seed)
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref = tattn.masked_attention_reference(*leaves, mask, p, seed)
    want = (ref.detach(),) + torch.autograd.grad(ref, leaves, do.float())
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a.float(), b, atol=3e-2, rtol=3e-2, msg=name)
        assert bool((a[-1] == 0).all()), f"{name}: fully masked bag not exactly 0"
    assert bool((got[2][0][mask[0] == 0] == 0).all()) and bool((got[3][0][mask[0] == 0] == 0).all())
    if p:
        return
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))

    def jloss(q_, k_, v_):
        out = jattn.masked_flash_attention(q_, k_, v_, jnp.asarray(mask.numpy()), interpret=True)
        return jnp.sum(out * jnp.asarray(do.float().numpy()))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    for name, a, b, w in zip(("dq", "dk", "dv"), got[1:], want[1:], jgrads):
        w = torch.from_numpy(np.array(w))
        torch.testing.assert_close(b, w, atol=1e-5, rtol=0, msg=f"{name}: reference against JAX")
        torch.testing.assert_close(a.float(), w, atol=3e-2, rtol=3e-2,
                                   msg=f"{name}: rounding oracle against JAX")


def _share(a, b, atol, rtol):
    """The largest |a - b| as a share of the bound atol + rtol |b|."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


@pytest.mark.parametrize("p", [0.0, 0.25])
def test_rounded_tol_catches_a_dropped_fragment_tile(p):
    """Why the card holds the bf16 kernels to `masked_attention_rounded` within
    `rounded_tol` and not to the plain version's 3e-2 abs + rel alone. The
    fault: 16 real keys (two n8 tiles of a fragment) never visited, at the
    training shape's length. Its dk and dv on the other keys use under 0.7 of
    the plain bound, so they pass it; every one of out, dq, dk, dv is over
    `rounded_tol`: dv 1.2 times, dk twice, out and dq more than ten times. The
    oracle without `dout` returns the same `out`."""
    B, L, H, Dh = 1, 1024, 2, 48
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, L, H, Dh)).astype(np.float32)).bfloat16()
                   for _ in range(4))
    mask = torch.ones(B, L)
    mask[0, L - 300:] = 0.0
    faulty = mask.clone()
    faulty[0, 128:144] = 0.0
    seed = 0x5EED if p else None
    right = tattn.masked_attention_rounded(q, k, v, mask, do, p, seed)
    wrong = tattn.masked_attention_rounded(q, k, v, faulty, do, p, seed)
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref = tattn.masked_attention_reference(*leaves, mask, p, seed)
    plain = (ref.detach(),) + torch.autograd.grad(ref, leaves, do.float())
    live = faulty[0] > 0                             # the keys the fault did not zero
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        w, r, pl = ((t[i][0][live] if i >= 2 else t[i]) for t in (wrong, right, plain))
        assert _share(r, pl, 3e-2, 3e-2) < 0.5, name         # the oracle is the function
        tight = _share(w, r, **tattn.rounded_tol(right[i]))
        assert tight > (10.0, 10.0, 2.0, 1.2)[i], (name, tight)
        if i >= 2:
            assert _share(w, pl, 3e-2, 3e-2) < 0.7, name     # the plain bound lets it pass
    assert torch.equal(tattn.masked_attention_rounded(q, k, v, mask, None, p, seed), right[0])


def _dq_with_a_dropped_term(q, k, v, mask, do, p, seed, lost):
    """dQ as `masked_attention_rounded` forms it (dS rounded to bf16 before
    dS . K), but with the `- dvec` term of dS left out at the keys where
    `lost` is set: what a dQ kernel computes that drops the term for some
    elements of its fragment."""
    B, Lq, H, Dh = q.shape
    f32, scale = torch.float32, 1.0 / Dh ** 0.5
    out = tattn.masked_attention_rounded(q, k, v, mask, None, p, seed).to(f32)
    qs, kf, vf, dof = (q * scale).to(f32), k.to(f32), v.to(f32), do.to(f32)
    real = mask[:, None, None, :] > 0
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    probs = torch.softmax(s.masked_fill(~real, float("-inf")), dim=-1)
    keep = 1.0
    if p:
        keep = tphilox.keep_mask_plain(seed, B * H, Lq, k.shape[1], p).reshape(B, H, Lq, -1) \
            * (1.0 / (1.0 - p))
    dvec = (dof * out).sum(-1).permute(0, 2, 1)[..., None]
    ds = probs * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) * keep - dvec * (~lost).to(f32))
    return (torch.einsum("bhqk,bkhd->bqhd", ds.bfloat16().to(f32), kf) * scale).to(q.dtype)


@pytest.mark.parametrize("p", [0.0, 0.25])
def test_rounded_tol_catches_a_dropped_term_of_dq(p):
    """The dQ kernel's own fault: dS without its `- dvec` term at one key in
    sixteen (one column of each A-operand fragment of dS . K), at the training
    shape's length. Against the plain version's 3e-2 abs + rel that dQ passes
    (under 0.8 of the bound); against the oracle within `rounded_tol` it is
    more than four times over. (Dropped at every second key the fault is large
    enough to fail the plain bound too, 2.5 times over: not the case that
    needs the tight bound.) With no key lost the helper is the oracle's dQ."""
    B, L, H, Dh = 1, 1024, 2, 48
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, L, H, Dh)).astype(np.float32)).bfloat16()
                   for _ in range(4))
    mask = torch.ones(B, L)
    mask[0, L - 300:] = 0.0
    seed = 0x5EED if p else None
    right = tattn.masked_attention_rounded(q, k, v, mask, do, p, seed)[1]
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref = tattn.masked_attention_reference(*leaves, mask, p, seed)
    plain = torch.autograd.grad(ref, leaves, do.float())[0]
    none = torch.zeros(L, dtype=torch.bool)
    same = _dq_with_a_dropped_term(q, k, v, mask, do, p, seed, none)
    assert _share(same, right, **tattn.rounded_tol(right)) < 0.5
    wrong = _dq_with_a_dropped_term(q, k, v, mask, do, p, seed, torch.arange(L) % 16 == 1)
    assert _share(right, plain, 3e-2, 3e-2) < 0.5            # the oracle is the function
    assert _share(wrong, plain, 3e-2, 3e-2) < 0.8            # the plain bound lets it pass
    assert _share(wrong, right, **tattn.rounded_tol(right)) > 4.0


@pytest.mark.parametrize("peak", [1.0, 12.0])
def test_rounded_oracle_holds_the_backward_on_the_forward_output_it_was_given(peak):
    """The backward kernels take dvec = rowsum(dO * O) from the forward
    kernel's output, which may sit one bf16 ulp from the oracle's own. On a
    row whose softmax is saturated (logits scaled by `peak`, as trained
    attention grows them) dS = P (dP - dvec) cancels, and that ulp alone
    moves dQ past `rounded_tol`; held on the same forward output
    (`fwd_out`) the oracle gives the kernel's function. Unit-scale logits
    (peak 1) keep dQ within the bound either way."""
    B, L, H, Dh = 1, 256, 2, 48
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, L, H, Dh)).astype(np.float32))
                   for _ in range(4))
    q, k, v, do = (q * peak).bfloat16(), (k * peak).bfloat16(), v.bfloat16(), do.bfloat16()
    mask = torch.ones(B, L)
    own = tattn.masked_attention_rounded(q, k, v, mask, do)
    same = tattn.masked_attention_rounded(q, k, v, mask, do, fwd_out=own[0])
    assert all(torch.equal(a, b) for a, b in zip(own, same))
    # a forward output about one bf16 ulp away at every element
    nudged = (own[0].float() * (1.0 + 2.0 ** -7)).bfloat16()
    moved = tattn.masked_attention_rounded(q, k, v, mask, do, fwd_out=nudged)
    share = _share(moved[1], own[1], **tattn.rounded_tol(own[1]))
    if peak == 1.0:
        assert share <= 1.0
    else:
        assert share > 1.0
    assert _share(moved[3], own[3], **tattn.rounded_tol(own[3])) == 0.0   # dV reads no dvec


@pytest.mark.parametrize("seed,BH,Lq,Lk,p", [(77, 3, 20, 131, 0.25), ((1 << 63) + 5, 2, 9, 64, 0.6),
                                             (0, 1, 33, 6, 0.1)])
def test_a_column_pair_shares_one_philox_block(seed, BH, Lq, Lk, p):
    """An accumulator fragment holds the column pair (2j, 2j + 1): both are
    words of the one Philox block at counter 2j // 4, words 2j % 4 and + 1. So
    one block per pair (and one per four columns between two lanes) gives the
    keep mask of the per-element definition, unchanged."""
    lo, hi = tphilox.split_seed(seed)
    pairs = (Lk + 1) // 2
    first = 2 * torch.arange(pairs)[None, None, :]                   # column 2j
    rows = torch.arange(Lq)[None, :, None]
    bhs = torch.arange(BH)[:, None, None]
    c0, c1, c2 = torch.broadcast_tensors(first // 4, rows, bhs)
    words = torch.stack(tphilox.philox4x32_10(c0, c1, c2, torch.zeros((), dtype=torch.int64),
                                              lo, hi), dim=-1)        # [BH, Lq, pairs, 4]
    w = (first % 4).expand(BH, Lq, pairs)[..., None]
    both = torch.cat([torch.gather(words, -1, w), torch.gather(words, -1, w + 1)], dim=-1)
    paired = (both.reshape(BH, Lq, 2 * pairs)[..., :Lk] >= tphilox.threshold(p)).float()
    assert torch.equal(paired, tphilox.keep_mask_plain(seed, BH, Lq, Lk, p))
