"""Fused region patch embedding: Dense -> LayerNorm -> ReLU -> 16-row region
mean as one op, forward and backward.

Counterpart of `advmil_tpu/ops/fused_embed.py::fused_region_embedding`
(`_fwd_kernel`, `_bwd_dx_kernel`, `_bwd_dparams_kernel`). ESAT's patch
embedding with `use_fused_embedding` runs it instead of Dense + LN-pool: the
[M, D] activation h = x W + b never reaches device memory in the forward, and
it is never rounded to the compute dtype (the unfused layer rounds Dense's
output before the LayerNorm).

Arithmetic, on both devices: x [M, K] in f32 or bf16; W [K, D] f32, rounded
to x's dtype for the product; the product accumulates in f32; b, the
LayerNorm (eps 1e-6 inside the rsqrt) and the mean in f32; the output
[M / 16, D] in x's dtype. The backward takes the cotangent in f32, divides it
by 16, masks with y > 0 on the recomputed y, and returns dx in x's dtype, dW
in W's dtype and db / dscale / dbias in their parameters' dtypes.

Dispatch: a CPU tensor goes to `fused_region_embedding_plain` (autograd
through plain torch ops); a CUDA tensor goes to `FusedRegionEmbedding`, whose
forward and backward are hand-written kernels (the matrix products included:
no library GEMM on this path), or raises. There is no fallback from the
kernels to the plain version. f32 runs as register-blocked products on the
CUDA cores, true f32 (`csrc/fused_embed.cu`); bf16 on the warpgroup tensor
cores with TMA loads (`csrc/wgmma.cuh`): the row kernel
`csrc/fused_embed_rows.cu`, dW `csrc/fused_embed_dw.cu`, dx
`csrc/fused_embed_dx.cu`.

On an H100 (M = 32,768, K = 1,024, D = 384, bf16) the forward is bound by its
25.8 GFLOP (26 us at 989 TFLOP/s; its 68 MB take 20 us at 3.35 TB/s). One
block owns 128 whole rows (LayerNorm needs a row's every column), and a
warp's 16 rows of the product's accumulators are one region, so the
LayerNorm, the ReLU and the region mean run on the accumulators in registers.
The backward of the parameters runs the row kernel once more, which writes
dh [M, D] in x's dtype (25 MB in bf16) with per-block partials of db / dscale
/ dbias, then the product dW = x^T dh in slabs over M; dx = dh W^T reads the
same dh and is launched only when x needs a gradient (never in the models:
the patch features are data). All sums across blocks are per-block partials
added in a fixed order: no atomics, the same gradients every run.

Padding contract (as in the JAX package): callers pad bags in whole 16-patch
regions; fully padded regions produce finite values that the caller zeroes
with its region mask, so their cotangent is 0.
"""
from __future__ import annotations

import torch

from . import _build
from .ln_pool import LN_EPS, S2

MAX_D = 384               # the row kernels keep a block's rows x D in registers
LAUNCHES = 0              # forward (#9) launches since the last reset
LAUNCHES_BWD_DPARAMS = 0  # parameter backward (#11: dh + sums, then dW) launches
LAUNCHES_BWD_DX = 0       # dx (#10) launches


def fused_region_embedding_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                                 scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version with the kernels' arithmetic: x and W in x's
    dtype, their product and everything after it in f32, output in x.dtype."""
    M = x.shape[0]
    h = x.float() @ w.to(x.dtype).float() + b.float()
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
    xhat = (h - mu) * torch.rsqrt(var + LN_EPS)
    y = torch.relu(xhat * scale.float() + bias.float())
    return y.reshape(M // S2, S2, -1).mean(dim=1).to(x.dtype)


def fused_region_embedding_dh_plain(g, x, w, b, scale, bias):
    """(dh, xhat, gy) in f32 for the cotangent g [M / 16, D]: the gradient at
    h = x W + b, the normalised rows and the cotangent behind the ReLU, as the
    row kernel forms them in backward mode (dh not yet rounded to x's dtype)."""
    h = x.float() @ w.to(x.dtype).float() + b.float()
    mu = h.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(((h - mu) ** 2).mean(dim=-1, keepdim=True) + LN_EPS)
    xhat = (h - mu) * inv
    g_rows = (g.float() / S2).repeat_interleave(S2, dim=0)
    gy = torch.where(xhat * scale.float() + bias.float() > 0, g_rows, torch.zeros_like(g_rows))
    gx = gy * scale.float()
    dh = inv * (gx - gx.mean(dim=-1, keepdim=True)
                - xhat * (gx * xhat).mean(dim=-1, keepdim=True))
    return dh, xhat, gy


def fused_region_embedding_bwd_plain(g, x, w, b, scale, bias):
    """The backward written out with the kernels' roundings, (dx, dW, db,
    dscale, dbias): dh is rounded to x's dtype before the two products dW =
    x^T dh and dx = dh W^T, as the TPU kernels round it (`dh.astype(x.dtype)`),
    and db is summed from the unrounded dh. In f32 it equals autograd through
    `fused_region_embedding_plain`; in bf16 autograd keeps dh in f32, so this
    is the version the bf16 kernels are held against."""
    dh, xhat, gy = fused_region_embedding_dh_plain(g, x, w, b, scale, bias)
    dh_r = dh.to(x.dtype)
    return (fused_region_embedding_bwd_dx_plain(dh_r, w),
            (x.float().t() @ dh_r.float()).to(w.dtype),
            dh.sum(dim=0).to(b.dtype), (gy * xhat).sum(dim=0).to(scale.dtype),
            gy.sum(dim=0).to(bias.dtype))


def fused_region_embedding_bwd_dx_plain(dh: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx = dh W^T from a given dh, as the dx kernel forms it: W rounded to
    dh's dtype, the sum over D in f32, one rounding to dh's dtype. Held against
    the kernel's own dh it differs from the kernel only by the order of the
    f32 sum and that last rounding (`dx_tol`). The oracle of the tests and the
    card checks; no model path calls it."""
    return (dh.float() @ w.to(dh.dtype).float().t()).to(dh.dtype)


def dx_tol(want: torch.Tensor) -> dict:
    """atol / rtol of the bf16 dx kernel against
    `fused_region_embedding_bwd_dx_plain` on the same dh: one bf16 ulp
    relative (2^-7: a sum that lands on the other side of a rounding edge),
    and 2^-8 of the largest |dx| absolute for sums that cancel. A tile that
    loses a 64-wide chunk of D is off by a share of the values themselves."""
    return dict(rtol=2.0 ** -7, atol=float(want.detach().abs().max()) / 256)


def fwd_tol(want: torch.Tensor) -> dict:
    """atol / rtol of the bf16 forward kernel against
    `fused_region_embedding_plain` on the same inputs: the same arithmetic,
    so only the order of the f32 sums and the last rounding to bf16 differ:
    one bf16 ulp relative (2^-7) and 2^-10 of the largest |out| absolute for
    region means that cancel to near 0."""
    return dict(rtol=2.0 ** -7, atol=float(want.detach().abs().max()) / 1024)


def dh_tol(want: torch.Tensor) -> dict:
    """atol / rtol of the bf16 dh (the row kernel in backward mode) against
    `fused_region_embedding_dh_plain` rounded to bf16: one bf16 ulp relative
    and 2^-10 of the largest |dh| for elements whose three terms cancel."""
    return dict(rtol=2.0 ** -7, atol=float(want.detach().abs().max()) / 1024)


def dw_tol(want: torch.Tensor) -> dict:
    """atol / rtol of the bf16 dW product against `x.float().t() @
    dh.float()` on the kernel's own dh: exact bf16 products summed in f32 in
    another order, over M terms: 2^-16 relative and 2^-16 of the largest |dW|
    absolute (the kernel used at most 0.0103 of a bound 16 times as wide on
    an H100). A slab or a 64-row chunk of M left out is off by a share of the
    values themselves."""
    return dict(rtol=2.0 ** -16, atol=float(want.detach().abs().max()) / 65536)


def _check(name: str, x, w, b, scale, bias):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {x.device}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: x must be [M, K] and w [K, D], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    (M, K), D = x.shape, w.shape[1]
    if M % S2 or K % 32 or D % 32 or not 32 <= D <= MAX_D:
        raise ValueError(f"{name}: needs M % 16 == 0, K % 32 == 0 and D a multiple of "
                         f"32 in [32, {MAX_D}], got M={M} K={K} D={D}")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    if w.dtype != torch.float32:
        raise ValueError(f"{name}: w must be float32 (parameters stay f32), got {w.dtype}")
    for t in (b, scale, bias):
        if t.shape != (D,):
            raise ValueError(f"{name}: b, scale and bias must be [D]")


def _f32(*tensors):
    return [t.detach().to(torch.float32).contiguous() for t in tensors]


def _kernel_operands(name: str, x, w, transposed: bool = False):
    """x contiguous and W rounded to x's dtype (one cast per call; the
    kernels copy both into shared memory 16 bytes at a time, so their bases
    must be aligned to 16 bytes). `transposed`: W as [D, K] for the bf16 row
    kernel, whose tensor-core B operand wants K contiguous (a copy of
    nothing when w is the transposed view of a torch Linear weight)."""
    x = x.contiguous()
    w = w.detach().to(x.dtype)
    w = (w.t() if transposed and x.dtype == torch.bfloat16 else w).contiguous()
    for t in (x, w):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor storage must be aligned to 16 bytes")
    return x, w


def fused_region_embedding_fwd(x, w, b, scale, bias) -> torch.Tensor:
    """Launch the forward kernel: [M, K] -> [M / 16, D] in x.dtype."""
    global LAUNCHES
    _check("fused_region_embedding", x, w, b, scale, bias)
    (M, K), D = x.shape, w.shape[1]
    x, w = _kernel_operands("fused_region_embedding", x, w, transposed=True)
    b, scale, bias = _f32(b, scale, bias)
    _build.require_cuda("fused_region_embedding", x, w, b, scale, bias)
    out = torch.empty((M // S2, D), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.advmil_fused_embed_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), M, K, D, _build.DTYPE_CODES[x.dtype], LN_EPS,
            _build.stream_of(x))
    _build.check(rc, "fused_region_embedding")
    LAUNCHES += 1
    return out


def fused_region_embedding_bwd_dparams(g, x, w, b, scale, bias):
    """Launch the parameter backward: (dh [M, D] in x.dtype, dW [K, D], db,
    dscale, dbias [D], all f32) for the cotangent g [M / 16, D] (taken in
    f32). dh is the gradient at h = x W + b, which `fused_region_embedding_bwd_dx`
    turns into dx."""
    global LAUNCHES_BWD_DPARAMS
    _check("fused_region_embedding_bwd_dparams", x, w, b, scale, bias)
    (M, K), D = x.shape, w.shape[1]
    if g.shape != (M // S2, D):
        raise ValueError(f"fused_region_embedding_bwd_dparams: g {tuple(g.shape)} for "
                         f"x {(M, K)} and D={D}")
    x, w = _kernel_operands("fused_region_embedding_bwd_dparams", x, w, transposed=True)
    g, b, scale, bias = _f32(g, b, scale, bias)
    _build.require_cuda("fused_region_embedding_bwd_dparams", g, x, w, b, scale, bias)
    dh = torch.empty((M, D), dtype=x.dtype, device=x.device)
    sums = torch.zeros((3, D), dtype=torch.float32, device=x.device)
    dw = torch.zeros((K, D), dtype=torch.float32, device=x.device)
    if M == 0:
        return dh, dw, sums[0], sums[1], sums[2]
    lib = _build.load()
    code = _build.DTYPE_CODES[x.dtype]
    partials = torch.empty((lib.advmil_fused_embed_row_blocks(M, code), 3, D),
                           dtype=torch.float32, device=x.device)
    slabs = lib.advmil_fused_embed_dw_slabs(M, K, D, code)
    dw_partials = torch.empty((slabs if slabs > 1 else 0, K, D), dtype=torch.float32,
                              device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.advmil_fused_embed_bwd_dh(
            g.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), dh.data_ptr(), partials.data_ptr(), sums.data_ptr(),
            M, K, D, code, LN_EPS, _build.stream_of(x))
        _build.check(rc, "fused_region_embedding_bwd_dparams (dh)")
        rc = lib.advmil_fused_embed_dw(x.data_ptr(), dh.data_ptr(), dw.data_ptr(),
                                       dw_partials.data_ptr(), M, K, D, code,
                                       _build.stream_of(x))
    _build.check(rc, "fused_region_embedding_bwd_dparams (dW)")
    LAUNCHES_BWD_DPARAMS += 1
    return dh, dw, sums[0], sums[1], sums[2]


def fused_region_embedding_bwd_dx(dh: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the dx kernel: dx [M, K] = dh W^T in dh.dtype (W rounded to
    it), from the dh of `fused_region_embedding_bwd_dparams`."""
    global LAUNCHES_BWD_DX
    if dh.device.type != "cuda":
        raise ValueError(f"fused_region_embedding_bwd_dx: needs CUDA tensors, got {dh.device}")
    if dh.dim() != 2 or w.dim() != 2 or w.shape[1] != dh.shape[1]:
        raise ValueError(f"fused_region_embedding_bwd_dx: dh must be [M, D] and w [K, D], "
                         f"got {tuple(dh.shape)} and {tuple(w.shape)}")
    (M, D), K = dh.shape, w.shape[0]
    if M % S2 or K % 32 or D % 32 or dh.dtype not in _build.DTYPE_CODES \
            or w.dtype != torch.float32:
        raise ValueError(f"fused_region_embedding_bwd_dx: unsupported M={M} K={K} D={D} "
                         f"{dh.dtype} / {w.dtype}")
    dh, w = _kernel_operands("fused_region_embedding_bwd_dx", dh, w)
    _build.require_cuda("fused_region_embedding_bwd_dx", dh, w)
    dx = torch.empty((M, K), dtype=dh.dtype, device=dh.device)
    if M == 0:
        return dx
    lib = _build.load()
    with torch.cuda.device(dh.device):
        rc = lib.advmil_fused_embed_dx(dh.data_ptr(), w.data_ptr(), dx.data_ptr(), M, K, D,
                                       _build.DTYPE_CODES[dh.dtype], _build.stream_of(dh))
    _build.check(rc, "fused_region_embedding_bwd_dx")
    LAUNCHES_BWD_DX += 1
    return dx


class FusedRegionEmbedding(torch.autograd.Function):
    """The op on the card: kernel forward, kernel backward (counterpart of the
    JAX package's `_fused_fwd` / `_fused_bwd` rules)."""

    @staticmethod
    def forward(ctx, x, w, b, scale, bias):
        ctx.save_for_backward(x, w, b, scale, bias)
        return fused_region_embedding_fwd(x, w, b, scale, bias)

    @staticmethod
    @_build.first_order
    def backward(ctx, g):
        x, w, b, scale, bias = ctx.saved_tensors
        dh, dw, db, dscale, dbias = fused_region_embedding_bwd_dparams(g, x, w, b, scale, bias)
        dx = fused_region_embedding_bwd_dx(dh, w) if ctx.needs_input_grad[0] else None
        return dx, dw.to(w.dtype), db.to(b.dtype), dscale.to(scale.dtype), dbias.to(bias.dtype)


def fused_region_embedding(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """[M, K] patches -> [M / 16, D] region embeddings (M % 16 == 0):
    mean over 16-row groups of relu(LayerNorm(x @ w + b) * scale + bias).

    x is f32 or bf16, w [K, D] f32 (flax's kernel layout). The kernels take
    K % 32 == 0 and D a multiple of 32 from 32 to 384. Differentiable in all
    five arguments on both devices.
    """
    if x.device.type == "cpu":
        return fused_region_embedding_plain(x, w, b, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_region_embedding: unsupported device {x.device}")
    return FusedRegionEmbedding.apply(x, w, b, scale, bias)
