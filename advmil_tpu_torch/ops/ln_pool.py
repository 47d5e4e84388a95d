"""Fused LayerNorm -> ReLU -> 16-row region mean, forward and backward.

Counterpart of `advmil_tpu/ops/ln_pool.py::ln_relu_region_mean`. The ESAT and
discriminator patch embeddings are Dense -> LayerNorm -> ReLU -> mean over
each 4x4 region; the matmul stays with torch and this op reads the pre-LN
rows once and writes only the 16x smaller pooled output.

Dispatch: a CPU tensor goes to `ln_relu_region_mean_plain` (autograd through
plain torch ops); a CUDA tensor goes to `LnReluRegionMean`, whose forward and
backward are the hand-written kernels of `csrc/ln_pool.cu`, or raises. There
is no fallback from the kernels to the plain version.

Padding contract (as in the JAX package): callers pad bags in whole 16-patch
regions; fully padded regions produce finite values that the caller zeroes
with its region mask.

`ln_relu` is the same normalisation without the pool (counterpart of
`advmil_tpu/ops/ln_pool.py::ln_relu`): [M, D] -> [M, D], any M, the
`POOL = false` instantiation of the same two kernels. As in the JAX package
it is a public op with its own gradient that no model calls.
"""
from __future__ import annotations

import torch

from . import _build

S2 = 16          # patches per region (4x4)
LN_EPS = 1e-6    # flax LayerNorm default
LAUNCHES = 0      # forward kernel launches since the last reset (chip_smoke reads it)
LAUNCHES_BWD = 0  # backward kernel launches since the last reset
LAUNCHES_BY_D: dict = {}      # the same two counts by row width D
LAUNCHES_BWD_BY_D: dict = {}
LAUNCHES_LNRELU = 0      # ln_relu forward launches
LAUNCHES_LNRELU_BWD = 0  # ln_relu backward launches


def ln_relu_region_mean_plain(h: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 LN statistics like flax, output in h.dtype."""
    M, D = h.shape
    hf = h.float()
    mu = hf.mean(dim=-1, keepdim=True)
    var = ((hf - mu) ** 2).mean(dim=-1, keepdim=True)
    xhat = (hf - mu) * torch.rsqrt(var + LN_EPS)
    y = torch.relu(xhat * scale.float() + bias.float())
    return y.reshape(M // S2, S2, D).mean(dim=1).to(h.dtype)


def fwd_tol(want: torch.Tensor) -> dict:
    """atol / rtol of the bf16 forward kernel's pooled rows against the plain
    version's on the same bf16 h (`ln_relu_region_mean_plain`, rounded to
    bf16 once). Both compute the statistics, the normalised rows and their
    16-row sum in f32 and round once; only the order of the f32 sums differs.
    So a value may land one bf16 ulp away, on the other side of a rounding
    edge (2^-7 relative), and a pooled value near 0 keeps the f32 noise of
    the statistics behind it (2^-12 of the largest |out| absolute: about a
    thousand times that noise at unit-scale rows). A row of a region, columns
    left out of the mean, or the variance taken without its mean moves a value
    by a share of the values themselves; eps dropped breaks rows of equal
    values. The same bound holds `ln_relu` (#3) on its rows."""
    return dict(rtol=2.0 ** -7, atol=float(want.detach().abs().max()) / 4096)


def bwd_tol(want: torch.Tensor) -> dict:
    """atol / rtol of the bf16 backward kernel's dh against the plain
    version's on the same bf16 h and g (`ln_relu_region_mean_plain` and its
    autograd backward, whose dh is rounded to bf16 once). Both compute dh in
    f32 and round once; only the order of the f32 sums (mean, variance and the
    two means of the gradient) differs. So a value may land one bf16 ulp away,
    on the other side of a rounding edge (2^-7 relative), and a dh whose terms
    cancel to near 0 keeps their f32 noise (2^-10 of the largest |dh|
    absolute). A term of the gradient dropped moves dh by a share of that term.
    Where a ReLU input lies within f32 noise of 0, the two may take the ReLU
    mask differently: callers zero the cotangent of such regions first."""
    return dict(rtol=2.0 ** -7, atol=float(want.detach().abs().max()) / 1024)


def _check(name: str, h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           pool: bool = True):
    if h.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {h.device}")
    if h.dim() != 2:
        raise ValueError(f"{name}: h must be [M, D], got {tuple(h.shape)}")
    M, D = h.shape
    if (pool and M % S2) or D % 32 or not 32 <= D <= 1024:
        raise ValueError(f"{name}: needs {'M % 16 == 0 and ' if pool else ''}D a "
                         f"multiple of 32 in [32, 1024], got {(M, D)}")
    if h.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {h.dtype}")
    if scale.shape != (D,) or bias.shape != (D,):
        raise ValueError(f"{name}: scale and bias must be [D]")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned: the forward kernels read 8- or
    16-byte pieces of a row where D % 128 == 0, and the backward kernels stage
    their rows by 16-byte copies (a view at an odd offset is copied once)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ln_relu_region_mean_fwd(h: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: [M, D] -> [M/16, D] in h.dtype."""
    global LAUNCHES
    _check("ln_relu_region_mean", h, scale, bias)
    M, D = h.shape
    h = _aligned(h)
    scale, bias = _aligned(scale.to(torch.float32)), _aligned(bias.to(torch.float32))
    _build.require_cuda("ln_relu_region_mean", h, scale, bias)
    out = torch.empty((M // S2, D), dtype=h.dtype, device=h.device)
    if M == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(h.device):
        rc = lib.advmil_ln_relu_region_mean(
            h.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            M, D, _build.DTYPE_CODES[h.dtype], LN_EPS, _build.stream_of(h))
    _build.check(rc, "ln_relu_region_mean")
    LAUNCHES += 1
    LAUNCHES_BY_D[D] = LAUNCHES_BY_D.get(D, 0) + 1
    return out


def ln_relu_region_mean_bwd(g: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor):
    """Launch the backward kernel: (dh [M, D] in h.dtype, dscale [D] f32,
    dbias [D] f32) for the cotangent g [M/16, D]. The kernel reads g in its
    storage dtype (f32 or bf16; another dtype is cast to f32) and converts it
    to f32 exactly, as the TPU rule `_bwd_rule` takes it."""
    global LAUNCHES_BWD
    _check("ln_relu_region_mean_bwd", h, scale, bias)
    M, D = h.shape
    if g.shape != (M // S2, D):
        raise ValueError(f"ln_relu_region_mean_bwd: g {tuple(g.shape)} for h {(M, D)}")
    if g.dtype not in _build.DTYPE_CODES:
        g = g.to(torch.float32)
    g, h = _aligned(g), _aligned(h)
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    _build.require_cuda("ln_relu_region_mean_bwd", g, h, scale, bias)
    dh = torch.empty_like(h)
    if M == 0:
        return (dh, *(torch.zeros(D, dtype=torch.float32, device=h.device) for _ in range(2)))
    # the kernel writes every column of dscale / dbias: no fill launches
    dscale = torch.empty(D, dtype=torch.float32, device=h.device)
    dbias = torch.empty(D, dtype=torch.float32, device=h.device)
    lib = _build.load()
    nblocks = lib.advmil_ln_pool_bwd_blocks(M)
    partials = torch.empty((2, nblocks, D), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = lib.advmil_ln_relu_region_mean_bwd(
            g.data_ptr(), h.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            dh.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), partials.data_ptr(),
            M, D, _build.DTYPE_CODES[h.dtype], _build.DTYPE_CODES[g.dtype], LN_EPS,
            _build.stream_of(h))
    _build.check(rc, "ln_relu_region_mean_bwd")
    LAUNCHES_BWD += 1
    LAUNCHES_BWD_BY_D[D] = LAUNCHES_BWD_BY_D.get(D, 0) + 1
    return dh, dscale, dbias


class LnReluRegionMean(torch.autograd.Function):
    """The op on the card: kernel forward, kernel backward (counterpart of the
    JAX package's `jax.custom_vjp` rules `_fwd_rule` / `_bwd_rule`)."""

    @staticmethod
    def forward(ctx, h, scale, bias):
        ctx.save_for_backward(h, scale, bias)
        return ln_relu_region_mean_fwd(h, scale, bias)

    @staticmethod
    @_build.first_order
    def backward(ctx, g):
        h, scale, bias = ctx.saved_tensors
        dh, dscale, dbias = ln_relu_region_mean_bwd(g, h, scale, bias)
        return dh, dscale.to(scale.dtype), dbias.to(bias.dtype)


def ln_relu_region_mean(h: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """[M, D] pre-LN rows -> [M/16, D] pooled regions (M % 16 == 0).

    mean over 16-row groups of relu(LayerNorm(h) * scale + bias), LN
    statistics in f32 with eps 1e-6. h is f32 or bf16; the kernels take any D
    that is a multiple of 32 from 32 to 1024. Differentiable in h, scale and
    bias on both devices.
    """
    if h.device.type == "cpu":
        return ln_relu_region_mean_plain(h, scale, bias)
    if h.device.type != "cuda":
        raise ValueError(f"ln_relu_region_mean: unsupported device {h.device}")
    return LnReluRegionMean.apply(h, scale, bias)


# ---------------------------------------------------------------------------
# ln_relu: the same LayerNorm -> ReLU without the region mean
# ---------------------------------------------------------------------------

def ln_relu_plain(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 LN statistics like flax, output in h.dtype."""
    hf = h.float()
    mu = hf.mean(dim=-1, keepdim=True)
    var = ((hf - mu) ** 2).mean(dim=-1, keepdim=True)
    xhat = (hf - mu) * torch.rsqrt(var + LN_EPS)
    return torch.relu(xhat * scale.float() + bias.float()).to(h.dtype)


def ln_relu_fwd(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: [M, D] -> [M, D] in h.dtype."""
    global LAUNCHES_LNRELU
    _check("ln_relu", h, scale, bias, pool=False)
    M, D = h.shape
    h = _aligned(h)
    scale, bias = _aligned(scale.to(torch.float32)), _aligned(bias.to(torch.float32))
    _build.require_cuda("ln_relu", h, scale, bias)
    out = torch.empty_like(h)
    if M == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(h.device):
        rc = lib.advmil_ln_relu(h.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                out.data_ptr(), M, D, _build.DTYPE_CODES[h.dtype],
                                LN_EPS, _build.stream_of(h))
    _build.check(rc, "ln_relu")
    LAUNCHES_LNRELU += 1
    return out


def ln_relu_bwd(g: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor):
    """Launch the backward kernel: (dh [M, D] in h.dtype, dscale [D] f32,
    dbias [D] f32). The cotangent g [M, D] is read in h's dtype: a full-size
    cotangent is the backward's largest read, so it is not upcast in device
    memory (as `_lnrelu_bwd_rule` of the JAX package keeps it)."""
    global LAUNCHES_LNRELU_BWD
    _check("ln_relu_bwd", h, scale, bias, pool=False)
    M, D = h.shape
    if g.shape != h.shape:
        raise ValueError(f"ln_relu_bwd: g {tuple(g.shape)} for h {(M, D)}")
    g, h = _aligned(g.to(h.dtype)), _aligned(h)
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    _build.require_cuda("ln_relu_bwd", g, h, scale, bias)
    dh = torch.empty_like(h)
    if M == 0:
        return (dh, *(torch.zeros(D, dtype=torch.float32, device=h.device) for _ in range(2)))
    # the kernel writes every column of dscale / dbias: no fill launches
    dscale = torch.empty(D, dtype=torch.float32, device=h.device)
    dbias = torch.empty(D, dtype=torch.float32, device=h.device)
    lib = _build.load()
    nblocks = lib.advmil_ln_pool_bwd_blocks(M)
    partials = torch.empty((2, nblocks, D), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = lib.advmil_ln_relu_bwd(
            g.data_ptr(), h.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            dh.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), partials.data_ptr(),
            M, D, _build.DTYPE_CODES[h.dtype], LN_EPS, _build.stream_of(h))
    _build.check(rc, "ln_relu_bwd")
    LAUNCHES_LNRELU_BWD += 1
    return dh, dscale, dbias


class LnRelu(torch.autograd.Function):
    """ln_relu on the card: kernel forward, kernel backward (counterpart of
    the JAX package's `_lnrelu_fwd_rule` / `_lnrelu_bwd_rule`)."""

    @staticmethod
    def forward(ctx, h, scale, bias):
        ctx.save_for_backward(h, scale, bias)
        return ln_relu_fwd(h, scale, bias)

    @staticmethod
    @_build.first_order
    def backward(ctx, g):
        h, scale, bias = ctx.saved_tensors
        dh, dscale, dbias = ln_relu_bwd(g, h, scale, bias)
        return dh, dscale.to(scale.dtype), dbias.to(bias.dtype)


def ln_relu(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(LayerNorm(h) * scale + bias) over the last axis of [M, D], LN
    statistics in f32 with eps 1e-6, output in h.dtype (f32 or bf16). The
    kernels take any M and any D that is a multiple of 32 from 32 to 1024.
    Differentiable in h, scale and bias on both devices."""
    if h.device.type == "cpu":
        return ln_relu_plain(h, scale, bias)
    if h.device.type != "cuda":
        raise ValueError(f"ln_relu: unsupported device {h.device}")
    return LnRelu.apply(h, scale, bias)
