"""The attention-dropout random stream: Philox4x32-10, per element.

The TPU kernels draw their keep masks from the TPU core PRNG per tile
(`advmil_tpu/ops/attention.py::_dropout_keep`); those bits cannot be
reproduced off the TPU. The port defines its own stream, per element and
independent of any tiling: element (bh, row, col) of a [BH, Lq, Lk] attention
map takes word `col % 4` of

    philox4x32_10(counter=(col // 4, row, bh, 0), key=(seed_lo, seed_hi))

and is kept when that word is >= `threshold(p)` (the TPU kernel's rule,
`attention.py:77`); kept probabilities are scaled by 1 / (1 - p). The flash
kernels (`csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`) regenerate it from
`csrc/philox.cuh`; `keep_mask` materialises it (the tests' oracle, kernel
`csrc/keep_mask.cu`), and `keep_mask_plain` computes it in plain torch on
int64 tensors masked to 32 bits, on any device.
"""
from __future__ import annotations

import torch

from . import _build

LAUNCHES = 0     # keep-mask kernel launches since the last reset
_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def threshold(p: float) -> int:
    """Keep when bits >= this: min(floor(p * 2^32), 2^32 - 1)."""
    return min(int(p * 4294967296.0), _MASK32)


def split_seed(seed: int) -> tuple[int, int]:
    """A 64-bit seed as the key words (lo, hi)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"dropout seed must lie in [0, 2^64), got {seed}")
    return seed & _MASK32, seed >> 32


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of m * x for uint32 values held in int64: x is
    split into 16-bit halves so no product leaves int64."""
    t_lo = m * (x & 0xFFFF)                      # < 2^48
    t_hi = m * (x >> 16)                         # < 2^48
    mid = t_lo + ((t_hi & 0xFFFF) << 16)         # < 2^49
    return (t_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors (broadcastable) holding uint32 values;
    keys are Python ints. Returns the four output words as int64 tensors."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def dropout_bits(seed: int, BH: int, Lq: int, Lk: int,
                 device=None) -> torch.Tensor:
    """The [BH, Lq, Lk] random words (int64 holding uint32) of the stream."""
    k0, k1 = split_seed(seed)
    groups = (Lk + 3) // 4
    c0 = torch.arange(groups, dtype=torch.int64, device=device)[None, None, :]
    c1 = torch.arange(Lq, dtype=torch.int64, device=device)[None, :, None]
    c2 = torch.arange(BH, dtype=torch.int64, device=device)[:, None, None]
    c3 = torch.zeros((), dtype=torch.int64, device=device)
    c0, c1, c2 = torch.broadcast_tensors(c0, c1, c2)
    words = torch.stack(philox4x32_10(c0, c1, c2, c3, k0, k1), dim=-1)
    return words.reshape(BH, Lq, groups * 4)[..., :Lk]


def keep_mask_plain(seed: int, BH: int, Lq: int, Lk: int, p: float,
                    device=None) -> torch.Tensor:
    """Plain version of the keep mask: [BH, Lq, Lk] f32 0/1."""
    return (dropout_bits(seed, BH, Lq, Lk, device) >= threshold(p)).to(torch.float32)


def keep_mask(seed: int, BH: int, Lq: int, Lk: int, p: float,
              device=None) -> torch.Tensor:
    """[BH, Lq, Lk] f32 0/1 keep mask of the stream. On a CUDA device the
    kernel `csrc/keep_mask.cu` writes it; on the CPU the plain version."""
    global LAUNCHES
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cpu":
        return keep_mask_plain(seed, BH, Lq, Lk, p, device)
    if device.type != "cuda":
        raise ValueError(f"keep_mask: unsupported device {device}")
    if min(BH, Lq, Lk) <= 0:
        raise ValueError(f"keep_mask: empty shape {(BH, Lq, Lk)}")
    lo, hi = split_seed(seed)
    out = torch.empty((BH, Lq, Lk), dtype=torch.float32, device=device)
    lib = _build.load()
    with torch.cuda.device(device):
        rc = lib.advmil_keep_mask(out.data_ptr(), BH, Lq, Lk, lo, hi, threshold(p),
                                  _build.stream_of(out))
    _build.check(rc, "keep_mask")
    LAUNCHES += 1
    return out


def check_against_curand(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(ours, curand) [n, 4] words of `csrc/philox.cuh` and of the toolkit's
    `curand_Philox4x32_10` on the same counters and keys (card only)."""
    ours = torch.empty((n, 4), dtype=torch.int32, device=device)
    ref = torch.empty((n, 4), dtype=torch.int32, device=device)
    lib = _build.load()
    with torch.cuda.device(ours.device):
        rc = lib.advmil_philox_check(ours.data_ptr(), ref.data_ptr(), n,
                                     _build.stream_of(ours))
    _build.check(rc, "philox_check")
    return ours, ref
