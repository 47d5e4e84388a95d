"""The attention-dropout keep mask, worked out from its seed in plain torch.

The flash kernels keep element (bh, row, col) of a [B*H, Lq, Lk] attention
map, bh = b * H + h, when word `col % 4` of

    philox4x32_10(counter=(col // 4, row, bh, 0), key=(seed_lo, seed_hi))

is at least min(floor(p * 2^32), 2^32 - 1); kept probabilities are scaled by
1 / (1 - p). Philox4x32-10 is Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3" (SC 2011), with its published multipliers and Weyl
constants. The words are held in int64 tensors masked to 32 bits.
"""
from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def threshold(p: float) -> int:
    return min(int(p * 4294967296.0), _MASK32)


def _mulhilo(m: int, x: torch.Tensor):
    t_lo = m * (x & 0xFFFF)
    t_hi = m * (x >> 16)
    mid = t_lo + ((t_hi & 0xFFFF) << 16)
    return (t_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def keep_mask(seed: int, bh: int, n: int, p: float, device) -> torch.Tensor:
    """[n, n] bool keep mask of query rows and key columns 0 .. n-1 of one
    (bag, head) slice `bh` of the stream of `seed`."""
    seed = int(seed) % (1 << 64)
    k0, k1 = seed & _MASK32, seed >> 32
    groups = (n + 3) // 4
    c0 = torch.arange(groups, dtype=torch.int64, device=device)[None, :]
    c1 = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    c0, c1 = torch.broadcast_tensors(c0, c1)
    c2 = torch.full_like(c0, bh)
    c3 = torch.zeros_like(c0)
    words = torch.stack(philox4x32_10(c0, c1, c2, c3, k0, k1), dim=-1)
    return words.reshape(n, groups * 4)[:, :n] >= threshold(p)
