"""Operation counts of the reference's step and evaluation of one bag, by
torch's FlopCounterMode (matrix products, forward and backward as the step
runs them, nothing recomputed). The configurations' coefficients are held
to these counts by the tests."""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from . import model as M
from . import steps as R


def _params(shapes: dict, gen) -> dict:
    return {k: (torch.rand(s, generator=gen) - 0.5) * 0.1 for k, s in shapes.items()}


def draws_for(n: int, gen, K: int = 30, kind: str = "train") -> list:
    """Random draws of a one-bag batch of n patches, in the step's order."""
    L = n // M.S2
    if kind == "eval":
        return [("rand", torch.rand(1, 192, generator=gen)),
                ("rand", torch.rand(K, 1, 192, generator=gen))]
    d = [("rand", torch.rand(1, 192, generator=gen))]
    for _ in range(2):
        d += [("rand", torch.rand(1, L, 64, generator=gen)),
              ("rand", torch.rand(1, L, 128, generator=gen)),
              ("rand", torch.rand(1, L, 128, generator=gen)),
              ("rand", torch.rand(1, 64, generator=gen))]
    d += [("rand", torch.rand(1, 8, L, L, generator=gen))]
    d += [("rand", torch.rand(1, L, 384, generator=gen)) for _ in range(5)]
    d += [("rand", torch.rand(1, 192, generator=gen)), ("rand", torch.rand(1, 192, generator=gen))]
    return d


def count(cfg: dict, shapes_g: dict, shapes_d: dict, n: int, kind: str = "train") -> int:
    gen = torch.Generator().manual_seed(n)
    ref = R.Reference(cfg, _params(shapes_g, gen), _params(shapes_d, gen), torch.device("cpu"))
    x = torch.randn(n, 1024, generator=gen)
    draws = draws_for(n, gen, kind=kind)
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            ref.train_step([(x, 0, 0.5, 1.0)], draws, 0.004, 1e-5)
        else:
            ref.eval_bag(x, 0, draws[0][1][0], draws[1][1][:, 0])
    return int(fc.get_total_flops())


def fit(counts: dict) -> dict:
    """Coefficients (per patch, per region pair, per bag) from counts at
    three or more bag sizes (multiples of 16)."""
    ns = sorted(counts)
    A = np.array([[n, (n // 16) ** 2, 1] for n in ns], np.float64)
    sol = np.linalg.lstsq(A, np.array([counts[n] for n in ns], np.float64), rcond=None)[0]
    return dict(zip(("per_patch", "per_region_pair", "per_bag"),
                    [float(round(v, 3)) for v in sol]))
