"""Optimizers of the adversarial handler and the plateau LR schedule
(counterparts of the parts of `advmil_tpu/train/optim.py` that cfg_nlst
runs).

The JAX package builds Adam as optax `add_decayed_weights` (coupled L2 on
parameters with ndim > 1 only, timm's bias / norm exclusion) -> `scale_by_adam`
-> `scale_by_learning_rate`. `torch.optim.Adam`'s `weight_decay` is the same
coupled L2 (added to the gradient before the moments) and its update equals
`scale_by_adam`'s, so two parameter groups express it. The other optimizers
of the factory are ROADMAP A12.
"""
from __future__ import annotations

import torch


def adam_with_l2(params, lr: float, weight_decay: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8) -> torch.optim.Adam:
    """Adam with coupled L2 `weight_decay` on parameters with ndim > 1 only."""
    params = [p for p in params if p.requires_grad]
    decay = [p for p in params if p.ndim > 1]
    no_decay = [p for p in params if p.ndim <= 1]
    groups = [{"params": decay, "weight_decay": float(weight_decay or 0.0)},
              {"params": no_decay, "weight_decay": 0.0}]
    return torch.optim.Adam([g for g in groups if g["params"]], lr=lr,
                            betas=betas, eps=eps)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


class ReduceLROnPlateau:
    """Host-side plateau tracker, as the JAX package's: mode 'min', a relative
    threshold of 1e-4; returns the current LR multiplier, which the handler
    applies to the generator's optimizer."""

    def __init__(self, factor: float = 0.5, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0, verbose: bool = False):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.verbose = verbose
        self.best = float("inf")
        self.num_bad = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale *= self.factor
                self.num_bad = 0
                if self.verbose:
                    print(f"[lr] plateau: scaling LR by {self.factor} "
                          f"-> x{self.scale}")
        return self.scale
