"""Framework-generic utilities of the ported slices.

Copies of `advmil_tpu.utils.func` (config scraping, occlusion masking, early
stopping, the printed-artifact formats, seeding), kept here so the port never
imports the JAX package. Behaviour is identical, including the order of RNG
draws.
"""
from __future__ import annotations

import os.path as osp
import random
import sys

import numpy as np


def sparse_key(d: dict, prefixes: str = "") -> dict:
    """Strip ``prefixes`` + '_' off matching keys: {'gen_noi_hops': 1} with
    prefixes='gen_noi' -> {'hops': 1}."""
    if prefixes == "":
        return d
    ret = {}
    for k in d.keys():
        if k.startswith(prefixes):
            new_key = k.split(prefixes)[1]
            if len(new_key) < 2:
                continue
            ret[new_key[1:]] = d[k]
    return ret


def sparse_str(s, sep: str = "-", dtype=int) -> list:
    """'1024-384-384' -> [1024, 384, 384]; non-strings pass through as [s]."""
    if not isinstance(s, str):
        return [s]
    return [dtype(p) for p in s.split(sep)]


def rename_keys(d: dict, prefix_name: str, sep: str = "/") -> dict:
    return {prefix_name + sep + k: v for k, v in d.items()}


def add_prefix_to_filename(path: str, prefix: str = "") -> str:
    dir_name, file_name = osp.split(path)
    return osp.join(dir_name, prefix + "_" + file_name)


def random_mask_square_instance(bag: np.ndarray, mask_ratio: float, scale: int = 4,
                                mask_way: str = "mask_zero",
                                rng: np.random.Generator | None = None) -> np.ndarray:
    """Zero (or discard) whole 4x4-aligned regions of a bag for robustness eval."""
    if mask_ratio <= 0 or mask_ratio > 1:
        return bag
    N = bag.shape[0]
    n_square = scale * scale
    assert N % n_square == 0, "bag must consist of square instances."
    N_scaled = N // n_square
    n_keep = max(1, int(N_scaled * (1 - mask_ratio)))
    perm = (rng.permutation(N_scaled) if rng is not None
            else np.random.permutation(N_scaled))
    idxs_keep = np.sort(perm[:n_keep])
    idxs_keep = (idxs_keep.reshape(-1, 1) * n_square
                 + np.arange(n_square).reshape(1, -1)).reshape(-1)
    if mask_way == "discard":
        return bag[idxs_keep]
    if mask_way == "mask_zero":
        new_bag = np.zeros_like(bag)
        new_bag[idxs_keep] = bag[idxs_keep]
        return new_bag
    raise NotImplementedError(f"Cannot run with mask_way={mask_way}.")


class EarlyStopping:
    """Stops training when the monitored value does not improve (reference
    utils/func.py:300-353, as `advmil_tpu.utils.func.EarlyStopping`).

    score = -val_loss; no tracking during `warmup` epochs; an improvement
    needs score - 1e-6 >= best; stopping needs counter >= patience and
    epoch > start_epoch.
    """

    def __init__(self, warmup: int = 5, patience: int = 15, start_epoch: int = 0,
                 verbose: bool = False):
        self.warmup = warmup
        self.patience = patience
        self.start_epoch = start_epoch
        self.verbose = verbose
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.save_checkpoint = False
        self.val_loss_min = np.inf

    def __call__(self, epoch: int, val_loss: float):
        self.save_checkpoint = False
        score = -val_loss
        if epoch < self.warmup:
            pass
        elif self.best_score is None:
            self.best_score = score
            self._update(val_loss)
        elif score - 1e-6 < self.best_score:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} out of {self.patience}")
            if self.counter >= self.patience and epoch > self.start_epoch:
                self.early_stop = True
        else:
            self.best_score = score
            self._update(val_loss)
            self.counter = 0

    def if_stop(self) -> bool:
        return self.early_stop

    def if_save_checkpoint(self) -> bool:
        return self.save_checkpoint

    def _update(self, val_loss: float):
        if self.verbose:
            print(f"Validation loss decreased ({self.val_loss_min:.6f} --> "
                  f"{val_loss:.6f}).  Saving model ...")
        self.val_loss_min = val_loss
        self.save_checkpoint = True


def seed_everything(seed: int):
    """Seed the host-side RNGs. Model init and noise use explicit
    torch.Generators derived from the same seed."""
    random.seed(seed)
    np.random.seed(seed)
    print(f"[setup] seed: {seed}")


def print_config(config: dict, print_to_path: str | None = None):
    f = open(print_to_path, "w") if print_to_path is not None else sys.stdout
    print("**************** MODEL CONFIGURATION ****************", file=f)
    for key in sorted(config.keys()):
        val = config[key]
        keystr = f"{key}" + (" " * (24 - len(key)))
        print(f"{keystr} -->   {val}", file=f)
    print("**************** MODEL CONFIGURATION ****************", file=f)
    if print_to_path is not None:
        f.close()


def print_metrics(metrics: dict, print_to_path: str | None = None):
    f = open(print_to_path, "w") if print_to_path is not None else sys.stdout
    print("**************** MODEL METRICS ****************", file=f)
    for key in sorted(metrics.keys()):
        for v in metrics[key]:
            cur_key = key + "/" + v[0]
            keystr = f"{cur_key}" + (" " * (20 - len(cur_key)))
            valstr = f"{v[1]}"
            if isinstance(v[1], list):
                valstr = "{}, avg/std = {:.5f}/{:.5f}".format(
                    valstr, np.mean(v[1]), np.std(v[1]))
            print(f"{keystr} -->   {valstr}", file=f)
    print("**************** MODEL METRICS ****************", file=f)
    if print_to_path is not None:
        f.close()
