"""Checkpoints of the port: one torch file per network, `{epoch, params}`
with `params` a state_dict, under the JAX package's naming contract
`{run}_model{G|D}-{best|last}.ckpt`. Optimizer state joins with the training
slice (ROADMAP A9)."""
from __future__ import annotations

import os
import os.path as osp

import torch


def save_checkpoint(path: str, epoch: int, state_dict: dict) -> None:
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    params = {k: v.detach().to("cpu") for k, v in state_dict.items()}
    torch.save({"epoch": int(epoch), "params": params}, path)


def restore_checkpoint(path: str) -> tuple[int, dict]:
    """(epoch, state_dict on CPU)."""
    bundle = torch.load(path, map_location="cpu", weights_only=True)
    return int(bundle["epoch"]), bundle["params"]
