"""Checkpoints of the port: one torch file per network, `{epoch, params,
opt_state}` with `params` a state_dict and `opt_state` the optimizer's
state_dict (or None), under the JAX package's naming contract
`{run}_model{G|D}-{best|last}.ckpt`. Test mode reads only `params`."""
from __future__ import annotations

import os
import os.path as osp

import torch


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu")
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, epoch: int, state_dict: dict,
                    opt_state: dict | None = None) -> None:
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    torch.save({"epoch": int(epoch), "params": _to_cpu(state_dict),
                "opt_state": _to_cpu(opt_state)}, path)


def restore_checkpoint(path: str) -> tuple[int, dict, dict | None]:
    """(epoch, state_dict on CPU, optimizer state_dict on CPU or None)."""
    bundle = torch.load(path, map_location="cpu", weights_only=True)
    return int(bundle["epoch"]), bundle["params"], bundle.get("opt_state")
