"""Checkpoints of the port: one torch file per network, `{epoch, params,
opt_state}` with `params` a state_dict and `opt_state` the optimizer's
state_dict (or None), under the JAX package's naming contract
`{run}_model{G|D}-{best|last}.ckpt`.

`restore_checkpoint` also reads the JAX package's files: its default
`ckpt_backend: msgpack` writes `flax.serialization.msgpack_serialize` of
`{epoch, params, opt_state}` (flax state dicts), read here by the port's own
decoder (`utils/flax_msgpack.py`); the parameters come back as a state_dict
through `bridge.flax_to_torch`, the optimizer state as a `FlaxOptState`,
which `optimizer_state` maps onto the port's optimizer
(`bridge.opt_state_from_flax`: every optimizer name, `lookahead_`,
MultiSteps and AdaHessian, per leaf or fused by `opt_flatten`). The format
is told from the file's first bytes. Its `ckpt_backend: orbax` writes a
directory per checkpoint (`_METADATA` and an OCDBT store of zarr arrays),
read by `utils/orbax_ckpt.py` into the same bundle as the msgpack file of
the same state, and mapped the same way. The port itself writes torch files
whatever `ckpt_backend` says: the JAX package reads neither of the port's
formats.
"""
from __future__ import annotations

import os
import os.path as osp

import torch

from .. import bridge
from ..utils import flax_msgpack, orbax_ckpt

_TORCH_ZIP = b"PK\x03\x04"


class FlaxOptState(dict):
    """The optimizer state of a JAX package checkpoint: its flax state dict
    (nested dicts of numpy arrays)."""


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
    """(epoch, state_dict on CPU, optimizer state or None): the port's
    optimizer state_dict, or a `FlaxOptState` from a JAX package file or
    orbax directory."""
    if osp.isdir(path):
        bundle = orbax_ckpt.read(path)
    else:
        with open(path, "rb") as f:
            head = f.read(4)
        if head == _TORCH_ZIP:
            bundle = torch.load(path, map_location="cpu", weights_only=True)
            return int(bundle["epoch"]), bundle["params"], bundle.get("opt_state")
        if not flax_msgpack.is_msgpack_map(head):
            raise ValueError(f"{path}: neither a torch checkpoint nor a JAX package "
                             f"msgpack checkpoint (first bytes {head!r})")
        bundle = flax_msgpack.read(path)
    opt = bundle.get("opt_state")
    return (int(bundle["epoch"]), bridge.flax_to_torch(bundle["params"]),
            None if opt is None else FlaxOptState(opt))


def optimizer_state(opt_state, optimizer, model: torch.nn.Module, name: str) -> dict:
    """The state_dict to load into `optimizer` (which steps `model`'s
    parameters) from a checkpoint's optimizer state: the port's as it is, a
    JAX package's mapped through the bridge (`name` is the config's
    optimizer name; a state the bridge does not recognise raises here)."""
    if isinstance(opt_state, FlaxOptState):
        return bridge.opt_state_from_flax(opt_state, optimizer, model, name)
    if opt_state is None:
        raise ValueError("the checkpoint holds no optimizer state")
    return opt_state
