"""Weight bridge between flax parameter trees and the port's state_dicts.

A flax tree is a nested dict of numpy arrays (what `flax.serialization`
produces, or `load_npz` reads). The port's modules carry the flax names as
attribute names, so a path maps onto a state_dict key by joining with '.',
with these rules:

- Dense `kernel [in, out]` becomes `weight [out, in]`;
- Conv `kernel [kh, kw, in, out]` (flax's HWIO; the ksize-3 patch embedding's
  `Conv_0`) becomes `weight [out, in, kh, kw]` (torch's OIHW);
- LayerNorm `scale` becomes `weight`;
- the packed attention `in_proj` keeps q | k | v on the output axis (the
  same packing as torch's `in_proj_weight`), so it needs no reordering;
- the generator's head subtree is `head` in flax and `head_mlp` in torch
  (`head` is the Generator's method there);
- DeepAttnMISL's `phis`, `attn_fc` and `gate/attention_{a,b,c}` are
  Dense layers under the same names on both sides;
- GENConv's temperature `t [1]` keeps its name. PatchGCN's per-graph
  layers run under `nn.vmap` with shared parameters in flax, so their trees
  (`layer0_conv/{t, mlp0, mlp_norm, mlp1}`, `layer{i}/conv/...`,
  `layer{i}/norm`) carry no batch axis and map one to one.

Trees come from numpy dicts, `.npz` files or the JAX package's msgpack
`.ckpt` (`utils/flax_msgpack.py`, read by `train/checkpoint.py`), whose
bfloat16 leaves are torch tensors.

The optimizer state of such a checkpoint maps onto the port's optimizer
(`adam_state_from_flax`) for Adam, the optimizer of every shipped config
(G: coupled L2 on the matrices; D: plain; the baseline's `opt_net`): optax's
`scale_by_adam` state `mu` / `nu` / `count` becomes torch's `exp_avg` /
`exp_avg_sq` / `step` per parameter, and the learning rate that
`optax.inject_hyperparams` carries becomes the groups' `lr`. Other
optimizers, and the one fused vector of `opt_flatten: true`, are refused
(ROADMAP A1 rest).
"""
from __future__ import annotations

import numpy as np
import torch

_TOP_RENAME = {"head": "head_mlp"}
_TOP_RENAME_BACK = {v: k for k, v in _TOP_RENAME.items()}


def _flatten(tree: dict, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def flax_to_torch(params: dict) -> dict:
    """Nested flax params (numpy leaves) -> torch state_dict (f32 tensors)."""
    sd = {}
    for path, arr in _flatten(params).items():
        if isinstance(arr, torch.Tensor):          # a bfloat16 leaf of a .ckpt
            arr = arr.float().numpy()
        arr = np.asarray(arr, dtype=np.float32)
        *mods, leaf = path
        mods = [_TOP_RENAME.get(mods[0], mods[0])] + mods[1:] if mods else mods
        if leaf == "kernel":
            if arr.ndim not in (2, 4):
                raise ValueError(f"{'/'.join(path)}: only Dense and 2-D Conv kernels "
                                 f"are bridged, got shape {arr.shape}")
            leaf, arr = "weight", (arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1))
        elif leaf == "scale":
            leaf = "weight"
        elif leaf not in ("bias", "t"):
            raise ValueError(f"unknown flax leaf {'/'.join(path)}")
        sd[".".join(mods + [leaf])] = torch.tensor(np.ascontiguousarray(arr))
    return sd


def torch_to_flax(state_dict: dict) -> dict:
    """torch state_dict -> nested flax params with numpy f32 leaves."""
    flat = {}
    for key, t in state_dict.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        *mods, leaf = key.split(".")
        if mods:
            mods[0] = _TOP_RENAME_BACK.get(mods[0], mods[0])
        if leaf == "weight":
            if arr.ndim == 2:
                leaf, arr = "kernel", np.ascontiguousarray(arr.T)
            elif arr.ndim == 4:
                leaf, arr = "kernel", np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
            else:
                leaf = "scale"
        flat[tuple(mods + [leaf])] = arr
    return _unflatten(flat)


def save_npz(path: str, params: dict) -> None:
    """Save a nested params tree as an .npz with '/'-joined keys."""
    np.savez(path, **{"/".join(p): np.asarray(v)
                      for p, v in _flatten(params).items()})


def load_npz(path: str) -> dict:
    with np.load(path) as z:
        return _unflatten({tuple(k.split("/")): z[k] for k in z.files})



def _adam_entry(tree: dict, name: str) -> tuple[dict, float | None]:
    """(optax `scale_by_adam` state, injected learning rate or None) of a
    JAX optimizer state: `optax.inject_hyperparams` around a chain whose
    entries ("0", "1", ...) are the L2 decay's (empty), Adam's and the
    learning rate's (empty). Anything else raises, naming `name`."""
    refuse = (f"resuming optimizer {name!r} from a JAX package checkpoint is not "
              "ported (ROADMAP A1 rest): the port maps Adam's state only")
    lr = None
    if "hyperparams" in tree and "inner_state" in tree:
        lr = float(np.asarray(tree["hyperparams"]["learning_rate"]))
        tree = tree["inner_state"]
    if not isinstance(tree, dict) or not all(k.isdigit() for k in tree):
        raise NotImplementedError(refuse)
    adam = [v for v in tree.values() if isinstance(v, dict) and v.get("mu") is not None]
    rest = [v for v in tree.values() if not (isinstance(v, dict) and v.get("mu") is not None)]
    if (len(adam) != 1 or set(adam[0]) != {"count", "mu", "nu"}
            or any(v not in ({}, {"inner_state": {}}) for v in rest)):
        raise NotImplementedError(refuse)
    if not isinstance(adam[0]["mu"], dict):
        raise NotImplementedError(
            f"optimizer {name!r}: the checkpoint was saved with opt_flatten: true (one "
            "fused moment vector), which the port does not map (ROADMAP A1 rest); "
            "train the JAX run with opt_flatten: false")
    return adam[0], lr


def adam_state_from_flax(opt_state: dict, optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module, name: str) -> dict:
    """`optimizer.state_dict()` with the JAX Adam state of `opt_state` (a
    flax state dict of the optimizer that stepped `model`'s parameters, as
    the JAX handlers build it) in place of its own: exp_avg / exp_avg_sq in
    torch's layout, step = optax's count, and the injected learning rate on
    every group. Raises before anything is loaded when `optimizer` is not
    torch's Adam or the state is not an unflattened Adam's."""
    if type(optimizer) is not torch.optim.Adam:
        raise NotImplementedError(
            f"resuming optimizer {name!r} from a JAX package checkpoint is not ported "
            "(ROADMAP A1 rest): the port maps Adam's state only")
    adam, lr = _adam_entry(opt_state, name)
    mu, nu = flax_to_torch(adam["mu"]), flax_to_torch(adam["nu"])
    step = float(np.asarray(adam["count"]))
    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    named = {n: p for n, p in model.named_parameters() if id(p) in index}
    if set(named) != set(mu):
        raise ValueError("the checkpoint's Adam moments do not match the model's "
                         f"parameters: {sorted(set(named) ^ set(mu))[:5]}")
    sd = optimizer.state_dict()
    sd["state"] = {index[id(p)]: {"step": torch.tensor(step, dtype=torch.float32),
                                  "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                   for n, p in named.items()}
    if lr is not None:
        for g in sd["param_groups"]:
            g["lr"] = lr
    return sd
