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

Reading the JAX package's msgpack `.ckpt` without flax is ROADMAP A1; until
then trees come from numpy dicts or `.npz` files.
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

