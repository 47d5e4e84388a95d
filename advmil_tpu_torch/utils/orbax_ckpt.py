"""A reader of the checkpoints the JAX package writes with `ckpt_backend:
orbax` (`orbax.checkpoint.PyTreeCheckpointer`, a directory per checkpoint),
with neither orbax nor tensorstore.

The directory holds `_METADATA` (JSON: the layout flags and `tree_metadata`,
one entry per leaf of the saved tree), `_CHECKPOINT_METADATA`, and an OCDBT
store (`manifest.ocdbt` at the root, merged from `ocdbt.process_<i>/`) in
which each array leaf is a zarr v2 array named by its tree path joined with
`.`. The tree is rebuilt from `tree_metadata`: each entry's `key_metadata`
gives its path of dict keys (`key_type` 2; the JAX package saves flax state
dicts, which hold no sequences), never the store key, since a key may hold
a `.`; its `value_metadata.value_type` says what the leaf is:

- `np.ndarray`: the zarr array (`utils/zarr2.py`);
- `scalar` (a Python or numpy scalar): the 0-d zarr array as a Python
  number, as orbax restores it (the bundle's `epoch`);
- `Dict`, `None`: an empty dict (an optax `EmptyState`) or None; these
  are not stored.

The result is `utils/flax_msgpack.py::read`'s for the same bundle: the same
keys at every level, dtypes and bytes, `{}` and `None` included (the bridge
finds optax states by position, so an `EmptyState` slot must stay).

Only the layout the JAX package writes is read: `use_ocdbt: true` and
`use_zarr3: false` in `_METADATA`; another raises naming the key.
"""
from __future__ import annotations

import json
import os.path as osp

from . import zarr2
from .ocdbt import OcdbtStore

_ARRAYS = ("np.ndarray", "scalar")
_EMPTY = {"Dict": dict, "None": lambda: None}
_LAYOUT = {"use_ocdbt": True, "use_zarr3": False}


def _insert(tree: dict, keys: list, leaf, where: str) -> None:
    node = tree
    for i, k in enumerate(keys):
        if k["key_type"] != 2:
            raise ValueError(f"{where}: key_type {k['key_type']!r}; only dict keys (2) are "
                             "known")
        if i == len(keys) - 1:
            if k["key"] in node:
                raise ValueError(f"{where}: the path is listed twice")
            node[k["key"]] = leaf
        else:
            node = node.setdefault(k["key"], {})
            if not isinstance(node, dict):
                raise ValueError(f"{where}: a leaf is also a parent")


def read(path: str) -> dict:
    """The tree saved in the orbax checkpoint directory `path`: nested dicts
    of numpy arrays, Python scalars, `{}` and `None`."""
    meta_path = osp.join(path, "_METADATA")
    if not osp.isfile(meta_path):
        lacks = [f for f in ("_METADATA", "manifest.ocdbt") if not osp.isfile(osp.join(path, f))]
        raise ValueError(f"{path} is not an orbax checkpoint directory (ckpt_backend: orbax): "
                         f"it lacks {' and '.join(lacks)}")
    with open(meta_path) as f:
        meta = json.load(f)
    for key, want in _LAYOUT.items():
        if meta.get(key) is not want:
            raise ValueError(f"{meta_path}: {key} is {meta.get(key)!r}; the port reads the "
                             f"layout the JAX package writes ({key}: {str(want).lower()})")
    if "tree_metadata" not in meta:
        raise ValueError(f"{meta_path}: no tree_metadata")
    store = OcdbtStore(path)
    tree: dict = {}
    for name, entry in meta["tree_metadata"].items():
        where = f"{meta_path}: {name}"
        keys = entry["key_metadata"]
        vtype = entry["value_metadata"]["value_type"]
        if vtype in _EMPTY:
            leaf = _EMPTY[vtype]()
        elif vtype in _ARRAYS:
            if entry["value_metadata"].get("skip_deserialize"):
                raise ValueError(f"{where}: a {vtype} marked skip_deserialize")
            leaf = zarr2.read_array(store, ".".join(str(k["key"]) for k in keys))
            if vtype == "scalar":
                leaf = leaf.item()
        else:
            raise ValueError(f"{where}: value_type {vtype!r} is not known "
                             f"({', '.join(_ARRAYS + tuple(_EMPTY))})")
        _insert(tree, keys, leaf, where)
    return tree
