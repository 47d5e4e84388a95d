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
(`opt_state_from_flax`), whatever the JAX handlers saved:

- `optax.inject_hyperparams` (G, the baseline's `opt_net`): its learning
  rate goes onto every group; MultiSteps (`accum_steps > 1`, G and D) its
  accumulator, `mini_step` and `gradient_step`; `lookahead_<name>` its slow
  weights and count;
- the factory's chain (coupled L2, a `scale_by_*` transform, the learning
  rate) for every name: Adam's `mu` / `nu` / `count` become torch Adam's
  `exp_avg` / `exp_avg_sq` / `step`, the other names' fields
  `FactoryOptimizer`'s per-tensor state under optax's names (RAdam's state
  has Adam's layout: the config's name tells them apart); adafactor's
  factored moments per tensor;
- AdaHessian's `{count, mu, nu}`;
- each per-parameter field either a tree like the parameters' or, under
  `opt_flatten: true` (the JAX default) for the ten elementwise names, one
  fused vector over the parameter leaves in `jax.tree_util.tree_leaves`
  order (every dict's keys sorted), split here by the leaves' sizes.

A state of another structure raises before anything is loaded.
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
        path = _flax_path(key, arr.ndim)
        if path[-1] == "kernel":
            arr = np.ascontiguousarray(arr.transpose(np.argsort(_torch_axes(path, arr.ndim))))
        flat[path] = arr
    return _unflatten(flat)


def save_npz(path: str, params: dict) -> None:
    """Save a nested params tree as an .npz with '/'-joined keys."""
    np.savez(path, **{"/".join(p): np.asarray(v)
                      for p, v in _flatten(params).items()})


def load_npz(path: str) -> dict:
    with np.load(path) as z:
        return _unflatten({tuple(k.split("/")): z[k] for k in z.files})


# ---------------------------------------------------------------------------
# optimizer states of the JAX package's checkpoints
# ---------------------------------------------------------------------------

# each factory name's per-parameter fields in its `scale_by_*` state, under
# optax's names (which FactoryOptimizer keeps; sgdp's state is its momentum
# tree itself, `buf` here)
_FIELDS = {"sgd": ("trace",), "momentum": ("trace",), "nesterov": ("trace",),
           "adam": ("mu", "nu"), "adamw": ("mu", "nu"), "nadam": ("mu", "nu"),
           "radam": ("mu", "nu"), "adamp": ("mu", "nu"), "novograd": ("mu", "nu"),
           "nvnovograd": ("mu", "nu"), "adadelta": ("e_g", "e_x"), "rmsprop": ("nu",),
           "rmsproptf": ("sq", "mom"), "adafactor": ("v_row", "v_col", "v")}
# the names whose state also counts its updates
_COUNTED = frozenset(("adam", "adamw", "nadam", "radam", "adamp", "novograd",
                      "nvnovograd", "adafactor"))
_MULTISTEPS = frozenset(("mini_step", "gradient_step", "inner_opt_state", "acc_grads",
                         "skip_state"))


def _flax_path(key: str, ndim: int) -> tuple:
    """The flax path of a torch state_dict key (torch_to_flax's naming)."""
    *mods, leaf = key.split(".")
    if mods:
        mods[0] = _TOP_RENAME_BACK.get(mods[0], mods[0])
    if leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    return tuple(mods + [leaf])


def _torch_axes(path: tuple, ndim: int) -> tuple:
    """For each axis of the torch tensor, the axis of the flax array it
    comes from (flax_to_torch's transposes)."""
    if path[-1] == "kernel":
        return (1, 0) if ndim == 2 else (3, 2, 0, 1)
    return tuple(range(ndim))


def _numpy(v) -> np.ndarray:
    return np.asarray(v.float().numpy() if isinstance(v, torch.Tensor) else v, np.float32)


def _describe(tree, depth: int = 0) -> str:
    """A short account of a state: dict keys two levels down, array shapes."""
    if not isinstance(tree, dict):
        return f"shape {np.shape(_numpy(tree))}"
    if depth == 2:
        return "{" + ", ".join(map(str, tree)) + "}"
    text = "{" + ", ".join(f"{k}: {_describe(v, depth + 1)}" for k, v in tree.items()) + "}"
    return text if len(text) <= 300 else text[:297] + "..."


def _empty(tree) -> bool:
    """optax's stateless entries: {} or {"inner_state": {}} (a masked one)."""
    return isinstance(tree, dict) and all(_empty(v) for v in tree.values())


class _Params:
    """The parameters that `optimizer` steps, keyed by flax path: the
    tensor (torch layout), the index in the optimizer's state_dict, and the
    order of `jax.tree_util.tree_leaves` (every dict's keys sorted), which
    is the order of a fused vector."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer, name: str):
        self.name = name
        index = {id(p): i for i, p in enumerate(
            p for g in optimizer.param_groups for p in g["params"])}
        self.param, self.index = {}, {}
        for key, p in model.named_parameters():
            if id(p) in index:
                path = _flax_path(key, p.ndim)
                self.param[path], self.index[path] = p, index[id(p)]
        if len(self.param) != len(index):
            raise ValueError(f"optimizer {name!r} steps tensors that are not the model's "
                             "parameters")
        self.order = sorted(self.param)

    def _fail(self, what: str, found) -> ValueError:
        return ValueError(f"optimizer {self.name!r}: the JAX package checkpoint's optimizer "
                          f"state is not one the port maps: expected {what}, found "
                          f"{_describe(found)}")

    def expect(self, tree, keys, what: str) -> None:
        if not isinstance(tree, dict) or set(tree) != set(keys):
            raise self._fail(f"{what} with keys {sorted(keys)}", tree)

    def _flax_shape(self, path: tuple) -> tuple:
        p = self.param[path]
        axes = _torch_axes(path, p.ndim)
        shape = [0] * p.ndim
        for i, a in enumerate(axes):
            shape[a] = p.shape[i]
        return tuple(shape)

    def _to_torch(self, path: tuple, arr: np.ndarray) -> torch.Tensor:
        if arr.shape == self._flax_shape(path):
            arr = arr.transpose(_torch_axes(path, arr.ndim))
        elif arr.shape != ():
            raise self._fail(f"{'/'.join(path)} of shape {self._flax_shape(path)} or ()", arr)
        return torch.tensor(np.ascontiguousarray(arr))

    def tensors(self, value, what: str) -> dict:
        """{flax path: tensor in torch's layout} of one per-parameter field:
        a tree like the parameters', or one fused vector (`optax.flatten`)
        over the leaves in tree_leaves order."""
        if isinstance(value, dict):
            flat = {p: _numpy(v) for p, v in _flatten(value).items()}
            if set(flat) != set(self.param):
                raise self._fail(f"{what} over the model's parameters "
                                 f"(first differences {sorted(set(flat) ^ set(self.param))[:3]})",
                                 value)
            return {p: self._to_torch(p, flat[p]) for p in self.order}
        vec = _numpy(value)
        sizes = [int(np.prod(self._flax_shape(p))) for p in self.order]
        if vec.ndim != 1 or vec.size != sum(sizes):
            raise self._fail(f"{what}: a parameter tree or one fused vector of "
                             f"{sum(sizes)} elements", value)
        pieces = np.split(vec, np.cumsum(sizes)[:-1])
        return {p: self._to_torch(p, piece.reshape(self._flax_shape(p)))
                for p, piece in zip(self.order, pieces)}

    def listed(self, value, what: str) -> list:
        """`tensors` in the optimizer's order (the wrappers' lists)."""
        t = self.tensors(value, what)
        return [t[p] for p in sorted(t, key=self.index.get)]

    def factored(self, state: dict) -> dict:
        """optax.adafactor's second moments per parameter, as
        FactoryOptimizer keeps them: `v_row` / `v_col` (the means over the
        largest and the second largest axis) where the tensor is factored,
        else `v`; optax's (1,) placeholders are dropped. Where the two
        largest sizes tie, torch's transposed layout orders the axes the
        other way, and v_row / v_col swap."""
        flat = {k: _flatten(state[k]) if isinstance(state[k], dict) else {}
                for k in ("v_row", "v_col", "v")}
        out = {}
        for path in self.order:
            if any(path not in f for f in flat.values()):
                raise self._fail(f"adafactor's v_row / v_col / v at {'/'.join(path)}", state)
            leaf = {k: _numpy(f[path]) for k, f in flat.items()}
            p = self.param[path]
            dims = sorted(range(p.ndim), key=lambda i: p.shape[i])
            if not (p.ndim >= 2 and p.shape[dims[-2]] >= 128):
                out[path] = {"v": self._to_torch(path, leaf["v"])}
                continue
            fd = np.argsort(np.asarray(self._flax_shape(path)), kind="stable")
            reduced = {int(fd[-1]): leaf["v_row"], int(fd[-2]): leaf["v_col"]}
            axes = _torch_axes(path, p.ndim)
            out[path] = {}
            for key, d in (("v_row", dims[-1]), ("v_col", dims[-2])):
                a = axes[d]
                if a not in reduced:
                    raise self._fail(f"adafactor's factors of {'/'.join(path)} in an order "
                                     "the port's layout can take", state)
                rest = [axes[i] - (axes[i] > a) for i in range(p.ndim) if i != d]
                out[path][key] = torch.tensor(np.ascontiguousarray(reduced[a].transpose(rest)))
        return out

    def state_dict(self, optimizer: torch.optim.Optimizer, per_param: dict) -> dict:
        sd = optimizer.state_dict()
        sd["state"] = {self.index[p]: per_param[p] for p in self.order}
        return sd


def _chain_entry(params: _Params, tree, base: str):
    """The one stateful entry of an optax chain (`"0"`, `"1"`, ...): the
    decay's, the learning rate's and adafactor's other entries hold none."""
    if isinstance(tree, dict) and tree and all(k.isdigit() for k in tree):
        full = [v for v in tree.values() if not _empty(v)]
        if len(full) == 1:
            return full[0]
    raise params._fail(f"{base}'s optax chain: entries '0', '1', ... of which one holds "
                       "state", tree)


def _fill(optimizer, tree, params: _Params, steps) -> dict:
    """`optimizer.state_dict()` with the JAX state `tree` in place of its
    own; `steps` is the inner optimizer's update count where the JAX state
    holds one outside the scale_by_* state (for names whose state has none)."""
    from .train.optim import AdaHessian, FactoryOptimizer, Lookahead, MultiSteps
    if isinstance(optimizer, MultiSteps):
        params.expect(tree, _MULTISTEPS, "optax.MultiSteps' state")
        if not _empty(tree["skip_state"]):
            raise params._fail("MultiSteps' empty skip_state", tree["skip_state"])
        gradient_step = int(np.asarray(tree["gradient_step"]))
        return {"inner": _fill(optimizer.inner, tree["inner_opt_state"], params,
                               gradient_step),
                "mini_step": int(np.asarray(tree["mini_step"])),
                "gradient_step": gradient_step,
                "acc": params.listed(tree["acc_grads"], "MultiSteps' acc_grads")}
    if isinstance(optimizer, Lookahead):
        params.expect(tree, ("inner", "slow", "count"), "lookahead's state")
        count = int(np.asarray(tree["count"]))
        return {"inner": _fill(optimizer.inner, tree["inner"], params, count),
                "count": count, "slow": params.listed(tree["slow"], "lookahead's slow")}
    if isinstance(optimizer, AdaHessian):
        params.expect(tree, ("count", "mu", "nu"), "AdaHessianState")
        count = int(np.asarray(tree["count"]))
        mu, nu = (params.tensors(tree[k], f"AdaHessian's {k}") for k in ("mu", "nu"))
        return params.state_dict(optimizer, {p: {"count": count, "mu": mu[p], "nu": nu[p]}
                                             for p in params.order})
    if type(optimizer) is torch.optim.Adam:
        base = "adam"
    elif isinstance(optimizer, FactoryOptimizer):
        base = optimizer.name
    else:
        raise TypeError(f"optimizer {params.name!r}: no JAX state maps onto "
                        f"{type(optimizer).__name__}")
    entry = _chain_entry(params, tree, base)
    if base == "sgdp":
        buf = params.tensors(entry, "sgdp's momentum")
        return params.state_dict(optimizer, {p: {"count": steps or 0, "buf": buf[p]}
                                             for p in params.order})
    fields = _FIELDS[base]
    params.expect(entry, fields + (("count",) if base in _COUNTED else ()),
                  f"{base}'s scale_by_* state")
    count = int(np.asarray(entry["count"])) if base in _COUNTED else (steps or 0)
    if base == "adafactor":
        per = params.factored(entry)
        return params.state_dict(optimizer, {p: dict(per[p], count=count)
                                             for p in params.order})
    per = {f: params.tensors(entry[f], f"{base}'s {f}") for f in fields}
    if base == "adam":      # torch.optim.Adam's names; its step is a float tensor
        return params.state_dict(optimizer, {
            p: {"step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": per["mu"][p], "exp_avg_sq": per["nu"][p]} for p in params.order})
    return params.state_dict(optimizer, {p: dict({f: per[f][p] for f in fields}, count=count)
                                         for p in params.order})


def opt_state_from_flax(opt_state: dict, optimizer: torch.optim.Optimizer,
                        model: torch.nn.Module, name: str) -> dict:
    """The state_dict to load into `optimizer` (the port's optimizer for the
    config's optimizer name `name`, stepping `model`'s parameters) from the
    flax state dict `opt_state` of the JAX optimizer that stepped the same
    parameters, as the JAX handlers build it. `optax.inject_hyperparams`
    (its learning rate goes onto every group), then `optax.MultiSteps`, then
    `lookahead` are unwrapped; every per-parameter field is either a tree
    like the parameters' or one fused vector (`opt_flatten: true`), told
    apart by the state itself. A state of another structure than the one
    `optimizer` needs raises before anything is loaded."""
    params = _Params(model, optimizer, name)
    lr, steps = None, None
    if isinstance(opt_state, dict) and {"hyperparams", "inner_state"} <= set(opt_state):
        params.expect(opt_state, ("count", "hyperparams", "hyperparams_states", "inner_state"),
                      "optax.inject_hyperparams' state")
        lr = float(_numpy(opt_state["hyperparams"]["learning_rate"]))
        steps = int(np.asarray(opt_state["count"]))
        opt_state = opt_state["inner_state"]
    sd = _fill(optimizer, opt_state, params, steps)
    if lr is not None:
        inner = sd
        while "inner" in inner:
            inner = inner["inner"]
        for g in inner["param_groups"]:
            g["lr"] = lr
    return sd
