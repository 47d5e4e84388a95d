"""Every optimizer state the JAX package's handlers save, mapped onto the
port's optimizer (`advmil_tpu_torch.bridge.opt_state_from_flax`) on the
CPU, at the transform level.

Each case builds the JAX optimizer as the handlers build it
(`optax.inject_hyperparams` around `advmil_tpu.train.optim.create_optimizer`
with the bias exclusion; MultiSteps inside it; AdaHessian bare) over a small
tree whose dict keys sort differently from their insertion order, and takes
three updates with the injected learning rate halved after them. Its state
goes through `flax.serialization.msgpack_serialize` and the port's decoder,
onto the port's optimizer for the same name, and both sides take three more
updates from the same parameters: every parameter within 1e-6 of the JAX
one, relative to the tensor's largest element.

The cases: the 15 names of the factory with `flatten` True and False (the
JAX default flattens the ten elementwise names into one fused vector; the
five per-tensor names have one layout either way), `lookahead_` over three
names, MultiSteps (k = 2) over `lookahead_radam` stopped after an odd
number of mini-steps (half an accumulator), and AdaHessian. The tree holds
a kernel that adafactor factors (130 x 128) and a square one (128 x 128),
whose factors swap between flax's layout and torch's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from advmil_tpu.train import optim as jopt
from advmil_tpu_torch import bridge
from advmil_tpu_torch.train import optim as topt
from advmil_tpu_torch.utils import flax_msgpack

LR, WD, K = 1e-2, 5e-4, 2
_FLATTENABLE = ("sgd", "momentum", "nesterov", "adam", "adamw", "nadam", "radam",
                "adadelta", "rmsprop", "rmsproptf")


def _tree(rng, scale=1.0):
    """Insertion order Zeta, Alpha / kernel, bias; tree_leaves sorts both."""
    draw = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)   # noqa: E731
    return {"Zeta": {"kernel": draw(130, 128), "bias": draw(128)},
            "Alpha": {"Norm": {"scale": draw(128)}, "Dense": {"kernel": draw(128, 128)}}}


def _in_order(tree, like):
    """`tree` (a jax tree_map result: keys sorted) in `like`'s key order."""
    if not isinstance(like, dict):
        return np.asarray(tree)
    return {k: _in_order(tree[k], v) for k, v in like.items()}


def _module(params: dict) -> torch.nn.Module:
    """A module whose parameters carry the tree's names (bridge naming), in
    the tree's insertion order."""
    root = torch.nn.Module()
    for key, t in bridge.flax_to_torch(params).items():
        *mods, leaf = key.split(".")
        m = root
        for name in mods:
            if name not in m._modules:
                m.add_module(name, torch.nn.Module())
            m = m._modules[name]
        m.register_parameter(leaf, torch.nn.Parameter(t.clone()))
    return root


def _cases():
    cases = [(n, f) for n in topt.OPTIMIZER_NAMES for f in (True, False)]
    cases += [(n, True) for n in ("lookahead_radam", "lookahead_adafactor",
                                  "lookahead_momentum")]
    return cases + [("accum_lookahead_radam", True), ("adahessian", False)]


def _jax_tx(case, flatten, params):
    if case == "adahessian":
        mask = jax.tree_util.tree_map(lambda p: p.ndim > 1, params)
        return jopt.adahessian(LR, weight_decay=WD, params_mask=mask)
    name = case.removeprefix("accum_")

    def make(learning_rate):
        tx = jopt.create_optimizer(name, learning_rate, weight_decay=WD, params=params,
                                   flatten=flatten)
        return optax.MultiSteps(tx, K) if case.startswith("accum_") else tx
    return optax.inject_hyperparams(make)(learning_rate=LR)


def _port_opt(case, model):
    if case == "adahessian":
        return topt.AdaHessian(model.parameters(), LR, weight_decay=WD)
    opt = topt.create_optimizer(case.removeprefix("accum_"), model.parameters(), LR,
                                weight_decay=WD)
    return topt.MultiSteps(opt, K) if case.startswith("accum_") else opt


def _fused(tree) -> bool:
    """Whether a JAX state holds a fused (1-D, whole-tree) vector."""
    n = 128 * 130 + 128 * 128 + 256
    return any(np.ndim(v) == 1 and np.size(v) == n for v in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("case,flatten", _cases(),
                         ids=lambda v: v if isinstance(v, str) else ("flat" if v else "tree"))
def test_jax_state_resumes_in_port(case, flatten):
    rng = np.random.default_rng(7)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(6)]
    hdiag = [_tree(rng, 0.1) for _ in range(6)]
    tx = _jax_tx(case, flatten, p0)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(params)
    update = jax.jit(tx.update)       # as the handlers' steps run it

    def jax_steps(params, state, steps):
        for t in steps:
            extra = {"hessian_diag": hdiag[t]} if case == "adahessian" else {}
            updates, state = update(grads[t], state, params, **extra)
            params = optax.apply_updates(params, updates)
        return params, state

    params, state = jax_steps(params, state, range(3))
    if case != "adahessian":
        state.hyperparams["learning_rate"] = jnp.asarray(LR * 0.5, jnp.float32)
    data = serialization.msgpack_serialize(serialization.to_state_dict(state))
    saved = flax_msgpack.msgpack_restore(data)
    fused = _fused(saved)
    assert fused == (flatten and case.removeprefix("accum_").split("_")[-1] in _FLATTENABLE)

    saved_params = _in_order(params, p0)
    model = _module(saved_params)
    assert list(dict(model.named_parameters()))[:2] == ["Zeta.weight", "Zeta.bias"]
    opt = _port_opt(case, model)
    opt.load_state_dict(bridge.opt_state_from_flax(saved, opt, model, case))
    if case != "adahessian":
        # the wrappers' groups too: they are the inner optimizer's after a load
        assert all(g["lr"] == np.float32(LR * 0.5) for g in opt.param_groups)
    named = dict(model.named_parameters())
    for t in range(3, 6):
        g = bridge.flax_to_torch(grads[t])
        for k, p in named.items():
            p.grad = g[k].clone()
        if case == "adahessian":
            h = bridge.flax_to_torch(hdiag[t])
            opt.step([h[k] for k in named])         # opt.order: the model's order
        else:
            opt.step()
    want, _ = jax_steps(params, state, range(3, 6))
    want = bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, want))
    before = bridge.flax_to_torch(saved_params)
    for k, p in named.items():
        got, w = p.detach().numpy(), want[k].numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=f"{case} {k}")
    assert max(float((want[k] - before[k]).abs().max()) for k in named) > 1e-5
