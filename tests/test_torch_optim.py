"""The port's optimizer factory, gradient accumulation and AdaHessian
(advmil_tpu_torch/train/optim.py) against advmil_tpu on the CPU in f32.

- Every factory name (and `lookahead_` over four of them) x weight decay
  {0, 5e-4}, 7 steps against `create_optimizer(..., params=...)`: the
  gradient of each step is a fixed function of the current parameters, so
  the two trajectories stay coupled; parameters within 2e-6 + 2e-5 relative
  (f32; the port runs per tensor what JAX runs on one flattened vector).
- `MultiSteps` against optax.MultiSteps inside `inject_hyperparams`, with an
  LR change midway, Lookahead inside it and around it; parameters on the
  mini-steps between inner steps bit-unchanged.
- `reset_multisteps_accum`, and a checkpoint round trip mid-accumulation that
  continues bit for bit.
- AdaHessian: the transform given `hessian_diag`, the Hutchinson diagonal on
  a quadratic (exact up to f32 rounding), one base ABMIL step against the
  JAX step with the same Rademacher z (`jax.random.rademacher` is
  monkeypatched in this process to return numpy's z).
- Whole runs (dropout and noise off on both sides, the port from the JAX
  run's initial weights): 2-epoch adversarial ESAT `exec` with
  `accum_steps: 2` on a split of 3 batches (a remainder each epoch), with and
  without `accum_drop_remainder`; a 2-epoch base ABMIL `exec` with
  `batch_max_size: 1`, `accum_steps: 4`.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from advmil_tpu import config as jconfig
from advmil_tpu.train import optim as jopt
from advmil_tpu_torch import bridge
from advmil_tpu_torch import config as tconfig
from advmil_tpu_torch.data.bags import BucketBatcher, prepare_dataset
from advmil_tpu_torch.models import layers as tl
from advmil_tpu_torch.train import baseline as tbaseline
from advmil_tpu_torch.train import optim as topt
from advmil_tpu_torch.train.steps import make_base_train_step
from tests.test_torch_ssl import _run_both, _same_outputs, no_jax_dropout, synth  # noqa: F401

ATOL, RTOL = 2e-6, 2e-5
SHAPES = {"a_big": (130, 136), "b_w": (6, 5), "c_b": (5,), "d_k": (3, 4, 2)}


def _problem(seed=0):
    """Initial parameters and per-step gradient terms: g_t = a * p + c_t."""
    rng = np.random.default_rng(seed)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    a = {k: rng.uniform(0.5, 1.5, size=s).astype(np.float32) for k, s in SHAPES.items()}
    c = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
         for _ in range(20)]
    return p0, a, c


def _jax_run(tx, p0, a, c, steps, lr_at=None):
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    update = jax.jit(tx.update)     # as the handlers' steps run it (eager f32 differs)
    trail = []
    for t in range(steps):
        if lr_at and t in lr_at:
            hp = dict(state.hyperparams)
            hp["learning_rate"] = jnp.asarray(lr_at[t], jnp.float32)
            state = state._replace(hyperparams=hp)
        g = {k: a[k] * params[k] + c[t][k] for k in params}
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)
        trail.append({k: np.asarray(v) for k, v in params.items()})
    return trail


def _torch_params(p0):
    return [torch.tensor(p0[k], requires_grad=True) for k in sorted(SHAPES)]


def _torch_run(opt, params, a, c, steps, lr_at=None, start=0):
    trail = []
    for t in range(start, start + steps):
        if lr_at and t in lr_at:
            topt.set_lr(opt, lr_at[t])
        for k, p in zip(sorted(SHAPES), params):
            p.grad = torch.from_numpy(a[k]) * p.detach() + torch.from_numpy(c[t][k])
        opt.step()
        trail.append({k: p.detach().numpy().copy() for k, p in zip(sorted(SHAPES), params)})
    return trail


def _close(got, want, **tol):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **(tol or {"atol": ATOL, "rtol": RTOL}),
                                   err_msg=k)


_NAMES = list(topt.OPTIMIZER_NAMES) + ["lookahead_adam", "lookahead_sgd",
                                       "lookahead_radam", "lookahead_adafactor"]


@pytest.mark.parametrize("wd", [0.0, 5e-4])
@pytest.mark.parametrize("name", _NAMES)
def test_factory_matches_optax(name, wd):
    """7 steps (the lookahead sync period is 6) at lr 1e-2 from the same
    parameters; the port per tensor, JAX as its handlers build it
    (`params=` for the bias exclusion, flattened where it flattens)."""
    p0, a, c = _problem()
    lr = 1e-2
    want = _jax_run(jopt.create_optimizer(name, lr, weight_decay=wd, params=p0), p0, a, c, 7)
    params = _torch_params(p0)
    opt = topt.create_optimizer(name, params, lr, weight_decay=wd)
    got = _torch_run(opt, params, a, c, 7)
    for t in range(7):
        _close(got[t], want[t])
    moved = max(float(np.abs(want[-1][k] - p0[k]).max()) for k in p0)
    assert moved > 1e-4, moved         # adadelta moves least: 4e-4


def test_factory_names_and_refusals():
    params = _torch_params(_problem()[0])
    assert isinstance(topt.create_optimizer("Adam", params, 1e-3), torch.optim.Adam)
    la = topt.create_optimizer("lookahead_sgdp", params, 1e-3)
    assert isinstance(la, topt.Lookahead) and la.inner.name == "sgdp"
    assert topt.create_optimizer("foo_rmsproptf", params, 1e-3).name == "rmsproptf"
    for bad in ("adamax", "lookahead_lamb"):
        with pytest.raises(ValueError, match="Invalid optimizer"):
            topt.create_optimizer(bad, params, 1e-3)
        with pytest.raises(ValueError, match="Invalid optimizer"):
            jopt.create_optimizer(bad, 1e-3)
    with pytest.raises(NotImplementedError, match="adahessian"):
        topt.create_optimizer("adahessian", params, 1e-3)


@pytest.mark.parametrize("handler,over", [
    ("adv", {"accum_steps": 2}), ("adv", {"bcb_mode": "cluster"}),
    ("adv", {"opt_netG": "lookahead_adafactor"}), ("base", {"accum_steps": 16}),
    ("base", {"bcb_mode": "cluster"}), ("base", {"opt_net": "nvnovograd"}),
    ("base", {"opt_net": "adahessian"})], ids=lambda v: str(v))
def test_modes_once_refused_are_accepted(synth, tmp_path, handler, over):  # noqa: F811
    """accumulation (ROADMAP A6), the cluster backbone and the other
    optimizers (A12) build under both handlers on the CPU."""
    from tests.test_torch_baseline import _cfg as base_cfg
    from tests.test_torch_train import _cfg as adv_cfg
    from advmil_tpu_torch.train import handler as thandler
    if handler == "adv":
        cfg = adv_cfg(synth, tmp_path, "a", device="cpu", path_cluster=synth["path_cluster"],
                      **over)
        h = thandler.AdvHandler(tconfig.with_defaults(cfg))
        opt = h.opt_G
    else:
        cfg = base_cfg(synth, tmp_path, "b", device="cpu", bcb_dims="64-64-64", **over)
        h = tbaseline.BaselineHandler(tconfig.with_defaults(cfg))
        opt = h.opt
    assert not tconfig._not_ported(h.cfg, handler)
    if "accum_steps" in over:
        assert isinstance(opt, topt.MultiSteps) and opt.k == over["accum_steps"]
    if over.get("opt_net") == "adahessian":
        assert isinstance(opt, topt.AdaHessian)


def test_adahessian_refusals():
    """Under device cuda AdaHessian is refused on the backbones whose path
    runs a kernel (ROADMAP A19, no quiet switch to the plain versions), not
    on ABMIL or cluster and not on the CPU; with accumulation it is refused
    everywhere, as the JAX handler asserts."""
    base = {"task": "surv_nll", "opt_net": "adahessian", "device": "cuda"}
    for bcb in ("patch", "graph"):
        with pytest.raises(NotImplementedError, match="A19.*device: cpu runs it"):
            tconfig.check_configs(tconfig.with_defaults(dict(base, bcb_mode=bcb)), "base")
        tconfig.check_configs(tconfig.with_defaults(dict(base, bcb_mode=bcb,
                                                         device="cpu")), "base")
    for bcb in ("abmil", "cluster"):
        tconfig.check_configs(tconfig.with_defaults(dict(base, bcb_mode=bcb)), "base")
    tconfig.check_configs(tconfig.with_defaults(dict(base, bcb_mode="patch",
                                                     opt_net="adam")), "base")


def test_adahessian_refuses_accumulation(synth, tmp_path):  # noqa: F811
    from tests.test_torch_baseline import _cfg
    cfg = _cfg(synth, tmp_path, "b", device="cpu", bcb_dims="64-64-64",
               opt_net="adahessian", accum_steps=2)
    with pytest.raises(AssertionError, match="accum_steps is not supported"):
        tbaseline.BaselineHandler(tconfig.with_defaults(cfg))


# ---------------------------------------------------------------------------
# accumulation
# ---------------------------------------------------------------------------

_ACCUM = {"adam-k3": ("adam", 3, 7, "inside"),
          "lookahead_radam-k2": ("lookahead_radam", 2, 14, "inside"),
          "lookahead-around-k2": ("sgd", 2, 14, "around")}


@pytest.mark.parametrize("case", list(_ACCUM))
def test_multisteps_matches_optax(case):
    """MultiSteps inside inject_hyperparams as the JAX handlers build it
    (Lookahead, if any, inside MultiSteps), and Lookahead around MultiSteps,
    the other order JAX can build; the LR halves after the 4th mini-step.
    Between inner steps the parameters do not move, bit for bit."""
    name, k, n, order = _ACCUM[case]
    p0, a, c = _problem(1)
    lr_at = {4: 5e-3}
    wd = 5e-4

    def make_tx(learning_rate):
        tx = jopt.create_optimizer(name, learning_rate, weight_decay=wd, params=p0)
        if order == "around":
            return jopt.lookahead(optax.MultiSteps(tx, k))
        return optax.MultiSteps(tx, k)

    want = _jax_run(optax.inject_hyperparams(make_tx)(learning_rate=1e-2), p0, a, c, n,
                    lr_at=lr_at)
    params = _torch_params(p0)
    inner = topt.create_optimizer(name, params, 1e-2, weight_decay=wd)
    opt = (topt.Lookahead(topt.MultiSteps(inner, k)) if order == "around"
           else topt.MultiSteps(inner, k))
    got = _torch_run(opt, params, a, c, n, lr_at=lr_at)
    prev = p0
    for t in range(n):
        _close(got[t], want[t])
        if (t + 1) % k:
            for key in p0:
                assert np.array_equal(got[t][key], prev[key]), (t, key)
        prev = got[t]
    ms = opt.inner if order == "around" else opt
    assert ms.gradient_step == n // k and ms.mini_step == n % k


def test_reset_multisteps_accum_matches_jax():
    """k = 3: two mini-steps, the epoch-end reset, four more: the partial
    mean is dropped on both sides (the inner state stays)."""
    p0, a, c = _problem(2)
    tx = optax.MultiSteps(jopt.create_optimizer("adam", 1e-2, params=p0), 3)
    params_j = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params_j)
    params = _torch_params(p0)
    opt = topt.MultiSteps(topt.create_optimizer("adam", params, 1e-2), 3)
    for t in range(6):
        if t == 2:
            state = jopt.reset_multisteps_accum(state)
            topt.reset_multisteps_accum(opt)
            assert opt.mini_step == 0 and all(float(x.abs().sum()) == 0 for x in opt.acc)
        g = {k: a[k] * params_j[k] + c[t][k] for k in params_j}
        updates, state = tx.update(g, state, params_j)
        params_j = optax.apply_updates(params_j, updates)
        _torch_run(opt, params, a, c, 1, start=t)
    assert int(state.gradient_step) == opt.gradient_step == 1
    _close({k: p.detach().numpy() for k, p in zip(sorted(SHAPES), params)},
           {k: np.asarray(v) for k, v in params_j.items()})


@pytest.mark.parametrize("name", ["adam", "lookahead_nvnovograd"])
def test_checkpoint_mid_accumulation_continues_bit_for_bit(name):
    """state_dict after 4 mini-steps of k = 3 (one inner step, one mini-step
    into the next), through torch.save / torch.load, into a fresh optimizer
    over a copy of the parameters: the next 8 mini-steps equal the
    uninterrupted run's, bit for bit."""
    p0, a, c = _problem(3)
    params = _torch_params(p0)
    opt = topt.MultiSteps(topt.create_optimizer(name, params, 1e-2, weight_decay=5e-4), 3)
    _torch_run(opt, params, a, c, 4)
    buf = io.BytesIO()
    torch.save({"opt": opt.state_dict(), "params": [p.detach().clone() for p in params]}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    params2 = [torch.tensor(v.numpy(), requires_grad=True) for v in saved["params"]]
    opt2 = topt.MultiSteps(topt.create_optimizer(name, params2, 1e-2, weight_decay=5e-4), 3)
    opt2.load_state_dict(saved["opt"])
    assert opt2.mini_step == 1 and opt2.gradient_step == 1
    got = _torch_run(opt2, params2, a, c, 8, start=4)
    want = _torch_run(opt, params, a, c, 8, start=4)
    for g, w in zip(got, want):
        for k in w:
            assert np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("name", ["adam", "lookahead_nvnovograd"])
def test_wrappers_share_the_inner_groups_after_a_load(name):
    """torch's `load_state_dict` gives the inner optimizer new group dicts;
    MultiSteps (and Lookahead inside it) take them too, so an LR set on the
    outer optimizer after a resume (the plateau rule) reaches the inner
    step."""
    params = _torch_params(_problem(3)[0])
    opt = topt.MultiSteps(topt.create_optimizer(name, params, 1e-2), 3)
    opt.load_state_dict(opt.state_dict())
    topt.set_lr(opt, 0.25)
    inner = opt
    while isinstance(inner, topt.MultiSteps | topt.Lookahead):
        inner = inner.inner
        assert all(g["lr"] == 0.25 for g in inner.param_groups), type(inner).__name__


# ---------------------------------------------------------------------------
# AdaHessian
# ---------------------------------------------------------------------------

def test_adahessian_transform_matches_jax():
    """Three steps of the transform given the same gradients and Hessian
    diagonals, coupled L2 5e-4 on ndim > 1 (the handler's mask)."""
    p0, a, c = _problem(4)
    rng = np.random.default_rng(5)
    hd = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
          for _ in range(3)]
    mask = {k: len(s) > 1 for k, s in SHAPES.items()}
    tx = jopt.adahessian(1e-2, weight_decay=5e-4, params_mask=mask)
    params_j = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params_j)
    params = _torch_params(p0)
    opt = topt.AdaHessian(params, 1e-2, weight_decay=5e-4)
    for t in range(3):
        g = {k: a[k] * params_j[k] + c[t][k] for k in params_j}
        updates, state = tx.update(g, state, params_j, hessian_diag=hd[t])
        params_j = optax.apply_updates(params_j, updates)
        for k, p in zip(sorted(SHAPES), params):
            p.grad = torch.from_numpy(a[k]) * p.detach() + torch.from_numpy(c[t][k])
        opt.step([torch.from_numpy(hd[t][k]) for k in sorted(SHAPES)])
    _close({k: p.detach().numpy() for k, p in zip(sorted(SHAPES), params)},
           {k: np.asarray(v) for k, v in params_j.items()})


def test_hutchinson_diag_on_a_quadratic_is_exact():
    """loss = x^T A x / 2 + y^T B y / 2 + x^T C y: the double backward gives
    the gradient (A x + C y, B y + C^T x) and z * (H z) with H's cross blocks,
    against numpy."""
    rng = np.random.default_rng(6)
    nx, ny = 7, 5
    A = rng.normal(size=(nx, nx)); A = (A + A.T) / 2
    B = rng.normal(size=(ny, ny)); B = (B + B.T) / 2
    C = rng.normal(size=(nx, ny))
    x0, y0 = rng.normal(size=nx), rng.normal(size=ny)
    x = torch.tensor(x0, requires_grad=True)
    y = torch.tensor(y0, requires_grad=True)
    At, Bt, Ct = (torch.tensor(m) for m in (A, B, C))
    loss = x @ At @ x / 2 + y @ Bt @ y / 2 + x @ Ct @ y
    zs = topt.rademacher_like([x, y], torch.Generator().manual_seed(0))
    assert all(set(np.unique(z.numpy())) <= {-1.0, 1.0} for z in zs)
    grads, hd = topt.hutchinson_diag(loss, [x, y], zs)
    zx, zy = (z.numpy() for z in zs)
    np.testing.assert_allclose(grads[0].numpy(), A @ x0 + C @ y0, rtol=1e-12)
    np.testing.assert_allclose(grads[1].numpy(), B @ y0 + C.T @ x0, rtol=1e-12)
    np.testing.assert_allclose(hd[0].numpy(), zx * (A @ zx + C @ zy), rtol=1e-12)
    np.testing.assert_allclose(hd[1].numpy(), zy * (B @ zy + C.T @ zx), rtol=1e-12)


def test_adahessian_base_step_matches_jax(synth, tmp_path, monkeypatch,  # noqa: F811
                                          no_jax_dropout):
    """One surv_nll ABMIL step under `opt_net: adahessian` from the same
    weights, dropout off, the same z on both sides (the port's base step
    against the JAX base step's second-order branch on the same loss):
    - loss within 1e-6 relative; gradients within 1e-6 + 1e-5 relative;
    - z * (H z) within 1e-5 of its largest |value| (f32 sums of products
      of different order);
    - every parameter's update within 1e-6 + 2e-5 relative, plus what that
      Hessian bound allows where the diagonal is small: the update is
      -lr * g / (|h| + eps), so a relative error of h passes into it whole,
      1e-5 * max|h| / |h|."""
    from advmil_tpu import losses as jlosses
    from advmil_tpu.train.baseline import BaselineHandler as JaxHandler
    from tests.test_torch_baseline import _cfg
    over = dict(task="surv_nll", pdh_dims="64-4", opt_net="adahessian",
                opt_net_lr=0.0008, bcb_dims="64-64-64")
    jh = JaxHandler(jconfig.with_defaults(_cfg(synth, tmp_path, "jax", rng_impl="threefry",
                                               **over)))
    th = tbaseline.BaselineHandler(tconfig.with_defaults(
        _cfg(synth, tmp_path, "port", device="cpu", **over)))
    assert isinstance(th.opt, topt.AdaHessian) and th.plateau_opt is None
    flax_params = jax.tree_util.tree_map(np.asarray, dict(jh.state.params))
    th.model.load_state_dict(bridge.flax_to_torch(flax_params))
    tl.set_dropout_rates(th.model, 0.0)

    rng = np.random.default_rng(9)
    z_tree = jax.tree_util.tree_map(
        lambda v: rng.integers(0, 2, size=v.shape).astype(np.float32) * 2 - 1, flax_params)

    def fixed_rademacher(key, shape, dtype=jnp.float32):
        z = next(fixed_rademacher.leaves)
        assert z.shape == tuple(shape)
        return jnp.asarray(z, dtype)

    monkeypatch.setattr(jax.random, "rademacher", fixed_rademacher)
    z_sd = bridge.flax_to_torch(z_tree)
    names = [n for n, p in th.model.named_parameters() if p.requires_grad]
    step = make_base_train_step(th.model, th.opt, task="surv_nll",
                                l1_coef=th.cfg["loss_regl1_coef"],
                                sup_loss_fn=th.sup_loss_fn,
                                z_fn=lambda params, gen: [z_sd[n] for n in names])

    ds = prepare_dataset([f"P{i:04d}" for i in range(36)], th.cfg)
    batch = next(iter(BucketBatcher(ds, token_budget=4096).epoch_batches()))
    jdev = {"feats": jnp.asarray(batch.feats), "mask": jnp.asarray(batch.mask),
            "label": jnp.asarray(batch.label),
            "sample_mask": jnp.asarray(batch.sample_mask)}

    def loss_fn(params):        # the JAX base step's loss (dropout is the identity)
        pred = jh.model.apply({"params": params}, jdev["feats"], jdev["mask"], None,
                              deterministic=True)
        lab = jdev["label"]
        loss = jh.sup_loss_fn(pred, lab[:, 0], lab[:, 1], weight=jdev["sample_mask"])
        return loss + jlosses.loss_reg_l1(params, jh.l1_coef)

    # the JAX base step's second-order branch (train/steps.py:224-229), jitted
    # once: adahessian_grads, then the adahessian transform
    fixed_rademacher.leaves = iter(jax.tree_util.tree_leaves(z_tree))

    @jax.jit
    def jax_step(params, opt_state):
        total, grads, hd = jopt.adahessian_grads(loss_fn, params, jax.random.PRNGKey(0))
        updates, _ = jh.tx.update(grads, opt_state, params, hessian_diag=hd)
        return total, grads, hd, optax.apply_updates(params, updates)

    jtotal, jgrads, jhd, jparams = jax_step(jh.state.params, jh.state.opt)
    jgrads, jhd = (bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, dict(t)))
                   for t in (jgrads, jhd))

    from advmil_tpu_torch.train import optim as optim_mod
    seen = {}
    real_hutchinson = optim_mod.hutchinson_diag

    def spy(loss, params, zs):
        grads, hd = real_hutchinson(loss, params, zs)
        seen.update(grads=dict(zip(names, grads)), hd=dict(zip(names, hd)))
        return grads, hd

    monkeypatch.setattr("advmil_tpu_torch.train.steps.hutchinson_diag", spy)
    tmet, _ = step(th._ship(batch, train=True), th.train_rngs)
    np.testing.assert_allclose(float(tmet["loss_total"]), float(jtotal), rtol=1e-6)
    h_max = max(float(v.abs().max()) for v in jhd.values())
    for n in names:
        np.testing.assert_allclose(seen["grads"][n].numpy(), jgrads[n].numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=n)
        np.testing.assert_allclose(seen["hd"][n].numpy(), jhd[n].numpy(),
                                   atol=1e-5 * h_max, rtol=0, err_msg=n)
    want = bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, dict(jparams)))
    before = bridge.flax_to_torch(flax_params)
    got = th.model.state_dict()
    for k in want:
        dw, dg = (want[k] - before[k]).numpy(), (got[k] - before[k]).numpy()
        bound = 1e-6 + np.abs(dw) * (2e-5 + 1e-5 * h_max / (np.abs(jhd[k].numpy()) + 1e-8))
        assert np.all(np.abs(dg - dw) <= bound), k
    assert max(float((want[k] - before[k]).abs().max()) for k in want) > 1e-4


# ---------------------------------------------------------------------------
# whole runs against the JAX handlers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop", [False, True], ids=["carry", "drop"])
def test_adv_exec_accumulated_matches_jax(synth, tmp_path, monkeypatch,  # noqa: F811
                                          no_jax_dropout, drop):
    """accum_steps 2 on 3 batches an epoch: with `accum_drop_remainder` one
    inner step an epoch, the third batch's mean dropped; without it the
    partial mean carries into epoch 2 (two inner steps there). CSVs within
    1e-4, C-indices within 1e-4."""
    jh, jm, th, tm = _run_both(synth, tmp_path, monkeypatch, "exec", accum_steps=2,
                               accum_drop_remainder=drop, batch_token_budget=2048)
    assert th.opt_G.gradient_step == th.opt_D.gradient_step == (2 if drop else 3)
    assert th.opt_G.mini_step == th.opt_D.mini_step == 0
    assert int(jh.state.opt_D.gradient_step) == th.opt_D.gradient_step
    _same_outputs(jm, tm, tmp_path, "train", "best", ("train", "validation", "test"))


def test_base_exec_refregime_matches_jax(synth, tmp_path, monkeypatch,  # noqa: F811
                                         no_jax_dropout):
    """The reference's regime on ABMIL surv_nll: one bag a micro-batch, an
    inner step every 4 bags, 2 epochs through the port's CLI from the JAX
    run's initial weights; CSVs within 1e-4, C-indices within 1e-4."""
    from advmil_tpu.train.baseline import BaselineHandler as JaxHandler
    from advmil_tpu_torch.main import main as port_main
    from tests.test_torch_baseline import _cfg, _write_yaml
    over = dict(task="surv_nll", pdh_dims="64-4", bcb_dims="64-64-64", batch_max_size=1,
                accum_steps=4, accum_drop_remainder=True)
    jh = JaxHandler(jconfig.with_defaults(_cfg(synth, tmp_path, "jax", rng_impl="threefry",
                                               **over)))
    init = bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, dict(jh.params)))
    jm = jh.exec()

    def from_jax_init(model, seed):
        model.load_state_dict(init)
        return tl.set_dropout_rates(model, 0.0)

    monkeypatch.setattr(tbaseline, "init_parameters", from_jax_init)
    yaml_path = str(tmp_path / "port.yaml")
    _write_yaml(yaml_path, _cfg(synth, tmp_path, "port", device="cpu", **over))
    [(th, tm)] = port_main(["--config", yaml_path, "--handler", "base"])
    n_train = len(th.patient_id["train"])
    assert th.opt.gradient_step == 2 * (n_train // 4)
    assert int(jh.state.opt.inner_state.gradient_step) == th.opt.gradient_step
    for split in ("train", "validation", "test"):
        assert abs(dict(tm[split])["cindex"] - dict(jm[split])["cindex"]) <= 1e-4, split
