"""Optimizers of both handlers, gradient accumulation and the plateau LR
schedule (counterpart of `advmil_tpu/train/optim.py`).

The JAX package builds every optimizer as an optax chain: coupled L2 on
parameters with ndim > 1 only (timm's bias / norm exclusion) -> a
`scale_by_*` transform -> the learning rate. Each name of its factory
(`create_optimizer`) is one `torch.optim.Optimizer` here that computes the
same chain per parameter tensor, with optax's eps placement and initial
state: `param_groups` carry `lr`, so `set_lr`, the plateau rule and the
checkpoints (`state_dict` / `load_state_dict`) work on every one of them.
The JAX factory flattens elementwise optimizers into one vector
(`opt_flatten`); that is the same arithmetic per element, so it is not
copied. `adam` stays `torch.optim.Adam` (`adam_with_l2`): its coupled L2
and update equal `add_decayed_weights` -> `scale_by_adam`.

Wrappers: `Lookahead` (the `lookahead_<name>` prefix) and `MultiSteps`
(`accum_steps > 1`, optax.MultiSteps' semantics); both share their inner
optimizer's `param_groups`, so an LR set on the wrapper is the LR the inner
step uses. `AdaHessian` takes the Hutchinson Hessian diagonal
(`hutchinson_diag`) as an argument of `step`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# factory names whose chain starts with coupled L2 (g + wd * p on ndim > 1)
_COUPLED = frozenset(("sgd", "momentum", "nesterov", "nadam", "radam", "adadelta",
                      "novograd", "nvnovograd", "rmsprop", "rmsproptf"))
OPTIMIZER_NAMES = ("sgd", "momentum", "nesterov", "adam", "adamw", "nadam", "radam",
                   "adadelta", "adafactor", "adamp", "sgdp", "novograd", "nvnovograd",
                   "rmsprop", "rmsproptf")


def adam_with_l2(params, lr: float, weight_decay: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8) -> torch.optim.Adam:
    """Adam with coupled L2 `weight_decay` on parameters with ndim > 1 only."""
    params = [p for p in params if p.requires_grad]
    decay = [p for p in params if p.ndim > 1]
    no_decay = [p for p in params if p.ndim <= 1]
    groups = [{"params": decay, "weight_decay": float(weight_decay or 0.0)},
              {"params": no_decay, "weight_decay": 0.0}]
    return torch.optim.Adam([g for g in groups if g["params"]], lr=lr,
                            betas=betas, eps=eps)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def _decay_groups(params, weight_decay: float) -> list:
    """Two groups: `decay` True for ndim > 1 (where the chain's L2 acts)."""
    params = [p for p in params if p.requires_grad]
    groups = [{"params": [p for p in params if p.ndim > 1], "decay": True},
              {"params": [p for p in params if p.ndim <= 1], "decay": False}]
    return [dict(g, weight_decay=float(weight_decay or 0.0)) for g in groups if g["params"]]


def _bias_correction(decay: float, t: int) -> float:
    """1 - decay ** t in f32, as optax computes it (f64 moves RAdam's
    rectifier and the first steps' corrections by f32 ulps of 1 - b2^t)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(t))


def _radam_rect(b2: float, t: int):
    """optax.scale_by_radam's rectifier r in f32, None below its threshold
    5 (the step is then the bias-corrected momentum alone)."""
    f = np.float32
    ro_inf = f(2.0 / (1.0 - b2) - 1.0)
    b2t = f(b2) ** f(t)
    ro = ro_inf - f(2) * f(t) * b2t / (f(1) - b2t)
    if not ro >= f(5.0):
        return None
    return float(np.sqrt((ro - f(4)) * (ro - f(2)) * ro_inf
                         / ((ro_inf - f(4)) * (ro_inf - f(2)) * ro)))


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


def _adamp_project(d, p, delta: float, wd_ratio: float):
    """AdamP's projection: the update's component along the weight is removed
    when the two are nearly orthogonal (|cos| < delta / sqrt(size)), over the
    whole tensor; returns (update, decay ratio)."""
    pv, dv = p.reshape(-1), d.reshape(-1)
    cos = torch.abs(torch.sum(pv * dv) / torch.clamp(
        torch.sqrt(torch.sum(pv * pv)) * torch.sqrt(torch.sum(dv * dv)), min=1e-30))
    p_unit = pv / torch.clamp(torch.linalg.vector_norm(pv), min=1e-30)
    d_proj = dv - torch.sum(dv * p_unit) * p_unit
    use = cos < delta / math.sqrt(pv.numel())
    out = torch.where(use, d_proj, dv).reshape(p.shape)
    return out, torch.where(use, torch.tensor(wd_ratio, dtype=p.dtype, device=p.device),
                            torch.tensor(1.0, dtype=p.dtype, device=p.device))


class FactoryOptimizer(torch.optim.Optimizer):
    """One name of the JAX factory (every name but `adam`), per tensor:

    - coupled L2 names (`_COUPLED`): u = scale(g + wd * p [ndim > 1]) * -lr;
    - `adamw`: u = (scale_by_adam(g) + wd * p [ndim > 1]) * -lr;
    - `adamp` / `sgdp`: the projected Adam / momentum step, decayed after the
      projection by wd * ratio * p on ndim > 1 tensors, then * -lr;
    - `adafactor` (optax.adafactor): factored RMS scaling (dims >= 128),
      clipping by block RMS 1.0, * lr, * the parameter's RMS (at least
      1e-3), + wd * p on every tensor (not scaled by lr), negated.

    `sgd` is Nesterov momentum (the factory's quirk), `momentum` is not.
    Gradients that are None skip their tensor, as torch's optimizers do."""

    def __init__(self, params, name: str, lr: float, weight_decay: float = 0.0):
        if name not in OPTIMIZER_NAMES or name == "adam":
            raise ValueError(f"Invalid optimizer {name}")
        self.name = name
        super().__init__(_decay_groups(params, weight_decay), {"lr": lr})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._step_one(p, p.grad, self.state[p], group)

    def _step_one(self, p, g, st, group):
        # optax's defaults, which the JAX factory keeps for every name
        name, lr = self.name, group["lr"]
        wd = group["weight_decay"]
        b1, b2, mom = 0.9, 0.999, 0.9
        if name in _COUPLED and wd and group["decay"]:
            g = g + wd * p
        if not st:
            st["count"] = 0
        st["count"] += 1
        t = st["count"]
        if name in ("sgd", "momentum", "nesterov"):
            tr = st.setdefault("trace", torch.zeros_like(p))
            tr.copy_(g + mom * tr)
            u = g + mom * tr if name != "momentum" else tr
        elif name in ("adamw", "nadam", "radam", "adamp"):
            mu = st.setdefault("mu", torch.zeros_like(p))
            nu = st.setdefault("nu", torch.zeros_like(p))
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            eps = 1e-8
            if name == "nadam":
                mu_hat = (b1 * (mu / _bias_correction(b1, t + 1))
                          + (1 - b1) * (g / _bias_correction(b1, t)))
            else:
                mu_hat = mu / _bias_correction(b1, t)
            nu_hat = nu / _bias_correction(b2, t)
            if name == "radam":
                r = _radam_rect(b2, t)
                u = mu_hat if r is None else r * mu_hat / (torch.sqrt(nu_hat) + eps)
            else:
                u = mu_hat / (torch.sqrt(nu_hat) + eps)
            if name == "adamw" and wd and group["decay"]:
                u = u + wd * p
            if name == "adamp" and p.ndim > 1:
                u, ratio = _adamp_project(u, p, 0.1, 0.1)
                if wd:
                    u = u + wd * ratio * p
        elif name == "sgdp":
            buf = st.setdefault("buf", torch.zeros_like(p))
            buf.copy_(mom * buf + g)
            u = buf
            if p.ndim > 1:
                u, ratio = _adamp_project(u, p, 0.1, 0.1)
                if wd:
                    u = u + wd * ratio * p
        elif name == "adadelta":
            rho, eps = 0.9, 1e-6
            e_g = st.setdefault("e_g", torch.zeros_like(p))
            e_x = st.setdefault("e_x", torch.zeros_like(p))
            e_g.copy_((1 - rho) * (g * g) + rho * e_g)
            u = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
            e_x.copy_((1 - rho) * (u * u) + rho * e_x)
        elif name in ("novograd", "nvnovograd"):
            # optax.scale_by_novograd(b1=0.95, b2=0.98) and the JAX package's
            # nvnovograd: a layer-wise second moment of the squared norm
            eps = 1e-8
            sq = torch.sum(g * g)
            if t == 1:
                st["nu"] = sq.clone()
            else:
                st["nu"] = (1 - 0.98) * sq + 0.98 * st["nu"]
            normed = g / (torch.sqrt(st["nu"]) + eps)
            st["mu"] = normed.clone() if t == 1 else 0.95 * st["mu"] + normed
            u = st["mu"]
        elif name == "rmsprop":
            nu = st.setdefault("nu", torch.zeros_like(p))
            nu.copy_((1 - 0.9) * (g * g) + 0.9 * nu)
            u = torch.rsqrt(nu + 1e-8) * g
        elif name == "rmsproptf":
            sq = st.setdefault("sq", torch.ones_like(p))
            mo = st.setdefault("mom", torch.zeros_like(p))
            sq.copy_(sq + (1 - 0.9) * (g * g - sq))
            mo.copy_(mom * mo + g / torch.sqrt(sq + 1e-10))
            u = mo
        else:   # adafactor
            p.add_(-self._adafactor(p, g, st, t, lr, wd))
            return
        p.add_(u * -lr)

    @staticmethod
    def _adafactor(p, g, st, t: int, lr: float, wd: float) -> torch.Tensor:
        """optax.adafactor's update before its final negation."""
        decay = 1.0 - float(t) ** -0.8
        grad_sqr = g * g + 1e-30
        dims = sorted(range(p.ndim), key=lambda i: p.shape[i])
        if p.ndim >= 2 and p.shape[dims[-2]] >= 128:
            d1, d0 = dims[-2], dims[-1]
            v_row = st.setdefault("v_row", torch.zeros_like(grad_sqr.mean(dim=d0)))
            v_col = st.setdefault("v_col", torch.zeros_like(grad_sqr.mean(dim=d1)))
            v_row.copy_(decay * v_row + (1.0 - decay) * grad_sqr.mean(dim=d0))
            v_col.copy_(decay * v_col + (1.0 - decay) * grad_sqr.mean(dim=d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
            u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
        else:
            v = st.setdefault("v", torch.zeros_like(p))
            v.copy_(decay * v + (1.0 - decay) * grad_sqr)
            u = g * v ** -0.5
        u = u / torch.clamp(_rms(u) / 1.0, min=1.0)
        u = u * lr
        rms_p = _rms(p)
        u = u * torch.where(rms_p <= 1e-3, torch.full_like(rms_p, 1e-3), rms_p)
        if wd:
            u = u + wd * p
        return u


class _Wrapper(torch.optim.Optimizer):
    """Base of the wrappers: the inner optimizer's group dicts are this
    optimizer's own (an LR set here is the LR the inner step reads)."""

    def __init__(self, inner: torch.optim.Optimizer):
        self.inner = inner
        super().__init__(inner.param_groups, {})

    def _params(self) -> list:
        return [p for g in self.param_groups for p in g["params"]]

    def _load_inner(self, state: dict) -> None:
        """Load the inner optimizer's state. torch's `load_state_dict` puts
        new group dicts in its place, which become this optimizer's too (an
        LR set here after a resume must still reach the inner step)."""
        self.inner.load_state_dict(state)
        self.param_groups = self.inner.param_groups


class Lookahead(_Wrapper):
    """The JAX package's `lookahead` over an inner optimizer: the slow
    weights start at the parameters; every 6 inner steps the parameters land
    at slow + 0.5 * (fast - slow), which becomes the slow weights, computed
    as the JAX transform's update p + (target - p)."""

    def __init__(self, inner: torch.optim.Optimizer):
        super().__init__(inner)
        self.count = 0
        self.slow = [p.detach().clone() for p in self._params()]

    @torch.no_grad()
    def step(self, closure=None):
        sync = (self.count + 1) % 6 == 0
        before = [p.detach().clone() for p in self._params()] if sync else None
        self.inner.step()
        self.count += 1
        if sync:
            for p, p0, s in zip(self._params(), before, self.slow):
                target = s + 0.5 * (p - s)
                p.copy_(p0 + (target - p0))
                s.copy_(target)

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count,
                "slow": [s.clone() for s in self.slow]}

    def load_state_dict(self, state: dict) -> None:
        self._load_inner(state["inner"])
        self.count = int(state["count"])
        for s, v in zip(self.slow, state["slow"]):
            s.copy_(v)


class MultiSteps(_Wrapper):
    """optax.MultiSteps(inner, k) over a torch optimizer: each `step()` is
    one mini-step. The gradients accumulate as a running mean (Welford:
    acc + (g - acc) / (mini_step + 1); a None gradient counts as 0); on
    mini-steps 0 .. k-2 neither the parameters nor the inner state move; on
    mini-step k-1 the inner optimizer steps on the mean (coupled L2, the LR
    and its step count apply then) and the accumulator restarts at 0.
    `reset()` drops a partial accumulator (`accum_drop_remainder`)."""

    def __init__(self, inner: torch.optim.Optimizer, k: int):
        super().__init__(inner)
        self.k = int(k)
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = [torch.zeros_like(p) for p in self._params()]

    @torch.no_grad()
    def step(self, closure=None):
        n = self.mini_step
        for p, a in zip(self._params(), self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            a.copy_(a + (g - a) / (n + 1))
        if n == self.k - 1:
            for p, a in zip(self._params(), self.acc):
                p.grad = a.clone()
            self.inner.step()
            for a in self.acc:
                a.zero_()
            self.gradient_step += 1
        self.mini_step = (n + 1) % self.k

    def reset(self) -> None:
        self.mini_step = 0
        for a in self.acc:
            a.zero_()

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "acc": [a.clone() for a in self.acc]}

    def load_state_dict(self, state: dict) -> None:
        self._load_inner(state["inner"])
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])
        for a, v in zip(self.acc, state["acc"]):
            a.copy_(v)


def reset_multisteps_accum(optimizer) -> None:
    """Zero the accumulator of every MultiSteps in `optimizer` (a no-op
    without one); the inner state and `gradient_step` stay."""
    while isinstance(optimizer, _Wrapper):
        if isinstance(optimizer, MultiSteps):
            optimizer.reset()
        optimizer = optimizer.inner


def create_optimizer(opt: str, params, lr: float,
                     weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """The JAX factory's names (its `create_optimizer(..., params=...)`):
    `lookahead_<name>` wraps <name> in Lookahead; the last `_` part names
    the optimizer; an unknown name is a ValueError and `adahessian` needs the
    baseline handler's second-order step."""
    opt_lower = opt.lower()
    parts = opt_lower.split("_")
    base = parts[-1]
    params = list(params)
    if base == "adahessian":
        raise NotImplementedError(
            "adahessian needs Hessian-diagonal estimates: build it with "
            "advmil_tpu_torch.train.optim.AdaHessian and a second-order step "
            "(BaselineHandler does this for opt_net: adahessian)")
    if base == "adam":
        tx = adam_with_l2(params, lr, weight_decay=weight_decay)
    elif base in OPTIMIZER_NAMES:
        tx = FactoryOptimizer(params, base, lr, weight_decay=weight_decay)
    else:
        raise ValueError(f"Invalid optimizer {opt_lower}")
    if len(parts) > 1 and parts[0] == "lookahead":
        tx = Lookahead(tx)
    return tx


# ---------------------------------------------------------------------------
# AdaHessian (the baseline handler's second-order optimizer)
# ---------------------------------------------------------------------------

def rademacher_like(params, generator: torch.Generator | None = None) -> list:
    """One Rademacher (+-1) tensor per parameter, from `generator` (on the
    parameters' device)."""
    return [(torch.randint(0, 2, p.shape, generator=generator, device=p.device)
             * 2 - 1).to(p.dtype) for p in params]


def hutchinson_diag(loss: torch.Tensor, params: list, zs: list) -> tuple:
    """(gradients, z * (H z)): the loss's gradients and the Hutchinson
    estimate of its Hessian diagonal, by a double backward (the graph of
    the first is kept for the second)."""
    grads = torch.autograd.grad(loss, params, create_graph=True)
    hz = torch.autograd.grad(grads, params, grad_outputs=zs)
    return ([g.detach() for g in grads],
            [h.detach() * z for h, z in zip(hz, zs)])


class AdaHessian(torch.optim.Optimizer):
    """The JAX package's `adahessian`: coupled L2 on ndim > 1, Adam's first
    moment of the gradient and second moment of the Hessian diagonal,
    u = -lr * m_hat / (sqrt(max(v_hat, 0)) + 1e-8) (betas 0.9 / 0.999, Hessian
    power 1: the JAX defaults, which its handler keeps). `step` takes the
    diagonals in the order of the parameters given here. Its LR is fixed, as
    in JAX, where the transform is not under `inject_hyperparams`."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        self.order = [p for p in params if p.requires_grad]
        super().__init__(_decay_groups(self.order, weight_decay), {"lr": lr})

    @torch.no_grad()
    def step(self, hessian_diag: list):
        hd = dict(zip(self.order, hessian_diag))
        b1, b2 = 0.9, 0.999
        for group in self.param_groups:
            wd = group["weight_decay"] if group["decay"] else 0.0
            for p in group["params"]:
                g = p.grad + wd * p if wd else p.grad
                st = self.state[p]
                if not st:
                    st.update(count=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
                st["count"] += 1
                t = st["count"]
                st["mu"].copy_(b1 * st["mu"] + (1 - b1) * g)
                st["nu"].copy_(b2 * st["nu"] + (1 - b2) * hd[p] * hd[p])
                den = torch.sqrt(torch.clamp(st["nu"] / _bias_correction(b2, t),
                                             min=0.0)) + 1e-8
                p.add_(-group["lr"] * (st["mu"] / _bias_correction(b1, t)) / den)


class ReduceLROnPlateau:
    """Host-side plateau tracker, as the JAX package's: mode 'min', a relative
    threshold of 1e-4; returns the current LR multiplier, which the handler
    applies to the generator's optimizer."""

    def __init__(self, factor: float = 0.5, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0, verbose: bool = False):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.verbose = verbose
        self.best = float("inf")
        self.num_bad = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale *= self.factor
                self.num_bad = 0
                if self.verbose:
                    print(f"[lr] plateau: scaling LR by {self.factor} "
                          f"-> x{self.scale}")
        return self.scale
