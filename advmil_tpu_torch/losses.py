"""Survival and adversarial losses (counterparts of `advmil_tpu/losses.py`):
the reconstruction loss, the real/fake discriminator loss, the generator's
adversarial loss and the L1 penalty. Every loss takes an optional
per-sample `weight` so padded (tail-filler) and invisible samples drop out
exactly: a weighted mean with 0/1 weights equals the reference's mean over
the real bags."""
from __future__ import annotations

import torch

_EPS_LOG = 1e-8


def _wmean(x: torch.Tensor, weight=None) -> torch.Tensor:
    """Weighted mean; with weight None a plain mean. All-zero weights give 0."""
    if weight is None:
        return x.mean()
    weight = torch.as_tensor(weight, dtype=x.dtype, device=x.device)
    denom = weight.sum()
    return torch.where(denom > 0, (x * weight).sum() / torch.clamp(denom, min=1e-12),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def recon_loss(pred_t, t, e, alpha: float = 0.0, gamma: float = 1.0,
               norm: str = "l1", cur_alpha=None, weight=None):
    """Continuous survival reconstruction loss.

    event (e=1): |t_hat - t|; censored (e=0): relu(gamma - (t_hat - t));
    (1-alpha) * (obs + cen) + alpha * obs, then the (weighted) mean.
    """
    pred_t = pred_t.reshape(-1)
    t = t.reshape(-1).to(pred_t.dtype)
    e = e.reshape(-1).to(pred_t.dtype)
    loss_obs = e * (pred_t - t).abs()
    loss_cen = (1.0 - e) * torch.relu(gamma - (pred_t - t))
    if norm == "l2":
        loss_obs = loss_obs * loss_obs
        loss_cen = loss_cen * loss_cen
    elif norm != "l1":
        raise NotImplementedError(f"recon_loss norm must be l1/l2, got {norm}")
    _alpha = alpha if cur_alpha is None else cur_alpha
    return _wmean((1.0 - _alpha) * (loss_obs + loss_cen) + _alpha * loss_obs, weight)


def real_fake_loss(real, fake, which: str = "bce", real_weight=None,
                   fake_weight=None):
    """Discriminator loss over real/fake scores; `real=None` gives the
    fake-only value used at eval time. `bce` keeps the reference's form
    -mean(1 - log(sigmoid(fake) + 1e-8)) - mean(log(sigmoid(real) + 1e-8))."""
    fake = fake.reshape(-1)
    if which == "bce":
        loss = -_wmean(1.0 - torch.log(torch.sigmoid(fake) + _EPS_LOG), fake_weight)
        if real is not None:
            real_s = torch.sigmoid(real.reshape(-1))
            loss = loss - _wmean(torch.log(real_s + _EPS_LOG), real_weight)
    elif which == "hinge":
        loss = _wmean(torch.relu(1.0 + fake), fake_weight)
        if real is not None:
            loss = loss + _wmean(torch.relu(1.0 - real.reshape(-1)), real_weight)
    elif which == "wasserstein":
        loss = _wmean(fake, fake_weight)
        if real is not None:
            loss = loss - _wmean(real.reshape(-1), real_weight)
    else:
        raise ValueError(f"real_fake_loss `which` must be bce/hinge/wasserstein, got {which}")
    return loss


def fake_generator_loss(fake_score, weight=None):
    """Generator adversarial loss: -mean(pre-sigmoid fake score)."""
    return -_wmean(fake_score.reshape(-1), weight)


def _abs_jax_grad(w: torch.Tensor) -> torch.Tensor:
    """|w| with JAX's subgradient at 0, +1 (`jnp.abs`), where torch's `abs`
    has 0: G's biases start at exactly 0, and Adam turns the L1 term's sign
    at 0 into a full step, so the two choices part ways on the first step."""
    return torch.where(w >= 0, w, -w)


def loss_reg_l1(params, coef: float) -> torch.Tensor:
    """coef * sum of |w| over the parameters (reference loss/utils.py:6-14;
    subgradient at 0 as in the JAX package); 0 when coef <= 1e-8."""
    params = list(params)
    if coef is None or coef <= 1e-8:
        return torch.zeros((), dtype=torch.float32, device=params[0].device)
    return coef * sum(_abs_jax_grad(p).sum() for p in params)
