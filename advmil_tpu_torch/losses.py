"""Survival and adversarial losses (counterparts of `advmil_tpu/losses.py`):
the reconstruction loss, the baselines' MSE, discrete-time likelihood and
Cox partial likelihood, the real/fake discriminator loss, the generator's
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


def mse_loss(pred_t, t, e, include_censored: bool = False, weight=None):
    """(t_hat - t)^2 on events, and on censored samples too with
    `include_censored` (the ESAT baseline's loss); the (weighted) mean."""
    pred_t = pred_t.reshape(-1)
    t = t.reshape(-1).to(pred_t.dtype)
    e = e.reshape(-1).to(pred_t.dtype)
    sq = (pred_t - t) * (pred_t - t)
    loss = e * sq
    if include_censored:
        loss = loss + (1.0 - e) * sq
    return _wmean(loss, weight)


def surv_mle_loss(hazards, t, e, alpha: float = 0.0, eps: float = 1e-7,
                  cur_alpha=None, weight=None):
    """Discrete-time negative log-likelihood (MCAT-style). hazards [B, T];
    t [B] the bin index; e [B] the event indicator. With S[k] = prod over
    j < k of (1 - h[j]) (S[0] = 1): events -log S[t] - log h[t], censored
    -log S[t + 1]; (1 - alpha) * (cens + uncens) + alpha * uncens, then the
    (weighted) mean. Logs are taken of values clamped at `eps`."""
    B = hazards.shape[0]
    t = t.reshape(B, 1).long()
    c = 1.0 - e.reshape(B, 1).to(hazards.dtype)
    S = torch.cumprod(1.0 - hazards, dim=1)
    S_padded = torch.cat([torch.ones_like(c), S], dim=1)
    s_at_t = S_padded.gather(1, t)
    h_at_t = hazards.gather(1, t)
    s_at_t1 = S_padded.gather(1, t + 1)
    uncensored = -(1.0 - c) * (torch.log(torch.clamp(s_at_t, min=eps))
                               + torch.log(torch.clamp(h_at_t, min=eps)))
    censored = -c * torch.log(torch.clamp(s_at_t1, min=eps))
    _alpha = alpha if cur_alpha is None else cur_alpha
    per_sample = ((1.0 - _alpha) * (censored + uncensored) + _alpha * uncensored)[:, 0]
    return _wmean(per_sample, weight)


def surv_ple_loss(y_hat, t, e, weight=None):
    """Cox partial likelihood, the risk set of sample i being every j with
    t_j >= t_i (a broadcast [B, B] mask; tied times share a risk set).
    y_hat is clipped at 10 as in the reference. With `weight` (0/1 per
    sample) excluded samples drop from the risk sets and the mean, which is
    over the kept samples."""
    theta = torch.clamp(y_hat.reshape(-1), max=10.0)
    t = t.reshape(-1)
    e = e.reshape(-1).to(theta.dtype)
    R = (t[None, :] >= t[:, None]).to(theta.dtype)
    if weight is not None:
        w = torch.as_tensor(weight, dtype=theta.dtype, device=theta.device).reshape(-1)
        R = R * w[None, :]
        e = e * w
    risk = (torch.exp(theta)[None, :] * R).sum(dim=1)
    per_sample = (theta - torch.log(torch.clamp(risk, min=1e-30))) * e
    if weight is None:
        return -per_sample.mean()
    return -per_sample.sum() / torch.clamp(w.sum(), min=1e-12)


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
