"""The losses the evaluator reports (counterparts of `advmil_tpu/losses.py`):
the reconstruction loss, the fake-only discriminator loss and the generator's
adversarial loss, as plain means. Training losses, per-sample weights and the
real/fake pair come with ROADMAP A5."""
from __future__ import annotations

import torch

_EPS_LOG = 1e-8


def recon_loss(pred_t, t, e, alpha: float = 0.0, gamma: float = 1.0,
               norm: str = "l1", cur_alpha=None):
    """Continuous survival reconstruction loss.

    event (e=1): |t_hat - t|; censored (e=0): relu(gamma - (t_hat - t));
    (1-alpha) * (obs + cen) + alpha * obs, then the mean.
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
    return ((1.0 - _alpha) * (loss_obs + loss_cen) + _alpha * loss_obs).mean()


def real_fake_loss(real, fake, which: str = "bce"):
    """Discriminator loss on the fake scores alone (`real=None`, the eval
    call). `bce` keeps the reference's form -mean(1 - log(sigmoid(fake) + 1e-8))."""
    if real is not None:
        raise NotImplementedError("the real/fake pair loss comes with training "
                                  "(ROADMAP A5)")
    fake = fake.reshape(-1)
    if which == "bce":
        return -(1.0 - torch.log(torch.sigmoid(fake) + _EPS_LOG)).mean()
    if which == "hinge":
        return torch.relu(1.0 + fake).mean()
    if which == "wasserstein":
        return fake.mean()
    raise ValueError(f"real_fake_loss `which` must be bce/hinge/wasserstein, got {which}")


def fake_generator_loss(fake_score):
    """Generator adversarial loss: -mean(pre-sigmoid fake score)."""
    return -fake_score.reshape(-1).mean()
