"""The adversarial and baseline training steps, the supervised-loss factory
and the evaluation step (counterparts of `advmil_tpu/train/steps.py::
make_adv_train_step`, `make_base_train_step`, `make_supervised_loss` and
`make_eval_step`).

Under a process grid (`parallel/`) the models see this rank's rows of the
batch, while label, sample_mask and visible are global. Each step gathers
the per-bag outputs to the global batch (`comm.gather_rows`, backward:
reduce-scatter) and computes every loss on it, so masked means count the
global weights, the Cox risk sets span ranks and each rank's loss is the
single-process loss. Each rank back-propagates loss / world
(`comm.for_backward`); the gradients are summed over the world in one flat
buffer before every optimizer step (`comm.reduce_grads`; with
`MultiSteps`, before each micro-step), which gives the single-process
gradient of the global loss. In a single-process run every one of these
helpers is the identity."""
from __future__ import annotations

import functools

import torch

from .. import losses
from ..models.layers import Rngs
from ..parallel import comm
from ..parallel.mesh import local_rows
from .optim import AdaHessian, hutchinson_diag, rademacher_like


def _median_lower(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """torch.median semantics: the lower of the two middle order statistics
    (the reference reduces its 30 samples with torch.median); quantile(0.5)
    would average them."""
    return torch.median(x, dim=dim).values


def make_supervised_loss(task: str, cfg: dict):
    """The task's supervised loss bound to its config keys; `surv_mse` is
    the ESAT baseline's MSE."""
    if task in ("cont_gansurv", "surv_reg"):
        return functools.partial(losses.recon_loss,
                                 alpha=cfg.get("loss_recon_alpha", 0.0) or 0.0,
                                 gamma=cfg.get("loss_recon_gamma", 1.0),
                                 norm=cfg.get("loss_recon_norm", "l1"))
    if task in ("disc_gansurv", "surv_nll"):
        return functools.partial(losses.surv_mle_loss,
                                 alpha=cfg.get("loss_mle_alpha", 0.0) or 0.0)
    if task == "surv_cox":
        return losses.surv_ple_loss
    if task == "surv_mse":
        return functools.partial(losses.mse_loss,
                                 include_censored=cfg.get("loss_use_censored", False))
    raise ValueError(f"unknown task {task}")


def make_eval_step(gen_model, disc_model=None, *, n_samples: int = 1,
                   zero_noise: bool = False):
    """One forward in eval mode for y_hat [B, out] (and f_fake [B] when a
    discriminator is given), reduced over n_samples > 1 samples by the lower
    median.

    A generator (a model with `embed` / `head`) computes the backbone
    embedding once and runs the K noise samples as one [K, B] batch through
    the head; `generator` supplies the noise (on the batch's device). A
    model without them (the baseline SurvNet) draws no noise, so its K
    samples are K copies of its one forward. Outputs are per bag of the
    batch the step was given (a rank's rows under a grid).
    """
    has_embed_head = hasattr(gen_model, "embed") and hasattr(gen_model, "head")

    @torch.inference_mode()
    def step(batch: dict, generator: torch.Generator | None = None) -> dict:
        feats, mask = batch["feats"], batch["mask"]
        for m in (gen_model, disc_model):
            if m is not None:
                m.eval()
        if has_embed_head:
            H = gen_model.embed(feats, mask, batch.get("extra"))
            y_hat = gen_model.head(H, zero_noise=zero_noise, generator=generator)
        else:
            y_hat = gen_model(feats, mask, batch.get("extra"))
        out = {"y_hat": y_hat}
        if disc_model is not None:
            out["f_fake"] = disc_model(feats, y_hat, mask).float().reshape(-1)
        if n_samples > 1:
            B = y_hat.shape[0]
            if has_embed_head:
                Hk = H.repeat(n_samples, *([1] * (H.dim() - 1))).reshape(
                    n_samples, *H.shape)                           # [K, B, d]
                dist = gen_model.head(Hk, zero_noise=zero_noise, generator=generator)
            else:
                dist = y_hat.repeat(n_samples, 1)
            dist = dist.reshape(n_samples, B, -1)                  # [K, B, out]
            out["dist_y_hat"] = dist.transpose(0, 1)
            out["avg_y_hat"] = _median_lower(dist, dim=0)
        return out

    return step


def _set_requires_grad(model, flag: bool) -> None:
    for p in model.parameters():
        p.requires_grad_(flag)


def make_adv_train_step(gen_model, disc_model, opt_G, opt_D, *, loss_netD: str,
                        coef_gan: float, l1_coef: float, gen_updates: int,
                        sup_loss_fn, task: str = "cont_gansurv", nbins: int = 4):
    """The adversarial step of one batch: a D update, then `gen_updates` G
    updates.

    batch: feats [B, N, C], mask [B, N], label [B, 2] (t, e), sample_mask [B],
    visible [B] (0 hides a label from the supervised loss in semi-supervised
    training), and in graph mode `extra`, the graph tables G reads (D sees the
    node features and mask only, as in the JAX package). Modes follow the
    reference's train() / eval() flips:
    - D phase: G in eval mode with noise on (no dropout), its prediction
      detached; D in train mode scores the pair (t_real, t_fake) in one call
      (shared patch embedding, independent dropout masks); fake pairs are
      weighted by sample_mask.
    - G phase: G in train mode; D in eval mode with its parameters frozen;
      loss = supervised (weighted by visible) + coef_gan * adversarial
      (weighted by sample_mask) + l1_coef * sum |w_G|.
    cont_gansurv: the real pair is t [B, 1], weighted by event * visible; the
    supervised loss takes pred[:, 0]. disc_gansurv (label t is a bin index):
    the real pair is the per-bin label times its mask from `get_label_mask`,
    weighted by sample_mask alone; both fake pairs are masked the same way;
    the supervised loss takes the whole [B, nbins] hazards.
    Returns (metrics, collect) as device tensors: the caller syncs once per
    epoch. collect holds the D phase's predictions and fake scores, which the
    reference logs as the training-set predictions (the global batch's).
    """
    is_disc_task = task == "disc_gansurv"

    def step(batch: dict, rngs: Rngs):
        feats, mask, extra = batch["feats"], batch["mask"], batch.get("extra")
        t, e = batch["label"][:, 0], batch["label"][:, 1]
        smask = batch["sample_mask"]
        visible = batch["visible"] * smask
        y_mask = None
        if is_disc_task:
            # the reference passes the label's second column into the
            # censorship argument of get_label_mask (reference
            # model_handler.py:382), so 1 - e goes into this `e`; "fixing" it
            # swaps which patients get the one-hot label
            y_disc, y_mask = losses.get_label_mask(t, 1.0 - e, nbins)
            y_mask_rows = local_rows(y_mask)

        # ---- D phase: generator in eval mode (dropout off, noise on) ----
        gen_model.eval()
        disc_model.train()
        with torch.no_grad():
            pred_eval = gen_model(feats, mask, extra, zero_noise=False,
                                  generator=rngs.device)
        if is_disc_task:
            t_real, fake_in = local_rows(y_disc * y_mask), pred_eval * y_mask_rows
            real_w = smask      # visibility does not gate the disc task's real pairs
        else:
            t_real, fake_in = local_rows(t[:, None]), pred_eval
            real_w = (e == 1).to(torch.float32) * visible
        f_real, f_fake = disc_model(feats, (t_real, fake_in), mask, rngs)
        f_real, f_fake = comm.gather_rows(f_real.float()), comm.gather_rows(f_fake.float())
        loss_D = losses.real_fake_loss(f_real, f_fake, which=loss_netD,
                                       real_weight=real_w, fake_weight=smask)
        opt_D.zero_grad(set_to_none=True)
        comm.for_backward(loss_D).backward()
        comm.reduce_grads(disc_model.parameters())
        opt_D.step()
        metrics = {"Loss_D": loss_D.detach(),
                   "D_real": losses._wmean(f_real.detach().reshape(-1), real_w),
                   "D_fake": losses._wmean(f_fake.detach().reshape(-1), smask)}
        collect = {"y_hat": comm.gather_rows_nograd(pred_eval),
                   "f_fake": f_fake.detach().reshape(-1)}

        # ---- G phase (x gen_updates): D in eval mode and frozen ----
        gen_model.train()
        disc_model.eval()
        _set_requires_grad(disc_model, False)
        try:
            for _ in range(gen_updates):
                pred = gen_model(feats, mask, extra, zero_noise=False,
                                 generator=rngs.device, rng=rngs)
                f_fake_g = disc_model(feats, pred * y_mask_rows if is_disc_task else pred,
                                      mask).float()
                f_fake_g, pred = comm.gather_rows(f_fake_g), comm.gather_rows(pred)
                gen_loss = losses.fake_generator_loss(f_fake_g, weight=smask)
                t_reg = sup_loss_fn(pred if is_disc_task else pred[:, 0], t, e,
                                    weight=visible)
                total = t_reg if coef_gan == 0.0 else t_reg + coef_gan * gen_loss
                total = total + losses.loss_reg_l1(gen_model.parameters(), l1_coef)
                opt_G.zero_grad(set_to_none=True)
                comm.for_backward(total).backward()
                comm.reduce_grads(gen_model.parameters())
                opt_G.step()
                metrics.update({
                    "Loss_G_fake": gen_loss.detach(), "Loss_G_time": t_reg.detach(),
                    "Loss_G_total": total.detach(),
                    "D_fake_avg": losses._wmean(f_fake_g.detach().reshape(-1), smask)})
        finally:
            _set_requires_grad(disc_model, True)
        return metrics, collect

    return step


def make_base_train_step(model, opt, *, task: str, l1_coef: float, sup_loss_fn,
                         z_fn=rademacher_like):
    """The baseline step of one batch: one supervised update of `model` (in
    train mode, dropout from `rngs`). The loss takes the whole prediction
    [B, T] for surv_nll and its first column otherwise, weighted by
    sample_mask; the total adds l1_coef * sum |w|. Returns (metrics,
    collect) as device tensors; collect holds the train-mode predictions,
    which the reference logs as the training-set predictions.

    An `AdaHessian` `opt` gets the Hutchinson estimate of the Hessian
    diagonal in `opt.step`, z * (H z), from a double backward through the
    same forward (same dropout masks); `z_fn(params, generator)` draws the
    Rademacher z (default: `rngs.device`; the parameters' shape is global, so
    every rank draws the same z). Under a grid the double backward runs
    through the collectives' backward rules as well, and both the gradients
    and z * (H z) are summed over the world."""
    is_disc_task = task == "surv_nll"
    second_order = isinstance(opt, AdaHessian)

    def step(batch: dict, rngs: Rngs):
        t, e = batch["label"][:, 0], batch["label"][:, 1]
        model.train()
        pred = comm.gather_rows(model(batch["feats"], batch["mask"], batch.get("extra"),
                                      rng=rngs))
        loss = sup_loss_fn(pred if is_disc_task else pred[:, 0], t, e,
                           weight=batch["sample_mask"])
        total = loss + losses.loss_reg_l1(model.parameters(), l1_coef)
        opt.zero_grad(set_to_none=True)
        if second_order:
            params = [p for p in model.parameters() if p.requires_grad]
            grads, hdiag = hutchinson_diag(comm.for_backward(total), params,
                                           z_fn(params, rngs.device))
            grads, hdiag = comm.reduce_tensors(grads), comm.reduce_tensors(hdiag)
            for p, g in zip(params, grads):
                p.grad = g
            opt.step(hdiag)
        else:
            comm.for_backward(total).backward()
            comm.reduce_grads(model.parameters())
            opt.step()
        return ({"loss_supervision": loss.detach(), "loss_total": total.detach()},
                {"y_hat": pred.detach()})

    return step
