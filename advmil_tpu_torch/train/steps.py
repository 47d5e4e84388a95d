"""The evaluation step (counterpart of `advmil_tpu/train/steps.py::
make_eval_step`). Training steps come with ROADMAP A7."""
from __future__ import annotations

import torch


def _median_lower(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """torch.median semantics: the lower of the two middle order statistics
    (the reference reduces its 30 samples with torch.median); quantile(0.5)
    would average them."""
    return torch.median(x, dim=dim).values


def make_eval_step(gen_model, disc_model=None, *, n_samples: int = 1,
                   zero_noise: bool = False):
    """One forward for y_hat [B, out] (and f_fake [B] when a discriminator is
    given). With n_samples > 1 the backbone embedding is computed once and
    the K noise samples run as one [K*B] batch through the head, reduced by
    the lower median. `generator` supplies the noise (on the batch's device).
    """

    @torch.inference_mode()
    def step(batch: dict, generator: torch.Generator | None = None) -> dict:
        feats, mask = batch["feats"], batch["mask"]
        H = gen_model.embed(feats, mask)
        y_hat = gen_model.head(H, zero_noise=zero_noise, generator=generator)
        out = {"y_hat": y_hat}
        if disc_model is not None:
            out["f_fake"] = disc_model(feats, y_hat, mask).float().reshape(-1)
        if n_samples > 1:
            B = H.shape[0]
            Hk = H.repeat(n_samples, *([1] * (H.dim() - 1)))       # [K*B, d]
            dist = gen_model.head(Hk, zero_noise=zero_noise, generator=generator)
            dist = dist.reshape(n_samples, B, -1)                  # [K, B, out]
            out["dist_y_hat"] = dist.transpose(0, 1)
            out["avg_y_hat"] = _median_lower(dist, dim=0)
        return out

    return step
