"""Metric evaluators for continuous, discrete and Cox outputs (counterparts
of `advmil_tpu/eval/evaluator.py`): collected predictions are host numpy
arrays; the loss-valued metrics call the port's torch losses on CPU f32."""
from __future__ import annotations

import numpy as np
import torch

from .. import losses
from .cindex import concordance_index


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


class _BaseEvaluator:
    valid_metrics: list

    def compute(self, data: dict, metrics: list) -> dict:
        for m in metrics:
            assert m in self.valid_metrics, f"unknown metric {m}"
        self._pre_compute({k: np.asarray(v) for k, v in data.items()
                           if v is not None})
        return {m: float(getattr(self, "_" + m)()) for m in metrics}


class ContSurvEvaluator(_BaseEvaluator):
    """Continuous-time survival metrics."""

    valid_metrics = ["c_index", "loss_recon", "loss_recon_org",
                     "loss_fake_netD", "loss_fake_netG", "avg_fake",
                     "event_t_rae", "nonevent_t_rae", "event_t_nre",
                     "nonevent_t_nre", "mae"]

    def __init__(self, end_time=1.0, recon_loss=None, disc_loss=None):
        self.end_time = float(end_time)
        self.recon_loss = recon_loss  # callable(pred, t, e, **kw) or None
        self.disc_loss = disc_loss    # callable(real, fake) or None

    def _pre_compute(self, data):
        self.y = data["y"]
        self.t = data["y"][:, 0]
        self.e = data["y"][:, 1]
        self.f_fake = np.squeeze(data["f_fake"]) if "f_fake" in data else None
        key = "avg_y_hat" if "avg_y_hat" in data else "y_hat"
        self.y_hat = np.squeeze(data[key])

    def _c_index(self):
        return concordance_index(self.y, self.y_hat[:, None])

    def _loss_recon(self):
        if self.recon_loss is None:
            return 0.0
        return float(self.recon_loss(_t(self.y_hat), _t(self.t), _t(self.e)))

    def _loss_recon_org(self):
        if self.recon_loss is None:
            return 0.0
        return float(self.recon_loss(_t(self.y_hat), _t(self.t), _t(self.e),
                                     cur_alpha=0.0))

    def _mae(self):
        """The default reconstruction loss (l1, gamma 1, alpha 0)."""
        return float(losses.recon_loss(_t(self.y_hat), _t(self.t), _t(self.e),
                                       cur_alpha=0.0))

    def _loss_fake_netD(self):
        if self.disc_loss is None or self.f_fake is None:
            return 0.0
        return float(self.disc_loss(None, _t(self.f_fake)))

    def _loss_fake_netG(self):
        return float(losses.fake_generator_loss(_t(self.f_fake)))

    def _avg_fake(self):
        return float(np.mean(self.f_fake))

    # error decompositions scaled by end_time; empty subsets give nan
    @staticmethod
    def _safe_mean(x):
        return float(np.mean(x)) if x.size else float("nan")

    def _event_t_rae(self):
        idx = self.e == 1
        return self._safe_mean(np.abs(self.t[idx] - self.y_hat[idx]) / self.end_time)

    def _nonevent_t_rae(self):
        idx = self.e == 0
        diff = self.t[idx] - self.y_hat[idx]
        return self._safe_mean(np.maximum(diff, 0.0) / self.end_time)

    def _event_t_nre(self):
        idx = self.e == 1
        return self._safe_mean((self.y_hat[idx] - self.t[idx]) / self.end_time)

    def _nonevent_t_nre(self):
        idx = self.e == 0
        diff = self.y_hat[idx] - self.t[idx]
        return self._safe_mean(-np.maximum(-diff, 0.0) / self.end_time)


class DiscSurvEvaluator(_BaseEvaluator):
    """Discrete-time survival metrics."""

    valid_metrics = ["c_index", "loss_mle", "loss_mle_org", "loss_fake_netD",
                     "loss_fake_netG", "avg_fake"]

    def __init__(self, mle_loss=None, disc_loss=None):
        self.mle_loss = mle_loss
        self.disc_loss = disc_loss

    def _pre_compute(self, data):
        self.y = data["y"]
        self.t = data["y"][:, 0]
        self.e = data["y"][:, 1]
        self.f_fake = np.squeeze(data["f_fake"]) if "f_fake" in data else None
        key = "avg_y_hat" if "avg_y_hat" in data else "y_hat"
        self.y_hat = data[key]

    def _c_index(self):
        return concordance_index(self.y, self.y_hat)

    def _loss_mle(self):
        assert self.mle_loss is not None
        return float(self.mle_loss(_t(self.y_hat), _t(self.t), _t(self.e)))

    def _loss_mle_org(self):
        assert self.mle_loss is not None
        return float(self.mle_loss(_t(self.y_hat), _t(self.t), _t(self.e),
                                   cur_alpha=0.0))

    def _loss_fake_netD(self):
        if self.disc_loss is None or self.f_fake is None:
            return 0.0
        return float(self.disc_loss(None, _t(self.f_fake)))

    def _loss_fake_netG(self):
        return float(losses.fake_generator_loss(_t(self.f_fake)))

    def _avg_fake(self):
        return float(np.mean(self.f_fake))


class CoxSurvEvaluator(_BaseEvaluator):
    """Cox proportional-hazard metrics: the C-index of the one-column
    prediction (the reference's convention, risk = -prediction) and the
    partial likelihood over the whole split."""

    valid_metrics = ["c_index", "loss_ple"]

    def __init__(self, ple_loss=None):
        self.ple_loss = ple_loss

    def _pre_compute(self, data):
        self.y = data["y"]
        self.t = data["y"][:, 0]
        self.e = data["y"][:, 1]
        key = "avg_y_hat" if "avg_y_hat" in data else "y_hat"
        self.y_hat = np.squeeze(data[key])

    def _c_index(self):
        return concordance_index(self.y, self.y_hat[:, None])

    def _loss_ple(self):
        if self.ple_loss is None:
            return 0.0
        return float(self.ple_loss(_t(self.y_hat), _t(self.t), _t(self.e)))


def prepare_evaluator(output_type: str, **kws):
    if output_type == "continuous":
        return ContSurvEvaluator(**kws)
    if output_type == "discrete":
        return DiscSurvEvaluator(**kws)
    if output_type == "prohazard":
        return CoxSurvEvaluator(**kws)
    raise ValueError(f"unknown evaluator type {output_type}")
