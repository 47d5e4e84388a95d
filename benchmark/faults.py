"""Faults planted under the timed path, to show that the comparison catches
them (the tests and `calibrate.py`). Each maker takes the run's state and
returns the hook `Probe` calls."""
from __future__ import annotations

import contextlib
import dataclasses

import torch


def half_batch(st):
    """Half of each batch's real bags left out: their sample_mask set to 0,
    so the step's means run over the rest."""
    def hook(batch):
        keep = batch.sample_mask.copy()
        real = keep.nonzero()[0]
        keep[real[(len(real) + 1) // 2:]] = 0.0
        return dataclasses.replace(batch, sample_mask=keep)
    return hook


def frozen_state(st):
    """A step that returns its state unchanged: the parameters are put back
    after each checked step."""
    def hook():
        with torch.no_grad():
            for model, p0 in ((st.handler.gen_model, st.probe.params0[0]),
                              (st.handler.disc_model, st.probe.params0[1])):
                for k, p in model.named_parameters():
                    p.copy_(p0[k].to(p.device))
    return hook


def flash_scale(st):
    """The flash op's dropout scale wrong: its output (and so its gradients)
    times 1 - p, as a kernel that drops weights without rescaling the kept
    ones by 1 / (1 - p). The op is swapped where the ESAT layer calls it, for
    the recorded steps only."""
    from advmil_tpu_torch.models import layers

    @contextlib.contextmanager
    def hook():
        orig = layers.masked_flash_attention

        def wrong(q, k, v, mask, *, dropout_p: float = 0.0, seed=None):
            out = orig(q, k, v, mask, dropout_p=dropout_p, seed=seed)
            return out * (1.0 - dropout_p)

        layers.masked_flash_attention = wrong
        try:
            yield
        finally:
            layers.masked_flash_attention = orig
    return hook


def answer(st):
    """An answer altered where it is produced: the first bag's 30-sample
    median moved by 0.05."""
    def hook(out):
        out = dict(out)
        avg = out["avg_y_hat"].clone()
        avg.view(-1)[0] += 0.05
        out["avg_y_hat"] = avg
        return out
    return hook


TRAIN = {"half_batch": half_batch, "frozen_state": frozen_state, "flash_scale": flash_scale}
EVAL = {"answer": answer}
