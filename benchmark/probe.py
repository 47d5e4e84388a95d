"""The benchmark's wrappers around the calls into each layer of the port.

They are instance attributes set on the handler (`_ship`, `train_step`,
`_eval_step`); the program is not edited. In every run they count batches,
bags and patch slots; in the traced run they also time the host's wall in
each call and mark it for the profiler; over the first steps (or the first
evaluation pass) they record what the reference needs to replay them: each
batch's bags and labels, every random draw the step takes (`Recorder`), the
optimizers' first moments after step 1, the step's D-phase predictions, its
G-phase predictions and ESAT encoder outputs (G in train mode, by forward
hooks held only over the recorded steps) and the parameters before and
after. Recording runs over at least `record_steps` steps and on until one
of them took the flash branch (`flash_regions`: the padded region count
from which G's attention runs the flash op in train mode) and one had two
real bags or more (the step's means over the batch).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

_DRAWS = (torch.rand, torch.randn, torch.randint)
MAX_RECORDED = 64          # steps; a cohort without such steps stops here
ENCODER = "backbone.encoder_0"


class Recorder(TorchFunctionMode):
    """Keeps a copy of every draw from an explicit torch.Generator, in
    order: ("rand" | "randn" | "randint", tensor)."""

    def __init__(self):
        super().__init__()
        self.draws = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _DRAWS and isinstance(kwargs.get("generator"), torch.Generator):
            self.draws.append((func.__name__, out.detach().clone()))
        return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Probe:
    def __init__(self, handler, record_steps: int = 0, record_eval_pass: bool = False,
                 flash_regions: int | None = None):
        self.h = handler
        self.device = handler.device
        self.record_steps = record_steps
        self.flash_regions = flash_regions
        self.recording = record_steps > 0
        self.after_step = None       # called with the window's step count (traced run)
        self.record_eval = record_eval_pass
        self.timing = False          # host wall per call (traced run)
        self.counting = False        # window statistics
        self.reset()
        self.steps_seen = 0
        self.records = []            # per recorded step / eval batch
        self.params0 = None
        self.first_moments = None
        self.params_after = None
        self.faults = {}             # name -> callable, for the fault tests
        self._orig_ship = handler._ship
        handler._ship = self._ship
        if getattr(handler, "train_step", None) is not None:
            self._orig_step = handler.train_step
            handler.train_step = self._train_step
        self._orig_eval_step = handler._eval_step
        self._eval_wrapped = {}
        handler._eval_step = self._eval_step
        self._last_batch = None

    def reset(self):
        self.n_steps = 0
        self.n_bags = 0
        self.real_tokens = 0
        self.padded_tokens = 0
        self.ship_s = 0.0
        self.step_s = 0.0
        self.shapes = []             # (B, N, real sizes of real bags)

    # -- _ship ------------------------------------------------------------
    def _ship(self, batch, train: bool = False, visible=None):
        self._last_batch = batch
        if "half_batch" in self.faults:
            batch = self.faults["half_batch"](batch)
        if self.counting:
            keep = batch.sample_mask.astype(bool)
            sizes = batch.mask.sum(axis=1)
            self.n_bags += int(keep.sum())
            self.real_tokens += int(sizes[keep].sum())
            self.padded_tokens += int(batch.mask.size)
            self.shapes.append((batch.mask.shape[0], batch.mask.shape[1],
                                sizes[keep].astype(np.int64)))
        if not self.timing:
            return self._orig_ship(batch, train=train, visible=visible)
        with torch.profiler.record_function("bench._ship"):
            t0 = time.perf_counter()
            out = self._orig_ship(batch, train=train, visible=visible)
            self.ship_s += time.perf_counter() - t0
        return out

    def _batch_record(self, batch) -> dict:
        keep = batch.sample_mask.astype(bool)
        return {"idx": batch.idx.copy(), "keep": keep, "sizes": batch.mask.sum(axis=1),
                "B": int(batch.mask.shape[0]), "N": int(batch.mask.shape[1])}

    # -- train_step -------------------------------------------------------
    @staticmethod
    def _snapshot(model):
        return {k: v.detach().float().cpu().clone() for k, v in model.named_parameters()}

    def _train_step(self, batch, rngs):
        i = self.steps_seen
        self.steps_seen += 1
        if self.recording:
            out = self._recorded_step(i, batch, rngs)
            flash = any(r["flash"] for r in self.records) or self.flash_regions is None
            several = any(r["keep"].sum() >= 2 for r in self.records)
            if (i + 1 >= self.record_steps and flash and several) or i + 1 >= MAX_RECORDED:
                self.recording = False
            return out
        out = self._timed(self._orig_step, "bench.train_step", batch, rngs)
        self._count_step()
        return out

    def _count_step(self):
        if self.counting:
            self.n_steps += 1
            if self.after_step is not None:
                self.after_step(self.n_steps)

    def _timed(self, fn, label, *args):
        if not self.timing:
            return fn(*args)
        with torch.profiler.record_function(label):
            t0 = time.perf_counter()
            out = fn(*args)
            self.step_s += time.perf_counter() - t0
        return out

    def _recorded_step(self, i, batch, rngs):
        h = self.h
        if i == 0:
            self.params0 = (self._snapshot(h.gen_model), self._snapshot(h.disc_model))
        rec = self._batch_record(self._last_batch)
        rec["flash"] = self.flash_regions is not None and rec["N"] // 16 >= self.flash_regions
        taps = {}

        def tap(name):
            def hook(module, args, out):
                if module.training:
                    taps[name] = out.detach().float().cpu()
            return hook

        mods = dict(h.gen_model.named_modules())
        hooks = [h.gen_model.register_forward_hook(tap("g_pred"))]
        if ENCODER in mods:
            hooks.append(mods[ENCODER].register_forward_hook(tap("g_enc")))
        broken = self.faults.get("flash_scale", contextlib.nullcontext)
        try:
            with Recorder() as r, broken():
                metrics, collect = self._orig_step(batch, rngs)
        finally:
            for hk in hooks:
                hk.remove()
        if "frozen_state" in self.faults:
            self.faults["frozen_state"]()
        _sync(self.device)
        rec["draws"] = r.draws
        rec["metrics"] = {k: float(v) for k, v in metrics.items()}
        rec["y_hat"] = collect["y_hat"].detach().float().cpu().reshape(-1)
        rec["g_pred"] = taps["g_pred"].reshape(-1)
        rec["g_enc"] = taps.get("g_enc")
        self.records.append(rec)
        if i == 0:
            self.first_moments = tuple(
                {n: opt.state[p]["exp_avg"].detach().float().cpu().clone()
                 for n, p in model.named_parameters() if p in opt.state}
                for model, opt in ((h.gen_model, h.opt_G), (h.disc_model, h.opt_D)))
        self.params_after = (self._snapshot(h.gen_model), self._snapshot(h.disc_model))
        return metrics, collect

    # -- the evaluation step ---------------------------------------------
    def _eval_step(self, n_samples, zero_noise):
        key = (n_samples, zero_noise)
        if key not in self._eval_wrapped:
            step = self._orig_eval_step(n_samples, zero_noise)

            def wrapped(batch, gen=None):
                if self.record_eval:
                    rec = self._batch_record(self._last_batch)
                    with Recorder() as r:
                        out = step(batch, gen)
                    _sync(self.device)
                    if "answer" in self.faults:
                        out = self.faults["answer"](out)
                    rec["draws"] = r.draws
                    rec["out"] = {k: v.detach().float().cpu() for k, v in out.items()}
                    self.records.append(rec)
                    return out
                out = self._timed(step, "bench.eval_step", batch, gen)
                self._count_step()
                return out

            self._eval_wrapped[key] = wrapped
        return self._eval_wrapped[key]


@contextlib.contextmanager
def window(probe: Probe, timing: bool):
    probe.reset()
    probe.counting, probe.timing = True, timing
    try:
        yield probe
    finally:
        probe.counting = probe.timing = False
