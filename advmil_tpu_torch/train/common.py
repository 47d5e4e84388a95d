"""Handler plumbing (counterpart of `advmil_tpu/train/common.py`): the
save/load path layout, the run logger, the bucketed batcher, shipping a host
batch to the configured device, and the training loop and evaluation both
handlers share."""
from __future__ import annotations

import os
import os.path as osp
import time

import numpy as np
import torch

from ..data.bags import BucketBatcher
from ..utils.func import (EarlyStopping, add_prefix_to_filename, print_config,
                          print_metrics, rename_keys)
from ..utils.io import save_prediction
from ..utils.logging import RunLogger
from .optim import ReduceLROnPlateau, set_lr


def graph_banded(cfg: dict) -> str:
    """`graph_banded` as the batcher takes it: YAML reads a bare `off` as
    False, which means off here too."""
    v = cfg.get("graph_banded", "auto")
    return "off" if v in ("off", False) else "auto"


def resolve_device(name: str) -> torch.device:
    """The configured device; never falls back from cuda to cpu."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("config device: cuda, but torch.cuda.is_available()"
                               " is False (set device: cpu to run on the CPU)")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")


class HandlerCommon:
    """Mixin: the handler sets ``self.cfg`` and ``self.device`` first. For
    training and evaluation it provides `train_step(batch, rngs) ->
    (metrics, collect)` with `train_rngs`, `plateau_opt` and `base_lr` (the
    optimizer whose LR the plateau rule scales), `batch_log_prefix`,
    `_eval_step(n_samples, zero_noise)`, `load_params`, `save_model`, and
    `evaluator` / `metrics_list` / `ret_metrics`."""

    def _setup_paths(self):
        cfg = self.cfg
        if cfg["test"]:
            cfg["test_save_path"] = cfg["test_save_path"].format(
                cfg["test_mask_ratio"], cfg["data_split_seed"])
            cfg["test_load_path"] = cfg["test_load_path"].format(
                cfg["data_split_seed"])
            os.makedirs(cfg["test_save_path"], exist_ok=True)
            self.save_dir = cfg["test_save_path"]
            self.load_dir = cfg["test_load_path"]
        else:
            os.makedirs(cfg["save_path"], exist_ok=True)
            self.save_dir = cfg["save_path"]
            self.load_dir = cfg["save_path"]
        self.config_path = osp.join(self.save_dir, "print_config.txt")
        self.metrics_paths = {
            "best": osp.join(self.save_dir, "metrics-best.txt"),
            "last": osp.join(self.save_dir, "metrics-last.txt")}

    def _setup_logging(self):
        cfg = self.cfg
        self.patient_id = {}
        self.np_rng = np.random.default_rng(cfg["seed"])
        run_name = self.save_dir.rstrip("/").split("/")[-1]
        prj = (cfg.get("test_wandb_prj") or cfg.get("wandb_prj")) \
            if cfg.get("test") else cfg.get("wandb_prj")
        self.logger = RunLogger(prj, run_name, self.save_dir, config=cfg)
        print_config(cfg, print_to_path=self.config_path)

    def _make_bucket_batcher(self, ds) -> BucketBatcher:
        b = BucketBatcher(ds, token_budget=self.cfg["batch_token_budget"],
                          max_batch=self.cfg["batch_max_size"],
                          min_bucket=self.cfg["bucket_min"],
                          bucket_growth=float(self.cfg["bucket_growth"]),
                          edges_per_node=int(self.cfg["graph_edges_per_node"]),
                          banded=graph_banded(self.cfg))
        nw = int(self.cfg["num_workers"] or 0)
        b.prefetch_depth = max(2, nw)
        b.prefetch_workers = max(1, nw)
        return b

    def _ship(self, batch, train: bool = False) -> dict:
        """Host batch -> device tensors; feats in bf16 under precision bf16.
        A training batch also carries label, sample_mask and visible (all 1:
        every label is visible outside semi-supervised training). `extra` is
        what the backbone takes as its third argument: the dict of graph
        tables (int32 / f32 tensors) in graph mode, the region coordinates
        [B, L, 2] in patch mode with `use_coords_pe`."""
        feats = torch.from_numpy(batch.feats).to(self.device)
        if self.cfg["precision"] in ("bf16", "bfloat16"):
            feats = feats.to(torch.bfloat16)
        out = {"feats": feats,
               "mask": torch.from_numpy(batch.mask).to(self.device)}
        if "coords" in batch.extra:
            out["extra"] = torch.from_numpy(batch.extra["coords"]).to(self.device)
        elif batch.extra:
            out["extra"] = {k: torch.from_numpy(v).to(self.device)
                            for k, v in batch.extra.items()}
        if train:
            smask = torch.from_numpy(batch.sample_mask).to(self.device)
            out.update(label=torch.from_numpy(batch.label).to(self.device),
                       sample_mask=smask, visible=torch.ones_like(smask))
        return out

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------

    def _run_training(self, epochs, train_loader, name_loader, val_loaders=None,
                      val_name=None, run_name="train"):
        cfg = self.cfg
        if cfg.get("es_patience") is not None:
            self.early_stop = EarlyStopping(
                warmup=cfg["es_warmup"], patience=cfg["es_patience"],
                start_epoch=cfg["es_start_epoch"], verbose=cfg["es_verbose"])
        else:
            self.early_stop = None
        self.steplr = ReduceLROnPlateau(factor=0.5, patience=10, verbose=True)
        last_epoch = -1
        for epoch in range(epochs):
            last_epoch = epoch + 1
            cltor = self._train_each_epoch(train_loader)
            self._eval_and_print(cltor, name=name_loader, at_epoch=epoch + 1)

            val_metrics = None
            for k_i, (k, (ds, batcher)) in enumerate((val_loaders or {}).items()):
                cltor = self._run_eval(ds, batcher, n_samples=1,
                                       rng_tag=(epoch + 1) * 1024 + k_i)
                met_ci, met_loss = self._eval_and_print(cltor, name=k,
                                                        at_epoch=epoch + 1)
                if k == val_name:
                    # 'ci' keeps the reference's inverted semantics (monitored
                    # as a loss: saves the minimum C-index); 'ci_max' negates
                    mm = cfg.get("monitor_metrics", "loss")
                    val_metrics = (met_ci if mm == "ci" else -met_ci
                                   if mm == "ci_max" else met_loss)

            if val_metrics is not None and self.early_stop is not None:
                set_lr(self.plateau_opt, self.base_lr * self.steplr.step(val_metrics))
                self.early_stop(epoch, val_metrics)
                if self.early_stop.if_save_checkpoint():
                    self.save_model(epoch + 1, "best", run_name)
                    print(f"[{run_name}] best model saved at epoch {epoch + 1}")
                if self.early_stop.if_stop():
                    break
        self.save_model(last_epoch, "last", run_name)
        print(f"[{run_name}] last model saved at epoch {last_epoch}")

    def _train_each_epoch(self, loader):
        """One shuffled pass of training steps; the device is synced once,
        at the end, for the logged metrics and the collected predictions
        (every tensor of the steps' `collect`)."""
        ds, batcher = loader
        t0 = time.perf_counter()
        pending, keeps, ys, idxs = [], [], [], []
        for batch in batcher.prefetch(shuffle=True, rng=self.np_rng):
            metrics, collect = self.train_step(self._ship(batch, train=True),
                                               self.train_rngs)
            keep = batch.sample_mask.astype(bool)
            pending.append((metrics, collect))
            keeps.append(keep)
            ys.append(batch.label[keep])
            idxs.append(batch.idx[keep])
        names = list(pending[0][0])
        logged = {k: torch.stack([m[k] for m, _ in pending]).float().cpu().tolist()
                  for k in names}
        cltor = {"y": ys, "idx": idxs, **{k: [] for k in pending[0][1]}}
        for (_, collect), keep in zip(pending, keeps):
            for k, v in collect.items():
                cltor[k].append(v.float().cpu().numpy()[keep])
        self.train_timings.append((int(sum(k.sum() for k in keeps)),
                                   time.perf_counter() - t0))
        for i in range(len(pending)):
            self.logger.log({f"{self.batch_log_prefix}{k}": logged[k][i] for k in names})
        return {k: np.concatenate(v, axis=0) for k, v in cltor.items()}

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def _run_eval(self, ds, batcher, n_samples=1, zero_noise=False, rng_tag=0):
        """One pass over `batcher`; returns the host-side collections of
        every output of the eval step."""
        step = self._eval_step(n_samples, zero_noise)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((self.cfg["seed"] + 777) * 1_000_003 + rng_tag) % (1 << 62))
        t0 = time.perf_counter()
        pending, keeps, ys, idxs = [], [], [], []
        for batch in batcher.prefetch():
            pending.append(step(self._ship(batch), gen))
            keep = batch.sample_mask.astype(bool)
            ys.append(batch.label[keep])
            idxs.append(batch.idx[keep])
            keeps.append(keep)
        cltor = {"y": ys, "idx": idxs, **{k: [] for k in pending[0]}}
        for out, keep in zip(pending, keeps):
            for k, v in out.items():
                cltor[k].append(v.float().cpu().numpy()[keep])
        self.eval_timings.append((int(sum(k.sum() for k in keeps)),
                                  time.perf_counter() - t0))
        return {k: np.concatenate(v, axis=0) for k, v in cltor.items()}

    def _eval_and_print(self, cltor, name="", at_epoch=None):
        results = self.evaluator.compute(cltor, self.metrics_list)
        results = rename_keys(results, name, sep="/")
        print(f"[{name}] At epoch {at_epoch}:",
              " ".join(f"{k}={v:.6f}," for k, v in results.items()))
        self.logger.log(results)
        return [results[name + "/" + k] for k in self.ret_metrics]

    def _eval_all(self, evals_loader, ckpt_type="best", run_name="train",
                  test_mode=False, n_samples=1, zero_noise=False,
                  test_mode_name="test_mode"):
        """Evaluate a checkpoint (test mode: the training run's, from
        `test_load_path`) on every loader with `n_samples` samples; writes
        the metrics file and `{group}_{ckpt_type}_pred_{split}.csv`."""
        cfg = self.cfg
        if test_mode:
            print("[warning] you are in test mode now.")
            ckpt_run, group = "train", test_mode_name
        else:
            ckpt_run, group = run_name, run_name
        self.load_params(ckpt_type, ckpt_run, load=test_mode)
        wandb_group = f"{'bestckpt' if ckpt_type == 'best' else 'lastckpt'}/{group}"
        print_path = add_prefix_to_filename(self.metrics_paths[ckpt_type], group)

        metrics = {}
        for k_i, (k, (ds, batcher)) in enumerate(evals_loader.items()):
            # the JAX package's tag domain for checkpoint evaluations
            tag = (1 << 30) + (1 if ckpt_type == "best" else 2) * 16 + k_i
            cltor = self._run_eval(ds, batcher, n_samples=n_samples,
                                   zero_noise=zero_noise, rng_tag=tag)
            ci, loss = self._eval_and_print(cltor, name=f"{wandb_group}/{k}")
            metrics[k] = [("cindex", ci), ("loss", loss)]
            if cfg["save_prediction"]:
                path = osp.join(self.save_dir, f"{group}_{ckpt_type}_pred_{k}.csv")
                pids = [ds.pids[int(i)] for i in cltor["idx"]]
                save_prediction(pids, cltor["y"],
                                cltor.get("avg_y_hat", cltor["y_hat"]),
                                cltor.get("dist_y_hat"), path)
        print_metrics(metrics, print_to_path=print_path)
        return metrics
