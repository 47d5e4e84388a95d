"""Handler plumbing (counterpart of `advmil_tpu/train/common.py`): the
save/load path layout, the process grid, the run logger, the bucketed
batcher, shipping a host batch to the configured device, and the training
loop and evaluation both handlers share.

In a multi-process run (`parallel/`) every rank builds the same global
batch on the host (same seed, same bucket order) and ships only its rows
and, under inst > 1, its share of the patch axis; the labels and sample
masks stay global, since the losses run on gathered outputs. Evaluation
gathers each batch's outputs to every rank in global order, so the metrics,
early stopping and the plateau rule decide the same thing everywhere. Rank 0
alone writes checkpoints, prediction CSVs, `print_config.txt` and the
scalars log; a barrier follows each checkpoint, so every rank can read it
back."""
from __future__ import annotations

import contextlib
import os
import os.path as osp
import time

import numpy as np
import torch

from ..data.bags import BucketBatcher
from ..parallel import comm, mesh
from ..parallel.dist import barrier, is_multi_process, is_primary, multi_host_settings
from ..utils.func import (EarlyStopping, add_prefix_to_filename, plot_time_kde,
                          print_config, print_metrics, rename_keys)
from ..utils.io import save_prediction
from ..utils import tracing
from ..utils.logging import RunLogger
from .optim import ReduceLROnPlateau, reset_multisteps_accum, set_lr


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
    optimizer whose LR the plateau rule scales; None: a fixed LR),
    `accum_reset` (the accumulating optimizers whose partial accumulator
    is dropped at epoch end), `batch_log_prefix`,
    `_eval_step(n_samples, zero_noise)`, `load_params`, `save_model`, and
    `evaluator` / `metrics_list` / `ret_metrics`. `draws_plots`: whether a
    checkpoint's evaluation draws `log_plot`'s time histograms (the
    adversarial handler's, as in the JAX package). `traces_epoch_2`: whether
    `profile_dir` traces the second training epoch (the adversarial
    handler's, as in the JAX package)."""

    draws_plots = False
    traces_epoch_2 = False

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

    def _setup_parallel(self):
        """Register the process grid (`parallel/mesh.py`): dp_devices x
        inst_devices ranks, or, in a multi-host run (`dist_*` settings),
        pure data parallelism over every rank (inst_devices ignored, as in
        the JAX package). A single-process run registers none; asking it for
        several ranks raises (main.py or torchrun starts them)."""
        cfg = self.cfg
        dp = int(cfg.get("dp_devices", 1) or 1)
        inst = int(cfg.get("inst_devices", 1) or 1)
        self.grid = None
        if is_multi_process():
            import torch.distributed as tdist
            world = tdist.get_world_size()
            if multi_host_settings(cfg):
                if inst > 1:
                    print("[parallel] WARNING: inst_devices is ignored in multi-host runs "
                          "(pure data parallelism over every rank)")
                dp, inst = world, 1
            self.grid = mesh.make_grid(dp, inst, self.device)
            print(f"[parallel] rank {self.grid.rank} of {world}: dp {dp} x inst {inst} "
                  f"({self.grid.backend}, {self.device})")
        elif dp * inst > 1:
            raise RuntimeError(f"dp_devices x inst_devices = {dp * inst} ranks: start them "
                               "with `python -m advmil_tpu_torch.main` (which spawns them) "
                               "or torchrun")
        mesh.set_grid(self.grid)

    def _setup_logging(self):
        cfg = self.cfg
        self.patient_id = {}
        self.np_rng = np.random.default_rng(cfg["seed"])
        run_name = self.save_dir.rstrip("/").split("/")[-1]
        prj = (cfg.get("test_wandb_prj") or cfg.get("wandb_prj")) \
            if cfg.get("test") else cfg.get("wandb_prj")
        self.logger = RunLogger(prj, run_name, self.save_dir, config=cfg,
                                enabled=is_primary())
        if is_primary():
            print_config(cfg, print_to_path=self.config_path)

    def _save(self, write) -> None:
        """Run `write()` on rank 0 only, then wait for every rank, so a file
        just written can be read back everywhere."""
        if is_primary():
            write()
        barrier()

    def _make_bucket_batcher(self, ds) -> BucketBatcher:
        g = self.grid
        b = BucketBatcher(ds, token_budget=self.cfg["batch_token_budget"],
                          max_batch=self.cfg["batch_max_size"],
                          min_bucket=self.cfg["bucket_min"],
                          bucket_growth=float(self.cfg["bucket_growth"]),
                          edges_per_node=int(self.cfg["graph_edges_per_node"]),
                          banded=graph_banded(self.cfg),
                          grid_max_inflation=float(self.cfg["graph_grid_max_inflation"]),
                          # every rank gets the same number of bags, and whole
                          # 16-patch regions of each
                          batch_multiple=g.dp if g else 1,
                          n_multiple=16 * (g.inst if g else 1))
        nw = int(self.cfg["num_workers"] or 0)
        b.prefetch_depth = max(2, nw)
        b.prefetch_workers = max(1, nw)
        return b

    def _ship(self, batch, train: bool = False, visible=None) -> dict:
        """Host batch -> device tensors; feats in bf16 under precision bf16.
        A training batch also carries label, sample_mask and visible: the
        given [B] host array, or all 1 (every label is visible outside
        semi-supervised training). `extra` is what the backbone takes as its
        third argument: the dict of graph tables (int32 / f32 tensors) in
        graph mode, the region coordinates [B, L, 2] in patch mode with
        `use_coords_pe`, the cluster ids [B, N] (int32) in cluster mode.
        Under a grid the model's inputs are this rank's rows (and share of
        the patch axis), sliced on the host before any cast or copy; label,
        sample_mask and visible stay global. Traced as the span `ship`; the
        counter `h2d_bytes` adds up the host arrays handed to `.to(device)`
        (feats as shipped, f32)."""
        with tracing.span("ship"):
            arrays = {"feats": batch.feats, "mask": batch.mask}
            if "coords" in batch.extra:
                arrays["coords"] = batch.extra["coords"]
            elif "cluster_id" in batch.extra:     # int32 [B, N], -1 on padding
                arrays["cluster_id"] = batch.extra["cluster_id"]
            elif batch.extra:
                arrays["graph"] = batch.extra
            if self.grid is not None:
                arrays = mesh.shard_batch_2d(arrays, self.grid)

            def dev(a):
                a = np.ascontiguousarray(a)
                tracing.count("h2d_bytes", a.nbytes)
                return torch.from_numpy(a).to(self.device)
            feats = dev(arrays["feats"])
            if self.cfg["precision"] in ("bf16", "bfloat16"):
                feats = feats.to(torch.bfloat16)
            out = {"feats": feats, "mask": dev(arrays["mask"])}
            if "coords" in arrays:
                out["extra"] = dev(arrays["coords"])
            elif "cluster_id" in arrays:
                out["extra"] = dev(arrays["cluster_id"])
            elif "graph" in arrays:
                out["extra"] = {k: dev(v) for k, v in arrays["graph"].items()}
            if train:
                smask = dev(batch.sample_mask)
                vis = torch.ones_like(smask) if visible is None else dev(visible)
                out.update(label=dev(batch.label), sample_mask=smask, visible=vis)
            return out

    @staticmethod
    def _visible(ds, batch, visible_set) -> np.ndarray:
        """[B] f32: 1 where the patient of `batch.idx[j]` in `ds` is in
        `visible_set` (tail fillers included, as in the JAX package; the
        step multiplies by sample_mask)."""
        return np.asarray([1.0 if ds.pids[int(i)] in visible_set else 0.0
                           for i in batch.idx], np.float32)

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------

    def _run_training(self, epochs, train_loader, name_loader, val_loaders=None,
                      val_name=None, run_name="train", mode="wlabel", early_stop=True):
        """Train for up to `epochs` epochs with plateau LR and (with
        `early_stop` and a patience configured) early stopping on
        `val_name`, saving `best` checkpoints as it improves and `last` at
        the end. `train_loader` / `name_loader` are one
        (dataset, batcher) and its name, or lists of them (k-fold: epoch e
        trains loader e % k). `mode` "wolabel" (semi-supervised) shows the
        supervised loss only the labels of `patient_id["label_visible"]`
        and reads the `ssl_`-prefixed early-stopping keys."""
        cfg = self.cfg
        prefix = "" if mode == "wlabel" else "ssl_"
        if early_stop and cfg.get(prefix + "es_patience") is not None:
            self.early_stop = EarlyStopping(
                warmup=cfg[prefix + "es_warmup"], patience=cfg[prefix + "es_patience"],
                start_epoch=cfg[prefix + "es_start_epoch"],
                verbose=cfg[prefix + "es_verbose"])
        else:
            self.early_stop = None
        self.steplr = ReduceLROnPlateau(factor=0.5, patience=10, verbose=True)
        visible_set = None if mode == "wlabel" else self.patient_id["label_visible"]
        is_kfold = isinstance(name_loader, (list, tuple))
        profile_dir = cfg.get("profile_dir") if self.traces_epoch_2 else None
        last_epoch = -1
        for epoch in range(epochs):
            last_epoch = epoch + 1
            loader, name = ((train_loader[epoch % len(name_loader)],
                             name_loader[epoch % len(name_loader)])
                            if is_kfold else (train_loader, name_loader))
            with self._trace(profile_dir if epoch == 1 else None):
                cltor = self._train_each_epoch(loader, visible_set)
            self._eval_and_print(cltor, name=name, at_epoch=epoch + 1)

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
                scale = self.steplr.step(val_metrics)
                if self.plateau_opt is not None:
                    set_lr(self.plateau_opt, self.base_lr * scale)
                elif not getattr(self, "_warned_fixed_lr", False):
                    self._warned_fixed_lr = True
                    print("[lr] WARNING: the optimizer's learning rate is fixed "
                          "(adahessian, as in JAX); ReduceLROnPlateau has no effect")
                self.early_stop(epoch, val_metrics)
                if self.early_stop.if_save_checkpoint():
                    self.save_model(epoch + 1, "best", run_name)
                    print(f"[{run_name}] best model saved at epoch {epoch + 1}")
                if self.early_stop.if_stop():
                    break
        self.save_model(last_epoch, "last", run_name)
        print(f"[{run_name}] last model saved at epoch {last_epoch}")

    @contextlib.contextmanager
    def _trace(self, profile_dir):
        """With `profile_dir`, a `torch.profiler` trace of the block (CPU,
        and CUDA on the card) written there as a Chrome trace,
        `epoch2_rank<r>.trace.json`; the counterpart of the JAX handler's
        `jax.profiler` trace of epoch 2. The loops' `advmil.*` spans
        (`utils/tracing.py`) show in it on the main thread, above the
        kernels; a line prints the block's span totals and counters."""
        if not profile_dir:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
        os.makedirs(profile_dir, exist_ok=True)
        rank = self.grid.rank if self.grid is not None else 0
        prof.export_chrome_trace(osp.join(profile_dir, f"epoch2_rank{rank}.trace.json"))
        print(f"[profile] epoch-2 trace written to {profile_dir}")
        print(f"[profile] epoch-2 {tracing.summary()}")

    def _train_each_epoch(self, loader, visible_set=None):
        """One shuffled pass of training steps; the device is synced once,
        at the end, for the logged metrics and the collected predictions
        (every tensor of the steps' `collect`). With `visible_set`, a
        sample's label reaches the supervised loss only if its patient is in
        the set; `train_visible` records each epoch's count of such samples.
        Traced (`utils/tracing.py`): the spans `batch_wait`, `step` and
        `pass_end`, as in `_run_eval`."""
        ds, batcher = loader
        t0 = time.perf_counter()
        pending, keeps, ys, idxs = [], [], [], []
        n_visible = 0
        for batch in tracing.batches(batcher.prefetch(shuffle=True, rng=self.np_rng)):
            visible = None
            if visible_set is not None:
                visible = self._visible(ds, batch, visible_set)
                n_visible += int((visible * batch.sample_mask).sum())
            shipped = self._ship(batch, train=True, visible=visible)
            with tracing.span("step"):
                metrics, collect = self.train_step(shipped, self.train_rngs)
            keep = batch.sample_mask.astype(bool)
            pending.append((metrics, collect))
            keeps.append(keep)
            ys.append(batch.label[keep])
            idxs.append(batch.idx[keep])
        with tracing.span("pass_end"):
            names = list(pending[0][0])
            logged = {k: torch.stack([m[k] for m, _ in pending]).float().cpu().tolist()
                      for k in names}
            cltor = {"y": ys, "idx": idxs, **{k: [] for k in pending[0][1]}}
            for (_, collect), keep in zip(pending, keeps):
                for k, v in collect.items():
                    cltor[k].append(v.float().cpu().numpy()[keep])
            self.train_timings.append((int(sum(k.sum() for k in keeps)),
                                       time.perf_counter() - t0))
            if visible_set is not None:
                self.train_visible.append(n_visible)
            for opt in self.accum_reset:
                reset_multisteps_accum(opt)
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
        for batch in tracing.batches(batcher.prefetch()):
            shipped = self._ship(batch)
            with tracing.span("step"):
                out = step(shipped, gen)
            # every rank gets the whole batch's outputs, in global order
            pending.append({k: comm.gather_rows_nograd(v) for k, v in out.items()})
            keep = batch.sample_mask.astype(bool)
            ys.append(batch.label[keep])
            idxs.append(batch.idx[keep])
            keeps.append(keep)
        with tracing.span("pass_end"):
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
        the metrics file and `{group}_{ckpt_type}_pred_{split}.csv`, and
        with `log_plot` (`draws_plots`) each split's time histograms through
        the run logger (`<run>_<group>_<split>_chart.png` without wandb)."""
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
            if self.draws_plots and cfg.get("log_plot") and is_primary():
                fig = plot_time_kde(cltor["y"], cltor.get("avg_y_hat", cltor["y_hat"]))
                self.logger.log_image(f"{wandb_group}/{k}/chart", fig)
            if cfg["save_prediction"] and is_primary():
                path = osp.join(self.save_dir, f"{group}_{ckpt_type}_pred_{k}.csv")
                pids = [ds.pids[int(i)] for i in cltor["idx"]]
                save_prediction(pids, cltor["y"],
                                cltor.get("avg_y_hat", cltor["y_hat"]),
                                cltor.get("dist_y_hat"), path)
        if is_primary():
            print_metrics(metrics, print_to_path=print_path)
        return metrics
