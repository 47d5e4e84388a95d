"""Adversarial handler, test mode (counterpart of
`advmil_tpu/train/handler.py::AdvHandler`): builds G and D on the configured
device, loads the `best` checkpoints of a training run, evaluates the
occluded test split with zero noise and writes the metrics and the
prediction CSV under the same names and paths as the JAX package.

Training (`exec`) is ROADMAP slice 2 and semi-supervised training
(`exec_semi_sl`) slice 4.
"""
from __future__ import annotations

import functools
import os.path as osp
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import losses
from ..config import check_configs
from ..data.bags import prepare_dataset
from ..eval.evaluator import prepare_evaluator
from ..models.backbones import load_backbone
from ..models.gan import Discriminator, Generator, PrjDiscriminator
from ..models.layers import compute_dtype_of, init_parameters
from ..utils.func import (add_prefix_to_filename, print_metrics, rename_keys,
                          seed_everything, sparse_key, sparse_str)
from ..utils.io import read_datasplit_npz, read_maxt_from_table, save_prediction
from . import checkpoint as ckpt_lib
from .common import HandlerCommon, resolve_device
from .steps import make_eval_step


def build_models(cfg: dict):
    """(Generator, discriminator) for the config, on the CPU, parameters not
    yet drawn (see `init_parameters`); compute dtype from `precision`."""
    dtype = compute_dtype_of(cfg["precision"])
    backbone = load_backbone(cfg["bcb_mode"], sparse_str(cfg["bcb_dims"]),
                             use_pallas=cfg["use_pallas"],
                             use_lnpool=cfg["use_fused_lnpool"],
                             tra_backbone=cfg["tra_backbone"],
                             flash_min_len=int(cfg["flash_min_len"]),
                             dtype=dtype)
    dim_in, dim_out = sparse_str(cfg["gen_dims"])
    noi = SimpleNamespace(**sparse_key(cfg, prefixes="gen_noi"))
    gen = Generator(backbone, dim_in, dim_out, noise=tuple(sparse_str(noi.noise)),
                    hops=noi.hops, noise_dist=(noi.noise_dist or "uniform"),
                    norm=cfg["gen_norm"], out_scale=cfg["gen_out_scale"],
                    dtype=dtype)
    dx = SimpleNamespace(**sparse_key(cfg, prefixes="disc_netx"))
    dy = SimpleNamespace(**sparse_key(cfg, prefixes="disc_nety"))
    disc_kw = dict(netx_in_dim=dx.in_dim, netx_out_dim=dx.out_dim,
                   nety_in_dim=dy.in_dim,
                   nety_hid_dims=tuple(sparse_str(dy.hid_dims)),
                   nety_norm=dy.norm,
                   use_lnpool=cfg["use_fused_lnpool"], dtype=dtype)
    if cfg["disc_type"] == "prj":
        disc = PrjDiscriminator(prj_path=cfg["disc_prj_path"],
                                inner_product=cfg["disc_prj_iprd"], **disc_kw)
    else:
        disc = Discriminator(**disc_kw)
    return gen, disc


class AdvHandler(HandlerCommon):
    """Adversarial (generator/discriminator) survival model, test mode."""

    def __init__(self, cfg: dict):
        check_configs(cfg)
        seed_everything(cfg["seed"])
        self.cfg = cfg
        self.device = resolve_device(cfg["device"])
        self.task = cfg["task"]
        self.bcb = cfg["bcb_mode"]
        self._setup_paths()

        self.gen_model, self.disc_model = build_models(cfg)
        # the port's own seeded init; a checkpoint replaces it in _eval_all
        init_parameters(self.gen_model, cfg["seed"])
        init_parameters(self.disc_model, cfg["seed"] + 1)
        self.gen_model.to(self.device).eval()
        self.disc_model.to(self.device).eval()

        self.sup_loss_fn = functools.partial(
            losses.recon_loss, alpha=cfg.get("loss_recon_alpha", 0.0) or 0.0,
            gamma=cfg.get("loss_recon_gamma", 1.0),
            norm=cfg.get("loss_recon_norm", "l1"))
        end_time = (read_maxt_from_table(cfg["path_label"])
                    if cfg["time_format"] == "origin" else 1.0)
        disc_loss = functools.partial(losses.real_fake_loss,
                                      which=cfg["loss_netD"])
        self.evaluator = prepare_evaluator(
            "continuous", end_time=end_time, recon_loss=self.sup_loss_fn,
            disc_loss=disc_loss)
        self.metrics_list = ["c_index", "loss_recon", "loss_recon_org",
                             "loss_fake_netD", "loss_fake_netG", "avg_fake",
                             "event_t_rae", "nonevent_t_rae", "event_t_nre",
                             "nonevent_t_nre"]
        self.ret_metrics = ["c_index", "loss_recon_org"]
        self._eval_steps = {}
        self.eval_timings = []   # (bags, seconds) per _run_eval pass
        self._setup_logging()

    def _ckpt_path(self, net: str, ckpt_type: str, run_name: str,
                   load: bool = False) -> str:
        base = self.load_dir if load else self.save_dir
        return osp.join(base, f"{run_name}_model{net}-{ckpt_type}.ckpt")

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------

    def exec(self):
        raise NotImplementedError("training (AdvHandler.exec) is not ported "
                                  "yet (ROADMAP slice 2: A5-A9)")

    def exec_semi_sl(self):
        raise NotImplementedError("semi-supervised training is not ported yet "
                                  "(ROADMAP slice 4: A11)")

    def exec_test(self):
        cfg = self.cfg
        print(f"[exec] execute test {self.task} using backbone-mode {self.bcb}.")
        path_split = cfg["data_split_path"].format(cfg["data_split_seed"])
        pids_train, pids_val, pids_test = read_datasplit_npz(path_split)
        pids = {"train": pids_train, "val": pids_val,
                "test": pids_test}[cfg["test_path"]]
        test_set = prepare_dataset(pids, cfg, mask_ratio=cfg["test_mask_ratio"],
                                   rng=self.np_rng)
        self.patient_id["exec-test"] = test_set.pids
        self.loaders = {"exec-test": (test_set, self._make_bucket_batcher(test_set))}
        return self._eval_all(self.loaders, ckpt_type="best", run_name="train",
                              test_mode=True, test_mode_name="test_mode",
                              test_zero_noise=cfg["test_zero_noise"])

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def _get_eval_step(self, n_samples: int, zero_noise: bool):
        key = (n_samples, zero_noise)
        if key not in self._eval_steps:
            self._eval_steps[key] = make_eval_step(
                self.gen_model, self.disc_model, n_samples=n_samples,
                zero_noise=zero_noise)
        return self._eval_steps[key]

    def _run_eval(self, ds, batcher, n_samples=1, zero_noise=False, rng_tag=0):
        """One pass over `batcher`; returns the host-side collections."""
        step = self._get_eval_step(n_samples, zero_noise)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((self.cfg["seed"] + 777) * 1_000_003 + rng_tag) % (1 << 62))
        t0 = time.perf_counter()
        keys = ["y_hat", "f_fake"] + (["avg_y_hat", "dist_y_hat"]
                                      if n_samples > 1 else [])
        pending, keeps, ys, idxs = [], [], [], []
        for batch in batcher.prefetch():
            out = step(self._ship(batch), gen)
            keep = batch.sample_mask.astype(bool)
            ys.append(batch.label[keep])
            idxs.append(batch.idx[keep])
            pending.append({k: out[k] for k in keys})
            keeps.append(keep)
        cltor = {"y": ys, "idx": idxs, **{k: [] for k in keys}}
        for out, keep in zip(pending, keeps):
            for k in keys:
                cltor[k].append(out[k].cpu().numpy()[keep])
        self.eval_timings.append((int(sum(k.sum() for k in keeps)),
                                  time.perf_counter() - t0))
        return {k: np.concatenate(v, axis=0) for k, v in cltor.items()}

    def _eval_and_print(self, cltor, name=""):
        results = self.evaluator.compute(cltor, self.metrics_list)
        results = rename_keys(results, name, sep="/")
        print(f"[{name}] At epoch None:",
              " ".join(f"{k}={v:.6f}," for k, v in results.items()))
        self.logger.log(results)
        return [results[name + "/" + k] for k in self.ret_metrics]

    def load_params(self, ckpt_type: str, run_name: str, load: bool):
        """Load the G and D checkpoints into the models (on the device)."""
        gpath = self._ckpt_path("G", ckpt_type, run_name, load=load)
        dpath = self._ckpt_path("D", ckpt_type, run_name, load=load)
        if not osp.exists(gpath):
            raise FileNotFoundError(
                f"checkpoint {gpath} not found (no '{ckpt_type}' model was "
                "saved - check es_warmup/epochs or test_load_path)")
        self.gen_model.load_state_dict(ckpt_lib.restore_checkpoint(gpath)[1])
        self.disc_model.load_state_dict(ckpt_lib.restore_checkpoint(dpath)[1])

    def save_model(self, epoch, ckpt_type="best", run_name="train"):
        ckpt_lib.save_checkpoint(self._ckpt_path("G", ckpt_type, run_name),
                                 epoch, self.gen_model.state_dict())
        ckpt_lib.save_checkpoint(self._ckpt_path("D", ckpt_type, run_name),
                                 epoch, self.disc_model.state_dict())

    def _eval_all(self, evals_loader, ckpt_type="best", run_name="train",
                  if_print=True, test_mode=False, test_mode_name="test_mode",
                  test_zero_noise=False):
        cfg = self.cfg
        if test_mode:
            print("[warning] you are in test mode now.")
            ckpt_run, group = "train", test_mode_name
            sampling_times = cfg["test_sampling_times"]
        else:
            ckpt_run, group = run_name, run_name
            sampling_times = cfg["times_test_sample"]
        self.load_params(ckpt_type, ckpt_run, load=test_mode)
        wandb_group = f"{'bestckpt' if ckpt_type == 'best' else 'lastckpt'}/{group}"
        print_path = add_prefix_to_filename(self.metrics_paths[ckpt_type], group)
        csv_name = f"{group}_{ckpt_type}"

        metrics = {}
        for k_i, (k, (ds, batcher)) in enumerate(evals_loader.items()):
            cltor = self._run_eval(ds, batcher, n_samples=sampling_times,
                                   zero_noise=test_zero_noise, rng_tag=k_i)
            ci, loss = self._eval_and_print(cltor, name=f"{wandb_group}/{k}")
            metrics[k] = [("cindex", ci), ("loss", loss)]
            if cfg["save_prediction"]:
                path = osp.join(self.save_dir, f"{csv_name}_pred_{k}.csv")
                pids = [ds.pids[int(i)] for i in cltor["idx"]]
                save_prediction(pids, cltor["y"],
                                cltor.get("avg_y_hat", cltor["y_hat"]),
                                cltor.get("dist_y_hat"), path)
        if if_print:
            print_metrics(metrics, print_to_path=print_path)
        return metrics
