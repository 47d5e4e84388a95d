"""Baseline handler (counterpart of `advmil_tpu/train/baseline.py::
BaselineHandler`): a SurvNet (backbone + MLP head) trained with one
supervised loss and one Adam optimizer, on the configured device.

The task fixes the rest, as in the JAX package:

- surv_nll: sigmoid hazards over `time_bins` quantile bins, the
  discrete-time likelihood, xavier init;
- surv_reg: a sigmoid time ratio, the reconstruction loss (the MSE for the
  ESAT backbone, `bcb_mode: patch`), xavier init;
- surv_cox: an unscaled log-hazard, the Cox partial likelihood over origin
  times, the pytorch-0.4.1 uniform init.

`exec` trains with plateau LR and early stopping on the validation split,
saves `{run}_model-{best,last}.ckpt` (parameters and optimizer state), then
evaluates the best checkpoint on every split and writes
`{group}_{ckpt}_pred_{split}.csv`; `exec_test` evaluates the occluded test
split from a training run's best checkpoint (the port's or the JAX
package's); `resume_model` restores parameters and optimizer state from
either package's checkpoint. Both write metrics, CSVs and
checkpoints under the JAX package's names and paths, in one process or as
one rank of a parallel world (`train/common.py`, `parallel/`).
"""
from __future__ import annotations

import os.path as osp

import torch

from ..config import check_configs
from ..data.bags import prepare_dataset
from ..eval.evaluator import prepare_evaluator
from ..models.backbones import load_backbone
from ..models.gan import SurvNet
from ..models.layers import PT041, XAVIER, Rngs, compute_dtype_of, init_parameters
from ..utils.func import seed_everything, sparse_str
from ..utils.io import read_datasplit_npz
from . import checkpoint as ckpt_lib
from .common import HandlerCommon, resolve_device
from .optim import AdaHessian, MultiSteps, create_optimizer
from .steps import make_base_train_step, make_eval_step, make_supervised_loss

# task -> (out_scale, time_format), the JAX handler's inference
_TASK_OUTPUT = {"surv_nll": ("sigmoid", "quantile"),
                "surv_reg": ("sigmoid", "ratio"),
                "surv_cox": ("none", "origin")}


def build_survnet(cfg: dict, out_scale: str, dense_init: str) -> SurvNet:
    """The config's SurvNet on the CPU, parameters not yet drawn (see
    `init_parameters`); compute dtype from `precision`."""
    dtype = compute_dtype_of(cfg["precision"])
    backbone = load_backbone(cfg["bcb_mode"], sparse_str(cfg["bcb_dims"]),
                             dense_init=dense_init, use_pallas=cfg["use_pallas"],
                             use_fused_embed=cfg["use_fused_embedding"],
                             use_lnpool=cfg["use_fused_lnpool"],
                             tra_backbone=cfg["tra_backbone"],
                             flash_min_len=int(cfg["flash_min_len"]),
                             num_graph_layers=int(cfg["num_graph_layers"]),
                             grid_resident=bool(cfg["graph_grid_resident"]),
                             dtype=dtype)
    dim_in, dim_out = sparse_str(cfg["pdh_dims"])
    return SurvNet(backbone, dim_in, dim_out, hops=cfg.get("mlp_hops", 1),
                   norm=cfg.get("mlp_norm", False), dropout=cfg.get("mlp_dropout", 0.25),
                   out_scale=out_scale, dense_init=dense_init, dtype=dtype)


class BaselineHandler(HandlerCommon):
    """Baseline (non-adversarial) survival model."""

    def __init__(self, cfg: dict):
        check_configs(cfg, handler="base")
        seed_everything(cfg["seed"])
        self.cfg = cfg
        self.device = resolve_device(cfg["device"])
        self._setup_parallel()
        self.task = cfg["task"]
        self.bcb = cfg["bcb_mode"]
        self._setup_paths()
        # the task decides the time format before any label is read
        out_scale, cfg["time_format"] = _TASK_OUTPUT[self.task]
        dense_init = XAVIER if out_scale == "sigmoid" else PT041
        self.model = build_survnet(cfg, out_scale, dense_init)
        init_parameters(self.model, cfg["seed"])
        self.model.to(self.device).eval()

        # ESAT's surv_reg trains on the MSE (reference baseline_handler.py)
        self.sup_loss_fn = make_supervised_loss(
            "surv_mse" if (self.task, self.bcb) == ("surv_reg", "patch") else self.task,
            cfg)
        self.base_lr = cfg["opt_net_lr"]
        accum = int(cfg.get("accum_steps", 1) or 1)
        if str(cfg["opt_net"]).lower() == "adahessian":
            assert accum == 1, "accum_steps is not supported with adahessian"
            self.opt = AdaHessian(self.model.parameters(), self.base_lr,
                                  weight_decay=cfg["opt_net_weight_decay"] or 0.0)
            # its LR is fixed, as in JAX: the plateau rule only warns
            self.plateau_opt = None
        else:
            self.opt = create_optimizer(cfg["opt_net"], self.model.parameters(),
                                        self.base_lr,
                                        weight_decay=cfg["opt_net_weight_decay"])
            if accum > 1:
                self.opt = MultiSteps(self.opt, accum)
            self.plateau_opt = self.opt
        self.accum_reset = [self.opt] if accum > 1 and cfg.get("accum_drop_remainder") else []
        self.batch_log_prefix = "train_batch/net/"
        # dropout masks on the device; flash Philox seeds from a CPU generator
        self.train_rngs = Rngs(
            device=torch.Generator(device=self.device).manual_seed(int(cfg["seed"])),
            host=torch.Generator().manual_seed(int(cfg["seed"]) + 1))
        self.train_step = make_base_train_step(
            self.model, self.opt, task=self.task,
            l1_coef=cfg.get("loss_regl1_coef", 0.0) or 0.0, sup_loss_fn=self.sup_loss_fn)
        self._eval_steps = {}

        if self.task == "surv_reg":      # ratio times: the end time is 1
            self.evaluator = prepare_evaluator("continuous", end_time=1.0,
                                               recon_loss=self.sup_loss_fn)
            self.metrics_list = ["c_index", "loss_recon", "mae", "event_t_rae",
                                 "nonevent_t_rae", "event_t_nre", "nonevent_t_nre"]
            self.ret_metrics = ["c_index", "loss_recon"]
        elif self.task == "surv_nll":
            self.evaluator = prepare_evaluator("discrete", mle_loss=self.sup_loss_fn)
            self.metrics_list = ["c_index", "loss_mle", "loss_mle_org"]
            self.ret_metrics = ["c_index", "loss_mle_org"]
        else:
            self.evaluator = prepare_evaluator("prohazard", ple_loss=self.sup_loss_fn)
            self.metrics_list = ["c_index", "loss_ple"]
            self.ret_metrics = ["c_index", "loss_ple"]
        self.eval_timings = []    # (bags, seconds) per _run_eval pass
        self.train_timings = []   # (bags, seconds) per training epoch
        self._setup_logging()

    def _ckpt_path(self, ckpt_type: str, run_name: str, load: bool = False) -> str:
        base = self.load_dir if load else self.save_dir
        return osp.join(base, f"{run_name}_model-{ckpt_type}.ckpt")

    def _batcher(self, ds):
        b = self._make_bucket_batcher(ds)
        if self.task == "surv_cox":
            # the partial likelihood's risk sets live within a batch: a bag
            # alone in its batch contributes zero loss and zero gradient
            degenerate = [int(n) for n in b.buckets if b.batch_size_for(n) < 2]
            if degenerate:
                print(f"[surv_cox] WARNING: buckets {degenerate} get batch "
                      "size 1 -> zero PLE gradient for those bags; raise "
                      "batch_token_budget. Note risk sets are bucket-local "
                      "(the reference uses 16 random bags per step).")
        return b

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------

    def exec(self):
        cfg = self.cfg
        print(f"[exec] execute task {self.task} using backbone-mode {self.bcb}.")
        path_split = cfg["data_split_path"].format(cfg["data_split_seed"])
        pids_train, pids_val, pids_test = read_datasplit_npz(path_split)
        train_set = prepare_dataset(pids_train, cfg, ratio_sampling=cfg["train_sampling"],
                                    rng=self.np_rng)
        val_set = prepare_dataset(pids_val, cfg, rng=self.np_rng)
        self.patient_id["train"] = train_set.pids
        self.patient_id["validation"] = val_set.pids
        loaders = {"train": (train_set, self._batcher(train_set)),
                   "validation": (val_set, self._batcher(val_set))}
        if pids_test is not None:
            test_set = prepare_dataset(pids_test, cfg, rng=self.np_rng)
            self.patient_id["test"] = test_set.pids
            loaders["test"] = (test_set, self._batcher(test_set))
        self.loaders = loaders
        val_loaders = {k: v for k, v in loaders.items() if k != "train"}
        self._run_training(cfg["epochs"], loaders["train"], "train",
                           val_loaders=val_loaders, val_name="validation",
                           run_name="train")
        return self._eval_all(loaders, ckpt_type="best", run_name="train")   # one sample, as in JAX

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
        self.loaders = {"exec-test": (test_set, self._batcher(test_set))}
        return self._eval_all(self.loaders, ckpt_type="best", run_name="train",
                              test_mode=True, n_samples=cfg["test_sampling_times"])

    def _eval_step(self, n_samples: int, zero_noise: bool):
        """SurvNet draws no noise: `zero_noise` changes nothing."""
        if n_samples not in self._eval_steps:
            self._eval_steps[n_samples] = make_eval_step(self.model, n_samples=n_samples)
        return self._eval_steps[n_samples]

    def load_params(self, ckpt_type: str, run_name: str, load: bool):
        """Load a checkpoint's parameters into the model (on the device); the
        optimizer state stays as it is."""
        path = self._ckpt_path(ckpt_type, run_name, load=load)
        if not osp.exists(path):
            raise FileNotFoundError(
                f"checkpoint {path} not found (no '{ckpt_type}' model was "
                "saved - check es_warmup/epochs or test_load_path)")
        self.model.load_state_dict(ckpt_lib.restore_checkpoint(path)[1])

    def resume_model(self, ckpt_type="best", run_name="train"):
        """Restore the parameters and the optimizer state from
        `{run_name}_model-{ckpt_type}.ckpt` under save_path, as the JAX
        handler's `resume_model`: the port's own checkpoint, or the JAX
        package's (any optimizer state it saves, fused or per leaf: see
        `bridge.opt_state_from_flax`), mapped before anything is loaded."""
        epoch, params, opt_state = ckpt_lib.restore_checkpoint(
            self._ckpt_path(ckpt_type, run_name))
        opt_sd = ckpt_lib.optimizer_state(opt_state, self.opt, self.model, self.cfg["opt_net"])
        self.model.load_state_dict(params)
        self.opt.load_state_dict(opt_sd)
        print(f"[model] resumed from {ckpt_type}_{run_name} at epoch {epoch}")

    def save_model(self, epoch, ckpt_type="best", run_name="train"):
        self._save(lambda: ckpt_lib.save_checkpoint(
            self._ckpt_path(ckpt_type, run_name), epoch, self.model.state_dict(),
            self.opt.state_dict()))
