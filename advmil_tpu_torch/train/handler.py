"""Adversarial handler (counterpart of `advmil_tpu/train/handler.py::
AdvHandler`): builds G and D on the configured device and runs

- `exec`: adversarial training with plateau LR and early stopping on the
  validation split, best / last checkpoints with optimizer state, then the
  evaluation of the best checkpoint on every split (`times_test_sample`
  noise samples, lower median);
- `exec_semi_sl`: semi-supervised training (`semi_training: True`): a
  labelled share of the training patients, an optional supervised
  pretraining run, then `semitrain_{LD_UD,LD,UD}` in which only the labelled
  patients' labels reach the supervised loss;
- `exec_test`: test mode, which loads the `best` checkpoints of a training
  run, evaluates the occluded test split with zero noise;

for cont_gansurv (one continuous time) and disc_gansurv (hazards over
`time_bins` quantile bins), writing metrics, prediction CSVs and
checkpoints under the same names and paths as the JAX package. Each mode
runs in one process or as one rank of a dp_devices x inst_devices (or
multi-host) world (`train/common.py`, `parallel/`).
"""
from __future__ import annotations

import functools
import json
import os.path as osp
from types import SimpleNamespace

import numpy as np
import torch

from .. import losses
from ..config import check_configs
from ..data.bags import prepare_dataset
from ..eval.evaluator import prepare_evaluator
from ..models.backbones import load_backbone
from ..models.gan import Discriminator, Generator, PrjDiscriminator
from ..models.layers import Rngs, compute_dtype_of, init_parameters
from ..utils.func import (get_kfold_pids, sampling_data, seed_everything, sparse_key,
                          sparse_str)
from ..utils.io import read_datasplit_npz, read_maxt_from_table
from . import checkpoint as ckpt_lib
from .common import HandlerCommon, resolve_device
from .optim import MultiSteps, create_optimizer
from .steps import make_adv_train_step, make_eval_step, make_supervised_loss


def build_models(cfg: dict):
    """(Generator, discriminator) for the config, on the CPU, parameters not
    yet drawn (see `init_parameters`); compute dtype from `precision`."""
    dtype = compute_dtype_of(cfg["precision"])
    backbone = load_backbone(cfg["bcb_mode"], sparse_str(cfg["bcb_dims"]),
                             use_pallas=cfg["use_pallas"],
                             use_fused_embed=cfg["use_fused_embedding"],
                             use_lnpool=cfg["use_fused_lnpool"],
                             tra_backbone=cfg["tra_backbone"],
                             flash_min_len=int(cfg["flash_min_len"]),
                             num_graph_layers=int(cfg["num_graph_layers"]),
                             grid_resident=bool(cfg["graph_grid_resident"]),
                             dtype=dtype)
    dim_in, dim_out = sparse_str(cfg["gen_dims"])
    noi = SimpleNamespace(**sparse_key(cfg, prefixes="gen_noi"))
    gen = Generator(backbone, dim_in, dim_out, noise=tuple(sparse_str(noi.noise)),
                    hops=noi.hops, noise_dist=(noi.noise_dist or "uniform"),
                    norm=cfg["gen_norm"], dropout=cfg["gen_dropout"],
                    out_scale=cfg["gen_out_scale"], dtype=dtype)
    dx = SimpleNamespace(**sparse_key(cfg, prefixes="disc_netx"))
    dy = SimpleNamespace(**sparse_key(cfg, prefixes="disc_nety"))
    disc_kw = dict(netx_in_dim=dx.in_dim, netx_out_dim=dx.out_dim,
                   nety_in_dim=dy.in_dim,
                   nety_hid_dims=tuple(sparse_str(dy.hid_dims)),
                   netx_dropout=dx.dropout, nety_norm=dy.norm,
                   nety_dropout=dy.dropout, netx_ksize=getattr(dx, "ksize", None) or 1,
                   netx_backbone=getattr(dx, "backbone", None) or "avgpool",
                   use_lnpool=cfg["use_fused_lnpool"], dtype=dtype)
    if cfg["disc_type"] == "prj":
        disc = PrjDiscriminator(prj_path=cfg["disc_prj_path"],
                                inner_product=cfg["disc_prj_iprd"], **disc_kw)
    else:
        disc = Discriminator(**disc_kw)
    return gen, disc


class AdvHandler(HandlerCommon):
    """Adversarial (generator/discriminator) survival model."""

    def __init__(self, cfg: dict):
        check_configs(cfg)
        seed_everything(cfg["seed"])
        self.cfg = cfg
        self.device = resolve_device(cfg["device"])
        self._setup_parallel()
        self.task = cfg["task"]
        self.bcb = cfg["bcb_mode"]
        self.nbins = cfg.get("time_bins", 4)
        self._setup_paths()

        self.gen_model, self.disc_model = build_models(cfg)
        # the port's own seeded init (training starts from it; a checkpoint
        # replaces it in _eval_all)
        init_parameters(self.gen_model, cfg["seed"])
        init_parameters(self.disc_model, cfg["seed"] + 1)
        self.gen_model.to(self.device).eval()
        self.disc_model.to(self.device).eval()

        self.sup_loss_fn = make_supervised_loss(self.task, cfg)
        disc_loss = functools.partial(losses.real_fake_loss,
                                      which=cfg["loss_netD"])
        if self.task == "cont_gansurv":
            end_time = (read_maxt_from_table(cfg["path_label"])
                        if cfg["time_format"] == "origin" else 1.0)
            self.evaluator = prepare_evaluator(
                "continuous", end_time=end_time, recon_loss=self.sup_loss_fn,
                disc_loss=disc_loss)
            self.metrics_list = ["c_index", "loss_recon", "loss_recon_org",
                                 "loss_fake_netD", "loss_fake_netG", "avg_fake",
                                 "event_t_rae", "nonevent_t_rae", "event_t_nre",
                                 "nonevent_t_nre"]
            self.ret_metrics = ["c_index", "loss_recon_org"]
        else:
            self.evaluator = prepare_evaluator(
                "discrete", mle_loss=self.sup_loss_fn, disc_loss=disc_loss)
            self.metrics_list = ["c_index", "loss_mle", "loss_mle_org",
                                 "loss_fake_netD", "loss_fake_netG", "avg_fake"]
            self.ret_metrics = ["c_index", "loss_mle_org"]
        self.batch_log_prefix = "train_batch/"
        self.opt_G = self.opt_D = self.train_step = None
        if not cfg["test"]:
            self._setup_training()
        self._eval_steps = {}
        self.eval_timings = []    # (bags, seconds) per _run_eval pass
        self.train_timings = []   # (bags, seconds) per training epoch
        self.train_visible = []   # labelled samples per semi-supervised epoch
        self._setup_logging()

    def _setup_training(self):
        """Optimizers, train-mode generators and the adversarial step."""
        cfg = self.cfg
        # reference model/model_handler.py:100-109: G's optimizer by name
        # (coupled L2 on its matrices), plain Adam on D; the plateau LR scales
        # G's only. With accum_steps > 1 both accumulate (optax.MultiSteps):
        # D steps once a batch, G once per gen_update, each call a mini-step.
        self.base_lr = cfg["opt_netG_lr"]
        self.opt_G = create_optimizer(cfg["opt_netG"], self.gen_model.parameters(),
                                      self.base_lr,
                                      weight_decay=cfg["opt_netG_weight_decay"])
        self.opt_D = create_optimizer("adam", self.disc_model.parameters(),
                                      cfg["opt_netD_lr"])
        accum = int(cfg.get("accum_steps", 1) or 1)
        if accum > 1:
            self.opt_G, self.opt_D = MultiSteps(self.opt_G, accum), MultiSteps(self.opt_D, accum)
        self.accum_reset = ([self.opt_G, self.opt_D]
                            if accum > 1 and cfg.get("accum_drop_remainder") else [])
        self.plateau_opt = self.opt_G
        # dropout masks and noise on the device; the flash kernels' Philox
        # seeds from a CPU generator, so drawing one never waits for the card
        self.train_rngs = Rngs(
            device=torch.Generator(device=self.device).manual_seed(int(cfg["seed"])),
            host=torch.Generator().manual_seed(int(cfg["seed"]) + 1))
        self.train_step = make_adv_train_step(
            self.gen_model, self.disc_model, self.opt_G, self.opt_D,
            loss_netD=cfg["loss_netD"], coef_gan=cfg["loss_gan_coef"],
            l1_coef=cfg["loss_regl1_coef"] or 0.0,
            gen_updates=int(cfg["gen_updates"]), sup_loss_fn=self.sup_loss_fn,
            task=self.task, nbins=self.nbins)

    def _ckpt_path(self, net: str, ckpt_type: str, run_name: str,
                   load: bool = False) -> str:
        base = self.load_dir if load else self.save_dir
        return osp.join(base, f"{run_name}_model{net}-{ckpt_type}.ckpt")

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------

    def exec(self):
        cfg = self.cfg
        print(f"[exec] execute task {self.task} using backbone-mode {self.bcb}.")
        path_split = cfg["data_split_path"].format(cfg["data_split_seed"])
        pids_train, pids_val, pids_test = read_datasplit_npz(path_split)
        self.patient_id["label_visible"] = set(
            pids_train + pids_val + (pids_test or []))
        print(f"[exec] read patient IDs from {path_split}")

        train_set = prepare_dataset(pids_train, cfg, ratio_sampling=cfg["train_sampling"],
                                    rng=self.np_rng)
        val_set = prepare_dataset(pids_val, cfg, rng=self.np_rng)
        self.patient_id["train"] = train_set.pids
        self.patient_id["validation"] = val_set.pids
        loaders = {"train": (train_set, self._make_bucket_batcher(train_set)),
                   "validation": (val_set, self._make_bucket_batcher(val_set))}
        if pids_test is not None:
            test_set = prepare_dataset(pids_test, cfg, rng=self.np_rng)
            self.patient_id["test"] = test_set.pids
            loaders["test"] = (test_set, self._make_bucket_batcher(test_set))
        self.loaders = loaders

        val_loaders = {k: v for k, v in loaders.items() if k != "train"}
        self._run_training(cfg["epochs"], loaders["train"], "train",
                           val_loaders=val_loaders, val_name="validation",
                           run_name="train")
        return self._eval_all(loaders, ckpt_type="best", run_name="train",
                              n_samples=cfg["times_test_sample"])

    def exec_semi_sl(self):
        """Semi-supervised training (reference model_handler.py:680-778):
        the training patients split into labelled / unlabelled; only the
        labelled patients' labels reach the supervised loss ("wolabel"), the
        adversarial loss sees every bag. UD+LD trains on k folds of the
        unlabelled patients, each joined by every labelled one (epoch e
        trains fold e % k); LD on the labelled, UD on the unlabelled."""
        cfg = self.cfg
        assert cfg["semi_training"]
        path_split = cfg["data_split_path"].format(cfg["data_split_seed"])
        pids_train, pids_val, pids_test = read_datasplit_npz(path_split)
        # the split comes from a fresh legacy RandomState(seed), the stream
        # the reference draws it from; shuffles and train_sampling draw from
        # the handler's default_rng(seed). Swapping the two labels other
        # patients than the JAX package does.
        labeled, unlabeled = sampling_data(pids_train, cfg["ssl_num_labeled"],
                                           rng=np.random.RandomState(cfg["seed"]))
        print("PARITY_SSL_LABELED_JSON=" + json.dumps(sorted(labeled)))
        self.patient_id["label_visible"] = set(labeled)
        self.patient_id["label_invisible"] = set(unlabeled)

        labeled_set = prepare_dataset(labeled, cfg, rng=self.np_rng)
        unlabeled_set = prepare_dataset(unlabeled, cfg, rng=self.np_rng)
        self.patient_id["labeled_train"] = labeled_set.pids
        self.patient_id["unlabeled_train"] = unlabeled_set.pids
        val_set = prepare_dataset(pids_val, cfg, rng=self.np_rng)
        test_set = prepare_dataset(pids_test, cfg, rng=self.np_rng)
        self.patient_id["validation"] = val_set.pids
        self.patient_id["test"] = test_set.pids
        val_loaders = {"validation": (val_set, self._make_bucket_batcher(val_set)),
                       "test": (test_set, self._make_bucket_batcher(test_set))}
        evals = {"labeled_train": (labeled_set, self._make_bucket_batcher(labeled_set)),
                 "unlabeled_train": (unlabeled_set, self._make_bucket_batcher(unlabeled_set)),
                 **val_loaders}

        if cfg.get("ssl_first_phase", False):
            print("[exec_semi_sl] first phase: supervised pretraining")
            self._run_training(cfg["epochs"], evals["labeled_train"], "labeled_train",
                               val_loaders=val_loaders, val_name="validation",
                               early_stop=False, run_name="pretrain")
            self._eval_all(evals, ckpt_type="last", run_name="pretrain",
                           n_samples=cfg["times_test_sample"])
        else:
            print("[exec_semi_sl] NOTE: skipped the first supervised phase.")

        mode = cfg["semi_training_mode"]
        if "UD" in mode and "LD" in mode:
            run_name = "semitrain_LD_UD"
            folds = get_kfold_pids(unlabeled, cfg["ssl_kfold"], keep_pids=labeled,
                                   random_state=cfg["seed"])
            fold_loaders, fold_names = [], []
            for i, kth in enumerate(folds):
                name = f"fold{i}_mixed_train"
                ds = prepare_dataset(kth, cfg, rng=self.np_rng)
                self.patient_id[name] = ds.pids
                fold_loaders.append((ds, self._make_bucket_batcher(ds)))
                fold_names.append(name)
            train_loader, train_name = fold_loaders, fold_names
            self.loaders = dict(zip(fold_names, fold_loaders))
        elif "LD" in mode or "UD" in mode:
            run_name, train_name = (("semitrain_LD", "labeled_train") if "LD" in mode
                                    else ("semitrain_UD", "unlabeled_train"))
            train_loader = evals[train_name]
            self.loaders = {train_name: train_loader}
        else:
            print("[exec_semi_sl] no UD/LD specified; nothing to train")
            return {}
        self.loaders.update(val_loaders)
        self._run_training(cfg["ssl_epochs"], train_loader, train_name, mode="wolabel",
                           val_loaders=val_loaders, val_name="validation",
                           run_name=run_name)
        return self._eval_all(evals, ckpt_type="best", run_name=run_name,
                              n_samples=cfg["times_test_sample"])

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
                              test_mode=True, n_samples=cfg["test_sampling_times"],
                              zero_noise=cfg["test_zero_noise"])

    def _eval_step(self, n_samples: int, zero_noise: bool):
        key = (n_samples, zero_noise)
        if key not in self._eval_steps:
            self._eval_steps[key] = make_eval_step(
                self.gen_model, self.disc_model, n_samples=n_samples,
                zero_noise=zero_noise)
        return self._eval_steps[key]

    def load_params(self, ckpt_type: str, run_name: str, load: bool):
        """Load the G and D checkpoints' parameters into the models (on the
        device); the optimizer states stay as they are."""
        gpath = self._ckpt_path("G", ckpt_type, run_name, load=load)
        dpath = self._ckpt_path("D", ckpt_type, run_name, load=load)
        if not osp.exists(gpath):
            raise FileNotFoundError(
                f"checkpoint {gpath} not found (no '{ckpt_type}' model was "
                "saved - check es_warmup/epochs or test_load_path)")
        self.gen_model.load_state_dict(ckpt_lib.restore_checkpoint(gpath)[1])
        self.disc_model.load_state_dict(ckpt_lib.restore_checkpoint(dpath)[1])

    def save_model(self, epoch, ckpt_type="best", run_name="train"):
        def write():
            ckpt_lib.save_checkpoint(self._ckpt_path("G", ckpt_type, run_name),
                                     epoch, self.gen_model.state_dict(),
                                     self.opt_G.state_dict())
            ckpt_lib.save_checkpoint(self._ckpt_path("D", ckpt_type, run_name),
                                     epoch, self.disc_model.state_dict(),
                                     self.opt_D.state_dict())
        self._save(write)
