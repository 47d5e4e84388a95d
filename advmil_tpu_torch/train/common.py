"""Handler plumbing (counterpart of `advmil_tpu/train/common.py`): the
save/load path layout, the run logger, the bucketed batcher and shipping a
host batch to the configured device."""
from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from ..data.bags import BucketBatcher
from ..utils.func import print_config
from ..utils.logging import RunLogger


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
    """Mixin: the handler sets ``self.cfg`` and ``self.device`` first."""

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
