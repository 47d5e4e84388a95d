"""Experiment logging with an optional wandb backend.

The reference hard-requires wandb (reference model/model_handler.py:49,61).
Here logging degrades gracefully: if wandb is importable and enabled it is
used; otherwise scalars go to an append-only JSONL file next to the run
artifacts so training remains observable in any environment.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import time


class RunLogger:
    def __init__(self, project: str | None, name: str, log_dir: str,
                 config: dict | None = None, use_wandb: bool | None = None,
                 enabled: bool = True):
        """enabled=False makes every call a no-op (non-primary processes of a
        multi-host run must not race on the shared jsonl/wandb sinks)."""
        self.project = project
        self.name = name
        self.log_dir = log_dir
        self._wandb = None
        self._step = 0
        self.enabled = enabled
        if not enabled:
            self._jsonl = None
            return
        if use_wandb is None:
            use_wandb = os.environ.get("ADVMIL_WANDB", "0") == "1"
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=project, name=name, dir=log_dir,
                                         config=config, reinit=True)
            except Exception as exc:  # missing package / offline
                print(f"[logging] wandb unavailable ({exc}); falling back to jsonl")
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl_path = osp.join(log_dir, f"{name}_scalars.jsonl")
        self._jsonl = open(self._jsonl_path, "a")

    def log(self, scalars: dict):
        if not self.enabled:
            return
        self._step += 1
        if self._wandb is not None:
            self._wandb.log(scalars)
        rec = {"_step": self._step, "_time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()
                    if isinstance(v, (int, float))})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def log_image(self, name: str, figure):
        if not self.enabled:
            return
        if self._wandb is not None:
            import wandb
            self._wandb.log({name: wandb.Image(figure)})
        else:
            path = osp.join(self.log_dir, f"{self.name}_{name.replace('/', '_')}.png")
            figure.savefig(path)
        import matplotlib.pyplot as plt
        plt.close(figure)

    def finish(self):
        if not self.enabled:
            return
        if self._wandb is not None:
            self._wandb.finish()
        self._jsonl.close()
