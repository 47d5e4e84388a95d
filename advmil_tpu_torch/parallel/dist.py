"""Process-group initialisation and host-side helpers of a multi-process run
(counterpart of `advmil_tpu/parallel/dist.py`).

Config keys (all optional; absent means single-process), read as the JAX
package reads them, with the same environment fallbacks:
  dist_init:          "auto" -> torchrun's `env://` rendezvous (MASTER_ADDR,
                      MASTER_PORT, RANK, WORLD_SIZE set by the launcher), the
                      counterpart of the TPU pod's metadata server
  dist_coordinator:   "host:port" of rank 0
  dist_num_processes: the world size (one process per card)
  dist_process_id:    this process's rank
Environment fallbacks: ADVMIL_DIST_INIT / ADVMIL_COORDINATOR /
ADVMIL_NUM_PROCESSES / ADVMIL_PROCESS_ID.

The backend is NCCL when the ranks run on cards, gloo on the CPU
(`backend_for`). A multi-host run is pure data parallelism over every rank
(`inst_devices` is ignored there, as in the JAX package). Only rank 0 writes
checkpoints, prediction CSVs and logs; every rank reads checkpoints back from
`save_path`, so on several hosts it must be a filesystem they share.
"""
from __future__ import annotations

import os
import sys

import torch
import torch.distributed as tdist


def _lookup(cfg: dict | None, key: str, env: str):
    if cfg and cfg.get(key) is not None:
        return cfg[key]
    return os.environ.get(env)


def backend_for(device_type: str, devices=None) -> str:
    """NCCL when every rank has a card of its own; gloo on the CPU, and for
    ranks that share a card (NCCL refuses two ranks on one device)."""
    if device_type != "cuda":
        return "gloo"
    if devices is not None and len(set(devices)) < len(devices):
        return "gloo"
    return "nccl"


def local_device(cfg: dict) -> torch.device:
    """The card of this process in a torchrun / multi-host run: LOCAL_RANK's
    (0 when unset); the CPU under `device: cpu`."""
    if cfg.get("device") != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("config device: cuda, but torch.cuda.is_available() is False")
    idx = int(os.environ.get("LOCAL_RANK", 0))
    if idx >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {idx}: only {torch.cuda.device_count()} "
                           "visible cards")
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def whole_lines() -> None:
    """Make this process's stdout write each line in one piece. The ranks of
    a world share their launcher's stdout: block-buffered, a flush can cut a
    line around another rank's writes, and unbuffered (PYTHONUNBUFFERED, as
    in torchrun's children when the launcher's environment sets it) every
    piece of a `print` is its own write. Line buffering with write-through
    off gathers a line and writes it at its newline."""
    sys.stdout.reconfigure(line_buffering=True, write_through=False)


def _init(device: torch.device, **kwargs) -> None:
    whole_lines()
    backend = backend_for(device.type)
    if backend == "nccl":
        kwargs["device_id"] = device
    tdist.init_process_group(backend, **kwargs)


def maybe_initialize(cfg: dict | None = None) -> bool:
    """Initialise the default process group when multi-process settings are
    present. Returns True when running (or now initialised) multi-process,
    False for a plain single-process run. Idempotent. An initialisation that
    fails raises."""
    if tdist.is_initialized():
        return tdist.get_world_size() > 1
    cfg = cfg or {}
    if str(_lookup(cfg, "dist_init", "ADVMIL_DIST_INIT") or "").lower() == "auto":
        _init(local_device(cfg), init_method="env://")
        print(f"[dist] initialized rank {tdist.get_rank()} / {tdist.get_world_size()} "
              "from the launcher's environment (env://)")
        return tdist.get_world_size() > 1
    num = _lookup(cfg, "dist_num_processes", "ADVMIL_NUM_PROCESSES")
    if num is None or int(num) <= 1:
        return False
    coord = _lookup(cfg, "dist_coordinator", "ADVMIL_COORDINATOR")
    pid = _lookup(cfg, "dist_process_id", "ADVMIL_PROCESS_ID")
    if coord is None or pid is None:
        raise ValueError("dist_num_processes > 1 needs dist_coordinator (host:port of "
                         "rank 0) and dist_process_id, or dist_init: auto under torchrun")
    _init(local_device(cfg), init_method=f"tcp://{coord}", world_size=int(num),
          rank=int(pid))
    print(f"[dist] initialized rank {tdist.get_rank()} / {tdist.get_world_size()} "
          f"(coordinator {coord})")
    return True


def is_multi_process() -> bool:
    return tdist.is_initialized() and tdist.get_world_size() > 1


def barrier() -> None:
    """No-op single-process; otherwise block until every rank arrives."""
    if is_multi_process():
        tdist.barrier()


def is_primary() -> bool:
    return not tdist.is_initialized() or tdist.get_rank() == 0


def multi_host_settings(cfg: dict) -> bool:
    """True when the config (or the environment) asks for a multi-host run:
    `dist_init: auto` or `dist_num_processes` > 1."""
    if str(_lookup(cfg, "dist_init", "ADVMIL_DIST_INIT") or "").lower() == "auto":
        return True
    num = _lookup(cfg, "dist_num_processes", "ADVMIL_NUM_PROCESSES")
    return num is not None and int(num) > 1
