"""Start the ranks of a dp x inst run from one command.

The JAX package drives a host's devices from one process and needs no
launcher. The port runs one process per card: `python -m
advmil_tpu_torch.main` with `dp_devices * inst_devices > 1` and no torchrun
environment spawns that many ranks itself (`run_ranks`), so the command
line stays the JAX package's. Under torchrun (RANK / WORLD_SIZE set) the
ranks exist already and `init_from_env` joins them, checking the world
size against the config.

`run_ranks` takes an explicit list of devices, one per rank: card indices,
or "cpu". The default (`default_devices`) is one card per rank under
`device: cuda`, and asking for more ranks than there are visible cards
raises. Two ranks may share a card (the list [0, 0]): the process group is
then gloo, since NCCL refuses two ranks on one device.
"""
from __future__ import annotations

import os
import pickle
import socket
import traceback

import torch
import torch.distributed as tdist

from .dist import backend_for, whole_lines


def grid_shape(cfg: dict) -> tuple[int, int]:
    return int(cfg.get("dp_devices", 1) or 1), int(cfg.get("inst_devices", 1) or 1)


def default_devices(cfg: dict, n: int) -> list:
    """One device per rank: cards 0 .. n-1 under `device: cuda` (raises when
    fewer are visible), the CPU under `device: cpu`."""
    if cfg.get("device") != "cuda":
        return ["cpu"] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise RuntimeError(f"{n} ranks (dp_devices x inst_devices) need {n} cards, "
                           f"{have} visible; set device: cpu to run the ranks on the CPU")
    return list(range(n))


def torchrun_env() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_from_env(cfg: dict) -> torch.device:
    """Join a torchrun world (env://): one card per rank (LOCAL_RANK) under
    `device: cuda`. The world size must be dp_devices * inst_devices. Like a
    spawned rank, this one writes whole lines to the stdout it shares."""
    from .dist import local_device
    dp, inst = grid_shape(cfg)
    world = int(os.environ["WORLD_SIZE"])
    if world != dp * inst:
        raise ValueError(f"torchrun started {world} ranks; the config asks for "
                         f"dp_devices {dp} x inst_devices {inst} = {dp * inst}")
    whole_lines()
    device = local_device(cfg)
    kwargs = {"device_id": device} if backend_for(device.type) == "nccl" else {}
    if not tdist.is_initialized():
        tdist.init_process_group(backend_for(device.type), init_method="env://", **kwargs)
    return device


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, devices, port, queue, args):
    whole_lines()       # the ranks share the parent's stdout
    dev = devices[rank]
    if dev == "cpu":
        device = torch.device("cpu")
        # ranks on the CPU share its cores instead of each taking all of them
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    else:
        device = torch.device("cuda", int(dev))
        torch.cuda.set_device(device)
    backend = backend_for(device.type, devices)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    tdist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                             world_size=len(devices), rank=rank, **kwargs)
    try:
        # pickled here to bytes: through the queue torch would share a CPU
        # tensor's storage by a file descriptor that dies with this process
        result = pickle.dumps(fn(rank, device, *args))
        queue.put((rank, True, result))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        tdist.destroy_process_group()


def run_ranks(fn, devices: list, args: tuple = ()) -> list:
    """Run `fn(rank, device, *args)` in len(devices) spawned processes joined
    by one process group over 127.0.0.1; returns each rank's result in rank
    order. `fn` must be importable (a module-level function). A rank that
    raises ends the run: the others are stopped and the error re-raised here
    with that rank's traceback."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    pc = mp.start_processes(_rank_main, args=(fn, list(devices), free_port(), queue, args),
                            nprocs=len(devices), start_method="spawn", join=False)
    results, errors = {}, {}

    def drain():
        while not queue.empty():
            r, ok, val = queue.get()
            (results if ok else errors)[r] = val
    try:
        while not pc.join(timeout=0.5):
            drain()
    except Exception as exc:
        drain()
        if errors:
            r = min(errors)
            raise RuntimeError(f"rank {r} failed:\n{errors[r]}") from exc
        raise
    drain()
    return [pickle.loads(results[r]) for r in range(len(devices))]
