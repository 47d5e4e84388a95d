"""Entry point of the port, with the CLI contract of the repo's `main.py`:

    python -m advmil_tpu_torch.main --config <yaml> --handler {adv,base} [--multi_run]

`adv` is the adversarial handler, `base` the baseline (SurvNet) handler.
Dispatch: semi_training -> exec_semi_sl(), test -> exec_test(), else exec().
Both run on the configured `device`.
--multi_run expands every list-valued key into a grid, each run with a
derived save_path suffix.

Parallel runs: with `dp_devices * inst_devices > 1` the command spawns one
rank per card itself (`parallel/launch.py`); under torchrun it joins the
ranks torchrun started; with `dist_*` settings (a multi-host run) it joins
the process group they describe.
"""
from __future__ import annotations

import argparse

from .config import check_configs, get_config, grid, grid_hyperparams, with_defaults
from .parallel import launch
from .parallel.dist import maybe_initialize, multi_host_settings
from .utils.func import print_config


def run_one(handler_cls, config):
    """(handler, metrics) of one run."""
    model = handler_cls(config)
    if config.get("semi_training"):
        metrics = model.exec_semi_sl()
    elif config.get("test"):
        metrics = model.exec_test()
    else:
        metrics = model.exec()
    print("[INFO] Metrics:", metrics)
    return model, metrics


def handler_class(name: str):
    if name == "adv":
        from .train.handler import AdvHandler
        return AdvHandler
    if name == "base":
        from .train.baseline import BaselineHandler
        return BaselineHandler
    raise SystemExit(f"unknown handler {name} (use adv|base)")


def _rank(rank, device, handler_name: str, config: dict):
    """One spawned rank: the run's metrics."""
    return run_one(handler_class(handler_name), config)[1]


def launch_ranks(handler_name: str, config: dict) -> list:
    """Run one config over dp_devices x inst_devices spawned ranks, one card
    each (the CPU under `device: cpu`). Returns every rank's metrics in rank
    order."""
    dp, inst = launch.grid_shape(config)
    return launch.run_ranks(_rank, launch.default_devices(config, dp * inst),
                            (handler_name, config))


def run_config(handler_name: str, config: dict):
    """(handler, metrics) of one config: in this process, or, for a run of
    several ranks spawned here, (None, rank 0's metrics)."""
    check_configs(config, handler_name)
    dp, inst = launch.grid_shape(config)
    if multi_host_settings(config):
        maybe_initialize(config)
    elif dp * inst > 1:
        if not launch.torchrun_env():
            return None, launch_ranks(handler_name, config)[0]
        launch.init_from_env(config)
    return run_one(handler_class(handler_name), config)


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", "-f", required=True, type=str,
                        help="path to the config file")
    parser.add_argument("--handler", "-d", required=True, type=str,
                        help="model handler (adv or base)")
    parser.add_argument("--multi_run", action="store_true",
                        help="flag: multi run (grid over list-valued keys)")
    return vars(parser.parse_args(argv))


def main(argv=None) -> list:
    """Run the CLI; returns [(handler, metrics)] for each run (handler None
    for a run of spawned ranks)."""
    args = get_args(argv)
    config = get_config(args["config"])
    print_config(config)
    name = args["handler"]
    handler_class(name)
    if not args["multi_run"]:
        return [run_config(name, config)]
    results = []
    hyperparams = grid_hyperparams(config)
    for cnf in grid(config):
        for k in hyperparams:
            cnf["save_path"] += f"-{k}_{cnf[k]}"
        print(cnf["save_path"])
        results.append(run_config(name, with_defaults(cnf)))
    return results


if __name__ == "__main__":
    main()
