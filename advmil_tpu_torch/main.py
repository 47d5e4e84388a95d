"""Entry point of the port, with the CLI contract of the repo's `main.py`:

    python -m advmil_tpu_torch.main --config <yaml> --handler {adv,base} [--multi_run]

`adv` is the adversarial handler, `base` the baseline (SurvNet) handler.
Dispatch: semi_training -> exec_semi_sl(), test -> exec_test(), else exec().
Both run on the configured `device`.
--multi_run expands every list-valued key into a grid, each run with a
derived save_path suffix.
"""
from __future__ import annotations

import argparse

from .config import get_config, grid, grid_hyperparams, with_defaults
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
    """Run the CLI; returns [(handler, metrics)] for each run."""
    args = get_args(argv)
    config = get_config(args["config"])
    print_config(config)
    if args["handler"] == "adv":
        from .train.handler import AdvHandler as handler_cls
    elif args["handler"] == "base":
        from .train.baseline import BaselineHandler as handler_cls
    else:
        raise SystemExit(f"unknown handler {args['handler']} (use adv|base)")
    if not args["multi_run"]:
        return [run_one(handler_cls, config)]
    results = []
    hyperparams = grid_hyperparams(config)
    for cnf in grid(config):
        for k in hyperparams:
            cnf["save_path"] += f"-{k}_{cnf[k]}"
        print(cnf["save_path"])
        results.append(run_one(handler_cls, with_defaults(cnf)))
    return results


if __name__ == "__main__":
    main()
