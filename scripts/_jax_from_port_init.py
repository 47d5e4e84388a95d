"""Run the JAX package's handler from the PyTorch port's initial weights
(CPU, f32).

    python scripts/_jax_from_port_init.py --config <yaml> [--handler adv|base]

The config is a JAX-side config of `scripts/run_torch_parity.py`. The port
draws its initial networks (`advmil_tpu_torch.train.handler.AdvHandler`'s G
and D, or `train.baseline.BaselineHandler`'s model, with `device: cpu`, its
own seeded init), `bridge.torch_to_flax` carries them across, and the JAX
handler trains from them with its own dropout, noise and shuffle streams:
everything but the initial weights is the JAX run's. Prints `[INFO]
Metrics: {...}` as `main.py` does.
"""
import argparse
import os.path as osp
import sys

import jax

jax.config.update("jax_platforms", "cpu")

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)

import jax.numpy as jnp  # noqa: E402

from advmil_tpu.config import get_config  # noqa: E402
from advmil_tpu_torch import bridge  # noqa: E402
from advmil_tpu_torch import config as tconfig  # noqa: E402


def _same_tree(want, got):
    if jax.tree_util.tree_structure(dict(want)) != jax.tree_util.tree_structure(got):
        raise SystemExit("the port's parameter tree does not match the JAX one")
    return jax.tree_util.tree_map(jnp.asarray, got)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--handler", default="adv", choices=["adv", "base"])
    args = ap.parse_args()
    cfg = get_config(args.config)
    port_cfg = tconfig.with_defaults({k: v for k, v in tconfig.read_yaml(args.config).items()
                                      if k != "rng_impl"})
    # its own directory: the port's handler writes its config and log there
    port_cfg.update(device="cpu", save_path=osp.join(cfg["save_path"], "port_init"))
    if args.handler == "adv":
        from advmil_tpu.train.handler import AdvHandler
        from advmil_tpu_torch.train.handler import AdvHandler as PortHandler
        port = PortHandler(port_cfg)
        jh = AdvHandler(cfg)
        jh.params_G = _same_tree(jh.params_G, bridge.torch_to_flax(port.gen_model.state_dict()))
        jh.params_D = _same_tree(jh.params_D, bridge.torch_to_flax(port.disc_model.state_dict()))
        jh.state = jh.state.replace(params_G=jh.params_G, params_D=jh.params_D,
                                    opt_G=jh.tx_G.init(jh.params_G),
                                    opt_D=jh.tx_D.init(jh.params_D))
    else:
        from advmil_tpu.train.baseline import BaselineHandler
        from advmil_tpu_torch.train.baseline import BaselineHandler as PortHandler
        port = PortHandler(port_cfg)
        jh = BaselineHandler(cfg)
        jh.params = _same_tree(jh.params, bridge.torch_to_flax(port.model.state_dict()))
        jh.state = jh.state.replace(params=jh.params, opt=jh.tx.init(jh.params))
    metrics = jh.exec()
    print("[INFO] Metrics:", metrics)


if __name__ == "__main__":
    main()
