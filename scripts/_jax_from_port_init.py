"""Run the JAX package's adversarial handler from the PyTorch port's initial
weights (CPU, f32).

    python scripts/_jax_from_port_init.py --config <yaml>

The config is a JAX-side config of `scripts/run_torch_parity.py`. The port
draws its initial G and D (`advmil_tpu_torch.train.handler.AdvHandler` with
`device: cpu`, its own seeded init), `bridge.torch_to_flax` carries them
across, and the JAX handler trains from them with its own dropout, noise and
shuffle streams: everything but the initial weights is the JAX run's. Prints
`[INFO] Metrics: {...}` as `main.py` does.
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
from advmil_tpu.train.handler import AdvHandler  # noqa: E402
from advmil_tpu_torch import bridge  # noqa: E402
from advmil_tpu_torch import config as tconfig  # noqa: E402
from advmil_tpu_torch.train import handler as thandler  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    args = ap.parse_args()
    cfg = get_config(args.config)
    port_cfg = tconfig.with_defaults({k: v for k, v in tconfig.read_yaml(args.config).items()
                                      if k != "rng_impl"})
    # its own directory: the port's handler writes its config and log there
    port_cfg.update(device="cpu", save_path=osp.join(cfg["save_path"], "port_init"))
    port = thandler.AdvHandler(port_cfg)
    pG = bridge.torch_to_flax(port.gen_model.state_dict())
    pD = bridge.torch_to_flax(port.disc_model.state_dict())

    jh = AdvHandler(cfg)
    as_jnp = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    for want, got in ((jh.params_G, pG), (jh.params_D, pD)):
        if jax.tree_util.tree_structure(dict(want)) != jax.tree_util.tree_structure(got):
            raise SystemExit("the port's parameter tree does not match the JAX one")
    jh.params_G, jh.params_D = as_jnp(pG), as_jnp(pD)
    jh.state = jh.state.replace(params_G=jh.params_G, params_D=jh.params_D,
                                opt_G=jh.tx_G.init(jh.params_G),
                                opt_D=jh.tx_D.init(jh.params_D))
    metrics = jh.exec()
    print("[INFO] Metrics:", metrics)


if __name__ == "__main__":
    main()
