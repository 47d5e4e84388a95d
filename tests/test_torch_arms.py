"""The paired accuracy check's arms (`scripts/run_torch_parity.py::ARMS`):
for every arm, both sides' configs, written as the sweep writes them and read
back by each package's own `get_config`, pass each package's checks (the JAX
package checks the adversarial handler's config only), and the keys that
define the arm's mode are equal on the two sides. No training."""
import os.path as osp
import sys

import pytest
import yaml

from advmil_tpu import config as jconfig
from advmil_tpu_torch import config as tconfig

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "scripts"))
import run_torch_parity as rtp  # noqa: E402

MODE_KEYS = ("task", "bcb_mode", "use_fused_embedding", "graph_banded", "accum_steps",
             "batch_max_size", "path_graph", "time_format", "precision")


def _paths(root) -> dict:
    """The sweep's dataset paths, as names under `root` (nothing is read)."""
    paths = {k: str(root / k) for k in ("path_patch", "path_label", "path_cluster",
                                        "path_graph", "path_coordx5", "path_tissue_graph",
                                        "path_raster_graph")}
    return dict(paths, data_split_path=str(root / "split-fold{}.npz"), feat_format="pt")


@pytest.mark.parametrize("arm", list(rtp.ARMS))
def test_arm_configs_build_and_agree(arm, tmp_path):
    handler = rtp.ARMS[arm][0]
    cfgs = {}
    for side, get in (("jax", jconfig.get_config), ("port", tconfig.get_config)):
        cfg = rtp.side_cfg(arm, side, _paths(tmp_path), 0, 42, str(tmp_path / side), 30)
        path = tmp_path / f"{side}.yaml"
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        cfgs[side] = get(str(path))
    if handler == "adv":            # the JAX adversarial handler checks its config
        jconfig.check_configs(cfgs["jax"])
    tconfig.check_configs(cfgs["port"], handler)
    assert "rng_impl" not in cfgs["port"] and cfgs["jax"]["rng_impl"] == "threefry"
    assert cfgs["port"]["device"] == "cpu"
    for key in MODE_KEYS:
        assert cfgs["jax"].get(key) == cfgs["port"].get(key), key
    assert cfgs["port"]["seed"] == cfgs["jax"]["seed"] == 42
