"""The weight bridge (advmil_tpu_torch.bridge) on the cfg_nlst G and D trees
and on a PatchGCN G at the same widths: flax -> torch -> flax round trips
exactly, every flax leaf lands on a port parameter (strict load), and the
parameter counts are those of the ESAT main path and of the graph path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advmil_tpu.models import backbones as jbb
from advmil_tpu.models import gan as jgan
from advmil_tpu_torch import bridge
from advmil_tpu_torch.models import backbones as tbb
from advmil_tpu_torch.models import gan as tgan

G_PARAMS = 1_653_314
D_PARAMS = 206_338
G_GRAPH_PARAMS = 2_392_516   # PatchGCN 1024-384-384, 2 graph layers, head 384-1


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def nlst_trees():
    """flax G / D params at cfg_nlst widths and the matching port modules."""
    x = jnp.zeros((1, 16, 1024), jnp.float32)
    m = jnp.ones((1, 16), jnp.float32)
    jG = jgan.Generator(backbone=jbb.load_backbone("patch", [1024, 384, 384]),
                        dim_in=384, dim_out=1, noise=(0, 1), hops=1)
    pG = jG.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
                  "dropout": jax.random.PRNGKey(2)}, x, m, zero_noise=True,
                 deterministic=True)["params"]
    jD = jgan.PrjDiscriminator(1024, 128, 1, (64, 128), prj_path="x",
                               inner_product="instance")
    pD = jD.init({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
                 x, jnp.zeros((1, 1)), m, deterministic=True)["params"]
    tG = tgan.Generator(tbb.load_backbone("patch", [1024, 384, 384]), 384, 1, (0, 1))
    tD = tgan.PrjDiscriminator(1024, 128, 1, (64, 128), prj_path="x",
                               inner_product="instance")
    # PatchGCN: GENConv t, layer0_conv / layer1 (DeepGCN block), gate
    jGg = jgan.Generator(backbone=jbb.load_backbone("graph", [1024, 384, 384],
                                                    num_graph_layers=2),
                         dim_in=384, dim_out=1, noise=(0, 1), hops=1)
    edges = {"edge_src": jnp.zeros((1, 16, 9), jnp.int32),
             "edge_mask": jnp.ones((1, 16, 9), jnp.float32)}
    pGg = jGg.init({"params": jax.random.PRNGKey(5), "noise": jax.random.PRNGKey(6),
                    "dropout": jax.random.PRNGKey(7)}, x, m, edges, zero_noise=True,
                   deterministic=True)["params"]
    tGg = tgan.Generator(tbb.load_backbone("graph", [1024, 384, 384], num_graph_layers=2),
                         384, 1, (0, 1))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, dict(p))  # noqa: E731
    return {"G": (to_np(pG), tG), "D": (to_np(pD), tD), "G_graph": (to_np(pGg), tGg)}


@pytest.mark.parametrize("net,count", [("G", G_PARAMS), ("D", D_PARAMS),
                                       ("G_graph", G_GRAPH_PARAMS)])
def test_round_trip_is_exact(nlst_trees, net, count):
    params, module = nlst_trees[net]
    assert sum(v.size for v in _flatten(params).values()) == count
    module.load_state_dict(bridge.flax_to_torch(params))        # strict
    assert sum(p.numel() for p in module.parameters()) == count
    back = _flatten(bridge.torch_to_flax(module.state_dict()))
    want = _flatten(params)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg="/".join(k))


def test_main_path_names(nlst_trees):
    sd = bridge.flax_to_torch(nlst_trees["G"][0])
    assert sd["backbone.encoder_0.in_proj.weight"].shape == (3 * 384, 384)
    w = nlst_trees["G"][0]["backbone"]["encoder_0"]["in_proj"]["kernel"]
    # q | k | v packed on the output axis, like torch's in_proj_weight
    np.testing.assert_array_equal(sd["backbone.encoder_0.in_proj.weight"][384:768].numpy(),
                                  w[:, 384:768].T)
    assert sd["head_mlp.mlp_1.weight"].shape == (1, 384)     # fan_in 2 * 192
    assert sd["head_mlp.mlp_0.Dense_0.weight"].shape == (192, 384)
    assert sd["backbone.patch_embedding.LayerNorm_0.weight"].shape == (384,)
    sdD = bridge.flax_to_torch(nlst_trees["D"][0])
    assert {k.split(".")[0] for k in sdD} == {"net_pair_one", "net_pair_two",
                                              "prj_layer"}


def test_npz_round_trip(nlst_trees, tmp_path):
    params = nlst_trees["D"][0]
    path = str(tmp_path / "d.npz")
    bridge.save_npz(path, params)
    back = _flatten(bridge.load_npz(path))
    want = _flatten(params)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


def test_unknown_leaf_is_refused():
    with pytest.raises(ValueError):
        bridge.flax_to_torch({"conv": {"kernel": np.zeros((3, 4, 8))}})   # a 1-D conv
    with pytest.raises(ValueError):
        bridge.flax_to_torch({"emb": {"embedding": np.zeros((3, 4))}})
    assert torch.equal(bridge.flax_to_torch({"n": {"scale": np.ones(2)}})["n.weight"],
                       torch.ones(2))
    # a 2-D conv kernel is carried: flax HWIO -> torch OIHW
    assert bridge.flax_to_torch({"c": {"kernel": np.zeros((3, 3, 4, 8))}})["c.weight"].shape \
        == (8, 4, 3, 3)
