"""Compare the initial-weight distributions of the JAX package and the
PyTorch port, leaf by leaf, over many seeds (CPU, f32).

    python scripts/compare_init.py --workdir DIR [--arm adv_esat_disc]
        [--seeds 0-199] [--out TORCH_PARITY_INIT.json]

Both sides build G and D from the arm's JAX-side and port-side configs of
`scripts/run_torch_parity.py` and draw their initial weights for each seed
as their handlers do: the JAX handler's `init` calls with
`jax.random.split(PRNGKey(seed), 3)`'s first two keys; the port's
`seed_everything(seed)`, `build_models`, `init_parameters(G, seed)`,
`init_parameters(D, seed + 1)`. For every leaf the values of all seeds are
pooled per side and compared: mean, standard deviation, extremes, the
standard deviation over seeds of the per-seed mean, and the two-sample
Kolmogorov-Smirnov statistic with its p-value. Two rules that draw a leaf
alike give p-values spread evenly over (0, 1) across the leaves; a rule
that differs (another distribution, bound or fan) gives p near 0 on its
leaves at these sample sizes. Constant leaves (LayerNorm scales, zero
biases) are compared for equality.

The JAX handler needs a dataset on disk: the parity sweep's synthetic set
is written under `--workdir` (`run_parity.build_dataset`).
"""
import argparse
import json
import os
import os.path as osp
import sys

import jax

jax.config.update("jax_platforms", "cpu")

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, osp.join(REPO, "scripts"))

import numpy as np  # noqa: E402
from scipy import stats  # noqa: E402

import run_torch_parity as rtp  # noqa: E402
from advmil_tpu import config as jconfig  # noqa: E402
from advmil_tpu.train.handler import AdvHandler  # noqa: E402
from advmil_tpu_torch import bridge  # noqa: E402
from advmil_tpu_torch import config as tconfig  # noqa: E402
from advmil_tpu_torch.models.layers import init_parameters  # noqa: E402
from advmil_tpu_torch.train.handler import build_models  # noqa: E402
from advmil_tpu_torch.utils.func import seed_everything  # noqa: E402


def _leaves(tree: dict) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float64)
            for path, v in flat}


def jax_draws(cfg: dict, seeds: list) -> dict:
    """net -> leaf -> [seeds, *shape]: the JAX handler's own init calls."""
    import jax.numpy as jnp
    h = AdvHandler(cfg)
    dummy = h._dummy_batch()
    t_dummy = jnp.zeros((1, int(cfg["disc_nety_in_dim"])), jnp.float32)
    init_g = jax.jit(lambda k: h.gen_model.init(
        {"params": k, "noise": k, "dropout": k}, dummy["feats"], dummy["mask"],
        dummy["extra"], zero_noise=True, deterministic=True)["params"])
    init_d = jax.jit(lambda k: h.disc_model.init(
        {"params": k, "dropout": k}, dummy["feats"], t_dummy, dummy["mask"],
        deterministic=True)["params"])
    out = {"G": {}, "D": {}}
    for seed in seeds:
        kG, kD, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
        for net, tree in (("G", init_g(kG)), ("D", init_d(kD))):
            for name, v in _leaves(dict(tree)).items():
                out[net].setdefault(name, []).append(v)
    return {net: {n: np.stack(v) for n, v in leaves.items()} for net, leaves in out.items()}


def port_draws(cfg: dict, seeds: list) -> dict:
    """net -> leaf -> [seeds, *shape] in the flax tree's names: the port
    handler's init."""
    out = {"G": {}, "D": {}}
    for seed in seeds:
        seed_everything(seed)
        G, D = build_models(cfg)
        init_parameters(G, seed)
        init_parameters(D, seed + 1)
        for net, m in (("G", G), ("D", D)):
            tree = bridge.torch_to_flax(m.state_dict())
            for name, v in _leaves(tree).items():
                out[net].setdefault(name, []).append(v)
    return {net: {n: np.stack(v) for n, v in leaves.items()} for net, leaves in out.items()}


def compare(a: np.ndarray, b: np.ndarray) -> dict:
    """Pooled statistics of one leaf, JAX (`a`) against the port (`b`)."""
    row = {"shape": list(a.shape[1:]), "n_per_side": int(a.size)}
    for side, v in (("jax", a), ("port", b)):
        row[side] = {"mean": float(v.mean()), "std": float(v.std()),
                     "min": float(v.min()), "max": float(v.max()),
                     "std_of_seed_means": float(v.reshape(len(v), -1).mean(1).std())}
    if a.std() == 0 and b.std() == 0:
        row["constant"] = True
        row["equal"] = bool(np.array_equal(a, b))
        return row
    ks = stats.ks_2samp(a.ravel(), b.ravel())
    row["ks_stat"], row["ks_p"] = float(ks.statistic), float(ks.pvalue)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--arm", default="adv_esat_disc",
                    choices=[a for a, v in rtp.ARMS.items() if v[0] == "adv"])
    ap.add_argument("--seeds", nargs="+", default=["0-199"])
    ap.add_argument("--out", default=osp.join(REPO, "TORCH_PARITY_INIT.json"))
    args = ap.parse_args()
    seeds = rtp.parse_seeds(args.seeds)
    os.makedirs(args.workdir, exist_ok=True)
    paths = rtp.run_parity.build_dataset(args.workdir, 5)
    run_dir = osp.join(args.workdir, "init_compare")
    jcfg = jconfig.with_defaults(rtp.side_cfg(args.arm, "jax", paths, 0, seeds[0],
                                              run_dir, 1))
    tcfg = tconfig.with_defaults(rtp.side_cfg(args.arm, "port", paths, 0, seeds[0],
                                              run_dir, 1))
    want, got = jax_draws(jcfg, seeds), port_draws(tcfg, seeds)
    leaves, ps = {}, []
    for net in ("G", "D"):
        if set(want[net]) != set(got[net]):
            raise SystemExit(f"{net}: the two parameter trees differ: "
                             f"{sorted(set(want[net]) ^ set(got[net]))}")
        for name in sorted(want[net]):
            row = compare(want[net][name], got[net][name])
            leaves[f"{net}/{name}"] = row
            if "ks_p" in row:
                ps.append(row["ks_p"])
    n = len(ps)
    summary = {"arm": args.arm, "seeds": [seeds[0], seeds[-1]], "n_seeds": len(seeds),
               "drawn_leaves": n, "constant_leaves": len(leaves) - n,
               "constant_leaves_equal": all(r.get("equal", True) for r in leaves.values()),
               "min_ks_p": min(ps), "bonferroni_min_ks_p": min(1.0, min(ps) * n),
               "ks_p_below_0.01": sum(p < 0.01 for p in ps),
               "ks_p_uniformity_p": float(stats.kstest(ps, "uniform").pvalue)}
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "leaves": leaves}, f, indent=1)
    print(json.dumps(summary))
    for name, row in leaves.items():
        if "ks_p" in row:
            print(f"{name:70s} {str(row['shape']):12s} KS {row['ks_stat']:.4f} "
                  f"p {row['ks_p']:.3g}  std jax {row['jax']['std']:.5f} "
                  f"port {row['port']['std']:.5f}")
        else:
            print(f"{name:70s} {str(row['shape']):12s} constant, equal {row['equal']}")


if __name__ == "__main__":
    main()
