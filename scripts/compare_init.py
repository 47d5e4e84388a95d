"""Compare the initial-weight distributions of the JAX package and the
PyTorch port, leaf by leaf, over many seeds (CPU, f32).

    python scripts/compare_init.py --workdir DIR [--arm adv_esat_disc]
        [--seeds 0-199] [--out TORCH_PARITY_INIT.json] [--functional]

Both sides build G and D from the arm's JAX-side and port-side configs of
`scripts/run_torch_parity.py` and draw their initial weights for each seed
as their handlers do: the JAX handler's `init` calls with
`jax.random.split(PRNGKey(seed), 3)`'s first two keys; the port's
`seed_everything(seed)`, `build_models`, `init_parameters(G, seed)`,
`init_parameters(D, seed + 1)`. A baseline arm (`--arm base_*`) compares
its one network the same way: the JAX baseline handler's `init` with
`jax.random.split(PRNGKey(seed))`'s first key; the port's `build_survnet`
and `init_parameters(net, seed)`. For every leaf the values of all seeds are
pooled per side and compared: mean, standard deviation, extremes, the
standard deviation over seeds of the per-seed mean, and the two-sample
Kolmogorov-Smirnov statistic with its p-value. Two rules that draw a leaf
alike give p-values spread evenly over (0, 1) across the leaves; a rule
that differs (another distribution, bound or fan) gives p near 0 on its
leaves at these sample sizes. Constant leaves (LayerNorm scales, zero
biases) are compared for equality.

`--functional` compares instead what the initial networks compute (a
leaf-wise test cannot see a difference that only shows in a function of
several leaves). Each side's draws for every seed go through the port's G
and D (`bridge.flax_to_torch` carries the JAX draws across; the two
packages' steps agree within 1e-5 in `tests/test_torch_train.py`), on one
fixed batch of the parity dataset (fold 0's training batch with the most
bags), in eval mode with zero noise. Per seed: G's outputs (each of its outputs' mean and
spread over the batch, and the mean entropy of the normalised output
vector) and D's logit on the real pairs, on G's fake pairs, and their gap,
the pairs formed as the adversarial step forms them. Each statistic's
distribution over the seeds is compared between the sides (two-sample KS,
Bonferroni over the statistics). The port's statistics at the seeds of the
arm's collapsed pairs in TORCH_PARITY.json (port val < 0.7) are
compared with those at the arm's other seeds (Mann-Whitney U). Writes
TORCH_PARITY_INIT_FUNCTIONAL.json.

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
from advmil_tpu_torch.models.layers import PT041, XAVIER, init_parameters  # noqa: E402
from advmil_tpu_torch.train import baseline as tbaseline  # noqa: E402
from advmil_tpu_torch.train.handler import build_models  # noqa: E402
from advmil_tpu_torch.utils.func import seed_everything, sparse_str  # noqa: E402


def _leaves(tree: dict) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float64)
            for path, v in flat}


def jax_trees(cfg: dict, seeds: list, handler: str = "adv"):
    """Each seed's flax parameter trees, (G, D) or the baseline's (net,),
    from the JAX handler's own init calls."""
    import jax.numpy as jnp
    if handler == "base":
        yield from _jax_base_trees(cfg, seeds)
        return
    h = AdvHandler(cfg)
    dummy = h._dummy_batch()
    t_dummy = jnp.zeros((1, int(cfg["disc_nety_in_dim"])), jnp.float32)
    init_g = jax.jit(lambda k: h.gen_model.init(
        {"params": k, "noise": k, "dropout": k}, dummy["feats"], dummy["mask"],
        dummy["extra"], zero_noise=True, deterministic=True)["params"])
    init_d = jax.jit(lambda k: h.disc_model.init(
        {"params": k, "dropout": k}, dummy["feats"], t_dummy, dummy["mask"],
        deterministic=True)["params"])
    for seed in seeds:
        kG, kD, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
        yield dict(init_g(kG)), dict(init_d(kD))


def _jax_base_trees(cfg: dict, seeds: list):
    """The JAX baseline handler's init: `PRNGKey(seed)`'s first split key on
    the handler's own dummy batch."""
    import jax.numpy as jnp
    from advmil_tpu.train.baseline import BaselineHandler
    h = BaselineHandler(cfg)
    dim = sparse_str(cfg["bcb_dims"])[0]
    extra = {"cluster": jnp.zeros((1, 16), jnp.int32)}.get(cfg["bcb_mode"])
    init = jax.jit(lambda k: h.model.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 16, dim), jnp.float32),
        jnp.ones((1, 16), jnp.float32), extra, deterministic=True)["params"])
    for seed in seeds:
        yield (dict(init(jax.random.split(jax.random.PRNGKey(seed))[0])),)


def port_trees(cfg: dict, seeds: list, handler: str = "adv"):
    """Each seed's flax parameter trees, (G, D) or the baseline's (net,):
    the port handler's init."""
    for seed in seeds:
        seed_everything(seed)
        if handler == "base":
            out_scale = tbaseline._TASK_OUTPUT[cfg["task"]][0]
            net = tbaseline.build_survnet(cfg, out_scale,
                                          XAVIER if out_scale == "sigmoid" else PT041)
            init_parameters(net, seed)
            yield (bridge.torch_to_flax(net.state_dict()),)
            continue
        G, D = build_models(cfg)
        init_parameters(G, seed)
        init_parameters(D, seed + 1)
        yield bridge.torch_to_flax(G.state_dict()), bridge.torch_to_flax(D.state_dict())


def draws(trees, nets=("G", "D")) -> dict:
    """net -> leaf -> [seeds, *shape] in the flax tree's names."""
    out = {net: {} for net in nets}
    for pair in trees:
        for net, tree in zip(nets, pair):
            for name, v in _leaves(tree).items():
                out[net].setdefault(name, []).append(v)
    return {net: {n: np.stack(v) for n, v in leaves.items()} for net, leaves in out.items()}


def fixed_batch(cfg: dict) -> dict:
    """Fold 0's training batch with the most bags (unshuffled) of the parity
    dataset, as CPU tensors, with the real pairs' time rows and the mask of
    the fake pairs, as the adversarial step forms them for the task."""
    import torch
    from advmil_tpu_torch import losses
    from advmil_tpu_torch.data.bags import BucketBatcher, prepare_dataset
    from advmil_tpu_torch.utils.io import read_datasplit_npz
    train, _, _ = read_datasplit_npz(cfg["data_split_path"].format(0))
    ds = prepare_dataset(train, cfg)
    b = max(BucketBatcher(ds, token_budget=cfg["batch_token_budget"],
                          min_bucket=cfg["bucket_min"]).epoch_batches(),
            key=lambda b: b.sample_mask.sum())
    t, e = (torch.from_numpy(b.label[:, i]) for i in (0, 1))
    if cfg["task"] == "disc_gansurv":
        y_disc, y_mask = losses.get_label_mask(t, 1.0 - e, int(cfg["time_bins"]))
        t_real = y_disc * y_mask
    else:
        t_real, y_mask = t[:, None].float(), torch.ones(len(t), 1)
    keep = torch.from_numpy(b.sample_mask).bool()
    return {"feats": torch.from_numpy(b.feats), "mask": torch.from_numpy(b.mask),
            "t_real": t_real, "y_mask": y_mask, "keep": keep}


def functional_stats(cfg: dict, trees, batch: dict) -> dict:
    """statistic -> [seeds]: what each seed's initial G and D compute on
    `batch` (eval mode, zero noise; the port's forwards)."""
    import torch
    G, D = build_models(cfg)
    G.eval()
    D.eval()
    out = {}
    with torch.no_grad():
        for tG, tD in trees:
            G.load_state_dict(bridge.flax_to_torch(tG))
            D.load_state_dict(bridge.flax_to_torch(tD))
            y = G(batch["feats"], batch["mask"], None, zero_noise=True).float()
            f_real = D(batch["feats"], batch["t_real"], batch["mask"]).float().reshape(-1)
            f_fake = D(batch["feats"], y * batch["y_mask"], batch["mask"]).float().reshape(-1)
            y, f_real, f_fake = (v[batch["keep"]] for v in (y, f_real, f_fake))
            row = {}
            for j in range(y.shape[1]):
                row[f"G_out{j}_mean"] = float(y[:, j].mean())
                row[f"G_out{j}_std"] = float(y[:, j].std())
            p = y.clamp_min(1e-12) / y.clamp_min(1e-12).sum(dim=1, keepdim=True)
            row["G_entropy"] = float(-(p * p.log()).sum(dim=1).mean())
            row["D_real"], row["D_fake"] = float(f_real.mean()), float(f_fake.mean())
            row["D_gap"] = row["D_real"] - row["D_fake"]
            for k, v in row.items():
                out.setdefault(k, []).append(v)
    return {k: np.asarray(v) for k, v in out.items()}


COLLAPSED_BELOW = 0.7    # a pair collapsed: its port val below this (the rest sit near 0.8)


def collapsed_seeds(arm: str, below: float):
    """(seeds of the arm's pairs whose port val < `below`, the arm's other
    seeds) in TORCH_PARITY.json."""
    with open(osp.join(REPO, "TORCH_PARITY.json")) as f:
        rows = json.load(f)[arm]["rows"]
    bad = sorted({r["seed"] for r in rows if r["port_val"] < below})
    return bad, sorted({r["seed"] for r in rows} - set(bad))


def functional(args, seeds, jcfg, tcfg):
    batch = fixed_batch(tcfg)
    want = functional_stats(tcfg, jax_trees(jcfg, seeds), batch)
    got = functional_stats(tcfg, port_trees(tcfg, seeds), batch)
    n = len(want)
    rows = {}
    for k in want:
        ks = stats.ks_2samp(want[k], got[k])
        rows[k] = {"jax_mean": float(want[k].mean()), "jax_std": float(want[k].std()),
                   "port_mean": float(got[k].mean()), "port_std": float(got[k].std()),
                   "ks_stat": float(ks.statistic), "ks_p": float(ks.pvalue),
                   "ks_p_bonferroni": min(1.0, float(ks.pvalue) * n)}
    bad, rest = collapsed_seeds(args.arm, COLLAPSED_BELOW)
    port_at = functional_stats(tcfg, port_trees(tcfg, bad + rest), batch)
    coll = {}
    for k, v in port_at.items():
        a, b = v[:len(bad)], v[len(bad):]
        u = stats.mannwhitneyu(a, b) if len(a) and len(b) else None
        coll[k] = {"collapsed_mean": float(a.mean()) if len(a) else None,
                   "rest_mean": float(b.mean()), "rest_std": float(b.std()),
                   "mannwhitney_p": float(u.pvalue) if u else None,
                   "mannwhitney_p_bonferroni": min(1.0, float(u.pvalue) * n) if u else None}
    summary = {"arm": args.arm, "seeds": [seeds[0], seeds[-1]], "n_seeds": len(seeds),
               "statistics": n, "batch_bags": int(batch["keep"].sum()),
               "batch_shape": list(batch["feats"].shape),
               "min_ks_p_bonferroni": min(r["ks_p_bonferroni"] for r in rows.values()),
               "collapse_below": COLLAPSED_BELOW, "collapsed_seeds": bad,
               "other_seeds": len(rest),
               "min_collapse_p_bonferroni": min(
                   (r["mannwhitney_p_bonferroni"] for r in coll.values()
                    if r["mannwhitney_p_bonferroni"] is not None), default=None)}
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "statistics": rows, "collapsed": coll}, f, indent=1)
    print(json.dumps(summary))
    for k, r in rows.items():
        c = coll[k]
        print(f"{k:12s} JAX {r['jax_mean']:+.5f} +/- {r['jax_std']:.5f}  port "
              f"{r['port_mean']:+.5f} +/- {r['port_std']:.5f}  KS p {r['ks_p']:.3g} "
              f"(x{n}: {r['ks_p_bonferroni']:.3g}) | collapsed {c['collapsed_mean']:+.5f} "
              f"rest {c['rest_mean']:+.5f} +/- {c['rest_std']:.5f} MW p "
              f"{c['mannwhitney_p']:.3g}")


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
                    choices=[a for a in rtp.ARMS if a != "adv_ssl"])
    ap.add_argument("--seeds", nargs="+", default=["0-199"])
    ap.add_argument("--out", default=None,
                    help="default TORCH_PARITY_INIT.json (another arm than "
                         "adv_esat_disc: TORCH_PARITY_INIT_<arm>.json), with --functional "
                         "TORCH_PARITY_INIT_FUNCTIONAL.json (repo root)")
    ap.add_argument("--functional", action="store_true",
                    help="compare what the initial networks compute, not their leaves")
    args = ap.parse_args()
    suffix = "" if args.arm == "adv_esat_disc" else f"_{args.arm}"
    args.out = args.out or osp.join(REPO, f"TORCH_PARITY_INIT{suffix}.json" if not
                                    args.functional else "TORCH_PARITY_INIT_FUNCTIONAL.json")
    seeds = rtp.parse_seeds(args.seeds)
    os.makedirs(args.workdir, exist_ok=True)
    paths = rtp.run_parity.build_dataset(args.workdir, 5)
    run_dir = osp.join(args.workdir, "init_compare")
    jcfg = jconfig.with_defaults(rtp.side_cfg(args.arm, "jax", paths, 0, seeds[0],
                                              run_dir, 1))
    tcfg = tconfig.with_defaults(rtp.side_cfg(args.arm, "port", paths, 0, seeds[0],
                                              run_dir, 1))
    handler = rtp.ARMS[args.arm][0]
    if args.functional:
        if handler != "adv":
            raise SystemExit("--functional compares the adversarial arms' G and D")
        return functional(args, seeds, jcfg, tcfg)
    nets = ("G", "D") if handler == "adv" else ("net",)
    want = draws(jax_trees(jcfg, seeds, handler), nets)
    got = draws(port_trees(tcfg, seeds, handler), nets)
    leaves, ps = {}, []
    for net in nets:
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
