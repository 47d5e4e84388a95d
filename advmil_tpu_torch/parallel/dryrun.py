"""One sharded adversarial step in each backbone mode over n CPU ranks
(counterpart of the JAX package's `dryrun_multichip`):

    python -m advmil_tpu_torch.parallel.dryrun 4

spawns n gloo ranks on the CPU and runs, on a random global batch of 2n
bags, one adversarial step of G and D (cont_gansurv, bce, L1) under pure
data parallelism in patch, cluster and graph mode (the dense graph route),
on the grid route (`graph_grid`: the chain+skip graph laid out on a grid
16 patches wide with 4 empty cells a row, as the JAX dry run's grid case),
then in every one of these modes on an (n/2) x 2 dp x inst grid; every rank
asserts finite, equal losses.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

C, N = 64, 256          # feature width, patches per bag (16 regions)


def _cfg(mode: str) -> dict:
    from ..config import with_defaults
    return with_defaults({
        "task": "cont_gansurv", "device": "cpu",
        "bcb_mode": "graph" if mode == "graph_grid" else mode,
        "bcb_dims": f"{C}-64-64", "gen_dims": "64-1", "gen_noi_noise": "0-1",
        "gen_noi_noise_dist": "uniform", "gen_noi_hops": 1, "gen_norm": False,
        "gen_dropout": 0.6, "gen_out_scale": "sigmoid", "disc_type": "prj",
        "disc_netx_in_dim": C, "disc_netx_out_dim": 32, "disc_nety_in_dim": 1,
        "disc_nety_hid_dims": "16-32", "disc_netx_dropout": 0.25,
        "disc_nety_norm": False, "disc_nety_dropout": 0.0, "disc_prj_path": "x",
        "disc_prj_iprd": "instance", "loss_recon_norm": "l1", "loss_recon_alpha": 0.0,
        "loss_recon_gamma": 0.0, "num_graph_layers": 2, "flash_min_len": 8})


def _batch(B: int, mode: str) -> dict:
    """A random global host batch (every rank draws the same one)."""
    rng = np.random.default_rng(0)
    mask = np.ones((B, N), np.float32)
    mask[0, N // 2 + 8:] = 0.0
    t = rng.uniform(0.1, 1.0, size=B).astype(np.float32)
    batch = {"feats": (rng.normal(size=(B, N, C)) * mask[..., None]).astype(np.float32),
             "mask": mask, "label": np.stack([t, np.ones(B, np.float32)], 1),
             "sample_mask": np.ones(B, np.float32), "visible": np.ones(B, np.float32)}
    if mode == "cluster":
        batch["cluster_id"] = np.where(mask > 0, rng.integers(0, 8, size=(B, N)),
                                       -1).astype(np.int32)
    elif mode == "graph":
        src = rng.integers(0, N // 2, size=(B, N, 9)).astype(np.int32)
        batch["graph"] = {"edge_src": src,
                          "edge_mask": np.repeat(mask[..., None], 9, axis=2)}
    elif mode == "graph_grid":
        from ..data.bags import grid_tables
        from ..data.synthetic import chain_skip_graph
        a = np.arange(N)
        rc = np.stack([a // 16, a % 16], axis=1)          # rows of 20 cells, 4 empty
        tabs, _ = grid_tables(chain_skip_graph(N), rc, 20, -(-(N // 16) * 20 // 128) * 128,
                              N, 9, u_slots=64)
        batch["graph"] = {k: np.repeat(v[None], B, axis=0) for k, v in tabs.items()}
    return batch


def _step(device, mode: str, dp: int, inst: int) -> dict:
    from ..models.layers import Rngs, init_parameters
    from ..train import steps
    from ..train.handler import build_models
    from ..train.optim import create_optimizer
    from . import mesh
    g = mesh.make_grid(dp, inst, device)
    mesh.set_grid(g)
    cfg = _cfg(mode)
    gen, disc = build_models(cfg)
    init_parameters(gen, 0)
    init_parameters(disc, 1)
    step = steps.make_adv_train_step(
        gen, disc, create_optimizer("adam", gen.parameters(), 8e-5, weight_decay=5e-4),
        create_optimizer("adam", disc.parameters(), 8e-5), loss_netD="bce",
        coef_gan=0.004, l1_coef=1e-5, gen_updates=1,
        sup_loss_fn=steps.make_supervised_loss("cont_gansurv", cfg))
    host = _batch(2 * dp, mode)
    local = mesh.shard_batch_2d({k: host[k] for k in ("feats", "mask", "cluster_id", "graph")
                                 if k in host}, g)
    batch = {"feats": torch.from_numpy(np.ascontiguousarray(local["feats"])),
             "mask": torch.from_numpy(np.ascontiguousarray(local["mask"])),
             **{k: torch.from_numpy(host[k]) for k in ("label", "sample_mask", "visible")}}
    if "cluster_id" in local:
        batch["extra"] = torch.from_numpy(np.ascontiguousarray(local["cluster_id"]))
    elif "graph" in local:
        batch["extra"] = {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in local["graph"].items()}
    rngs = Rngs(device=torch.Generator().manual_seed(0), host=torch.Generator().manual_seed(1))
    metrics, _ = step(batch, rngs)
    mesh.set_grid(None)
    out = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"{mode} dp {dp} x inst {inst}: non-finite losses {out}")
    return out


def _rank(rank, device, n: int) -> dict:
    modes = ("patch", "cluster", "graph", "graph_grid")
    runs = {f"dp{n} {mode}": _step(device, mode, n, 1) for mode in modes}
    if n >= 4 and n % 2 == 0:
        runs.update({f"dp{n // 2} x inst2 {mode}": _step(device, mode, n // 2, 2)
                     for mode in modes})
    return runs


def dryrun_multichip(n_devices: int) -> dict:
    """Run the dry run over `n_devices` CPU ranks; returns rank 0's losses per
    case after checking that every rank reports the same."""
    from .launch import run_ranks
    results = run_ranks(_rank, ["cpu"] * int(n_devices), (int(n_devices),))
    for r in results[1:]:
        if r != results[0]:
            raise AssertionError(f"ranks disagree: {results[0]} vs {r}")
    for case, met in results[0].items():
        print(f"[dryrun_multichip] {case} ok on {n_devices} ranks: "
              f"Loss_D={met['Loss_D']:.4f} Loss_G_total={met['Loss_G_total']:.4f}")
    return results[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
