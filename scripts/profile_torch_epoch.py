#!/usr/bin/env python3
"""Where one ESAT training epoch of advmil_tpu_torch spends its time on the
GPU, with and without `use_fused_embedding`; or one PatchGCN epoch on the
banded or the dense graph route.

    python3 scripts/profile_torch_epoch.py [--rounds 2] [--epochs 3]
    python3 scripts/profile_torch_epoch.py --graph banded[,dense] [--rounds 2] [--epochs 3]

Data and configuration are chip_smoke.py's (cfg_nlst width, bf16, 24 training
bags in 4 batches, two of them long enough for flash attention). Each arm
trains `--epochs` epochs through `advmil_tpu_torch.main`, then runs one more
training epoch unprofiled (warm host cache: the wall time) and one under
`torch.profiler` (device time by kernel family, launches). Arms alternate
unfused, fused, fused, unfused, `--rounds` times over. One JSON object per arm
goes to stdout and to `profile_torch_epoch.jsonl` in chip_smoke.py's output
directory, with the card's name and power limit. Needs one CUDA GPU.

`--graph`: PatchGCN (3 graph layers, bf16) on chip_smoke.py phase 8's tissue
graphs and split (23 training bags in 4 batches), on the routes named
(`banded`: band coverage 0.84 takes the banded core #14 / #15 and the exact
residual rows through #12 / #13; `dense`: `graph_banded: off`, #12 / #13 on
every row), in turns a, b, b, a (one route: twice) per round; the families
split out the aggregation kernels and torch's gathers and scatters.

Each arm also lists the LN-pool kernels by name (their template arguments
tell the row widths apart), with launches and device ms in the epoch.
"""
import argparse
import json
import os
import os.path as osp
import sys
import time

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

FAMILIES = (                      # first match wins; names of device kernels
    ("fused_embed", ("fused_rows_kernel", "gemm_tile_kernel", "sum_rows_kernel")),
    ("banded #14 / #15", ("banded_fwd_kernel", "banded_bwd_kernel")),
    ("knn #12 / #13", ("knn_agg_",)),
    ("gather / scatter", ("gather", "scatter", "index_")),
    ("ln_pool", ("ln_relu_region_mean", "sum_partials_kernel")),
    ("flash", ("flash_",)),
    ("gemm", ("gemm", "cutlass", "cublas", "nvjet", "xmma", "splitKreduce")),
    ("adam", ("multi_tensor", "adam")),
    ("memcpy", ("Memcpy", "Memset")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "elementwise / reduce / copy"


def profile_arm(paths, fused: bool, epochs: int, tag: str, graph=None) -> dict:
    """One arm: ESAT (unfused or fused) or, with `graph` = (gpaths, route),
    PatchGCN on that route."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from advmil_tpu_torch import main as port_main

    run = f"profile_{tag}"
    if graph is None:
        cfg = chip_smoke._smoke_cfg(paths, run, test=False, epochs=epochs, es_warmup=0,
                                    use_fused_embedding=fused)
    else:
        cfg = chip_smoke._graph_cfg(paths, graph[0], run, test=False, epochs=epochs,
                                    es_warmup=0,
                                    graph_banded="auto" if graph[1] == "banded" else "off")
    yaml_path = osp.join(chip_smoke.WORK_DIR, f"{run}.yaml")
    chip_smoke._write_yaml(yaml_path, cfg)
    [(handler, _)] = port_main.main(["--config", yaml_path, "--handler", "adv"])
    loader = handler.loaders["train"]
    handler._train_each_epoch(loader)                       # warm, unprofiled
    torch.cuda.synchronize()
    bags, wall = handler.train_timings[-1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        handler._train_each_epoch(loader)
        torch.cuda.synchronize()
    fams, launches, ln_pool = {}, 0, {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us <= 0 or ev.device_type.name == "CPU":
            continue
        fam = family(ev.key)
        fams[fam] = fams.get(fam, 0.0) + dev_us / 1e3
        if fam != "memcpy":
            launches += ev.count
        if fam == "ln_pool":   # the template arguments tell the row widths apart
            ln_pool[ev.key] = [ev.count, dev_us / 1e3]
    kernels_ms = sum(v for k, v in fams.items() if k != "memcpy")
    arm = ("fused" if fused else "unfused") if graph is None else f"graph {graph[1]}"
    return {"arm": arm, "tag": tag, "bags": bags,
            "warm_epoch_s": wall, "bags_per_s": bags / wall,
            "profiled_epoch_s": handler.train_timings[-1][1],
            "device_kernels_ms": kernels_ms, "device_share_of_warm_epoch": kernels_ms / wall / 1e3,
            "kernel_launches": launches, "steps": 4,
            "device_ms_by_family": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
            "ln_pool_launches_ms": ln_pool}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--graph", help="PatchGCN routes to profile, in turns: banded, dense or "
                                    "banded,dense")
    args = ap.parse_args()
    routes = [r for r in (args.graph or "").split(",") if r]
    if any(r not in ("banded", "dense") for r in routes):
        ap.error("--graph takes banded, dense or banded,dense")
    import chip_smoke
    card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    paths = chip_smoke.make_data()
    gpaths = chip_smoke.make_graph_data(paths) if routes else None
    if routes:   # a, b, b, a; one route: twice
        turns = [(False, (gpaths, r)) for r in routes + routes[::-1]]
    else:
        turns = [(fused, None) for fused in (False, True, True, False)]
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with open(osp.join(chip_smoke.OUT_DIR, "profile_torch_epoch.jsonl"), "a") as f:
        for r in range(args.rounds):
            for i, (fused, graph) in enumerate(turns):
                rec = profile_arm(paths, fused, args.epochs, f"r{r}a{i}", graph)
                rec["card"] = card
                line = json.dumps(rec)
                print("PROFILE " + line, flush=True)
                f.write(line + "\n")
    print(f"done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
