"""Paired accuracy check of the PyTorch port against the JAX package.

Both packages train on the same synthetic dataset and split files
(`scripts/run_parity.py::build_dataset`: 160 patients, 128-d `.pt`
features, a planted survival signal) with the same arm configs
(`run_parity.adv_cfg` / `disc_cfg` / `ssl_cfg` / `reg_cfg`, built from this
repo's `config/cfg_nlst.yaml`), on the CPU in f32:

- JAX side: `python main.py` with `ADVMIL_FORCE_CPU=1`, `rng_impl: threefry`
  and `run_parity.ours_extra`'s batching;
- port side: `python -m advmil_tpu_torch.main` with `device: cpu` and the
  same batching.

Dropout masks, noise and initial weights come from each framework's own
generators, so single runs differ; the claim is statistical over folds x
seeds. The pre-registered criterion is PARITY.md's: |paired median delta
val C-index (port - JAX)| <= 0.005, reported with the two-sided sign test
and a bootstrap 95% CI of the paired median. In the semi-supervised arm
(`adv_ssl`) both sides must label the same patients: each run's
`PARITY_SSL_LABELED_JSON=` line is kept, and a pair whose lists differ fails
the sweep.

Every finished run is cached as `<workdir>/<arm>/fold<f>s<seed>/<side>/
result.json` and reused, so an interrupted sweep resumes where it stopped;
`--sides jax` (or `port`) runs one side only. Pairs with a side missing are
listed as unfinished in the report.

The pairs already recorded in TORCH_PARITY.json are pooled with the new
ones and never run again (a recorded row is not re-drawn), and arms not
named in `--arms` keep their recorded results.

`--jax-from-port-init N` (adversarial arms) also runs, for the N pairs of
each named arm where the port's val C-index falls furthest below JAX's, the
JAX side from the port's initial weights (`scripts/_jax_from_port_init.py`):
the one pairing that separates the port's init from the rest of its
training. The result is kept under the arm's `jax_from_port_init` key.

Usage:
  python scripts/run_torch_parity.py --workdir DIR [--arms adv_esat adv_esat_disc ...]
      [--folds 5] [--seeds 42-51 | 42 43 ...] [--procs 4] [--sides jax port]
Writes TORCH_PARITY.md and TORCH_PARITY.json at the repo root.
"""
import argparse
import ast
import json
import math
import os
import os.path as osp
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import yaml

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, osp.join(REPO, "scripts"))
import run_parity  # noqa: E402

run_parity.REF_CFG = osp.join(REPO, "config", "cfg_nlst.yaml")


def tissue_slide_coords(n: int, rng: np.random.Generator) -> np.ndarray:
    """Patch coordinates [n, 2] (pixels, 256-px grid) of a tissue-like
    slide of exactly n patches: an ellipse about 10% larger than n cells,
    less randomly chosen cells (holes), in raster order."""
    side = int(np.ceil(np.sqrt(1.15 * n / (np.pi / 4)))) + 1
    while True:
        yy, xx = np.mgrid[0:side, 0:side].astype(np.float64)
        cy, cx = side / 2 + rng.uniform(-0.5, 0.5, size=2)
        cells = np.argwhere(((yy - cy) / (side / 2)) ** 2 + ((xx - cx) / (side / 2)) ** 2 <= 1.0)
        if len(cells) >= n:
            break
        side += 1
    keep = np.sort(rng.choice(len(cells), size=n, replace=False))
    return (cells[keep][:, ::-1] * 256).astype(np.float32)


def write_tissue_graphs(paths: dict) -> str:
    """The adv_graph_grid arm's graphs: for every slide of the dataset a
    tissue slide of its patch count (`tissue_slide_coords`, seeded by the
    slide id) and its 8-nearest-neighbour graph from the port's graph tool
    (`edge_index`, `edge_latent`: the spatial kNN; `centroid`), written once
    under `<data>/tissue_graphs/`. Both packages read these files, and both
    take the grid route on them."""
    import torch
    sys.path.insert(0, REPO)
    from advmil_tpu_torch.tools.build_graphs import build_graph
    out = osp.join(osp.dirname(paths["path_label"]), "tissue_graphs")
    os.makedirs(out, exist_ok=True)
    for f in sorted(os.listdir(paths["path_patch"])):
        sid = osp.splitext(f)[0]
        dst = osp.join(out, f"{sid}.npz")
        if osp.exists(dst):
            continue
        n = int(torch.load(osp.join(paths["path_patch"], f), mmap=True,
                           weights_only=True).shape[0])
        coords = tissue_slide_coords(n, np.random.default_rng(int(sid[1:])))
        g = build_graph(coords, np.zeros((n, 1), np.float32), use_device_for_feats=False)
        g["edge_latent"] = g["edge_index"]
        np.savez(dst, **g)
    return out


def graph_grid_cfg(paths: dict, fold: int, run_dir: str, epochs: int) -> dict:
    """adv_esat's config with PatchGCN (2 graph layers) on the tissue graphs
    (`path_tissue_graph`), where the grid route engages on both sides."""
    cfg = run_parity.adv_cfg(paths, fold, run_dir, epochs)
    cfg.update(bcb_mode="graph", num_graph_layers=2, path_graph=paths["path_tissue_graph"],
               graph_banded="auto")
    return cfg


# arm -> (handler, run_parity config function, run_parity batching decorator)
ARMS = {"adv_esat": ("adv", run_parity.adv_cfg, run_parity.ours_extra),
        "adv_esat_disc": ("adv", run_parity.disc_cfg, run_parity.ours_extra),
        "adv_ssl": ("adv", run_parity.ssl_cfg, run_parity.ours_extra),
        "base_reg_abmil": ("base", run_parity.reg_cfg, run_parity.ours_extra),
        "base_nll_cluster": ("base", run_parity.cluster_cfg, run_parity.ours_extra),
        "base_nll_abmil_refregime": ("base", run_parity.base_cfg,
                                     run_parity.ours_refregime),
        "adv_graph_grid": ("adv", graph_grid_cfg, run_parity.ours_extra)}
CRITERION = 0.005
RECORD = osp.join(REPO, "TORCH_PARITY.json")


def parse_seeds(items: list) -> list:
    """`42 43` or `42-51` (inclusive) or a mix."""
    seeds = []
    for it in items:
        lo, _, hi = str(it).partition("-")
        seeds += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return seeds


def side_cfg(arm: str, side: str, paths: dict, fold: int, seed: int,
             run_dir: str, epochs: int) -> dict:
    _, make_cfg, decorate = ARMS[arm]
    cfg = decorate(make_cfg(paths, fold, run_dir, epochs))
    cfg["seed"] = seed
    # the parity regime of PARITY.md: f32 on the CPU (cfg_nlst ships bf16)
    cfg["precision"] = "f32"
    if side == "port":
        cfg.pop("rng_impl")
        cfg["device"] = "cpu"
    return cfg


def run_side(arm: str, side: str, cfg: dict, run_dir: str, threads: int) -> dict:
    out = osp.join(run_dir, "result.json")
    if osp.exists(out):
        with open(out) as f:
            return json.load(f)
    os.makedirs(run_dir, exist_ok=True)
    cfg_path = osp.join(run_dir, "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    handler = ARMS[arm][0]
    if side == "jax":
        cmd = [sys.executable, osp.join(REPO, "main.py")]
        env = dict(os.environ, ADVMIL_FORCE_CPU="1")
    elif side == "jax_port_init":
        cmd = [sys.executable, osp.join(REPO, "scripts", "_jax_from_port_init.py")]
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    else:
        cmd = [sys.executable, "-m", "advmil_tpu_torch.main"]
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    cmd += ["--config", cfg_path] + ([] if side == "jax_port_init" else ["--handler", handler])
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, env=env)
    seconds = time.time() - t0
    with open(osp.join(run_dir, "stdout.log"), "w") as f:
        f.write(r.stdout + "\n--- stderr ---\n" + r.stderr)
    m = re.search(r"\[INFO\] Metrics: (\{.*\})", r.stdout)
    if r.returncode != 0 or not m:
        raise RuntimeError(f"{arm} {side} run in {run_dir} failed rc={r.returncode}\n"
                           f"stderr tail: {r.stderr[-2000:]}")
    metrics = ast.literal_eval(m.group(1))
    res = {"val": run_parity.cindex_of(metrics, "validation"),
           "test": run_parity.cindex_of(metrics, "test"),
           "seconds": seconds}
    labeled = re.search(r"PARITY_SSL_LABELED_JSON=(\[.*\])", r.stdout)
    if labeled:
        res["labeled"] = json.loads(labeled.group(1))
    with open(out, "w") as f:
        json.dump(res, f)
    return res


def sign_test_p(d: np.ndarray) -> tuple:
    npos, nneg = int((d > 0).sum()), int((d < 0).sum())
    nz = npos + nneg
    p = (float(min(1.0, 2.0 * sum(math.comb(nz, i)
                                  for i in range(min(npos, nneg) + 1)) / 2.0 ** nz))
         if nz else 1.0)
    return p, npos, nneg


def summarize(rows: list) -> dict:
    jv = np.array([r["jax_val"] for r in rows])
    pv = np.array([r["port_val"] for r in rows])
    jt = np.array([r["jax_test"] for r in rows])
    pt = np.array([r["port_test"] for r in rows])
    d = pv - jv
    p, npos, nneg = sign_test_p(d)
    meds = np.median(np.random.default_rng(0).choice(d, size=(10000, len(d))), axis=1)
    return {
        "n_runs": len(rows),
        "jax_val_mean": float(jv.mean()), "jax_val_std": float(jv.std()),
        "port_val_mean": float(pv.mean()), "port_val_std": float(pv.std()),
        "jax_test_mean": float(jt.mean()), "port_test_mean": float(pt.mean()),
        "paired_val_delta_median": float(np.median(d)),
        "paired_val_delta_mean": float(d.mean()),
        "primary_criterion_pass": bool(abs(np.median(d)) <= CRITERION),
        "sign_test_p": p, "n_pos": npos, "n_neg": nneg,
        "median_ci95": [float(np.percentile(meds, 2.5)),
                        float(np.percentile(meds, 97.5))],
        **({"ssl_split_match_n": len([r for r in rows if "ssl_split_match" in r]),
            "ssl_split_match_all": all(r["ssl_split_match"] for r in rows)}
           if any("ssl_split_match" in r for r in rows) else {}),
    }


def write_report(results: dict, args) -> None:
    with open(osp.join(REPO, "TORCH_PARITY.json"), "w") as f:
        json.dump(results, f, indent=2)
    lines = [
        "# TORCH_PARITY: trained accuracy of the PyTorch port against the JAX package",
        "",
        "Written by `python scripts/run_torch_parity.py`. Both packages train on "
        "`scripts/run_parity.py`'s synthetic dataset (160 patients, 128-d "
        f"features, {args.folds} folds) with the arm configs of `run_parity.py` "
        "built from `config/cfg_nlst.yaml`, on the CPU in f32, "
        f"{args.epochs} max epochs with early stopping on the validation loss. "
        "JAX: `main.py`, `ADVMIL_FORCE_CPU=1`, `rng_impl: threefry`. Port: "
        "`python -m advmil_tpu_torch.main`, `device: cpu`. Initial weights, "
        "dropout masks, noise and the shuffle come from each package's own "
        "generators, so the comparison is over folds x seeds. The seconds "
        f"are each run's wall time on the CPU, {args.procs} runs at a time "
        "(not device metrics).",
        "",
        f"Pre-registered criterion (PARITY.md's): |paired median delta val "
        f"C-index (port - JAX)| <= {CRITERION}.",
        "",
        "| arm | n | paired median delta val | primary | sign test p (+/-) "
        "| bootstrap 95% CI | val mean JAX / port | test mean JAX / port |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for arm, r in results.items():
        if "n_runs" not in r:
            lines.append(f"| {arm} | 0 | - | not run | - | - | - | - |")
            continue
        lo, hi = r["median_ci95"]
        lines.append(
            f"| {arm} | {r['n_runs']} | {r['paired_val_delta_median']:+.4f} | "
            f"{'pass' if r['primary_criterion_pass'] else 'FAIL'} | "
            f"{r['sign_test_p']:.2f} ({r['n_pos']}/{r['n_neg']}) | "
            f"[{lo:+.4f}, {hi:+.4f}] | {r['jax_val_mean']:.4f} / "
            f"{r['port_val_mean']:.4f} | {r['jax_test_mean']:.4f} / "
            f"{r['port_test_mean']:.4f} |")
    for arm, r in results.items():
        if "ssl_split_match_n" in r:
            lines += ["", f"{arm}: the labelled patients are the same on both sides in "
                      f"{sum(row['ssl_split_match'] for row in r['rows'])} of "
                      f"{r['ssl_split_match_n']} pairs (`PARITY_SSL_LABELED_JSON`)."]
    for arm, r in results.items():
        picked = r.get("jax_from_port_init")
        if not picked:
            continue
        d_own = np.mean([p["jax_val"] - p["port_val"] for p in picked])
        d_init = np.mean([p["jax_from_port_init_val"] - p["port_val"] for p in picked])
        lines += ["", f"{arm}: the JAX side run from the port's initial weights "
                  f"(`scripts/_jax_from_port_init.py`) on "
                  + (f"all {len(picked)} pairs" if len(picked) == r.get("n_runs") else
                     f"the {len(picked)} pairs where the port fell furthest below JAX")
                  + f". Mean val C-index gap to the port: JAX from "
                  f"its own init {d_own:+.4f}, JAX from the port's init {d_init:+.4f}.", "",
                  *([f"Port against JAX from the port's init over these {r['jax_from_port_init_summary']['n']} "
                     f"pairs: paired median delta val "
                     f"{r['jax_from_port_init_summary']['paired_val_delta_median']:+.4f}, sign test "
                     f"p = {r['jax_from_port_init_summary']['sign_test_p']:.2f} "
                     f"({r['jax_from_port_init_summary']['n_pos']}/"
                     f"{r['jax_from_port_init_summary']['n_neg']}), bootstrap 95% CI "
                     f"[{r['jax_from_port_init_summary']['median_ci95'][0]:+.4f}, "
                     f"{r['jax_from_port_init_summary']['median_ci95'][1]:+.4f}].", ""]
                    if "jax_from_port_init_summary" in r else []),
                  "| fold | seed | JAX val | port val | JAX from port init val |",
                  "|---|---|---|---|---|"]
        lines += [f"| {p['fold']} | {p['seed']} | {p['jax_val']:.4f} | {p['port_val']:.4f} | "
                  f"{p['jax_from_port_init_val']:.4f} |" for p in picked]
    for arm, r in results.items():
        lines += ["", f"## {arm}", ""]
        if r.get("unfinished"):
            lines += ["Unfinished (fold, seed, missing side): "
                      + ", ".join(f"({f}, {s}, {side})" for f, s, side in r["unfinished"]),
                      ""]
        lines += ["| fold | seed | JAX val | port val | JAX test | port test "
                  "| JAX CPU wall s | port CPU wall s |", "|---|---|---|---|---|---|---|---|"]
        for row in r["rows"]:
            lines.append(
                f"| {row['fold']} | {row['seed']} | {row['jax_val']:.4f} | "
                f"{row['port_val']:.4f} | {row['jax_test']:.4f} | "
                f"{row['port_test']:.4f} | {row['jax_seconds']:.1f} | "
                f"{row['port_seconds']:.1f} |")
    with open(osp.join(REPO, "TORCH_PARITY.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=osp.join(tempfile.gettempdir(), "torch_parity"))
    ap.add_argument("--arms", nargs="+", default=list(ARMS), choices=list(ARMS))
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--seeds", nargs="+", default=["42-51"],
                    help="seeds, or inclusive ranges such as 52-71")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--procs", type=int, default=4, help="runs at a time")
    ap.add_argument("--threads", type=int, default=2,
                    help="OMP threads of each port process")
    ap.add_argument("--sides", nargs="+", default=["jax", "port"],
                    choices=["jax", "port"])
    ap.add_argument("--report-only", action="store_true",
                    help="summarize the cached runs; launch nothing")
    ap.add_argument("--jax-from-port-init", type=int, default=0, metavar="N",
                    help="run JAX from the port's initial weights for the N pairs "
                         "with the largest negative gap of each named arm")
    args = ap.parse_args()
    args.seeds = parse_seeds(args.seeds)
    record = {}
    if osp.exists(RECORD):
        with open(RECORD) as f:
            record = json.load(f)
    recorded = {arm: {(row["fold"], row["seed"]): row for row in r.get("rows", [])}
                for arm, r in record.items()}

    os.makedirs(args.workdir, exist_ok=True)
    paths = run_parity.build_dataset(args.workdir, args.folds)
    if "adv_graph_grid" in args.arms:
        paths["path_tissue_graph"] = write_tissue_graphs(paths)
    jobs = []
    for arm in args.arms:
        for fold in range(args.folds):
            for seed in args.seeds:
                if (fold, seed) in recorded.get(arm, {}):
                    continue
                for side in args.sides:
                    run_dir = osp.join(args.workdir, arm, f"fold{fold}s{seed}", side)
                    cfg = side_cfg(arm, side, paths, fold, seed, run_dir, args.epochs)
                    jobs.append((arm, side, cfg, run_dir))

    def one(job):
        arm, side, cfg, run_dir = job
        try:
            res = run_side(arm, side, cfg, run_dir, args.threads)
        except RuntimeError as err:
            print(f"[torch-parity] FAILED {err}", flush=True)
            return
        print(f"[torch-parity] {arm} {side} {osp.basename(osp.dirname(run_dir))}: "
              f"val={res['val']:.4f} test={res['test']:.4f} ({res['seconds']:.0f}s)",
              flush=True)

    if not args.report_only:
        with ThreadPoolExecutor(args.procs) as pool:
            list(pool.map(one, jobs))

    def largest_gaps(rows):
        return sorted(rows, key=lambda r: r["port_val"] - r["jax_val"])[:args.jax_from_port_init]

    def init_dir(arm, row):
        return osp.join(args.workdir, arm, f"fold{row['fold']}s{row['seed']}", "jax_port_init")

    def pooled_rows(arm):
        """The recorded rows and the cached new pairs of `arm`."""
        rows = list(recorded.get(arm, {}).values())
        for fold in range(args.folds):
            for seed in args.seeds:
                got = [osp.join(args.workdir, arm, f"fold{fold}s{seed}", s, "result.json")
                       for s in ("jax", "port")]
                if (fold, seed) not in recorded.get(arm, {}) and all(map(osp.exists, got)):
                    res = [json.load(open(p)) for p in got]
                    rows.append({"fold": fold, "seed": seed, "jax_val": res[0]["val"],
                                 "port_val": res[1]["val"]})
        return rows

    init_jobs = []
    if args.jax_from_port_init:
        for arm in args.arms:
            if ARMS[arm][0] != "adv" or arm == "adv_ssl":
                raise SystemExit(f"--jax-from-port-init runs exec of the adversarial "
                                 f"handler; {arm} is not such an arm")
            for row in largest_gaps(pooled_rows(arm)):
                cfg = side_cfg(arm, "jax", paths, row["fold"], row["seed"],
                               init_dir(arm, row), args.epochs)
                init_jobs.append((arm, "jax_port_init", cfg, init_dir(arm, row)))
        if not args.report_only:
            with ThreadPoolExecutor(args.procs) as pool:
                list(pool.map(one, init_jobs))

    results = {}
    for arm in list(record) + [a for a in args.arms if a not in record]:
        if arm not in args.arms:
            results[arm] = record[arm]
            continue
        rows = list(recorded.get(arm, {}).values())
        unfinished = []
        for fold in range(args.folds):
            for seed in args.seeds:
                if (fold, seed) in recorded.get(arm, {}):
                    continue
                got = {}
                for side in ("jax", "port"):
                    p = osp.join(args.workdir, arm, f"fold{fold}s{seed}", side,
                                 "result.json")
                    if osp.exists(p):
                        with open(p) as f:
                            got[side] = json.load(f)
                    else:
                        unfinished.append((fold, seed, side))
                if len(got) == 2:
                    row = {"fold": fold, "seed": seed,
                           **{f"{s}_{k}": got[s][k] for s in got
                              for k in ("val", "test", "seconds")}}
                    if "labeled" in got["jax"] or "labeled" in got["port"]:
                        row["ssl_split_match"] = (got["jax"].get("labeled")
                                                  == got["port"].get("labeled"))
                    rows.append(row)
        rows.sort(key=lambda row: (row["fold"], row["seed"]))
        results[arm] = {**(summarize(rows) if rows else {}), "rows": rows,
                        "unfinished": unfinished}
        if args.jax_from_port_init:
            picked = []
            for row in largest_gaps(rows):
                p = osp.join(init_dir(arm, row), "result.json")
                if osp.exists(p):
                    with open(p) as f:
                        res = json.load(f)
                    picked.append({"fold": row["fold"], "seed": row["seed"],
                                   "jax_val": row["jax_val"], "port_val": row["port_val"],
                                   "jax_from_port_init_val": res["val"],
                                   "jax_from_port_init_test": res["test"]})
            results[arm]["jax_from_port_init"] = picked
            if len(picked) >= 10:
                d = np.array([q["port_val"] - q["jax_from_port_init_val"] for q in picked])
                p_sign, npos, nneg = sign_test_p(d)
                meds = np.median(np.random.default_rng(0).choice(d, size=(10000, len(d))),
                                 axis=1)
                results[arm]["jax_from_port_init_summary"] = {
                    "n": len(d), "paired_val_delta_median": float(np.median(d)),
                    "paired_val_delta_mean": float(d.mean()),
                    "within_criterion": bool(abs(np.median(d)) <= CRITERION),
                    "sign_test_p": p_sign, "n_pos": npos, "n_neg": nneg,
                    "median_ci95": [float(np.percentile(meds, 2.5)),
                                    float(np.percentile(meds, 97.5))]}
        else:
            for key in ("jax_from_port_init", "jax_from_port_init_summary"):
                if key in record.get(arm, {}):
                    results[arm][key] = record[arm][key]
    write_report(results, args)
    print("[torch-parity] wrote TORCH_PARITY.md / TORCH_PARITY.json")
    bad = [(arm, row["fold"], row["seed"]) for arm, r in results.items()
           for row in r["rows"] if row.get("ssl_split_match") is False]
    if bad:
        raise SystemExit(f"[torch-parity] the two sides labelled different patients in "
                         f"(arm, fold, seed) {bad}")


if __name__ == "__main__":
    main()
