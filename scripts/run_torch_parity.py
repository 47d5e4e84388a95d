"""Paired accuracy check of the PyTorch port against the JAX package.

Both packages train on the same synthetic dataset and split files
(`scripts/run_parity.py::build_dataset`: 160 patients, 128-d `.pt`
features, a planted survival signal) with the same arm configs
(`run_parity.adv_cfg` / `reg_cfg`, built from this repo's
`config/cfg_nlst.yaml`), on the CPU in f32:

- JAX side: `python main.py` with `ADVMIL_FORCE_CPU=1`, `rng_impl: threefry`
  and `run_parity.ours_extra`'s batching;
- port side: `python -m advmil_tpu_torch.main` with `device: cpu` and the
  same batching.

Dropout masks, noise and initial weights come from each framework's own
generators, so single runs differ; the claim is statistical over folds x
seeds. The pre-registered criterion is PARITY.md's: |paired median delta
val C-index (port - JAX)| <= 0.005, reported with the two-sided sign test
and a bootstrap 95% CI of the paired median.

Every finished run is cached as `<workdir>/<arm>/fold<f>s<seed>/<side>/
result.json` and reused, so an interrupted sweep resumes where it stopped;
`--sides jax` (or `port`) runs one side only. Pairs with a side missing are
listed as unfinished in the report.

Usage:
  python scripts/run_torch_parity.py --workdir DIR [--arms adv_esat base_reg_abmil]
      [--folds 5] [--seeds 42 ... 51] [--procs 4] [--sides jax port]
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

ARMS = {"adv_esat": ("adv", run_parity.adv_cfg),
        "base_reg_abmil": ("base", run_parity.reg_cfg)}
CRITERION = 0.005


def side_cfg(arm: str, side: str, paths: dict, fold: int, seed: int,
             run_dir: str, epochs: int) -> dict:
    _, builder = ARMS[arm]
    cfg = run_parity.ours_extra(builder(paths, fold, run_dir, epochs))
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
    else:
        cmd = [sys.executable, "-m", "advmil_tpu_torch.main"]
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    cmd += ["--config", cfg_path, "--handler", handler]
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
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(42, 52)))
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--procs", type=int, default=4, help="runs at a time")
    ap.add_argument("--threads", type=int, default=2,
                    help="OMP threads of each port process")
    ap.add_argument("--sides", nargs="+", default=["jax", "port"],
                    choices=["jax", "port"])
    ap.add_argument("--report-only", action="store_true",
                    help="summarize the cached runs; launch nothing")
    args = ap.parse_args()

    os.makedirs(args.workdir, exist_ok=True)
    paths = run_parity.build_dataset(args.workdir, args.folds)
    jobs = []
    for arm in args.arms:
        for fold in range(args.folds):
            for seed in args.seeds:
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

    results = {}
    for arm in args.arms:
        rows, unfinished = [], []
        for fold in range(args.folds):
            for seed in args.seeds:
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
                    rows.append({"fold": fold, "seed": seed,
                                 **{f"{s}_{k}": got[s][k] for s in got
                                    for k in ("val", "test", "seconds")}})
        results[arm] = {**(summarize(rows) if rows else {}), "rows": rows,
                        "unfinished": unfinished}
    write_report(results, args)
    print("[torch-parity] wrote TORCH_PARITY.md / TORCH_PARITY.json")


if __name__ == "__main__":
    main()
