#!/usr/bin/env python3
"""How often the first call of a vector-math function in a fresh process,
split over CPU threads, comes back inaccurate (CPU only; no card needed).

    python3 scripts/probe_vml_first_call.py [--fns exp,log,tanh,sqrt,sin,cos,knn_agg]
                                            [--warm none,exp,pkg] [--procs 200]
                                            [--jobs 8] [--repo DIR]

On the CPU torch runs exp, log, tanh, sqrt, sin and cos through MKL's vector
math library, in pieces of 2,048 values over OpenMP threads. Each trial is a
fresh Python process whose first call of the function takes 16,384 float32
values (8 pieces) and prints the largest relative error against numpy in
float64. `--warm` says what the process does before that call: nothing
(`none`), one `torch.exp` of one value, on one thread (`exp`), or `import
advmil_tpu_torch` from `--repo` (`pkg`, the package's own set-up; `--repo`
may name another checkout, e.g. a parent commit's). `knn_agg`: the port's
plain kNN aggregation (`ops/segment.py`) on the inputs of the [37-9-24] case
of tests/test_torch_graph.py as the process's first op, its largest absolute
error against float64 (always after the package's import: the op lives
there). Trials run `--jobs` at a time; one counts as inaccurate above 1e-5.
One JSON line per (function, warm-up) on stdout.
"""
import argparse
import json
import os.path as osp
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
BAD = 1e-5

CHILD = r'''
import sys
import numpy as np
import torch
fn, warm, repo = sys.argv[1:4]
if warm == "exp":
    torch.exp(torch.zeros(1))
elif warm == "pkg" or fn == "knn_agg":
    sys.path.insert(0, repo)
    import advmil_tpu_torch  # noqa: F401
if fn == "knn_agg":
    from advmil_tpu_torch.ops import segment
    N, epn, C = 37, 9, 24
    rng = np.random.default_rng(N + epn)
    msg = rng.normal(size=(N, epn, C)).astype(np.float32)
    em = (rng.random((N, epn)) < 0.7).astype(np.float32)
    em[[0, 5]] = 0.0
    t = np.float32(1.3)
    out = segment.knn_edge_softmax_aggregate(torch.tensor(msg), torch.tensor(em),
                                             torch.tensor([t]))
    m64, live = msg.astype(np.float64), em[..., None] > 0
    logit = np.where(live, m64 * np.float64(t), -np.inf)
    top = logit.max(1, keepdims=True)
    top[~np.isfinite(top)] = 0
    e = np.where(live, np.exp(logit - top), 0)
    ref = (e / np.maximum(e.sum(1, keepdims=True), 1e-16) * m64).sum(1)
    print(float(np.abs(out.numpy() - ref).max()))
else:
    lo, hi = {"exp": (-8, 0), "log": (1.5, 100), "tanh": (0.1, 3), "sin": (0.1, 1.4),
              "cos": (0.1, 1.4), "sqrt": (0.5, 100)}[fn]
    x = torch.from_numpy(np.linspace(lo, hi, 16384, dtype=np.float32))
    y = getattr(torch, fn)(x)
    ref = getattr(np, fn)(x.double().numpy())
    print(float(np.max(np.abs(y.double().numpy() - ref) / np.abs(ref))))
'''


def trial(fn, warm, repo):
    out = subprocess.run([sys.executable, "-c", CHILD, fn, warm, repo], capture_output=True,
                         text=True, check=True)
    return float(out.stdout.split()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fns", default="exp,log,tanh,sqrt,sin,cos")
    ap.add_argument("--warm", default="none,exp,pkg")
    ap.add_argument("--procs", type=int, default=200)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--repo", default=ROOT, help="the checkout `pkg` imports the package from")
    args = ap.parse_args()
    for fn in args.fns.split(","):
        for warm in args.warm.split(","):
            errs = []
            with ThreadPoolExecutor(args.jobs) as pool:
                for start in range(0, args.procs, args.jobs):   # a batch of fresh processes
                    n = min(args.jobs, args.procs - start)
                    errs += list(pool.map(lambda _: trial(fn, warm, args.repo), range(n)))
            print(json.dumps(dict(fn=fn, warm=warm, procs=len(errs),
                                  inaccurate=sum(e > BAD for e in errs), max_err=max(errs),
                                  median_err=sorted(errs)[len(errs) // 2])), flush=True)


if __name__ == "__main__":
    main()
