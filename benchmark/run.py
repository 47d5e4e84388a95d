"""Run one cell of the benchmark of `advmil_tpu_torch` once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA card; without one it exits 2 and prints no result. It makes the
cohort and the weights from `--seed`, warms the cell's shapes, measures
whole epochs (or evaluation passes) for `--seconds`, and with `--trace 1`
traces a further few passes for the per-layer metrics. Then it replays the
recorded steps through the plain reference and prints, as its last lines on
standard error, each compared number beside its limit, and as the last line
of standard output the result object.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    spec = harness.load_spec(args.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run_dir = tempfile.mkdtemp(prefix="advmil-bench-")
    try:
        def log(msg):
            print(msg, file=sys.stderr, flush=True)
        result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), device,
                                  T_START, run_dir, log=log)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    found = harness.forbidden_modules()
    if found:
        print(f"[bench] the process has loaded {found}: the port must run without JAX",
              file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"[check] {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(f"[check] correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
