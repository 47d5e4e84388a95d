"""The readings the limits of `limits/<cell>.json` are set from, on the card:

    python benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--control 3] [--faults 3]

For each seed it builds the cell as a run does, warms it (which records the
checked steps or pass) and prints one JSON line with the program's candidate
numbers (`check.py`); for the first `--control` seeds also the control's
(the reference computed in fp8, put in the program's place: the step below
the configuration's bf16), for the first `--witness` seeds the reference
computed in bf16 (what the configuration's own precision moves), and for the
first `--faults` seeds those of each fault of `faults.py` that the cell can
have. No window is measured. Lines go to standard output and to `--out`.
"""
from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(spec, seed, device, fault=None, control=False, leaves=0,
             witness=False) -> dict:
    import torch
    from benchmark import check, faults as F, harness
    run_dir = tempfile.mkdtemp(prefix="advmil-calib-")
    try:
        st = harness.build(spec, seed, run_dir, device)
        if fault:
            table = F.TRAIN if spec.kind == "train" else F.EVAL
            st.probe.faults[fault] = table[fault](st)
        harness.one_pass(spec, st)
        while st.probe.recording:
            harness.one_pass(spec, st)
        out = {"program": harness.check_numbers(spec, st, device)}
        if leaves and spec.kind == "train":
            got, want, p0 = harness.observables(spec, st, device)
            out["leaves"] = {"grad": [list(r) for r in check.grad_rows(got, want)[:leaves]],
                             "change": [list(r) for r in
                                        check.change_rows(got, want, p0)[:leaves]]}
        if control:
            out["control"] = harness.check_numbers(spec, st, device, mm=torch.float8_e4m3fn)
        if witness:
            # the reference computed in bf16 itself: what the configuration's
            # precision alone moves the numbers by
            out["witness_bf16"] = harness.check_numbers(spec, st, device, mm=torch.bfloat16)
            if leaves and spec.kind == "train":
                got, want, p0 = harness.observables(spec, st, device, mm=torch.bfloat16)
                out["witness_leaves"] = {
                    "grad": [list(r) for r in check.grad_rows(got, want)[:leaves]],
                    "change": [list(r) for r in check.change_rows(got, want, p0)[:leaves]]}
        st.handler = st.probe.h = None
        return out
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--leaves", type=int, default=0,
                    help="also print the worst leaves of grad_gap and change_gap")
    ap.add_argument("--witness", type=int, default=0,
                    help="for the first seeds, the reference in bf16 against the f32 one")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from benchmark import faults as F, harness
    if not torch.cuda.is_available():
        print("[calibrate] needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = harness.load_spec(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    names = list((F.TRAIN if spec.kind == "train" else F.EVAL))
    try:
        for i, seed in enumerate(seeds):
            t0 = time.perf_counter()
            r = readings(spec, seed, device, control=i < args.control, leaves=args.leaves,
                         witness=i < args.witness)
            lines = [{"seed": seed, "kind": k, "numbers": v} for k, v in r.items()]
            if i < args.faults:
                for name in names:
                    if name == "frozen_state":
                        continue       # reads 1 on change_gap by construction
                    lines.append({"seed": seed, "kind": "fault_" + name,
                                  "numbers": readings(spec, seed, device, fault=name)["program"]})
            for line in lines:
                line.update(workload=spec.name, seconds=time.perf_counter() - t0)
                print(json.dumps(line), flush=True)
                if sink:
                    sink.write(json.dumps(line) + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
