"""One run of one cell: the spec from BENCHMARK.json and the files it names,
the cohort and the weights from the seed, the port's handler, the warm-up
(which records the steps the reference replays), the measured window, the
traced window and the comparison that decides `correct`.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name: `configs/` (as BENCHMARK.json names
it), `traffic/<traffic>.json`, `limits/<cell>.json` (the limits of the
compared numbers) and `metrics/<metric>.py` (a `read(ctx)` that returns a
number, or None where it finds nothing to read).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os.path as osp
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import check, cohort as cohort_mod, probe as probe_mod, trace as trace_mod

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TRACE_STEPS = {"train": 48, "eval": None}   # the traced window: steps of a pass (None: all)
FORBIDDEN = ("jax", "jaxlib", "flax", "advmil_tpu")


@dataclass
class Spec:
    name: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def kind(self) -> str:
        return "train" if self.traffic["entry"] == "train_epoch" else "eval"


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(workload: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Spec:
    bench = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return Spec(
        name=workload, cell=cell,
        config=json.loads((bench_file.parent / conf["file"]).read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((BENCH / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# weights and the port's objects
# ---------------------------------------------------------------------------

def make_weights(model: torch.nn.Module, seed: int, device) -> dict:
    """Every parameter from one uniform draw on the device: a matrix
    U(+-sqrt(6 / (fan_in + fan_out))), its bias U(+-1 / sqrt(fan_in)), a norm's
    scale 1 and shift 0, a scalar 1. Loaded into `model`; returns the dict."""
    named = dict(model.named_parameters())
    total = sum(p.numel() for p in named.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for k, p in named.items():
        v = u[off:off + p.numel()].reshape(p.shape)
        off += p.numel()
        mod, _, leaf = k.rpartition(".")
        w = named.get(mod + ".weight")
        if p.dim() >= 2:
            fan_out, fan_in = p.shape[0], p[0].numel()
            v = v * math.sqrt(6.0 / (fan_in + fan_out))
        elif leaf == "bias" and w is not None and w.dim() >= 2:
            v = v / math.sqrt(w[0].numel())
        elif leaf == "bias":
            v = torch.zeros_like(v)
        else:
            v = torch.ones_like(v)
        out[k] = v.contiguous()
    model.load_state_dict(out, strict=True)
    return {k: v.clone() for k, v in out.items()}


def program_config(spec: Spec, seed: int, coh, run_dir: str, device) -> dict:
    from advmil_tpu_torch.config import with_defaults
    cfg = with_defaults(dict(spec.config["config"]))
    cfg.update(seed=int(seed) % (1 << 31), device=device.type,
               save_path=osp.join(run_dir, "run"), path_patch=run_dir,
               path_label=coh.label_path)
    return cfg


def build(spec: Spec, seed: int, run_dir: str, device):
    """(handler, dataset, batcher, probe, cohort, weights, cfg)."""
    from advmil_tpu_torch.data.bags import prepare_dataset
    from advmil_tpu_torch.train.handler import AdvHandler
    dim = int(spec.config["config"]["bcb_dims"].split("-")[0])
    coh = cohort_mod.make_cohort(spec.traffic, seed, dim, run_dir, device)
    cfg = program_config(spec, seed, coh, run_dir, device)
    handler = AdvHandler(cfg)
    weights = (make_weights(handler.gen_model, seed, device),
               make_weights(handler.disc_model, seed + 1, device))
    ds = prepare_dataset(coh.pids, cfg, rng=handler.np_rng)
    if ds.pids != coh.pids:
        raise RuntimeError("the dataset's patients are not the cohort's")
    sizes = {pid: int(n) for pid, n in zip(coh.pids, coh.sizes)}
    ds.bag_size = lambda i: sizes[ds.pids[i]]
    for i, pid in enumerate(ds.pids):       # the cache the first epoch would fill
        ds._cache[i] = {"index": i, "pid": pid, "feats": coh.feats[i],
                        "label": np.asarray(ds.pid2label[pid], np.float32)}
    batcher = handler._make_bucket_batcher(ds)
    kind = spec.kind
    flash = cfg["flash_min_len"] if cfg["use_pallas"] and cfg["bcb_mode"] == "patch" else None
    probe = probe_mod.Probe(handler,
                            record_steps=int(spec.traffic.get("check_steps", 0)) if kind == "train" else 0,
                            record_eval_pass=kind == "eval", flash_regions=flash)
    return SimpleNamespace(handler=handler, ds=ds, batcher=batcher, probe=probe, cohort=coh,
                           weights=weights, cfg=cfg)


def one_pass(spec: Spec, st) -> None:
    """One epoch (training cells) or one evaluation pass; each ends in the
    program's own sync."""
    if spec.kind == "train":
        st.handler._train_each_epoch((st.ds, st.batcher))
    else:
        st.handler._run_eval(st.ds, st.batcher, n_samples=int(spec.traffic["n_samples"]))


def timed_passes(spec: Spec, st, seconds: float):
    """Whole passes until `seconds` have gone by: (passes, wall seconds,
    window statistics)."""
    with probe_mod.window(st.probe, False) as pr:
        t0 = time.perf_counter()
        n = 0
        while True:
            one_pass(spec, st)
            n += 1
            wall = time.perf_counter() - t0
            if wall >= seconds:
                break
    return n, wall, pr


def _stats(pr) -> SimpleNamespace:
    return SimpleNamespace(n_steps=pr.n_steps, n_bags=pr.n_bags, real_tokens=pr.real_tokens,
                           padded_tokens=pr.padded_tokens, ship_s=pr.ship_s,
                           step_s=pr.step_s, shapes=list(pr.shapes))


def traced_window(spec: Spec, st, run_dir: str):
    """The profiled window: the first `TRACE_STEPS` steps of one more pass
    (the whole pass for None), ended by a device sync; the pass then runs
    to its end untraced and uncounted."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if st.handler.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    limit = TRACE_STEPS[spec.kind]
    span = {}

    def stop():
        if "t1" not in span:
            if st.handler.device.type == "cuda":
                torch.cuda.synchronize(st.handler.device)
            span["t1"] = time.perf_counter()
            prof.stop()
            st.probe.counting = st.probe.timing = False

    def after_step(n):
        if limit is not None and n >= limit:
            stop()

    st.probe.after_step = after_step
    with probe_mod.window(st.probe, True) as pr:
        prof.start()
        span["t0"] = time.perf_counter()
        one_pass(spec, st)
        stop()
    st.probe.after_step = None
    wall = span["t1"] - span["t0"]
    path = osp.join(run_dir, "trace.json")
    prof.export_chrome_trace(path)
    return trace_mod.reduce_trace(path, wall), wall, _stats(pr)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def observables(spec: Spec, rec, device, mm=None):
    """(got, want, initial parameters) of a run: the program's observables
    (or, with `mm`, the reference's in that precision: the control) and the
    f32 reference's."""
    cfg, coh, probe = rec.cfg, rec.cohort, rec.probe
    p0 = tuple({k: v.float().cpu() for k, v in w.items()} for w in rec.weights)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if spec.kind == "train":
        want = check.replay_train(probe.records, coh, cfg, p0, device)
        got = (check.replay_train(probe.records, coh, cfg, p0, device, mm) if mm is not None
               else check.observe_program(probe))
    else:
        want = check.replay_eval(probe.records, coh, cfg, p0, device)
        got = (check.replay_eval(probe.records, coh, cfg, p0, device, mm) if mm is not None
               else check.observe_program_eval(probe))
    return got, want, p0


def check_numbers(spec: Spec, rec, device, mm=None) -> dict:
    """The compared numbers of a run (or of the control, `mm`: the reference
    in that precision put in the program's place)."""
    got, want, p0 = observables(spec, rec, device, mm)
    if spec.kind == "train":
        return check.compare_train(got, want, p0)
    return check.compare_eval(got, want, len(rec.cohort.pids))


def card_line() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                              "clocks.max.sm,power.draw", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def host_line() -> str:
    """The process's CPU seconds so far (a window's cores and CPU seconds a
    bag come from two of these)."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return f"user {ru.ru_utime:.1f} s sys {ru.ru_stime:.1f} s"


def run_cell(spec: Spec, seed: int, seconds: float, traced: bool, device,
             t_start: float, run_dir: str, faults=None, log=print) -> dict:
    """One run; returns the result object of the contract's last line."""
    st = build(spec, seed, run_dir, device)
    if faults:
        for name, make in faults.items():
            st.probe.faults[name] = make(st)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    one_pass(spec, st)                     # warm; records the checked steps / pass
    while st.probe.recording:
        one_pass(spec, st)
    if spec.kind == "eval":
        st.probe.record_eval = False
        one_pass(spec, st)
    setup_s = time.perf_counter() - t_start

    log(f"[bench] set-up {setup_s:.3f} s; {len(st.probe.records)} steps recorded for the "
        f"check ({sum(1 for r in st.probe.records if r.get('flash'))} flash in training); "
        "host " + host_line())
    passes, wall, pr = timed_passes(spec, st, seconds)
    window = _stats(pr)
    rate = window.n_bags / wall
    timings = st.handler.train_timings if spec.kind == "train" else st.handler.eval_timings
    log(f"[bench] {spec.name}: {passes} passes, {window.n_bags} bags, {window.n_steps} steps "
        f"in {wall:.3f} s: {rate:.4f} bags/s; setup {setup_s:.3f} s; seconds a pass "
        + " ".join(f"{s:.3f}" for _, s in timings[-passes:]) + "; host " + host_line())
    trace = tstats = None
    if traced:
        trace, twall, tstats = traced_window(spec, st, run_dir)
        log(f"[bench] traced window: {tstats.n_steps} steps, {tstats.n_bags} bags in "
            f"{twall:.3f} s: {tstats.n_bags / twall:.4f} bags/s traced against {rate:.4f} "
            "untraced")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"[bench] peak device memory {peak} bytes; card: {card_line()}")

    kind = spec.kind
    metrics = {}
    if not traced:
        for m in spec.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == f"{kind}_bags_per_s":
                metrics[m["name"]] = {"value": rate, "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(kind=kind, spec=spec, trace=trace, traced=tstats,
                              window=window, window_s=wall, cfg=st.cfg)
        for m in spec.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # free the program's state before the reference runs
    rec = SimpleNamespace(cfg=st.cfg, cohort=st.cohort, weights=st.weights, probe=st.probe)
    rec.probe.h = None
    del st
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = check_numbers(spec, rec, device)
    correct = check.judge(numbers, spec.limits)
    log(f"[bench] reference check {time.perf_counter() - t0:.3f} s; every candidate number "
        + json.dumps(numbers))

    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(window.n_bags), "failed": 0,
              "metrics": metrics, "device": device_info}
    if traced:
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    result["check"] = {k: {"value": numbers[k], "limit": v} for k, v in spec.limits.items()}
    return result
