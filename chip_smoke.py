#!/usr/bin/env python3
"""Smoke test of advmil_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printed on its own line:
  1. device: refuses to run without CUDA; prints the card, its power limit,
     the torch / CUDA versions; turns TF32 off.
  2. build: compiles advmil_tpu_torch/csrc/*.cu with nvcc.
  3. kernels against their plain PyTorch versions on the card, at the main
     path's shapes, in f32 and bf16, with CUDA-event timings.
  4. the cfg_nlst test-mode slice at full width through
     `advmil_tpu_torch.main` (synthetic data, seeded random weights written as
     checkpoints), then the 30-sample pass; the kernels' launch counters are
     reset just before and read just after.
  5. one batch of the slice in f32 on the card (kernels) against the same
     batch and weights on the CPU (plain versions).
The last lines are the kernels JSON, the card line and the result JSON.
Any failure raises and exits non-zero.
"""
import json
import math
import os
import os.path as osp
import shutil
import statistics
import subprocess
import sys
import time

ROOT = osp.dirname(osp.abspath(__file__))
OUT_DIR = osp.join(ROOT, "chiprun_out")
WORK_DIR = osp.join(ROOT, "results-chip-smoke")


def log(msg):
    print(msg, flush=True)


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def timed_pair(kernel_fn, plain_fn, reps=10):
    """Median ms of each, timed with CUDA events in turns plain, kernel,
    kernel, plain after a warm-up."""
    import torch

    def run(fn):
        out = []
        for _ in range(reps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e))
        return out

    for fn in (kernel_fn, plain_fn, kernel_fn, plain_fn):
        fn()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = run(plain_fn), run(kernel_fn), run(kernel_fn), run(plain_fn)
    return statistics.median(k1 + k2), statistics.median(p1 + p2)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke.py "
                           "runs only on a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] {card} | torch {torch.__version__} | CUDA {torch.version.cuda} "
        f"| devices {torch.cuda.device_count()} | tf32 off")
    return card


def phase_build():
    from advmil_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(osp.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(_build.build_info.get("log", ""))
    regs = [ln.strip() for ln in _build.build_info.get("log", "").splitlines()
            if "registers" in ln or "spill" in ln]
    log(f"[2 build] {osp.basename(_build.build_info['path'])} in {secs:.1f} s "
        f"(nvcc {_build.build_info['seconds']:.1f} s); ptxas lines: {len(regs)}")
    return secs


def phase_kernels(card):
    import torch
    from advmil_tpu_torch.ops import attention as attn
    from advmil_tpu_torch.ops import ln_pool
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    report = {}

    # LN-pool at one batch_token_budget batch: M = 32768 patches
    worst = 0.0
    for D in (384, 128):
        h32 = torch.randn(32768, D, device=dev, generator=g)
        scale = 1.0 + 0.1 * torch.randn(D, device=dev, generator=g)
        bias = 0.1 * torch.randn(D, device=dev, generator=g)
        for dtype, atol, rtol in ((torch.float32, 1e-5, 0.0), (torch.bfloat16, 2e-2, 2e-2)):
            h = h32.to(dtype)
            got = ln_pool.ln_relu_region_mean(h, scale, bias)
            want = ln_pool.ln_relu_region_mean_plain(h, scale, bias)
            torch.cuda.synchronize()
            err = max_abs(got, want)
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
            k_ms, p_ms = timed_pair(lambda: ln_pool.ln_relu_region_mean(h, scale, bias),
                                    lambda: ln_pool.ln_relu_region_mean_plain(h, scale, bias))
            gbs = (h.numel() * h.element_size() + got.numel() * got.element_size()) / k_ms / 1e6
            log(f"[3 kernel] ln_relu_region_mean M=32768 D={D} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e} (atol {atol}, rtol {rtol}) | kernel "
                f"{k_ms:.4f} ms ({gbs:.0f} GB/s) | plain {p_ms:.4f} ms | {card}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
                if D == 384:
                    report["ln_relu_region_mean"] = dict(ms=k_ms, plain_ms=p_ms)
    report["ln_relu_region_mean"]["max_abs_err"] = worst

    # flash forward: B=1 ragged bag (last 300 keys masked) + 1 fully masked bag
    L, H, Dh = 2048, 8, 48
    q32, k32, v32 = (torch.randn(2, L, H, Dh, device=dev, generator=g) for _ in range(3))
    mask = torch.ones(2, L, device=dev)
    mask[0, L - 300:] = 0.0
    mask[1] = 0.0
    worst = 0.0
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        got, lse = attn.flash_attention_fwd(q, k, v, mask)
        want = attn.masked_attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        err = max_abs(got, want)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0.0)
        if not bool((got[1] == 0).all()):
            raise AssertionError("flash: the fully masked bag is not exactly 0")
        if not bool(torch.isfinite(lse[:H]).all()):
            raise AssertionError("flash: non-finite lse on the ragged bag")
        q1, k1, v1, m1 = q[:1], k[:1], v[:1], mask[:1]
        k_ms, p_ms = timed_pair(lambda: attn.flash_attention_fwd(q1, k1, v1, m1),
                                lambda: attn.masked_attention_reference(q1, k1, v1, m1))
        tflops = 4 * L * L * H * Dh / k_ms / 1e9
        log(f"[3 kernel] masked_flash_attention B=1 L={L} H={H} Dh={Dh} "
            f"{str(dtype)[6:]}: max_abs_err {err:.3e} (atol {atol}); fully masked "
            f"bag exactly 0 | kernel {k_ms:.4f} ms ({tflops:.2f} TFLOP/s) | plain "
            f"{p_ms:.4f} ms | {card}")
        if dtype == torch.bfloat16:
            worst = err
            report["masked_flash_attention"] = dict(ms=k_ms, plain_ms=p_ms)
    report["masked_flash_attention"]["max_abs_err"] = worst
    return report


def _write_yaml(path, cfg):
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k}: {'null' if v is None else v}\n")


def phase_slice():
    import numpy as np
    import torch
    from advmil_tpu_torch import main as port_main
    from advmil_tpu_torch.config import read_yaml, with_defaults
    from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
    from advmil_tpu_torch.ops import attention as attn
    from advmil_tpu_torch.ops import ln_pool
    from advmil_tpu_torch.train.handler import AdvHandler

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    counts = np.random.default_rng(7).integers(64, 257, size=36)
    counts[0] = 2048                      # 32,768 patches: engages flash
    paths = make_synthetic_dataset(osp.join(WORK_DIR, "data"), dim=1024, seed=7,
                                   feat_format="pt", region_counts=list(counts),
                                   test_pids=[f"P{i:04d}" for i in range(7)])
    log(f"[4 slice] synthetic cfg_nlst-width data: 36 patients, 1024-d, regions "
        f"{int(counts[1:].min())}-{int(counts[1:].max())} + one test bag of 2048 "
        f"({time.perf_counter() - t0:.1f} s)")

    cfg = read_yaml(osp.join(ROOT, "config", "cfg_nlst.yaml"))
    run = osp.join(WORK_DIR, "run")
    cfg.update(path_patch=paths["path_patch"], path_label=paths["path_label"],
               data_split_path=paths["data_split_path"], data_split_seed=0,
               save_path=run, test_load_path=run,
               test_save_path=osp.join(WORK_DIR, "test_{}-{}"), device="cuda",
               test=True)
    # checkpoints from the port's seeded init, through train/checkpoint.py
    AdvHandler(with_defaults(dict(cfg, test=False))).save_model(0, "best", "train")
    yaml_path = osp.join(WORK_DIR, "cfg_nlst_smoke.yaml")
    _write_yaml(yaml_path, cfg)

    ln_pool.LAUNCHES = 0
    attn.LAUNCHES = 0
    [(handler, metrics)] = port_main.main(["--config", yaml_path, "--handler", "adv"])
    ds, batcher = handler.loaders["exec-test"]
    dist = handler._run_eval(ds, batcher, n_samples=handler.cfg["times_test_sample"],
                             rng_tag=1)
    launches = {"ln_relu_region_mean": ln_pool.LAUNCHES,
                "masked_flash_attention": attn.LAUNCHES}

    ci = dict(metrics["exec-test"])["cindex"]
    if not (isinstance(ci, float) and 0.0 <= ci <= 1.0):
        raise AssertionError(f"C-index {ci!r} is not a float in [0, 1]")
    for key in ("y_hat", "f_fake", "avg_y_hat", "dist_y_hat"):
        if not np.all(np.isfinite(dist[key])):
            raise AssertionError(f"non-finite {key}")
    for key in ("y_hat", "avg_y_hat", "dist_y_hat"):
        if dist[key].min() < 0.0 or dist[key].max() > 1.0:
            raise AssertionError(f"{key} outside [0, 1]")
    if dist["dist_y_hat"].shape != (len(ds), 30, 1):
        raise AssertionError(f"dist shape {dist['dist_y_hat'].shape}")
    csv_path = osp.join(handler.save_dir, "test_mode_best_pred_exec-test.csv")
    with open(csv_path) as f:
        rows = f.read().strip().splitlines()[1:]
    if len(rows) != len(ds):
        raise AssertionError(f"CSV has {len(rows)} rows for {len(ds)} patients")
    preds = np.asarray([float(r.split(",")[-1]) for r in rows])
    if not (np.all(np.isfinite(preds)) and preds.min() >= 0 and preds.max() <= 1):
        raise AssertionError("CSV predictions not finite in [0, 1]")
    shipped = handler._ship(next(iter(batcher.epoch_batches())))
    on_cuda = (shipped["feats"].is_cuda and shipped["feats"].dtype == torch.bfloat16
               and all(p.is_cuda for p in handler.gen_model.parameters())
               and all(p.is_cuda for p in handler.disc_model.parameters()))
    if not on_cuda:
        raise AssertionError("feats / parameters are not on cuda")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    (b1, s1), (b2, s2) = handler.eval_timings[-2:]
    log(f"[4 slice] exec-test C-index {ci:.6f} | CSV {osp.relpath(csv_path, ROOT)} "
        f"with {len(rows)} rows | feats bf16 and params on cuda | launches {launches}")
    log(f"[4 slice] eval bags/s: test-mode pass {b1 / s1:.2f} ({b1} bags, {s1:.3f} s); "
        f"30-sample pass {b2 / s2:.2f} ({b2} bags, {s2:.3f} s)")
    return handler, launches


def phase_gpu_vs_cpu(handler):
    import torch
    from advmil_tpu_torch.train.handler import build_models
    from advmil_tpu_torch.train.steps import make_eval_step

    _, batcher = handler.loaders["exec-test"]
    batch = list(batcher.epoch_batches())[-1]   # the largest bucket (2048 regions)
    cfg32 = dict(handler.cfg, precision="f32")
    outs = {}
    for dev in ("cuda", "cpu"):
        G, D = build_models(cfg32)
        G.load_state_dict(handler.gen_model.state_dict())
        D.load_state_dict(handler.disc_model.state_dict())
        G.to(dev).eval()
        D.to(dev).eval()
        step = make_eval_step(G, D, n_samples=1, zero_noise=True)
        out = step({"feats": torch.from_numpy(batch.feats).to(dev),
                    "mask": torch.from_numpy(batch.mask).to(dev)})
        outs[dev] = {k: v.float().cpu() for k, v in out.items()}
    diff = {k: max_abs(outs["cuda"][k], outs["cpu"][k]) for k in ("y_hat", "f_fake")}
    log(f"[5 gpu-vs-cpu] f32 batch {tuple(batch.feats.shape)}: max |y_hat| diff "
        f"{diff['y_hat']:.3e}, max |f_fake| diff {diff['f_fake']:.3e} (bound 1e-4)")
    for k, d in diff.items():
        if not d <= 1e-4:
            raise AssertionError(f"GPU vs CPU {k} differs by {d}")


def main():
    if not osp.isdir(osp.join(ROOT, "advmil_tpu_torch")):
        raise SystemExit("chip_smoke.py runs from the root of a checkout: "
                         "advmil_tpu_torch/ not found beside it")
    sys.path.insert(0, ROOT)
    card = phase_device()
    phase_build()
    report = phase_kernels(card)
    handler, launches = phase_slice()
    phase_gpu_vs_cpu(handler)
    shutil.rmtree(osp.join(WORK_DIR, "data"), ignore_errors=True)

    import torch
    sources = {"ln_relu_region_mean": ("advmil_tpu_torch/csrc/ln_pool.cu",
                                       "advmil_tpu/ops/ln_pool.py:67"),
               "masked_flash_attention": ("advmil_tpu_torch/csrc/flash_fwd.cu",
                                          "advmil_tpu/ops/attention.py:85")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    assert all(math.isfinite(k["ms"]) for k in kernels)
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
