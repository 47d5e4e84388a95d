#!/usr/bin/env python3
"""Smoke test of advmil_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printed on its own line:
  1. device: refuses to run without CUDA; prints the card, its power limit,
     the torch / CUDA versions; turns TF32 off.
  2. build: compiles advmil_tpu_torch/csrc/*.cu with nvcc (one process per
     source, all at once).
  3. kernels against their plain PyTorch versions on the card, at the main
     path's shapes, in f32 and bf16, with CUDA-event timings: LN-pool forward
     and backward, flash forward (p = 0 and p = 0.25), flash dQ and dK/dV
     (p = 0 and 0.25), the keep-mask kernel (bit for bit) and philox.cuh
     against cuRAND's Philox4x32-10.
  4. training: the cfg_nlst adversarial training at full width through
     `advmil_tpu_torch.main` with `test: False` (synthetic data with two long
     training bags that engage flash with dropout, seeded random init, bf16,
     2 epochs); the kernels' launch counters are reset just before and read
     just after.
  5. test mode: the same entry point with `test: True`, loading the best
     checkpoint of phase 4, then the 30-sample pass; counters reset and read
     around it.
  6. one batch of the test-mode slice in f32 on the card (kernels) against
     the same batch and weights on the CPU (plain versions).
  7. one training step's gradients of G and D in f32 on the card against the
     CPU, dropout off and zero noise, on the long training batch.
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
    report.update(_kernels_training(card, dev, g))
    return report


def _kernels_training(card, dev, g):
    """Phase 3, the training kernels: LN-pool backward, flash forward with
    dropout, flash dQ and dK/dV, the keep mask and philox.cuh."""
    import torch
    from advmil_tpu_torch.ops import attention as attn
    from advmil_tpu_torch.ops import ln_pool
    from advmil_tpu_torch.ops import philox
    report = {}

    # LN-pool backward at M = 32768, D = 384 (G) and 128 (D's netx)
    worst = 0.0
    for D in (384, 128):
        h32 = torch.randn(32768, D, device=dev, generator=g)
        scale = 1.0 + 0.1 * torch.randn(D, device=dev, generator=g)
        bias = 0.1 * torch.randn(D, device=dev, generator=g)
        g32 = torch.randn(2048, D, device=dev, generator=g)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            h, gout = h32.to(dtype), g32.to(dtype)
            got = ln_pool.ln_relu_region_mean_bwd(gout, h, scale, bias)
            leaves = [t.detach().clone().requires_grad_(True) for t in (h, scale, bias)]
            out = ln_pool.ln_relu_region_mean_plain(*leaves)
            plain = lambda: torch.autograd.grad(out, leaves, gout, retain_graph=True)  # noqa: E731
            want = plain()
            torch.cuda.synchronize()
            errs = [max_abs(a, b) for a, b in zip(got, want)]
            torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
            for a, b in zip(got[1:], want[1:]):
                torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-4)
            k_ms, p_ms = timed_pair(lambda: ln_pool.ln_relu_region_mean_bwd(gout, h, scale, bias),
                                    plain)
            gbs = 2 * h.numel() * h.element_size() / k_ms / 1e6
            log(f"[3 kernel] ln_relu_region_mean_bwd M=32768 D={D} {str(dtype)[6:]}: "
                f"max_abs_err dh {errs[0]:.3e} (atol {tol}, rtol {tol}), dscale "
                f"{errs[1]:.3e}, dbias {errs[2]:.3e} (atol 1e-3, rtol 1e-4) | kernel "
                f"{k_ms:.4f} ms ({gbs:.0f} GB/s of h + dh) | plain autograd bwd "
                f"{p_ms:.4f} ms | {card}")
            if dtype == torch.bfloat16:
                worst = max(worst, *errs)
                if D == 384:
                    report["ln_relu_region_mean_bwd"] = dict(ms=k_ms, plain_ms=p_ms)
    report["ln_relu_region_mean_bwd"]["max_abs_err"] = worst

    # flash at the training shape: B=2 L=1024 H=8 Dh=48, one ragged bag and one
    # fully masked bag; forward with p = 0.25, backward with p = 0 and 0.25
    B, L, H, Dh = 2, 1024, 8, 48
    q32, k32, v32, do32 = (torch.randn(B, L, H, Dh, device=dev, generator=g)
                           for _ in range(4))
    mask = torch.ones(B, L, device=dev)
    mask[0, L - 300:] = 0.0
    mask[1] = 0.0
    seed = 0x5EED_0F_D20F0
    scale = 1.0 / Dh ** 0.5
    for p in (0.25, 0.0):
        sd = seed if p else None
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            q, k, v, dout = (t.to(dtype) for t in (q32, k32, v32, do32))
            out, lse = attn.flash_attention_fwd(q, k, v, mask, p, sd)
            ops = attn.flash_bwd_inputs(q, k, v, mask, out, lse, dout)
            dq = attn.flash_bwd_dq(ops, p, sd) * scale
            dk, dv = attn.flash_bwd_dkv(ops, p, sd)
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            ref = attn.masked_attention_reference(*leaves, mask, p, sd)
            plain_bwd = lambda: torch.autograd.grad(ref, leaves, dout, retain_graph=True)  # noqa: E731
            want = plain_bwd()
            torch.cuda.synchronize()
            errs = {}
            for name, a, b in (("out", out, ref), ("dq", dq, want[0]), ("dk", dk, want[1]),
                               ("dv", dv, want[2])):
                errs[name] = max_abs(a, b)
                torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol, msg=name)
                if not bool((a[1] == 0).all()):
                    raise AssertionError(f"flash {name}: fully masked bag not exactly 0")
            dq_ms, plain_ms = timed_pair(lambda: attn.flash_bwd_dq(ops, p, sd), plain_bwd)
            dkv_ms, _ = timed_pair(lambda: attn.flash_bwd_dkv(ops, p, sd), plain_bwd)
            line = (f"[3 kernel] flash B={B} L={L} H={H} Dh={Dh} p={p} {str(dtype)[6:]}: "
                    f"max_abs_err out {errs['out']:.3e} dq {errs['dq']:.3e} dk "
                    f"{errs['dk']:.3e} dv {errs['dv']:.3e} (atol {tol}, rtol {tol}); "
                    f"fully masked bag exactly 0")
            if p:
                f_ms, fp_ms = timed_pair(
                    lambda: attn.flash_attention_fwd(q, k, v, mask, p, sd),
                    lambda: attn.masked_attention_reference(q, k, v, mask, p, sd))
                line += f" | fwd kernel {f_ms:.4f} ms, plain {fp_ms:.4f} ms"
            log(f"{line} | dq kernel {dq_ms:.4f} ms, dk/dv kernel {dkv_ms:.4f} ms, plain "
                f"autograd bwd (dq, dk, dv) {plain_ms:.4f} ms | {card}")
            if dtype == torch.bfloat16 and p:
                report["masked_flash_attention_dropout"] = dict(
                    ms=f_ms, plain_ms=fp_ms, max_abs_err=errs["out"])
                report["flash_bwd_dq"] = dict(ms=dq_ms, plain_ms=plain_ms,
                                              max_abs_err=errs["dq"])
                report["flash_bwd_dkv"] = dict(ms=dkv_ms, plain_ms=plain_ms,
                                               max_abs_err=max(errs["dk"], errs["dv"]))

    # the keep-mask oracle, bit for bit, and philox.cuh against cuRAND
    km = philox.keep_mask(seed, B * H, L, L, 0.25, device=dev)
    kp = philox.keep_mask_plain(seed, B * H, L, L, 0.25, device=dev)
    if not torch.equal(km, kp):
        raise AssertionError(f"keep mask differs from the torch Philox in "
                             f"{int((km != kp).sum())} elements")
    rate = float(km.mean())
    k_ms, p_ms = timed_pair(lambda: philox.keep_mask(seed, B * H, L, L, 0.25, device=dev),
                            lambda: philox.keep_mask_plain(seed, B * H, L, L, 0.25, device=dev))
    ours, ref = philox.check_against_curand(1 << 16, dev)
    if not torch.equal(ours, ref):
        raise AssertionError(f"philox.cuh differs from curand_Philox4x32_10 in "
                             f"{int((ours != ref).sum())} of {ours.numel()} words")
    log(f"[3 kernel] keep_mask [{B * H}, {L}, {L}] p=0.25: bit-exact against the torch "
        f"Philox (keep rate {rate:.5f}) | kernel {k_ms:.4f} ms | plain {p_ms:.4f} ms | "
        f"philox.cuh == curand_Philox4x32_10 on {ours.shape[0]} counters | {card}")
    report["keep_mask"] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=max_abs(km, kp))
    return report




def _write_yaml(path, cfg):
    """Floats are written positionally: YAML 1.1 reads `8e-05` (no dot) as a
    string."""
    import numpy as np

    def fmt(v):
        if v is None:
            return "null"
        return np.format_float_positional(v) if isinstance(v, float) else str(v)

    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k}: {fmt(v)}\n")


COUNTERS = (("ln_relu_region_mean", "ln_pool", "LAUNCHES"),
            ("ln_relu_region_mean_bwd", "ln_pool", "LAUNCHES_BWD"),
            ("masked_flash_attention", "attention", "LAUNCHES"),
            ("masked_flash_attention_dropout", "attention", "LAUNCHES_DROPOUT"),
            ("flash_bwd_dq", "attention", "LAUNCHES_DQ"),
            ("flash_bwd_dkv", "attention", "LAUNCHES_DKV"),
            ("keep_mask", "philox", "LAUNCHES"))


def _counter_modules():
    from advmil_tpu_torch.ops import attention, ln_pool, philox
    return {"ln_pool": ln_pool, "attention": attention, "philox": philox}


def reset_counters():
    mods = _counter_modules()
    for _, mod, attr in COUNTERS:
        setattr(mods[mod], attr, 0)


def read_counters() -> dict:
    mods = _counter_modules()
    return {name: getattr(mods[mod], attr) for name, mod, attr in COUNTERS}


def make_data():
    """cfg_nlst-width synthetic data: 36 patients of 64-256 regions (around
    the reference's ~212), one 2,048-region test bag (the eval flash gate)
    and two training bags of 700 and 1,000 regions, whose 16,384-patch bucket
    (1,024 regions) engages flash with dropout in the G phase."""
    import numpy as np
    from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    counts = np.random.default_rng(7).integers(64, 257, size=38)
    counts[0], counts[36], counts[37] = 2048, 700, 1000
    paths = make_synthetic_dataset(osp.join(WORK_DIR, "data"), dim=1024, seed=7,
                                   feat_format="pt", region_counts=list(counts),
                                   test_pids=[f"P{i:04d}" for i in range(7)],
                                   train_pids=["P0036", "P0037"])
    log(f"[4 train] synthetic cfg_nlst-width data: 38 patients, 1024-d, regions "
        f"{int(counts[1:36].min())}-{int(counts[1:36].max())}, a test bag of 2048 and "
        f"training bags of 700 and 1000 ({time.perf_counter() - t0:.1f} s)")
    return paths


def _smoke_cfg(paths, **over):
    from advmil_tpu_torch.config import read_yaml
    cfg = read_yaml(osp.join(ROOT, "config", "cfg_nlst.yaml"))
    run = osp.join(WORK_DIR, "run")
    cfg.update(path_patch=paths["path_patch"], path_label=paths["path_label"],
               data_split_path=paths["data_split_path"], data_split_seed=0,
               save_path=run, test_load_path=run,
               test_save_path=osp.join(WORK_DIR, "test_{}-{}"), device="cuda")
    cfg.update(over)
    return cfg


def _read_csv_preds(path):
    import numpy as np
    with open(path) as f:
        rows = f.read().strip().splitlines()[1:]
    return np.asarray([float(r.split(",")[-1]) for r in rows])


def phase_train(paths):
    """Phase 4: `exec` at full cfg_nlst width, bf16, 2 epochs, on the card."""
    import json as _json
    import numpy as np
    from advmil_tpu_torch import main as port_main

    cfg = _smoke_cfg(paths, test=False, epochs=2, es_warmup=0)
    yaml_path = osp.join(WORK_DIR, "cfg_nlst_train.yaml")
    _write_yaml(yaml_path, cfg)
    reset_counters()
    [(handler, metrics)] = port_main.main(["--config", yaml_path, "--handler", "adv"])
    launches = read_counters()

    for name in ("ln_relu_region_mean", "ln_relu_region_mean_bwd", "masked_flash_attention",
                 "masked_flash_attention_dropout", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the training path")
    run = handler.save_dir
    for f in ("train_modelG-best.ckpt", "train_modelD-best.ckpt", "train_modelG-last.ckpt",
              "train_modelD-last.ckpt", "train_metrics-best.txt"):
        if not osp.exists(osp.join(run, f)):
            raise AssertionError(f"training wrote no {f}")
    losses = []
    with open(osp.join(run, "run_scalars.jsonl")) as f:
        for line in f:
            rec = _json.loads(line)
            losses += [v for k, v in rec.items() if k.startswith("train_batch/Loss")]
    if not losses or not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training losses ({len(losses)} logged)")
    for split in ("train", "validation", "test"):
        preds = _read_csv_preds(osp.join(run, f"train_best_pred_{split}.csv"))
        if not (len(preds) and np.all(np.isfinite(preds)) and preds.min() >= 0
                and preds.max() <= 1):
            raise AssertionError(f"{split} predictions not finite in [0, 1]")
        ci = dict(metrics[split])["cindex"]
        if not 0.0 <= ci <= 1.0:
            raise AssertionError(f"{split} C-index {ci!r} not in [0, 1]")
    on_cuda = all(p.is_cuda for m in (handler.gen_model, handler.disc_model)
                  for p in m.parameters())
    if not on_cuda:
        raise AssertionError("parameters are not on cuda")
    rates = " ".join(f"epoch {i + 1} {b / s:.2f} ({b} bags, {s:.3f} s);"
                     for i, (b, s) in enumerate(handler.train_timings))
    log(f"[4 train] exec: {len(losses)} finite losses logged; best/last checkpoints; "
        f"C-index train {dict(metrics['train'])['cindex']:.4f} validation "
        f"{dict(metrics['validation'])['cindex']:.4f} test "
        f"{dict(metrics['test'])['cindex']:.4f}; predictions finite in [0, 1] | "
        f"launches {launches}")
    log(f"[4 train] training bags/s: {rates}")
    return handler, launches


def phase_slice(paths):
    """Phase 5: test mode through the same entry point, loading the best
    checkpoint phase 4 wrote."""
    import numpy as np
    import torch
    from advmil_tpu_torch import main as port_main

    cfg = _smoke_cfg(paths, test=True)
    yaml_path = osp.join(WORK_DIR, "cfg_nlst_smoke.yaml")
    _write_yaml(yaml_path, cfg)

    reset_counters()
    [(handler, metrics)] = port_main.main(["--config", yaml_path, "--handler", "adv"])
    ds, batcher = handler.loaders["exec-test"]
    dist = handler._run_eval(ds, batcher, n_samples=handler.cfg["times_test_sample"],
                             rng_tag=1)
    launches = read_counters()

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
    preds = _read_csv_preds(csv_path)
    if len(preds) != len(ds):
        raise AssertionError(f"CSV has {len(preds)} rows for {len(ds)} patients")
    if not (np.all(np.isfinite(preds)) and preds.min() >= 0 and preds.max() <= 1):
        raise AssertionError("CSV predictions not finite in [0, 1]")
    shipped = handler._ship(next(iter(batcher.epoch_batches())))
    on_cuda = (shipped["feats"].is_cuda and shipped["feats"].dtype == torch.bfloat16
               and all(p.is_cuda for p in handler.gen_model.parameters())
               and all(p.is_cuda for p in handler.disc_model.parameters()))
    if not on_cuda:
        raise AssertionError("feats / parameters are not on cuda")
    for name in ("ln_relu_region_mean", "masked_flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the test-mode path")
    (b1, s1), (b2, s2) = handler.eval_timings[-2:]
    log(f"[5 slice] exec-test C-index {ci:.6f} (best checkpoint of phase 4) | CSV "
        f"{osp.relpath(csv_path, ROOT)} with {len(preds)} rows | feats bf16 and params "
        f"on cuda | launches {launches}")
    log(f"[5 slice] eval bags/s: test-mode pass {b1 / s1:.2f} ({b1} bags, {s1:.3f} s); "
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
    log(f"[6 gpu-vs-cpu] f32 batch {tuple(batch.feats.shape)}: max |y_hat| diff "
        f"{diff['y_hat']:.3e}, max |f_fake| diff {diff['f_fake']:.3e} (bound 1e-4)")
    for k, d in diff.items():
        if not d <= 1e-4:
            raise AssertionError(f"GPU vs CPU {k} differs by {d}")


def phase_gpu_vs_cpu_train(handler):
    """Phase 7: the gradients of one adversarial step (D phase, then G phase
    against the frozen D) in f32 with dropout off and zero noise, on the card
    (kernels) and on the CPU (plain versions), on the long training batch."""
    import torch
    from advmil_tpu_torch import losses
    from advmil_tpu_torch.models.layers import set_dropout_rates
    from advmil_tpu_torch.train.handler import build_models

    _, batcher = handler.loaders["train"]
    batch = list(batcher.epoch_batches())[-1]     # the largest bucket (1,024 regions)
    cfg = dict(handler.cfg, precision="f32")
    grads = {}
    for dev in ("cuda", "cpu"):
        G, D = build_models(cfg)
        G.load_state_dict(handler.gen_model.state_dict())
        D.load_state_dict(handler.disc_model.state_dict())
        set_dropout_rates(G.to(dev), 0.0)
        set_dropout_rates(D.to(dev), 0.0)
        feats, mask, label, smask = (torch.from_numpy(a).to(dev) for a in (
            batch.feats, batch.mask, batch.label, batch.sample_mask))
        t, e = label[:, 0], label[:, 1]
        G.eval()
        D.train()
        with torch.no_grad():
            pred = G(feats, mask, zero_noise=True)
        f_real, f_fake = D(feats, (t[:, None], pred), mask)
        losses.real_fake_loss(f_real.float(), f_fake.float(), cfg["loss_netD"],
                              real_weight=(e == 1).float() * smask,
                              fake_weight=smask).backward()
        G.train()
        D.eval()
        D.requires_grad_(False)
        pred = G(feats, mask, zero_noise=True)
        total = (handler.sup_loss_fn(pred[:, 0], t, e, weight=smask)
                 + cfg["loss_gan_coef"] * losses.fake_generator_loss(
                     D(feats, pred, mask).float(), weight=smask)
                 + losses.loss_reg_l1(G.parameters(), cfg["loss_regl1_coef"]))
        total.backward()
        grads[dev] = {f"{tag}.{n}": p.grad.detach().cpu()
                      for tag, m in (("G", G), ("D", D))
                      for n, p in m.named_parameters() if p.grad is not None}
    if set(grads["cuda"]) != set(grads["cpu"]) or len(grads["cpu"]) < 40:
        raise AssertionError("gradients missing on one device")
    diffs = {k: max_abs(grads["cuda"][k], grads["cpu"][k]) for k in grads["cpu"]}
    worst = max(diffs, key=diffs.get)
    scale = max(float(g.abs().max()) for g in grads["cpu"].values())
    log(f"[7 gpu-vs-cpu train] f32 step on batch {tuple(batch.feats.shape)}: gradients of "
        f"{len(diffs)} G and D tensors, max |diff| {diffs[worst]:.3e} at {worst} (bound "
        f"1e-4; largest |grad| {scale:.3e})")
    if not diffs[worst] <= 1e-4:
        raise AssertionError(f"GPU vs CPU gradient {worst} differs by {diffs[worst]}")


SOURCES = {
    "ln_relu_region_mean": ("advmil_tpu_torch/csrc/ln_pool.cu", "advmil_tpu/ops/ln_pool.py:67"),
    "ln_relu_region_mean_bwd": ("advmil_tpu_torch/csrc/ln_pool.cu",
                                "advmil_tpu/ops/ln_pool.py:74"),
    "masked_flash_attention": ("advmil_tpu_torch/csrc/flash_fwd.cu",
                               "advmil_tpu/ops/attention.py:85"),
    "masked_flash_attention_dropout": ("advmil_tpu_torch/csrc/flash_fwd.cu",
                                       "advmil_tpu/ops/attention.py:85"),
    "flash_bwd_dq": ("advmil_tpu_torch/csrc/flash_bwd.cu", "advmil_tpu/ops/attention.py:138"),
    "flash_bwd_dkv": ("advmil_tpu_torch/csrc/flash_bwd.cu", "advmil_tpu/ops/attention.py:182"),
    "keep_mask": ("advmil_tpu_torch/csrc/keep_mask.cu", "advmil_tpu/ops/attention.py:505"),
}


def main():
    if not osp.isdir(osp.join(ROOT, "advmil_tpu_torch")):
        raise SystemExit("chip_smoke.py runs from the root of a checkout: "
                         "advmil_tpu_torch/ not found beside it")
    sys.path.insert(0, ROOT)
    card = phase_device()
    phase_build()
    reset_counters()
    report = phase_kernels(card)
    oracle_launches = read_counters()["keep_mask"]
    paths = make_data()
    train_handler, train_launches = phase_train(paths)
    handler, test_launches = phase_slice(paths)
    phase_gpu_vs_cpu(handler)
    phase_gpu_vs_cpu_train(train_handler)
    shutil.rmtree(osp.join(WORK_DIR, "data"), ignore_errors=True)

    import torch
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = report[name]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces}
        if name == "keep_mask":        # the tests' oracle: no model path runs it
            entry.update(launches=oracle_launches, main_path=False)
        else:
            by_path = {"train": train_launches[name], "test_mode": test_launches[name]}
            entry.update(launches=sum(by_path.values()), launches_by_path=by_path)
        entry.update(max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"])
        kernels.append(entry)
    assert all(math.isfinite(k["ms"]) and math.isfinite(k["plain_ms"]) for k in kernels)
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
