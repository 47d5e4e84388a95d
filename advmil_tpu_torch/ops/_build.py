"""Build and load the port's hand-written CUDA kernels.

Every `advmil_tpu_torch/csrc/*.cu` is compiled by `nvcc` for `sm_90a`, one
`nvcc` process per source, all started together, and the objects are linked
into one shared library with a plain C interface, at first use, under
`advmil_tpu_torch/_build/` (listed in .gitignore). The library's name carries
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. It is loaded with ctypes; every pointer and the CUDA
stream cross as `c_void_p` (without argtypes ctypes would cut them to 32
bits). Each C entry point returns `cudaGetLastError()` after its launch and
`check` raises on anything but 0: a refused launch is visible nowhere else.

Nothing here runs at import time; a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_DROP = [_I, _U, _U, _U, _F]   # dropout on/off, seed lo / hi, threshold, 1/(1-p)
_SIGNATURES = {
    # name: argtypes (all return int: cudaError_t, or a count where named so)
    "advmil_ln_relu_region_mean": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "advmil_ln_relu_region_mean_bwd": [_P] * 8 + [_I, _I, _I, _I, _F, _P],
    "advmil_ln_pool_bwd_blocks": [_I],                       # returns a count
    "advmil_ln_relu": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "advmil_ln_relu_bwd": [_P] * 8 + [_I, _I, _I, _F, _P],
    "advmil_fused_embed_fwd": [_P] * 6 + [_I, _I, _I, _I, _F, _P],
    "advmil_fused_embed_bwd_dh": [_P] * 9 + [_I, _I, _I, _I, _F, _P],
    "advmil_fused_embed_row_blocks": [_I],                   # returns a count
    "advmil_fused_embed_dw": [_P] * 4 + [_I, _I, _I, _I, _P],
    "advmil_fused_embed_dw_slabs": [_I, _I, _I, _I],         # returns a count
    "advmil_fused_embed_dx": [_P] * 3 + [_I, _I, _I, _I, _P],
    "advmil_flash_fwd": [_P] * 6 + [_I] * 6 + _DROP + [_P],
    "advmil_flash_bwd_dq": [_P] * 8 + [_I] * 6 + _DROP + [_P],
    "advmil_flash_bwd_dkv": [_P] * 9 + [_I] * 6 + _DROP + [_P],
    "advmil_keep_mask": [_P, _I, _I, _I, _U, _U, _U, _P],
    "advmil_philox_check": [_P, _P, _I, _P],
    "advmil_knn_agg_fwd": [_P] * 4 + [_I] * 4 + [_P],
    "advmil_knn_agg_bwd_blocks": [_I, _I, _I],              # returns a count
    "advmil_knn_agg_bwd": [_P] * 6 + [_I, _P] + [_I] * 4 + [_P],
    "advmil_banded_fwd": [_P] * 7 + [_I] * 5 + [_P],
    "advmil_banded_bwd": [_P] * 10 + [_I] * 5 + [_P],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}   # path, seconds (0.0 when reused), ptxas log


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels of advmil_tpu_torch cannot be built")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libadvmil_kernels_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []   # one nvcc per source, all running at once
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = so.with_name(f"{tag}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(f"$ {' '.join(cmd)}\n{r.stdout}{r.stderr}")
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc link failed ({r.returncode}): {' '.join(cmd)}\n"
                               f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, so)   # atomic: a concurrent build never sees a partial file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0, log="\n".join(logs))


def load():
    """The loaded kernel library, built first if needed (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            build_info.update(path=str(so), seconds=0.0, log="")
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.advmil_error_string.argtypes = [ctypes.c_int]
            lib.advmil_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        msg = load().advmil_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def first_order(backward):
    """Decorate a kernel Function's backward. The kernels have no backward
    of their own backward, so a backward asked to build a graph (autograd
    with create_graph=True, as the Hutchinson estimate of AdaHessian's
    double backward needs) raises. torch's `once_differentiable` is not
    enough: `torch.autograd.grad(..., inputs=params)` prunes its error
    node and drops the kernel's share of the second derivative silently."""
    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError(f"{backward.__qualname__}: the CUDA kernels have no double "
                               "backward (create_graph=True); ROADMAP A19")
        return backward(ctx, *grads)
    return wrapper


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Common wrapper checks: every tensor on one CUDA device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
