"""Exact kNN and k-means on the host, for the offline tools (`tools/`).

`knn_kmeans.cc` (C++, a copy of the JAX package's `native/knn_kmeans.cc`) is
compiled with g++ at first use into `advmil_tpu_torch/_build/` (listed in
.gitignore), under a name that carries a hash of the source, and bound with
ctypes. A failed build raises with g++'s output: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "knn_kmeans.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libadvmil_native_{h.hexdigest()[:16]}.so"


def load():
    """The loaded library, built first if needed (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
                cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
                r = subprocess.run(cmd, capture_output=True, text=True)
                if r.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"g++ failed ({r.returncode}): {' '.join(cmd)}\n"
                                       f"{r.stdout}\n{r.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
            lib.advmil_knn_l2.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32,
                                          ctypes.c_int32, i32p, f32p, ctypes.c_int32]
            lib.advmil_knn_l2.restype = None
            lib.advmil_kmeans.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32,
                                          ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32,
                                          i32p, f32p]
            lib.advmil_kmeans.restype = None
            _lib = lib
    return _lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def knn_l2(X: np.ndarray, k: int, n_threads: int = 0) -> np.ndarray:
    """Exact L2 kNN indices [n, min(k, n)] of the rows of X [n, d], nearest
    first, the point itself at column 0 (distance 0). Ties keep the order of
    the C++ heap, the same as the JAX package's `native.knn_l2`."""
    X = np.ascontiguousarray(X, np.float32)
    if X.ndim != 2:
        raise ValueError(f"knn_l2: X must be [n, d], got {X.shape}")
    n, d = X.shape
    k = min(int(k), n)
    out = np.empty((n, k), np.int32)
    load().advmil_knn_l2(_f32p(X), n, d, k, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         None, int(n_threads))
    return out


def kmeans(X: np.ndarray, k: int, max_iter: int = 300, seed: int = 42):
    """k-means (kmeans++ seeding, then Lloyd) of the rows of X [n, d]:
    (labels [n] int32, centroids [k, d] f32), deterministic for a seed."""
    X = np.ascontiguousarray(X, np.float32)
    if X.ndim != 2 or not 1 <= int(k) <= X.shape[0]:
        raise ValueError(f"kmeans: X [n, d] with 1 <= k <= n, got {X.shape} and k={k}")
    n, d = X.shape
    labels = np.empty((n,), np.int32)
    centroids = np.empty((int(k), d), np.float32)
    load().advmil_kmeans(_f32p(X), n, d, int(k), int(max_iter), int(seed),
                         labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         _f32p(centroids))
    return labels, centroids
