"""Reduction of a torch.profiler trace of the traced window.

Device intervals are the trace's kernels, copies and sets; the device is busy
where one of them runs (their union) and idle elsewhere in the window. Each
idle gap is labelled by the benchmark's host mark (`bench.*`) that covers
its middle, or as the time between steps (the batcher's prefetch wait and
the epoch's end, which the program does not mark yet). Kernels are grouped
into families by name; the first match wins.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

FAMILIES = (
    ("fused_embed", ("fused_rows_kernel", "gemm_tile_kernel", "sum_rows_kernel")),
    ("banded #14 / #15", ("banded_fwd_kernel", "banded_bwd_kernel")),
    ("knn #12 / #13", ("knn_agg_",)),
    ("gather / scatter", ("gather", "scatter", "index_")),
    ("ln_pool", ("ln_relu_region_mean", "sum_partials_kernel")),
    ("flash", ("flash_",)),
    ("gemm", ("gemm", "cutlass", "cublas", "nvjet", "xmma", "splitKreduce")),
    ("adam", ("multi_tensor", "adam")),
    ("memcpy", ("Memcpy", "Memset")),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BETWEEN = "between steps (prefetch wait, epoch end)"


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "elementwise / reduce / copy"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)      # (name, seconds)
    n_kernels: int = 0
    gaps: list = field(default_factory=list)         # (label, seconds)

    def seconds_of(self, names) -> float:
        """Device seconds of the kernels whose name holds any of `names`."""
        return sum(s for n, s in self.kernels if any(k in n for k in names))

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for n, s in self.kernels:
            key = f"{family(n)}: {n[:96]}"
            by[key] = by.get(key, 0.0) + s
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        total, longest = {}, {}
        for label, s in self.gaps:
            total[label] = total.get(label, 0.0) + s
            longest[label] = max(longest.get(label, 0.0), s)
        rows = [[f"{k} (sum)", v] for k, v in total.items()]
        rows += [[f"{k} (longest)", v] for k, v in longest.items()]
        return sorted(rows, key=lambda kv: -kv[1])[:top]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(path: str, window_s: float) -> Trace:
    """The trace exported to `path` (Chrome JSON, times in us); `window_s`
    is the traced window's length on the host's clock."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    dev, marks, kernels = [], [], []
    lo, hi = float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        ts, dur = float(ev["ts"]), float(ev["dur"])
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            kernels.append((ev.get("name", ""), dur * 1e-6))
        elif cat == "user_annotation" and str(ev.get("name", "")).startswith("bench."):
            marks.append((ts, ts + dur, ev["name"][len("bench."):]))
            lo, hi = min(lo, ts), max(hi, ts + dur)
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = []
    if busy:
        lo, hi = min(lo, busy[0][0]), max(hi, busy[-1][1])
        edges = [(lo, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                      for i in range(len(busy) - 1)] + [(busy[-1][1], hi)]
        marks.sort()
        for a, b in edges:
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            label = next((m for s, e, m in marks if s <= mid <= e), BETWEEN)
            gaps.append((label, (b - a) * 1e-6))
    return Trace(window_s=window_s, busy_s=busy_s, kernels=kernels,
                 n_kernels=sum(1 for n, _ in kernels
                               if "Memcpy" not in n and "Memset" not in n),
                 gaps=gaps)
