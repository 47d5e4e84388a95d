"""Spans and counters of the training and evaluation loops, for whoever
profiles them.

A span names a stretch of host work (`with span("ship"): ...`); a counter
adds up a quantity (`count("h2d_bytes", n)`). Both record only while
tracing is active: inside a `torch.profiler` window (the benchmark's traced
run, the `profile_dir` epoch) or after `enable(True)`. The loops call
`poll()` once an iteration, on the main thread, to read that state into
`ACTIVE`; the totals are cleared when it turns on, so a window reads its
own totals (`snapshot()`). Two profiler windows with no loop iteration
between them read as one.

Off, a span costs one test of `ACTIVE` and returns a shared no-op context:
no clock read, no `record_function`. On, it is a
`torch.profiler.record_function("advmil.<name>")`, so it shows in the
profiler's trace on the main thread above the kernels it launched, and it
adds its host wall (`time.perf_counter`) and a count to `name`'s totals.
`span(name, host_only=True)` keeps the totals only: the batcher's prefetch
workers use it, since the profiler records the threads it was started on
and a `record_function` opened on a worker never reaches its trace.

Spans (host wall; the device's side is in the profiler's trace):
  batch_wait  the main thread waiting for the batcher's next batch
  ship        `HandlerCommon._ship`: host batch to device tensors
  step        one call of the training step or of the evaluation step
  step.d      the adversarial step's D phase, through `opt_D.step()`
  step.g      its G phase (every G update)
  pass_end    a pass after its last step: the stack of the logged metrics,
              the `.cpu()` that is the pass's one device sync, the logger
  assemble    `BucketBatcher._make_batch` on a prefetch worker (host only)
Counters:
  h2d_bytes     bytes of the host arrays `_ship` hands to `.to(device)`
  slots_total   patch slots of the assembled batches (rows x bucket)
  slots_real    the real patches of their real bags
  slots_filler  the slots of their tail-filler rows (the rest is padding)
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

ACTIVE = False         # read by span / count; set by poll()
_forced = False
_lock = threading.Lock()
_spans: dict = {}      # name -> [count, seconds]
_counters: dict = {}   # name -> int
_OFF = contextlib.nullcontext()   # every span while tracing is off


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str, host_only: bool):
        self.name = name
        self.rf = None if host_only else torch.profiler.record_function("advmil." + name)

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        with _lock:
            tot = _spans.setdefault(self.name, [0, 0.0])
            tot[0] += 1
            tot[1] += dt
        return False


def poll() -> None:
    """Read whether tracing is on (`enable`d, or a profiler running on this
    thread); clear the totals when it turns on."""
    global ACTIVE
    on = _forced or torch.autograd._profiler_enabled()
    if on and not ACTIVE:
        with _lock:
            _spans.clear()
            _counters.clear()
    ACTIVE = on


def enable(flag: bool = True) -> None:
    """Trace without a profiler (from the next `poll()`), or stop forcing it."""
    global _forced
    _forced = bool(flag)


def span(name: str, host_only: bool = False):
    if not ACTIVE:
        return _OFF
    return _Span(name, host_only)


def count(name: str, n) -> None:
    if ACTIVE:
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)


def batches(iterable):
    """Yield the items of `iterable` (a batcher's prefetch), each after a
    `poll()` and fetched under a `batch_wait` span."""
    it = iter(iterable)
    end = object()
    while True:
        poll()
        with span("batch_wait"):
            item = next(it, end)
        if item is end:
            return
        yield item


def snapshot() -> dict:
    """{"spans": {name: (count, seconds)}, "counters": {name: int}}: the
    totals since tracing last turned on."""
    with _lock:
        return {"spans": {k: (c, s) for k, (c, s) in _spans.items()},
                "counters": dict(_counters)}


def summary(snap: dict | None = None) -> str:
    """One line of a snapshot: each span's count and host ms, each counter."""
    snap = snapshot() if snap is None else snap
    spans = ", ".join(f"{k} {c} / {1e3 * s:.3f} ms" for k, (c, s) in sorted(snap["spans"].items()))
    counters = ", ".join(f"{k} {v}" for k, v in sorted(snap["counters"].items()))
    return f"spans (count / host ms): {spans or 'none'}; counters: {counters or 'none'}"
