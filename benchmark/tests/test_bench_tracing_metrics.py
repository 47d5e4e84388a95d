"""The readers of the program's own spans and counters
(`advmil_tpu_torch/utils/tracing.py`): None on an empty snapshot, on a
program without the module and in the other kind of cell; the expected
number on a planted snapshot."""
import sys
from types import SimpleNamespace

import pytest

import advmil_tpu_torch.utils
from advmil_tpu_torch.utils import tracing
from benchmark import harness, trace

PLANTED = {
    "spans": {"step": (4, 0.400), "batch_wait": (5, 0.020), "assemble": (8, 0.160),
              "step.d": (4, 0.150), "step.g": (4, 0.200), "pass_end": (2, 0.030),
              "ship": (4, 0.100)},
    "counters": {"h2d_bytes": 600_000_000, "slots_total": 4000, "slots_real": 2600,
                 "slots_filler": 800},
}
# the trace's host-to-device copies: 0.25 s (pageable) + 0.05 s (pinned)
COPIES = [("Memcpy HtoD (Pageable -> Device)", 0.25), ("Memcpy HtoD (Pinned -> Device)", 0.05),
          ("Memcpy DtoH (Device -> Pageable)", 9.0), ("void ln_relu_region_mean", 1.0)]
WANT = {
    "batch_wait_ms.train": 5.0, "batch_wait_ms.eval": 5.0,    # 20 ms over 4 steps
    "assemble_ms.train": 20.0,                                # 160 ms over 8 batches
    "h2d_mb_per_step.train": 150.0,                           # 600 MB over 4 steps
    "h2d_gbps.train": 2.0, "h2d_gbps.eval": 2.0,              # 0.6 GB over 0.3 s
    "filler_slot_share.train": 20.0,                          # 800 of 4000 slots
    "d_phase_host_ms.train": 37.5, "g_phase_host_ms.train": 50.0,
    "pass_end_ms.eval": 15.0,                                 # 30 ms over 2 passes
}


def _ctx(kind):
    return SimpleNamespace(kind=kind, trace=trace.Trace(window_s=10.0, busy_s=10.3,
                                                        kernels=list(COPIES)))


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_planted_snapshot(name, monkeypatch):
    read = harness.metric_reader(name)
    kind = name.rsplit(".", 1)[1]
    monkeypatch.setattr(tracing, "snapshot", lambda: PLANTED)
    assert read(_ctx(kind)) == pytest.approx(WANT[name], rel=1e-12)
    other = "eval" if kind == "train" else "train"
    assert read(_ctx(other)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_without_steps_or_without_the_module(name, monkeypatch):
    read = harness.metric_reader(name)
    ctx = _ctx(name.rsplit(".", 1)[1])
    monkeypatch.setattr(tracing, "snapshot", lambda: {"spans": {}, "counters": {}})
    assert read(ctx) is None
    no_steps = {"spans": {k: v for k, v in PLANTED["spans"].items() if k != "step"},
                "counters": PLANTED["counters"]}
    monkeypatch.setattr(tracing, "snapshot", lambda: no_steps)
    assert read(ctx) is None
    # a program that has no `utils/tracing.py` (an older checkout)
    monkeypatch.setattr(tracing, "snapshot", lambda: PLANTED)
    monkeypatch.setitem(sys.modules, "advmil_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(advmil_tpu_torch.utils, "tracing")
    assert read(ctx) is None


def test_h2d_rate_needs_a_copy_in_the_trace(monkeypatch):
    monkeypatch.setattr(tracing, "snapshot", lambda: PLANTED)
    for name in ("h2d_gbps.train", "h2d_gbps.eval"):
        kind = name.rsplit(".", 1)[1]
        no_copy = SimpleNamespace(kind=kind, trace=trace.Trace(window_s=1.0, busy_s=0.5))
        assert harness.metric_reader(name)(no_copy) is None
        assert harness.metric_reader(name)(SimpleNamespace(kind=kind, trace=None)) is None
