"""The spans and counters of the port's loops (`advmil_tpu_torch/utils/
tracing.py`) on a small adversarial handler on the CPU: off, they record
nothing, enter no `record_function` and change no number; under the
profiler they show in its trace on the main thread, with counts that match
the batches; the counters equal what was shipped and assembled; a profiled
window reads its own totals."""
import json
import os
import os.path as osp
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from advmil_tpu_torch.config import with_defaults
from advmil_tpu_torch.data.bags import prepare_dataset
from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
from advmil_tpu_torch.train.handler import AdvHandler
from advmil_tpu_torch.utils import tracing
from tests.test_torch_train import _cfg as adv_cfg

TINY = dict(bcb_dims="32-64-64", gen_dims="64-1", disc_netx_in_dim=32, disc_netx_out_dim=32,
            disc_nety_hid_dims="16-32", device="cpu", batch_token_budget=512, bucket_min=32,
            num_workers=2)
LOOP_SPANS = ("batch_wait", "ship", "step", "step.d", "step.g", "pass_end")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """20 patients of 2-7 regions: buckets of 32-112 patches, 4-16 bags a
    batch, so batches hold padding and tail fillers."""
    root = str(tmp_path_factory.mktemp("tracing_data"))
    return make_synthetic_dataset(root, n_patients=20, dim=32, min_regions=2, max_regions=7,
                                  seed=4, feat_format="pt")


@pytest.fixture(autouse=True)
def fresh():
    """No totals and tracing off before and after each test."""
    def reset():
        tracing.enable(False)
        tracing.poll()
        tracing._spans.clear()
        tracing._counters.clear()
    reset()
    yield
    reset()


def _handler(data, tmp_path, name):
    """(handler, (dataset, batcher)) of the training patients; the handler's
    logged scalars are kept in `h.logged`."""
    h = AdvHandler(with_defaults(adv_cfg(data, tmp_path, name, **TINY)))
    pids = [f"P{i:04d}" for i in range(20)]
    ds = prepare_dataset(pids, h.cfg, rng=h.np_rng)
    h.logged = []
    h.logger.log = h.logged.append
    return h, (ds, h._make_bucket_batcher(ds))


def _n_batches(loader):
    return sum(1 for _ in loader[1].epoch_batches())


def _pass(h, loader):
    """One training epoch and one 3-sample evaluation pass."""
    return h._train_each_epoch(loader), h._run_eval(*loader, n_samples=3)


def test_off_records_nothing_and_the_profiled_epoch_is_bit_for_bit_the_same(data, tmp_path):
    plain, loader = _handler(data, tmp_path, "plain")
    got_plain = _pass(plain, loader)
    assert tracing.snapshot() == {"spans": {}, "counters": {}}
    traced, tloader = _handler(data, tmp_path, "traced")
    with profile(activities=[ProfilerActivity.CPU]):
        got_traced = _pass(traced, tloader)
    assert tracing.snapshot()["spans"]["step"][0] > 0
    for a, b in zip(got_plain, got_traced):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert plain.logged == traced.logged and len(plain.logged) == _n_batches(loader)


def test_profile_dir_epoch_shows_the_spans_on_the_main_thread(data, tmp_path, capsys):
    h, loader = _handler(data, tmp_path, "profiled")
    trace_dir = str(tmp_path / "trace")
    with h._trace(trace_dir):
        h._train_each_epoch(loader)
    snap = tracing.snapshot()
    n = _n_batches(loader)
    counts = {k: c for k, (c, _) in snap["spans"].items()}
    assert counts["ship"] == counts["step"] == counts["step.d"] == counts["step.g"] == n
    assert counts["batch_wait"] == n + 1 and counts["pass_end"] == 1   # + the wait for the end
    assert counts["assemble"] == n
    assert f"[profile] epoch-2 {tracing.summary(snap)}" in capsys.readouterr().out
    with open(osp.join(trace_dir, "epoch2_rank0.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if str(e.get("name", "")).startswith("advmil.")]
    assert {e["name"] for e in ours} == {"advmil." + k for k in LOOP_SPANS}
    assert {e["cat"] for e in ours} == {"user_annotation"}
    assert {e["tid"] for e in ours} == {threading.get_native_id()}
    assert sum(e["name"] == "advmil.step" for e in ours) == n


def test_counters_equal_the_shipped_arrays_and_the_batches_slots(data, tmp_path):
    h, loader = _handler(data, tmp_path, "counted")
    shipped = []
    ship = h._ship

    def keep(batch, train=False, visible=None):
        shipped.append(batch)
        return ship(batch, train=train, visible=visible)
    h._ship = keep
    tracing.enable(True)
    h._train_each_epoch(loader)
    c = tracing.snapshot()["counters"]
    assert c["h2d_bytes"] == sum(b.feats.nbytes + b.mask.nbytes + b.sample_mask.nbytes
                                 + b.label.nbytes for b in shipped)
    real = [b.sample_mask.astype(bool) for b in shipped]
    assert c["slots_total"] == sum(b.mask.size for b in shipped)
    assert c["slots_real"] == sum(int(b.mask[r].sum()) for b, r in zip(shipped, real))
    assert c["slots_filler"] == sum(int((~r).sum()) * b.mask.shape[1]
                                    for b, r in zip(shipped, real))
    # the cohort exercises all three: real patches, padding and fillers
    assert 0 < c["slots_filler"] and c["slots_real"] + c["slots_filler"] < c["slots_total"]


def test_a_profiled_window_reads_its_own_totals(data, tmp_path):
    h, loader = _handler(data, tmp_path, "windows")
    reads = []
    for profiled in (True, False, True):
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                h._train_each_epoch(loader)
        else:
            h._train_each_epoch(loader)       # tracing off: the totals stay
        snap = tracing.snapshot()
        reads.append(({k: c for k, (c, _) in snap["spans"].items()}, snap["counters"]))
    assert reads[0] == reads[1] == reads[2]
    assert reads[0][0]["step"] == _n_batches(loader) and reads[0][1]["h2d_bytes"] > 0


def test_off_a_span_never_enters_record_function(data, tmp_path, monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    h, loader = _handler(data, tmp_path, "off")
    _pass(h, loader)
    assert tracing.span("ship") is tracing.span("step") is tracing._OFF
    assert tracing.snapshot() == {"spans": {}, "counters": {}}
    tracing.enable(True)                  # on, the same span does enter it
    tracing.poll()
    with pytest.raises(AssertionError, match="advmil.ship"):
        tracing.span("ship")


def test_totals_lose_no_update_across_threads():
    """More threads than cores add to one counter and one host span at a
    short switch interval: every addition is kept."""
    tracing.enable(True)
    tracing.poll()
    n_threads, n_adds = 4 * (os.cpu_count() or 1), 200

    def work():
        for _ in range(n_adds):
            tracing.count("slots_total", 3)
            with tracing.span("assemble", host_only=True):
                pass
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = tracing.snapshot()
    assert snap["counters"]["slots_total"] == 3 * n_threads * n_adds
    assert snap["spans"]["assemble"][0] == n_threads * n_adds
