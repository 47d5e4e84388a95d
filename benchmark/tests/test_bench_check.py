"""The reference against the port's CPU path at a tiny size, the result
line's keys, the control and the planted faults. Each run skips the
harness's look for a card and drives the rest of a run on the CPU."""
import json

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests.tiny import tiny_run, tiny_spec


@pytest.fixture(scope="module")
def traced_esat():
    return tiny_run("esat_nlst_train", traced=True)


def test_reference_agrees_with_the_port_in_f32(traced_esat):
    # f32 on both sides: the replay follows the program's arithmetic to
    # round-off, far below the bf16 limits
    for k, v in traced_esat["check"].items():
        assert v["value"] < 1e-4, (k, v)
    assert traced_esat["correct"] is True


def test_reference_agrees_with_the_port_in_f32_eval():
    res = tiny_run("esat_nlst_eval30")
    assert res["correct"] is True
    for k, v in res["check"].items():
        assert v["value"] < 1e-4, (k, v)


def test_recording_runs_on_until_a_flash_step(tmp_path):
    spec = tiny_spec("esat_nlst_train")
    st = harness.build(spec, 2 ** 36 + 9, str(tmp_path), torch.device("cpu"))
    harness.one_pass(spec, st)
    recs = st.probe.records
    assert len(recs) >= spec.traffic["check_steps"] and not st.probe.recording
    assert any(r["flash"] for r in recs) and any(r["keep"].sum() >= 2 for r in recs)
    assert all(r["g_enc"] is not None and r["g_pred"].numel() == r["B"] for r in recs)
    numbers = harness.check_numbers(spec, st, torch.device("cpu"))
    assert numbers["genc_flash_gap"] < 1e-5 and numbers["gpred_flash_gap"] < 1e-5


def test_result_line_has_the_contract_keys(traced_esat):
    res = json.loads(json.dumps(traced_esat))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "check"
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes",
                                  "busy_s", "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    # a CPU run reads no device metric
    assert "device_idle_share.train" not in res["metrics"]
    assert "launches_per_step.train" not in res["metrics"]
    assert "step_host_ms.train" in res["metrics"]


@pytest.mark.parametrize("cell,fault", [("esat_nlst_train", "frozen_state"),
                                        ("esat_nlst_train", "half_batch"),
                                        ("esat_nlst_train", "flash_scale"),
                                        ("esat_nlst_eval30", "answer")])
def test_a_planted_fault_is_not_correct(cell, fault):
    table = faults.TRAIN if cell.endswith("train") else faults.EVAL
    res = tiny_run(cell, faults={fault: table[fault]})
    assert res["correct"] is False, res["check"]


@pytest.mark.parametrize("cell", ["esat_nlst_train", "esat_nlst_eval30"])
def test_the_control_in_fp8_is_not_correct(cell, tmp_path):
    spec = tiny_spec(cell)
    dev = torch.device("cpu")
    st = harness.build(spec, 2 ** 35 + 1, str(tmp_path), dev)
    harness.one_pass(spec, st)
    while st.probe.recording:
        harness.one_pass(spec, st)
    numbers = harness.check_numbers(spec, st, dev, mm=torch.float8_e4m3fn)
    assert not harness.check.judge(numbers, spec.limits), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["esat_nlst_train", "esat_nlst_eval30"])
def test_tiny_cell_on_the_card_is_correct_in_bf16(cell):
    """The kernels' path at a tiny size, bf16 as configured, traced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = tiny_run(cell, precision="bf16", traced=True, device="cuda")
    assert res["correct"] is True, res["check"]
    assert res["device"]["busy_s"] > 0 and res["device"]["platform"] == "gpu"
