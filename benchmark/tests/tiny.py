"""A cell cut to a size the CPU runs in seconds: eight patients of small
slides, f32, a small token budget (two to four bags a batch), and the
flash gate lowered so that the larger buckets take the flash branch (on the CPU the port's own plain
version of the flash op, with the same Philox dropout). Used by the tests
only; the cells run at their own sizes."""
from __future__ import annotations

import copy
import tempfile
import time

import torch

from benchmark import harness

PATIENTS = 8
SLIDE_LAW = {"kind": "uniform", "min": 64, "max": 256, "multiple": 16}
FLASH_REGIONS = 32


def tiny_spec(workload: str, precision: str = "f32") -> harness.Spec:
    spec = copy.deepcopy(harness.load_spec(workload))
    spec.traffic.update(patients=spec.traffic["patients"][:PATIENTS], slide_law=dict(SLIDE_LAW))
    spec.config["config"].update(precision=precision, batch_token_budget=2048,
                                 num_workers=2, flash_min_len=FLASH_REGIONS)
    return spec


def tiny_run(workload: str, seed: int = 2 ** 33 + 5, faults=None, traced: bool = False,
             precision: str = "f32", device: str = "cpu") -> dict:
    """One run, on the CPU unless `device` says otherwise, the harness's look
    for a card skipped."""
    spec = tiny_spec(workload, precision)
    with tempfile.TemporaryDirectory() as d:
        return harness.run_cell(spec, seed, 0.2, traced, torch.device(device),
                                time.perf_counter(), d, faults=faults, log=lambda m: None)
