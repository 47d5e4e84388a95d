"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W)
and the least time an op's work needs on it.

A share of a roofline is the least time, the larger of the operations over
the peak of their type and the bytes over the memory rate, divided by the
device time the op's kernels took. Inputs are counted read once and outputs
written once.
"""
from __future__ import annotations

PEAK = {"bytes": 3.35e12, "bf16": 989e12, "f32": 67e12}
BF16 = 2      # bytes of a bf16 element


def bound_s(moved_bytes: float, ops: float, kind: str = "bf16") -> float:
    return max(moved_bytes / PEAK["bytes"], ops / PEAK[kind])


def share(least_s: float, device_s: float):
    """Percent of the roofline, or None where the op did not run."""
    if device_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / device_s


def step_flops(coef: dict, n: int) -> float:
    """A bag of n patches' operations from the configuration's coefficients:
    per patch, per ordered pair of 16-patch regions, per bag."""
    L = n // 16
    return coef["per_patch"] * n + coef["per_region_pair"] * L * L + coef["per_bag"]
