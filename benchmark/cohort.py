"""The cohort of one run, made from its traffic file and `--seed`.

The traffic file lists the patients of a real split: each patient's number of
slides and label (t in days, event e), as the NLST table gives them. A
patient's bag is the concatenation of their slides, as `BagDataset` builds
it. Slide sizes follow the traffic's law as a fixed set of quantiles, laid
onto the slides in a fixed order, so every seed trains the same bags; the
seed makes the features (N(0, 1), with the signal 2 t / t_max - 1 added to
the first `signal_dims` dims, the pattern of the synthetic NLST-like data).
Features are made on the device in a few large calls and kept on the host as
the dataset's cache holds them; the label table is written under the run's
directory.
"""
from __future__ import annotations

import csv
import os
import os.path as osp
import statistics
from dataclasses import dataclass

import numpy as np
import torch

SLIDE_ORDER = 0x5A1DE          # the fixed order in which slides take the sizes
CHUNK = 1 << 20                # patches made in one call on the device


def slide_sizes(law: dict, n: int) -> np.ndarray:
    """The law's (i + 0.5) / n quantiles, clipped and rounded to its multiple."""
    q = (np.arange(n) + 0.5) / n
    if law["kind"] == "lognormal":
        z = np.asarray([statistics.NormalDist().inv_cdf(float(v)) for v in q])
        s = law["median"] * np.exp(law["sigma"] * z)
    elif law["kind"] == "uniform":
        s = law["min"] + (law["max"] - law["min"]) * q
    else:
        raise ValueError(f"unknown size law {law['kind']!r}")
    m = int(law["multiple"])
    s = np.clip(np.round(s / m) * m, law["min"], law["max"])
    return s.astype(np.int64)


def bag_sizes(traffic: dict) -> np.ndarray:
    """Patches per patient: the sum of their slides' sizes (seed-free)."""
    n_slides = np.asarray([p[1] for p in traffic["patients"]], np.int64)
    sizes = np.random.default_rng(SLIDE_ORDER).permutation(
        slide_sizes(traffic["slide_law"], int(n_slides.sum())))
    offs = np.concatenate([[0], np.cumsum(n_slides)])
    return np.asarray([sizes[offs[i]:offs[i + 1]].sum() for i in range(len(n_slides))])


@dataclass
class Cohort:
    pids: list
    sizes: np.ndarray              # patches per patient
    feats: list                    # [n, C] f32 host arrays
    t: np.ndarray                  # time as the config's time_format gives it
    e: np.ndarray                  # event indicator
    label_path: str


def make_cohort(traffic: dict, seed: int, dim: int, root: str, device) -> Cohort:
    pats = traffic["patients"]
    pids = [str(p[0]) for p in pats]
    t_days = np.asarray([float(p[2]) for p in pats])
    e = np.asarray([float(p[3]) for p in pats], np.float32)
    sizes = bag_sizes(traffic)
    # the table's longest follow-up sets the ratio's scale, as in the full table
    mpid, msid, mt, me = traffic["t_max_row"]
    t_max = max(float(mt), float(t_days.max()))
    os.makedirs(root, exist_ok=True)

    label_path = osp.join(root, "labels.csv")
    with open(label_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["pathology_id", "patient_id", "e", "t"])
        for pid, (_, n_sl, t, ev) in zip(pids, pats):
            for k in range(int(n_sl)):
                w.writerow([f"{pid}_{k}", pid, int(ev), repr(float(t))])
        if str(mpid) not in pids:
            w.writerow([msid, mpid, int(me), repr(float(mt))])
    t_out = t_days / t_max if traffic["time_format"] == "ratio" else t_days

    # features: the seed's N(0, 1) stream on the device, a chunk a call
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    total = int(sizes.sum())
    host = np.empty((total, dim), np.float32)
    sig = np.repeat((2.0 * t_days / t_max - 1.0).astype(np.float32), sizes)
    nd = int(traffic["signal_dims"])
    for a in range(0, total, CHUNK):
        b = min(total, a + CHUNK)
        x = torch.randn(b - a, dim, generator=gen, device=device)
        x[:, :nd] += torch.from_numpy(sig[a:b]).to(device)[:, None]
        torch.from_numpy(host[a:b]).copy_(x)
        del x
    offs = np.concatenate([[0], np.cumsum(sizes)])
    feats = [host[offs[i]:offs[i + 1]] for i in range(len(pids))]
    return Cohort(pids, sizes, feats, t_out.astype(np.float64), e, label_path)
