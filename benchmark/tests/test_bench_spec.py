"""BENCHMARK.json and the files it names: every configuration, traffic mix,
limit file and per-layer metric loads by name."""
import csv
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import cohort, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    spec = harness.load_spec(cell)
    assert spec.config["name"] == spec.cell["config"]
    train = {"pred_gap", "pred_median_gap", "gpred_flash_gap", "genc_flash_gap", "loss_gap",
             "loss_d_gap", "grad_gap", "grad_median_gap", "change_gap", "change_median_gap"}
    evals = {"pred_gap", "pred_median_gap", "score_gap", "score_median_gap"}
    assert spec.limits and set(spec.limits) <= (train if spec.kind == "train" else evals)
    assert all(0 < v < 1 for v in spec.limits.values())
    names = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer
    for m in spec.per_layer:
        assert m["moves"] in names
        assert callable(harness.metric_reader(m["name"]))


def test_every_metric_has_a_reader_and_every_config_its_file():
    for m in BENCH["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert set(c["reduced"]) <= set(conf["reduced"])
    for f in (ROOT / "benchmark" / "configs").glob("*.json"):
        conf = json.loads(f.read_text())
        assert conf["name"] == f.stem
        for k in ("train_step", "eval_pass_k30"):
            assert set(conf["flops"][k]) == {"per_patch", "per_region_pair", "per_bag"}


@pytest.mark.parametrize("traffic", sorted(p.stem for p in
                                            (ROOT / "benchmark" / "traffic").glob("*.json")))
def test_cohort_is_the_same_for_a_seed_and_keeps_the_table(traffic, tmp_path):
    spec = json.loads((ROOT / "benchmark" / "traffic" / f"{traffic}.json").read_text())
    small = dict(spec, patients=spec["patients"][:12])
    a = cohort.make_cohort(small, 2 ** 40 + 3, 16, str(tmp_path / "a"), "cpu")
    b = cohort.make_cohort(small, 2 ** 40 + 3, 16, str(tmp_path / "b"), "cpu")
    c = cohort.make_cohort(small, 7, 16, str(tmp_path / "c"), "cpu")
    assert np.array_equal(a.t, b.t) and all(np.array_equal(x, y) for x, y in zip(a.feats, b.feats))
    # every seed trains the same bags, with other features
    assert np.array_equal(a.sizes, c.sizes) and not np.array_equal(a.feats[0], c.feats[0])
    assert [f.shape[0] for f in a.feats] == list(a.sizes)
    # the label table: one row a slide, the table's t and e, the ratio over
    # the table's longest follow-up
    rows = list(csv.DictReader(open(a.label_path)))
    pats = small["patients"]
    assert len(rows) == sum(p[1] for p in pats) + 1
    assert a.pids == [p[0] for p in pats] and list(a.e) == [p[3] for p in pats]
    assert np.allclose(a.t, [p[2] / spec["t_max_row"][2] for p in pats])
    # the whole split: every bag is its slides' sum, and the law's median
    sizes = cohort.bag_sizes(spec)
    law = spec["slide_law"]
    slides = cohort.slide_sizes(law, sum(p[1] for p in spec["patients"]))
    assert sizes.sum() == slides.sum() and len(sizes) == len(spec["patients"])
    assert abs(np.median(slides) - law["median"]) <= law["multiple"]


def test_lognormal_law_median_and_clip():
    law = {"kind": "lognormal", "median": 3360, "sigma": 1.0, "min": 256, "max": 32768,
           "multiple": 16}
    s = cohort.slide_sizes(law, 64)
    assert abs(np.median(s) - 3360) <= 160 and s.max() == 32768 and s.min() >= 256
    assert 5000 < s.mean() < 5700
    assert all(n % 16 == 0 for n in s)


def test_harness_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); import runpy;"
            "import benchmark.run, benchmark.harness, benchmark.calibrate, benchmark.faults;"
            "from benchmark import harness;"
            "from advmil_tpu_torch.train.handler import AdvHandler;"
            "import advmil_tpu_torch.data.bags, advmil_tpu_torch.ops.attention;"
            "[harness.metric_reader(m['name']) for m in __import__('json').load("
            "open(%r))['per_layer']];"
            "print(harness.forbidden_modules())" % (str(ROOT), str(ROOT / "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
