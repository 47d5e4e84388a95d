"""The configurations' operation counts held to torch's FlopCounterMode over
the reference, at small bag sizes."""
import json
from pathlib import Path

import pytest

from advmil_tpu_torch.config import with_defaults
from advmil_tpu_torch.train.handler import build_models
from benchmark.reference import flops
from benchmark.roofline import step_flops

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name", ["esat_nlst"])
@pytest.mark.parametrize("kind", ["train", "eval"])
def test_flop_coefficients_match_the_counter(name, kind):
    conf = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    cfg = with_defaults(dict(conf["config"], device="cpu"))
    g, d = build_models(cfg)
    sg = {k: v.shape for k, v in g.named_parameters()}
    sd = {k: v.shape for k, v in d.named_parameters()}
    coef = conf["flops"]["train_step" if kind == "train" else "eval_pass_k30"]
    for n in (256, 512, 1024):
        assert flops.count(cfg, sg, sd, n, kind) == step_flops(coef, n)
