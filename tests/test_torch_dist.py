"""Multi-process runs of advmil_tpu_torch end to end on the CPU (the
counterpart of tests/test_dist.py): a 2-epoch `exec` of each handler over
two gloo ranks spawned by the port's own launcher, against the port's
single-process `exec` of the same config; the process-group helpers, the
config checks of the parallel keys, and the dry run.

The configs keep the default `flash_min_len`, so at these bag sizes the
attention takes its plain branch and every random draw (dropout masks,
noise) comes from the generators every rank shares, drawn at the global
shape and cut to the rank's rows: the two-rank run then computes what the
single-process run computes, up to the order of its sums.
"""
import ast
import json
import os
import os.path as osp
import re

import pytest
import torch

from advmil_tpu_torch.config import check_configs, with_defaults
from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
from advmil_tpu_torch.main import handler_class, launch_ranks, main, run_one
from advmil_tpu_torch.parallel import comm, dist, launch, mesh
from tests.test_torch_baseline import _cfg as base_cfg
from tests.test_torch_train import _cfg as adv_cfg, _write_yaml

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_data"))
    return make_synthetic_dataset(root, n_patients=36, dim=64, min_regions=4,
                                  max_regions=16, seed=5, feat_format="pt", with_graph=True)


def _cfgs(synth, tmp_path, handler):
    if handler == "adv":
        make = lambda name, **o: adv_cfg(synth, tmp_path, name, device="cpu",  # noqa: E731
                                         gen_noi_noise="0-1", times_test_sample=3, **o)
    else:
        make = lambda name, **o: base_cfg(synth, tmp_path, name, device="cpu",  # noqa: E731
                                          bcb_dims="64-64-64", pdh_dims="64-1", **o)
    return make("single"), make("ranks", dp_devices=2)


def _metrics_lines(text):
    return [line for line in text.splitlines() if line.startswith("[INFO] Metrics:")]


def _close(got, want, atol=1e-4):
    assert set(got) == set(want)
    for split in want:
        g, w = dict(got[split]), dict(want[split])
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - w[k]) <= atol, (split, k, g[k], w[k])


def _scalars(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("handler", ["adv", "base"])
def test_two_rank_exec_matches_single_process(synth, tmp_path, capfd, handler):
    """dp_devices: 2 over two spawned ranks: the same metrics on both ranks,
    within 1e-4 of the single-process run; checkpoints, prediction CSVs and
    the scalars log written once (rank 0), the log line for line as long as
    the single-process one."""
    single, ranks = _cfgs(synth, tmp_path, handler)
    _, want = run_one(handler_class(handler), with_defaults(single))
    capfd.readouterr()
    if handler == "adv":       # through the CLI, which spawns the ranks itself
        yaml_path = str(tmp_path / "ranks.yaml")
        _write_yaml(yaml_path, ranks)
        [(h, got)] = main(["--config", yaml_path, "--handler", "adv"])
        assert h is None
        lines = _metrics_lines(capfd.readouterr().out)
        assert len(lines) == 2 and lines[0] == lines[1], lines
    else:
        per_rank = launch_ranks("base", with_defaults(ranks))
        assert len(per_rank) == 2 and per_rank[0] == per_rank[1]
        got = per_rank[0]
    _close(got, want)
    sdir, rdir = ranks["save_path"], single["save_path"]
    ckpts = (["train_modelG-best.ckpt", "train_modelD-best.ckpt"] if handler == "adv"
             else ["train_model-best.ckpt"])
    for f in ckpts + ["train_best_pred_train.csv", "train_best_pred_test.csv",
                      "print_config.txt", "train_metrics-best.txt"]:
        assert osp.exists(osp.join(sdir, f)), f
    log = _scalars(osp.join(sdir, "ranks_scalars.jsonl"))
    assert len(log) == len(_scalars(osp.join(rdir, "single_scalars.jsonl"))) > 0


@pytest.mark.parametrize("how", ["torchrun", "dist_keys"])
def test_ranks_started_outside_join_their_world(synth, tmp_path, how):
    """The CLI as one rank of a world it did not start: under torchrun
    (`dp_devices: 2`, env://) and under the `dist_*` keys (a multi-host
    world of two processes, the coordinator and the world size from the
    yaml, each rank's id from ADVMIL_PROCESS_ID). Both ranks print the same
    metrics, equal to the single-process run's within 1e-4."""
    import subprocess
    import sys
    single, ranks = _cfgs(synth, tmp_path, "base")
    _, want = run_one(handler_class("base"), with_defaults(single))
    port = launch.free_port()
    if how == "dist_keys":
        ranks = dict(ranks, dp_devices=1, dist_num_processes=2,
                     dist_coordinator=f"127.0.0.1:{port}")
    yaml_path = str(tmp_path / "ranks.yaml")
    _write_yaml(yaml_path, ranks)
    cli = ["-m", "advmil_tpu_torch.main", "--config", yaml_path, "--handler", "base"]
    env = {k: v for k, v in os.environ.items() if not k.startswith("ADVMIL_")}
    env["PYTHONPATH"] = REPO
    if how == "torchrun":
        procs = [subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
             "--master_addr", "127.0.0.1", "--master_port", str(port)] + cli,
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    else:
        procs = [subprocess.Popen([sys.executable] + cli, cwd=REPO,
                                  env=dict(env, ADVMIL_PROCESS_ID=str(r)),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    lines = [ln for o in outs for ln in _metrics_lines(o)]
    assert len(lines) == 2 and lines[0] == lines[1], lines
    assert "dp 2 x inst 1 (gloo, cpu)" in "".join(outs)
    got = ast.literal_eval(lines[0].split("[INFO] Metrics:", 1)[1].strip())
    _close(got, want)


def test_grid_needs_its_ranks(synth, tmp_path):
    """A handler asked for several ranks outside a process group raises;
    with device: cuda, more ranks than visible cards raise before any
    spawn; a world of the wrong size is refused by the grid."""
    single, ranks = _cfgs(synth, tmp_path, "base")
    with pytest.raises(RuntimeError, match="torchrun"):
        handler_class("base")(with_defaults(ranks))
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="visible"):
        launch.default_devices({"device": "cuda"}, n)
    with pytest.raises(RuntimeError, match="visible"):
        launch_ranks("base", with_defaults(dict(ranks, device="cuda", dp_devices=n)))
    assert launch.default_devices({"device": "cpu"}, 3) == ["cpu"] * 3


def test_parallel_config_keys(synth, tmp_path):
    """dp_devices / dist_* pass the checks; inst_devices passes for patch and
    abmil and is refused for graph and cluster, naming ROADMAP A14 rest."""
    single, _ = _cfgs(synth, tmp_path, "adv")
    for over in ({"dp_devices": 4}, {"dist_num_processes": 2, "dist_process_id": 1,
                                     "dist_coordinator": "127.0.0.1:1"},
                 {"dist_init": "auto"}, {"inst_devices": 4},
                 {"inst_devices": 2, "dp_devices": 2}):
        check_configs(with_defaults(dict(single, **over)))
    for mode in ("graph", "cluster"):
        with pytest.raises(NotImplementedError, match=f"A14 rest.*{mode}"):
            check_configs(with_defaults(dict(single, bcb_mode=mode, inst_devices=2)))
    with pytest.raises(ValueError, match="dp_devices"):
        check_configs(with_defaults(dict(single, dp_devices=0)))


def test_single_process_helpers(monkeypatch):
    """Without settings nothing initialises and every helper is the
    single-process identity."""
    for k in ("ADVMIL_DIST_INIT", "ADVMIL_NUM_PROCESSES", "ADVMIL_COORDINATOR",
              "ADVMIL_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert dist.maybe_initialize({}) is False
    assert dist.maybe_initialize({"dist_num_processes": 1}) is False
    assert not dist.multi_host_settings({})
    assert dist.multi_host_settings({"dist_init": "auto"})
    monkeypatch.setenv("ADVMIL_NUM_PROCESSES", "2")
    assert dist.multi_host_settings({})
    assert mesh.row_slice(8) == slice(0, 8) and mesh.inst_slice(8) == slice(0, 8)
    assert dist.is_primary() and not dist.is_multi_process()
    rows = torch.arange(3.0)
    assert comm.gather_rows_nograd(rows) is rows and comm.inst_sum(rows) is rows
    dist.barrier()
    with pytest.raises(ValueError, match="dist_coordinator"):
        dist.maybe_initialize({"dist_num_processes": 2})


def test_dryrun_multichip_on_four_cpu_ranks(capfd):
    from advmil_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(4)
    assert set(out) == {"dp4 patch", "dp4 cluster", "dp4 graph", "dp4 graph_grid",
                        "dp2 x inst2 patch"}
    printed = capfd.readouterr().out
    assert len(re.findall(r"\[dryrun_multichip\] .* ok on 4 ranks", printed)) == 5
