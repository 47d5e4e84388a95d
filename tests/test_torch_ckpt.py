"""The JAX package's checkpoints in the port (ROADMAP A1), model statistics
(A16) and `log_plot` (A9), against advmil_tpu on the CPU.

- The port's msgpack decoder (`utils/flax_msgpack.py`), leaf for leaf against
  `flax.serialization.msgpack_restore` on files the JAX package writes (f32,
  bf16 and int leaves, a numpy scalar, an optimizer state with
  `inject_hyperparams`, a chunked array through a patched MAX_CHUNK_SIZE).
- Test mode from a JAX run directory (`test_load_path`) at cfg_nlst width,
  both handlers: the port's predictions within 1e-5 of the JAX exec_test's.
- `resume_model` from a JAX checkpoint (taken after one step, with the
  injected learning rate halved), then one f32 step on one batch: every
  parameter within 1e-5 of the JAX step from the same state. The port's own
  checkpoint resumes bit for bit; a flattened optimizer state and other
  optimizers raise before anything is loaded.
- `advmil_tpu_torch.stats`: parameter counts equal `advmil_tpu.stats`'s in
  every mode, FLOPs equal the closed-form count of the products.
- `log_plot`: the adversarial test mode writes each split's PNG, and the
  port's figure has the JAX figure's histogram heights.

Dropout and noise are off on both sides (JAX `mask_dropout` patched to the
identity while the JAX runs trace, port `set_dropout_rates(model, 0)`,
`gen_noi_noise: 0-0`), as in tests/test_torch_train.py.
"""
import csv
import os
import os.path as osp

import numpy as np
import optax
import pytest
import torch
from flax import serialization

from advmil_tpu.config import with_defaults as j_with_defaults
from advmil_tpu.models import layers as jlayers
from advmil_tpu.train import checkpoint as jckpt
from advmil_tpu.train.optim import create_optimizer as j_create_optimizer
from advmil_tpu_torch import bridge
from advmil_tpu_torch.config import with_defaults
from advmil_tpu_torch.data.bags import BucketBatcher, prepare_dataset
from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
from advmil_tpu_torch.main import handler_class
from advmil_tpu_torch.main import main as port_main
from advmil_tpu_torch.models import layers as tl
from advmil_tpu_torch.train import checkpoint as tckpt
from advmil_tpu_torch.utils import flax_msgpack
from tests.test_torch_baseline import _cfg as base_cfg
from tests.test_torch_train import _cfg as adv_cfg, _np_tree, _write_yaml

LR = 0.00008
# cfg_nlst.yaml / cfg_nlst_base.yaml widths
WIDTH = {"adv": dict(bcb_dims="1024-384-384", gen_dims="384-1", disc_netx_in_dim=1024,
                     disc_netx_out_dim=128, disc_nety_hid_dims="64-128", opt_netG_lr=LR),
         "base": dict(bcb_mode="abmil", bcb_dims="1024-384-384", pdh_dims="384-1",
                      opt_net_lr=LR)}


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _same_leaves(got, want):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for k in w:
        a, b = g[k], w[k]
        if isinstance(a, torch.Tensor):           # bfloat16
            assert a.dtype == torch.bfloat16 and str(b.dtype) == "bfloat16", k
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32),
                                          err_msg=str(k))
            continue
        assert type(a) is type(b), (k, type(a), type(b))
        if isinstance(b, (np.ndarray, np.generic)):
            assert a.dtype == b.dtype and np.shape(a) == np.shape(b), k
            np.testing.assert_array_equal(a, b, err_msg=str(k))
        else:
            assert a == b, k


def _jax_tree():
    import jax.numpy as jnp
    params = {"Dense_0": {"kernel": np.linspace(-1, 1, 24, dtype=np.float32).reshape(4, 6),
                          "bias": np.zeros(6, np.float32)},
              "LayerNorm_0": {"scale": jnp.ones(6, jnp.bfloat16) * 1.5},
              "t": np.asarray([0.5], np.float32)}
    tx = optax.inject_hyperparams(lambda learning_rate: j_create_optimizer(
        "adam", learning_rate, weight_decay=5e-4, params=params, flatten=False))(
        learning_rate=LR)
    return {"params": params, "opt_state": tx.init(params),
            "ints": np.arange(7, dtype=np.int32), "scalar": np.float32(2.5),
            "count": np.int64(-3), "flags": [True, None, "x" * 40]}


@pytest.mark.parametrize("chunk", [None, 64])
def test_decoder_matches_flax_restore(tmp_path, monkeypatch, chunk):
    """A tree written by the JAX package's `save_checkpoint` (and, chunked,
    by `msgpack_serialize` with MAX_CHUNK_SIZE 64 bytes: every array over 64
    bytes in pieces) decodes to flax's leaves: same types, dtypes, shapes
    and values."""
    tree = _jax_tree()
    path = str(tmp_path / "t.ckpt")
    if chunk:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        tree["big"] = np.arange(100, dtype=np.float32).reshape(10, 10)
        with open(path, "wb") as f:
            f.write(serialization.msgpack_serialize(serialization.to_state_dict(tree)))
    else:
        jckpt.save_checkpoint(path, 3, tree["params"], tree["opt_state"])
    with open(path, "rb") as f:
        data = f.read()
    if chunk:
        assert b"__msgpack_chunked_array__" in data
    _same_leaves(flax_msgpack.msgpack_restore(data), serialization.msgpack_restore(data))


def test_checkpoint_formats(tmp_path):
    """restore_checkpoint tells the format from the first bytes: a JAX file
    gives the bridged state_dict and a FlaxOptState; the port's own file is
    read as before; a directory that is not an orbax checkpoint names what
    it lacks; other bytes raise."""
    tree = _jax_tree()
    jpath = str(tmp_path / "j.ckpt")
    jckpt.save_checkpoint(jpath, 3, tree["params"], tree["opt_state"])
    epoch, sd, opt = tckpt.restore_checkpoint(jpath)
    assert epoch == 3 and isinstance(opt, tckpt.FlaxOptState)
    assert set(sd) == {"Dense_0.weight", "Dense_0.bias", "LayerNorm_0.weight", "t"}
    np.testing.assert_array_equal(sd["Dense_0.weight"].numpy(),
                                  tree["params"]["Dense_0"]["kernel"].T)
    assert sd["LayerNorm_0.weight"].dtype == torch.float32
    assert float(opt["hyperparams"]["learning_rate"]) == np.float32(LR)
    tpath = str(tmp_path / "t.ckpt")
    tckpt.save_checkpoint(tpath, 4, sd, {"state": {}, "param_groups": []})
    epoch, sd2, opt2 = tckpt.restore_checkpoint(tpath)
    assert epoch == 4 and opt2 == {"state": {}, "param_groups": []}
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    with pytest.raises(ValueError, match="not an orbax checkpoint.*lacks _METADATA and "
                                         "manifest.ocdbt"):
        tckpt.restore_checkpoint(str(tmp_path))
    with open(str(tmp_path / "bad.ckpt"), "wb") as f:
        f.write(b"\x00\x01junk")
    with pytest.raises(ValueError, match="neither"):
        tckpt.restore_checkpoint(str(tmp_path / "bad.ckpt"))


# ---------------------------------------------------------------------------
# JAX runs at cfg_nlst width: test mode and resume
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt_data"))
    return make_synthetic_dataset(root, n_patients=36, dim=1024, min_regions=2,
                                  max_regions=8, seed=11, feat_format="pt")


def _make(handler, synth, tmp, name, **o):
    make = adv_cfg if handler == "adv" else base_cfg
    return make(synth, tmp, name, **dict(WIDTH[handler], **o))


def _batches(cfg, n):
    ds = prepare_dataset([f"P{i:04d}" for i in range(36)], with_defaults(dict(cfg)))
    return list(BucketBatcher(ds, token_budget=2048).epoch_batches())[:n]


def _jax_dev(batch):
    return {"feats": batch.feats, "mask": batch.mask, "label": batch.label,
            "sample_mask": batch.sample_mask, "visible": np.ones_like(batch.sample_mask)}


def _nets(handler, h):
    """{name: (module, optimizer, config optimizer name)} of a port handler."""
    if handler == "adv":
        return {"G": (h.gen_model, h.opt_G, h.cfg["opt_netG"]),
                "D": (h.disc_model, h.opt_D, "adam")}
    return {"net": (h.model, h.opt, h.cfg["opt_net"])}


def _jax_params(handler, jh):
    if handler == "adv":
        return {"G": jh.state.params_G, "D": jh.state.params_D}
    return {"net": jh.state.params}


def _jax_step_save(handler, jh, batches):
    """One step on batch 0, the injected learning rate halved,
    `save_model(1, "best")`; (parameters saved, parameters after a step on
    batch 1)."""
    jh.state, _, _ = jh.train_step(jh.state, jh._ship(_jax_dev(batches[0])))
    jh._set_lr(LR * 0.5)
    jh.save_model(1, "best", "train")
    saved = {k: _np_tree(v) for k, v in _jax_params(handler, jh).items()}
    jh.state, _, _ = jh.train_step(jh.state, jh._ship(_jax_dev(batches[1])))
    return saved, {k: bridge.flax_to_torch(_np_tree(v))
                   for k, v in _jax_params(handler, jh).items()}


@pytest.fixture(scope="module")
def jax_runs(synth, tmp_path_factory):
    """Per handler, from a JAX handler (opt_flatten: false): one step on
    batch 0, the injected learning rate halved, `save_model(1, "best")`
    into its run directory, then the parameters after a step on batch 1;
    and the JAX test mode from that directory. Then the same run at the JAX
    defaults (`opt_flatten` unset: one fused moment vector) into a run
    directory of its own (`default`), without test mode."""
    from advmil_tpu.train.baseline import BaselineHandler as JBase
    from advmil_tpu.train.handler import AdvHandler as JAdv
    tmp = tmp_path_factory.mktemp("ckpt_runs")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "mask_dropout", lambda rng, rate, x: x)
        for handler, jcls in (("adv", JAdv), ("base", JBase)):
            cfg = _make(handler, synth, tmp, f"jax_{handler}", rng_impl="threefry",
                        opt_flatten=False)
            batches = _batches(cfg, 3)
            saved, stepped = _jax_step_save(handler, jcls(j_with_defaults(dict(cfg))),
                                            batches)
            test_cfg = dict(cfg, test=True, test_load_path=cfg["save_path"],
                            test_save_path=str(tmp / f"jax_{handler}-test-{{}}-{{}}"))
            jt = jcls(j_with_defaults(test_cfg)).exec_test()
            dcfg = _make(handler, synth, tmp, f"jax_{handler}_default", rng_impl="threefry")
            dsaved, dstepped = _jax_step_save(handler, jcls(j_with_defaults(dict(dcfg))),
                                              batches)
            out[handler] = {"cfg": cfg, "batches": batches, "saved": saved,
                            "stepped": stepped, "jax_test": jt,
                            "jax_test_dir": str(tmp / f"jax_{handler}-test-0.8-0"
                                                if handler == "adv"
                                                else tmp / f"jax_{handler}-test-0.0-0"),
                            "default": {"cfg": dcfg, "saved": dsaved, "stepped": dstepped},
                            "tmp": tmp}
    return out


def _read_pred(path):
    with open(path) as f:
        return {r["patient_id"]: float(r["pred_t"]) for r in csv.DictReader(f)}


@pytest.mark.parametrize("handler", ["adv", "base"])
def test_exec_test_from_jax_run_directory(jax_runs, synth, tmp_path, handler):
    """`test_load_path` names the JAX run directory; the port's CLI on the
    CPU evaluates its `.ckpt` files: the prediction CSV within 1e-5 of the
    JAX exec_test's, the C-index within 1e-6. The adversarial run also
    draws `log_plot`'s histograms: one PNG for the split."""
    run = jax_runs[handler]
    cfg = dict(run["cfg"], test=True, device="cpu", test_load_path=run["cfg"]["save_path"],
               test_save_path=str(tmp_path / "port-test-{}-{}"), log_plot=True)
    del cfg["rng_impl"], cfg["opt_flatten"]
    yaml_path = str(tmp_path / "port.yaml")
    _write_yaml(yaml_path, cfg)
    [(th, tm)] = port_main(["--config", yaml_path, "--handler", handler])
    assert th.device.type == "cpu"
    name = "test_mode_best_pred_exec-test.csv"
    jp = _read_pred(osp.join(run["jax_test_dir"], name))
    tp = _read_pred(osp.join(th.save_dir, name))
    assert sorted(tp) == sorted(jp) and len(tp) > 0 and np.ptp(list(tp.values())) > 0
    np.testing.assert_allclose([tp[k] for k in sorted(jp)], [jp[k] for k in sorted(jp)],
                               atol=1e-5)
    assert abs(dict(tm["exec-test"])["cindex"]
               - dict(run["jax_test"]["exec-test"])["cindex"]) <= 1e-6
    png = osp.join(th.save_dir, f"{osp.basename(th.save_dir)}_bestckpt_test_mode_"
                                f"exec-test_chart.png")
    assert osp.exists(png) == (handler == "adv"), png
    if handler == "adv":
        with open(png, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _port_handler(handler, run, **o):
    """A port handler on the CPU whose save_path is the JAX run's directory
    (resume_model reads from save_path, as the JAX handler's), dropout off."""
    cfg = dict(run["cfg"], device="cpu", **o)
    cfg.pop("opt_flatten", None)
    del cfg["rng_impl"]
    h = handler_class(handler)(with_defaults(cfg))
    for m, _, _ in _nets(handler, h).values():
        tl.set_dropout_rates(m, 0.0)
    return h


def _step(h, batch):
    return h.train_step(h._ship(batch, train=True), h.train_rngs)


@pytest.mark.parametrize("handler", ["adv", "base"])
def test_resume_from_jax_checkpoint_then_step(jax_runs, handler):
    """resume_model from the JAX `.ckpt`: the saved parameters exactly, the
    Adam moments and count in torch's layout, the halved learning rate;
    then one f32 step on batch 1 within 1e-5 of the JAX step. Then the
    port's own checkpoint of that state resumes bit for bit: a second
    handler resumed from it takes the same next step to the last bit."""
    run = jax_runs[handler]
    h = _port_handler(handler, run)
    h.resume_model("best", "train")
    for net, (m, opt, _) in _nets(handler, h).items():
        want = bridge.flax_to_torch(run["saved"][net])
        for k, v in m.state_dict().items():
            assert torch.equal(v, want[k]), (net, k)
        lr = np.float32(LR if net == "D" else LR * 0.5)   # D's is not injected
        assert all(g["lr"] == lr for g in opt.param_groups), net
        # the moments, read here by flax: optax's chain entry that holds them
        fname = f"train_model{'' if net == 'net' else net}-best.ckpt"
        with open(osp.join(run["cfg"]["save_path"], fname), "rb") as f:
            jopt = serialization.msgpack_restore(f.read())["opt_state"]
        jopt = jopt.get("inner_state", jopt)
        adam = next(v for v in jopt.values() if v.get("mu") is not None)
        moments = {"exp_avg": bridge.flax_to_torch(adam["mu"]),
                   "exp_avg_sq": bridge.flax_to_torch(adam["nu"])}
        st = opt.state
        for k, p in m.named_parameters():
            assert float(st[p]["step"]) == 1.0 == float(adam["count"]), k
            for name, want in moments.items():
                assert torch.equal(st[p][name], want[k]), (net, k, name)
    _step(h, run["batches"][1])
    for net, (m, _, _) in _nets(handler, h).items():
        want = run["stepped"][net]
        for k, v in m.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                       err_msg=f"{net} {k}")

    h.save_model(2, "last", "port")
    h2 = _port_handler(handler, run)
    h2.resume_model("last", "port")
    for a, b in zip(_nets(handler, h).values(), _nets(handler, h2).values()):
        for (k, v), (_, w) in zip(a[0].state_dict().items(), b[0].state_dict().items()):
            assert torch.equal(v, w), k
    _step(h, run["batches"][2])
    _step(h2, run["batches"][2])
    for a, b in zip(_nets(handler, h).values(), _nets(handler, h2).values()):
        for (k, v), (_, w) in zip(a[0].state_dict().items(), b[0].state_dict().items()):
            assert torch.equal(v, w), k


@pytest.mark.parametrize("handler", ["adv", "base"])
def test_resume_at_jax_defaults_then_step(jax_runs, handler):
    """A JAX run at its defaults (`opt_flatten` unset) saves Adam's moments
    of G, D and the baseline's net as one fused vector each; resume_model
    maps them (split by the leaves' sizes in tree_leaves order) and the
    halved learning rate, and the next f32 step on batch 1 is within 1e-5 of
    the JAX step from the same state."""
    run = dict(jax_runs[handler], **jax_runs[handler]["default"])
    h = _port_handler(handler, run)
    h.resume_model("best", "train")
    for net, (m, opt, _) in _nets(handler, h).items():
        fname = f"train_model{'' if net == 'net' else net}-best.ckpt"
        with open(osp.join(run["cfg"]["save_path"], fname), "rb") as f:
            jopt = serialization.msgpack_restore(f.read())["opt_state"]
        jopt = jopt.get("inner_state", jopt)
        adam = next(v for v in jopt.values() if v.get("mu") is not None)
        n = sum(p.numel() for p in m.parameters())
        assert np.shape(adam["mu"]) == (n,) == np.shape(adam["nu"]), net
        lr = np.float32(LR if net == "D" else LR * 0.5)   # D's is not injected
        assert all(g["lr"] == lr for g in opt.param_groups), net
        got = np.concatenate([opt.state[p]["exp_avg"].numpy().ravel() for p in m.parameters()])
        assert np.abs(got).sum() == pytest.approx(np.abs(adam["mu"]).sum(), rel=1e-6), net
    _step(h, run["batches"][1])
    for net, (m, _, _) in _nets(handler, h).items():
        want = run["stepped"][net]
        for k, v in m.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                       err_msg=f"{net} {k}")


def _write_jax_ckpt(path, params, opt_name, flatten):
    """A JAX package checkpoint of `params` with an `opt_name` state after
    one update (gradient: the parameters / 10), built as the JAX handler
    builds G's (inject_hyperparams, coupled L2); returns the state."""
    import jax
    tx = optax.inject_hyperparams(lambda learning_rate: j_create_optimizer(
        opt_name, learning_rate, weight_decay=5e-4, params=params, flatten=flatten))(
        learning_rate=LR)
    grads = jax.tree_util.tree_map(lambda p: p / 10, params)
    _, state = jax.jit(tx.update)(grads, tx.init(params), params)
    jckpt.save_checkpoint(path, 1, params, state)
    return state


@pytest.mark.parametrize("case", ["opt_flatten", "jax_momentum", "port_radam"])
def test_resume_refusals_raise_before_loading(jax_runs, tmp_path, case):
    """Once refused, now resumed: a JAX checkpoint with one fused moment
    vector (opt_flatten: true), one of momentum's state (its trace) into a
    port run of momentum, and a JAX Adam state into a port run of RAdam
    (the same layout; the config's name decides). G's and D's parameters
    load, and each mapped per-parameter field equals the JAX state's leaf
    for leaf (the fused vector against the same update's unflattened
    state)."""
    run = jax_runs["adv"]
    save = str(tmp_path / "run")
    opt_name = "momentum" if case == "jax_momentum" else "adam"
    states = {net: _write_jax_ckpt(osp.join(save, f"train_model{net}-best.ckpt"),
                                   run["saved"][net], opt_name if net == "G" else "adam",
                                   flatten=case == "opt_flatten")
              for net in ("G", "D")}
    port_name = {"jax_momentum": "momentum", "port_radam": "radam"}.get(case, "adam")
    h = _port_handler("adv", run, save_path=save, opt_netG=port_name)
    h.resume_model("best", "train")
    fields = {"adam": {"exp_avg": "mu", "exp_avg_sq": "nu"}, "radam": {"mu": "mu", "nu": "nu"},
              "momentum": {"trace": "trace"}}[port_name]
    m, opt = h.gen_model, h.opt_G
    want_sd = bridge.flax_to_torch(run["saved"]["G"])
    for k, v in m.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    entry = serialization.to_state_dict(states["G"])["inner_state"]["1"]
    if case == "opt_flatten":        # the same update unflattened: the per-leaf reference
        assert np.ndim(entry["mu"]) == 1
        entry = serialization.to_state_dict(_write_jax_ckpt(
            str(tmp_path / "twin.ckpt"), run["saved"]["G"], opt_name, False))["inner_state"]["1"]
    moved = 0.0
    for field, jfield in fields.items():
        want = bridge.flax_to_torch(_np_tree(entry[jfield]))
        for k, p in m.named_parameters():
            np.testing.assert_allclose(opt.state[p][field].numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-12, err_msg=f"{field} {k}")
            moved = max(moved, float(want[k].abs().max()))
    assert moved > 0
    first = opt.state[next(iter(m.parameters()))]
    assert float(first["step" if port_name == "adam" else "count"]) == 1.0
    assert all(g["lr"] == np.float32(LR) for g in opt.param_groups)


def test_resume_unrecognised_state_raises_before_loading(jax_runs, tmp_path):
    """A state of another structure than the port's optimizer needs (a JAX
    momentum trace for a port run of Adam) raises, naming the optimizer and
    what it found, and the model keeps its parameters (nothing was loaded)."""
    run = jax_runs["adv"]
    save = str(tmp_path / "run")
    for net in ("G", "D"):
        _write_jax_ckpt(osp.join(save, f"train_model{net}-best.ckpt"), run["saved"][net],
                        "momentum" if net == "G" else "adam", flatten=True)
    h = _port_handler("adv", run, save_path=save)
    before = {k: v.clone() for k, v in h.gen_model.state_dict().items()}
    with pytest.raises(ValueError, match="'adam'.*found.*trace"):
        h.resume_model("best", "train")
    for k, v in h.gen_model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# model statistics
# ---------------------------------------------------------------------------

def _products(mode, dims, n, B, heads_flops=True):
    """Closed-form forward FLOPs of the products (2 per multiply-add) of the
    stats model: Generator(noise 0-1, one hop) over the backbone."""
    C, D = dims[0], dims[1]
    L, K = n // 16, 8
    dense = lambda rows, i, o: 2 * B * rows * i * o          # noqa: E731
    head = dense(1, D, D // 2) + dense(1, D, 1)              # D -> D/2, [h, noise] -> 1
    gate = lambda rows: 2 * dense(rows, D, D) + dense(rows, D, 1)   # noqa: E731
    pool = lambda rows: 2 * B * rows * D                     # noqa: E731 sum_n a_n x_n
    if mode == "patch":     # embedding, 1 encoder layer (ffn D), GAPool
        enc = (dense(L, D, 3 * D) + 2 * (2 * B * L * L * D) + dense(L, D, D)
               + 2 * dense(L, D, D))
        return dense(n, C, D) + enc + 2 * dense(L, D, D) + dense(L, D, 1) + pool(L) + head
    if mode == "abmil":
        return dense(n, C, D) + gate(n) + pool(n) + dense(1, D, D) + head
    if mode == "cluster":   # phis, per-cluster sums, attn_fc, gate, pool over K
        return (dense(n, C, D) + 2 * B * n * K * D + dense(K, D, D) + gate(K) + pool(K)
                + head)
    if mode == "graph":     # fc, one GENConv's MLP (D -> 2D -> D), path_phi, gate
        return (dense(n, C, D) + dense(n, D, 2 * D) + dense(n, 2 * D, D)
                + dense(n, 2 * D, D) + gate(n) + pool(n) + head)
    raise ValueError(mode)


@pytest.mark.parametrize("mode", ["patch", "abmil", "cluster", "graph"])
def test_stats_match_jax(mode, capsys):
    """Parameter counts equal `advmil_tpu.stats.backbone_stats`'s; the
    port's FLOPs equal the closed-form count of the products. XLA's count,
    printed beside it, is larger: XLA counts elementwise operations
    (activations, LayerNorm, softmax, the masks) as well."""
    from advmil_tpu.stats import backbone_stats as jstats
    from advmil_tpu_torch import stats
    dims, n, B = [96, 64, 64], 200, 2
    got = stats.backbone_stats(mode, dims, n, batch=B)
    want = jstats(mode, dims, n, batch=B)
    assert got["n_patches"] == want["n_patches"] == 208
    assert got["params"] == want["params"]
    assert got["flops_forward"] == _products(mode, dims, 208, B)
    assert want["flops_forward"] > got["flops_forward"]
    print(f"{mode}: params {got['params']}, port FLOPs {got['flops_forward']:.0f}, "
          f"XLA FLOPs {want['flops_forward']:.0f} (elementwise operations counted)")
    out = stats.main(["--mode", mode, "--dims", "96-64-64", "--n", "200", "--batch", "2",
                      "--device", "cpu"])
    assert out == got
    assert f"params={got['params'] / 1e6:.3f}M" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# log_plot
# ---------------------------------------------------------------------------

def test_log_plot_histograms_match_jax():
    """The port's `plot_time_kde` and the JAX package's on the same y and
    y_hat: three panels, and in each the bars' heights and edges equal."""
    import matplotlib.pyplot as plt
    from advmil_tpu.utils.func import plot_time_kde as jplot
    from advmil_tpu_torch.utils.func import plot_time_kde as tplot
    rng = np.random.default_rng(3)
    y = np.stack([rng.uniform(0.05, 1.0, 64), (rng.uniform(size=64) < 0.4)], 1)
    y_hat = rng.uniform(0.0, 1.0, (64, 1)).astype(np.float32)
    tfig, jfig = tplot(y, y_hat), jplot(y, y_hat)
    assert len(tfig.axes) == len(jfig.axes) == 3
    for ta, ja in zip(tfig.axes, jfig.axes):
        assert ta.get_title() == ja.get_title()
        th = [(p.get_x(), p.get_height()) for p in ta.patches]
        jh = [(p.get_x(), p.get_height()) for p in ja.patches]
        assert len(th) == 200 and th == jh
    plt.close(tfig)
    plt.close(jfig)


def test_log_plot_without_matplotlib_raises(monkeypatch, tmp_path):
    """Where matplotlib cannot be imported, `log_plot: True` raises at the
    config check and names it; the baseline handler, which draws nothing
    (as in JAX), does not ask for it."""
    import sys
    from advmil_tpu_torch.config import check_configs
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    paths = {k: str(tmp_path) for k in ("path_patch", "path_label", "data_split_path",
                                        "path_graph", "path_cluster")}
    with pytest.raises(ImportError, match="matplotlib"):
        check_configs(with_defaults(adv_cfg(paths, tmp_path, "a", device="cpu",
                                            log_plot=True)))
    check_configs(with_defaults(base_cfg(paths, tmp_path, "b", device="cpu", log_plot=True)),
                  "base")


# ---------------------------------------------------------------------------
# the committed fixture that chip_smoke.py phase 38 reads on the card
# ---------------------------------------------------------------------------

def test_chip_smoke_jax_fixture_phase_on_cpu(monkeypatch, tmp_path, capsys):
    """`chip_smoke.phase_jax_ckpt` with `device: cpu`: the committed JAX runs
    (`scripts/make_jax_ckpt_fixture.py`) evaluated and resumed by the port
    within the phase's 1e-4 of the committed JAX numbers, with no JAX in the
    phase's path: the Adam pair, the JAX defaults' fused moments, lookahead
    under accumulation, and the baseline with sgd, adamp and AdaHessian;
    then the orbax twins of the Adam pair and the fused run, read as their
    msgpack runs bit for bit, the pair's test mode and both resumed steps.
    The Adam pair and the dataset stay under 1 MB, and so do the other
    msgpack runs together, and the orbax twins together."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "WORK_DIR", str(tmp_path))
    runs = chip_smoke.JAX_ADV_RUNS + ("base_opts",)
    size = lambda root: sum(osp.getsize(osp.join(d, f))   # noqa: E731
                            for d, _, fs in os.walk(root) for f in fs)
    added = sum(size(osp.join(chip_smoke.JAX_FIXTURE, r)) for r in runs)
    orbax = size(osp.join(chip_smoke.JAX_FIXTURE, "orbax"))
    assert 0 < size(chip_smoke.JAX_FIXTURE) - added - orbax <= 1 << 20
    assert 0 < added <= 1 << 20 and 0 < orbax <= 1 << 20
    launches = chip_smoke.phase_jax_ckpt("cpu", device="cpu")
    assert set(launches) == {"test", "step", "orbax_test", "orbax_step"}
    out = capsys.readouterr().out
    assert "[38 jax checkpoint] cpu" in out
    subs = runs[:-1] + tuple(f"base_opts/{o}" for o in chip_smoke.JAX_BASE_OPTS)
    for sub in subs + tuple(f"orbax/{t}" for t in chip_smoke.JAX_ORBAX_TWINS):
        assert f"[38 jax checkpoint {sub}] cpu" in out, sub
    assert "[38 jax checkpoint orbax] cpu: libzstd" in out


def test_chip_smoke_full_width_flat_resume_on_cpu(monkeypatch, tmp_path, capsys):
    """`chip_smoke.phase_jax_flat_full` on the CPU at a narrow width: G's
    and D's Adam state laid out as `optax.flatten` lays it out (numpy, in
    the script), resumed through the bridge in a fresh handler, and its next
    step equal to the uninterrupted one within the spread of two
    uninterrupted steps (0 here). The layout is the JAX package's: the JAX
    optimizers' flattened state has the same structure and shapes."""
    import jax
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "WORK_DIR", str(tmp_path))
    paths = make_synthetic_dataset(str(tmp_path / "data"), n_patients=14, dim=32,
                                   min_regions=2, max_regions=6, seed=4, feat_format="pt")
    over = dict(bcb_dims="32-64-64", gen_dims="64-1", disc_netx_in_dim=32,
                disc_netx_out_dim=32, disc_nety_hid_dims="16-32", precision="f32",
                batch_token_budget=256, bucket_min=32)
    chip_smoke.phase_jax_flat_full(paths, "cpu", device="cpu",
                                   pids=[f"P{i:04d}" for i in range(14)], **over)
    assert "resumed in a fresh handler" in capsys.readouterr().out
    # the layout against the JAX package's own flattened Adam, on a small tree
    params = {"b": {"kernel": np.ones((3, 2), np.float32)}, "a": {"bias": np.ones(2, np.float32)}}
    model = torch.nn.Module()
    for name, sd in (("b", {"weight": torch.ones(2, 3)}), ("a", {"bias": torch.ones(2)})):
        sub = torch.nn.Module()
        for k, v in sd.items():
            sub.register_parameter(k, torch.nn.Parameter(v))
        model.add_module(name, sub)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    for inject in (None, LR):
        mine = chip_smoke._optax_flat_adam(model, opt, inject)
        if inject is None:
            tx = j_create_optimizer("adam", LR, betas=(0.9, 0.999))
        else:
            tx = optax.inject_hyperparams(lambda learning_rate: j_create_optimizer(
                "adam", learning_rate, weight_decay=5e-4, params=params))(learning_rate=LR)
        theirs = serialization.to_state_dict(tx.init(params))
        shapes = lambda t: jax.tree_util.tree_map(np.shape, t)   # noqa: E731
        assert shapes(mine) == shapes(theirs), (shapes(mine), shapes(theirs))
