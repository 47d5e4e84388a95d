"""The JAX package's orbax checkpoints (`ckpt_backend: orbax`) in the port,
and `profile_dir`, against their oracles on the CPU.

The port reads orbax directories with its own code: libzstd through ctypes
(`utils/zstd.py`), an OCDBT reader (`utils/ocdbt.py`), a zarr v2 decoder
(`utils/zarr2.py`) and the tree rebuild (`utils/orbax_ckpt.py`). Here,
`zstandard`, `tensorstore` and `orbax` are the oracles:

- (a) the zstd binding byte for byte against `zstandard`'s frames (with and
  without a content size, several blocks, levels 1 and 19, empty), and a
  corrupt frame raising;
- (b) the OCDBT reader against tensorstore's on stores tensorstore writes
  with small node and inline limits (B-trees of height >= 1, values inline
  and in several data files, two commits, a deleted key, long shared key
  prefixes; compressed and not), and a corrupt node raising;
- (c) the zarr decoder against tensorstore's `zarr` arrays over an OCDBT
  store: chunks smaller than the shape, C and F order, a missing chunk read
  as the fill value, a 0-d array, both dimension separators;
- (d) every committed JAX msgpack checkpoint saved again through orbax by
  the JAX package, and the committed orbax twins, read as `flax_msgpack`
  reads the msgpack file: the same keys at every level, dtypes and bits,
  `{}` and `None` included;
- (e) at cfg_nlst width, a JAX run of each handler saved with
  `ckpt_backend: orbax` (`opt_flatten` at its default): the port's test
  mode and resumed step within `tests/test_torch_ckpt.py`'s bounds;
- (f) the refusals, each naming its key: `use_zarr3: true`, `use_ocdbt:
  false`, a directory without `_METADATA`, another zarr compressor, a zarr
  v3 array, and no libzstd (while msgpack and torch files still load);
- (g) `profile_dir`: a 2-epoch adversarial `exec` writes a Chrome trace of
  epoch 2 and the same metrics as without it; the baseline handler writes
  none, as the JAX one.
"""
import ctypes.util
import glob
import json
import os.path as osp
import shutil

import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard

from advmil_tpu.config import with_defaults as j_with_defaults
from advmil_tpu.models import layers as jlayers
from advmil_tpu.train import checkpoint as jckpt
from advmil_tpu_torch import bridge
from advmil_tpu_torch.config import with_defaults
from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
from advmil_tpu_torch.main import main as port_main
from advmil_tpu_torch.train import checkpoint as tckpt
from advmil_tpu_torch.train.baseline import BaselineHandler
from advmil_tpu_torch.train.handler import AdvHandler
from advmil_tpu_torch.utils import flax_msgpack, orbax_ckpt, zarr2, zstd
from advmil_tpu_torch.utils.ocdbt import OcdbtStore
from tests.test_torch_ckpt import (_batches, _jax_params, _make, _nets, _port_handler,
                                   _read_pred, _step)
from tests.test_torch_train import _cfg as adv_cfg, _np_tree, _write_yaml

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "data", "jax_ckpt")


def _same(got, want, where=""):
    """Strict tree equality: dict keys at every level, list lengths, leaf
    types, dtypes, shapes and bits; `{}` and `None` included."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, got, want)
        for k in want:
            _same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{where}/{i}")
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype, where
        assert torch.equal(got, want), where
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


# ---------------------------------------------------------------------------
# (a) zstd
# ---------------------------------------------------------------------------

PAYLOADS = {"empty": 0, "small": 1000, "multi_block": 600_000}


@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("level", [1, 19])
@pytest.mark.parametrize("payload", list(PAYLOADS))
def test_zstd_matches_zstandard(payload, level, content_size):
    """Frames `zstandard` writes (600 KB: several 128 KB blocks) decode to
    the same bytes, with and without the expected size; with no content
    size in the frame header (as tensorstore's zarr chunks) too."""
    rng = np.random.default_rng(PAYLOADS[payload] + level)
    data = (rng.integers(0, 16, PAYLOADS[payload]).astype(np.uint8) * 17).tobytes()
    comp = zstandard.ZstdCompressor(level=level, write_content_size=content_size)
    if content_size:
        frame = comp.compress(data)
    else:                                   # streamed: the size is not known ahead
        obj = comp.compressobj()
        frame = obj.compress(data) + obj.flush()
    header = zstandard.get_frame_parameters(frame)
    assert (header.content_size != zstandard.CONTENTSIZE_UNKNOWN) == content_size
    if payload == "multi_block":
        assert len(frame) > 1000
    assert zstd.decompress(frame) == data
    assert zstd.decompress(frame, len(data)) == data
    assert zstd.decompress(frame + frame) == data + data   # concatenated frames


def test_zstd_corrupt_frames_raise():
    """A frame cut short, a wrong magic number, a damaged block, a size other
    than the one expected, and empty input raise, naming the data."""
    data = bytes(range(256)) * 400
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    with pytest.raises(ValueError, match="chunk x: truncated"):
        zstd.decompress(frame[:-7], what="chunk x")
    with pytest.raises(ValueError, match="corrupt zstd frame"):
        zstd.decompress(b"\x00" + frame[1:])
    bad = bytearray(frame)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(ValueError, match="corrupt zstd frame"):
        zstd.decompress(bytes(bad))
    with pytest.raises(ValueError, match="more than the 100 bytes expected"):
        zstd.decompress(frame, 100)
    with pytest.raises(ValueError, match=f"{len(data)} bytes, {len(data) + 1} expected"):
        zstd.decompress(frame, len(data) + 1)
    with pytest.raises(ValueError, match="empty input"):
        zstd.decompress(b"")


# ---------------------------------------------------------------------------
# (b) the OCDBT reader
# ---------------------------------------------------------------------------

PREFIX = b"opt_state.inner_state.0.mu.backbone.encoder.layers_0.attention.query/"


def _write_store(root, compression):
    """Two commits into an OCDBT store with a 16-byte inline limit and
    300-byte nodes: 60 keys sharing a 70-byte prefix, values of 3-45 bytes
    (inline and in data files); the second commit rewrites every third key,
    adds five and deletes one."""
    config = {"max_inline_value_bytes": 16, "max_decoded_node_bytes": 300,
              "compression": compression}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": config}).result()
    for commit in range(2):
        with ts.Transaction() as txn:
            t = kv.with_transaction(txn)
            for i in range(60 + 5 * commit):
                if commit == 0 or i % 3 == 0 or i >= 60:
                    t[PREFIX + b"%04d/0.0" % i] = bytes([commit, i]) * (2 + i % 22)
        if commit == 1:
            kv.delete_range(ts.KvStore.KeyRange(PREFIX + b"0007/0.0",
                                                PREFIX + b"0007/0.0\x00")).result()
    return kv


@pytest.mark.parametrize("compression", [{"id": "zstd", "level": 5}, None])
def test_ocdbt_reader_matches_tensorstore(tmp_path, compression):
    """The newest version's keys and values equal tensorstore's reader's;
    the tree has height >= 1, values inline and in at least two data files,
    and the second commit's values win."""
    root = str(tmp_path)
    kv = _write_store(root, compression)
    store = OcdbtStore(root)
    want = kv.list().result()
    assert store.keys() == sorted(want) and len(want) == 64
    for k in want:
        assert store.read(k) == kv.read(k).result().value, k
    assert PREFIX + b"0007/0.0" not in store and store.read(PREFIX + b"0003/0.0")[0] == 1
    assert store.height >= 1
    kinds = list(store._values.values())
    assert any(isinstance(v, bytes) for v in kinds)
    assert len({v[0] for v in kinds if not isinstance(v, bytes)}) >= 2


def test_ocdbt_corrupt_node_raises(tmp_path):
    """A flipped byte in a node's region fails its CRC-32C, naming the file;
    a manifest of another magic number raises."""
    root = str(tmp_path)
    _write_store(root, {"id": "zstd", "level": 1})
    rel, offset, _ = OcdbtStore(root).root_node
    with open(osp.join(root, rel), "r+b") as f:
        f.seek(offset + 20)
        b = f.read(1)
        f.seek(offset + 20)
        f.write(bytes([b[0] ^ 0x40]))
    with pytest.raises(ValueError, match=f"{rel} \\[node at {offset}.*CRC-32C mismatch"):
        OcdbtStore(root)
    with open(osp.join(root, "manifest.ocdbt"), "r+b") as f:
        f.write(b"\x0c\xdb\x20\xde")
    with pytest.raises(ValueError, match="manifest.ocdbt: magic 0x0cdb20de"):
        OcdbtStore(root)


# ---------------------------------------------------------------------------
# (c) the zarr decoder
# ---------------------------------------------------------------------------

ZARRS = {
    "c_chunked": dict(dtype="<f4", shape=[5, 7], chunks=[2, 3], order="C"),
    "f_chunked": dict(dtype="<i4", shape=[4, 6, 3], chunks=[3, 4, 2], order="F"),
    "fill_missing": dict(dtype="<f8", shape=[6, 6], chunks=[3, 3], order="C",
                         fill_value=7.5, written=(slice(0, 3), slice(0, 6))),
    "scalar_i8": dict(dtype="<i8", shape=[], chunks=[], order="C"),
    "bool_slash": dict(dtype="|b1", shape=[9], chunks=[4], order="C",
                       dimension_separator="/"),
    "u4_raw": dict(dtype="<u4", shape=[3, 5], chunks=[2, 2], order="F", compressor=None),
}


@pytest.mark.parametrize("name", list(ZARRS))
def test_zarr_decoder_matches_tensorstore(tmp_path, name):
    """Arrays tensorstore writes as zarr v2 into an OCDBT
    store read back equal to tensorstore's reading, dtype for dtype."""
    spec = dict(ZARRS[name])
    written = spec.pop("written", None)
    meta = dict({"compressor": {"id": "zstd", "level": 1}, "fill_value": None}, **spec)
    root = str(tmp_path)
    arr = ts.open({"driver": "zarr", "metadata": meta, "create": True,
                   "kvstore": {"driver": "ocdbt", "base": f"file://{root}/",
                               "path": "params.a.b.kernel/"}}).result()
    rng = np.random.default_rng(1)
    data = (rng.integers(-50, 50, meta["shape"]) if meta["dtype"] != "|b1"
            else rng.integers(0, 2, meta["shape"])).astype(np.dtype(meta["dtype"]))
    if written is None:
        arr.write(data).result()
    else:
        arr[written].write(data[written]).result()
    store = OcdbtStore(root)
    got = zarr2.read_array(store, "params.a.b.kernel")
    want = arr.read().result()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    chunk_keys = [k for k in store.keys() if not k.endswith(b".zarray")]
    if name == "fill_missing":
        assert len(chunk_keys) == 2 and (got[3:] == 7.5).all()
    elif meta["shape"]:
        assert len(chunk_keys) > 1
    else:
        assert chunk_keys == [b"params.a.b.kernel/0"]


# ---------------------------------------------------------------------------
# (d) orbax against msgpack
# ---------------------------------------------------------------------------

MSGPACK = sorted(osp.relpath(p, FIXTURE) for p in glob.glob(
    osp.join(FIXTURE, "**", "*.ckpt"), recursive=True) if osp.isfile(p))
TWINS = {"orbax/adam/run/train_modelG-best.ckpt": "run/train_modelG-best.ckpt",
         "orbax/adam/run/train_modelD-best.ckpt": "run/train_modelD-best.ckpt",
         "orbax/flat/run/train_modelG-best.ckpt": "flat/run/train_modelG-best.ckpt",
         "orbax/flat/run/train_modelD-best.ckpt": "flat/run/train_modelD-best.ckpt"}


def test_fixture_lists():
    """The committed msgpack checkpoints (the Adam pair, flat, lookahead_accum
    and base_opts/*) and the orbax twins the cases below run on."""
    assert len(MSGPACK) == 9 and "base_opts/adahessian/run/train_model-best.ckpt" in MSGPACK
    for twin, src in TWINS.items():
        assert osp.isdir(osp.join(FIXTURE, twin)) and src in MSGPACK


@pytest.mark.parametrize("rel", MSGPACK)
def test_orbax_read_equals_msgpack_read(tmp_path, rel):
    """The JAX package restores the committed msgpack file raw (no
    templates) and saves it with `save_checkpoint_orbax`; the port's orbax
    reader gives `flax_msgpack.read`'s tree of the original, and
    `restore_checkpoint` the same state dict and optimizer state."""
    src = osp.join(FIXTURE, rel)
    out = str(tmp_path / "ckpt")
    jckpt.save_checkpoint_orbax(out, *jckpt.restore_checkpoint(src))
    want = flax_msgpack.read(src)
    _same(orbax_ckpt.read(out), want)
    _same(tckpt.restore_checkpoint(out), tckpt.restore_checkpoint(src))


@pytest.mark.parametrize("twin", list(TWINS))
def test_committed_orbax_twin_equals_msgpack(twin):
    """Each committed orbax twin (written by the JAX handler's own
    `save_model` with `ckpt_backend: orbax`) reads as its msgpack run's
    file, `{}` / `None` slots included; its orbax restore agrees too."""
    got = orbax_ckpt.read(osp.join(FIXTURE, twin))
    _same(got, flax_msgpack.read(osp.join(FIXTURE, TWINS[twin])))
    restored = ocp.PyTreeCheckpointer().restore(osp.join(FIXTURE, twin))
    assert got["epoch"] == restored["epoch"] == 1
    _same(got["params"], restored["params"])


# ---------------------------------------------------------------------------
# (e) JAX runs saved with ckpt_backend: orbax, at cfg_nlst width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("orbax_data"))
    return make_synthetic_dataset(root, n_patients=36, dim=1024, min_regions=2,
                                  max_regions=8, seed=11, feat_format="pt")


@pytest.fixture(scope="module")
def orbax_runs(synth, tmp_path_factory):
    """Per handler, a JAX handler at its defaults (`opt_flatten` unset: the
    fused moment vector) with `ckpt_backend: orbax`: one step on batch 0,
    the injected learning rate halved, `save_model(1, "best")`, then the
    parameters after a step on batch 1; and the JAX test mode from the run
    directory."""
    from advmil_tpu.train.baseline import BaselineHandler as JBase
    from advmil_tpu.train.handler import AdvHandler as JAdv
    from tests.test_torch_ckpt import LR
    tmp = tmp_path_factory.mktemp("orbax_runs")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "mask_dropout", lambda rng, rate, x: x)
        for handler, jcls in (("adv", JAdv), ("base", JBase)):
            cfg = _make(handler, synth, tmp, f"jax_{handler}", rng_impl="threefry",
                        ckpt_backend="orbax")
            batches = _batches(cfg, 2)
            jh = jcls(j_with_defaults(dict(cfg)))
            jh.state, _, _ = jh.train_step(jh.state, jh._ship(_jax_dev(batches[0])))
            jh._set_lr(LR * 0.5)
            jh.save_model(1, "best", "train")
            saved = {k: _np_tree(v) for k, v in _jax_params(handler, jh).items()}
            jh.state, _, _ = jh.train_step(jh.state, jh._ship(_jax_dev(batches[1])))
            stepped = {k: bridge.flax_to_torch(_np_tree(v))
                       for k, v in _jax_params(handler, jh).items()}
            test_cfg = dict(cfg, test=True, test_load_path=cfg["save_path"],
                            test_save_path=str(tmp / f"jax_{handler}-test-{{}}-{{}}"))
            jt = jcls(j_with_defaults(test_cfg)).exec_test()
            ratio = "0.8" if handler == "adv" else "0.0"
            out[handler] = {"cfg": cfg, "batches": batches, "saved": saved, "stepped": stepped,
                            "jax_test": jt,
                            "jax_test_dir": str(tmp / f"jax_{handler}-test-{ratio}-0")}
    return out


def _jax_dev(batch):
    return {"feats": batch.feats, "mask": batch.mask, "label": batch.label,
            "sample_mask": batch.sample_mask, "visible": np.ones_like(batch.sample_mask)}


@pytest.mark.parametrize("handler", ["adv", "base"])
def test_exec_test_from_jax_orbax_run(orbax_runs, tmp_path, handler):
    """`test_load_path` names the JAX run directory of orbax checkpoints;
    the port's CLI on the CPU evaluates them: predictions within 1e-5 of
    the JAX exec_test's, the C-index within 1e-6."""
    run = orbax_runs[handler]
    names = ("G", "D") if handler == "adv" else ("",)
    for n in names:
        assert osp.isfile(osp.join(run["cfg"]["save_path"], f"train_model{n}-best.ckpt",
                                   "_METADATA"))
    cfg = dict(run["cfg"], test=True, device="cpu", test_load_path=run["cfg"]["save_path"],
               test_save_path=str(tmp_path / "port-test-{}-{}"))
    del cfg["rng_impl"]
    yaml_path = str(tmp_path / "port.yaml")
    _write_yaml(yaml_path, cfg)
    [(th, tm)] = port_main(["--config", yaml_path, "--handler", handler])
    name = "test_mode_best_pred_exec-test.csv"
    jp = _read_pred(osp.join(run["jax_test_dir"], name))
    tp = _read_pred(osp.join(th.save_dir, name))
    assert sorted(tp) == sorted(jp) and len(tp) > 0 and np.ptp(list(tp.values())) > 0
    np.testing.assert_allclose([tp[k] for k in sorted(jp)], [jp[k] for k in sorted(jp)],
                               atol=1e-5)
    assert abs(dict(tm["exec-test"])["cindex"]
               - dict(run["jax_test"]["exec-test"])["cindex"]) <= 1e-6


@pytest.mark.parametrize("handler", ["adv", "base"])
def test_resume_from_jax_orbax_run_then_step(orbax_runs, handler):
    """resume_model from the JAX orbax directories (the fused Adam moments
    mapped through the bridge): the saved parameters exactly, then one f32
    step on batch 1 within 1e-5 of the JAX step from the same state."""
    run = orbax_runs[handler]
    h = _port_handler(handler, run)
    h.resume_model("best", "train")
    for net, (m, _, _) in _nets(handler, h).items():
        want = bridge.flax_to_torch(run["saved"][net])
        for k, v in m.state_dict().items():
            assert torch.equal(v, want[k]), (net, k)
    _step(h, run["batches"][1])
    for net, (m, _, _) in _nets(handler, h).items():
        for k, v in m.state_dict().items():
            np.testing.assert_allclose(v.numpy(), run["stepped"][net][k].numpy(), atol=1e-5,
                                       err_msg=f"{net} {k}")


# ---------------------------------------------------------------------------
# (f) refusals
# ---------------------------------------------------------------------------

def _tiny_orbax(path, **handler_kw):
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(**handler_kw)).save(
        str(path), {"epoch": 1, "params": {"Dense_0": {"bias": np.ones(3, np.float32)}},
         "opt_state": None},
        force=True)
    return str(path)


def test_refuses_other_orbax_layouts(tmp_path):
    """`use_zarr3: true` and `use_ocdbt: false` (orbax's other layouts) raise
    naming the key; a directory without `_METADATA` names what it lacks."""
    with pytest.raises(ValueError, match="use_zarr3 is True"):
        tckpt.restore_checkpoint(_tiny_orbax(tmp_path / "z3", use_zarr3=True))
    with pytest.raises(ValueError, match="use_ocdbt is False"):
        tckpt.restore_checkpoint(_tiny_orbax(tmp_path / "noocdbt", use_ocdbt=False))
    ok = _tiny_orbax(tmp_path / "ok")
    assert tckpt.restore_checkpoint(ok)[0] == 1
    shutil.copytree(ok, tmp_path / "nometa")
    (tmp_path / "nometa" / "_METADATA").unlink()
    with pytest.raises(ValueError, match="lacks _METADATA$"):
        tckpt.restore_checkpoint(str(tmp_path / "nometa"))


@pytest.mark.parametrize("case", ["blosc", "filter", "zarr3"])
def test_refuses_other_zarr(tmp_path, case):
    """Another compressor, a filter or a zarr v3 array raises, naming it."""
    root = str(tmp_path)
    kvstore = {"driver": "ocdbt", "base": f"file://{root}/", "path": "a/"}
    if case == "zarr3":
        arr = ts.open({"driver": "zarr3", "kvstore": kvstore, "create": True,
                       "metadata": {"shape": [4], "data_type": "float32"}}).result()
    else:
        meta = {"dtype": "<f4", "shape": [4], "chunks": [4],
                "compressor": {"id": "blosc"} if case == "blosc" else None}
        if case == "filter":
            meta["filters"] = [{"id": "delta", "dtype": "<f4"}]
        try:
            arr = ts.open({"driver": "zarr", "kvstore": kvstore, "create": True,
                           "metadata": meta}).result()
        except ValueError:               # tensorstore writes no filter: write the
            meta.pop("filters")          # array, then add one to its .zarray
            arr = ts.open({"driver": "zarr", "kvstore": kvstore, "create": True,
                           "metadata": meta}).result()
            kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
            zarray = json.loads(kv.read(b"a/.zarray").result().value)
            kv[b"a/.zarray"] = json.dumps(dict(zarray, filters=[{"id": "delta"}])).encode()
    arr.write(np.arange(4, dtype=np.float32)).result()
    match = {"blosc": "compressor 'blosc'", "filter": r"filters \['delta'\]",
             "zarr3": "zarr v3"}[case]
    with pytest.raises(ValueError, match=match):
        zarr2.read_array(OcdbtStore(root), "a")


def test_no_libzstd_raises_only_for_orbax(tmp_path, monkeypatch):
    """Where `find_library("zstd")` finds nothing, reading an orbax
    checkpoint raises an ImportError naming libzstd and `ckpt_backend:
    orbax`; msgpack and torch checkpoints still load."""
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    zstd._lib.cache_clear()
    try:
        with pytest.raises(ImportError, match="libzstd.*ckpt_backend: orbax"):
            tckpt.restore_checkpoint(osp.join(FIXTURE, "orbax/flat/run/train_modelG-best.ckpt"))
        epoch, sd, _ = tckpt.restore_checkpoint(osp.join(FIXTURE, "flat/run/train_modelG-best.ckpt"))
        path = str(tmp_path / "t.ckpt")
        tckpt.save_checkpoint(path, epoch, sd)
        assert tckpt.restore_checkpoint(path)[0] == epoch == 1
    finally:
        zstd._lib.cache_clear()


# ---------------------------------------------------------------------------
# (g) profile_dir
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("profile_data"))
    return make_synthetic_dataset(root, n_patients=20, dim=32, min_regions=2, max_regions=5,
                                  seed=3, feat_format="pt")


TINY = dict(bcb_dims="32-64-64", gen_dims="64-1", disc_netx_in_dim=32, disc_netx_out_dim=32,
            disc_nety_hid_dims="16-32", device="cpu", batch_token_budget=512, bucket_min=32)


def test_profile_dir_traces_epoch_2(tiny, tmp_path, capsys):
    """A 2-epoch adversarial `exec` with `profile_dir` writes a Chrome trace
    of epoch 2 holding the training steps (optimizer and autograd events;
    on the CPU the kernels' plain versions run, so no kernel is named),
    prints the JAX handler's line, and returns the metrics of the same run
    without the key."""
    trace_dir = str(tmp_path / "trace")
    runs = [AdvHandler(with_defaults(adv_cfg(tiny, tmp_path, name, profile_dir=pd, **TINY)))
            .exec() for name, pd in (("plain", None), ("profiled", trace_dir))]
    assert runs[0] == runs[1]
    assert f"[profile] epoch-2 trace written to {trace_dir}" in capsys.readouterr().out
    with open(osp.join(trace_dir, "epoch2_rank0.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {str(e.get("name")) for e in events}
    assert len(events) > 100 and "Optimizer.zero_grad#Adam.zero_grad" in names
    assert any(n.startswith("autograd::engine::evaluate_function") for n in names)


def test_profile_dir_base_handler_writes_none(tiny, tmp_path):
    """The baseline handler runs no trace (the JAX baseline handler has none)."""
    from tests.test_torch_baseline import _cfg as base_cfg
    cfg = base_cfg(tiny, tmp_path, "base", bcb_mode="abmil", bcb_dims="32-64-64",
                   pdh_dims="64-1", device="cpu", epochs=2, batch_token_budget=512,
                   bucket_min=32, profile_dir=str(tmp_path / "trace"))
    BaselineHandler(with_defaults(cfg)).exec()
    assert not osp.exists(tmp_path / "trace")
