"""The graph path of advmil_tpu_torch (PatchGCN, `bcb_mode: graph`) against
advmil_tpu on the CPU in f32: the two aggregation ops and their gradients,
the host-side band tables, the batcher's graph tables and route, the
GENConv / DeepGCNBlock / PatchGCN modules on both routes, and a 2-epoch
`exec` with its `exec_test`.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do. Its modules take the jnp oracles on the CPU (the Pallas kernels engage
only on a TPU): the dense aggregation `knn_edge_softmax_aggregate` and the
banded rolls path, which reads the residual-edge tables `res_*` that the
port does not ship. Dropout and noise are off on both sides in the module
and `exec` comparisons, as in tests/test_torch_train.py.
"""
import csv
import os
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advmil_tpu.data.bags import BagDataset as JBagDataset
from advmil_tpu.data.bags import BucketBatcher as JBucketBatcher
from advmil_tpu.models import backbones as jbb
from advmil_tpu.models import layers as jlayers
from advmil_tpu.ops import banded_pallas as jbp
from advmil_tpu.ops import segment as jseg
from advmil_tpu_torch import bridge
from advmil_tpu_torch import config as tconfig
from advmil_tpu_torch.data.bags import BucketBatcher, prepare_dataset
from advmil_tpu_torch.data.synthetic import make_synthetic_dataset
from advmil_tpu_torch.models import backbones as tbb
from advmil_tpu_torch.models import layers as tl
from advmil_tpu_torch.ops import banded as tbanded
from advmil_tpu_torch.ops import segment as tseg
from advmil_tpu_torch.train import handler as thandler

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOL = 1e-5


def raster_graph(N, W, rng, epn=9, drop=0.05, irregular=0, empty=()):
    """A raster spatial graph over N nodes of a W-wide grid (slot s reads
    n + offset_s), with dropped edges, `irregular` random extra edges and the
    nodes in `empty` left without edges: [N, epn] edge_src / edge_mask."""
    offs = [-W - 1, -W, -W + 1, -1, 0, 1, W - 1, W, W + 1][:epn]
    esrc = np.zeros((N, epn), np.int32)
    em = np.zeros((N, epn), np.float32)
    for s, o in enumerate(offs):
        tgt = np.arange(N) + o
        ok = (tgt >= 0) & (tgt < N) & (rng.random(N) >= drop)
        esrc[ok, s] = tgt[ok]
        em[ok, s] = 1.0
    for _ in range(irregular):
        n, s = rng.integers(N), rng.integers(epn)
        esrc[n, s] = rng.integers(N)
        em[n, s] = 1.0
    em[list(empty)] = 0.0
    return esrc, em


def _tvec(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---------------------------------------------------------------------------
# (a) the dense aggregation (#12 / #13 plain) against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,epn,C", [(37, 9, 24), (64, 4, 32), (20, 16, 8)])
def test_dense_aggregation_and_grads_match_jax(N, epn, C):
    """Values, d messages and dt of the plain op (what the CPU runs) against
    the Pallas kernels in interpret mode and the jnp oracle; rows 0 and 5
    have no edge and give exactly 0."""
    rng = np.random.default_rng(N + epn)
    msg = rng.normal(size=(N, epn, C)).astype(np.float32)
    em = (rng.random((N, epn)) < 0.7).astype(np.float32)
    em[[0, 5]] = 0.0
    g = rng.normal(size=(N, C)).astype(np.float32)
    t = np.float32(1.3)

    def jfused(m, tt):
        return jseg.fused_knn_softmax_aggregate(m, jnp.asarray(em), tt, True)

    jout, vjp = jax.vjp(jax.jit(jfused), jnp.asarray(msg), jnp.asarray(t))
    jdm, jdt = vjp(jnp.asarray(g))
    oracle = jseg.knn_edge_softmax_aggregate(jnp.asarray(msg), jnp.asarray(em), t)

    tm, tt = _tvec(msg, True), _tvec([t], True)
    out = tseg.fused_knn_softmax_aggregate(tm, _tvec(em), tt)
    out.backward(_tvec(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(oracle), atol=TOL)
    assert np.all(out.detach().numpy()[[0, 5]] == 0.0)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jdm), atol=TOL)
    np.testing.assert_allclose(float(tt.grad[0]), float(jdt), rtol=TOL, atol=TOL)
    assert np.all(tm.grad.numpy()[em == 0] == 0.0)


def test_dense_aggregation_ignores_huge_masked_messages():
    """A masked slot holding a huge message must not overflow exp into NaN,
    in the value or the gradient."""
    msg = torch.zeros(3, 4, 5)
    msg[:, 2] = 1e4
    em = torch.tensor([[1, 1, 0, 0], [0, 0, 0, 0], [1, 0, 0, 1]], dtype=torch.float32)
    m = msg.clone().requires_grad_(True)
    t = torch.ones(1, requires_grad=True)
    out = tseg.knn_edge_softmax_aggregate(m, em, t)
    out.sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(m.grad).all()
    assert torch.isfinite(t.grad).all() and bool((out[1] == 0).all())


@pytest.mark.parametrize("mutant", ["slot 3 dropped", "slot 5's mask ignored"])
def test_knn_tol_holds_a_right_forward_and_catches_mutants(mutant):
    """`segment.knn_tol`, the bound the card holds the bf16 forward kernel
    (#12) to: the aggregation in f64, rounded once to bf16, stays inside it
    against the plain version on the same bf16 messages; the mutants of the
    card's `--mutants` fall outside, while the plain bound (2e-2 + 2e-2
    relative) lets them pass. Messages near 1 (relu(x) + eps of normalised
    features), 5% of the slots masked, four nodes without edges."""
    rng = np.random.default_rng(5)
    N, epn, C = 2048, 9, 64
    msg = torch.from_numpy(1.0 + 0.03 * rng.normal(size=(N, epn, C))).bfloat16()
    em = torch.from_numpy((rng.random((N, epn)) >= 0.05).astype(np.float32))
    em[:4] = 0.0
    t = torch.tensor([1.3])
    want = tseg.knn_edge_softmax_aggregate(msg, em, t)
    tol = tseg.knn_tol(want)
    right = tseg.knn_edge_softmax_aggregate(msg.double(), em, t.double()).bfloat16()
    assert _share(right, want, **tol) <= 0.5
    bad = em.clone()
    if mutant == "slot 3 dropped":
        bad[:, 3] = 0.0
    else:
        bad[4:, 5] = 1.0
    got = tseg.knn_edge_softmax_aggregate(msg, bad, t)
    assert bool((got[:4] == 0).all())
    assert _share(got, want, 2e-2, 2e-2) <= 1.0
    assert _share(got, want, **tol) > 1.5


def _knn_dm(msg, em, t, g, drop_t=False, out_shift=0):
    """dmessages of the kNN aggregation in f64 from its formula, g alpha_s
    (1 + t (m_s - out)); `drop_t` makes the factor 1 + (m_s - out) and
    `out_shift` takes out from the row that many rows before."""
    m, t = msg.double(), float(t)
    masked = torch.where(em.bool()[..., None], m * t, float("-inf"))
    mx = masked.amax(dim=-2, keepdim=True)
    ex = torch.exp(masked - torch.where(torch.isfinite(mx), mx, torch.zeros(())))
    alpha = ex / ex.sum(dim=-2, keepdim=True).clamp_min(1e-16)
    out = torch.roll((alpha * m).sum(dim=-2, keepdim=True), out_shift, dims=0)
    return g.double()[..., None, :] * alpha * (1 + (1.0 if drop_t else t) * (m - out))


@pytest.mark.parametrize("mutant", ["slot 3 dropped", "slot 5's mask ignored", "t dropped",
                                    "out from the previous row"])
def test_knn_bwd_tol_holds_a_right_backward_and_catches_mutants(mutant):
    """`segment.knn_bwd_tol`, the bound the card holds the bf16 backward
    kernel's dmessages (#13) to: the formula in f64, rounded once to bf16,
    stays inside it against the plain version's autograd backward on the same
    bf16 messages and cotangent; each mutant falls outside it, while the plain
    bound (2e-2 + 2e-2 relative) lets it pass. Messages 1 + 0.3 N(0, 1), a
    cotangent of 0.005 N(0, 1) (a loss's gradient a value), 5% of the slots
    masked, four nodes without edges."""
    rng = np.random.default_rng(5)
    N, epn, C = 2048, 9, 64
    msg = torch.from_numpy(1.0 + 0.3 * rng.normal(size=(N, epn, C))).bfloat16()
    em = torch.from_numpy((rng.random((N, epn)) >= 0.05).astype(np.float32))
    em[:4] = 0.0
    g = torch.from_numpy(0.005 * rng.normal(size=(N, C))).bfloat16()
    t = torch.tensor([1.3])
    m = msg.clone().requires_grad_(True)
    tseg.knn_edge_softmax_aggregate(m, em, t).backward(g)
    want = m.grad
    assert want.dtype == torch.bfloat16 and bool((want[:4] == 0).all())
    m32 = msg.float().requires_grad_(True)     # the formula against autograd in f32
    tseg.knn_edge_softmax_aggregate(m32, em, t).backward(g.float())
    torch.testing.assert_close(_knn_dm(msg, em, t, g).float(), m32.grad, atol=1e-8, rtol=1e-5)
    tol = tseg.knn_bwd_tol(want)
    assert _share(_knn_dm(msg, em, t, g).bfloat16(), want, **tol) <= 1.0
    bad, kw = em.clone(), {}
    if mutant == "slot 3 dropped":
        bad[:, 3] = 0.0
    elif mutant == "slot 5's mask ignored":
        bad[4:, 5] = 1.0
    elif mutant == "t dropped":
        kw = dict(drop_t=True)
    else:
        kw = dict(out_shift=1)
    got = _knn_dm(msg, bad, t, g, **kw).bfloat16()
    assert _share(got, want, 2e-2, 2e-2) <= 1.0
    assert _share(got, want, **tol) > 1.5


def _share(got, want, atol, rtol):
    """The largest |got - want| as a share of atol + rtol |want| (1: at the bound)."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


# ---------------------------------------------------------------------------
# (b) the banded aggregation (#14 / #15 plain + exact rows) against Pallas
# ---------------------------------------------------------------------------

def _two_bags(N, W, C, seed, u_extra=3):
    """Two raster bags with residual rows, an empty-edge row and sentinel
    u_rows slots; returns numpy inputs of the port's batched op."""
    rng = np.random.default_rng(seed)
    tabs = []
    for b in range(2):
        esrc, em = raster_graph(N, W, rng, irregular=10 + 5 * b, empty=(17 + b,))
        offs, bmask, *_ = tseg.build_band_tables(esrc, em)
        tabs.append((esrc, em, offs, bmask))
    u_slots = max(len(np.unique(np.nonzero((em > 0) & (bm <= 0))[0]))
                  for _, em, _, bm in tabs) + u_extra
    out = {k: [] for k in ("offs", "bmask", "urows", "usrc", "uemask", "uinv", "esrc", "em")}
    for esrc, em, offs, bmask in tabs:
        ur, us, ue = tbanded.build_u_tables(esrc, em, bmask, u_slots=u_slots)
        for k, v in zip(out, (offs, bmask, ur, us, ue, tbanded.build_u_inv(ur, N), esrc, em)):
            out[k].append(v)
    out = {k: np.stack(v) for k, v in out.items()}
    assert (out["urows"] == N).any() and (out["urows"] < N).any()
    out["y"] = rng.normal(size=(2, N, C)).astype(np.float32)
    out["g"] = rng.normal(size=(2, N, C)).astype(np.float32)
    return out


@pytest.mark.parametrize("N,W,C", [(150, 12, 24), (40, 6, 8)])
def test_banded_aggregation_and_grads_match_jax(N, W, C):
    d = _two_bags(N, W, C, seed=N)
    t = np.float32(0.8)
    ty, tt = _tvec(d["y"], True), _tvec([t], True)
    out = tbanded.banded_aggregate(ty, _tvec(d["offs"]), _tvec(d["bmask"]), _tvec(d["urows"]),
                                   _tvec(d["usrc"]), _tvec(d["uemask"]), _tvec(d["uinv"]), tt)
    out.backward(_tvec(d["g"]))
    dt_pallas = dt_dense = 0.0
    for b in range(2):
        args = tuple(jnp.asarray(d[k][b]) for k in ("offs", "bmask", "urows", "usrc", "uemask"))

        def jpba(y, tj):
            return jbp.pallas_banded_aggregate(y, *args, tj, jnp.asarray(d["uinv"][b]), True)

        def jdense(y, tj):
            return jseg.knn_edge_softmax_aggregate(y[d["esrc"][b]], jnp.asarray(d["em"][b]), tj)

        jout, vjp = jax.vjp(jax.jit(jpba), jnp.asarray(d["y"][b]), jnp.asarray(t))
        jdy, jdt = vjp(jnp.asarray(d["g"][b]))
        dense, dvjp = jax.vjp(jdense, jnp.asarray(d["y"][b]), jnp.asarray(t))
        dt_pallas += float(jdt)
        dt_dense += float(dvjp(jnp.asarray(d["g"][b]))[1])
        np.testing.assert_allclose(out[b].detach().numpy(), np.asarray(jout), atol=TOL)
        np.testing.assert_allclose(ty.grad[b].numpy(), np.asarray(jdy), atol=TOL)
        np.testing.assert_allclose(out[b].detach().numpy(), np.asarray(dense), atol=TOL)
        assert np.all(out[b, 17 + b].detach().numpy() == 0.0)
    # dt against the JAX autodiff of the dense oracle; the Pallas backward sums
    # its dt as 1024 copies of each block partial and reads ~1e-5 off it, so
    # against Pallas the JAX package's own bound (tests/test_banded_pallas.py)
    np.testing.assert_allclose(float(tt.grad[0]), dt_dense, rtol=TOL)
    np.testing.assert_allclose(float(tt.grad[0]), dt_pallas, rtol=5e-5)


@pytest.mark.parametrize("N,W,C", [(150, 12, 24), (40, 6, 8)])
def test_banded_stats_and_bwd_from_stats_match_jax(N, W, C):
    """The plain statistics of the forward (lse = m + log den, out32) and the
    plain backward from them (`banded_core_bwd_plain`: the arithmetic of the
    #15 kernel) against the JAX package's banded kernels in interpret mode
    (its m, den, and its backward from them) and against autograd through
    `banded_core_plain`, in f32. A node without edges aggregates to exactly
    0 and passes no gradient."""
    d = _two_bags(N, W, C, seed=N + 1)
    t = np.float32(0.8)
    offs, bm, ty, tt, tg = (_tvec(d["offs"]), _tvec(d["bmask"]), _tvec(d["y"]), _tvec([t]),
                            _tvec(d["g"]))
    out, (lse, out32) = tbanded.banded_core_stats_plain(ty, offs, bm, tt)
    dy, dt = tbanded.banded_core_bwd_plain(ty, offs, bm, tt, (lse, out32), tg)
    ya, ta = _tvec(d["y"], True), _tvec([t], True)
    ref = tbanded.banded_core_plain(ya, offs, bm, ta)
    ref.backward(tg)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), atol=TOL)
    np.testing.assert_allclose(dy.numpy(), ya.grad.numpy(), atol=TOL)
    np.testing.assert_allclose(float(dt[0]), float(ta.grad[0]), rtol=TOL)
    dt_pallas = 0.0
    for b in range(2):
        args = (jnp.asarray(d["y"][b]), jnp.asarray(d["offs"][b]), jnp.asarray(d["bmask"][b]),
                jnp.asarray(t))
        (jout, m, den), _ = jbp._banded_core_fwd(*args, True, True)
        jlse = np.asarray(m + jnp.log(jnp.maximum(den, 1e-16)))[:N, :C]
        np.testing.assert_allclose(lse[b].numpy(), jlse, atol=TOL)
        np.testing.assert_allclose(out32[b].numpy(), np.asarray(jout)[:N, :C], atol=TOL)
        jdy, jdt = jbp._banded_core_bwd(*args, m, den, jout, jnp.asarray(d["g"][b]), True)
        np.testing.assert_allclose(dy[b].numpy(), np.asarray(jdy), atol=TOL)
        dt_pallas += float(jdt)
        assert np.all(out[b, 17 + b].numpy() == 0.0)
    # the Pallas dt is read off 1024 copies of each block partial (see above)
    np.testing.assert_allclose(float(dt[0]), dt_pallas, rtol=5e-5)
    g_empty = torch.zeros_like(tg)
    g_empty[0, 17], g_empty[1, 18] = 1.0, 1.0
    dy0, dt0 = tbanded.banded_core_bwd_plain(ty, offs, bm, tt, (lse, out32), g_empty)
    assert torch.all(dy0 == 0) and float(dt0[0]) == 0.0


@pytest.mark.parametrize("B,N,epn,C,span", [(2, 60, 9, 8, 40), (3, 10, 1, 4, 3),
                                            (2, 30, 16, 5, 20)])
def test_banded_bwd_plain_matches_autograd_for_any_offsets(B, N, epn, C, span):
    """The plain backward from the statistics against autograd through
    `banded_core_plain` on tables the batcher would not build: offsets that
    differ from bag to bag and reach across most of the bag, slots whose
    source lies outside it, node 3 without edges."""
    rng = np.random.default_rng(N + epn)
    offs = _tvec(np.stack([rng.choice(np.arange(-span, span + 1), size=epn, replace=False)
                           for _ in range(B)]).astype(np.int32))
    bm_np = (rng.random((B, N, epn)) < 0.85).astype(np.float32)
    bm_np[:, 3] = 0.0
    bm = _tvec(bm_np)
    y = rng.normal(size=(B, N, C)).astype(np.float32)
    g = _tvec(rng.normal(size=(B, N, C)).astype(np.float32))
    t = np.float32(1.2)
    out, stats = tbanded.banded_core_stats_plain(_tvec(y), offs, bm, _tvec([t]))
    dy, dt = tbanded.banded_core_bwd_plain(_tvec(y), offs, bm, _tvec([t]), stats, g)
    ya, ta = _tvec(y, True), _tvec([t], True)
    ref = tbanded.banded_core_plain(ya, offs, bm, ta)
    ref.backward(g)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), atol=TOL)
    np.testing.assert_allclose(dy.numpy(), ya.grad.numpy(), atol=TOL)
    np.testing.assert_allclose(float(dt[0]), float(ta.grad[0]), rtol=TOL, atol=TOL)
    assert torch.all(out[:, 3] == 0)


def test_banded_sentinel_u_slots_change_nothing():
    """u tables padded far beyond the residual rows (sentinel u_rows = N,
    mask 0) give the same values and gradients (the JAX package's
    tests/test_banded_pallas.py::test_grad_ignores_sentinel_u_rows)."""
    res = []
    for extra in (1, 40):
        d = _two_bags(120, 11, 16, seed=9, u_extra=extra)
        ty, tt = _tvec(d["y"], True), _tvec([np.float32(1.1)], True)
        out = tbanded.banded_aggregate(ty, _tvec(d["offs"]), _tvec(d["bmask"]),
                                       _tvec(d["urows"]), _tvec(d["usrc"]),
                                       _tvec(d["uemask"]), _tvec(d["uinv"]), tt)
        torch.cos(out).sum().backward()
        res.append((out.detach(), ty.grad, tt.grad))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# (c) host tables, array-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,W,irregular,u_slots", [(240, 13, 15, None), (200, 11, 0, 40),
                                                   (64, 8, 3, None)])
def test_band_tables_equal_jax(N, W, irregular, u_slots):
    rng = np.random.default_rng(N)
    esrc, em = raster_graph(N, W, rng, irregular=irregular, empty=(5,))
    got, want = tseg.build_band_tables(esrc, em), jseg.build_band_tables(esrc, em)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert tseg.band_coverage(esrc, em) == jseg.band_coverage(esrc, em)
    bmask = got[1]
    tu = tbanded.build_u_tables(esrc, em, bmask, u_slots=u_slots)
    ju = jbp.build_u_tables(esrc, em, bmask, u_slots=u_slots)
    for a, b in zip(tu, ju):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(tbanded.build_u_inv(tu[0], N), jbp.build_u_inv(ju[0], N))


# ---------------------------------------------------------------------------
# (d) the batcher's graph tables and route against the JAX batcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gsynth(tmp_path_factory):
    """36 patients of 4-16 regions with the chain+skip graphs: one 256-node
    bucket, so each JAX step compiles once."""
    root = str(tmp_path_factory.mktemp("graph_data"))
    return make_synthetic_dataset(root, n_patients=36, dim=32, min_regions=4,
                                  max_regions=16, seed=5, feat_format="pt", with_graph=True)


@pytest.mark.parametrize("banded,epn", [("auto", 9), ("off", 9), ("auto", 3), ("off", 3)])
def test_batcher_graph_tables_match_jax(gsynth, banded, epn):
    """epn 3 truncates the in-degree (4 inside the chain+skip graph)."""
    pids = [f"P{i:04d}" for i in range(36)]
    tds = prepare_dataset(pids, {"path_patch": gsynth["path_patch"],
                                 "path_label": gsynth["path_label"], "bcb_mode": "graph",
                                 "path_graph": gsynth["path_graph"], "feat_format": "pt",
                                 "time_format": "ratio"})
    jds = JBagDataset(pids, gsynth["path_patch"], gsynth["path_label"], mode="graph",
                      read_format="pt", time_format="ratio", graph_path=gsynth["path_graph"])
    kw = dict(token_budget=1024, bucket_growth=1.5, min_bucket=64, edges_per_node=epn,
              banded=banded)
    tb = BucketBatcher(tds, **kw)
    jb = JBucketBatcher(jds, scatter_free="off", **kw)
    assert tb.band_on == jb._band_on == (banded == "auto")
    tbs, jbs = list(tb.epoch_batches()), list(jb.epoch_batches())
    assert len(tbs) == len(jbs) > 3
    for a, b in zip(tbs, jbs):
        np.testing.assert_array_equal(a.idx, b.idx)
        np.testing.assert_array_equal(a.feats, b.feats)
        assert set(b.extra) >= set(a.extra) and len(a.extra) == (6 if tb.band_on else 2)
        for k, v in a.extra.items():
            np.testing.assert_array_equal(v, b.extra[k], err_msg=k)
            assert v.dtype == b.extra[k].dtype, k
    assert tb._warned_edge_truncation == (epn == 3)


def test_graph_dataset_refuses_pt_graphs(gsynth, tmp_path):
    """Reference-format .pt graphs are read (tests/test_torch_tools.py); an
    empty .pt file is refused by the unpickler, and a slide without any
    graph file names both files it looked for."""
    os.makedirs(tmp_path / "g")
    (tmp_path / "g" / "S0000.pt").write_bytes(b"")
    cfg = {"path_patch": gsynth["path_patch"], "path_label": gsynth["path_label"],
           "bcb_mode": "graph", "path_graph": str(tmp_path / "g"), "feat_format": "pt",
           "time_format": "ratio"}
    ds = prepare_dataset(["P0000", "P0001"], cfg)
    with pytest.raises(EOFError):
        ds.peek_edges(0)
    with pytest.raises(FileNotFoundError, match=r"S0001\.npz.*S0001\.pt"):
        ds.peek_edges(1)


# ---------------------------------------------------------------------------
# (e) GENConv, DeepGCNBlock and PatchGCN against flax, both routes
# ---------------------------------------------------------------------------

def _graph_extras(B, N, epn, rng, route):
    """(port extra, JAX extra) of B raster bags of N nodes (N % 16 == 0) on
    one route; the JAX banded extra adds its rolls path's residual tables."""
    graphs = [raster_graph(N, 8, rng, epn=epn, irregular=6, empty=(3,)) for _ in range(B)]
    if route == "dense":
        ex = {"edge_src": np.stack([g[0] for g in graphs]),
              "edge_mask": np.stack([g[1] for g in graphs])}
        return ex, dict(ex)
    cols = {k: [] for k in ("band_offs", "band_mask", "res_node", "res_src", "res_mask")}
    for esrc, em in graphs:
        for k, v in zip(cols, jseg.build_band_tables(esrc, em, res_slots=128)):
            cols[k].append(v)
    u_slots = 8 * (1 + max(tseg.band_coverage(*g)[2] for g in graphs) // 8)
    ut = [tbanded.build_u_tables(esrc, em, bm, u_slots=u_slots)
          for (esrc, em), bm in zip(graphs, cols["band_mask"])]
    port = {"band_offs": np.stack(cols["band_offs"]), "band_mask": np.stack(cols["band_mask"]),
            "band_urows": np.stack([u[0] for u in ut]), "band_usrc": np.stack([u[1] for u in ut]),
            "band_uemask": np.stack([u[2] for u in ut]),
            "band_uinv": np.stack([tbanded.build_u_inv(u[0], N) for u in ut])}
    jx = dict(port, **{k: np.stack(cols[k]) for k in ("res_node", "res_src", "res_mask")})
    return port, jx


def _grads_match(module, jparams, loss_t, loss_j, leaves, tol=TOL):
    """Port gradients (autograd) against jax.grad of every parameter and of
    the inputs `leaves` (torch tensors / jnp arrays, in order), within `tol`
    (1e-5) absolute or relative (the largest gradients are ~10: f32 sums
    over the nodes)."""
    module.zero_grad()
    for lv in leaves[0]:
        lv.grad = None
    loss_t().backward()
    jg_params, *jg_leaves = jax.jit(jax.grad(loss_j, argnums=tuple(range(1 + len(leaves[1])))))(
        jparams, *leaves[1])
    want = bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, jg_params))
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=tol, rtol=tol,
                                   err_msg=k)
    for a, b in zip(leaves[0], jg_leaves):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("route", ["banded", "dense"])
@pytest.mark.parametrize("which", ["GENConv", "DeepGCNBlock"])
def test_gcn_layers_match_flax(which, route, no_jax_dropout):
    B, N, C, epn = 2, 96, 16, 9
    rng = np.random.default_rng(11)
    port_ex, jax_ex = _graph_extras(B, N, epn, rng, route)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    w = rng.normal(size=(B, N, C)).astype(np.float32)
    if which == "GENConv":
        jmod = jbb.GENConv(C, use_pallas=True)
        tmod = tbb.GENConv(C).eval()
        call = lambda m, xx, ex: m(xx, ex)                          # noqa: E731
    else:
        jmod = jbb.DeepGCNBlock(C, det=True)
        tmod = tbb.DeepGCNBlock(C).eval()
        call = lambda m, xx, ex: m(xx, ex, None)                    # noqa: E731
    jex = {k: jnp.asarray(v) for k, v in jax_ex.items()}
    band = None
    if route == "banded":
        band = {"offs": jex["band_offs"], "mask": jex["band_mask"], "res_node": jex["res_node"],
                "res_src": jex["res_src"], "res_mask": jex["res_mask"],
                "u_rows": jex["band_urows"], "u_src": jex["band_usrc"],
                "u_emask": jex["band_uemask"], "u_inv": jex["band_uinv"]}
    es, em = jex.get("edge_src"), jex.get("edge_mask")

    kw = {"deterministic": True} if which == "GENConv" else {}
    axes = tuple(None if a is None else 0 for a in (es, em, band))

    def japply(params, xx):      # one graph at a time, shared parameters
        return jax.vmap(lambda xb, eb, mb, bb: jmod.apply(
            {"params": params}, xb, eb, mb, None, None, bb, **kw),
            in_axes=(0,) + axes)(xx, es, em, band)

    first = [None if a is None else jax.tree_util.tree_map(lambda v: v[0], a)
             for a in (es, em, band)]
    jparams = jmod.init(jax.random.PRNGKey(0), jnp.zeros((N, C), jnp.float32), first[0],
                        first[1], None, None, first[2], **kw)["params"]
    # a temperature other than 1 and non-trivial LayerNorm parameters
    jparams = jax.tree_util.tree_map(lambda a: a * 1.1 + 0.05, jparams)
    tmod.load_state_dict(bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, jparams)))
    tex = {k: torch.from_numpy(v) for k, v in port_ex.items()}
    tx = torch.tensor(x, requires_grad=True)
    got = call(tmod, tx, tex)
    want = jax.jit(japply)(jparams, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL)
    _grads_match(tmod, jparams,
                 lambda: (call(tmod, tx, tex) * torch.from_numpy(w)).sum(),
                 lambda p, xx: jnp.sum(japply(p, xx) * w),
                 ([tx], [jnp.asarray(x)]))


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(jlayers, "mask_dropout", lambda rng, rate, x: x)


@pytest.mark.parametrize("route", ["banded", "dense"])
def test_patchgcn_matches_flax(route, no_jax_dropout):
    """The whole backbone in train mode with dropout off: forward and every
    parameter's gradient, 3 layers (so DeepGCN blocks run), a padded bag."""
    B, N, C, epn = 2, 96, 24, 9
    rng = np.random.default_rng(5)
    port_ex, jax_ex = _graph_extras(B, N, epn, rng, route)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 80:] = 0.0
    w = rng.normal(size=(B, 16)).astype(np.float32)
    jmod = jbb.load_backbone("graph", [C, 16, 16], num_graph_layers=3)
    jex = {k: jnp.asarray(v) for k, v in jax_ex.items()}
    jparams = jmod.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x), jnp.asarray(mask),
                        jex, deterministic=True)["params"]
    jparams = jax.tree_util.tree_map(lambda a: a * 1.1 + 0.05, jparams)
    tmod = tbb.load_backbone("graph", [C, 16, 16], num_graph_layers=3)
    tmod.load_state_dict(bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, jparams)))
    tl.set_dropout_rates(tmod.train(), 0.0)
    tex = {k: torch.from_numpy(v) for k, v in port_ex.items()}
    tx, tmask = torch.tensor(x, requires_grad=True), torch.from_numpy(mask)

    def japply(p, xx):
        return jmod.apply({"params": p}, xx, jnp.asarray(mask), jex, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(2)})

    got = tmod(tx, tmask, tex)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jax.jit(japply)(jparams, jnp.asarray(x))), atol=TOL)
    _grads_match(tmod, jparams, lambda: (tmod(tx, tmask, tex) * torch.from_numpy(w)).sum(),
                 lambda p, xx: jnp.sum(japply(p, xx) * w), ([tx], [jnp.asarray(x)]))


def test_genconv_routes_agree_in_bf16():
    """In bf16 both routes gather the messages in f32 (the gather's backward
    sums a row's gradients in f32), so on the same graphs GENConv's output
    and its input and t gradients agree to bf16 rounding."""
    B, N, C, epn = 2, 96, 16, 9
    x = np.random.default_rng(0).normal(size=(B, N, C)).astype(np.float32)
    mod = tl.init_parameters(tbb.GENConv(C, dtype=torch.bfloat16), seed=3)
    res = []
    for route in ("banded", "dense"):
        ex, _ = _graph_extras(B, N, epn, np.random.default_rng(11), route)
        mod.zero_grad()
        tx = torch.tensor(x).bfloat16().requires_grad_(True)
        out = mod(tx, {k: torch.from_numpy(v) for k, v in ex.items()})
        assert out.dtype == torch.bfloat16
        out.float().square().sum().backward()
        res.append((out.detach().float(), tx.grad.float(), mod.t.grad.clone()))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# (f) exec and exec_test against the JAX handler; the config; no JAX import
# ---------------------------------------------------------------------------

def _cfg(paths, tmp_path, name, **over):
    cfg = {
        "task": "cont_gansurv", "seed": 42, "save_path": str(tmp_path / name),
        "dataset": "synthetic", "path_patch": paths["path_patch"],
        "path_graph": paths["path_graph"], "path_label": paths["path_label"],
        "path_coordx5": None, "feat_format": "pt", "time_format": "ratio", "time_bins": 4,
        "data_split_path": paths["data_split_path"], "data_split_seed": 0,
        "save_prediction": True, "bcb_mode": "graph", "bcb_dims": "32-16-16",
        "num_graph_layers": 2, "gen_dims": "16-1", "gen_noi_noise": "0-0",
        "gen_noi_noise_dist": "uniform", "gen_noi_hops": 1, "gen_norm": False,
        "gen_dropout": 0.6, "gen_out_scale": "sigmoid", "disc_type": "prj",
        "disc_netx_in_dim": 32, "disc_netx_out_dim": 128, "disc_netx_ksize": 1,
        "disc_netx_backbone": "avgpool", "disc_netx_dropout": 0.25,
        "disc_nety_in_dim": 1, "disc_nety_hid_dims": "16-128",
        "disc_nety_norm": False, "disc_nety_dropout": 0.0, "disc_prj_path": "x",
        "disc_prj_iprd": "instance", "loss_gan_coef": 0.004, "loss_netD": "bce",
        "loss_regl1_coef": 0.00001, "loss_mle_alpha": 0.0,
        "loss_recon_norm": "l1", "loss_recon_alpha": 0.0,
        "loss_recon_gamma": 0.0, "opt_netG": "adam", "opt_netG_lr": 0.0008,
        "opt_netG_weight_decay": 0.0005, "opt_netD_lr": 0.0008, "epochs": 2,
        "es_patience": 30, "es_warmup": 0, "es_verbose": False,
        "es_start_epoch": 0, "gen_updates": 1, "monitor_metrics": "loss",
        "times_test_sample": 1, "test": False, "test_wandb_prj": None,
        "test_path": "test", "test_load_path": str(tmp_path / name),
        "test_save_path": str(tmp_path / (name + "-test-{}-{}")),
        "test_mask_ratio": 0.0, "test_sampling_times": 1,
        "test_zero_noise": True, "batch_token_budget": 4096, "bucket_min": 256,
        "precision": "f32",
    }
    cfg.update(over)
    return cfg


def _read_pred(path):
    with open(path) as f:
        return {r["patient_id"]: float(r["pred_t"]) for r in csv.DictReader(f)}


def _write_yaml(path, cfg):
    def fmt(v):
        if v is None:
            return "null"
        return np.format_float_positional(v) if isinstance(v, float) else str(v)
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k}: {fmt(v)}\n")


def test_graph_exec_and_exec_test_match_jax(gsynth, tmp_path, monkeypatch, no_jax_dropout):
    """2 epochs of `exec` from the JAX run's initial weights, then `exec_test`
    from each side's best checkpoint: prediction CSVs and C-indices within
    1e-4 (the banded route: the synthetic chain+skip graphs are banded)."""
    from advmil_tpu.config import with_defaults as j_with_defaults
    from advmil_tpu.train.handler import AdvHandler as JaxHandler
    from advmil_tpu_torch.main import main as port_main

    jh = JaxHandler(j_with_defaults(_cfg(gsynth, tmp_path, "jax", rng_impl="threefry")))
    init = {42: bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, jh.params_G)),
            43: bridge.flax_to_torch(jax.tree_util.tree_map(np.asarray, jh.params_D))}
    jm = jh.exec()

    def from_jax_init(model, seed):
        model.load_state_dict(init[seed])
        return tl.set_dropout_rates(model, 0.0)

    monkeypatch.setattr(thandler, "init_parameters", from_jax_init)
    yaml_path = str(tmp_path / "port.yaml")
    _write_yaml(yaml_path, _cfg(gsynth, tmp_path, "port", device="cpu"))
    [(th, tm)] = port_main(["--config", yaml_path, "--handler", "adv"])
    assert th.loaders["train"][1].band_on
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for split in ("train", "validation", "test"):
        name = f"train_best_pred_{split}.csv"
        jp, tp = _read_pred(osp.join(jdir, name)), _read_pred(osp.join(tdir, name))
        assert sorted(tp) == sorted(jp) and np.ptp(list(tp.values())) > 0
        np.testing.assert_allclose([tp[k] for k in sorted(jp)], [jp[k] for k in sorted(jp)],
                                   atol=1e-4, err_msg=split)
        assert abs(dict(tm[split])["cindex"] - dict(jm[split])["cindex"]) <= 1e-4

    jt = JaxHandler(j_with_defaults(_cfg(gsynth, tmp_path, "jax", rng_impl="threefry",
                                         test=True))).exec_test()
    _write_yaml(yaml_path, _cfg(gsynth, tmp_path, "port", device="cpu", test=True))
    [(th2, tt)] = port_main(["--config", yaml_path, "--handler", "adv"])
    name = "test_mode_best_pred_exec-test.csv"
    jp = _read_pred(osp.join(str(tmp_path / "jax-test-0.0-0"), name))
    tp = _read_pred(osp.join(th2.save_dir, name))
    assert sorted(tp) == sorted(jp) and len(tp) > 0
    np.testing.assert_allclose([tp[k] for k in sorted(jp)], [jp[k] for k in sorted(jp)],
                               atol=1e-4)
    assert abs(dict(tt["exec-test"])["cindex"] - dict(jt["exec-test"])["cindex"]) <= 1e-4


def test_graph_path_imports_no_jax(gsynth, tmp_path):
    """A graph-mode training epoch and test mode on the CPU, through the
    entry point, in a fresh interpreter: no JAX module is loaded."""
    cfg = _cfg(gsynth, tmp_path, "nojax", device="cpu", epochs=1)
    train_yaml, test_yaml = str(tmp_path / "train.yaml"), str(tmp_path / "test.yaml")
    _write_yaml(train_yaml, cfg)
    _write_yaml(test_yaml, dict(cfg, test=True))
    code = ("import sys\n"
            "from advmil_tpu_torch.main import main\n"
            f"main(['--config', {train_yaml!r}, '--handler', 'adv'])\n"
            f"main(['--config', {test_yaml!r}, '--handler', 'adv'])\n"
            "print('BAD', sorted(k for k in sys.modules if k.split('.')[0] in\n"
            "      ('jax', 'jaxlib', 'flax', 'optax', 'advmil_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "BAD []" in r.stdout and "banded graph route ON" in r.stdout, r.stdout[-3000:]


@pytest.mark.parametrize("value,banded", [("off", "off"), (False, "off"), ("auto", "auto")])
def test_graph_banded_off_reads_yaml_false(value, banded):
    from advmil_tpu_torch.train.common import graph_banded
    assert graph_banded({"graph_banded": value}) == banded


def test_graph_grid_resident_names_the_roadmap():
    """graph_grid_resident was refused naming ROADMAP A13 until the grid route
    was ported: it passes the checks now, under inst_devices and with
    log_plot too (once refused, naming A14 rest and A9), and the one
    refusal left (A19) names no A13."""
    cfg = tconfig.get_config(osp.join(REPO, "config", "cfg_nlst.yaml"))
    cfg.update(test=True, device="cpu", bcb_mode="graph")
    tconfig.check_configs(cfg)
    tconfig.check_configs(dict(cfg, graph_grid_resident=True))
    tconfig.check_configs(dict(cfg, graph_grid_resident=True, log_plot=True,
                               inst_devices=2))
    with pytest.raises(NotImplementedError, match="A19") as err:
        tconfig.check_configs(dict(cfg, graph_grid_resident=True, device="cuda",
                                   opt_net="adahessian"), "base")
    assert "A13" not in str(err.value)
