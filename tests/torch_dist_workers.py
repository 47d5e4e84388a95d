"""Rank-side cases of tests/test_torch_parallel.py and tests/test_torch_dist.py.

They run in processes spawned by `advmil_tpu_torch.parallel.launch.run_ranks`
(gloo over 127.0.0.1, CPU tensors, so every kernel op takes its plain
version) and import nothing of JAX. `run_cases(rank, device, cases)` runs a
list of case dicts in order and returns {name: result}; each case builds its
own process grid (or handler) over the spawned world.
"""
import numpy as np
import torch

from advmil_tpu_torch.models import layers as tl
from advmil_tpu_torch.parallel import comm, mesh


def _grid(device, case):
    g = mesh.make_grid(case["dp"], case["inst"], device)
    mesh.set_grid(g)
    return g


def _local(a, by_instance):
    """This rank's rows of a global array, and its share of dim 1 when
    `by_instance`."""
    a = a[mesh.row_slice(a.shape[0])]
    if by_instance:
        a = a[:, mesh.inst_slice(a.shape[1])]
    return torch.from_numpy(np.ascontiguousarray(a))


def flash_case(device, case):
    """The sequence-parallel attention op on this rank's share of q / k / v /
    mask; loss sum(out * w) over the local rows (each rank's loss is its own
    part of the global sum). Returns the local out, dq, dk, dv."""
    from advmil_tpu_torch.ops.attention import masked_flash_attention_inst
    g = _grid(device, case)
    d = case["inputs"]
    q, k, v = (_local(d[n], True).requires_grad_(True) for n in ("q", "k", "v"))
    out = masked_flash_attention_inst(q, k, v, _local(d["mask"], True), g.inst_group,
                                      dropout_p=case["p"], seed=case["seed"])
    (out * _local(d["w"], True)).sum().backward()
    mesh.set_grid(None)
    return {"dp_rank": g.dp_rank, "inst_rank": g.inst_rank,
            **{n: t.detach().numpy() for n, t in
               (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}}


def build_model(spec: dict):
    """The port model of a model case: (module, call(module, x, mask, extra, t))."""
    from advmil_tpu_torch.models import backbones as tbb
    from advmil_tpu_torch.models import gan as tgan
    kind, kw = spec["kind"], dict(spec.get("kw", {}))
    if kind == "esat":
        m = tbb.DualTransHS(spec["dims"], **kw)
        return m, lambda m, x, mask, extra, t, rng: m(x, mask, extra, rng)
    if kind == "abmil":
        m = tbb.ABMIL(spec["dims"], **kw)
        return m, lambda m, x, mask, extra, t, rng: m(x, mask, None, rng)
    if kind == "disc":
        m = tgan.PrjDiscriminator(**kw)
        return m, lambda m, x, mask, extra, t, rng: m(x, t, mask, rng)
    if kind in ("graph", "cluster"):
        m = tbb.load_backbone(kind, spec["dims"], **kw)
        return m, lambda m, x, mask, extra, t, rng: m(x, mask, extra, rng)
    raise ValueError(kind)


def model_case(device, case):
    """Forward and parameter gradients of a model on the grid: train mode
    with every dropout rate 0 (the flash gate is `flash_min_len`), loss
    sum(out^2) over the gathered global batch, gradients summed over the
    world; then the eval-mode forward (gate 2048: the plain branch)."""
    _grid(device, case)
    model, call = build_model(case["model"])
    model.load_state_dict(case["weights"])
    tl.set_dropout_rates(model, 0.0)
    d = case["inputs"]
    x, mask = _local(d["x"], True), _local(d["mask"], True)
    extra = _local(d["coords"], True) if "coords" in d else None
    if "cluster_id" in d:
        extra = _local(d["cluster_id"], True)
    elif "graph" in d:      # the batch's tables as `_ship` cuts them
        extra = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in mesh.shard_batch_2d({"graph": d["graph"]})["graph"].items()}
    t = _local(d["t"], False) if "t" in d else None
    rngs = tl.Rngs(device=torch.Generator().manual_seed(0),
                   host=torch.Generator().manual_seed(1))
    model.train()
    out = comm.gather_rows(call(model, x, mask, extra, t, rngs))
    comm.for_backward((out ** 2).sum()).backward()
    comm.reduce_grads(model.parameters())
    model.eval()
    with torch.no_grad():
        out_eval = comm.gather_rows(call(model, x, mask, extra, t, None))
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()
             if p.grad is not None}
    mesh.set_grid(None)
    return {"out": out.detach().numpy(), "out_eval": out_eval.numpy(), "grads": grads}


def step_case(device, case):
    """Training steps of a handler built on the spawned world (its config
    names dp_devices / inst_devices): the given weights, dropout off unless
    the case keeps it (`dropout`), the given global batches (and, per batch,
    the label visibility, or None); returns the parameters after the last
    step and every step's metrics."""
    from advmil_tpu_torch.config import with_defaults
    from advmil_tpu_torch.main import handler_class
    h = handler_class(case["handler"])(with_defaults(case["cfg"]))
    models = ({"G": h.gen_model, "D": h.disc_model} if case["handler"] == "adv"
              else {"net": h.model})
    for name, m in models.items():
        m.load_state_dict(case["weights"][name])
        if not case.get("dropout"):
            tl.set_dropout_rates(m, 0.0)
    metrics = []
    visible = case.get("visible") or [None] * len(case["batches"])
    for batch, vis in zip(case["batches"], visible):
        met, _ = h.train_step(h._ship(batch, train=True, visible=vis), h.train_rngs)
        metrics.append({k: float(v) for k, v in met.items()})
    params = {name: {k: v.numpy().copy() for k, v in m.state_dict().items()}
              for name, m in models.items()}
    # the gradients of the last update, and AdaHessian's second moment of the
    # Hessian diagonal (the update divides by its root)
    grads = {name: {k: p.grad.numpy().copy() for k, p in m.named_parameters()
                    if p.grad is not None} for name, m in models.items()}
    opts = [getattr(h, "opt", None)]
    nu = {k: h.opt.state[p]["nu"].numpy().copy() for k, p in h.model.named_parameters()
          if p in h.opt.state} if type(opts[0]).__name__ == "AdaHessian" else None
    mesh.set_grid(None)
    return {"params": params, "metrics": metrics, "grads": grads, "nu": nu}


CASES = {"flash": flash_case, "model": model_case, "step": step_case}


def run_cases(rank, device, cases):
    out = {}
    for case in cases:
        out[case["name"]] = CASES[case["kind"]](device, case)
    return out
