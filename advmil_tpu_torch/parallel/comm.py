"""The collectives of the dp x inst grid, with their backward rules.

JAX differentiates through its collectives by transposition: an
all-gather's cotangent is reduce-scattered, a psum's is psum-ed. The
differentiable collectives here follow the same rule, and each backward is
itself one of them, so a double backward (AdaHessian's Hutchinson
estimate) goes through the collectives too:

- `_AllGather` (concatenate the group's pieces): backward reduce-scatters
  the cotangent (sum over the group, keep this rank's piece);
- `_ReduceScatter`: backward all-gathers;
- `_AllReduce` (sum): backward all-reduces.

`torch.distributed.nn` gives its all-gather the same sum rule; it is not
used, so the rule is written down where it runs. With these transposes the
per-rank gradients, summed over the world, are the gradient of
(1 / world) * the sum of every rank's loss. Every rank computes the same
global loss from gathered outputs, so each one back-propagates
`loss / world` (`for_backward`) and the sum (`reduce_grads`) is the
single-process gradient of the global loss.

NCCL and gloo (ranks that share a card, or the CPU) take the same calls:
torch's gloo backend accepts CUDA tensors for all_reduce, all_gather and
reduce_scatter_tensor (`chip_smoke.py` phase 32 checks each on the card)
and stages them through pinned host memory itself, so nothing here copies
to the host for it; a collective's time on ranks that share a card is
gloo's, host copies included, not NCCL's. Outside a grid (single process)
every function here is the identity.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

from . import mesh

def group_size(group) -> int:
    """Ranks in `group` (None: the world); 1 without a process group."""
    return tdist.get_world_size(group) if tdist.is_initialized() else 1


def all_reduce(x: torch.Tensor, group=None, op=tdist.ReduceOp.SUM) -> torch.Tensor:
    """The group's reduction of x (a new tensor). `group=None` is the world."""
    if group_size(group) == 1:
        return x
    y = x.detach().clone()
    tdist.all_reduce(y, op=op, group=group)
    return y


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group members' x concatenated along `dim` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return x
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    tdist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's piece (along `dim`) of the group's sum of x."""
    n = group_size(group)
    if n == 1:
        return x
    xs = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((xs.shape[0] // n,) + tuple(xs.shape[1:]),
                      dtype=xs.dtype, device=xs.device)
    tdist.reduce_scatter_tensor(out, xs, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceScatter.apply(grad, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _AllGather.apply(grad, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, ctx.group), None


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Differentiable all-gather (backward: reduce-scatter). In these two
    wrappers `group` None is the world."""
    return x if group_size(group) == 1 else _AllGather.apply(x, dim, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce sum (backward: all-reduce sum)."""
    return x if group_size(group) == 1 else _AllReduce.apply(x, group)


# ---------------------------------------------------------------------------
# the grid's axes
# ---------------------------------------------------------------------------

def _data_group():
    g = mesh.grid()
    return None if g is None or g.dp == 1 else g.data_group


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch of per-bag values [B/dp, ...] -> [B, ...] on every
    rank (differentiable)."""
    group = _data_group()
    return x if group is None else gather(x, 0, group)


def gather_rows_nograd(x: torch.Tensor) -> torch.Tensor:
    group = _data_group()
    return x if group is None else all_gather(x, 0, group)


def inst_gather(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole instance axis from every inst rank's share (differentiable)."""
    g = mesh.inst_grid()
    return x if g is None else gather(x, dim, g.inst_group)


def inst_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the inst ranks' partial results (differentiable)."""
    g = mesh.inst_grid()
    return x if g is None else psum(x, g.inst_group)


def inst_max(x: torch.Tensor) -> torch.Tensor:
    """Max over the inst ranks, outside autograd (a softmax's shift)."""
    g = mesh.inst_grid()
    return x if g is None else all_reduce(x.detach(), g.inst_group, tdist.ReduceOp.MAX)


def world_size() -> int:
    g = mesh.grid()
    return 1 if g is None else g.world


def for_backward(loss: torch.Tensor) -> torch.Tensor:
    """The share of a replicated global loss that one rank back-propagates:
    loss / world (see the module docstring); the loss itself in a
    single-process run."""
    w = world_size()
    return loss if w == 1 else loss * (1.0 / w)


@torch.no_grad()
def reduce_grads(params) -> None:
    """Sum every parameter's gradient over the world in one flat buffer (one
    collective a phase; the parameters are f32); None gradients stay None."""
    ps = [p for p in params if p.grad is not None]
    for p, g in zip(ps, reduce_tensors([p.grad for p in ps])):
        p.grad = g


def reduce_tensors(tensors: list) -> list:
    """The world's sums of a list of same-dtype tensors, in one collective."""
    if world_size() == 1 or not tensors:
        return list(tensors)
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]))
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out
