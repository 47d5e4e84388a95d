"""The dp x inst process grid (counterpart of `advmil_tpu/parallel/mesh.py`).

The JAX package drives every device of a host from one process through a
`jax.sharding.Mesh`; the port runs one process per card instead. The world
of `dp * inst` ranks is laid out as the JAX mesh `reshape(dp, inst)`:
rank = dp_rank * inst + inst_rank. Bags are split over `dp` (each rank
holds rows [dp_rank * B / dp, (dp_rank + 1) * B / dp) of the global batch)
and, with `inst > 1`, the patch axis over `inst` (each rank holds whole
16-patch regions). Parameters and optimizer state are replicated.

The handler registers the grid here (`set_grid`, the counterpart of
`models.layers.set_inst_mesh`); the layers, the steps and the collectives
of `parallel/comm.py` read it. None (the default) is the single-process
run, where every helper here is the identity.

Random draws go through `rand_global`: every rank draws the tensor at its
global shape from the generator all ranks share (same seed, same order of
calls) and keeps its own block, so a rank's dropout masks and noise are
the single-process run's draws for the same rows.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

S2 = 16     # patches per 4x4 region: the patch axis splits in whole regions


@dataclass
class Grid:
    """One rank's place in the dp x inst grid and its process groups:
    `data_group` joins the ranks of one inst index (None when dp == 1),
    `inst_group` the ranks of one dp index (None when inst == 1).
    `backend` is the process group's; `device` the rank's."""
    dp: int
    inst: int
    rank: int
    data_group: object
    inst_group: object
    backend: str
    device: torch.device

    @property
    def world(self) -> int:
        return self.dp * self.inst

    @property
    def dp_rank(self) -> int:
        return self.rank // self.inst

    @property
    def inst_rank(self) -> int:
        return self.rank % self.inst


_GRID: Grid | None = None


def set_grid(grid: Grid | None) -> None:
    global _GRID
    _GRID = grid


def grid() -> Grid | None:
    """The registered grid, or None in a single-process run."""
    return _GRID


def inst_grid() -> Grid | None:
    """The registered grid when it splits the patch axis (inst > 1)."""
    return _GRID if _GRID is not None and _GRID.inst > 1 else None


def make_grid(dp: int, inst: int, device: torch.device) -> Grid:
    """Build the grid over the initialised default process group (world size
    dp * inst). Every rank creates every subgroup, in the same order, as
    `torch.distributed.new_group` requires."""
    import torch.distributed as tdist

    world = tdist.get_world_size()
    if world != dp * inst:
        raise ValueError(f"process group has {world} ranks, the grid needs "
                         f"dp {dp} x inst {inst} = {dp * inst}")
    rank = tdist.get_rank()
    data_group = inst_group = None
    if dp > 1:
        for i in range(inst):
            g = tdist.new_group([d * inst + i for d in range(dp)])
            if rank % inst == i:
                data_group = g
    if inst > 1:
        for d in range(dp):
            g = tdist.new_group([d * inst + i for i in range(inst)])
            if rank // inst == d:
                inst_group = g
    return Grid(dp=dp, inst=inst, rank=rank, data_group=data_group,
                inst_group=inst_group, backend=tdist.get_backend(), device=device)


# ---------------------------------------------------------------------------
# local slices of a global host batch
# ---------------------------------------------------------------------------

def block_slice(n: int, parts: int, index: int, what: str) -> slice:
    per = n // parts
    if per * parts != n:
        raise ValueError(f"{what} {n} does not split over {parts} ranks")
    return slice(index * per, (index + 1) * per)


def row_slice(n_global: int, g: Grid | None = None) -> slice:
    """This rank's rows of a [n_global, ...] batch: the dp axis's block
    (the JAX package's `process_local_slice`)."""
    g = g or _GRID
    if g is None:
        return slice(0, n_global)
    return block_slice(n_global, g.dp, g.dp_rank, "global batch")


def inst_slice(n_global: int, g: Grid | None = None) -> slice:
    """This rank's share of an instance axis of length n_global."""
    g = g or _GRID
    if g is None or g.inst == 1:
        return slice(0, n_global)
    return block_slice(n_global, g.inst, g.inst_rank, "instance axis")


# patch-axis arrays: split over N as well as B under inst (region coords [B, L, 2]
# split over L, which is N / 16; the dense graph route's edge tables [B, N, epn]
# over their node rows, whose indices stay global). The banded and grid
# routes' tables stay whole: every rank aggregates the whole bag.
BY_INSTANCE = ("feats", "mask", "cluster_id", "coords", "edge_src", "edge_mask")


def shard_batch(batch: dict, g: Grid | None = None) -> dict:
    """This rank's rows of every array of a host batch dict (dicts one level
    deep, as the graph tables, are sliced per entry)."""
    g = g or _GRID
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = shard_batch(v, g)
        elif v is None:
            out[k] = None
        else:
            out[k] = v[row_slice(len(v), g)]
    return out


def shard_batch_2d(batch: dict, g: Grid | None = None) -> dict:
    """As `shard_batch`, and the patch axis (dim 1) of `BY_INSTANCE` arrays
    over inst."""
    g = g or _GRID
    out = shard_batch(batch, g)
    if g is None or g.inst == 1:
        return out

    def cut(d):
        for k in BY_INSTANCE:
            if k in d and d[k] is not None:
                d[k] = d[k][:, inst_slice(d[k].shape[1], g)]
    cut(out)
    for v in out.values():
        if isinstance(v, dict):
            cut(v)
    return out


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor that every rank holds whole."""
    if _GRID is None or _GRID.dp == 1:
        return x
    return x[row_slice(x.shape[0])]


# ---------------------------------------------------------------------------
# random draws at the global shape
# ---------------------------------------------------------------------------

def rand_global(shape, generator, device, *, batch_dim: int = 0, inst_dim=None,
                normal: bool = False) -> torch.Tensor:
    """U[0, 1) (or N(0, 1) with `normal`) of the local `shape`: drawn at the
    global shape (dim `batch_dim` times dp, dim `inst_dim` times inst) and
    cut to this rank's block, so the values are those the single-process run
    draws for the same elements."""
    shape = list(shape)
    g = _GRID
    draw = torch.randn if normal else torch.rand
    if g is None or g.world == 1:
        return draw(shape, generator=generator, device=device)
    full = list(shape)
    bd = batch_dim % len(shape)
    full[bd] *= g.dp
    idim = None
    if inst_dim is not None and g.inst > 1:
        idim = inst_dim % len(shape)
        full[idim] *= g.inst
    x = draw(full, generator=generator, device=device)
    x = x.narrow(bd, g.dp_rank * shape[bd], shape[bd])
    if idim is not None:
        x = x.narrow(idim, g.inst_rank * shape[idim], shape[idim])
    return x
