"""Explicit SPMD over a ``DeviceMesh``: the local shard each rank computes
on, and the collectives between shards, each recorded in the dispatch
ledger (``ops.collective_report()``) so none on a kernel's path is silent.

The serving paths run every registry op on local shards — a rank's rows of
a batch-sharded batch (the ``"data"``/``"pod"`` axes), its experts of a
model-sharded expert stack (``"model"``) — and move data between ranks
only here: the all-reduce of expert-parallel partial outputs
(``core/moe.py:apply_moe_ep_local``), the all-gather of the paged waves'
rows (``serve/expert_cache.py``), the all-gather of the router's logits
of a data-split batch (``core/moe.py:route_split``), and the
all-gather of a batch's sampled tokens.  Every tensor is a plain local
one: a rank's weights are the full tensors, narrowed to its own experts
where a layer shards them.

:func:`init_mesh` builds the mesh over an initialised default process
group (``torch.distributed.init_process_group``; NCCL on the card, gloo on
the CPU); ``launch/serve.py --mesh`` and the tests set that up.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence

import torch

from repro_torch.dist.sharding import P, _trim_spec, axis_names, axis_sizes

__all__ = ["init_mesh", "axis_size", "axis_index", "batch_shard",
           "batch_rows", "all_reduce", "all_gather", "gather_batch",
           "batch_split", "current_split"]

_SPLIT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_batch_split", default=None)


def init_mesh(shape: Sequence[int], names: Sequence[str] = ("data", "model"),
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group (whose
    world size must be the product of ``shape``)."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} holds "
                         f"{math.prod(shape)} ranks but the world size is "
                         f"{world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def axis_size(mesh, axis: str) -> int:
    return axis_sizes(mesh).get(axis, 1) if mesh is not None else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 where the mesh lacks it)."""
    if mesh is None or axis not in axis_names(mesh):
        return 0
    return mesh.get_local_rank(axis)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def batch_shard(n: int, rules) -> tuple[int, int, tuple]:
    """(shards, this rank's shard, axes) of a batch dim of ``n`` rows under
    ``rules``: the trimmed batch entry's axes, major first (the reference's
    spec order); (1, 0, ()) without rules or where the axes do not divide
    ``n`` (replicated, as ``_trim_spec`` replicates it)."""
    if rules is None or rules.mesh is None:
        return 1, 0, ()
    axes = _entry_axes(_trim_spec((n,), P(rules.batch_entry), rules.mesh)[0])
    shards, index = 1, 0
    for a in axes:
        size = axis_size(rules.mesh, a)
        shards *= size
        index = index * size + axis_index(rules.mesh, a)
    return shards, index, axes


def batch_rows(n: int, rules) -> slice:
    """This rank's rows of a batch dim of ``n`` under ``rules``."""
    shards, index, _ = batch_shard(n, rules)
    per = n // shards
    return slice(index * per, (index + 1) * per)


def _record(kind: str, axis: str, t: torch.Tensor, where: str) -> None:
    """Every collective is recorded, one over a single rank too (it is
    then skipped: nothing moves)."""
    from repro_torch.ops.registry import record_collective

    record_collective(kind, axis, t.numel() * t.element_size(), where)


def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group's ranks, with its gradient: every rank's loss
    reads the sum, so an input's gradient is the group's summed output
    gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _sum_over(t, group)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g.contiguous(), ctx.group), None


def all_reduce(t: torch.Tensor, mesh, axis: str, where: str,
               op: str = "sum") -> torch.Tensor:
    """Sum (or mean) of ``t`` over the ranks of ``axis``, differentiable
    where ``t`` needs a gradient.  Returns a new tensor."""
    _record("all_reduce", axis, t, where)
    if axis_size(mesh, axis) == 1:     # one rank: nothing to move
        return t.clone()
    group = mesh.get_group(axis)
    if torch.is_grad_enabled() and t.requires_grad:
        out = _AllReduceSum.apply(t, group)
    else:
        out = _sum_over(t, group)
    if op == "mean":
        out = out / axis_size(mesh, axis)
    return out


def all_gather(t: torch.Tensor, mesh, axis: str, where: str,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` concatenated on ``dim`` (rank
    order: this axis's coordinate)."""
    import torch.distributed as dist

    _record("all_gather", axis, t, where)
    if axis_size(mesh, axis) == 1:     # one rank: nothing to move
        return t
    group = mesh.get_group(axis)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def gather_batch(t: torch.Tensor, rules, n: int, where: str,
                 dim: int = 0) -> torch.Tensor:
    """The whole batch of ``n`` rows from every rank's local rows of
    ``t`` on ``dim``: all-gathers over the batch axes, minor axis first,
    so the rows come back in the reference's major-to-minor order."""
    _, _, axes = batch_shard(n, rules)
    for a in reversed(axes):
        t = all_gather(t, rules.mesh, a, where, dim)
    return t


@contextlib.contextmanager
def batch_split(rules, n: int):
    """Mark the forwards inside as running on this rank's rows of a batch
    of ``n`` (a no-op mark where the batch axes do not split it): the MoE
    layers read it to route the batch's global groups
    (``core/moe.py:apply_moe``)."""
    split = (rules, n) if rules is not None and rules.mesh is not None \
        and batch_shard(n, rules)[0] > 1 else None
    token = _SPLIT.set(split)
    try:
        yield split
    finally:
        _SPLIT.reset(token)


def current_split():
    """(rules, n) of the batch the running forward holds a shard of, or
    None."""
    return _SPLIT.get()
