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
one: a rank's weights are its blocks of the full tensors (its experts of
an ``ep_local`` stack, its heads and columns of a dense weight split over
``model``), the rest whole.

The tensor-parallel blocks (``models/layers.py``, serving and training)
move data over ``model`` through :func:`model_input` (the replicated
input of a column block), :func:`model_sum` (the float32 partials of a
row block: attention's ``wo``, the MLP's and the shared experts' down
projections, the vocab-parallel embedding, the vocab-parallel loss's sum
of exps and label logit), :func:`model_max` (the loss's shift) and
:func:`model_gather` (the head's vocabulary blocks of the logits, before
sampling), over the active rules' mesh.

Training (``train/step.py``) stores each parameter as its block under
the rules' spec, gathers it before use over the axes its layout does not
keep local (:func:`gather_param`: over the batch axes alone for a leaf
the ``model`` ranks compute on their blocks of) and reduces its gradient
back to the block (:func:`reduce_param_grad`).  The
collectives' gradients follow one rule: a rank's loss is its *share* of
the global loss over the batch axes (:data:`BATCH_AXES`) and the *same*
loss on every rank of ``model``.  So a batch-axis all-reduce sums its
output gradient and a batch-axis all-gather reduce-scatters it, while
over ``model`` an all-reduce passes its gradient through (the Megatron
``g``), an all-gather takes this rank's block, and :func:`copy_to` (the
Megatron ``f``) sums the gradient of an input each rank uses for a part
of the output.

:func:`init_mesh` builds the mesh over an initialised default process
group (``torch.distributed.init_process_group``; NCCL on the card, gloo on
the CPU); ``launch/serve.py --mesh``, ``launch/train.py --mesh local`` and
the tests set that up.  :class:`VirtualMesh` is a device-free mesh for the
dry-run: its collectives take ``meta`` tensors only.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence

import torch

from repro_torch.dist.sharding import P, _trim_spec, axis_names, axis_sizes

__all__ = ["init_mesh", "VirtualMesh", "BATCH_AXES", "axis_size",
           "axis_index", "batch_shard", "batch_rows", "all_reduce",
           "all_gather", "reduce_scatter", "copy_to", "gather_param",
           "reduce_param_grad", "rank", "world_max", "gather_batch",
           "batch_split", "current_split", "batch_shards", "batch_total",
           "model_rank", "model_input", "model_sum", "model_max",
           "model_gather"]

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


def batch_shard(n: int, rules, axes=None) -> tuple[int, int, tuple]:
    """(shards, this rank's shard, axes) of a batch dim of ``n`` rows under
    ``rules``: the trimmed batch entry's axes (only those of ``axes`` where
    given), major first (the reference's spec order); (1, 0, ()) without
    rules or where the axes do not divide ``n`` (replicated, as
    ``_trim_spec`` replicates it)."""
    if rules is None or rules.mesh is None:
        return 1, 0, ()
    entry = rules.batch_entry
    if axes is not None:
        entry = tuple(a for a in _entry_axes(entry) if a in axes) or None
    axes = _entry_axes(_trim_spec((n,), P(entry), rules.mesh)[0])
    shards, index = 1, 0
    for a in axes:
        size = axis_size(rules.mesh, a)
        shards *= size
        index = index * size + axis_index(rules.mesh, a)
    return shards, index, axes


def batch_rows(n: int, rules, axes=None) -> slice:
    """This rank's rows of a batch dim of ``n`` under ``rules`` (over
    ``axes`` only, where given)."""
    shards, index, _ = batch_shard(n, rules, axes)
    per = n // shards
    return slice(index * per, (index + 1) * per)


#: the axes a batch is split over: a rank's loss is its share of the
#: global loss over these, and replicated over the others (``model``)
BATCH_AXES = ("pod", "data")


class VirtualMesh:
    """A device-free mesh: a shape and axis names, seen from rank 0.

    The dry-run runs rank 0's share of a production mesh on ``meta``
    through it: its collectives take only ``meta`` tensors and return a
    ``meta`` result of the shape the real collective would give, recorded
    like any other.  A collective on it with a real tensor raises: it
    moves no data."""

    def __init__(self, shape: Sequence[int], names: Sequence[str]):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                             f"{tuple(names)} differ in length")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(names)

    @property
    def axis_names(self) -> tuple:
        return self.mesh_dim_names

    def size(self) -> int:
        import math

        return math.prod(self.shape)

    def get_local_rank(self, axis: str) -> int:
        return 0

    def get_group(self, axis: str):
        raise ValueError("a device-free mesh has no process group")

    def __repr__(self) -> str:
        return (f"VirtualMesh({'x'.join(map(str, self.shape))}, "
                f"{self.mesh_dim_names})")


def _virtual(mesh, t: torch.Tensor) -> bool:
    """True on a device-free mesh, whose collectives take ``meta`` tensors
    only."""
    if not isinstance(mesh, VirtualMesh):
        return False
    if t.device.type != "meta":
        raise ValueError(f"a collective on the device-free {mesh!r} got a "
                         f"tensor on {t.device}: it moves no data and takes "
                         f"meta tensors only")
    return True


def _record(kind: str, axis: str, nbytes: int, where: str) -> None:
    """Every collective is recorded with the bytes a rank receives (its
    output), one over a single rank too (it is then skipped: nothing
    moves); under an active cost counter its bytes are counted too."""
    from repro_torch.ops.registry import record_collective
    from repro_torch.roofline.op_cost import active

    record_collective(kind, axis, nbytes, where)
    counter = active()
    if counter is not None:
        counter.collective(kind, axis, nbytes)


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _raw_sum(t: torch.Tensor, mesh, axis: str,
             op: str = "sum") -> torch.Tensor:
    """The sum (or the max) of ``t`` over ``axis``'s ranks, a new
    tensor."""
    if _virtual(mesh, t):
        return t.clone()
    import torch.distributed as dist

    out = t.contiguous().clone()
    with torch.profiler.record_function("spmd.all_reduce"):
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return out


def _raw_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` concatenated on ``dim``."""
    n = axis_size(mesh, axis)
    if _virtual(mesh, t):
        shape = list(t.shape)
        shape[dim] *= n
        return t.new_empty(shape)
    import torch.distributed as dist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    with torch.profiler.record_function("spmd.all_gather"):
        dist.all_gather(parts, t, group=mesh.get_group(axis))
    return torch.cat(parts, dim)


def _own(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` split over ``axis``."""
    per = t.shape[dim] // axis_size(mesh, axis)
    return t.narrow(dim, axis_index(mesh, axis) * per, per)


def _sums_grad(axis: str) -> bool:
    """Whether a collective's backward sums over ``axis``: over a batch
    axis each rank's loss is its share, so a value every rank reads gets
    the ranks' summed gradient; over ``model`` the ranks hold the same
    loss, so each already has the whole gradient."""
    return axis in BATCH_AXES


class _AllReduce(torch.autograd.Function):
    """The sum over ``axis``; backward: the summed output gradient over a
    batch axis, the output gradient itself over ``model`` (the Megatron
    ``g``: every rank's loss reads the one sum)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, where):
        ctx.mesh, ctx.axis, ctx.where = mesh, axis, where
        return _raw_sum(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        if not _sums_grad(ctx.axis):
            return g, None, None, None
        _record("all_reduce", ctx.axis, _bytes(g), ctx.where + " (backward)")
        return _raw_sum(g, ctx.mesh, ctx.axis), None, None, None


class _AllGather(torch.autograd.Function):
    """The ranks' blocks along ``dim``; backward: this rank's block of the
    output gradient, summed over the ranks first over a batch axis (a
    reduce-scatter), taken as it is over ``model``."""

    @staticmethod
    def forward(ctx, t, mesh, axis, where, dim):
        ctx.mesh, ctx.axis, ctx.where, ctx.dim = mesh, axis, where, dim
        return _raw_gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if _sums_grad(ctx.axis):
            g = _raw_sum(g, ctx.mesh, ctx.axis)
        out = _own(g, ctx.mesh, ctx.axis, ctx.dim)
        if _sums_grad(ctx.axis):
            _record("reduce_scatter", ctx.axis, _bytes(out),
                    ctx.where + " (backward)")
        return out, None, None, None, None


class _CopyTo(torch.autograd.Function):
    """The identity, whose backward sums the gradient over ``axis`` (the
    Megatron ``f``): the input of a layer whose ranks each compute a part
    of the output from the same replicated input."""

    @staticmethod
    def forward(ctx, t, mesh, axis, where):
        ctx.mesh, ctx.axis, ctx.where = mesh, axis, where
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        _record("all_reduce", ctx.axis, _bytes(g), ctx.where + " (backward)")
        return _raw_sum(g, ctx.mesh, ctx.axis), None, None, None


def all_reduce(t: torch.Tensor, mesh, axis: str, where: str,
               op: str = "sum") -> torch.Tensor:
    """Sum (or mean, or max) of ``t`` over the ranks of ``axis``, the sum
    and the mean differentiable where ``t`` needs a gradient (see
    :class:`_AllReduce`); the max carries none (a constant, as the
    loss's shift).  Returns a new tensor."""
    _record("all_reduce", axis, _bytes(t), where)
    if axis_size(mesh, axis) == 1:     # one rank: nothing to move
        return t.detach().clone() if op == "max" else t.clone()
    if op == "max":
        return _raw_sum(t.detach(), mesh, axis, "max")
    if torch.is_grad_enabled() and t.requires_grad:
        out = _AllReduce.apply(t, mesh, axis, where)
    else:
        out = _raw_sum(t, mesh, axis)
    if op == "mean":
        out = out / axis_size(mesh, axis)
    return out


def copy_to(t: torch.Tensor, mesh, axis: str, where: str) -> torch.Tensor:
    """``t`` as it is, its gradient summed over ``axis`` in the backward
    (:class:`_CopyTo`)."""
    if axis_size(mesh, axis) == 1 or not (torch.is_grad_enabled()
                                          and t.requires_grad):
        return t
    return _CopyTo.apply(t, mesh, axis, where)


def all_gather(t: torch.Tensor, mesh, axis: str, where: str,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` concatenated on ``dim`` (rank
    order: this axis's coordinate), differentiable (see
    :class:`_AllGather`)."""
    _record("all_gather", axis, _bytes(t) * axis_size(mesh, axis), where)
    if axis_size(mesh, axis) == 1:     # one rank: nothing to move
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllGather.apply(t, mesh, axis, where, dim)
    return _raw_gather(t, mesh, axis, dim)


def reduce_scatter(t: torch.Tensor, mesh, axis: str, where: str,
                   dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``t`` over ``axis``'s
    ranks (an all-reduce and a narrow: gloo has no reduce-scatter; the
    record counts the block a rank keeps)."""
    size = axis_size(mesh, axis)
    _record("reduce_scatter", axis, _bytes(t) // size, where)
    if size == 1:
        return t
    return _own(_raw_sum(t, mesh, axis), mesh, axis, dim).contiguous()


def _gathered_axes(spec, mesh, keep=()) -> list:
    """(dim, axis) of every sharded dim's axes a parameter gather runs
    over, in gather order: dims in order, each dim's axes minor first."""
    names = axis_names(mesh)
    out = []
    for dim, entry in enumerate(spec):
        axes = [a for a in _entry_axes(entry) if a in names and a not in keep]
        out.extend((dim, a) for a in reversed(axes))
    return out


def reduce_param_grad(g: torch.Tensor, spec, mesh, keep=(),
                      where: str = "param grad") -> torch.Tensor:
    """The gradient of a parameter's local block from the gradient ``g``
    of its gathered form (:func:`gather_param`'s backward): each gathered
    batch axis reduce-scatters (sum) it, each gathered ``model`` axis takes
    this rank's block (the ranks computed the same rows, or summed their
    parts already: the whole k/v of an attention whose q heads split pass
    through :func:`model_input`), and a batch axis the parameter is
    replicated over sums it."""
    for dim, axis in reversed(_gathered_axes(spec, mesh, keep)):
        if _sums_grad(axis):
            g = reduce_scatter(g, mesh, axis, where, dim)
        elif axis_size(mesh, axis) > 1:
            g = _own(g, mesh, axis, dim).contiguous()
    sharded = {a for e in spec for a in _entry_axes(e)}
    for axis in BATCH_AXES:
        if axis in axis_names(mesh) and axis not in sharded:
            _record("all_reduce", axis, _bytes(g), where)
            if axis_size(mesh, axis) > 1:
                g = _raw_sum(g, mesh, axis)
    return g


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, spec, mesh, keep, where):
        ctx.spec, ctx.mesh, ctx.keep, ctx.where = spec, mesh, keep, where
        for dim, axis in _gathered_axes(spec, mesh, keep):
            _record("all_gather", axis, _bytes(t) * axis_size(mesh, axis),
                    where)
            if axis_size(mesh, axis) > 1:
                t = _raw_gather(t, mesh, axis, dim)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (reduce_param_grad(g, ctx.spec, ctx.mesh, ctx.keep,
                                  ctx.where + " (backward)"),
                None, None, None, None)


def gather_param(t: torch.Tensor, spec, mesh, keep=(),
                 where: str = "param gather") -> torch.Tensor:
    """The whole parameter from this rank's block ``t`` stored under
    ``spec`` (a trimmed spec of the whole shape): an all-gather over each
    sharded dim's axes but those in ``keep`` (``model`` for a leaf its
    ranks compute on their blocks of: the tensor-parallel dense blocks,
    an ``ep_local`` expert stack).  Differentiable: the backward is
    :func:`reduce_param_grad`."""
    return _GatherParam.apply(t, spec, mesh, tuple(keep), where)


def rank() -> int:
    """This process's rank in the default process group (0 without
    one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def world_max(x: float, mesh, where: str) -> float:
    """The largest ``x`` over every rank of ``mesh`` (one host value: the
    ranks then take the same host decisions)."""
    if mesh is None or isinstance(mesh, VirtualMesh):
        return x
    import torch.distributed as dist

    t = torch.tensor([x], dtype=torch.float64,
                     device=getattr(mesh, "device_type", "cpu"))
    _record("all_reduce", "world", _bytes(t), where)
    if dist.get_world_size() > 1:
        with torch.profiler.record_function("spmd.all_reduce"):
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


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


def batch_shards() -> int:
    """The number of shards the running forward's batch is split into (1
    outside :func:`batch_split`)."""
    split = current_split()
    return 1 if split is None else batch_shard(split[1], split[0])[0]


def batch_total(t: torch.Tensor, where: str) -> torch.Tensor:
    """The sum of ``t`` over the ranks holding the running forward's
    batch (its batch axes; ``t`` itself outside a split), differentiable:
    a loss that needs a statistic of the whole batch (a masked token
    count, a mean inside a square root) reads it so."""
    split = current_split()
    if split is None:
        return t
    rules, n = split
    for a in batch_shard(n, rules)[2]:
        t = all_reduce(t, rules.mesh, a, where)
    return t


def _model_mesh():
    """The active rules' mesh: a block holding a shard of its weights
    computes under them."""
    from repro_torch.dist.sharding import current_rules

    rules = current_rules()
    if rules is None or rules.mesh is None:
        raise ValueError("a block holding a shard of its weights runs under "
                         "the sharding rules of its mesh (use_rules)")
    return rules.mesh


def model_rank() -> int:
    """This rank's coordinate along ``model`` of the active rules' mesh:
    the index of its weights' blocks."""
    return axis_index(_model_mesh(), "model")


def model_input(t: torch.Tensor, where: str) -> torch.Tensor:
    """The replicated input of a column block (:func:`copy_to` over
    ``model``: the identity, its gradient summed over the ranks)."""
    return copy_to(t, _model_mesh(), "model", where)


def model_sum(t: torch.Tensor, where: str) -> torch.Tensor:
    """The ranks' partial sums ``t`` added over ``model``
    (:func:`all_reduce`)."""
    return all_reduce(t, _model_mesh(), "model", where)


def model_max(t: torch.Tensor, where: str) -> torch.Tensor:
    """The ranks' ``t`` reduced by max over ``model``, no gradient
    (:func:`all_reduce` with ``op="max"``)."""
    return all_reduce(t, _model_mesh(), "model", where, op="max")


def model_gather(t: torch.Tensor, where: str, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks ``t`` concatenated on ``dim`` over ``model``
    (:func:`all_gather`)."""
    return all_gather(t, _model_mesh(), "model", where, dim)
