"""The cost of what runs: the port's counterpart of
``repro.roofline.hlo_cost``.

The reference parses the optimized HLO of a compiled step.  PyTorch runs
eagerly and has no HLO, so the port counts the step as it runs, on any
device (the dry-run runs it on ``meta``, where nothing is computed):

* **Registry ops** (``ops/registry.py:dispatch``).  While a counter is
  active, the registry hands each op to :meth:`CostCounter.registry_op`,
  which adds the op's *analytic* cost (the ``cost`` registered beside the
  op in ``ops/impls.py``, from its operands' shapes) and counts nothing
  beneath it.  The cost is the same whatever impl serves the op
  (``eager``, ``blocked``, ``cuda``, ``cuda_fused``): the kernels are
  launched through ``ctypes``, where no dispatch mode can see them, and a
  plain impl's own aten ops would count its algorithm, not the op.  The
  FLOPs follow the reference's HLO count of its plain (``xla``) path:
  2·M·N·K a product, attention over the whole Sq × Skv rectangle (the
  masked half of a causal one and a decode over the whole cache
  included), the expert products over the E × C capacity rows.
* **Everything else** (the PyTorch glue) through a
  ``TorchDispatchMode``: 2·M·N·K for ``mm``/``bmm``/``addmm``/
  ``baddbmm`` (``einsum`` and ``matmul`` reach the mode as these), one
  FLOP an element for float pointwise ops with transcendentals tallied
  apart (``TRANSCENDENTAL_WEIGHT``, as the reference's), one an input
  element for reductions; bytes as operands plus results; views and
  slices free; an in-place ``copy_``/``index_put_``/``scatter_`` counting
  its update only (read the update, write the region), as ``hlo_cost``
  counts ``dynamic-update-slice``.

Every count goes to the innermost scope marker open at the time
(``roofline/scope.py``), else ``"other"``; a backward run after the
forward's scopes have closed counts as ``"other"`` (the reference's HLO
names carry the forward's scope into the backward).

**Peak live bytes**, the counterpart of the reference's
``memory_analysis()`` temp bytes: every storage an op allocates during
the run adds its bytes when it appears and drops them when it is freed
(a ``weakref.finalize`` on the storage); the peak of that sum is kept.
Tensors that existed before the run (weights, caches, inputs) are not
counted.  Inside a *kernel* impl only the op's outputs count: the
kernel keeps its tiles on chip, while its plain version (run on the CPU
or on ``meta``) would materialize them.  Inside a plain impl everything
it allocates counts, as it does on the card.

**Collectives** (``dist/spmd.py``) are counted where they are recorded:
each adds the bytes a rank receives (its output: a whole gathered
tensor, a reduced one, the block a reduce-scatter keeps — the
reference's ``hlo_cost`` convention) to ``collective_bytes``, to
``collectives`` by kind (``{"all_gather": {"count", "bytes", "by_axis":
{axis: bytes}}, ...}``)
and to the scope's ``collective_bytes``.  One device records none, so
its ``collective_bytes`` is 0.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import asdict, dataclass, field
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.roofline import scope as S

__all__ = ["OpCost", "Part", "CostCounter", "count_cost", "active",
           "register_cost", "repeat", "TRANSCENDENTAL_WEIGHT"]

TRANSCENDENTAL_WEIGHT = 1.0

_aten = torch.ops.aten


class Part(NamedTuple):
    """One piece of a registry op's analytic cost."""

    flops: float
    bytes: float = 0.0
    transcendentals: float = 0.0
    scope: Optional[str] = None     # None: the scope the op ran in
    op: Optional[str] = None        # ``by_op`` key; None: the op's name


@dataclass
class OpCost:
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = field(default_factory=dict)  # kind -> counts
    by_scope: dict = field(default_factory=dict)  # scope -> counts
    by_op: dict = field(default_factory=dict)     # op ("aten": glue) -> counts
    peak_live_bytes: float = 0.0

    def add(self, scope: str, op: str, flops: float = 0.0,
            nbytes: float = 0.0, transcendentals: float = 0.0) -> None:
        flops = float(flops)
        self.flops += flops
        self.transcendentals += transcendentals
        self.bytes_accessed += nbytes
        sc = self.by_scope.setdefault(scope, {
            "flops": 0.0, "bytes": 0.0, "transcendentals": 0.0,
            "collective_bytes": 0.0})
        sc["flops"] += flops
        sc["bytes"] += nbytes
        sc["transcendentals"] += transcendentals
        oc = self.by_op.setdefault(op, {"flops": 0.0, "bytes": 0.0,
                                        "calls": 0})
        oc["flops"] += flops
        oc["bytes"] += nbytes

    def to_dict(self) -> dict:
        return asdict(self)


# ------------------------------------------------------- registry op costs

_COSTS: dict[str, Callable] = {}


def register_cost(op: str, fn: Callable) -> None:
    """``fn(*args, **kwargs) -> [Part, ...]``: the analytic cost of one
    call of registry op ``op`` (the arguments its impls take, without the
    policy)."""
    _COSTS[op] = fn


# ------------------------------------------------------------ aten glue

_PRODUCTS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default, _aten.mv.default, _aten.dot.default,
             _aten.addmv.default}
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "rsqrt",
    "sqrt", "tanh", "sigmoid", "erf", "erfc", "sin", "cos", "tan", "atan2",
    "erfinv", "reciprocal",
}
#: pointwise ops that stand for several HLO elementwise ops: (flops,
#: transcendentals) per element, as the reference's plain forms lower
_COMPOSITE = {
    "silu": (2, 1),                 # x · logistic(x)
    "gelu": (5, 1),                 # x · 0.5 · (1 + erf(x / √2))
    "softplus": (4, 2),             # logaddexp(x, 0)
    "log_sigmoid_forward": (4, 2),  # −softplus(−x)
    "_softmax": (5, 1),             # max, sub, exp, sum, div
    "_log_softmax": (5, 1),
    "pow": (1, 0),                  # integer powers lower to multiplies
}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_local_scalar_dense", "detach", "alias",
         "lift_fresh", "set", "resize", "record_stream"}
_REDUCTIONS_EXTRA = {"mean": 1, "var": 3, "std": 4, "var_mean": 3,
                     "std_mean": 4}
#: copies, casts and fills: bytes, no FLOPs (a ``convert`` is free in the
#: reference's count too)
_MOVES = {"clone", "_to_copy", "copy", "lift_fresh_copy", "zeros_like",
          "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
          "scalar_tensor", "alias_copy", "expand_copy", "view_copy",
          "detach_copy", "masked_fill"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """Bytes an operand moves: its elements, a broadcast (stride-0) axis
    counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _product_flops(func, args, out) -> float:
    if func in (_aten.mm.default, _aten.addmm.default):
        a = args[0] if func is _aten.mm.default else args[1]
        m, k = a.shape
        n = out.shape[-1]
        return 2.0 * m * n * k + (m * n if func is _aten.addmm.default
                                  else 0)
    if func in (_aten.bmm.default, _aten.baddbmm.default):
        a = args[0] if func is _aten.bmm.default else args[1]
        b, m, k = a.shape
        n = out.shape[-1]
        return 2.0 * b * m * n * k + (b * m * n
                                      if func is _aten.baddbmm.default
                                      else 0)
    if func in (_aten.mv.default, _aten.addmv.default):
        a = args[0] if func is _aten.mv.default else args[1]
        return 2.0 * a.shape[0] * a.shape[1]
    return 2.0 * args[0].numel()                              # dot


_GATHERS = {"embedding", "index_select", "gather", "index", "take",
            "take_along_dim"}
_INPLACE_UPDATES = {"copy", "index_put", "scatter", "scatter_add",
                    "scatter_reduce", "index_add", "index_copy",
                    "masked_scatter"}


def _glue_cost(func, args, kwargs, outs, in_storages) -> tuple:
    """(flops, transcendentals, bytes) of one aten op of the glue."""
    base = func.__name__.split(".")[0].rstrip("_")
    if base in _FREE:
        return 0.0, 0.0, 0.0
    mutable = func._schema.is_mutable
    if not mutable and outs and all(
            o.untyped_storage()._cdata in in_storages for o in outs):
        return 0.0, 0.0, 0.0                      # a view or an alias
    ins = _tensors((args, kwargs))
    if mutable and base in ("fill", "zero"):
        return 0.0, 0.0, float(_nbytes(ins[0]))
    if mutable and base in _INPLACE_UPDATES:
        # in place: read the update, write the region it covers (plus the
        # indices read), as hlo_cost counts a dynamic-update-slice
        values, index = ins[-1], ins[1:-1]
        return 0.0, 0.0, 2.0 * _nbytes(values) + sum(_nbytes(t)
                                                     for t in index)
    if base in _GATHERS:
        # a gather reads the rows it picks, not its whole source: the
        # result's bytes read and written, plus the indices (hlo_cost's
        # ``gather``)
        out_b = sum(_nbytes(o) for o in outs)
        return 0.0, 0.0, 2.0 * out_b + sum(
            _nbytes(t) for t in ins if not t.is_floating_point())
    nbytes = float(sum(_nbytes(t) for t in ins)
                   + sum(_nbytes(o) for o in outs))
    if func in _PRODUCTS:
        return _product_flops(func, args, outs[0]), 0.0, nbytes
    if base == "convolution":
        w = args[1]
        return (2.0 * outs[0].numel() * w.shape[1] * math.prod(w.shape[2:]),
                0.0, nbytes)
    if base in _MOVES or not any(t.is_floating_point() for t in ins):
        return 0.0, 0.0, nbytes                   # moves; integer math
    if torch.Tag.reduction in func.tags or base in _REDUCTIONS_EXTRA:
        src = ins[0].numel()
        extra = _REDUCTIONS_EXTRA.get(base, 0)
        extra *= src if base != "mean" else sum(o.numel() for o in outs)
        return float(src + extra), 0.0, nbytes
    n = max(o.numel() for o in outs) if outs else 0
    if base in _COMPOSITE:
        f, tr = _COMPOSITE[base]
        if base == "pow" and not (isinstance(args[1], (int, float))
                                  and float(args[1]).is_integer()):
            f, tr = 1, 1
    elif torch.Tag.pointwise in func.tags:
        f, tr = 1, int(base in _TRANSCENDENTAL)
    else:
        return 0.0, 0.0, nbytes
    return (float((f - tr) * n + tr * n * TRANSCENDENTAL_WEIGHT),
            float(tr * n), nbytes)


# --------------------------------------------------------------- counter

_ACTIVE: list = []


def active() -> Optional["CostCounter"]:
    """The innermost active counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class _Mode(TorchDispatchMode):
    def __init__(self, counter: "CostCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.counter
        if c._suspend_alloc:
            return out
        in_storages = {t.untyped_storage()._cdata
                       for t in _tensors((args, kwargs))
                       if t.layout == torch.strided}
        outs = [o for o in _tensors(out) if o.layout == torch.strided]
        c._track(outs, in_storages)
        if not c._depth:
            f, tr, nb = _glue_cost(func, args, kwargs, outs, in_storages)
            if f or nb:
                k = c._scale
                c.cost.add(S.current(), "aten", f * k, nb * k, tr * k)
        return out


class CostCounter:
    """``with CostCounter() as c: fn(...)`` then ``c.cost`` (an
    :class:`OpCost`)."""

    def __init__(self):
        self.cost = OpCost()
        self._mode = _Mode(self)
        self._depth = 0            # > 0 inside a registry op
        self._suspend_alloc = 0    # > 0 inside a kernel impl
        self._live: dict = {}
        self._live_bytes = 0
        self._scale = 1.0          # > 1 inside a shortened loop (repeat)

    # ---------------------------------------------------------- memory

    def _free(self, key) -> None:
        n = self._live.pop(key, None)
        if n is not None:
            self._live_bytes -= n

    def _track(self, outs, in_storages) -> None:
        for o in outs:
            st = o.untyped_storage()
            key = st._cdata
            if key in in_storages or key in self._live:
                continue
            n = st.nbytes()
            if not n:
                continue
            self._live[key] = n
            self._live_bytes += n
            if self._live_bytes > self.cost.peak_live_bytes:
                self.cost.peak_live_bytes = float(self._live_bytes)
            weakref.finalize(st, self._free, key)

    # ----------------------------------------------------- collectives

    def collective(self, kind: str, axis: str, nbytes: int) -> None:
        """Count one recorded collective moving ``nbytes`` to this rank
        (scaled inside a shortened loop like everything else)."""
        nbytes = float(nbytes) * self._scale
        self.cost.collective_bytes += nbytes
        entry = self.cost.collectives.setdefault(kind, {
            "count": 0.0, "bytes": 0.0, "by_axis": {}})
        entry["count"] += self._scale
        entry["bytes"] += nbytes
        entry["by_axis"][axis] = entry["by_axis"].get(axis, 0.0) + nbytes
        sc = self.cost.by_scope.setdefault(S.current(), {
            "flops": 0.0, "bytes": 0.0, "transcendentals": 0.0,
            "collective_bytes": 0.0})
        sc["collective_bytes"] += nbytes

    # ---------------------------------------------------- registry ops

    def registry_op(self, op: str, kernel: bool, run: Callable, args,
                    kwargs):
        """Count one registry op analytically and run it, counting nothing
        beneath it (and, for a kernel impl, tracking only its outputs)."""
        if self._depth:
            if not kernel:
                return run()
            self._suspend_alloc += 1
            try:
                out = run()
            finally:
                self._suspend_alloc -= 1
            self._track_result(out, args, kwargs)
            return out
        fn = _COSTS.get(op)
        if fn is None:
            raise KeyError(f"registry op {op!r} has no registered cost")
        here, k = S.current(), self._scale
        for p in fn(*args, **kwargs):
            self.cost.add(p.scope or here, p.op or op, p.flops * k,
                          p.bytes * k, p.transcendentals * k)
        self.cost.by_op.setdefault(op, {"flops": 0.0, "bytes": 0.0,
                                        "calls": 0})["calls"] += 1
        self._depth += 1
        if kernel:
            self._suspend_alloc += 1
        try:
            out = run()
        finally:
            self._depth -= 1
            if kernel:
                self._suspend_alloc -= 1
        if kernel and not self._suspend_alloc:
            self._track_result(out, args, kwargs)
        return out

    def _track_result(self, out, args, kwargs) -> None:
        if self._suspend_alloc:
            return
        ins = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))
               if t.layout == torch.strided}
        self._track([o for o in _tensors(out) if o.layout == torch.strided],
                    ins)

    # ---------------------------------------------------------- context

    def __enter__(self):
        _ACTIVE.append(self)
        S.activate()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        S.deactivate()
        _ACTIVE.remove(self)
        return False


class _Mark(torch.autograd.Function):
    """Identity whose backward multiplies the counter's scale by
    ``factor``: placed after a shortened loop (factor n) and before it
    (factor 1/n), it scales the loop's backward as its forward was.
    ``summed`` (elements, bytes) is what autograd would add up there: the
    gradients of the inputs every step reads, n − 1 sums of each."""

    @staticmethod
    def forward(ctx, counter, factor, summed, *ts):
        ctx.counter, ctx.factor, ctx.summed = counter, factor, summed
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        c = ctx.counter
        c._scale *= ctx.factor
        elems, nbytes = ctx.summed
        if elems:
            c.cost.add(S.current(), "aten", elems, 3.0 * nbytes)
        return (None, None, None) + grads


class repeat:
    """A loop of ``n`` steps that each do the same work.  Everywhere it
    runs all ``n`` (``steps``), except on ``meta`` under an active counter
    (the dry-run), where it runs one step and the counts made in it are
    scaled by ``n`` — the way the reference's HLO counts a scan's body
    times its trip count.  ``begin``/``end`` mark the loop's inputs and
    outputs so that a backward through the one step is scaled too (with
    the n − 1 sums autograd makes of the gradients of the inputs that
    every step reads, ``each`` of them, first in ``begin``'s list);
    ``stack`` stacks the per-step outputs, the one step's repeated to the
    full count.  The one step's own allocations are counted once.

        with repeat(s, x.device) as rep:
            wx, h0 = rep.begin(wx, h0, each=1)
            outs = [step(t) for t in range(rep.steps)]
        hseq, = rep.end(rep.stack(outs, dim=1))
    """

    def __init__(self, n: int, device):
        self.n = n
        self.counter = active()
        self.short = (self.counter is not None and n > 1
                      and torch.device(device).type == "meta")
        self.steps = 1 if self.short else n

    def __enter__(self):
        if self.short:
            self.counter._scale *= self.n
        return self

    def __exit__(self, *exc):
        if self.short:
            self.counter._scale /= self.n
        return False

    def _mark(self, factor, ts, each=0):
        if not (self.short and torch.is_grad_enabled()
                and any(isinstance(t, torch.Tensor) and t.requires_grad
                        for t in ts)):
            return ts
        idx = [i for i, t in enumerate(ts) if isinstance(t, torch.Tensor)
               and t.requires_grad]
        summed = (sum((self.n - 1) * ts[i].numel() for i in idx
                      if i < each),
                  sum((self.n - 1) * ts[i].numel() * ts[i].element_size()
                      for i in idx if i < each))
        marked = _Mark.apply(self.counter, factor, summed,
                             *(ts[i] for i in idx))
        out = list(ts)
        for i, t in zip(idx, marked):
            out[i] = t
        return tuple(out)

    def begin(self, *ts, each: int = 0):
        """The loop's inputs, the first ``each`` read by every step, the
        rest carried in once; their backward leaves the scaled region."""
        return self._mark(1.0 / self.n, ts, each)

    def end(self, *ts):
        """The loop's outputs; their backward enters the scaled region."""
        return self._mark(float(self.n), ts)

    def stack(self, per_step: list, dim: int) -> torch.Tensor:
        """``torch.stack(per_step, dim)``; shortened, the one step's output
        expanded along ``dim`` to ``n`` entries."""
        if not self.short:
            return torch.stack(per_step, dim)
        one = per_step[0].unsqueeze(dim)
        sizes = list(one.shape)
        sizes[dim] = self.n
        return one.expand(sizes).contiguous()


def count_cost(fn: Callable, *args, **kwargs):
    """``(fn(*args, **kwargs), OpCost)``."""
    with CostCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.cost
