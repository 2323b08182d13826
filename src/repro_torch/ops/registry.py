"""Op registry + capability-checked dispatch with loud fallbacks.

The port of ``repro.ops.registry``.  Each logical op maps to named
implementations; each impl may carry a capability predicate that returns
``None`` when it can serve the call or a reason string when it cannot.
``dispatch`` walks the candidate chain — requested impl, op default,
remaining impls in registration order — runs the first capable one, and
records every rejection: there are no silent fallbacks.  One rejection
ends the walk instead: when the requested impl is a kernel and the
operands lie on the card, the call raises ``DispatchError`` rather than
run a plain version there.

``dispatch_report()[op]["modes"]`` records, for kernel impls, where the call
ran: ``"cuda"`` when the operands lay on the card and the kernel launched,
``"cpu"`` or ``"meta"`` when they lay there and the kernel module ran its
plain version.  Impl functions receive ``(policy, *args, **kwargs)``.

Tiles resolve as the reference's do: the tile table first
(``ops/schedules.py``, for the backend the operands lie on), then the
policy's override, checked against the knobs the impl takes.  An impl
registered with ``dims`` receives them as ``tiles=``.  A dispatch whose
policy overrides no tile, to an impl without ``dims``, skips all of it.

While a cost counter is active (``roofline/op_cost.py``), each dispatch
hands the op to it: the op's analytic cost is counted, nothing beneath it.
``registered``, ``op_names``, ``capability_matrix`` and ``default_impl``
read the table as the reference's do.

Collectives between the shards of a mesh (``dist/spmd.py``) are
recorded beside the dispatches:
``collective_report()`` lists each kind, axis and call site with its
count and bytes, and ``reset_dispatch_report()`` clears both ledgers.
"""

from __future__ import annotations

import threading
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.ops import schedules
from repro_torch.ops.policy import current_policy
from repro_torch.roofline import op_cost

__all__ = [
    "register",
    "registered",
    "op_names",
    "capability_matrix",
    "default_impl",
    "dispatch",
    "dispatch_report",
    "reset_dispatch_report",
    "record_collective",
    "collective_report",
    "DispatchError",
]


class DispatchError(RuntimeError):
    """No registered implementation can serve the call."""


@dataclass(frozen=True)
class OpImpl:
    op: str
    name: str
    fn: Callable
    requires: Optional[Callable] = None     # (policy, *a, **kw) -> None | str
    kernel: bool = False                    # CUDA kernel impl: record the mode
    doc: str = ""                           # capability summary
    dims: Optional[Callable] = None         # (*a, **kw) -> bucket dims; the
    #                                         impl then takes ``tiles=``


_REGISTRY: dict[str, dict[str, OpImpl]] = {}
_DEFAULTS: dict[str, str] = {}
_LOCK = threading.Lock()

# (op, requested, used, reasons, mode) -> count
_COUNTS: Counter = Counter()
# (kind, axis, where) -> [count, bytes]
_COLLECTIVES: dict = {}
_IMPLS_LOADED = False


def register(op: str, name: str, fn: Callable, *,
             requires: Optional[Callable] = None,
             default: bool = False, kernel: bool = False,
             doc: str = "", dims: Optional[Callable] = None) -> OpImpl:
    """Register implementation ``name`` for logical op ``op`` (``default``
    makes it the op's default; otherwise the first registered is).  An
    impl with ``dims`` takes its resolved tiles as ``tiles=``."""
    impl = OpImpl(op=op, name=name, fn=fn, requires=requires, kernel=kernel,
                  doc=doc, dims=dims)
    with _LOCK:
        table = _REGISTRY.setdefault(op, {})
        table[name] = impl
        if default or op not in _DEFAULTS:
            _DEFAULTS[op] = name
    return impl


def _ensure_impls() -> None:
    """Implementations live in ``repro_torch.ops.impls``; importing it here
    (not at module import) breaks the core ↔ ops import cycle."""
    global _IMPLS_LOADED
    if not _IMPLS_LOADED:
        import repro_torch.ops.impls  # noqa: F401  (registers on import)

        _IMPLS_LOADED = True


def registered(op: str) -> dict[str, OpImpl]:
    _ensure_impls()
    if op not in _REGISTRY:
        raise KeyError(f"unknown op {op!r}; registered: {sorted(_REGISTRY)}")
    return dict(_REGISTRY[op])


def op_names() -> tuple[str, ...]:
    _ensure_impls()
    return tuple(sorted(_REGISTRY))


def capability_matrix() -> dict[str, dict[str, str]]:
    """{op: {impl: capability summary}}."""
    _ensure_impls()
    return {op: {n: i.doc for n, i in impls.items()}
            for op, impls in sorted(_REGISTRY.items())}


def default_impl(op: str) -> str:
    _ensure_impls()
    return _DEFAULTS[op]


def _candidates(op: str, requested: str) -> list[str]:
    table = _REGISTRY[op]
    order = [requested]
    d = _DEFAULTS.get(op)
    if d and d not in order:
        order.append(d)
    order.extend(n for n in table if n not in order)
    return [n for n in order if n in table]


def _mode(args) -> str:
    """Where a kernel impl ran: on the card (the kernel), or on the CPU or
    the meta device (its plain version) — decided by the first operand's
    device."""
    first = args[0]
    if isinstance(first, torch.Tensor) and first.device.type in ("cuda",
                                                                 "meta"):
        return first.device.type
    return "cpu"


def _resolve_tiles(op: str, name: str, impl: OpImpl, policy, args,
                   kwargs) -> dict:
    """``kwargs`` for ``impl`` with its tiles resolved: the table's first,
    then the policy's override, which must name blocks the impl takes.
    An impl registered with ``dims`` receives them as ``tiles=``."""
    backend = schedules.backend_key(_mode(args))
    override = policy.tile_for(op)
    schedules.check_override(op, name, override, backend, impl.kernel)
    if impl.dims is None:
        return kwargs
    tiles = schedules.schedule_for(op, name, impl.dims(*args, **kwargs),
                                   backend)
    tiles.update(override)
    return dict(kwargs, tiles=tiles)


def dispatch(op: str, *args, **kwargs):
    """Run ``op`` through the impl the ambient policy names, falling back
    (loudly: every rejection is recorded) to the first capable impl."""
    _ensure_impls()
    if op not in _REGISTRY:
        raise KeyError(f"unknown op {op!r}; registered: {sorted(_REGISTRY)}")
    policy = current_policy()
    requested = policy.impl_for(op) or _DEFAULTS[op]
    reasons: list[str] = []
    if requested not in _REGISTRY[op]:
        reasons.append(f"{requested}: not a registered impl for {op!r} "
                       f"(registered: {sorted(_REGISTRY[op])})")
    on_card = _mode(args) == "cuda"
    for name in _candidates(op, requested):
        impl = _REGISTRY[op][name]
        why = impl.requires(policy, *args, **kwargs) if impl.requires else None
        if why is not None:
            if impl.kernel and name == requested and on_card:
                # operands on the card: the kernel runs or the call fails,
                # never a plain version in the kernel's place
                raise DispatchError(
                    f"op {op!r}: kernel impl {name!r} cannot take these "
                    f"operands on the card: {why}")
            reasons.append(f"{name}: {why}")
            continue
        mode = _mode(args) if impl.kernel else ""
        call_kw = kwargs
        if policy.tiles or impl.dims is not None:
            call_kw = _resolve_tiles(op, name, impl, policy, args, kwargs)
        with _LOCK:
            _COUNTS[(op, requested, name, tuple(reasons), mode)] += 1
        counter = op_cost.active()
        if counter is not None:
            return counter.registry_op(
                op, impl.kernel, lambda: impl.fn(policy, *args, **call_kw),
                args, kwargs)
        return impl.fn(policy, *args, **call_kw)
    raise DispatchError(
        f"no capable implementation for op {op!r} "
        f"(requested {requested!r}): " + "; ".join(reasons))


def dispatch_report() -> dict:
    """Per-op ledger of dispatch decisions since the last reset.

    {op: {"requests": N,
          "hits": {impl: n},
          "fallbacks": [{"requested", "used", "reasons", "count"}, ...],
          "modes": {impl: {"cuda"|"cpu"|"meta": n}}}}   # kernel impls
    """
    with _LOCK:
        items = list(_COUNTS.items())
    report: dict = {}
    for (op, requested, used, reasons, mode), n in sorted(items):
        entry = report.setdefault(op, {"requests": 0, "hits": {},
                                       "fallbacks": [], "modes": {}})
        entry["requests"] += n
        if used == requested:
            entry["hits"][used] = entry["hits"].get(used, 0) + n
        else:
            entry["fallbacks"].append({
                "requested": requested, "used": used,
                "reasons": list(reasons), "count": n,
            })
        if mode:
            m = entry["modes"].setdefault(used, {})
            m[mode] = m.get(mode, 0) + n
    return report


def record_collective(kind: str, axis: str, nbytes: int,
                      where: str) -> None:
    """Record one collective (``all_reduce``, ``all_gather``) over mesh
    ``axis`` moving ``nbytes`` a rank, made at ``where``."""
    with _LOCK:
        entry = _COLLECTIVES.setdefault((kind, axis, where), [0, 0])
        entry[0] += 1
        entry[1] += int(nbytes)


def collective_report() -> list[dict]:
    """The collectives since the last reset: [{"kind", "axis", "where",
    "count", "bytes"}, ...], sorted."""
    with _LOCK:
        items = sorted(_COLLECTIVES.items())
    return [{"kind": k, "axis": a, "where": w, "count": n, "bytes": b}
            for (k, a, w), (n, b) in items]


def reset_dispatch_report() -> None:
    with _LOCK:
        _COUNTS.clear()
        _COLLECTIVES.clear()
