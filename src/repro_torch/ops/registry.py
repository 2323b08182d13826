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
``"cpu"`` when they lay on the CPU and the kernel module ran its plain
version.  Impl functions receive ``(policy, *args, **kwargs)``.
"""

from __future__ import annotations

import threading
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.ops.policy import current_policy

__all__ = [
    "register",
    "dispatch",
    "dispatch_report",
    "reset_dispatch_report",
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


_REGISTRY: dict[str, dict[str, OpImpl]] = {}
_DEFAULTS: dict[str, str] = {}
_LOCK = threading.Lock()

# (op, requested, used, reasons, mode) -> count
_COUNTS: Counter = Counter()
_IMPLS_LOADED = False


def register(op: str, name: str, fn: Callable, *,
             requires: Optional[Callable] = None,
             default: bool = False, kernel: bool = False) -> OpImpl:
    """Register implementation ``name`` for logical op ``op`` (``default``
    makes it the op's default; otherwise the first registered is)."""
    impl = OpImpl(op=op, name=name, fn=fn, requires=requires, kernel=kernel)
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


def _candidates(op: str, requested: str) -> list[str]:
    table = _REGISTRY[op]
    order = [requested]
    d = _DEFAULTS.get(op)
    if d and d not in order:
        order.append(d)
    order.extend(n for n in table if n not in order)
    return [n for n in order if n in table]


def _mode(args) -> str:
    """Where a kernel impl ran: on the card (the kernel) or on the CPU
    (its plain version) — decided by the first operand's device."""
    first = args[0]
    return "cuda" if isinstance(first, torch.Tensor) and first.is_cuda \
        else "cpu"


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
        with _LOCK:
            _COUNTS[(op, requested, name, tuple(reasons), mode)] += 1
        return impl.fn(policy, *args, **kwargs)
    raise DispatchError(
        f"no capable implementation for op {op!r} "
        f"(requested {requested!r}): " + "; ".join(reasons))


def dispatch_report() -> dict:
    """Per-op ledger of dispatch decisions since the last reset.

    {op: {"requests": N,
          "hits": {impl: n},
          "fallbacks": [{"requested", "used", "reasons", "count"}, ...],
          "modes": {impl: {"cuda"|"cpu": n}}}}        # kernel impls
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


def reset_dispatch_report() -> None:
    with _LOCK:
        _COUNTS.clear()
