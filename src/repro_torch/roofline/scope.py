"""Scope markers: the port's counterpart of the reference's
``jax.named_scope`` labels (``roofline/hlo_cost.py``'s ``SCOPE_MARKERS``).

The model code plants ``scope(name)`` at the reference's sites, as a
context manager or a decorator.  A scope does nothing unless a consumer
is active: a cost counter (``roofline/op_cost.py``, which attributes
every count to the innermost marker on the stack) or a ``torch.profiler``
run, under which the scope also opens ``record_function(name)`` so the
card's busy time can be read by the same names.  Otherwise entering and
leaving a scope is one integer test and one cheap profiler-state read:
decode steps are host-bound, and an unconditional ``record_function``
per scope would add host time to every step.

This module imports nothing of the package, so any module can import it.
"""

from __future__ import annotations

import functools
import threading

import torch

__all__ = ["SCOPE_MARKERS", "scope", "current", "activate", "deactivate"]

#: the reference's markers, in its order, then the port's own
#: ``fsdp_gather`` (serving's per-layer gathers of the weights under FSDP
#: rules, ``models/transformer.py``; the reference's are XLA's, without a
#: name); the innermost one on the stack wins, anything outside every
#: marker counts as ``"other"``
SCOPE_MARKERS = (
    "attn_scores", "attn_pv", "attn_decode", "attn_qkv", "attn_out",
    "moe_gate", "moe_dispatch", "moe_ffn", "moe_combine", "moe_shared",
    "mlp", "lm_head", "loss", "adamw", "embed", "norm", "rope",
    "rglru", "mlstm", "slstm", "fsdp_gather",
)
_MARKERS = frozenset(SCOPE_MARKERS)

_TLS = threading.local()
_CONSUMERS = 0          # active cost counters


def activate() -> None:
    """A cost counter starts: scopes push their names from now on."""
    global _CONSUMERS
    _CONSUMERS += 1


def deactivate() -> None:
    global _CONSUMERS
    _CONSUMERS -= 1


def _stack() -> list:
    """This thread's stack of open scope names (outermost first)."""
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def current() -> str:
    """The innermost open marker of ``SCOPE_MARKERS``, else ``"other"``."""
    for name in reversed(_stack()):
        if name in _MARKERS:
            return name
    return "other"


class scope:
    """``with scope("mlp"): ...`` or ``@scope("mlp")``."""

    __slots__ = ("name", "_pushed", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._pushed = False
        self._rf = None

    def __enter__(self):
        profiling = torch.autograd.profiler._is_profiler_enabled
        if not (_CONSUMERS or profiling):
            return self
        _stack().append(self.name)
        self._pushed = True
        if profiling:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self._pushed:
            _stack().pop()
            self._pushed = False
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with scope(name):
                return fn(*args, **kwargs)

        return wrapped
