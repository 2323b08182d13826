"""Compute policies: which implementation runs each op, at what precision.

The port of ``repro.ops.policy``.  A :class:`ComputePolicy` names, for every
logical op in the registry, which registered implementation should serve
it, plus the numerics (accumulation dtype, widened f32 bias, LUT geometry).
:func:`use_policy` installs one for a dynamic extent; policies nest.

Implementation names in the port:

  * ``"eager"``   — plain PyTorch ops (the reference's ``"xla"``).
  * ``"blocked"`` — streaming K/V attention in plain PyTorch.
  * ``"lut"``     — the §IV-C LUT activation in plain PyTorch.
  * ``"cuda"``    — the hand-written Hopper kernels (the reference's
                    ``"pallas"``); on a CPU tensor the kernel module runs its
                    plain version instead.
  * ``"cuda_fused"`` — the fused Hopper kernels of ``moe_ffn`` and
                    ``attention_decode`` (the reference's ``"pallas_fused"``).
  * ``"ref"``     — the ``kernels/ref.py`` oracles.

Tile overrides and the Pallas ``interpret`` switch have no counterpart yet:
the kernels take fixed tiles, stated in their sources.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, replace
from typing import Mapping, Optional

__all__ = [
    "ComputePolicy",
    "use_policy",
    "current_policy",
    "DEFAULT_POLICY",
    "policy_named",
]

def _freeze_impls(impls) -> tuple:
    if isinstance(impls, Mapping):
        impls = tuple(sorted(impls.items()))
    return tuple((str(k), str(v)) for k, v in impls)


@dataclass(frozen=True)
class ComputePolicy:
    """Per-op implementation choices + numerics.

    ``impls``        — (op, impl) overrides; ops without an entry use
                       ``default_impl``, and when that is also None the
                       registry's per-op default.
    ``accum_dtype`` / ``bias_f32`` — widened accumulator / bias (§IV-E).
    ``lut_step_log2`` / ``lut_range`` — §IV-C LUT geometry.
    """

    impls: tuple = ()
    default_impl: Optional[str] = None
    accum_dtype: str = "float32"
    bias_f32: bool = True
    lut_step_log2: int = -8
    lut_range: float = 8.0

    def __post_init__(self):
        object.__setattr__(self, "impls", _freeze_impls(self.impls))

    def impl_for(self, op: str) -> Optional[str]:
        """Requested impl for ``op``: explicit entry > blanket default >
        None (registry decides)."""
        for name, impl in self.impls:
            if name == op:
                return impl
        return self.default_impl

    @property
    def lut_activations(self) -> bool:
        """True when the activation op resolves to a LUT implementation
        (kernel epilogues that fuse the activation read this)."""
        return self.impl_for("activation") in (None, "lut", "cuda")

    def with_impls(self, **ops) -> "ComputePolicy":
        merged = dict(self.impls)
        merged.update(ops)
        return replace(self, impls=tuple(sorted(merged.items())))


#: Registry defaults: blocked attention, eager GEMMs, LUT activations.
DEFAULT_POLICY = ComputePolicy()


def policy_named(name: str) -> ComputePolicy:
    """Preset policies.

    ``"eager"``   — plain PyTorch everywhere, exact activations (the
                    reference's ``"xla"`` preset).
    ``"blocked"`` — blocked streaming attention + LUT activations.
    ``"cuda"``    — the Hopper kernels for every op that has one, LUT
                    activations in the fused epilogue (the reference's
                    ``"pallas"`` preset).
    ``"cuda_fused"`` — the fused kernels: the routed expert layer as one
                    ``moe_ffn`` pass and single-pass decode attention, with
                    blocked attention and LUT activations around them (the
                    reference's ``"pallas_fused"`` preset).
    ``"ref"``     — the oracle impls.
    """
    if name == "eager":
        return ComputePolicy(default_impl="eager",
                             impls=(("activation", "eager"),
                                    ("attention", "eager")))
    if name == "blocked":
        return ComputePolicy(impls=(("activation", "lut"),
                                    ("attention", "blocked")))
    if name == "cuda":
        return ComputePolicy(default_impl="cuda")
    if name == "cuda_fused":
        return ComputePolicy(impls=(("activation", "lut"),
                                    ("attention", "blocked"),
                                    ("moe_ffn", "cuda_fused"),
                                    ("attention_decode", "cuda_fused")))
    if name == "ref":
        return ComputePolicy(default_impl="ref")
    raise ValueError(f"unknown policy preset: {name!r} "
                     "(expected eager | blocked | cuda | cuda_fused | ref)")


_POLICY: contextvars.ContextVar[Optional[ComputePolicy]] = \
    contextvars.ContextVar("repro_torch_compute_policy", default=None)


def current_policy() -> ComputePolicy:
    """The ambient policy (DEFAULT_POLICY outside any scope)."""
    return _POLICY.get() or DEFAULT_POLICY


@contextlib.contextmanager
def use_policy(policy: Optional[ComputePolicy] = None, **impl_overrides):
    """Scope a policy for the dynamic extent; restores the prior policy on
    exit.  ``use_policy(None)`` is a pass-through; keyword overrides derive
    from the current policy (``use_policy(attention="cuda")``)."""
    if policy is None and not impl_overrides:
        yield current_policy()
        return
    if policy is None:
        policy = current_policy()
    if impl_overrides:
        policy = policy.with_impls(**impl_overrides)
    token = _POLICY.set(policy)
    try:
        yield policy
    finally:
        _POLICY.reset(token)
