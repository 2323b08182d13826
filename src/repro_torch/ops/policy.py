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
  * ``"eager_int8"`` / ``"eager_factored"`` — plain PyTorch over packed
                    weights (QTensor / FactoredTensor), the reference's
                    ``"xla_int8"`` / ``"xla_factored"``.

``tiles`` holds per-op tile overrides (``with_tiles``), consulted after
the tile table (``ops/schedules.py``), with the reference's hashing and
merge semantics.  The Pallas ``interpret`` switch has no counterpart: the
device of the operands decides where a kernel impl runs.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, replace
from typing import Mapping, Optional

__all__ = [
    "OPS",
    "ComputePolicy",
    "use_policy",
    "current_policy",
    "DEFAULT_POLICY",
    "policy_named",
]

# The logical ops of the unified compute unit.  Implementations register
# against these names in ``repro_torch.ops.impls``.
OPS = ("attention", "attention_decode", "linear", "moe_grouped_gemm",
       "moe_ffn", "activation")


def _freeze_impls(impls) -> tuple:
    if isinstance(impls, Mapping):
        impls = tuple(sorted(impls.items()))
    return tuple((str(k), str(v)) for k, v in impls)


def _freeze_tiles(tiles) -> tuple:
    if isinstance(tiles, Mapping):
        tiles = tuple(sorted(
            (op, tuple(sorted(blocks.items()))) for op, blocks in tiles.items()))
    return tuple((str(op), tuple((str(k), int(v)) for k, v in blocks))
                 for op, blocks in tiles)


@dataclass(frozen=True)
class ComputePolicy:
    """Per-op implementation choices + numerics.

    ``impls``        — (op, impl) overrides; ops without an entry use
                       ``default_impl``, and when that is also None the
                       registry's per-op default.
    ``tiles``        — (op, ((block_name, size), ...)) overrides consulted
                       after the tile table.
    ``accum_dtype`` / ``bias_f32`` — widened accumulator / bias (§IV-E).
    ``lut_step_log2`` / ``lut_range`` — §IV-C LUT geometry.
    """

    impls: tuple = ()
    default_impl: Optional[str] = None
    tiles: tuple = ()
    accum_dtype: str = "float32"
    bias_f32: bool = True
    lut_step_log2: int = -8
    lut_range: float = 8.0

    def __post_init__(self):
        object.__setattr__(self, "impls", _freeze_impls(self.impls))
        object.__setattr__(self, "tiles", _freeze_tiles(self.tiles))

    def impl_for(self, op: str) -> Optional[str]:
        """Requested impl for ``op``: explicit entry > blanket default >
        None (registry decides)."""
        for name, impl in self.impls:
            if name == op:
                return impl
        return self.default_impl

    def tile_for(self, op: str) -> dict:
        for name, blocks in self.tiles:
            if name == op:
                return dict(blocks)
        return {}

    @property
    def lut_activations(self) -> bool:
        """True when the activation op resolves to a LUT implementation
        (kernel epilogues that fuse the activation read this)."""
        return self.impl_for("activation") in (None, "lut", "cuda")

    def with_impls(self, **ops) -> "ComputePolicy":
        merged = dict(self.impls)
        merged.update(ops)
        return replace(self, impls=tuple(sorted(merged.items())))

    def with_tiles(self, op: str, **blocks) -> "ComputePolicy":
        """New policy with tile-size overrides for ``op``:
        ``policy.with_tiles("attention", block_k=128)``."""
        merged = {o: dict(b) for o, b in self.tiles}
        merged.setdefault(op, {}).update(blocks)
        return replace(self, tiles=_freeze_tiles(merged))

    def with_options(self, **kw) -> "ComputePolicy":
        """New policy with numerics fields replaced:
        ``policy.with_options(lut_step_log2=-7, bias_f32=False)``."""
        return replace(self, **kw)


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
    ``"eager_int8"`` — quantized serving: ``linear``, ``moe_grouped_gemm``
                    and ``attention_decode`` run the ``eager_int8`` impls
                    (QTensor weights, int8 KV caches); prefill attention
                    and activations keep the registry defaults (the
                    reference's ``"xla_int8"`` preset).  Floating-point
                    operands fall back loudly in ``dispatch_report()``.
    ``"eager_factored"`` — factored-expert serving: ``moe_grouped_gemm``
                    runs ``eager_factored``; everything else keeps the
                    registry defaults (the reference's ``"xla_factored"``).
                    Compose with quantization as
                    ``policy_named("eager_int8").with_impls(
                    moe_grouped_gemm="eager_factored")``.
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
    if name == "eager_int8":
        return ComputePolicy(impls=(("linear", "eager_int8"),
                                    ("moe_grouped_gemm", "eager_int8"),
                                    ("attention_decode", "eager_int8")))
    if name == "eager_factored":
        return ComputePolicy(impls=(("moe_grouped_gemm", "eager_factored"),))
    raise ValueError(f"unknown policy preset: {name!r} "
                     "(expected eager | blocked | cuda | cuda_fused | ref | "
                     "eager_int8 | eager_factored)")


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
