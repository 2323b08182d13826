"""Decode-slot preemption: bit-exact park & restore of one slot's state,
the port of ``repro.serve.slo.preempt``.

Preempting a batch-tier request means lifting its per-slot decode state
(the KV cache rows of every layer) out of the bucket's batched state so
the slot can serve an interactive request, then splicing it back later
and continuing decode *token-identically* — the same greedy tokens as an
uninterrupted run.  Extraction slices each leaf along its batch axis
(``serve.engine.state_batch_axes``, in ``repro_torch.tree.flatten``
order) and clones the slice: the bucket keeps decoding its other slots,
in place, so a view would change under the parked request.  Restore
copies the parked rows back into the slot in place.

``compress="int8"`` (fp KV rows packed through ``quantize_kv``) comes
with the packed-formats slice of the port (``ROADMAP.md`` queue 1 item 3)
and raises; ``"none"`` is always bit-exact.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.tree import flatten

__all__ = ["ParkedState", "SlotParker"]


@dataclass
class ParkedState:
    """One slot's extracted batch-1 state: ``leaves`` parallels the bucket
    state's flattened leaves, each a batch-1 tensor of its own."""

    leaves: list
    nbytes: int


class SlotParker:
    """Park/restore over a bucket state with per-leaf batch axes ``axes``
    (``serve.engine.state_batch_axes`` order)."""

    def __init__(self, axes: list, compress: str = "none"):
        if compress not in ("none", "int8"):
            raise ValueError(f"unknown park compress {compress!r} "
                             "(expected none | int8)")
        if compress == "int8":
            raise NotImplementedError(
                "int8 parking (fp KV rows through quantize_kv) comes with "
                "ROADMAP.md queue 1 item 3 (packed formats)")
        self.axes = list(axes)
        self.compress = compress

    def park(self, state, slot: int) -> ParkedState:
        leaves = [leaf.narrow(ax, slot, 1).clone()
                  for leaf, ax in zip(flatten(state).values(), self.axes)]
        return ParkedState(leaves=leaves, nbytes=sum(
            t.numel() * t.element_size() for t in leaves))

    def restore(self, state, parked: ParkedState, slot: int):
        """Copy the parked rows into ``slot`` of ``state`` in place;
        returns ``state``."""
        for leaf, small, ax in zip(flatten(state).values(), parked.leaves,
                                   self.axes):
            leaf.narrow(ax, slot, 1).copy_(small)
        return state
