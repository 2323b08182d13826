"""Decode-slot preemption: bit-exact park & restore of one slot's state,
the port of ``repro.serve.slo.preempt``.

Preempting a batch-tier request means lifting its per-slot decode state
(the KV cache rows of every layer, or a recurrent arch's cells: mLSTM
C/n/m, sLSTM c/n/h/m, RG-LRU h and the conv windows) out of the bucket's
batched state so
the slot can serve an interactive request, then splicing it back later
and continuing decode *token-identically* — the same greedy tokens as an
uninterrupted run.  Extraction slices each leaf along its batch axis
(``serve.engine.state_batch_axes``, in ``repro_torch.tree.flatten``
order) and clones the slice: the bucket keeps decoding its other slots,
in place, so a view would change under the parked request.  Restore
copies the parked rows back into the slot in place.  Where a bucket's
lanes are split over ranks, the lane's rank parks it and the others keep
a shell of it (:meth:`SlotParker.shell`); the bucket moves the rows to the
rank of the lane it restores into (``serve/scheduler.py``).

With ``kv_quant="int8"`` the slot's leaves are already int8 (+ small
float32 scales), so a parked request costs about a quarter of the
floating-point bytes and the round trip stays bit-exact.  For floating
caches, ``compress="int8"`` packs the rows through ``quant.quantize_kv``
on the way out (per-(token, head) scales) — a lossy saving for workloads
that tolerate it; ``"none"`` is always bit-exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.quant.qtensor import QTensor, dequantize, quantize_kv
from repro_torch.tree import flatten

__all__ = ["ParkedState", "SlotParker"]

# floating leaves with at least this many elements along the last axis are
# quantized under compress="int8", the reference's rule: KV rows (head_dim
# wide) and the recurrent cells' rows (mLSTM C and n, the sLSTM cells,
# RG-LRU h, the conv windows) qualify; the per-row float32 scales of an
# already-int8 cache (last dim 1), mLSTM's per-head stabilizer m (B, H)
# with fewer than 8 heads and other small bookkeeping leaves pass through
# verbatim — which is what keeps the int8-KV round trip bit-exact
_MIN_ROW = 8


@dataclass
class ParkedState:
    """One slot's extracted batch-1 state: ``leaves`` parallels the bucket
    state's flattened leaves; a packed entry is a ``(q, scale)`` pair,
    every other one a batch-1 tensor of its own."""

    leaves: list
    nbytes: int


def _packs(leaf, compress: str) -> bool:
    return (compress == "int8" and leaf.is_floating_point()
            and leaf.dim() >= 2 and leaf.shape[-1] >= _MIN_ROW)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class SlotParker:
    """Park/restore over a bucket state with per-leaf batch axes ``axes``
    (``serve.engine.state_batch_axes`` order)."""

    def __init__(self, axes: list, compress: str = "none"):
        if compress not in ("none", "int8"):
            raise ValueError(f"unknown park compress {compress!r} "
                             "(expected none | int8)")
        self.axes = list(axes)
        self.compress = compress

    def park(self, state, slot: int) -> ParkedState:
        leaves = []
        for leaf, ax in zip(flatten(state).values(), self.axes):
            row = leaf.narrow(ax, slot, 1)
            leaves.append(quantize_kv(row) if _packs(leaf, self.compress)
                          else row.clone())
        return ParkedState(leaves=leaves, nbytes=sum(
            sum(map(_nbytes, p)) if isinstance(p, tuple) else _nbytes(p)
            for p in leaves))

    def shell(self, state) -> ParkedState:
        """The record a rank keeps of a lane another rank parks (a bucket
        whose lanes are split over ranks): every leaf's shape and dtype on
        ``meta``, no values, and the owner's byte count."""
        leaves = []
        for leaf, ax in zip(flatten(state).values(), self.axes):
            row = torch.empty_like(leaf.narrow(ax, 0, 1), device="meta")
            leaves.append(quantize_kv(row) if _packs(leaf, self.compress)
                          else row)
        return ParkedState(leaves=leaves, nbytes=sum(
            sum(map(_nbytes, p)) if isinstance(p, tuple) else _nbytes(p)
            for p in leaves))

    def restore(self, state, parked: ParkedState, slot: int):
        """Copy the parked rows into ``slot`` of ``state`` in place (a
        packed entry dequantized to the leaf's dtype); returns
        ``state``."""
        for leaf, small, ax in zip(flatten(state).values(), parked.leaves,
                                   self.axes):
            if isinstance(small, tuple):
                small = dequantize(QTensor(*small), leaf.dtype)
            leaf.narrow(ax, slot, 1).copy_(small)
        return state
