"""``repro_torch.serve.slo`` — SLO-aware multi-tenant serving primitives,
the port of ``repro.serve.slo``.

  * ``tiers``    — service classes (interactive/batch) with TTFT/TPOT
                   deadlines, the ``SLOPolicy`` scheduler knob bundle,
                   and goodput-under-SLO accounting;
  * ``preempt``  — bit-exact decode-slot park/restore, optionally packing
                   floating KV rows to int8;
  * ``prefix``   — radix-trie shared prompt-prefix cache seeding fused
                   prefill admissions;
  * ``trace``    — seeded heavy-tailed multi-tenant traffic traces
                   (bursts, task-mix shifts, tenant skew).

The scheduler integration lives in ``serve/scheduler.py`` (pass
``Scheduler(..., slo=SLOPolicy(...))``).
"""

from repro_torch.serve.slo.preempt import ParkedState, SlotParker
from repro_torch.serve.slo.prefix import RadixPrefixCache
from repro_torch.serve.slo.tiers import (BATCH, INTERACTIVE, SLOPolicy,
                                         TIERS, TierSpec, goodput,
                                         is_preemptible, meets_slo,
                                         request_tpot, tag_request)
from repro_torch.serve.slo.trace import (TickClock, TraceConfig,
                                         TraceGenerator)

__all__ = [
    "ParkedState", "SlotParker", "RadixPrefixCache",
    "BATCH", "INTERACTIVE", "SLOPolicy", "TIERS", "TierSpec",
    "goodput", "is_preemptible", "meets_slo", "request_tpot",
    "tag_request", "TickClock", "TraceConfig", "TraceGenerator",
]
