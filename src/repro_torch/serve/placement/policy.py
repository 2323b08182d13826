"""PlacementPolicy: the decision half of expert residency, a copy of
``repro.serve.placement.policy`` (NumPy only).

The caches (``serve/expert_cache.py``) are mechanism only — they reserve
slots, page bytes, fence transfers, and commit stores.  Every *decision*
lives here:

  * **shard ownership** — ``initial_plan`` builds the
    :class:`~repro_torch.serve.placement.plan.PlacementPlan` a sharded
    cache serves from, and ``update`` may propose a rebalanced successor
    (elastic placement; the static/lru/budget policies never do).
  * **victim selection** — ``victim`` picks which resident expert a full
    bank evicts (least-recently-used, skipping the working set being
    ensured).
  * **prefetch ranking** — ``prefetch_ranking`` orders the lookahead
    warm-up set (usage-EMA hottest first, ties broken by expert id).
  * **residency sizing** — ``slots`` turns a byte budget or resident
    fraction into a per-device slot count.

``get_policy`` resolves a policy name (``static`` / ``lru`` / ``budget``
/ ``elastic``) or passes a constructed policy through.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np

from repro_torch.serve.placement.plan import PlacementPlan

__all__ = ["PlacementPolicy", "StaticPolicy", "LRUPolicy", "BudgetPolicy",
           "get_policy", "budget_slots", "fraction_slots"]


def budget_slots(budget_bytes: int, per_expert_bytes: int,
                 pinned_bytes: int, floor: int) -> int:
    """Device byte budget -> resident slots per device.  Pinned leaves (a
    factored layer's shared basis) are paid out of the budget FIRST — they
    are on device whether or not any expert is resident; only the
    remainder buys slots, priced at the PAGED per-expert bytes."""
    paged = max(0, int(budget_bytes) - int(pinned_bytes))
    return max(int(floor), paged // max(int(per_expert_bytes), 1))


def fraction_slots(resident_fraction: float, experts_per_shard: int,
                   floor: int) -> int:
    """Per-shard resident fraction -> slot count (same fraction at any
    mesh size)."""
    return max(int(floor),
               int(np.ceil(float(resident_fraction)
                           * int(experts_per_shard))))


class PlacementPolicy:
    """Base policy: static ownership, LRU victims, usage-hot prefetch.

    Subclasses override the decisions they change; everything a subclass
    does NOT override is this base behaviour.
    """

    name = "base"
    # forwards between ``update`` consultations; 0 = never rebalance
    rebalance_every = 0

    def __init__(self, budget_bytes: Optional[int] = None):
        self.budget_bytes = budget_bytes

    # ---------------------------------------------------------- ownership

    def initial_plan(self, num_experts: int,
                     num_shards: int) -> PlacementPlan:
        return PlacementPlan.static(num_experts, num_shards)

    def table_width(self, num_shards: int) -> int:
        """Max replicas per expert this policy will ever plan (fixes the
        width of the wave's replica table for the cache's lifetime)."""
        return 1

    def update(self, plan: PlacementPlan, usage, shard_load,
               slots_per_shard: int) -> Optional[PlacementPlan]:
        """Propose a successor plan from router-usage evidence, or None
        to keep the current one.  Called between forwards only."""
        return None

    # ------------------------------------------------------------- slots

    def slots(self, *, per_expert_bytes: int, pinned_bytes: int,
              experts_per_shard: int, resident_fraction: float,
              floor: int) -> int:
        """Per-device slot count: byte-budget sizing when the policy
        carries one, fraction sizing otherwise."""
        if self.budget_bytes is not None:
            return budget_slots(self.budget_bytes, per_expert_bytes,
                                pinned_bytes, floor)
        return fraction_slots(resident_fraction, experts_per_shard, floor)

    # ----------------------------------------------------------- eviction

    def victim(self, lru: "OrderedDict[int, int]", pinned: set[int]) -> int:
        """Expert to evict from a full bank: least-recently-used not in
        the working set being ensured (``pinned``)."""
        return next(e for e in lru if e not in pinned)

    # ----------------------------------------------------------- prefetch

    def prefetch_ranking(self, usage, budget: int,
                         task_id: Optional[int] = None) -> list[int]:
        """Lookahead warm-up set, hottest first (deterministic ties)."""
        return usage.hot(budget, task_id)


class StaticPolicy(PlacementPolicy):
    """The static partition: modulo ownership, LRU eviction, fraction- or
    budget-sized banks."""

    name = "static"


class LRUPolicy(PlacementPolicy):
    """Alias naming the eviction rule (identical mechanics to ``static``;
    exists so the name ``lru`` reads as what it does)."""

    name = "lru"


class BudgetPolicy(PlacementPolicy):
    """Byte-budget residency sizing as a named policy."""

    name = "budget"

    def __init__(self, budget_bytes: Optional[int] = None):
        super().__init__(budget_bytes=None if budget_bytes is None
                         else int(budget_bytes))

    def slots(self, **kw) -> int:
        if self.budget_bytes is None:
            raise ValueError(
                "budget placement needs a byte budget — pass "
                "budget_bytes (M3ViTServer: expert_budget_bytes)")
        return super().slots(**kw)


_REGISTRY = {}


def _register(cls):
    _REGISTRY[cls.name] = cls
    return cls


for _cls in (StaticPolicy, LRUPolicy, BudgetPolicy):
    _register(_cls)


def get_policy(spec, **kwargs) -> PlacementPolicy:
    """Resolve a policy: an instance passes through; a name constructs one
    (``static`` / ``lru`` / ``budget`` / ``elastic``) with ``kwargs``."""
    if isinstance(spec, PlacementPolicy):
        return spec
    if spec is None:
        spec = "static"
    name = str(spec).lower()
    if name == "elastic":   # deferred: elastic.py imports this module
        from repro_torch.serve.placement.elastic import ElasticPolicy
        return ElasticPolicy(**kwargs)
    cls = _REGISTRY.get(name)
    if cls is None:
        raise ValueError(
            f"unknown placement policy {spec!r}; available: "
            f"{sorted(_REGISTRY) + ['elastic']}")
    return cls(**kwargs)
