"""Elastic placement: hot-expert replication + cold-expert migration, a
copy of ``repro.serve.placement.elastic`` (NumPy only).

The paper's task-level sparsity means the router concentrates traffic on
a small, per-task-stable expert subset.  Under the static partition that
subset can land entirely on one shard (experts are blocked by id), so
that shard pages and computes every wave while its siblings idle.  The
elastic policy consumes the same router-usage EMA the prefetcher already
maintains and periodically proposes a rebalanced
:class:`~repro_torch.serve.placement.plan.PlacementPlan`:

  * **migration** — active experts are dealt to shards hottest-first,
    each to the least-loaded shard with bank room (greedy LPT), so the
    EMA load spreads evenly.  Inactive experts keep their static home
    (no churn for weights nobody routes to).
  * **replication** — an expert whose EMA load is ``replicate_factor``×
    the mean active load is placed on EVERY shard with bank room; the
    wave dispatch then splits its tokens round-robin across the replicas
    (bit-exact per token — replicas are identical weights, and a GEMM
    row depends only on its own inputs).
  * **stability** — the proposal is deterministic (EMA ties break by
    expert id) and compared layout-wise against the current plan; an
    unchanged layout returns ``None`` so generations only advance on
    real swaps.  A changed layout must also EARN its swap: the
    proposal's projected load imbalance has to beat the current plan's
    by ``improve_margin`` (hysteresis) — without it, ordinary EMA drift
    reorders the greedy deal every cadence and the plan churns, paying
    migration paging forever for layouts that are all equivalent.

The policy only *proposes*; a sharded cache applies the swap between
forwards.  On one device (the port's ``PagedMoE`` today) ``update``
returns ``None`` — there is nothing to rebalance across — and the policy's
victim and ranking hooks run as the base policy's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.serve.placement.plan import PlacementPlan
from repro_torch.serve.placement.policy import PlacementPolicy

__all__ = ["ElasticPolicy"]


class ElasticPolicy(PlacementPolicy):
    name = "elastic"

    def __init__(self, rebalance_every: int = 4,
                 replicate_factor: float = 4.0,
                 ema_floor: float = 1e-6,
                 improve_margin: float = 0.9,
                 budget_bytes: Optional[int] = None):
        super().__init__(budget_bytes=budget_bytes)
        self.rebalance_every = max(1, int(rebalance_every))
        self.replicate_factor = float(replicate_factor)
        self.ema_floor = float(ema_floor)
        self.improve_margin = float(improve_margin)

    @staticmethod
    def _projected_imbalance(replicas, v: np.ndarray, m: int) -> float:
        """max*m/total of the per-shard EMA load a replica map would
        carry (the same replica-split accounting as ``record_load``)."""
        load = np.zeros(m, np.float64)
        for e in np.nonzero(v)[0]:
            shards = replicas[int(e)]
            share = float(v[e]) / len(shards)
            for s in shards:
                load[s] += share
        tot = float(load.sum())
        return float(load.max()) * m / tot if tot > 0 else 1.0

    def table_width(self, num_shards: int) -> int:
        # full replication is the ceiling: the replica table is
        # (E, num_shards) from the start, so later plan swaps that add
        # replicas never change its shape
        return int(num_shards)

    def update(self, plan: PlacementPlan, usage, shard_load,
               slots_per_shard: int) -> Optional[PlacementPlan]:
        E, m = plan.num_experts, plan.num_shards
        if m < 2:
            return None
        v = usage.ema.sum(axis=0)
        # deterministic hot order: EMA descending, ties by expert id
        order = np.lexsort((np.arange(E), -v))
        active = [int(e) for e in order if v[e] > self.ema_floor]
        if not active:
            return None
        thresh = self.replicate_factor * float(v[active].mean())
        cap = max(1, int(slots_per_shard))
        load = np.zeros(m, np.float64)
        nslots = np.zeros(m, np.int64)
        replicas = [plan.shards_of(e) if v[e] <= self.ema_floor else None
                    for e in range(E)]
        for e in active:
            shards: list[int]
            if m > 1 and float(v[e]) >= thresh:
                # hot enough to replicate: every shard with bank room
                shards = [s for s in range(m) if nslots[s] < cap]
                if len(shards) < 2:
                    shards = []
            else:
                shards = []
            if not shards:
                # single home: least-loaded shard with room (ignore the
                # cap only when every bank is already spoken for — the
                # overflow experts demand-page, as they always did)
                cands = [s for s in range(m) if nslots[s] < cap] \
                    or list(range(m))
                shards = [min(cands, key=lambda s: (load[s], s))]
            share = float(v[e]) / len(shards)
            for s in shards:
                load[s] += share
                nslots[s] += 1
            replicas[e] = tuple(sorted(shards))
        new = tuple(replicas)
        if new == plan.replicas:
            return None
        # hysteresis: a changed layout must beat the CURRENT plan's
        # projected imbalance by the margin, or EMA drift would reorder
        # the greedy deal every cadence and churn migrations forever
        cur_imb = self._projected_imbalance(plan.replicas, v, m)
        new_imb = self._projected_imbalance(new, v, m)
        if new_imb >= self.improve_margin * cur_imb:
            return None
        return plan.evolve(new)
