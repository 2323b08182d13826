"""Expert-weight paging: bounded device residency for MoE expert weights,
on one device or expert-parallel over a mesh — the port of
``repro.serve.expert_cache`` (``ExpertUsage``, ``ExpertCache``,
``ShardedExpertCache``, ``PagedMoE``).

The software analogue of Edge-MoE's DDR expert streaming (§IV-D): device
memory holds only a bounded set of expert weights (a fraction of E, or a
byte budget); the rest live in pinned host memory and are paged in on
demand.  Three pieces:

  * ``ExpertUsage``   — per-task EMA of the router's per-expert dispatch
    counts, the prediction signal: the paper's task-level sparsity makes
    each task's working set stable, so usage history predicts the next
    batch's.
  * ``ExpertCache``   — the residency manager: one stacked ``(R, ...)``
    device tensor per weight name (the slots), a pinned host store built
    once, LRU eviction decided by the placement policy, demand paging with
    hit/miss/byte accounting, and usage-driven prefetch, synchronous or
    through a transfer engine (``serve/transfer.py``).  A page-in is one
    copy per weight into the expert's slot row, on the compute stream:
    from the pinned host row when synchronous, from the transfer's payload
    when fenced.
  * ``PagedMoE``      — a serve-time MoE layer that routes once, pages
    the needed experts, and runs the staged expert FFN in *waves* of at
    most R resident experts: each wave dispatches every routing group at
    once into a ``(G, R, C, d)`` buffer, runs ``_expert_ffn`` on the slots
    (``moe_gemm`` and ``gelu_lut`` under ``cuda``) and writes its slots'
    rows into a ``(G, T·k, d)`` row buffer (waves touch disjoint rows);
    the finish step is ``routing.combine_rows``, the arithmetic of
    ``routing.combine`` — so the paged forward is **bit-exact** with the
    all-resident staged forward at any residency.

Packed expert weights page as their packed tensors: a ``QTensor`` leaf as
``<name>.q`` and ``<name>.scale``, a ``FactoredTensor``'s deltas as
``<name>.u`` and ``<name>.v`` (split further into ``.q``/``.scale`` when
quantized), while the factored basis is a *pinned* leaf — on the device
once, never paged.  Per-expert bytes, and so the slots a byte budget
buys, count the paged leaves only; the pinned bytes come off the budget
first.  Each wave rebuilds the packed objects from the slots (and the
pinned basis), so its expert products dispatch the ``eager_int8`` /
``eager_factored`` impls, which take one product per expert: a slot's
product has the shape the all-resident expert's has, and paged output
stays bit-exact.

Expert parallelism (``PagedMoE(mesh=...)``): ``ShardedExpertCache``
places the experts over the mesh's ``model`` axis by a placement plan.
Each rank holds one bounded slot bank, its own shard's, on its device; the
bookkeeping (one ``ExpertCache`` a shard, keyed by global expert id) runs
on every rank alike, so every rank plans the same waves.  A wave runs each
shard's slots on that shard (``moe_gemm`` on its own bank), and one
all-gather over ``model`` after the last wave brings every row home; the
finish is ``combine_rows`` in the single-device order, so expert-parallel
paging equals ``apply_moe`` bit for bit too.  The reference's XLA-only
store machinery (donated jitted writes, power-of-two write batches, the
stacked (shards, R, ...) store) has no counterpart: PyTorch writes a slot
of the rank's own bank in place.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import tensor_from_numpy
from repro_torch.core import moe as moe_lib
from repro_torch.core import routing as R
from repro_torch.core.moe import MoEConfig, expert_param_names
from repro_torch.dist.sharding import axis_names
from repro_torch.factor.factored import FactoredTensor, is_factored
from repro_torch.quant.qtensor import QTensor, is_qtensor
from repro_torch.serve.placement import (PlacementPlan, PlacementPolicy,
                                         get_policy)
from repro_torch.serve.transfer import Transfer

__all__ = ["ExpertUsage", "ExpertCache", "ShardedExpertCache", "PagedMoE"]

# how many truncation-dropped prefetch ids each cache retains as evidence
# (bounded so a long-running server cannot grow the list without limit)
PREFETCH_DROPPED_KEEP = 64


def _host_tensor(w) -> torch.Tensor:
    """A weight (tensor on any device, or NumPy) as a contiguous CPU
    tensor."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu").contiguous()
    return tensor_from_numpy(w)


def _per_expert_bytes(host: dict) -> int:
    """Device bytes one expert occupies across the paged weight leaves —
    the unit of paging accounting and byte-budget residency sizing.
    Pinned leaves (a factored layer's shared basis) are not in ``host``:
    they are resident once, not per expert (:func:`_pinned_bytes`)."""
    return sum(int(w[0].nbytes) for w in host.values())


def _pinned_bytes(pinned: dict) -> int:
    """Device bytes of the always-resident (never paged) leaves."""
    return sum(int(v.nbytes) for v in pinned.values())


class ExpertUsage:
    """Per-task EMA + cumulative totals of per-expert dispatch counts."""

    def __init__(self, num_experts: int, num_tasks: int = 1,
                 decay: float = 0.9):
        self.num_experts = num_experts
        self.num_tasks = max(1, num_tasks)
        self.decay = decay
        self.ema = np.zeros((self.num_tasks, num_experts), np.float64)
        self.totals = np.zeros((self.num_tasks, num_experts), np.int64)

    def update(self, counts, task_id: int = 0) -> None:
        c = np.asarray(counts, np.float64).reshape(-1)
        if c.size != self.num_experts:
            raise ValueError(f"counts size {c.size} != E={self.num_experts}")
        self.ema[task_id] = self.decay * self.ema[task_id] \
            + (1.0 - self.decay) * c
        self.totals[task_id] += c.astype(np.int64)

    def hot(self, k: int, task_id: Optional[int] = None) -> list[int]:
        """Top-k expert ids by EMA usage (one task, or summed over tasks),
        ties broken by expert id explicitly (lexsort keys), so prefetch
        ranking is deterministic."""
        v = self.ema[task_id] if task_id is not None else self.ema.sum(axis=0)
        order = np.lexsort((np.arange(v.size), -v))
        return [int(e) for e in order[:k]]

    def task_overlap(self) -> float:
        """Mean pairwise cosine similarity of per-task usage — low values
        are the paper's task-level sparsity (disjoint working sets)."""
        if self.num_tasks < 2:
            return 1.0
        sims = []
        for a in range(self.num_tasks):
            for b in range(a + 1, self.num_tasks):
                u, v = self.totals[a].astype(float), self.totals[b].astype(float)
                n = np.linalg.norm(u) * np.linalg.norm(v)
                sims.append(float(u @ v / n) if n else 1.0)
        return float(np.mean(sims))


class ExpertCache:
    """Bounded device slots over a pinned host (E, ...) weight store.

    ``host``: {name: (E, ...) tensor or array} — the per-expert weights
    (``expert_param_names`` order), copied once into pinned host memory
    (plain CPU tensors for ``device="cpu"``).  ``max_resident`` slots per
    name are allocated on ``device`` as one stacked ``(R, ...)`` tensor;
    ``ensure`` demand-pages, ``prefetch`` warms without touching the
    demand hit/miss counters.  ``pinned`` leaves (always resident, no
    expert axis) are put on the device once and never paged.

    With a ``transfer_engine`` the cache pages asynchronously:
    ``prefetch_async`` *submits* copies and returns at once (the slot is
    reserved and the expert tracked in flight), ``ensure`` *fences* any
    in-flight member before the caller dereferences it, and demand misses
    submit-then-fence.  Evicting an in-flight expert cancels its transfer,
    so a late completion never lands in the slot's next occupant.  Every
    slot write is a copy on the current (compute) stream, ordered after
    every wave already queued there that reads the slot; the engine's side
    stream only writes its own payload tensors.

    ``store=False`` keeps the books only (the reference's external-write
    mode): no slots, no copies — a sharded cache's record of another
    rank's bank, whose residency decisions it replays.
    """

    def __init__(self, host: dict, max_resident: int,
                 usage: Optional[ExpertUsage] = None,
                 transfer_engine=None, label: str = "cache",
                 pinned: Optional[dict] = None,
                 policy: Optional[PlacementPolicy] = None,
                 device="cuda", store: bool = True):
        if not host:
            raise ValueError("empty expert weight store")
        self.device = resolve_device(device)
        # all residency DECISIONS (victim pick, prefetch ranking) live in
        # the policy; this class is mechanism — slots, copies, commits
        self.policy = policy if policy is not None else get_policy("static")
        pinned = pinned or {}
        clash = set(pinned) & set(host)
        if clash:
            raise ValueError(f"leaves both pinned and paged: {sorted(clash)}")
        self.store = store
        self.pinned = {n: _host_tensor(v).to(self.device)
                       for n, v in pinned.items()} if store else {}
        self.pinned_bytes = _pinned_bytes(self.pinned)
        # transfer keys are (label, expert): stable and test-addressable
        self.label = label
        self.names = tuple(host)
        store = {n: _host_tensor(w) for n, w in host.items()}
        self.num_experts = next(iter(store.values())).shape[0]
        for n, w in store.items():
            if w.shape[0] != self.num_experts:
                raise ValueError(f"{n}: leading dim {w.shape[0]} != E")
        self.max_resident = max(1, min(int(max_resident), self.num_experts))
        # page-locked, so a copy from it never runs synchronously; pinning
        # that fails raises here
        pin = self.device.type == "cuda" and self.store
        self.host = {n: w.pin_memory() if pin else w
                     for n, w in store.items()}
        self.usage = usage
        self.slots = {
            n: torch.zeros((self.max_resident,) + tuple(w.shape[1:]),
                           dtype=w.dtype, device=self.device)
            for n, w in self.host.items()
        } if self.store else {}
        self._slot_expert = [-1] * self.max_resident     # slot -> expert id
        self._lru: OrderedDict[int, int] = OrderedDict()  # expert -> slot
        self.engine = transfer_engine
        # expert -> (slot, Transfer): slot reserved, copy not yet committed
        self._inflight: dict[int, tuple[int, Transfer]] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_paged = 0
        self.async_prefetches = 0     # transfers submitted by prefetch_async
        self.inflight_joins = 0       # in-flight transfers fenced by ensure
        self.async_cancelled = 0      # in-flight prefetches killed by evict
        self.prefetch_truncated = 0   # ids dropped by over-long prefetch
        # dropped ids ACCUMULATE (bounded) — a multi-wave run keeps earlier
        # truncation evidence
        self.prefetch_dropped: deque[int] = deque(maxlen=PREFETCH_DROPPED_KEEP)
        self._expert_bytes = _per_expert_bytes(self.host)

    # -------------------------------------------------------------- state

    @property
    def resident(self) -> list[int]:
        """Experts holding a slot — committed OR reserved by an in-flight
        prefetch (wave planning treats an arriving expert as warm; its
        copy is fenced before any dereference)."""
        return [e for e in self._slot_expert if e >= 0]

    @property
    def inflight(self) -> list[int]:
        """Experts whose copy has been submitted but not yet fenced."""
        return list(self._inflight)

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 1.0

    def reset_stats(self) -> None:
        self.hits = self.misses = self.evictions = self.bytes_paged = 0
        self.async_prefetches = self.inflight_joins = 0
        self.async_cancelled = 0
        self.prefetch_truncated = 0
        self.prefetch_dropped.clear()

    def stats(self) -> dict[str, Any]:
        out = {
            "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions, "bytes_paged": self.bytes_paged,
            "hit_rate": self.hit_rate,
            "max_resident": self.max_resident,
            "resident_fraction": self.max_resident / self.num_experts,
            "prefetch_truncated": self.prefetch_truncated,
            "prefetch_dropped": list(self.prefetch_dropped),
            "paged_expert_bytes": self._expert_bytes,
            "pinned_bytes": self.pinned_bytes,
        }
        if self.engine is not None:
            out.update({
                "async_prefetches": self.async_prefetches,
                "inflight_joins": self.inflight_joins,
                "async_cancelled": self.async_cancelled,
                "inflight": len(self._inflight),
                "stall_s": self.engine.stats.stall_s,
                "overlap_ratio": self.engine.stats.overlap_ratio,
            })
        return out

    # ------------------------------------------------------------- paging

    def _reserve_slot(self, pinned: set[int]) -> int:
        """Claim a slot for a new occupant: first free slot, else evict the
        policy's victim (LRU-not-in-working-set for every stock policy).
        Evicting an expert whose prefetch is still in flight CANCELS the
        transfer — the copy never committed, so the slot's next occupant
        cannot be clobbered by a late completion."""
        free = [s for s, e in enumerate(self._slot_expert) if e < 0]
        if free:
            return free[0]
        victim = self.policy.victim(self._lru, pinned)
        slot = self._lru.pop(victim)
        self._slot_expert[slot] = -1
        self.evictions += 1
        vt = self._inflight.pop(victim, None)
        if vt is not None:
            self.engine.cancel(vt[1])
            self.async_cancelled += 1
        return slot

    def _commit(self, expert: int, slot: int, rows: dict) -> None:
        """Land ``rows`` (pinned host rows, or a fenced transfer's device
        payload) in ``slot`` — one copy per weight on the current stream —
        and finish the residency bookkeeping."""
        if self.store:
            for n in self.names:
                self.slots[n][slot].copy_(rows[n], non_blocking=True)
        self._slot_expert[slot] = expert
        self._lru[expert] = slot
        self.bytes_paged += self._expert_bytes

    def _host_rows(self, expert: int) -> dict[str, torch.Tensor]:
        return {n: self.host[n][expert] for n in self.names}

    def _page_in(self, expert: int, pinned: set[int]) -> None:
        """Synchronous demand page-in (also the misprediction fallback:
        an expert nobody prefetched still pages correctly — through the
        engine when one is attached, so its stall is accounted)."""
        slot = self._reserve_slot(pinned)
        new = self._host_rows(expert) if self.store else None
        if self.engine is not None:
            tr = self.engine.submit((self.label, expert), new, tag="demand")
            new = self.engine.fence(tr)
        self._commit(expert, slot, new)

    def _submit_async(self, expert: int, pinned: set[int],
                      tag: str = "demand") -> Transfer:
        """Reserve a slot and start a non-blocking copy for ``expert``.
        The slot is RESERVED (``_slot_expert``/``_lru`` claim it so LRU
        ordering and wave planning see it coming) but not written until
        the transfer is fenced and committed."""
        slot = self._reserve_slot(pinned)
        tr = self.engine.submit((self.label, expert),
                                self._host_rows(expert), tag=tag)
        self._inflight[expert] = (slot, tr)
        self._slot_expert[slot] = expert
        self._lru[expert] = slot
        return tr

    def ensure_submit(self, expert_ids, record: bool = True) -> list[int]:
        """Async first half of ``ensure``: submit copies for every missing
        id without fencing any — the per-expert transfers overlap each
        other and whatever compute is already queued.  Returns the ids
        that must be fenced (``ensure_fence``) before dereferencing.
        Requires a transfer engine."""
        needed = self._check_working_set(expert_ids)
        pinned = set(needed)
        to_fence = []
        for e in needed:
            if e in self._inflight:
                self._lru.move_to_end(e)
                if record:
                    self.hits += 1     # prefetch predicted it; fence below
                to_fence.append(e)
            elif e in self._lru:
                self._lru.move_to_end(e)
                if record:
                    self.hits += 1
            else:
                if record:
                    self.misses += 1
                self._submit_async(e, pinned)
                to_fence.append(e)
        return to_fence

    def ensure_fence(self, expert_ids) -> None:
        """Fence and commit the in-flight members of ``expert_ids`` (the
        second half of the async ``ensure``).  If a fence raises (a hung
        transport), everything fenced before it is still committed — then
        the timeout propagates, loud."""
        for e in expert_ids:
            e = int(e)
            if e in self._inflight:
                slot, tr = self._inflight.pop(e)
                payload = self.engine.fence(tr)
                self._commit(e, slot, payload)
                self.inflight_joins += 1

    def _check_working_set(self, expert_ids) -> list[int]:
        needed = list(dict.fromkeys(int(e) for e in expert_ids))
        if len(needed) > self.max_resident:
            raise ValueError(
                f"{len(needed)} experts needed at once but only "
                f"{self.max_resident} slots — page in waves")
        return needed

    def ensure(self, expert_ids, record: bool = True) -> None:
        """Make every id in ``expert_ids`` device-resident (≤ max_resident).

        With a transfer engine this is submit-all-then-fence-all, so the
        misses' copies overlap each other; in-flight prefetches are fenced
        (and counted as hits — the prediction turned demand paging into an
        already-flying copy).  Without an engine every miss is a copy from
        the pinned host store on the compute stream."""
        if self.engine is not None:
            self.ensure_fence(self.ensure_submit(expert_ids, record=record))
            return
        needed = self._check_working_set(expert_ids)
        pinned = set(needed)
        for e in needed:
            if e in self._lru:
                self._lru.move_to_end(e)
                if record:
                    self.hits += 1
            else:
                if record:
                    self.misses += 1
                self._page_in(e, pinned)

    def _truncate_prefetch(self, expert_ids) -> list[int]:
        ids = list(dict.fromkeys(int(e) for e in expert_ids))
        keep, dropped = ids[: self.max_resident], ids[self.max_resident:]
        if dropped:
            self.prefetch_truncated += len(dropped)
            self.prefetch_dropped.extend(dropped)
        return keep

    def prefetch(self, expert_ids) -> None:
        """Warm residency (e.g. from ``ExpertUsage.hot``) without demand
        accounting — prefetched experts later hit in ``ensure``.

        A warm-up list longer than the slot count is truncated to the first
        ``max_resident`` (unique) ids; the dropped count and ids ACCUMULATE
        in the stats (``prefetch_truncated`` / ``prefetch_dropped``)."""
        self.ensure(self._truncate_prefetch(expert_ids), record=False)

    def prefetch_async(self, expert_ids, tag: str = "prefetch") -> list[int]:
        """Router-lookahead warm-up: SUBMIT copies for the given ids and
        return at once (``ensure`` fences them at the point of use).
        Without an engine this is the synchronous ``prefetch``.  Returns
        the ids actually submitted."""
        if self.engine is None:
            self.prefetch(expert_ids)
            return []
        keep = self._truncate_prefetch(expert_ids)
        pinned = set(keep)
        submitted = []
        for e in keep:
            if e in self._lru:              # resident or already in flight
                self._lru.move_to_end(e)
                continue
            self._submit_async(e, pinned, tag=tag)
            self.async_prefetches += 1
            submitted.append(e)
        return submitted

    def drop(self, expert: int) -> bool:
        """Release ``expert``'s slot, if it holds one (an in-flight copy is
        cancelled).  A placement drop, not a capacity eviction: the
        eviction counter is untouched.  Returns True when a slot was
        freed."""
        e = int(expert)
        slot = self._lru.pop(e, None)
        if slot is None:
            return False
        self._slot_expert[slot] = -1
        vt = self._inflight.pop(e, None)
        if vt is not None:
            self.engine.cancel(vt[1])
            self.async_cancelled += 1
        return True

    def fence_all(self) -> None:
        """Commit every outstanding in-flight transfer (a full barrier)."""
        self.ensure_fence(list(self._inflight))

    def remap(self) -> np.ndarray:
        """(E,) int32: expert id -> device slot, ``-1`` for non-resident.

        The sentinel is deliberate: a non-resident id must never alias
        whatever expert occupies slot 0.  ``PagedMoE`` dereferences slot
        indices only where the wave mask holds and checks that every wave
        id maps to a real slot before it launches the wave.  An in-flight
        expert maps to its reserved slot, whose contents are stale until
        ``ensure`` fences it."""
        m = np.full((self.num_experts,), -1, np.int32)
        for s, e in enumerate(self._slot_expert):
            if e >= 0:
                m[e] = s
        return m

    def replica_table(self) -> tuple[np.ndarray, np.ndarray]:
        """``(table, counts)``: ``table`` (E, 1) int32 slot ids (−1 for
        non-resident) and ``counts`` (E,) int32 resident-replica counts.
        A single-device cache never replicates, so counts is the residency
        indicator."""
        remap = self.remap()
        return remap[:, None], (remap >= 0).astype(np.int32)


class ShardedExpertCache:
    """Expert-parallel residency: experts placed over a mesh axis by a
    :class:`~repro_torch.serve.placement.plan.PlacementPlan`.

    Shard ``s`` of ``m`` holds a bounded bank of ``max_resident`` slots and
    serves the experts the plan assigns it — under the static plan the
    contiguous block ``[s·E/m, (s+1)·E/m)``; an elastic plan may move a
    cold expert's home or replicate a hot one.  One ``ExpertCache`` a
    shard keeps the books (LRU, hit/miss/bytes, prefetch truncation),
    keyed by GLOBAL expert id, with transfer keys ``("shard<s>", e)``.  On
    each rank only its own shard's book holds slots (on ``device``) and
    pages through the transfer engine; the others replay the same
    decisions with no copies (``store=False``), so every rank sees the
    same residency and plans the same waves.  A fixed per-device slot
    budget therefore holds ``m × R`` resident experts in aggregate.

    Plan swaps (:meth:`set_plan`) happen between forwards: residency on a
    shard the new plan removed is dropped, new homes page in (tagged
    ``migrate`` with an engine, else on demand), and the generation
    counter makes each swap observable once.
    """

    def __init__(self, host: dict, max_resident: int, mesh,
                 axis: str = "model", usage: Optional[ExpertUsage] = None,
                 transfer_engine=None, pinned: Optional[dict] = None,
                 policy: Optional[PlacementPolicy] = None,
                 plan: Optional[PlacementPlan] = None, device="cuda"):
        from repro_torch.dist.spmd import axis_index, axis_size

        if not host:
            raise ValueError("empty expert weight store")
        self.mesh = mesh
        self.axis = axis
        self.engine = transfer_engine
        self.policy = policy if policy is not None else get_policy("static")
        m = axis_size(mesh, axis)
        self.num_shards = m
        self.shard = axis_index(mesh, axis)       # this rank's bank
        self.num_experts = next(iter(host.values())).shape[0]
        if self.num_experts % m:
            raise ValueError(f"E={self.num_experts} does not divide the "
                             f"{m}-way {axis!r} axis")
        self.e_local = self.num_experts // m
        self.plan = plan if plan is not None \
            else self.policy.initial_plan(self.num_experts, m)
        if (self.plan.num_experts, self.plan.num_shards) \
                != (self.num_experts, m):
            raise ValueError(
                f"plan is ({self.plan.num_experts} experts, "
                f"{self.plan.num_shards} shards); cache has "
                f"({self.num_experts}, {m})")
        # the replica table's width is fixed by the policy (1 for static,
        # m for elastic): a bank of width 1 never holds more than its
        # shard's share, a replicating bank up to E
        self.table_width = max(1, min(int(self.policy.table_width(m)), m))
        cap = self.e_local if self.table_width == 1 else self.num_experts
        self.max_resident = max(1, min(int(max_resident), cap))
        self.usage = usage
        self.shard_load = np.zeros(m, np.float64)
        self.plan_swaps = 0
        self.migrations = 0        # replica additions from plan swaps
        self.migration_drops = 0   # residency released by plan swaps
        self.replications = 0      # experts whose replica count grew
        host = {n: _host_tensor(w) for n, w in host.items()}
        self.books = [
            ExpertCache(host, self.max_resident,
                        transfer_engine=transfer_engine if s == self.shard
                        else None, label=f"shard{s}",
                        pinned=pinned if s == self.shard else None,
                        policy=self.policy, device=device,
                        store=s == self.shard)
            for s in range(m)]
        self.names = self.books[0].names
        self._expert_bytes = self.books[0]._expert_bytes
        self.pinned_bytes = self.books[self.shard].pinned_bytes

    # -------------------------------------------------------------- state

    @property
    def slots(self) -> dict:
        """This rank's bank: {name: (R, ...)} on its device."""
        return self.books[self.shard].slots

    @property
    def pinned(self) -> dict:
        return self.books[self.shard].pinned

    @property
    def total_slots(self) -> int:
        return self.num_shards * self.max_resident

    def owner(self, expert: int) -> int:
        """Primary home shard of ``expert`` (the plan's call)."""
        return self.plan.owner(expert)

    @property
    def resident(self) -> list[int]:
        """Global ids holding a slot on ANY shard (a replicated expert is
        listed once)."""
        out: dict[int, None] = {}
        for book in self.books:
            out.update(dict.fromkeys(book.resident))
        return list(out)

    def _sum(self, attr: str) -> int:
        return sum(getattr(b, attr) for b in self.books)

    hits = property(lambda self: self._sum("hits"))
    misses = property(lambda self: self._sum("misses"))
    evictions = property(lambda self: self._sum("evictions"))
    bytes_paged = property(lambda self: self._sum("bytes_paged"))
    prefetch_truncated = property(
        lambda self: self._sum("prefetch_truncated"))

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 1.0

    def reset_stats(self) -> None:
        for b in self.books:
            b.reset_stats()
        # placement event counters are cumulative (the plan's history);
        # only the per-interval load evidence resets
        self.shard_load[:] = 0.0

    def record_load(self, per_expert_counts) -> None:
        """Fold one forward's routed-token counts into the per-shard load
        ledger: an expert's tokens land on its plan shards (replicas split
        evenly, as the wave dispatch splits them)."""
        c = np.asarray(per_expert_counts, np.float64).reshape(-1)
        for e in np.nonzero(c)[0]:
            shards = self.plan.shards_of(int(e))
            share = c[e] / len(shards)
            for s in shards:
                self.shard_load[s] += share

    def shard_load_imbalance(self) -> float:
        """max/mean of per-shard routed load (1.0 even, m all on one
        shard); 0.0 before any load is recorded."""
        tot = float(self.shard_load.sum())
        if tot <= 0:
            return 0.0
        return float(self.shard_load.max() * self.num_shards / tot)

    def stats(self) -> dict[str, Any]:
        out = {
            "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions, "bytes_paged": self.bytes_paged,
            "hit_rate": self.hit_rate,
            "max_resident": self.max_resident,       # per shard
            "num_shards": self.num_shards,
            "total_slots": self.total_slots,
            "resident_fraction": self.total_slots / self.num_experts,
            "prefetch_truncated": self.prefetch_truncated,
            "paged_expert_bytes": self._expert_bytes,
            "pinned_bytes": self.pinned_bytes,       # per device
            "shard_load": [float(v) for v in self.shard_load],
            "shard_load_imbalance": self.shard_load_imbalance(),
            "placement": {
                "policy": self.policy.name,
                "generation": self.plan.generation,
                "plan_swaps": self.plan_swaps,
                "migrations": self.migrations,
                "migration_drops": self.migration_drops,
                "replications": self.replications,
                "max_replicas": self.plan.max_replicas,
                "table_width": self.table_width,
            },
        }
        if self.engine is not None:
            mine = self.books[self.shard]
            out.update({
                "async_prefetches": mine.async_prefetches,
                "inflight_joins": mine.inflight_joins,
                "async_cancelled": mine.async_cancelled,
                "inflight": len(mine._inflight),
                "stall_s": self.engine.stats.stall_s,
                "overlap_ratio": self.engine.stats.overlap_ratio,
                "transfer_tags": self.engine.stats.tags_dict(),
            })
        return out

    # ------------------------------------------------------------- paging

    def _by_shard(self, expert_ids) -> dict[int, list[int]]:
        """Fan global ids out to the plan's shards (a replicated expert
        appears in several shards' lists)."""
        by: dict[int, list[int]] = {}
        for e in expert_ids:
            for s in self.plan.shards_of(int(e)):
                by.setdefault(s, []).append(int(e))
        return by

    def ensure(self, expert_ids, record: bool = True) -> None:
        """Make every (global) id resident on its plan shards; this rank's
        copies are submitted before any is fenced."""
        for s, local in self._by_shard(expert_ids).items():
            self.books[s].ensure(local, record=record)

    def prefetch(self, expert_ids) -> None:
        """Warm each shard's bank with its share of ``expert_ids``."""
        for s, local in self._by_shard(expert_ids).items():
            self.books[s].prefetch(local)

    def prefetch_async(self, expert_ids, tag: str = "prefetch") -> list[int]:
        """Submit this rank's copies of its share of ``expert_ids`` (the
        other shards' books record theirs); returns the ids submitted
        here."""
        submitted = []
        for s, ids in self._by_shard(expert_ids).items():
            got = self.books[s].prefetch_async(ids, tag=tag)
            if s == self.shard:
                submitted.extend(got)
        return submitted

    def fence_all(self) -> None:
        for b in self.books:
            b.fence_all()

    # ---------------------------------------------------------- placement

    def set_plan(self, new_plan: PlacementPlan) -> None:
        """Install a rebalanced plan between forwards: residency on shards
        the new plan removed is dropped, new homes page in (tagged
        ``migrate`` with an engine), the generation advances."""
        if (new_plan.num_experts, new_plan.num_shards) \
                != (self.num_experts, self.num_shards):
            raise ValueError("plan shape does not match cache")
        if new_plan.generation <= self.plan.generation:
            raise ValueError(
                f"plan generation must advance: {new_plan.generation} <= "
                f"{self.plan.generation}")
        if new_plan.max_replicas > self.table_width:
            raise ValueError(
                f"plan replicates {new_plan.max_replicas}-way but the "
                f"replica table is {self.table_width} wide")
        old = self.plan
        added: dict[int, list[int]] = {}
        for e in range(self.num_experts):
            before = set(old.shards_of(e))
            after = set(new_plan.shards_of(e))
            for s in before - after:
                if self.books[s].drop(e):
                    self.migration_drops += 1
            for s in after - before:
                added.setdefault(s, []).append(e)
            if len(after) > len(before):
                self.replications += 1
        self.plan = new_plan
        self.plan_swaps += 1
        self.migrations += sum(len(v) for v in added.values())
        if self.engine is not None:
            for s, ids in added.items():
                self.books[s].prefetch_async(ids, tag="migrate")

    def remap(self) -> np.ndarray:
        """(E,) int32: expert id -> GLOBAL slot ``shard·R + slot`` of its
        primary resident replica, ``-1`` for non-resident."""
        table, counts = self.replica_table()
        return np.where(counts > 0, table[:, 0], -1).astype(np.int32)

    def replica_table(self) -> tuple[np.ndarray, np.ndarray]:
        """``(table, counts)``: ``table`` (E, W) int32, the resident
        replicas' global slots ``shard·R + slot`` in plan order (primary
        first), −1 padded; ``counts`` (E,) the resident-replica counts.
        A wave deals an expert's tokens round-robin over its first
        ``counts[e]`` columns (``position % counts``)."""
        books = [b.remap() for b in self.books]
        table = np.full((self.num_experts, self.table_width), -1, np.int32)
        counts = np.zeros(self.num_experts, np.int32)
        for e in range(self.num_experts):
            k = 0
            for s in self.plan.shards_of(e):
                if k >= self.table_width:
                    break
                slot = books[s][e]
                if slot >= 0:
                    table[e, k] = s * self.max_resident + slot
                    k += 1
            counts[e] = k
        return table, counts


class PagedMoE:
    """Serve-time MoE layer with bounded expert residency on one device.

    Call semantics match ``core.moe.apply_moe(params, cfg, x, task_id)``
    with a scalar task: returns ``(y, aux)``, bit-exact with the
    all-resident staged path (``moe_ffn`` through dispatch, the expert
    GEMMs and combine) under the same policy.  The route step runs once
    per forward and reads the per-expert counts on the host once (the
    waves are planned from them).  The expert FFN then runs in waves of
    at most ``max_resident`` experts; each wave writes its slots' rows
    into a shared (token, slot) row buffer (waves touch disjoint rows),
    and the finish applies the gate weights and sums the k slots exactly
    as ``routing.combine`` does — so splitting into waves never changes a
    bit.  Under a policy whose ``moe_ffn`` is the fused kernel
    (``cuda_fused``) the waves still run the staged kernels, as the
    reference's do: the paged output then agrees with the fused
    all-resident output to the kernels' stated tolerance, not bit for
    bit.

    ``params`` are the layer's MoE params (``gate``, optional
    ``gate_bias``, the expert leaves, optional shared experts); the expert
    leaves — tensors, ``QTensor`` or ``FactoredTensor`` objects — may lie
    anywhere (their paged tensors are copied to the pinned host store, a
    factored basis to the device), the rest is moved to ``device``.

    ``mesh`` (a ``DeviceMesh`` with an ``ep_axis``) pages expert-parallel
    through a :class:`ShardedExpertCache`: waves are planned first-fit
    against every shard's bank (an expert joins the first wave in which
    all of its plan shards have a free slot), each rank runs its own
    bank's slots, and the rows come home by one all-gather over
    ``ep_axis`` — bit-exact with ``apply_moe`` as on one device.  The
    tokens are the rank's own (the same on every rank of an ``ep_axis``
    group).  A mesh of one runs the same path with one shard.
    """

    def __init__(self, params, cfg: MoEConfig,
                 resident_fraction: float = 0.5,
                 usage: Optional[ExpertUsage] = None,
                 usage_decay: float = 0.9,
                 budget_bytes: Optional[int] = None, mesh=None,
                 transfer_engine=None, placement=None, device="cuda",
                 ep_axis: str = "model"):
        from repro_torch.dist.spmd import axis_size

        if mesh is not None and ep_axis not in axis_names(mesh):
            raise ValueError(f"mesh has no {ep_axis!r} axis")
        self.mesh, self.ep_axis = mesh, ep_axis
        shards = axis_size(mesh, ep_axis) if mesh is not None else 1
        if cfg.impl not in ("grouped", "onehot"):
            raise NotImplementedError(
                f"MoE impl {cfg.impl!r}: the port pages the 'grouped' and "
                "'onehot' paths (both gather, as the reference's waves do "
                "on one device)")
        names = expert_param_names(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        # packed leaves split into the tensors the cache pages (and a
        # factored basis into a pinned leaf); _slot_params rebuilds them
        self._names = names
        self._qmeta: dict[str, tuple] = {}
        self._fmeta: dict[str, dict] = {}
        host: dict[str, torch.Tensor] = {}
        pinned: dict[str, torch.Tensor] = {}

        def host_leaf(key: str, leaf):
            """One paged leaf (tensor or QTensor) into host entries; the
            QTensor's rebuild meta, or None for a tensor."""
            if is_qtensor(leaf):
                host[key + ".q"] = _host_tensor(leaf.q)
                host[key + ".scale"] = _host_tensor(leaf.scale)
                return (leaf.bits, leaf.dtype, leaf.rows)
            host[key] = _host_tensor(leaf)
            return None

        for n in names:
            wn = params[n]
            if is_factored(wn):
                pinned[n + ".basis"] = wn.basis
                self._fmeta[n] = {"kind": wn.kind, "dtype": wn.dtype,
                                  "u": host_leaf(n + ".u", wn.u),
                                  "v": host_leaf(n + ".v", wn.v)}
            else:
                self._qmeta[n] = host_leaf(n, wn)
        # residency decisions live in the placement policy: ``placement``
        # is a name ("static"/"lru"/"budget"/"elastic") or a constructed
        # PlacementPolicy.  A bare ``budget_bytes`` resolves to the budget
        # policy; an explicit policy without its own budget inherits it.
        if isinstance(placement, PlacementPolicy):
            self.policy = placement
        elif placement in (None, "static") and budget_bytes is not None:
            self.policy = get_policy("budget", budget_bytes=budget_bytes)
        else:
            self.policy = get_policy(placement)
        if budget_bytes is not None and self.policy.budget_bytes is None:
            self.policy.budget_bytes = int(budget_bytes)
        # one device: at least top_k slots, so one wave can serve a
        # token's whole expert set; per-shard banks need only one (waves
        # fill disjoint rows, so splitting never hurts)
        max_resident = self.policy.slots(
            per_expert_bytes=_per_expert_bytes(host),
            pinned_bytes=_pinned_bytes(pinned),
            experts_per_shard=cfg.num_experts // shards,
            resident_fraction=resident_fraction,
            floor=cfg.top_k if mesh is None else 1)
        self.usage = usage or ExpertUsage(cfg.num_experts, cfg.num_tasks,
                                          decay=usage_decay)
        self.engine = transfer_engine
        if mesh is not None:
            self.cache = ShardedExpertCache(
                host, max_resident, mesh, axis=ep_axis, usage=self.usage,
                transfer_engine=transfer_engine, pinned=pinned,
                policy=self.policy, device=self.device)
        else:
            self.cache = ExpertCache(host, max_resident, usage=self.usage,
                                     transfer_engine=transfer_engine,
                                     pinned=pinned, policy=self.policy,
                                     device=self.device)
        self._forwards = 0   # rebalance cadence counter
        # per-wave record of the most recent forward (wave id, expert
        # count, lookahead submissions, fence stall)
        self.last_timeline: list[dict] = []
        self.router = {k: params[k].to(self.device)
                       for k in ("gate", "gate_bias") if k in params}
        self.shared = {k: params[k].to(self.device) for k in
                       ("shared_wg", "shared_wu", "shared_wd") if k in params}

    def _slot_params(self) -> dict:
        """The per-slot expert params from the device slots: packed leaves
        rewrapped as QTensors, factored ones as FactoredTensors over the
        pinned basis."""
        slots, pinned = self.cache.slots, self.cache.pinned

        def leaf(key, qmeta):
            if qmeta is None:
                return slots[key]
            bits, dtype, rows = qmeta
            return QTensor(slots[key + ".q"], slots[key + ".scale"],
                           bits=bits, dtype=dtype, rows=rows)

        out = {}
        for n in self._names:
            if n in self._fmeta:
                fm = self._fmeta[n]
                out[n] = FactoredTensor(pinned[n + ".basis"],
                                        leaf(n + ".u", fm["u"]),
                                        leaf(n + ".v", fm["v"]),
                                        kind=fm["kind"], dtype=fm["dtype"])
            else:
                out[n] = leaf(n, self._qmeta[n])
        return out

    # ------------------------------------------------------------- forward

    def __call__(self, x: torch.Tensor, task_id: int = 0):
        cfg = self.cfg
        d = x.shape[-1]
        task_id = int(task_id)
        from repro_torch.dist import spmd

        split = spmd.current_split()
        # this rank's rows of a data-split batch: the whole batch's
        # routing groups, as apply_moe routes them
        rt = moe_lib.route_groups(self.router, cfg, x, task_id) \
            if split is None else \
            moe_lib.route_split(self.router, cfg, x, task_id, *split)
        r = rt.routing
        n, g = rt.groups.shape[:2]

        # the one host read of the layer: which experts this batch needs
        counts_np = rt.stat.sum(dim=0).cpu().numpy()
        self.usage.update(counts_np, task_id)
        sharded = self.mesh is not None
        if sharded:
            # where this forward's tokens go, under the current plan
            self.cache.record_load(counts_np)
        needed = [int(i) for i in np.nonzero(counts_np)[0]]
        # wave order: already-resident experts first, so warm residency
        # (prefetch or the previous batch) turns into demand hits
        res = set(self.cache.resident)
        needed.sort(key=lambda i: (i not in res, i))

        rows = torch.zeros((n, g * cfg.top_k, d), dtype=rt.groups.dtype,
                           device=x.device)
        # sharded: the shard that computes each slot's row, -1 for none
        owner = torch.full((n, g * cfg.top_k), -1, dtype=torch.long,
                           device=x.device) if sharded else None
        waves = self._plan_waves(needed)
        eng = self.engine
        timeline: list[dict] = []
        for k, wave_ids in enumerate(waves):
            stall0 = eng.stats.stall_s if eng is not None else 0.0
            # fence point: everything this wave dereferences must have
            # landed — in-flight lookahead copies commit here, anything
            # mispredicted demand-pages
            self.cache.ensure(wave_ids)
            table, rep_counts = self.cache.replica_table()
            if not (rep_counts[wave_ids] >= 1).all():
                raise RuntimeError(f"wave ids {wave_ids} not all resident: "
                                   f"{rep_counts[wave_ids]}")
            if sharded:
                rows, owner = self._wave_ep(rt, table, rep_counts,
                                            wave_ids, rows, owner)
            else:
                rows = self._wave(rt, table[:, 0], wave_ids, rows)
            prefetched: list[int] = []
            if eng is not None:
                if k + 1 < len(waves):
                    # router lookahead inside the batch: the wave above is
                    # queued on the card, so wave k+1's copies ride behind
                    # its compute; their slots are written only at the
                    # next fence, on the compute stream, after this wave
                    prefetched = self.cache.prefetch_async(waves[k + 1])
                eng.on_wave()
            timeline.append({
                "wave": k, "experts": len(wave_ids),
                "lookahead_submitted": len(prefetched),
                "stall_s": (eng.stats.stall_s - stall0) if eng is not None
                else 0.0,
            })
        self.last_timeline = timeline
        if sharded:
            self._maybe_rebalance()
            rows = self._gather_rows(rows, owner)
        y = R.combine_rows(rows, r).to(x.dtype)
        aux = rt.aux if rt.aux is not None else R.load_balance_loss(
            r.probs, r.expert, cfg.num_experts, mask=rt.real)
        y = y.reshape(-1, d)[:rt.t_total].reshape(x.shape)
        if cfg.num_shared_experts:
            y = moe_lib.add_shared_experts(self.shared, x, y)
        return y, aux.mean()

    def _wave(self, rt: moe_lib.RoutedGroups, remap: np.ndarray,
              wave_ids: list[int], rows: torch.Tensor) -> torch.Tensor:
        """One wave: the slots' queues of every routing group dispatched
        at once into (G, R, C, d), the staged expert FFN on the slot
        store, and each in-wave slot's output row written into ``rows``
        (G, T·k, d)."""
        r = rt.routing
        dev = rows.device
        n_slots = self.cache.max_resident
        # expert -> slot for this wave's experts, -1 for every other one:
        # a slot index is taken only where the wave mask holds, so an
        # expert outside the wave never aliases slot 0's.  Staged in
        # page-locked memory: a pageable copy would wait for the stream
        lut = np.full(self.cfg.num_experts, -1, np.int64)
        lut[wave_ids] = remap[wave_ids]
        staged = torch.empty(lut.shape, dtype=torch.int64,
                             pin_memory=dev.type == "cuda")
        staged.numpy()[:] = lut
        slot = staged.to(dev, non_blocking=True)[r.expert.long()]
        in_wave = slot >= 0
        r_w = R.Routing(expert=torch.where(in_wave, slot, 0).to(torch.int32),
                        gate=r.gate, position=r.position,
                        valid=r.valid & in_wave, probs=r.probs)
        buf = R.dispatch(rt.groups, r_w, n_slots, rt.capacity)
        sizes = R.dispatch_counts(r_w, n_slots)
        out = moe_lib._expert_ffn(self._slot_params(), self.cfg, buf, sizes)
        n = rows.shape[0]
        gi = torch.arange(n, device=dev)[:, None]
        got = out[gi, r_w.expert.reshape(n, -1).long(),
                  r_w.position.reshape(n, -1).long().clamp_max(
                      rt.capacity - 1)]
        return torch.where(r_w.valid.reshape(n, -1)[..., None], got, rows)

    def _wave_ep(self, rt: moe_lib.RoutedGroups, table: np.ndarray,
                 rep_counts: np.ndarray, wave_ids: list[int],
                 rows: torch.Tensor, owner: torch.Tensor):
        """One expert-parallel wave on this rank: every in-wave slot goes
        to one resident replica (``position % replicas``, each replica a
        dense position stream), this rank dispatches the slots that landed
        in its own bank into (G, R, C, d), runs the staged expert FFN on
        its bank, and writes those rows; ``owner`` records, for every
        in-wave slot, the shard that computes it."""
        r = rt.routing
        dev = rows.device
        rs = self.cache.max_resident
        me = self.cache.shard
        mask = np.zeros(self.cfg.num_experts, bool)
        mask[wave_ids] = True
        staged = torch.from_numpy(np.concatenate(
            [table.astype(np.int64).reshape(-1), rep_counts.astype(np.int64),
             mask.astype(np.int64)]))
        if dev.type == "cuda":
            staged = staged.pin_memory()
        staged = staged.to(dev, non_blocking=True)
        e_num, width = table.shape
        tab = staged[:e_num * width].reshape(e_num, width)
        reps_all = staged[e_num * width:e_num * (width + 1)]
        in_mask = staged[e_num * (width + 1):].bool()
        expert = r.expert.long()
        in_wave = in_mask[expert] & r.valid
        reps = reps_all[expert].clamp_min(1)
        ridx = torch.remainder(r.position.long(), reps)
        # dereference the table only where the wave mask holds: a -1
        # column must never alias slot 0's expert
        gslot = torch.where(in_wave, tab[expert, ridx], 0)
        shard = torch.div(gslot, rs, rounding_mode="floor")
        mine = in_wave & (shard == me)
        r_w = R.Routing(expert=torch.where(mine, gslot - me * rs,
                                           0).to(torch.int32),
                        gate=r.gate, position=torch.div(
                            r.position.long(), reps,
                            rounding_mode="floor").to(r.position.dtype),
                        valid=mine, probs=r.probs)
        buf = R.dispatch(rt.groups, r_w, rs, rt.capacity)
        sizes = R.dispatch_counts(r_w, rs)
        out = moe_lib._expert_ffn(self._slot_params(), self.cfg, buf, sizes)
        n = rows.shape[0]
        gi = torch.arange(n, device=dev)[:, None]
        got = out[gi, r_w.expert.reshape(n, -1).long(),
                  r_w.position.reshape(n, -1).long().clamp_max(
                      rt.capacity - 1)]
        rows = torch.where(mine.reshape(n, -1)[..., None], got, rows)
        owner = torch.where(in_wave.reshape(n, -1), shard.reshape(n, -1),
                            owner)
        return rows, owner

    def _gather_rows(self, rows: torch.Tensor,
                     owner: torch.Tensor) -> torch.Tensor:
        """Every slot's row from the shard that computed it: one
        all-gather of the ranks' row buffers over ``ep_axis``, then a
        select by ``owner`` (a slot no wave touched keeps rank 0's zero
        row)."""
        from repro_torch.dist.spmd import all_gather

        every = all_gather(rows[None], self.mesh, self.ep_axis,
                           "paged moe rows")
        idx = owner.clamp_min(0)[None, ..., None].expand(
            (1,) + tuple(rows.shape))
        return every.gather(0, idx)[0]

    def _plan_waves(self, needed: list[int]) -> list[list[int]]:
        """Chunk the needed experts into residency-bounded waves.  One
        device: consecutive chunks of ``max_resident``.  Expert-parallel:
        first-fit against every shard's bank — an expert joins the
        earliest wave in which ALL of its plan shards still have a free
        slot, so the wave count is the largest per-shard slot pressure."""
        rs = self.cache.max_resident
        if self.mesh is None:
            return [needed[i:i + rs] for i in range(0, len(needed), rs)]
        plan = self.cache.plan
        waves: list[list[int]] = []
        loads: list[np.ndarray] = []
        for e in needed:   # first-fit keeps the resident-first order
            shards = plan.shards_of(e)
            w = 0
            while True:
                if w == len(waves):
                    waves.append([])
                    loads.append(np.zeros(self.cache.num_shards, np.int64))
                if all(loads[w][s] < rs for s in shards):
                    waves[w].append(e)
                    for s in shards:
                        loads[w][s] += 1
                    break
                w += 1
        return waves

    def _maybe_rebalance(self) -> None:
        """Consult the placement policy between forwards (its cadence):
        an accepted proposal swaps the plan via ``set_plan``."""
        every = getattr(self.policy, "rebalance_every", 0)
        self._forwards += 1
        if not every or self._forwards % every:
            return
        new = self.policy.update(self.cache.plan, self.usage,
                                 self.cache.shard_load,
                                 slots_per_shard=self.cache.max_resident)
        if new is not None:
            self.cache.set_plan(new)

    def predict(self, task_id: Optional[int] = None) -> list[int]:
        """Router-lookahead prediction: the next batch's expert working
        set, hottest first, from the per-task usage EMA (the placement
        policy's ranking); expert-parallel, as many as every bank
        holds."""
        budget = self.cache.total_slots if self.mesh is not None \
            else self.cache.max_resident
        return self.policy.prefetch_ranking(self.usage, budget, task_id)

    def prefetch(self, task_id: Optional[int] = None) -> None:
        """Warm the device slots with the usage-EMA-hot experts for a task
        — called ahead of a task switch.  With a transfer engine the
        warm-up only SUBMITS the copies; the first wave that needs them
        fences."""
        hot = self.predict(task_id)
        if self.engine is not None:
            self.cache.prefetch_async(hot)
        else:
            self.cache.prefetch(hot)
