"""Expert-weight paging on one device: bounded device residency for MoE
expert weights, the port of ``repro.serve.expert_cache`` (``ExpertUsage``,
``ExpertCache``, ``PagedMoE``).

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

Left for later slices (each raises ``NotImplementedError`` naming its
``ROADMAP.md`` item): expert parallelism over a mesh (the reference's
``ShardedExpertCache``, queue 1 item 6) and packed expert leaves
(QTensor / FactoredTensor, queue 1 item 3).  The reference's XLA-only
store machinery (donated jitted writes, power-of-two write batches, the
sharded cache's write callback) has no counterpart: PyTorch writes a slot
in place.
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
from repro_torch.serve.placement import PlacementPolicy, get_policy
from repro_torch.serve.transfer import Transfer

__all__ = ["ExpertUsage", "ExpertCache", "PagedMoE"]

# how many truncation-dropped prefetch ids each cache retains as evidence
# (bounded so a long-running server cannot grow the list without limit)
PREFETCH_DROPPED_KEEP = 64

_MESH = ("expert-parallel paging over a mesh (the sharded expert cache) "
         "comes with ROADMAP.md queue 1 item 6")
_PACKED = ("packed expert leaves (QTensor / FactoredTensor) come with "
           "ROADMAP.md queue 1 item 3")


def _host_tensor(w) -> torch.Tensor:
    """A weight (tensor on any device, or NumPy) as a contiguous CPU
    tensor."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu").contiguous()
    return tensor_from_numpy(w)


def _per_expert_bytes(host: dict) -> int:
    """Device bytes one expert occupies across the paged weight leaves —
    the unit of paging accounting and byte-budget residency sizing."""
    return sum(int(w[0].nbytes) for w in host.values())


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
    """

    def __init__(self, host: dict, max_resident: int,
                 usage: Optional[ExpertUsage] = None,
                 transfer_engine=None, label: str = "cache",
                 pinned: Optional[dict] = None,
                 policy: Optional[PlacementPolicy] = None,
                 device="cuda"):
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
        self.pinned = {n: _host_tensor(v).to(self.device)
                       for n, v in pinned.items()}
        self.pinned_bytes = sum(int(v.nbytes) for v in self.pinned.values())
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
        self.host = {n: w.pin_memory() if self.device.type == "cuda" else w
                     for n, w in store.items()}
        self.usage = usage
        self.slots = {
            n: torch.zeros((self.max_resident,) + tuple(w.shape[1:]),
                           dtype=w.dtype, device=self.device)
            for n, w in self.host.items()
        }
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
        new = self._host_rows(expert)
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
    leaves may lie anywhere (they are copied to the pinned host store),
    the rest is moved to ``device``.
    """

    def __init__(self, params, cfg: MoEConfig,
                 resident_fraction: float = 0.5,
                 usage: Optional[ExpertUsage] = None,
                 usage_decay: float = 0.9,
                 budget_bytes: Optional[int] = None, mesh=None,
                 transfer_engine=None, placement=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(_MESH)
        if cfg.impl != "grouped":
            raise NotImplementedError(
                f"MoE impl {cfg.impl!r}: the port pages the 'grouped' path")
        names = expert_param_names(cfg)
        if any(not isinstance(params[n], torch.Tensor) for n in names):
            raise NotImplementedError(_PACKED)
        self.cfg = cfg
        self.device = resolve_device(device)
        host = {n: _host_tensor(params[n]) for n in names}
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
        # at least top_k slots, so one wave can serve a token's whole
        # expert set
        max_resident = self.policy.slots(
            per_expert_bytes=_per_expert_bytes(host), pinned_bytes=0,
            experts_per_shard=cfg.num_experts,
            resident_fraction=resident_fraction, floor=cfg.top_k)
        self.usage = usage or ExpertUsage(cfg.num_experts, cfg.num_tasks,
                                          decay=usage_decay)
        self.engine = transfer_engine
        self.cache = ExpertCache(host, max_resident, usage=self.usage,
                                 transfer_engine=transfer_engine,
                                 policy=self.policy, device=self.device)
        # per-wave record of the most recent forward (wave id, expert
        # count, lookahead submissions, fence stall)
        self.last_timeline: list[dict] = []
        self.router = {k: params[k].to(self.device)
                       for k in ("gate", "gate_bias") if k in params}
        self.shared = {k: params[k].to(self.device) for k in
                       ("shared_wg", "shared_wu", "shared_wd") if k in params}

    # ------------------------------------------------------------- forward

    def __call__(self, x: torch.Tensor, task_id: int = 0):
        cfg = self.cfg
        d = x.shape[-1]
        task_id = int(task_id)
        rt = moe_lib.route_groups(self.router, cfg, x, task_id)
        r = rt.routing
        n, g = rt.groups.shape[:2]

        # the one host read of the layer: which experts this batch needs
        counts_np = rt.stat.sum(dim=0).cpu().numpy()
        self.usage.update(counts_np, task_id)
        needed = [int(i) for i in np.nonzero(counts_np)[0]]
        # wave order: already-resident experts first, so warm residency
        # (prefetch or the previous batch) turns into demand hits
        res = set(self.cache.resident)
        needed.sort(key=lambda i: (i not in res, i))

        rows = torch.zeros((n, g * cfg.top_k, d), dtype=rt.groups.dtype,
                           device=x.device)
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
        y = R.combine_rows(rows, r).to(x.dtype)
        aux = R.load_balance_loss(r.probs, r.expert, cfg.num_experts,
                                  mask=rt.real)
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
        out = moe_lib._expert_ffn(self.cache.slots, self.cfg, buf, sizes)
        n = rows.shape[0]
        gi = torch.arange(n, device=dev)[:, None]
        got = out[gi, r_w.expert.reshape(n, -1).long(),
                  r_w.position.reshape(n, -1).long().clamp_max(
                      rt.capacity - 1)]
        return torch.where(r_w.valid.reshape(n, -1)[..., None], got, rows)

    def _plan_waves(self, needed: list[int]) -> list[list[int]]:
        """Chunk the needed experts into consecutive waves of at most
        ``max_resident``."""
        rs = self.cache.max_resident
        return [needed[i:i + rs] for i in range(0, len(needed), rs)]

    def predict(self, task_id: Optional[int] = None) -> list[int]:
        """Router-lookahead prediction: the next batch's expert working
        set, hottest first, from the per-task usage EMA (the placement
        policy's ranking)."""
        return self.policy.prefetch_ranking(self.usage,
                                            self.cache.max_resident, task_id)

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
