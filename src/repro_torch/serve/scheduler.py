"""Task-aware serving scheduler: continuous batching over task buckets, the
port of ``repro.serve.scheduler``.

The multi-request generalization of the paper's zero-cost task switch
(§IV-F).  Requests carry a ``task_id``, an arrival time, and a prompt; the
scheduler keeps decode slots in buckets (one mixed-task bucket for LMs,
whose decode step gates each slot by its own task; one bucket per task for
the vision model), admits queued requests into freed slots mid-flight, and
rotates admission (and, per task, quanta) round-robin across tasks so one
hot task cannot starve the rest.

Continuous batching mechanics:

  * each bucket owns a batched decode state (the KV caches and recurrent
    states) of ``slots``
    sequences plus a per-slot ``cache_pos`` vector — the vector
    ``cache_index`` decode path of ``models/transformer.py``, which runs
    ``decode_fused`` with each slot's own cache length under
    ``attention_decode="cuda_fused"``;
  * admission prefills the new request alone (batch 1, the prompt padded up
    to a multiple of ``prompt_pad`` so its rows are masked past the real
    prompt; unpadded for recurrent archs, whose state padding would
    pollute) and splices the resulting state into the freed slot, leaf by
    leaf along each leaf's batch axis (``_StateSlots``);
  * a request finishes on its own EOS/max-tokens; its slot is immediately
    reusable — no waiting for the rest of the batch;
  * MoE archs: every decode step exports the per-expert dispatch counts
    into a per-task ``ExpertUsage``.

The port writes state in place where the reference's functions return new
arrays.  So an admission from the prefix cache clones the cached entry
before continuing its prefill (the entry must survive being read), a
parked slot is cloned out of the bucket (which keeps decoding its other
slots), and restores and splices copy into the bucket's tensors.  Per
decode step the host sends the slots' tokens, positions and tasks in one
copy from a page-locked buffer and reads the new tokens (and the MoE
counts) back in one copy into another: one host sync a step, as in the
reference.

SLO-aware serving (``Scheduler(..., slo=SLOPolicy(...))``, the
``repro_torch.serve.slo`` subsystem): interactive requests admit first,
due interactive requests preempt batch-tier slots (park/restore, bit
exact), a radix prefix cache (``ServeConfig.prefix_cache`` > 0) seeds
admissions from cached shared-prompt prefill state, and long prompts admit
in ``prefill_chunk``-token chunks interleaved with decode steps.  Recurrent
archs get neither a prefix cache nor chunked admission, as in the
reference: their state is a running reduction with no truncation
property.

``Scheduler`` is backend-generic: ``LMBackend`` serves autoregressive
decode; ``serve/vision.py`` provides the batched M³ViT backend (vision
"preemption" is a staged-batch bump — inference is stateless).  An int8
KV cache (``ServeConfig.kv_quant="int8"``) is served like a floating one:
its scale leaves are spliced, parked and cloned with the rows.  A stub
frontend's prompt (``embed_input="embeddings"``) is (S0, d) embeddings,
padded with zero rows under the same causal and ``cache_len`` masking; the
decode step feeds each slot's token back as its row of the engine's
pseudo-embedding table (one device copy for the backend's lifetime); the
prefix cache serves token prompts only, as in the reference.

Mesh serving (``LMBackend(rules=...)``, one process a rank, each running
the same scheduler on the same requests): the weights are held as the
static engine holds them (``serve.engine.place_params``; under FSDP rules
every forward — admissions, chunks, decode steps — gathers each layer's
leaves just before it runs, ``serve.engine.fsdp_gathers``), and a bucket's
decode lanes are batch-sharded over the data axes — each rank holds and
decodes its own lanes, and one all-gather a step brings every lane's token
back (the MoE layers count the whole bucket's dispatches, ``core/moe.py``),
so every rank's host loop takes the same decisions.  A batch-1 admission
is replicated, as the rule table replicates a batch of one; only the
lane's own rank splices it.  Preemption parks a lane on the rank that
holds it (every rank keeps the record's books and the lane's shapes) and
restores it on the rank of the free lane, the rows moved between ranks
by one all-gather over the data axes where those differ
(``LMTaskBucket.restore``).  Under tensor parallelism each rank's lane
holds its own KV heads, RG-LRU channels and xLSTM heads, so each parks
and restores its own block.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import spmd
from repro_torch.dist.sharding import use_rules
from repro_torch.models import model as M
from repro_torch.serve.engine import (ServeConfig, ServingEngine,
                                      feedback_inputs,
                                      fsdp_gathers, is_recurrent,
                                      place_params, serve_overrides,
                                      state_batch_axes,
                                      stub_feedback_table)
from repro_torch.serve.expert_cache import ExpertUsage
from repro_torch.serve.slo.preempt import ParkedState, SlotParker
from repro_torch.serve.slo.prefix import RadixPrefixCache
from repro_torch.serve.slo.tiers import (SLOPolicy, goodput, is_preemptible,
                                         meets_slo, request_tpot)
from repro_torch.tree import flatten

__all__ = ["Request", "Scheduler", "LMBackend"]


@dataclass
class Request:
    rid: int
    task_id: int
    prompt: Any     # (S0,) int tokens | (S0, d) embeddings | (H, W, 3) image
    max_new_tokens: int = 0         # LM: tokens to generate (>=1)
    arrival: float = 0.0
    eos_id: Optional[int] = None    # None => backend default
    # SLO tier (see serve.slo.tiers): deadlines are None until the
    # trace/tier tags them; ``tier`` names the service class
    tier: str = "interactive"
    tenant: int = 0
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None
    # filled in by the scheduler
    tokens: list = field(default_factory=list)
    result: Any = None              # vision: prediction array
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    preemptions: int = 0            # times this request's slot was parked
    prefix_hit_tokens: int = 0      # prefill tokens skipped via prefix cache

    @property
    def ttft(self) -> float:
        """Arrival -> first token; nan until the first token exists."""
        if self.t_first is None:
            return float("nan")
        return self.t_first - self.arrival

    @property
    def latency(self) -> float:
        if self.t_done is None:
            return float("nan")
        return self.t_done - self.arrival

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first (nan unfinished)."""
        return request_tpot(self)


def _pad_len(s0: int, bucket: int) -> int:
    return s0 if bucket <= 0 else -(-s0 // bucket) * bucket


def _state_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in flatten(state).values())


def _clone(state):
    """A state tree of tensors of its own (prefill writes in place)."""
    if isinstance(state, dict):
        return {k: _clone(v) for k, v in state.items()}
    return state.clone()


class _StateSlots:
    """The per-leaf batch axis of a batched decode state
    (``serve.engine.state_batch_axes``), for splicing a batch-1 state into
    slot ``i`` of the bucket's state, in place."""

    def __init__(self, cfg: ArchConfig, max_len: int):
        self._axes = state_batch_axes(cfg, max_len)

    def splice(self, big, small, slot: Optional[int]):
        """``slot`` is the lane's index in this rank's rows of ``big``;
        None: another rank's lane, nothing to write here."""
        if slot is None:
            return big
        for b, s, ax in zip(flatten(big).values(), flatten(small).values(),
                            self._axes):
            b.narrow(ax, slot, 1).copy_(s)
        return big


@dataclass
class _PrefillJob:
    """An in-flight chunked admission: a reserved slot plus a batch-1
    staging state advanced one ``prefill_chunk`` per decode step."""

    req: Request
    slot: int
    small: Any          # batch-1 staging state (owned: written in place)
    prompt: np.ndarray  # (1, S0) tokens | (1, S0, d) embeddings
    off: int            # next prefill position (prefix-matched tokens skip)
    s0: int


def _pad_rows(prompt: np.ndarray, n: int) -> np.ndarray:
    """``prompt`` (1, S[, d]) with ``n`` zero rows appended."""
    if n <= 0:
        return prompt
    return np.concatenate([prompt, np.zeros((1, n) + prompt.shape[2:],
                                            prompt.dtype)], 1)


class LMBackend:
    """Autoregressive decode backend with *mixed-task* batches: one decode
    step serves slots gated by different tasks (per-token gating — the
    per-slot generalization of the paper's zero-cost task switch), with
    vector cache positions and MoE router-usage export.  ``params`` is the
    flat dotted-name dict, moved to ``device`` (default: the card); a stub
    frontend feeds back rows of ``stub_table`` (as ``ServingEngine``'s).
    """

    bucketing = "mixed"   # one full-width bucket; fairness at admission

    def __init__(self, cfg: ArchConfig, params, scfg: ServeConfig,
                 rules=None, prompt_pad: int = 16, *, device="cuda",
                 stub_table=None):
        if scfg.temperature > 0.0:
            raise ValueError("the scheduler decodes greedily (argmax in "
                             "the decode step)")
        self.cfg = cfg = serve_overrides(cfg, scfg)
        self.scfg = scfg
        self.rules = rules
        self.device = resolve_device(device)
        self.params = place_params(
            {k: v.to(self.device) for k, v in params.items()}, cfg, rules)
        self.gathers = fsdp_gathers(self.params, cfg, rules)
        self.recurrent = is_recurrent(cfg)
        # padded prefill relies on causal / cache_len masking — attention
        # archs only
        self.prompt_pad = 0 if self.recurrent else prompt_pad
        self.num_tasks = max(cfg.num_tasks,
                             cfg.moe.num_tasks if cfg.moe else 1)
        self.usage = (ExpertUsage(cfg.moe.num_experts, self.num_tasks)
                      if cfg.moe else None)
        self._slots_io = _StateSlots(cfg, scfg.max_len)
        self._parkers: dict[str, SlotParker] = {}
        # shared prompt-prefix reuse needs the attention truncation
        # property (stale rows masked by causal/cache_len); recurrent
        # state is a running reduction, so no cache for those archs
        self.prefix: Optional[RadixPrefixCache] = None
        if scfg.prefix_cache > 0 and not self.recurrent:
            self.prefix = RadixPrefixCache(
                scfg.prefix_cache, min_match=max(1, scfg.prefix_min))
        # a stub frontend's feedback table, on the device once
        self.fb_table = stub_feedback_table(cfg, self.device, stub_table)

    # the engine's: a zeroed state at this rank's KV heads and channels
    new_state = ServingEngine.new_state

    def lanes(self, slots: int) -> slice:
        """This rank's lanes of a bucket of ``slots`` (all of them without
        rules, or where the batch axes do not divide ``slots``)."""
        return spmd.batch_rows(slots, self.rules) if self.rules is not None \
            else slice(0, slots)

    # ----------------------------------------------------------- steps

    def admit_step(self, task_id: int):
        """``admit(params, inputs, big, slot, last_idx) -> (tok, big)``:
        batch-1 prefill into a fresh state, the greedy first token at the
        last REAL prompt position (a 0-d tensor on the device), and the
        splice into slot ``slot`` of ``big`` (in place)."""
        cfg = self.cfg

        def admit(params, inputs, big, slot, last_idx):
            small = self.new_state(1)
            with use_rules(self.rules):
                logits, small, _ = M.forward(
                    params, inputs, cfg, state=small, cache_index=0,
                    task_id=task_id, return_state=True,
                    logits_mode=last_idx, gather=self.gathers)
            tok = torch.argmax(logits[0, 0], dim=-1)
            return tok, self._slots_io.splice(big, small, slot)

        return admit

    def staged_steps(self, task_id: int):
        """``mid(params, toks, small, idx) -> small``: one chunk;
        ``finish(params, toks, small, idx, last_rel, big, slot)
        -> (first_tok, small, big)``: the final chunk and the splice.

        Both run against an explicit batch-1 staging state, written in
        place, which is what lets an admission start from a prefix-cache
        entry (the caller passes a clone of it) and advance one chunk at a
        time between decode steps; ``small`` comes back so the finished
        prompt can be inserted into the cache."""
        cfg = self.cfg

        def mid(params, toks, small, idx):
            with use_rules(self.rules):
                M.forward(params, toks, cfg, state=small, cache_index=idx,
                          task_id=task_id, return_state=True,
                          logits_mode="last", gather=self.gathers)
            return small

        def finish(params, toks, small, idx, last_rel, big, slot):
            with use_rules(self.rules):
                logits, small, _ = M.forward(
                    params, toks, cfg, state=small, cache_index=idx,
                    task_id=task_id, return_state=True,
                    logits_mode=last_rel, gather=self.gathers)
            tok = torch.argmax(logits[0, 0], dim=-1)
            return tok, small, self._slots_io.splice(big, small, slot)

        return mid, finish

    def decode_step(self):
        """``decode(params, toks, state, cache_pos, task_ids) -> (tok,
        state, counts)``: one step of every slot, each at its own position
        and gated by its own task ((B,) tensors on the device); the greedy
        tokens and (MoE) the per-task dispatch counts stay on the device."""
        cfg = self.cfg
        want_counts = cfg.moe is not None

        def decode(params, toks, state, cache_pos, task_ids):
            # this rank's lanes decode; every lane's token comes back, so
            # the host loop sees the whole bucket on a mesh
            n, rows = toks.shape[0], self.lanes(toks.shape[0])
            with use_rules(self.rules), spmd.batch_split(self.rules, n):
                out = M.forward(params, feedback_inputs(
                    cfg, toks[rows], self.fb_table), cfg, state=state,
                    cache_index=cache_pos[rows], decode=True,
                    task_id=task_ids[rows], return_state=True,
                    return_expert_counts=want_counts, gather=self.gathers)
            logits, state = out[0], out[1]
            counts = out[3] if want_counts else None
            tok = torch.argmax(logits[:, -1], dim=-1)
            if self.rules is not None:
                # the MoE layers' counts are already the whole bucket's
                tok = spmd.gather_batch(tok, self.rules, n,
                                        "scheduler tokens")
            return tok, state, counts

        return decode

    def parker(self, compress: str = "none") -> SlotParker:
        """Park/restore machinery for this backend's state layout (one per
        compression mode, shared by every bucket)."""
        if compress not in self._parkers:
            self._parkers[compress] = SlotParker(self._slots_io._axes,
                                                 compress)
        return self._parkers[compress]

    def make_bucket(self, task_id: Optional[int],
                    slots: int) -> "LMTaskBucket":
        return LMTaskBucket(self, task_id, slots)


class LMTaskBucket:
    """``slots`` decode lanes.  With ``task_id=None`` (the LM backend's
    mixed mode) every slot carries its own task id into the decode step;
    with a fixed task id all lanes share one gating network.

    ``last_tok``, ``cache_pos`` and ``task_slots`` are NumPy views of one
    page-locked host buffer, sent to the card in one copy per decode
    step; ``host_syncs`` counts the reads of the card's results: one a
    decode step (``steps``), one an admission (``admissions``)."""

    def __init__(self, backend: LMBackend, task_id: Optional[int],
                 slots: int):
        self.backend = backend
        self.task_id = task_id
        self.slots = slots
        dev = backend.device
        # this rank's lanes of the bucket (all of them without a mesh)
        self._lanes = backend.lanes(slots)
        self.state = backend.new_state(self._lanes.stop - self._lanes.start)
        pin = dev.type == "cuda"
        self._host_in = torch.zeros((3, slots), dtype=torch.int64,
                                    pin_memory=pin)
        self._dev_in = torch.zeros((3, slots), dtype=torch.int64, device=dev)
        moe = backend.cfg.moe
        self._counts_n = backend.num_tasks * moe.num_experts if moe else 0
        self._host_out = torch.zeros((slots + self._counts_n,),
                                     dtype=torch.int64, pin_memory=pin)
        self.last_tok = self._host_in[0].numpy()
        self.cache_pos = self._host_in[1].numpy()
        self.task_slots = self._host_in[2].numpy()
        self.reqs: list[Optional[Request]] = [None] * slots
        self.jobs: list[_PrefillJob] = []   # in-flight chunked admissions
        self.reserved: set[int] = set()     # slots held by jobs
        self.steps = 0               # decode steps executed
        self.slot_steps = 0          # decode slot-steps with a live request
        self.prefill_chunks = 0      # interleaved chunk steps executed
        self.host_syncs = 0          # reads of the card's results
        self.admissions = 0          # prompts prefilled into a slot

    @property
    def active(self) -> int:
        return sum(r is not None for r in self.reqs)

    def _local(self, slot: int) -> Optional[int]:
        """``slot``'s index among this rank's lanes; None for another
        rank's."""
        lo, hi = self._lanes.start, self._lanes.stop
        return slot - lo if lo <= slot < hi else None

    def _shard(self, slot: int) -> int:
        """The index of the rank (over the data axes) holding ``slot``."""
        return slot // (self._lanes.stop - self._lanes.start)

    @property
    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.reqs)
                if r is None and i not in self.reserved]

    def _eos(self, req: Request) -> int:
        return self.backend.scfg.eos_id if req.eos_id is None else req.eos_id

    def _emit(self, req: Request, tok: int, now: float):
        """Record one generated token; returns True when the request is
        done (its own EOS or token budget — the slot frees immediately)."""
        req.tokens.append(tok)
        if req.t_first is None:
            req.t_first = now
        eos = self._eos(req)
        return (eos >= 0 and tok == eos) \
            or len(req.tokens) >= req.max_new_tokens

    def _read(self, *tensors) -> np.ndarray:
        """The tensors' values on the host, in one copy through the
        page-locked buffer and one sync."""
        flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors]) \
            if len(tensors) > 1 else tensors[0].reshape(-1).to(torch.int64)
        n = flat.numel()
        out = self._host_out[:n]
        out.copy_(flat, non_blocking=True)
        if flat.device.type == "cuda":
            torch.cuda.current_stream(flat.device).synchronize()
        self.host_syncs += 1
        return out.numpy().copy()

    def _tensor(self, prompt: np.ndarray):
        """Prompt tokens (int64) or embeddings (float32) on the device,
        through page-locked memory (a pageable copy would synchronize the
        stream)."""
        t = torch.from_numpy(np.ascontiguousarray(
            prompt, np.int64 if prompt.ndim == 2 else np.float32))
        if self.backend.device.type != "cuda":
            return t
        return t.pin_memory().to(self.backend.device, non_blocking=True)

    # ------------------------------------------------------- admission

    def _activate(self, req: Request, slot: int, tok: int, s0: int,
                  now: float) -> list[Request]:
        """Common admission tail: wire the slot and emit the first token."""
        self.admissions += 1
        self.cache_pos[slot] = s0
        self.last_tok[slot] = tok
        self.task_slots[slot] = req.task_id
        self.reqs[slot] = req
        if self._emit(req, tok, now):
            req.t_done = now
            self.reqs[slot] = None
            self.cache_pos[slot] = 0
            self.last_tok[slot] = 0
            return [req]
        return []

    def admit(self, req: Request, now: float,
              chunk_interleave: bool = False) -> list[Request]:
        """Prefill ``req`` and splice it into a free slot.

        Three admission paths, cheapest applicable wins:
          * one-shot (no prefix cache): batch-1 prefill into a fresh
            state, spliced into the slot;
          * staged one-shot: an explicit staging state — a clone of the
            radix prefix cache's entry when the prompt shares a cached
            prefix (only the suffix is prefilled, at ``cache_index = L``)
            — inserted into the cache afterwards;
          * chunked job (``chunk_interleave``): the slot is reserved and
            the prompt advances one ``prefill_chunk`` per decode step
            (``advance_prefill``).
        """
        b = self.backend
        slot = self.free_slots[0]
        prompt = np.asarray(req.prompt)[None]        # (1, S0[, d])
        s0 = prompt.shape[1]
        padded = _pad_len(s0, b.prompt_pad)
        if padded > b.scfg.max_len:
            raise ValueError(f"prompt {s0} > max_len {b.scfg.max_len}")
        if s0 + req.max_new_tokens - 1 > b.scfg.max_len:
            # decode step i writes K/V at position s0+i: reject a request
            # that cannot fit BEFORE it occupies a slot, not mid-flight
            raise ValueError(
                f"request {req.rid}: prompt {s0} + {req.max_new_tokens} "
                f"new tokens does not fit max_len {b.scfg.max_len}")

        # shared-prefix lookup (token prompts only)
        entry, matched = None, 0
        if b.prefix is not None and prompt.ndim == 2:
            entry, matched = b.prefix.lookup(prompt[0])
            matched = min(matched, s0 - 1)   # always prefill >= 1 token
            if entry is None or matched < b.prefix.min_match:
                entry, matched = None, 0

        chunk = b.scfg.prefill_chunk
        suffix_len = s0 - matched
        # chunking only pays while there are active decoders to protect
        if (chunk_interleave and self.active > 0 and chunk > 0
                and suffix_len > chunk and not b.recurrent
                and matched + _pad_len(suffix_len, chunk) <= b.scfg.max_len):
            small = _clone(entry) if entry is not None else b.new_state(1)
            self.jobs.append(_PrefillJob(req=req, slot=slot, small=small,
                                         prompt=prompt, off=matched, s0=s0))
            self.reserved.add(slot)
            req.t_admit = now
            req.prefix_hit_tokens = matched
            return []

        req.t_admit = now
        if b.prefix is None or prompt.ndim != 2:
            tok, self.state = b.admit_step(req.task_id)(
                b.params, self._tensor(_pad_rows(prompt, padded - s0)),
                self.state, self._local(slot), s0 - 1)
            return self._activate(req, slot, int(self._read(tok)[0]), s0,
                                  now)
        tok = self._admit_staged(req, slot, entry, matched, prompt)
        return self._activate(req, slot, tok, s0, now)

    def _admit_staged(self, req: Request, slot: int, entry, matched: int,
                      prompt: np.ndarray) -> int:
        """One-shot staged admission: suffix prefill at offset ``matched``
        (0 with a fresh staging state on a prefix miss), splice, and
        insert the finished prompt's state into the prefix cache."""
        b = self.backend
        s0 = prompt.shape[1]
        if matched and matched + _pad_len(s0 - matched, b.prompt_pad) \
                > b.scfg.max_len:
            # the padded suffix would write past the cache: drop the hit
            entry, matched = None, 0
        small = _clone(entry) if entry is not None else b.new_state(1)
        suffix = prompt[:, matched:]
        suffix = _pad_rows(suffix, _pad_len(suffix.shape[1], b.prompt_pad)
                           - suffix.shape[1])
        _, finish = b.staged_steps(req.task_id)
        tok, small, self.state = finish(
            b.params, self._tensor(suffix), small, matched,
            s0 - matched - 1, self.state, self._local(slot))
        req.prefix_hit_tokens = matched
        b.prefix.insert(prompt[0], small, _state_bytes(small))
        return int(self._read(tok)[0])

    def advance_prefill(self, now_fn) -> list[Request]:
        """Advance EVERY chunked admission by one chunk (called once per
        decode step, the interleaving grain).  A job's final chunk samples
        the first token and splices the slot, exactly like a one-shot
        admission — token-identical either way."""
        b = self.backend
        finished: list[Request] = []
        chunk = b.scfg.prefill_chunk
        for job in list(self.jobs):
            mid, finish = b.staged_steps(job.req.task_id)
            remaining = job.s0 - job.off
            self.prefill_chunks += 1
            if remaining > chunk:
                toks = self._tensor(job.prompt[:, job.off:job.off + chunk])
                job.small = mid(b.params, toks, job.small, job.off)
                job.off += chunk
                continue
            # the final chunk padded to the chunk width
            tail = _pad_rows(job.prompt[:, job.off:], chunk - remaining)
            tok, small, self.state = finish(
                b.params, self._tensor(tail), job.small, job.off,
                remaining - 1, self.state, self._local(job.slot))
            if b.prefix is not None and job.prompt.ndim == 2:
                b.prefix.insert(job.prompt[0], small, _state_bytes(small))
            self.jobs.remove(job)
            self.reserved.discard(job.slot)
            finished.extend(self._activate(
                job.req, job.slot, int(self._read(tok)[0]), job.s0,
                now_fn()))
        return finished

    # ------------------------------------------------------ preemption

    def pick_victim(self) -> Optional[int]:
        """The preemption victim: the *youngest* preemptible (batch-tier)
        slot — the least sunk decode work in the current burst."""
        cands = [(r.t_admit or 0.0, i) for i, r in enumerate(self.reqs)
                 if r is not None and is_preemptible(r)]
        return max(cands)[1] if cands else None

    def park(self, slot: int, parker: SlotParker) -> dict:
        """Evict ``slot``: clone its state out bit-exactly and free the
        lane.  Returns the parked record: the rows on the rank holding the
        lane, a shell of them (shapes, bytes) on the others."""
        req = self.reqs[slot]
        local = self._local(slot)
        parked = {"req": req,
                  "state": parker.park(self.state, local)
                  if local is not None else parker.shell(self.state),
                  "shard": self._shard(slot),
                  "cache_pos": int(self.cache_pos[slot]),
                  "last_tok": int(self.last_tok[slot])}
        req.preemptions += 1
        self.reqs[slot] = None
        self.cache_pos[slot] = 0
        self.last_tok[slot] = 0
        return parked

    def restore(self, parked: dict, parker: SlotParker) -> int:
        """Copy a parked record back into a free slot and resume decode
        where it left off (same cache position, same feedback token).  A
        lane parked on another rank than the free slot's comes over in
        one all-gather over the data axes (every rank calls it)."""
        slot = self.free_slots[0]
        held = parked["state"]
        if parked["shard"] != self._shard(slot):
            held = self._moved(held, parked["shard"], parker)
        local = self._local(slot)
        if local is not None:
            self.state = parker.restore(self.state, held, local)
        req = parked["req"]
        self.cache_pos[slot] = parked["cache_pos"]
        self.last_tok[slot] = parked["last_tok"]
        self.task_slots[slot] = req.task_id
        self.reqs[slot] = req
        return slot

    def _moved(self, held, shard: int, parker: SlotParker):
        """The parked rows of the lane rank ``shard`` parked, on every
        rank: each rank's record (rows or zeros of their shape) gathered
        over the data axes as bytes, ``shard``'s kept."""
        rules, dev = self.backend.rules, self.backend.device

        def one(t, ax):
            mine = t if t.device.type != "meta" else torch.zeros(
                t.shape, dtype=t.dtype, device=dev)
            raw = mine.contiguous().view(torch.uint8)
            every = spmd.gather_batch(raw, rules, self.slots,
                                      "parked lane move", dim=ax)
            return every.narrow(ax, shard, 1).view(t.dtype)

        leaves = [tuple(one(t, ax) for t in leaf) if isinstance(leaf, tuple)
                  else one(leaf, ax)
                  for leaf, ax in zip(held.leaves, parker.axes)]
        return ParkedState(leaves=leaves, nbytes=held.nbytes)

    # ---------------------------------------------------------- decode

    def run_quantum(self, n: int, now_fn,
                    admit_cb=None) -> list[Request]:
        """Up to ``n`` decode steps over the whole bucket; returns finished
        requests (their slots are already freed).  ``admit_cb`` runs before
        every step so slots freed mid-quantum refill immediately.
        In-flight chunked admissions advance one chunk per step."""
        b = self.backend
        decode = b.decode_step()
        finished: list[Request] = []
        counts_sum = None
        for _ in range(n):
            if admit_cb is not None:
                admit_cb()
            if self.jobs:
                finished.extend(self.advance_prefill(now_fn))
                # no decodable slot -> no decode latency to protect:
                # drain prefill chunks at full speed until a job
                # activates (admissions stay live via admit_cb)
                while self.active == 0 and self.jobs:
                    if admit_cb is not None:
                        admit_cb()
                    finished.extend(self.advance_prefill(now_fn))
            if self.active == 0:
                break
            self._dev_in.copy_(self._host_in, non_blocking=True)
            tok, self.state, counts = decode(
                b.params, self._dev_in[0], self.state, self._dev_in[1],
                self._dev_in[2])
            self.steps += 1
            self.slot_steps += self.active
            host = self._read(tok) if counts is None \
                else self._read(tok, counts)
            nxt = host[:self.slots]
            if counts is not None:
                c = host[self.slots:].reshape(tuple(counts.shape))
                counts_sum = c if counts_sum is None else counts_sum + c
            now = now_fn()
            for i, req in enumerate(self.reqs):
                if req is None:
                    continue
                self.cache_pos[i] += 1
                self.last_tok[i] = nxt[i]
                if self._emit(req, int(nxt[i]), now):
                    # finished-first: a request whose generation exactly
                    # fills the cache frees its slot instead of tripping
                    # the overrun guard below
                    req.t_done = now
                    self.reqs[i] = None
                    self.cache_pos[i] = 0
                    self.last_tok[i] = 0
                    finished.append(req)
                elif self.cache_pos[i] >= b.scfg.max_len:
                    raise RuntimeError("decode ran past max_len")
        if counts_sum is not None and b.usage is not None:
            if counts_sum.ndim == 2:   # mixed batch: one (E,) row per task
                for t in range(counts_sum.shape[0]):
                    if counts_sum[t].any():
                        b.usage.update(counts_sum[t], t)
            else:
                b.usage.update(counts_sum, self.task_id or 0)
        return finished


def _interactive(req: Request) -> bool:
    return not is_preemptible(req)


class Scheduler:
    """Task-fair continuous batching over a backend's buckets.

    Two bucketing modes (picked by ``backend.bucketing``):

      * ``"mixed"`` (LM decode): ONE bucket spanning ``total_slots`` decode
        lanes; freed slots are offered round-robin across task queues, so a
        hot task cannot monopolize admission while the decode batch itself
        mixes tasks (per-slot gating).
      * ``"per_task"`` (vision): one bucket per task, ``total_slots`` split
        evenly; quanta rotate round-robin across runnable tasks.

    Either way total batch capacity equals a static engine's batch of
    ``total_slots``.  ``clock`` (default ``time.perf_counter``) is read
    for every arrival, admission and token time; ``slo`` (an
    :class:`SLOPolicy`) turns on tiered admission, preemption and
    chunk-interleaved admission.
    """

    def __init__(self, backend, total_slots: int = 8, quantum: int = 4,
                 num_tasks: Optional[int] = None, clock=None,
                 slo: Optional[SLOPolicy] = None):
        self.backend = backend
        self.num_tasks = num_tasks or getattr(backend, "num_tasks", 1)
        self.mixed = getattr(backend, "bucketing", "per_task") == "mixed"
        self.slots_per_bucket = total_slots if self.mixed \
            else max(1, total_slots // self.num_tasks)
        self.quantum = quantum
        self.clock = clock or time.perf_counter
        self.slo = slo
        self.buckets: dict[Any, Any] = {}
        self.queues: dict[int, deque] = {}
        self.rotation: list[int] = []
        self._rr = 0
        self.finished: list[Request] = []
        self._t0: Optional[float] = None
        # SLO machinery
        self.parked: deque = deque()
        self.preemptions = 0
        self.restores = 0
        self.parked_bytes = 0
        self.parked_bytes_peak = 0
        self._parker: Optional[SlotParker] = None

    def now(self) -> float:
        if self._t0 is None:
            self._t0 = self.clock()
        return self.clock() - self._t0

    def submit(self, req: Request) -> None:
        if req.task_id not in self.queues:
            self.queues[req.task_id] = deque()
            self.rotation.append(req.task_id)
        self.queues[req.task_id].append(req)

    def _bucket(self, key):
        if key not in self.buckets:
            self.buckets[key] = self.backend.make_bucket(
                key, self.slots_per_bucket)
        return self.buckets[key]

    def _runnable(self, task_id: int, now: float) -> bool:
        q = self.queues.get(task_id)
        queued = bool(q) and (q[0].arrival <= now if self.slo is None
                              else any(r.arrival <= now for r in q))
        bucket = self.buckets.get(task_id)
        return queued or (bucket is not None and bucket.active > 0)

    def _peek_next_task(self, current: int, now: float) -> Optional[int]:
        """The task the rotation will pick after ``current`` — the cross-
        bucket lookahead target whose hot experts can stream behind the
        quantum that is about to run."""
        for off in range(len(self.rotation)):
            t = self.rotation[(self._rr + off) % len(self.rotation)]
            if t != current and self._runnable(t, now):
                return t
        return None

    def pending(self) -> bool:
        if self.parked:
            return True
        if any(self.queues.get(t) for t in self.rotation):
            return True
        return any(b.active > 0 or getattr(b, "jobs", None)
                   for b in self.buckets.values())

    # ------------------------------------------------------- admission

    def _pop_due(self, task: int, now: float, pred=None):
        """Pop the first due request in ``task``'s queue matching ``pred``
        (SLO mode scans past not-yet-due heads)."""
        q = self.queues.get(task)
        if not q:
            return None
        for i, r in enumerate(q):
            if r.arrival <= now and (pred is None or pred(r)):
                del q[i]
                return r
        return None

    def _due_any(self, now: float, pred) -> bool:
        return any(r.arrival <= now and pred(r)
                   for q in self.queues.values() for r in q)

    def _task_due(self, task: int, now: float, pred) -> bool:
        return any(r.arrival <= now and pred(r)
                   for r in self.queues.get(task, ()))

    def _admit_mixed(self, bucket) -> bool:
        """Offer freed slots round-robin across task queues (one request per
        runnable task per lap) — admission-level fairness for mixed mode."""
        admitted = False
        progress = True
        while bucket.free_slots and progress and self.rotation:
            progress = False
            for off in range(len(self.rotation)):
                if not bucket.free_slots:
                    break
                t = self.rotation[(self._rr + off) % len(self.rotation)]
                q = self.queues.get(t)
                if q and q[0].arrival <= self.now():
                    self.finished.extend(
                        bucket.admit(q.popleft(), self.now()))
                    self._rr = (self._rr + off + 1) % len(self.rotation)
                    admitted = progress = True
                    break
        return admitted

    def _admit_lap(self, bucket, pred, limit: Optional[int] = None) -> bool:
        """Round-robin admission laps restricted to ``pred`` requests —
        the SLO-mode analogue of ``_admit_mixed``."""
        interleave = bool(self.slo and self.slo.chunk_interleave)
        admitted = 0
        progress = True
        while bucket.free_slots and progress and self.rotation:
            progress = False
            for off in range(len(self.rotation)):
                if not bucket.free_slots:
                    break
                t = self.rotation[(self._rr + off) % len(self.rotation)]
                r = self._pop_due(t, self.now(), pred)
                if r is not None:
                    self.finished.extend(bucket.admit(
                        r, self.now(), chunk_interleave=interleave))
                    self._rr = (self._rr + off + 1) % len(self.rotation)
                    admitted += 1
                    progress = True
                    if limit is not None and admitted >= limit:
                        return True
                    break
        return admitted > 0

    def _get_parker(self) -> Optional[SlotParker]:
        if self._parker is None:
            mk = getattr(self.backend, "parker", None)
            if mk is not None:
                self._parker = mk(self.slo.park_compress)
        return self._parker

    def _park_victim(self, bucket) -> bool:
        victim = bucket.pick_victim()
        if victim is None:
            return False
        parked = bucket.park(victim, self._parker)
        self.parked.append(parked)
        self.preemptions += 1
        self.parked_bytes += parked["state"].nbytes
        self.parked_bytes_peak = max(self.parked_bytes_peak,
                                     self.parked_bytes)
        return True

    def _admit_slo(self, bucket) -> bool:
        """Tiered admission: interactive first, then preemption for the
        still-waiting interactive, then FIFO restores of parked requests,
        then batch admission into whatever capacity remains."""
        admitted = self._admit_lap(bucket, _interactive)
        if self.slo.preemption and self._get_parker() is not None:
            while (not bucket.free_slots
                   and len(self.parked) < self.slo.max_parked
                   and self._due_any(self.now(), _interactive)):
                if not self._park_victim(bucket):
                    break
                admitted |= self._admit_lap(bucket, _interactive, limit=1)
        while (bucket.free_slots and self.parked
               and not self._due_any(self.now(), _interactive)):
            parked = self.parked.popleft()
            bucket.restore(parked, self._get_parker())
            self.parked_bytes -= parked["state"].nbytes
            self.restores += 1
            admitted = True
        admitted |= self._admit_lap(bucket, is_preemptible)
        return admitted

    # ------------------------------------------------------------ step

    def step(self) -> bool:
        """One scheduling quantum.  Returns False when nothing was runnable
        (e.g. every remaining arrival is in the future)."""
        now = self.now()
        if self.mixed:
            bucket = self._bucket(None)
            admit = self._admit_slo if self.slo is not None \
                else self._admit_mixed
            admitted = admit(bucket)
            if bucket.active == 0 and not admitted and not bucket.jobs:
                return False
            self.finished.extend(bucket.run_quantum(
                self.quantum, self.now,
                admit_cb=lambda: admit(bucket)))
            return True
        # per-task buckets: with an SLO policy, tasks holding a due
        # interactive request take the quantum first
        offsets = list(range(len(self.rotation)))
        if self.slo is not None:
            urgent = [o for o in offsets if self._task_due(
                self.rotation[(self._rr + o) % len(self.rotation)],
                now, _interactive)]
            rest = [o for o in offsets if o not in urgent]
            offsets = urgent + rest
        for off in offsets:
            task = self.rotation[(self._rr + off) % len(self.rotation)]
            if self._runnable(task, now):
                self._rr = (self._rr + off + 1) % len(self.rotation)
                bucket = self._bucket(task)
                q = self.queues[task]

                def admit():
                    if self.slo is None:
                        while bucket.free_slots and q \
                                and q[0].arrival <= self.now():
                            done = bucket.admit(q.popleft(), self.now())
                            self.finished.extend(done)
                        return
                    # tiered: interactive first, then batch
                    while bucket.free_slots:
                        r = self._pop_due(task, self.now(), _interactive) \
                            or self._pop_due(task, self.now(),
                                             is_preemptible)
                        if r is None:
                            break
                        self.finished.extend(bucket.admit(r, self.now()))
                    # stateless "preemption": bump a staged batch-tier
                    # request back to the queue to seat a due interactive
                    bump = getattr(bucket, "bump_batch", None)
                    if bump is None or not self.slo.preemption:
                        return
                    while not bucket.free_slots and self._task_due(
                            task, self.now(), _interactive):
                        bumped = bump()
                        if bumped is None:
                            break
                        self.queues[task].appendleft(bumped)
                        self.preemptions += 1
                        r = self._pop_due(task, self.now(), _interactive)
                        if r is None:
                            break
                        self.finished.extend(bucket.admit(r, self.now()))

                admit()
                # router lookahead across buckets: submit the NEXT task's
                # usage-hot experts before this quantum launches
                la = getattr(self.backend, "lookahead", None)
                if la is not None:
                    nxt = self._peek_next_task(task, now)
                    if nxt is not None:
                        la(nxt)
                self.finished.extend(bucket.run_quantum(
                    self.quantum, self.now, admit_cb=admit))
                return True
        return False

    def run(self, requests=None) -> list[Request]:
        """Submit ``requests`` (optional) and drain everything.  Spins (with
        a tiny sleep) while all remaining arrivals are in the future —
        open-loop driving."""
        for r in requests or ():
            self.submit(r)
        self.now()                     # start the clock
        while self.pending():
            if not self.step():
                time.sleep(0.0005)
        return self.finished

    # ------------------------------------------------------------ metrics

    def metrics(self) -> dict[str, Any]:
        done = [r for r in self.finished if r.t_done is not None]
        toks = sum(len(r.tokens) for r in done)
        items = len(done)
        span = max((r.t_done for r in done), default=0.0) - \
            min((r.arrival for r in done), default=0.0)
        lat = np.array([r.latency for r in done], np.float64)
        lat = lat[np.isfinite(lat)]
        ttft = np.array([r.ttft for r in done], np.float64)
        ttft = ttft[np.isfinite(ttft)]

        def pct(a, p):
            return float(np.percentile(a, p)) if a.size else 0.0

        out: dict[str, Any] = {
            "requests": items,
            "tokens": toks,
            "span_s": span,
            "tok_per_s": toks / span if span > 0 else 0.0,
            "items_per_s": items / span if span > 0 else 0.0,
            "latency_p50_s": pct(lat, 50),
            "latency_p99_s": pct(lat, 99),
            "ttft_p50_s": pct(ttft, 50),
            "ttft_p99_s": pct(ttft, 99),
            "per_task": {
                t: sum(1 for r in done if r.task_id == t)
                for t in self.rotation
            },
        }
        # goodput-under-SLO + per-tier tails (requests without deadlines
        # count as met, so these reduce to throughput when SLOs are unset)
        out.update(goodput(done, span))
        tiers: dict[str, Any] = {}
        for name in sorted({r.tier for r in done}):
            rs = [r for r in done if r.tier == name]
            tt = np.array([r.ttft for r in rs], np.float64)
            tt = tt[np.isfinite(tt)]
            tp = np.array([request_tpot(r) for r in rs], np.float64)
            tp = tp[np.isfinite(tp)]
            tiers[name] = {
                "requests": len(rs),
                "ttft_p50_s": pct(tt, 50),
                "ttft_p99_s": pct(tt, 99),
                "tpot_p50_s": pct(tp, 50),
                "slo_attainment": sum(meets_slo(r) for r in rs) / len(rs),
                "preemptions": sum(r.preemptions for r in rs),
            }
        out["tiers"] = tiers
        if self.slo is not None:
            out["preemptions"] = self.preemptions
            out["restores"] = self.restores
            out["parked_now"] = len(self.parked)
            out["parked_bytes_peak"] = self.parked_bytes_peak
        prefix = getattr(self.backend, "prefix", None)
        if prefix is not None:
            out["prefix_cache"] = prefix.stats()
        chunks = sum(getattr(b, "prefill_chunks", 0)
                     for b in self.buckets.values())
        if chunks:
            out["prefill_chunks"] = chunks
        usage = getattr(self.backend, "usage", None)
        if usage is not None:
            out["expert_usage_task_overlap"] = usage.task_overlap()
        slot_steps = sum(getattr(b, "slot_steps", 0)
                         for b in self.buckets.values())
        steps = sum(getattr(b, "steps", 0) for b in self.buckets.values())
        cap = self.slots_per_bucket
        if steps:
            out["slot_utilization"] = slot_steps / (steps * cap)
        cache_stats = getattr(self.backend, "cache_stats", None)
        if callable(cache_stats):
            cs = cache_stats()
            out["expert_cache"] = cs
            # expert-parallel backends report placement evidence (plan
            # generation, migrations, per-shard load) at the top level
            if "placement" in cs:
                out["placement"] = cs["placement"]
                out["shard_load"] = cs.get("shard_load")
                out["shard_load_imbalance"] = cs.get("shard_load_imbalance")
        return out
