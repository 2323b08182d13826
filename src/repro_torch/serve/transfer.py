"""Asynchronous host→device expert-weight transfers with explicit fences,
the port of ``repro.serve.transfer``.

Edge-MoE's premise is that expert weights *stream* past a small fast
memory without stalling the compute pipeline (§IV-D).  The serving
analogue is a **copy stream**: host→device page-ins are *submitted*
non-blocking the moment the router makes the next wave predictable, run
while the current wave computes, and are *fenced* only where the weights
are dereferenced.  The paging policy in ``serve/expert_cache.py`` never
touches a clock, a stream or an event directly:

  * :class:`TransferEngine` — the transport on the card.  One side CUDA
    stream stands in for the reference's worker pool of
    ``jax.device_put``: ``submit`` copies pinned host rows into freshly
    allocated device tensors on that stream (``non_blocking=True``) and
    records an event; ``ready`` queries the event; ``fence`` waits for it
    and *accounts the wait*: time spent inside a fence is ``stall_s``
    (the copy was NOT hidden), time between submit and the fence is
    ``hidden_s`` (the copy rode behind compute).  A pageable source would
    make the copy synchronous, so ``submit`` refuses one on the card.
  * :class:`FakeTransferEngine` — the deterministic test transport.  Same
    API, but time is a **virtual clock** the test owns: every transfer
    completes ``latency_s`` after submit (per-key overrides via
    ``schedule``), ``advance()`` models compute happening while copies
    fly, ``complete()`` force-finishes a specific transfer, and a
    ``None`` latency is a *hung* link — fencing it raises
    :class:`TransferTimeout`.  It holds host copies and materializes them
    on its device with ``.to(device)`` at fence time, so adversarial
    completion orders can only break *bookkeeping*.
  * :class:`TransferStats` — the ledger both engines fill in (``stall_s``,
    ``overlap_ratio``, fence/cancel/byte counters, per-tag sub-ledgers).

Contract (``tests/test_torch_transfer.py``, as the reference's
``tests/test_async_paging.py``): a fence returns the payload exactly
once, and fencing twice is an error; ``cancel`` drops an in-flight
transfer (its bytes count as ``bytes_cancelled``, never as paged);
timeouts are loud — a fence past ``timeout_s`` raises
:class:`TransferTimeout` naming the transfer's key.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["Transfer", "TransferStats", "TransferEngine",
           "FakeTransferEngine", "TransferTimeout"]


class TransferTimeout(RuntimeError):
    """A fenced transfer did not complete within the engine timeout."""


@dataclass
class TransferStats:
    """Ledger of copy-stream activity, shared by both transports.

    ``stall_s`` is time a fence spent *blocked* (the copy was on the
    critical path); ``hidden_s`` is submit→fence time that fences did NOT
    have to wait for (the copy overlapped compute).  Demand page-ins fence
    right after submit, so they contribute almost pure stall;
    well-predicted prefetches almost pure hidden time.
    """

    submitted: int = 0
    fenced: int = 0
    fences_ready: int = 0        # fence found the copy already complete
    fences_blocked: int = 0      # fence had to wait
    cancelled: int = 0
    timeouts: int = 0
    bytes_submitted: int = 0
    bytes_cancelled: int = 0
    stall_s: float = 0.0
    hidden_s: float = 0.0
    # per-tag sub-ledgers ("demand" / "prefetch" / "migrate" / ...)
    tags: dict = field(default_factory=dict)

    def _tag(self, tag: str) -> dict:
        return self.tags.setdefault(tag, {
            "submitted": 0, "fenced": 0, "cancelled": 0,
            "stall_s": 0.0, "hidden_s": 0.0})

    def note_submit(self, tag: str) -> None:
        self._tag(tag)["submitted"] += 1

    def note_cancel(self, tag: str) -> None:
        self._tag(tag)["cancelled"] += 1

    def note_fence(self, tag: str, stall_s: float, hidden_s: float) -> None:
        d = self._tag(tag)
        d["fenced"] += 1
        d["stall_s"] += stall_s
        d["hidden_s"] += hidden_s

    def tags_dict(self) -> dict[str, Any]:
        out = {}
        for tag, d in self.tags.items():
            tot = d["stall_s"] + d["hidden_s"]
            out[tag] = dict(d, overlap_ratio=(
                d["hidden_s"] / tot if tot > 0 else 1.0))
        return out

    @property
    def active_s(self) -> float:
        """Total transfer time observed (hidden + stalled)."""
        return self.stall_s + self.hidden_s

    @property
    def overlap_ratio(self) -> float:
        """Fraction of transfer time hidden behind compute.  1.0 when no
        transfers happened (nothing to hide = nothing stalled)."""
        tot = self.active_s
        return self.hidden_s / tot if tot > 0 else 1.0

    def as_dict(self) -> dict[str, Any]:
        return {
            "submitted": self.submitted, "fenced": self.fenced,
            "fences_ready": self.fences_ready,
            "fences_blocked": self.fences_blocked,
            "cancelled": self.cancelled, "timeouts": self.timeouts,
            "bytes_submitted": self.bytes_submitted,
            "bytes_cancelled": self.bytes_cancelled,
            "stall_s": self.stall_s, "hidden_s": self.hidden_s,
            "overlap_ratio": self.overlap_ratio,
            "tags": self.tags_dict(),
        }

    def reset(self) -> None:
        for f in ("submitted", "fenced", "fences_ready", "fences_blocked",
                  "cancelled", "timeouts", "bytes_submitted",
                  "bytes_cancelled"):
            setattr(self, f, 0)
        self.stall_s = self.hidden_s = 0.0
        self.tags.clear()


class Transfer:
    """Handle for one in-flight host→device copy (one expert's leaves)."""

    __slots__ = ("key", "nbytes", "t_submit", "done", "cancelled",
                 "_payload", "_event", "ready_at", "tag")

    def __init__(self, key: Any, nbytes: int, t_submit: float,
                 tag: str = "page"):
        self.key = key
        self.nbytes = int(nbytes)
        self.t_submit = float(t_submit)
        self.tag = str(tag)
        self.done = False           # fenced (payload handed out)
        self.cancelled = False
        self._payload: Optional[dict] = None
        self._event = None          # real engine: the copy's CUDA event
        self.ready_at: float = 0.0  # fake engine: virtual completion time

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = ("cancelled" if self.cancelled
                 else "done" if self.done else "inflight")
        return f"Transfer({self.key!r}, {self.nbytes}B, {state})"


def _host_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def _nbytes(arrays: dict) -> int:
    return sum(int(_host_tensor(a).nbytes) for a in arrays.values())


class _Landed:
    """The event of a copy that completed inside ``submit`` (a CPU
    device: the copy is synchronous)."""

    @staticmethod
    def query() -> bool:
        return True


class TransferEngine:
    """The copy stream on the card: one side CUDA stream and an event per
    transfer.

    ``submit`` enqueues the copy of each pinned host tensor into a fresh
    device tensor on the side stream and returns a handle at once — the
    host keeps launching compute on its own stream while the copy engine
    moves bytes.  ``fence`` waits for the copy's event (polling it, so a
    copy that never lands raises :class:`TransferTimeout` after
    ``timeout_s`` instead of hanging), makes the current stream wait on
    the event and ties the payload's memory to the current stream
    (``record_stream``), so the caching allocator cannot hand the payload's
    blocks to another side-stream copy while compute still reads them.
    With ``device="cpu"`` (the tests) a copy is a synchronous clone and
    every fence finds it landed.

    The engine knows nothing of experts or slots: keys are opaque and name
    a transfer in errors and in the per-tag ledger only.
    """

    def __init__(self, device="cuda", timeout_s: Optional[float] = 60.0):
        self.device = resolve_device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.timeout_s = timeout_s
        self.stats = TransferStats()

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def submit(self, key: Any, arrays: dict, tag: str = "page") -> Transfer:
        """Begin a non-blocking host→device copy of ``arrays`` (host
        tensors, pinned on a card).  Returns immediately.  ``tag`` labels
        the copy's purpose ("demand"/"prefetch"/"migrate") in the
        per-tag ledger."""
        host = {n: _host_tensor(a) for n, a in arrays.items()}
        t = Transfer(key, _nbytes(host), self.now(), tag=tag)
        if self.stream is None:
            t._payload = {n: a.clone() for n, a in host.items()}
            t._event = _Landed()
        else:
            unpinned = [n for n, a in host.items() if not a.is_pinned()]
            if unpinned:
                raise ValueError(
                    f"transfer {key!r}: host tensors {unpinned} are not "
                    "pinned, so a non_blocking copy would run synchronously")
            # the copy waits for nothing on the compute stream: its sources
            # are immutable host rows and its destinations fresh tensors
            with torch.cuda.stream(self.stream):
                t._payload = {n: a.to(self.device, non_blocking=True)
                              for n, a in host.items()}
                t._event = torch.cuda.Event()
                t._event.record(self.stream)
        self.stats.submitted += 1
        self.stats.bytes_submitted += t.nbytes
        self.stats.note_submit(t.tag)
        return t

    def ready(self, t: Transfer) -> bool:
        """Non-blocking completion poll."""
        if t.done or t.cancelled:
            return t.done
        return bool(t._event.query())

    def fence(self, t: Transfer) -> dict:
        """Wait until ``t`` has landed on the device; returns its payload.

        The wait is accounted as ``stall_s``; submit→fence time is
        ``hidden_s`` (the copy overlapped whatever the caller did).
        Raises :class:`TransferTimeout` after ``timeout_s``."""
        if t.cancelled:
            raise RuntimeError(f"fence on cancelled transfer {t.key!r}")
        if t.done:
            raise RuntimeError(f"double fence on transfer {t.key!r}")
        t0 = self.now()
        was_ready = bool(t._event.query())
        if not was_ready:
            while not t._event.query():
                if self.timeout_s is not None \
                        and self.now() - t0 > self.timeout_s:
                    self.stats.timeouts += 1
                    raise TransferTimeout(
                        f"transfer {t.key!r} ({t.nbytes} bytes) did not "
                        f"complete within {self.timeout_s}s")
        t1 = self.now()
        payload = t._payload
        if self.stream is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(t._event)
            for a in payload.values():
                a.record_stream(current)
        self.stats.fenced += 1
        if was_ready:
            self.stats.fences_ready += 1
        else:
            self.stats.fences_blocked += 1
        self.stats.stall_s += t1 - t0
        self.stats.hidden_s += max(0.0, t0 - t.t_submit)
        self.stats.note_fence(t.tag, t1 - t0, max(0.0, t0 - t.t_submit))
        t.done = True
        t._event = None
        return payload

    def cancel(self, t: Transfer) -> None:
        """Drop an in-flight transfer: its payload will never be committed
        (the copy may still run to its end on the side stream, into
        tensors nobody reads)."""
        if t.done or t.cancelled:
            return
        t.cancelled = True
        t._payload = None
        t._event = None
        self.stats.cancelled += 1
        self.stats.bytes_cancelled += t.nbytes
        self.stats.note_cancel(t.tag)

    def on_wave(self, seconds: Optional[float] = None) -> None:
        """Compute-progress hook: a wave was launched.  Wall time advances
        by itself for the real transport — a no-op here and a
        virtual-clock tick on :class:`FakeTransferEngine`."""

    def drain(self) -> None:
        """Wait for every queued copy (teardown and tests)."""
        if self.stream is not None:
            self.stream.synchronize()

    def reset_stats(self) -> None:
        self.stats.reset()


class FakeTransferEngine:
    """Deterministic stall-injection transport with a virtual clock.

    Test control surface:

      * ``latency_s``      — default virtual copy duration per transfer;
      * ``schedule``       — ``{key: latency}`` per-key overrides; a
        ``None`` latency is a HUNG link (a fence raises
        :class:`TransferTimeout` instead of waiting forever);
      * ``wave_s``         — how much virtual time one compute wave is
        worth; ``on_wave()`` (called by ``PagedMoE`` after launching a
        wave) advances the clock by it;
      * ``advance(dt)``    — explicit clock tick;
      * ``complete(key)``  — force a specific in-flight transfer to be
        complete *now* (adversarial completion orderings).

    Payloads are host copies taken at submit and moved to ``device`` at
    fence time, so timing can never alter results — only the bookkeeping
    around them.
    """

    def __init__(self, latency_s: float = 0.0,
                 schedule: Optional[dict] = None,
                 timeout_s: float = 30.0,
                 wave_s: float = 0.0, device="cuda"):
        self.device = resolve_device(device)
        self.t = 0.0
        self.latency_s = float(latency_s)
        self.schedule = dict(schedule or {})
        self.timeout_s = float(timeout_s)
        self.wave_s = float(wave_s)
        self.stats = TransferStats()
        self._inflight: dict[Any, Transfer] = {}

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        """Tick the virtual clock: copies in flight make ``dt`` seconds
        of progress."""
        self.t += float(dt)

    def on_wave(self, seconds: Optional[float] = None) -> None:
        self.advance(self.wave_s if seconds is None else seconds)

    def complete(self, key: Any) -> None:
        """Force the in-flight transfer with ``key`` to complete now."""
        t = self._inflight.get(key)
        if t is None:
            raise KeyError(f"no in-flight transfer with key {key!r}")
        t.ready_at = self.t

    def _latency(self, key: Any) -> Optional[float]:
        return self.schedule.get(key, self.latency_s)

    def submit(self, key: Any, arrays: dict, tag: str = "page") -> Transfer:
        host = {n: _host_tensor(a) for n, a in arrays.items()}
        t = Transfer(key, _nbytes(host), self.t, tag=tag)
        lat = self._latency(key)
        t.ready_at = math.inf if lat is None else self.t + float(lat)
        # hold HOST copies: a late mutation of the caller's host store must
        # not retroactively change what this transfer delivers
        t._payload = {n: a.detach().to("cpu", copy=True)
                      for n, a in host.items()}
        self._inflight[key] = t
        self.stats.submitted += 1
        self.stats.bytes_submitted += t.nbytes
        self.stats.note_submit(t.tag)
        return t

    def ready(self, t: Transfer) -> bool:
        return (not t.cancelled) and t.ready_at <= self.t

    def fence(self, t: Transfer) -> dict:
        if t.cancelled:
            raise RuntimeError(f"fence on cancelled transfer {t.key!r}")
        if t.done:
            raise RuntimeError(f"double fence on transfer {t.key!r}")
        if not self.ready(t):
            wait = t.ready_at - self.t
            if wait > self.timeout_s:
                self.stats.timeouts += 1
                raise TransferTimeout(
                    f"transfer {t.key!r} ({t.nbytes} bytes) hung: needs "
                    f"{'forever' if math.isinf(wait) else f'{wait:.3f}s'} "
                    f"> timeout {self.timeout_s}s of virtual time")
            self.stats.fences_blocked += 1
            self.stats.stall_s += wait
            # the flight time BEFORE the fence overlapped whatever the
            # caller was doing (however the test advanced the clock)
            self.stats.hidden_s += max(0.0, self.t - t.t_submit)
            self.stats.note_fence(t.tag, wait, max(0.0, self.t - t.t_submit))
            self.t = t.ready_at
        else:
            self.stats.fences_ready += 1
            # copy finished before the fence: its whole duration was hidden
            self.stats.hidden_s += max(0.0, t.ready_at - t.t_submit)
            self.stats.note_fence(t.tag, 0.0,
                                  max(0.0, t.ready_at - t.t_submit))
        self.stats.fenced += 1
        t.done = True
        self._inflight.pop(t.key, None)
        payload = {n: a.to(self.device) for n, a in t._payload.items()}
        t._payload = payload
        return payload

    def cancel(self, t: Transfer) -> None:
        if t.done or t.cancelled:
            return
        t.cancelled = True
        t._payload = None
        self._inflight.pop(t.key, None)
        self.stats.cancelled += 1
        self.stats.bytes_cancelled += t.nbytes
        self.stats.note_cancel(t.tag)

    def reset_stats(self) -> None:
        self.stats.reset()
