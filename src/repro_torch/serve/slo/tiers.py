"""SLO tiers: per-request service classes with TTFT/TPOT deadlines.

"Millions of users" is not one service class: an interactive chat turn
cares about time-to-first-token (TTFT) and per-token cadence (TPOT),
while a batch summarization job only cares that it finishes.  A
:class:`TierSpec` names a class and its deadlines; the scheduler uses
``preemptible`` to decide whose decode slot may be evicted (KV parked)
when an interactive burst arrives, and :func:`meets_slo` turns finished
requests into the metric that matters at production scale —
goodput-under-SLO, the request/token rate *within deadline* rather than
raw throughput.

This module is deliberately dependency-free (no torch, no scheduler
import): the scheduler imports it, never the other way around.  A copy of
``repro.serve.slo.tiers``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Optional

__all__ = ["TierSpec", "INTERACTIVE", "BATCH", "TIERS", "SLOPolicy",
           "tag_request", "request_tpot", "meets_slo", "is_preemptible",
           "goodput"]


@dataclass(frozen=True)
class TierSpec:
    """A service class: deadlines (``None`` = unconstrained) and whether
    the scheduler may evict this tier's decode slots under pressure."""

    name: str
    ttft_slo_s: Optional[float] = None   # arrival -> first token deadline
    tpot_slo_s: Optional[float] = None   # mean seconds per output token
    preemptible: bool = False


INTERACTIVE = TierSpec("interactive", ttft_slo_s=0.3, tpot_slo_s=0.1,
                       preemptible=False)
BATCH = TierSpec("batch", preemptible=True)
TIERS = {t.name: t for t in (INTERACTIVE, BATCH)}


@dataclass(frozen=True)
class SLOPolicy:
    """Scheduler-level SLO behavior (pass as ``Scheduler(..., slo=...)``).

    ``preemption``       evict batch-tier decode slots (KV park/restore,
                         bit-exact — see ``slo/preempt.py``) when a due
                         interactive request has no free slot;
    ``park_compress``    parked-state storage: ``"none"`` keeps the slot
                         leaves verbatim (always bit-exact), ``"int8"``
                         packs fp KV rows via ``quant.quantize_kv`` (a
                         no-op — still bit-exact — when the cache is
                         already int8 via ``kv_quant="int8"``);
    ``chunk_interleave`` admit long prompts in ``ServeConfig.
                         prefill_chunk``-token chunks interleaved with
                         decode steps, so one long prefill cannot
                         head-of-line-block every decode slot;
    ``max_parked``       bound on simultaneously parked requests.
    """

    preemption: bool = True
    park_compress: str = "none"
    chunk_interleave: bool = True
    max_parked: int = 64


def tag_request(req: Any, spec: TierSpec) -> Any:
    """Stamp a request with a tier and (where unset) its deadlines."""
    req.tier = spec.name
    if req.ttft_slo_s is None:
        req.ttft_slo_s = spec.ttft_slo_s
    if req.tpot_slo_s is None:
        req.tpot_slo_s = spec.tpot_slo_s
    return req


def is_preemptible(req: Any) -> bool:
    spec = TIERS.get(getattr(req, "tier", "interactive"))
    return spec.preemptible if spec is not None else False


def request_tpot(req: Any) -> float:
    """Mean time per output token after the first (nan until finished)."""
    if req.t_done is None or req.t_first is None or len(req.tokens) <= 1:
        return float("nan")
    return (req.t_done - req.t_first) / (len(req.tokens) - 1)


def meets_slo(req: Any) -> bool:
    """A finished request within its deadlines (unset deadline = met)."""
    if req.t_done is None:
        return False
    if req.ttft_slo_s is not None:
        t = req.ttft
        if not (t == t) or t > req.ttft_slo_s:   # nan-safe
            return False
    if req.tpot_slo_s is not None and len(req.tokens) > 1:
        tp = request_tpot(req)
        if tp == tp and tp > req.tpot_slo_s:
            return False
    return True


def goodput(done: Iterable[Any], span_s: float) -> dict[str, float]:
    """Goodput-under-SLO over a finished set: requests/s and tokens/s
    counting only SLO-met requests, plus the attainment fraction."""
    done = list(done)
    good = [r for r in done if meets_slo(r)]
    span = max(span_s, 1e-12)
    return {
        "goodput_rps": len(good) / span,
        "goodput_tok_per_s": sum(len(r.tokens) for r in good) / span,
        "slo_attainment": len(good) / len(done) if done else 1.0,
    }
