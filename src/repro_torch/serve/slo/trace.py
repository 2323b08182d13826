"""Traffic-trace generator: heavy-tailed open-loop multi-tenant workloads.

A fixed Poisson arrival rate — what the throughput benchmarks drive —
is the one thing production traffic never is.  :class:`TraceGenerator`
produces the serving regimes the SLO scheduler exists for, all from one
seed (bit-reproducible across runs):

  * **bursts**: arrivals alternate ON/OFF phases; ON phases compress the
    mean interarrival by ``burst_factor`` (the p99-TTFT killer);
  * **heavy tails**: batch-tier output lengths draw from a bounded
    Pareto — a few requests occupy decode slots for a long time;
  * **tiers**: each request is interactive (short prompt, short output,
    TTFT/TPOT deadlines) or batch (long prompt, long output, no
    deadline, preemptible) per ``interactive_frac``;
  * **task-mix shift**: the task distribution flips halfway through the
    trace (a diurnal workload change in miniature);
  * **tenant skew**: tenants draw from a Zipf; each tenant owns a shared
    prompt prefix (its "system prompt"), which is what gives the radix
    prefix cache something to reuse.

A copy of ``repro.serve.slo.trace`` (numpy only): the same seed gives the
same requests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.serve.slo.tiers import (BATCH, INTERACTIVE, TierSpec,
                                         tag_request)

__all__ = ["TickClock", "TraceConfig", "TraceGenerator"]


class TickClock:
    """Deterministic scheduler clock: every call advances one ``dt``.

    Replaces ``time.monotonic`` in tests and trace replays so arrival
    deadlines and preemption timing are a function of scheduler *events*
    (clock reads), never of host speed or kernel build time.
    """

    def __init__(self, dt: float = 0.01):
        self.t = 0.0
        self.dt = dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


@dataclass(frozen=True)
class TraceConfig:
    n: int = 64
    seed: int = 0
    vocab: int = 256
    num_tasks: int = 2
    num_tenants: int = 4
    # arrivals: exponential interarrivals, phase-modulated into bursts
    mean_interarrival_s: float = 0.01
    burst_factor: float = 8.0      # ON-phase rate multiplier
    burst_len: int = 8             # requests per ON phase
    burst_gap: int = 8             # requests per OFF phase
    # tiers
    interactive_frac: float = 0.5
    interactive: TierSpec = INTERACTIVE
    batch: TierSpec = BATCH
    # prompt/output shapes (inclusive ranges)
    interactive_prompt: tuple = (8, 16)
    interactive_new: tuple = (4, 12)
    batch_prompt: tuple = (32, 64)
    batch_new: tuple = (16, 48)    # bounded-Pareto tail between these
    pareto_alpha: float = 1.5
    # structure
    task_shift: bool = True        # task mix flips at the halfway point
    tenant_zipf_a: float = 1.5
    shared_prefix_len: int = 0     # per-tenant shared prompt prefix


class TraceGenerator:
    """Seeded request-trace factory (see :class:`TraceConfig`)."""

    def __init__(self, cfg: TraceConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self._prefixes = [
            self.rng.integers(0, cfg.vocab, cfg.shared_prefix_len,
                              dtype=np.int32)
            for _ in range(cfg.num_tenants)
        ] if cfg.shared_prefix_len > 0 else None

    # ------------------------------------------------------------ draws

    def _arrivals(self) -> np.ndarray:
        cfg, rng = self.cfg, self.rng
        period = max(cfg.burst_len + cfg.burst_gap, 1)
        gaps = np.empty(cfg.n)
        for i in range(cfg.n):
            on = (i % period) < cfg.burst_len
            mean = cfg.mean_interarrival_s / (cfg.burst_factor if on
                                              else 1.0)
            gaps[i] = rng.exponential(mean)
        return np.cumsum(gaps)

    def _bounded_pareto(self, lo: int, hi: int) -> int:
        x = lo * (1.0 + self.rng.pareto(self.cfg.pareto_alpha))
        return int(min(max(x, lo), hi))

    def _task(self, i: int) -> int:
        cfg, rng = self.cfg, self.rng
        t = cfg.num_tasks
        if t <= 1:
            return 0
        # 70% of mass on one "hot" task; which task is hot flips halfway
        p = np.full(t, 0.3 / (t - 1))
        hot = 0 if (not cfg.task_shift or i < cfg.n // 2) else t - 1
        p[hot] = 0.7
        return int(rng.choice(t, p=p))

    def _tenant(self) -> int:
        cfg = self.cfg
        if cfg.num_tenants <= 1:
            return 0
        z = int(self.rng.zipf(cfg.tenant_zipf_a))
        return min(z - 1, cfg.num_tenants - 1)

    def _prompt(self, tenant: int, lo: int, hi: int) -> np.ndarray:
        cfg = self.cfg
        n = int(self.rng.integers(lo, hi + 1))
        body = self.rng.integers(0, cfg.vocab, n, dtype=np.int32)
        if self._prefixes is None:
            return body
        return np.concatenate([self._prefixes[tenant], body])

    # --------------------------------------------------------- generate

    def generate(self) -> list:
        from repro_torch.serve.scheduler import Request   # avoid import cycle

        cfg = self.cfg
        arrivals = self._arrivals()
        reqs = []
        for i in range(cfg.n):
            tenant = self._tenant()
            interactive = self.rng.random() < cfg.interactive_frac
            if interactive:
                prompt = self._prompt(tenant, *cfg.interactive_prompt)
                new = int(self.rng.integers(cfg.interactive_new[0],
                                            cfg.interactive_new[1] + 1))
                spec = cfg.interactive
            else:
                prompt = self._prompt(tenant, *cfg.batch_prompt)
                new = self._bounded_pareto(*cfg.batch_new)
                spec = cfg.batch
            req = Request(rid=i, task_id=self._task(i), prompt=prompt,
                          max_new_tokens=new, arrival=float(arrivals[i]),
                          tenant=tenant)
            reqs.append(tag_request(req, spec))
        return reqs
