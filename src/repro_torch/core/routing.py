"""Expert-by-expert computation reordering (Edge-MoE §IV-D), the port of the
gather path of ``repro.core.routing``.

Every function takes any number of leading routing-group dims: the
reference ``vmap``s one group at a time, the port routes all groups of a
layer at once with the same per-group arithmetic.

  * ``route_topk``     — gating softmax + top-k.  ``jax.lax.top_k`` breaks
                         ties toward the lower index; a stable descending
                         sort does the same (``torch.topk`` promises no
                         order).
  * ``build_dispatch`` — per-expert queue positions by exclusive cumsum in
                         token order; entries past ``capacity`` dropped.
  * ``dispatch``       — gather into (..., E, C, d) queues; dropped slots
                         write a scrap row that is sliced off.
  * ``combine``        — gate-weighted sum over the k slots, in the
                         activation dtype (as the reference's bf16 sum).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import online_softmax

__all__ = [
    "Routing",
    "route",
    "route_topk",
    "build_dispatch",
    "dispatch",
    "dispatch_counts",
    "combine",
    "combine_rows",
    "combine_partial",
    "load_balance_loss",
]


class Routing(NamedTuple):
    """Routing decision: (..., T, k) per slot, (..., T, E) probabilities."""

    expert: torch.Tensor      # int32 — selected expert per slot
    gate: torch.Tensor        # f32   — combine weight per slot
    position: torch.Tensor    # int32 — row within the expert's queue
    valid: torch.Tensor       # bool  — False if dropped by capacity
    probs: torch.Tensor       # f32   — full gating distribution


def route_topk(gate_logits: torch.Tensor, k: int, *,
               renormalize: bool = True):
    """Top-k experts + combine weights from gating logits (..., T, E)."""
    probs = online_softmax.softmax(gate_logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[..., :k], idx[..., :k]
    if renormalize:
        gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return expert.to(torch.int32), gate, probs


def build_dispatch(expert: torch.Tensor, num_experts: int, capacity: int):
    """Per-expert queues with fixed capacity: (position, valid), (..., T, k).
    A token's k slots are consecutive in arrival order."""
    *lead, t, k = expert.shape
    flat = expert.reshape(*lead, t * k).long()
    onehot = torch.nn.functional.one_hot(flat, num_experts)
    pos_in_expert = torch.cumsum(onehot, dim=-2) - onehot
    position = torch.gather(pos_in_expert, -1, flat[..., None])[..., 0]
    valid = position < capacity
    return (position.reshape(*lead, t, k).to(torch.int32),
            valid.reshape(*lead, t, k))


def route(gate_logits: torch.Tensor, k: int, capacity: int, *,
          renormalize: bool = True) -> Routing:
    num_experts = gate_logits.shape[-1]
    expert, gate, probs = route_topk(gate_logits, k, renormalize=renormalize)
    position, valid = build_dispatch(expert, num_experts, capacity)
    return Routing(expert=expert, gate=gate, position=position, valid=valid,
                   probs=probs)


def dispatch_counts(routing: Routing, num_experts: int) -> torch.Tensor:
    """Per-expert queue lengths (..., E) int32 — the paper's metaqueue."""
    lead = routing.expert.shape[:-2]
    counts = torch.zeros(*lead, num_experts, dtype=torch.int32,
                         device=routing.expert.device)
    return counts.scatter_add_(
        -1, routing.expert.reshape(*lead, -1).long(),
        routing.valid.reshape(*lead, -1).to(torch.int32))


def _flat_groups(routing: Routing):
    """(G, T·k) views of expert / position / valid / gate."""
    *lead, t, k = routing.expert.shape
    g = 1
    for n in lead:
        g *= n
    return (g, t, k, routing.expert.reshape(g, t * k).long(),
            routing.position.reshape(g, t * k).long(),
            routing.valid.reshape(g, t * k), routing.gate.reshape(g, t * k))


def dispatch(x: torch.Tensor, routing: Routing, num_experts: int,
             capacity: int) -> torch.Tensor:
    """Gather tokens into per-expert queues: (..., T, d) -> (..., E, C, d)."""
    g, t, k, e, p, v, _ = _flat_groups(routing)
    d = x.shape[-1]
    # each token's row repeated for its k slots: an expand, whose backward
    # sums the k slot gradients in a fixed order (a gather by token index
    # would accumulate them with atomics on the card, in no fixed order)
    rows = x.reshape(g, t, 1, d).expand(g, t, k, d).reshape(g, t * k, d)
    gi = torch.arange(g, device=x.device)[:, None].expand(g, t * k)
    # dropped entries write a scrap row (index capacity), sliced off below
    p_safe = torch.where(v, p, capacity)
    buf = torch.zeros((g, num_experts, capacity + 1, d), dtype=x.dtype,
                      device=x.device)
    buf[gi, e, p_safe] = rows
    return buf[:, :, :capacity].reshape(*x.shape[:-2], num_experts,
                                        capacity, d)


def combine(expert_out: torch.Tensor, routing: Routing) -> torch.Tensor:
    """Gate-weighted scatter back to token order: (..., E, C, d) ->
    (..., T, d); the k-slot sum runs in ``expert_out.dtype``."""
    g, t, k, e, p, _, _ = _flat_groups(routing)
    num_e, c, d = expert_out.shape[-3:]
    out = expert_out.reshape(g, num_e, c, d)
    gi = torch.arange(g, device=out.device)[:, None].expand(g, t * k)
    return combine_rows(out[gi, e, torch.clamp_max(p, c - 1)], routing)


def combine_rows(rows: torch.Tensor, routing: Routing) -> torch.Tensor:
    """The weighting and k-slot sum of :func:`combine` on rows already in
    routing-slot order: rows (G, T·k, d), each slot's expert output (any
    finite value where the slot is invalid) -> (..., T, d).  The paged
    expert layer (``serve/expert_cache.py:PagedMoE``) fills such a buffer
    wave by wave and finishes through here, so its arithmetic is
    :func:`combine`'s to the bit."""
    t, k = routing.expert.shape[-2:]
    g, _, d = rows.shape
    gate = routing.gate.reshape(g, t * k)
    v = routing.valid.reshape(g, t * k)
    rows = rows * (gate * v).to(rows.dtype)[..., None]
    y = rows.reshape(g, t, k, d).sum(dim=2)
    return y.reshape(*routing.expert.shape[:-1], d)


def combine_partial(expert_out: torch.Tensor,
                    routing: Routing) -> torch.Tensor:
    """:func:`combine`'s weighting, its k-slot sum left in float32 and
    unrounded: an expert shard's partial output (slots it does not own are
    invalid, so they add exact zeros).  Summed over the shards and rounded
    once to ``expert_out.dtype``, it gives :func:`combine`'s bits on one
    shard, and on several the sum of the same products in another float32
    order."""
    g, t, k, e, p, _, _ = _flat_groups(routing)
    num_e, c, d = expert_out.shape[-3:]
    out = expert_out.reshape(g, num_e, c, d)
    gi = torch.arange(g, device=out.device)[:, None].expand(g, t * k)
    rows = out[gi, e, torch.clamp_max(p, c - 1)]
    w = (routing.gate.reshape(g, t * k)
         * routing.valid.reshape(g, t * k)).to(rows.dtype)
    y = (rows * w[..., None]).float().reshape(g, t, k, d).sum(dim=2)
    return y.reshape(*routing.expert.shape[:-1], d)


def load_balance_loss(probs: torch.Tensor, expert: torch.Tensor,
                      num_experts: int,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """Switch-style auxiliary loss ``E · Σ_e f_e · P_e`` per routing group
    (leading dims kept); ``mask`` (..., T) excludes padding tokens."""
    *lead, t, k = expert.shape
    w = torch.ones((*lead, t), device=probs.device) if mask is None \
        else mask.float()
    counts = torch.zeros((*lead, num_experts), device=probs.device)
    counts = counts.scatter_add_(-1, expert.reshape(*lead, t * k).long(),
                                 w.repeat_interleave(k, dim=-1))
    denom = torch.clamp_min(w.sum(-1), 1.0)[..., None]
    f = counts / (denom * k)
    p = (probs * w[..., None]).sum(dim=-2) / denom
    return num_experts * (f * p).sum(-1)
