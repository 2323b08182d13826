"""Mixture-of-Experts layer with multi-task gating (Edge-MoE §IV-D + §IV-F),
the port of ``repro.core.moe`` with ``impl="grouped"``.

Tokens are cut into routing groups of ``group_size`` (zero-padded up to a
multiple); each group is routed on its own, exactly as the reference does
per group.  The reference ``vmap``s the group; here every stage carries
the group axis, so the expert GEMMs of all groups of a layer run as one
``moe_grouped_gemm`` dispatch per projection — one kernel launch on the
card.  Multi-task gating: the gate table has a leading task axis and the
active task is an index into it (a scalar task), or each sequence picks
its own row (a per-sequence task vector).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import routing as R
from repro_torch.core.unified_linear import unified_linear

__all__ = ["MoEConfig", "init_moe", "apply_moe", "group_shape",
           "expert_param_names", "route_groups", "RoutedGroups",
           "add_shared_experts"]


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                      # per-expert hidden dim
    num_experts: int
    top_k: int
    num_tasks: int = 1             # >1 => task-specific gating networks
    expert_kind: str = "swiglu"    # "gelu" | "swiglu"
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    group_size: int = 4096         # tokens routed per independent group
    impl: str = "grouped"          # the port serves "grouped"
    renormalize: bool = True

    def capacity(self, tokens_per_group: int) -> int:
        c = int(tokens_per_group * self.top_k * self.capacity_factor
                / self.num_experts) + 1
        return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def normal(rng: np.random.Generator, shape, scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """Seeded N(0, 1)·scale in float32, cast to ``dtype`` (on the CPU)."""
    a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
    return torch.from_numpy(a).to(dtype)


def init_moe(rng: np.random.Generator, cfg: MoEConfig,
             dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """The reference's shapes and scales; gate and biases in float32."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s, sf = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"gate": normal(rng, (cfg.num_tasks, d, e), s, torch.float32)}
    if cfg.expert_kind == "swiglu":
        p["wg"] = normal(rng, (e, d, f), s, dtype)
        p["wu"] = normal(rng, (e, d, f), s, dtype)
        p["wd"] = normal(rng, (e, f, d), sf, dtype)
    else:
        p["w1"] = normal(rng, (e, d, f), s, dtype)
        p["b1"] = torch.zeros((e, f), dtype=torch.float32)
        p["w2"] = normal(rng, (e, f, d), sf, dtype)
        p["b2"] = torch.zeros((e, d), dtype=torch.float32)
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared_wg"] = normal(rng, (d, fs), s, dtype)
        p["shared_wu"] = normal(rng, (d, fs), s, dtype)
        p["shared_wd"] = normal(rng, (fs, d), sf, dtype)
    return p


def group_shape(t_total: int, group_size: int) -> tuple[int, int]:
    """(group length g, padded token count): groups are
    ``min(group_size, t_total)`` long, the stream is padded up to a
    multiple of g."""
    g = max(1, min(group_size, t_total))
    return g, -(-t_total // g) * g


def expert_param_names(cfg: MoEConfig) -> tuple[str, ...]:
    if cfg.expert_kind == "swiglu":
        return ("wg", "wu", "wd")
    return ("w1", "b1", "w2", "b2")


def _expert_ffn(params, cfg: MoEConfig, buf: torch.Tensor,
                group_sizes: torch.Tensor | None = None) -> torch.Tensor:
    """Every expert's MLP on its queue: (..., E, C, d) -> (..., E, C, d).
    Each projection is one ``moe_grouped_gemm`` dispatch; the activation is
    policy-dispatched (exact / LUT / LUT kernel)."""
    from repro_torch.ops import apply_activation
    from repro_torch.ops.registry import dispatch

    act = "silu" if cfg.expert_kind == "swiglu" else "gelu"

    def gemm(x, w):
        return dispatch("moe_grouped_gemm", x, w, group_sizes)

    if cfg.expert_kind == "swiglu":
        g = gemm(buf, params["wg"])
        u = gemm(buf, params["wu"])
        h = (apply_activation(g, act) * u).to(buf.dtype)
        return gemm(h, params["wd"]).to(buf.dtype)
    h = gemm(buf, params["w1"])
    h = apply_activation(h + params["b1"][:, None, :], act).to(buf.dtype)
    o = gemm(h, params["w2"])
    return (o + params["b2"][:, None, :]).to(buf.dtype)


def _is_task_vector(task_id) -> bool:
    if isinstance(task_id, torch.Tensor):
        return task_id.dim() == 1
    return not isinstance(task_id, int) and np.ndim(task_id) == 1


#: rows of one gating product: a multiple of every routing group length
#: the serving paths use (128), so each group's rows land in one product
GATE_ROWS = 1024


def _gate_logits(xf: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """xf (G, g, d) float32 times the gate (d, E), or every task's gate
    (tasks, d, E) -> (G, g, E) or (G, g, tasks, E), in float32 products of
    exactly ``GATE_ROWS`` rows (the last one zero-padded).  Every product
    has the same shape at any G, so the library takes the same algorithm
    and a token's logits do not depend on the tokens beside it.  (One
    product over all G·g rows did: on the H100 it took another algorithm
    below 896 rows — split-K — and moved the logits' last bits, which the
    fused MoE kernel carries in its float32 gate weights.)"""
    g_num, t, d = xf.shape
    w = gate_w if gate_w.dim() == 2 else \
        gate_w.permute(1, 0, 2).reshape(d, -1)
    rows = xf.reshape(-1, d)
    n = rows.shape[0]
    pad = -n % GATE_ROWS
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, d))])
    out = torch.cat([torch.mm(c, w) for c in rows.split(GATE_ROWS)]) \
        if rows.shape[0] > GATE_ROWS else torch.mm(rows, w)
    return out[:n].reshape((g_num, t) + gate_w.shape[:-2] + (-1,))


class RoutedGroups(NamedTuple):
    """One MoE call's tokens cut into routing groups and routed: what
    :func:`apply_moe` and the paged layer (``serve/expert_cache.py``)
    share, so both route a token to the same bits."""

    groups: torch.Tensor            # (G, g, d), zero-padded
    real: Optional[torch.Tensor]    # (G, g) bool pad mask, None: no pads
    routing: R.Routing              # (G, g, k) per slot
    stat: torch.Tensor              # (G, rows) int32 per-expert counts
    capacity: int
    t_total: int


def route_groups(params, cfg: MoEConfig, x: torch.Tensor,
                 task_id=0) -> RoutedGroups:
    """Group, gate and route ``x`` (..., T, d): the gating logits in
    float32, top-k and capacity per group, and the per-expert dispatch
    counts with pad rows excluded — ``stat`` rows are experts, or
    (task, expert) pairs for a per-sequence task vector."""
    d = x.shape[-1]
    dev = x.device
    flat = x.reshape(-1, d)
    t_total = flat.shape[0]
    g, t_pad = group_shape(t_total, cfg.group_size)
    n_groups = t_pad // g
    real = None   # pad-row mask: pads are excluded from aux + stats
    if t_pad != t_total:
        flat = torch.cat([flat, flat.new_zeros((t_pad - t_total, d))])
        real = (torch.arange(t_pad, device=dev) < t_total).reshape(
            n_groups, g)
    groups = flat.reshape(n_groups, g, d)
    capacity = cfg.capacity(g)

    task_groups = None
    if _is_task_vector(task_id):
        tv = torch.as_tensor(task_id, dtype=torch.long, device=dev)
        task_vec = tv.repeat_interleave(t_total // tv.shape[0])
        if t_pad != t_total:
            task_vec = torch.cat([task_vec, task_vec.new_zeros(
                t_pad - t_total)])
        task_groups = task_vec.reshape(n_groups, g)

    gate_w = params["gate"]
    gate_b = params.get("gate_bias")
    n_stat_tasks = gate_w.shape[0] if gate_w.dim() == 3 else 1
    xf = groups.float()
    if task_groups is None:
        if gate_w.dim() == 3:   # (tasks, d, E): the §IV-F pointer switch
            gate_w = gate_w[int(task_id)]
            if gate_b is not None and gate_b.dim() == 2:
                gate_b = gate_b[int(task_id)]
        logits = _gate_logits(xf, gate_w)
        if gate_b is not None:
            logits = logits + gate_b.float()
    else:
        # every task's gate, then select per token
        all_logits = _gate_logits(xf, gate_w)
        logits = torch.gather(
            all_logits, 2,
            task_groups[:, :, None, None].expand(
                n_groups, g, 1, cfg.num_experts))[:, :, 0]
        if gate_b is not None:
            logits = logits + gate_b[task_groups].float()

    r = R.route(logits, cfg.top_k, capacity, renormalize=cfg.renormalize)
    stat_valid = r.valid if real is None else r.valid & real[..., None]
    stat_idx = r.expert.reshape(n_groups, -1).long()
    n_rows = cfg.num_experts
    if task_groups is not None:   # (tasks, E): per-task router usage
        stat_idx = stat_idx + cfg.num_experts * \
            task_groups.repeat_interleave(cfg.top_k, dim=-1)
        n_rows = n_stat_tasks * cfg.num_experts
    stat = torch.zeros((n_groups, n_rows), dtype=torch.int32, device=dev)
    stat.scatter_add_(-1, stat_idx,
                      stat_valid.reshape(n_groups, -1).to(torch.int32))
    return RoutedGroups(groups, real, r, stat, capacity, t_total)


def add_shared_experts(params, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """y + the always-on shared SwiGLU expert(s) on x."""
    gshared = unified_linear(x, params["shared_wg"], activation="silu")
    ushared = unified_linear(x, params["shared_wu"])
    return y + unified_linear((gshared * ushared).to(x.dtype),
                              params["shared_wd"])


def apply_moe(params, cfg: MoEConfig, x: torch.Tensor, task_id=0,
              return_stats: bool = False):
    """x: (..., T, d) -> (y, aux_loss[, counts]).

    ``task_id`` is a scalar (one gating network for the call) or a 1-D
    vector of per-sequence tasks matching x's leading dim.
    ``return_stats`` adds the per-expert dispatch counts summed over groups:
    (E,), or (num_tasks, E) for a task vector.
    """
    if cfg.impl != "grouped":
        raise NotImplementedError(
            f"MoE impl {cfg.impl!r} is not ported yet: the port serves "
            "'grouped' (onehot and ep_local come with the distribution "
            "slice)")
    d = x.shape[-1]
    rt = route_groups(params, cfg, x, task_id)
    r = rt.routing
    group_sizes = R.dispatch_counts(r, cfg.num_experts)      # (G, E)

    from repro_torch.ops.registry import dispatch as op_dispatch

    y = op_dispatch("moe_ffn", rt.groups,
                    {k: params[k] for k in expert_param_names(cfg)},
                    r, group_sizes, cfg=cfg, capacity=rt.capacity)
    aux = R.load_balance_loss(r.probs, r.expert, cfg.num_experts,
                              mask=rt.real)
    y = y.to(x.dtype).reshape(-1, d)[:rt.t_total].reshape(x.shape)

    if cfg.num_shared_experts:
        y = add_shared_experts(params, x, y)
    if return_stats:
        counts = rt.stat.sum(dim=0, dtype=torch.int32)
        if _is_task_vector(task_id):
            counts = counts.reshape(-1, cfg.num_experts)
        return y, aux.mean(), counts
    return y, aux.mean()
