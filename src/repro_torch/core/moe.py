"""Mixture-of-Experts layer with multi-task gating (Edge-MoE §IV-D + §IV-F),
the port of ``repro.core.moe`` with ``impl="grouped"``, ``impl="onehot"``
and ``impl="ep_local"``.  The first two run the gather into per-expert
queues: the
reference's one-hot einsums build the same queues bit for bit (they exist
to lower to plain dots under GSPMD), and their combine differs only in
how a token's k slots are summed (not at all at top-1, Llama-4-Scout's
routing).

Tokens are cut into routing groups of ``group_size`` (zero-padded up to a
multiple); each group is routed on its own, exactly as the reference does
per group.  The reference ``vmap``s the group; here every stage carries
the group axis, so the expert GEMMs of all groups of a layer run as one
``moe_grouped_gemm`` dispatch per projection — one kernel launch on the
card.  Multi-task gating: the gate table has a leading task axis and the
active task is an index into it (a scalar task), or each sequence picks
its own row (a per-sequence task vector).

``impl="ep_local"`` is explicit expert parallelism over the ``model`` axis
of the active sharding rules' mesh (:func:`apply_moe_ep_local`); without a
mesh it serves as ``grouped``, as the reference's does.  Under a data
split of the batch (``dist.spmd.batch_split``) ``grouped`` and ``onehot``
route the whole batch's groups from all-gathered router logits and run
only this rank's tokens (:func:`route_split`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import routing as R
from repro_torch.core.unified_linear import unified_linear
from repro_torch.roofline.scope import scope

__all__ = ["MoEConfig", "init_moe", "apply_moe", "apply_moe_ep_local",
           "group_shape", "expert_param_names", "route_groups",
           "route_split", "RoutedGroups", "add_shared_experts",
           "replace_impl"]


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
    impl: str = "grouped"          # "grouped" | "onehot" | "ep_local"
    renormalize: bool = True

    def capacity(self, tokens_per_group: int) -> int:
        c = int(tokens_per_group * self.top_k * self.capacity_factor
                / self.num_experts) + 1
        return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def normal(rng, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """Seeded N(0, 1)·scale in float32, cast to ``dtype``: drawn by a NumPy
    generator on the CPU, or by a ``torch.Generator`` on its own device
    (the same shapes, scales and dtypes; other values).  A
    ``torch.device`` in ``rng``'s place makes an empty tensor there: the
    shape-only build on ``meta``."""
    if isinstance(rng, torch.device):
        return torch.empty(shape, dtype=dtype, device=rng)
    if isinstance(rng, torch.Generator):
        a = torch.randn(shape, generator=rng, device=rng.device)
        return (a * np.float32(scale)).to(dtype)
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
    # (G,) per-group auxiliary loss where the routing had to compute it
    # (:func:`route_split`: the whole batch's groups); None: the caller
    # computes it from ``routing`` and ``real``
    aux: Optional[torch.Tensor] = None


def _token_tasks(task_id, t_total: int, t_pad: int, dev):
    """Each token's task (t_pad,) for a per-sequence task vector, pads
    given task 0; None for a scalar task."""
    if not _is_task_vector(task_id):
        return None
    tv = torch.as_tensor(task_id, dtype=torch.long, device=dev)
    task_vec = tv.repeat_interleave(t_total // tv.shape[0])
    if t_pad != t_total:
        task_vec = torch.cat([task_vec, task_vec.new_zeros(t_pad - t_total)])
    return task_vec


def _logits(params, cfg: MoEConfig, xf: torch.Tensor, task_id,
            task_groups: Optional[torch.Tensor]) -> torch.Tensor:
    """The float32 gating logits (G, g, E) of ``xf`` (G, g, d) float32:
    the scalar task's gate, or each token's own (``task_groups`` (G, g)).
    A token's logits depend on its row alone (:func:`_gate_logits`)."""
    gate_w = params["gate"]
    gate_b = params.get("gate_bias")
    if task_groups is None:
        if gate_w.dim() == 3:   # (tasks, d, E): the §IV-F pointer switch
            gate_w = gate_w[int(task_id)]
            if gate_b is not None and gate_b.dim() == 2:
                gate_b = gate_b[int(task_id)]
        logits = _gate_logits(xf, gate_w)
        if gate_b is not None:
            logits = logits + gate_b.float()
        return logits
    # every task's gate, then select per token
    n_groups, g = task_groups.shape
    all_logits = _gate_logits(xf, gate_w)
    logits = torch.gather(
        all_logits, 2,
        task_groups[:, :, None, None].expand(
            n_groups, g, 1, cfg.num_experts))[:, :, 0]
    if gate_b is not None:
        logits = logits + gate_b[task_groups].float()
    return logits


def _route(params, cfg: MoEConfig, logits: torch.Tensor, capacity: int,
           real: Optional[torch.Tensor], task_groups):
    """Top-k and capacity per group, and the per-expert dispatch counts
    with pad rows excluded — rows are experts, or (task, expert) pairs for
    a per-sequence task vector."""
    n_groups = logits.shape[0]
    gate_w = params["gate"]
    n_stat_tasks = gate_w.shape[0] if gate_w.dim() == 3 else 1
    r = R.route(logits, cfg.top_k, capacity, renormalize=cfg.renormalize)
    stat_valid = r.valid if real is None else r.valid & real[..., None]
    stat_idx = r.expert.reshape(n_groups, -1).long()
    n_rows = cfg.num_experts
    if task_groups is not None:   # (tasks, E): per-task router usage
        stat_idx = stat_idx + cfg.num_experts * \
            task_groups.repeat_interleave(cfg.top_k, dim=-1)
        n_rows = n_stat_tasks * cfg.num_experts
    stat = torch.zeros((n_groups, n_rows), dtype=torch.int32,
                       device=logits.device)
    stat.scatter_add_(-1, stat_idx,
                      stat_valid.reshape(n_groups, -1).to(torch.int32))
    return r, stat


def _pad_mask(t_total: int, t_pad: int, g: int, dev):
    """(G, g) bool: True for a real token; None where nothing is padded."""
    if t_pad == t_total:
        return None
    return (torch.arange(t_pad, device=dev) < t_total).reshape(t_pad // g, g)


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
    real = _pad_mask(t_total, t_pad, g, dev)  # pads: out of aux + stats
    if t_pad != t_total:
        flat = torch.cat([flat, flat.new_zeros((t_pad - t_total, d))])
    groups = flat.reshape(n_groups, g, d)
    capacity = cfg.capacity(g)
    tasks = _token_tasks(task_id, t_total, t_pad, dev)
    task_groups = None if tasks is None else tasks.reshape(n_groups, g)
    logits = _logits(params, cfg, groups.float(), task_id, task_groups)
    r, stat = _route(params, cfg, logits, capacity, real, task_groups)
    return RoutedGroups(groups, real, r, stat, capacity, t_total)


def route_split(params, cfg: MoEConfig, x: torch.Tensor, task_id, rules,
                n: int) -> RoutedGroups:
    """:func:`route_groups` for this rank's rows ``x`` of a batch of ``n``
    that the batch axes split (the forward runs under
    ``dist.spmd.batch_split``): the whole batch's routing groups, with
    their capacity and queue order, as one device routes them, and this
    rank's tokens only in the queues.

    Each rank gates its own tokens and all-gathers the float32 logits
    over the batch axes (a recorded collective of E floats a token, never
    the tokens): every rank then routes the whole batch exactly as
    :func:`route_groups` does — top-k, capacity drops, the dispatch counts
    and the auxiliary loss are the whole batch's, the same on every rank.
    Its own slots keep the validity the whole group gave them; they queue
    in one local group, the kept slots of each expert in token order, so
    the queues hold ``capacity`` rows for each routing group this rank's
    tokens touch.  A token's expert rows and its k-slot combine are those
    of the unsplit layer, so the layer's output rows are its bits."""
    from repro_torch.dist import spmd

    d = x.shape[-1]
    dev = x.device
    flat = x.reshape(-1, d)
    t_loc = flat.shape[0]
    shards, index, _ = spmd.batch_shard(n, rules)
    tok0, t_total = index * t_loc, shards * t_loc
    g, t_pad = group_shape(t_total, cfg.group_size)
    n_groups = t_pad // g
    e = cfg.num_experts
    # this rank's tokens' logits (the task vector is this rank's rows')
    tasks_loc = _token_tasks(task_id, t_loc, t_loc, dev)
    logits = _logits(params, cfg, flat[None].float(), task_id,
                     None if tasks_loc is None else tasks_loc[None])[0]
    logits = spmd.gather_batch(logits, rules, n, "moe gate logits")
    tasks = None
    if tasks_loc is not None:
        tasks = spmd.gather_batch(tasks_loc, rules, n, "moe task ids")
    if t_pad != t_total:      # pad rows: the logits of a zero row, task 0
        pad = t_pad - t_total
        pad_tasks = None
        if tasks is not None:
            pad_tasks = tasks.new_zeros(pad)
            tasks = torch.cat([tasks, pad_tasks])
            pad_tasks = pad_tasks[None]
        logits = torch.cat([logits, _logits(
            params, cfg, flat.new_zeros((1, pad, d), dtype=torch.float32),
            task_id, pad_tasks)[0]])
    real = _pad_mask(t_total, t_pad, g, dev)
    task_groups = None if tasks is None else tasks.reshape(n_groups, g)
    capacity = cfg.capacity(g)
    r, stat = _route(params, cfg, logits.reshape(n_groups, g, e), capacity,
                     real, task_groups)
    aux = R.load_balance_loss(r.probs, r.expert, e, mask=real)

    def mine(t):
        return t.reshape((t_pad,) + t.shape[2:])[tok0:tok0 + t_loc][None]

    expert, gate, valid, probs = map(mine, (r.expert, r.gate, r.valid,
                                            r.probs))
    # local queue rows: each expert's kept slots in token order (a
    # dropped slot is counted under a spare expert id, so it takes none)
    position, _ = R.build_dispatch(torch.where(valid, expert, e), e + 1, 0)
    pieces = (tok0 + t_loc - 1) // g - tok0 // g + 1
    return RoutedGroups(flat[None], None,
                        R.Routing(expert, gate, position, valid, probs),
                        stat, pieces * capacity, t_loc, aux)


def add_shared_experts(params, x: torch.Tensor, y: torch.Tensor,
                       cfg: Optional[MoEConfig] = None) -> torch.Tensor:
    """y + the always-on shared SwiGLU expert(s) on x.  Where a rank holds
    a block of their hidden columns (``cfg`` gives the whole width;
    tensor-parallel serving, ``models/layers.py``), the column blocks of
    ``shared_wg``/``shared_wu`` and the row block of ``shared_wd`` give
    float32 partials, added over ``model`` before the one rounding."""
    fs = params["shared_wd"].shape[0]
    split = cfg is not None and fs != cfg.d_ff * cfg.num_shared_experts
    order = cfg.d_ff * cfg.num_shared_experts if split else None
    if split:
        from repro_torch.dist import spmd

        x = spmd.model_input(x, "moe_shared input")
    gshared = unified_linear(x, params["shared_wg"], activation="silu",
                             order_n=order)
    ushared = unified_linear(x, params["shared_wu"], order_n=order)
    h = (gshared * ushared).to(x.dtype)
    if not split:
        return y + unified_linear(h, params["shared_wd"])
    from repro_torch.dist import spmd

    part = unified_linear(h, params["shared_wd"], out_dtype=torch.float32)
    return y + spmd.model_sum(part, "moe_shared all-reduce").to(x.dtype)


def replace_impl(cfg: MoEConfig, impl: str) -> MoEConfig:
    from dataclasses import replace

    return replace(cfg, impl=impl)


def apply_moe(params, cfg: MoEConfig, x: torch.Tensor, task_id=0,
              return_stats: bool = False):
    """x: (..., T, d) -> (y, aux_loss[, counts]).

    ``task_id`` is a scalar (one gating network for the call) or a 1-D
    vector of per-sequence tasks matching x's leading dim.
    ``return_stats`` adds the per-expert dispatch counts summed over groups:
    (E,), or (num_tasks, E) for a task vector.
    """
    if cfg.impl == "ep_local":
        from repro_torch.dist.sharding import axis_names, current_rules

        rules = current_rules()
        if rules is not None and rules.mesh is not None \
                and "model" in axis_names(rules.mesh):
            out = apply_moe_ep_local(params, cfg, x, rules.mesh,
                                     task_id=task_id)
            if return_stats:  # ep_local keeps counts shard-local
                return out + (torch.zeros((cfg.num_experts,),
                                          dtype=torch.int32,
                                          device=x.device),)
            return out
        cfg = replace_impl(cfg, "grouped")   # no mesh: one device
    if cfg.impl not in ("grouped", "onehot"):
        raise ValueError(f"unknown MoE impl {cfg.impl!r} (expected "
                         "grouped | onehot | ep_local)")
    from repro_torch.dist import spmd

    split = spmd.current_split()
    d = x.shape[-1]
    with scope("moe_gate"):
        rt = route_groups(params, cfg, x, task_id) if split is None else \
            route_split(params, cfg, x, task_id, *split)
        r = rt.routing
        group_sizes = R.dispatch_counts(r, cfg.num_experts)      # (G, E)

    from repro_torch.ops.registry import dispatch as op_dispatch

    with scope("moe_ffn"):      # the staged impl opens its stages' own
        y = op_dispatch("moe_ffn", rt.groups,
                        {k: params[k] for k in expert_param_names(cfg)},
                        r, group_sizes, cfg=cfg, capacity=rt.capacity)
    with scope("moe_aux"):
        aux = rt.aux if rt.aux is not None else R.load_balance_loss(
            r.probs, r.expert, cfg.num_experts, mask=rt.real)
    y = y.to(x.dtype).reshape(-1, d)[:rt.t_total].reshape(x.shape)

    if cfg.num_shared_experts:
        with scope("moe_shared"):
            y = add_shared_experts(params, x, y, cfg)
    if return_stats:
        counts = rt.stat.sum(dim=0, dtype=torch.int32)
        if _is_task_vector(task_id):
            counts = counts.reshape(-1, cfg.num_experts)
        return y, aux.mean(), counts
    return y, aux.mean()


def _local_experts(w, e_lo: int, e_local: int):
    """This rank's ``e_local`` experts of an expert leaf: a full stack is
    narrowed; a stack already ``e_local`` long (the serving engines keep
    only their own) is taken as it is."""
    return w if w.shape[0] == e_local else w[e_lo:e_lo + e_local]


def apply_moe_ep_local(params, cfg: MoEConfig, x: torch.Tensor, mesh,
                       task_id=0):
    """Explicit expert parallelism over the mesh's ``model`` axis.

    Experts are sharded over ``model``: each rank keeps E/|model| of them
    resident.  Tokens are the rank's local rows (batch-sharded over the
    data axes, the same on every rank of a ``model`` group).  Each rank
    routes its tokens (the gate is replicated), keeps the slots that chose
    one of its experts, runs ``_expert_ffn`` on them (``moe_gemm`` under
    ``cuda``), and combines its partial output; one all-reduce over
    ``model`` sums the partials, and the auxiliary loss is averaged over
    the batch axes.  The partials stay float32 until that sum (the
    reference sums them in the activation dtype): rounded once, they give
    ``grouped``'s bits on one shard and its float32 sum in another order
    on several.  Scalar tasks only.

    The layer trains: the ranks of a ``model`` group hold the same loss,
    so the combine's all-reduce passes its gradient through, and the
    tokens and gate weights each rank's experts read are marked with
    ``spmd.copy_to`` (their gradients, each from this rank's experts
    only, summed over ``model``).  An expert's gradient is then the
    one-device gradient, and so are the router's and the input's.
    """
    from repro_torch.dist.spmd import (all_reduce, axis_index, axis_size,
                                       copy_to)

    if _is_task_vector(task_id):
        raise ValueError("ep_local serves a scalar task (the reference's "
                         "shard_map path takes one gating network)")
    tp = axis_size(mesh, "model")
    if cfg.num_experts % tp:
        raise ValueError(f"E={cfg.num_experts} must divide the {tp}-way "
                         "model axis")
    e_local = cfg.num_experts // tp
    e_lo = axis_index(mesh, "model") * e_local
    # the gate alone: the reference's shard_map path reads no gate_bias
    router = {"gate": params["gate"]}
    ew = {k: _local_experts(params[k], e_lo, e_local)
          for k in expert_param_names(cfg)}
    d = x.shape[-1]
    with scope("moe_gate"):
        rt = route_groups(router, cfg, x, int(task_id))
        r = rt.routing
    with scope("moe_dispatch"):
        # local queues: only the slots owned by this rank's experts
        local = (r.expert >= e_lo) & (r.expert < e_lo + e_local)
        r_loc = R.Routing(
            expert=torch.where(local, r.expert - e_lo, 0).to(torch.int32),
            gate=copy_to(r.gate, mesh, "model", "moe ep_local gate"),
            position=r.position, valid=r.valid & local, probs=r.probs)
        sizes = R.dispatch_counts(r_loc, e_local)
        buf = R.dispatch(copy_to(rt.groups, mesh, "model",
                                 "moe ep_local tokens"),
                         r_loc, e_local, rt.capacity)
    with scope("moe_ffn"):
        out = _expert_ffn(ew, cfg, buf, sizes)
    with scope("moe_combine"):
        # the full combine: every expert shard's float32 partial summed,
        # then one rounding to the activation dtype
        y = all_reduce(R.combine_partial(out, r_loc), mesh, "model",
                       "moe ep_local combine")
    with scope("moe_aux"):
        aux = R.load_balance_loss(r.probs, r.expert, cfg.num_experts,
                                  mask=rt.real).mean()
        for ax in ("pod", "data"):     # aux is per data shard
            if axis_size(mesh, ax) > 1:
                aux = all_reduce(aux, mesh, ax, "moe ep_local aux",
                                 op="mean")
    y = y.to(x.dtype).reshape(-1, d)[:rt.t_total].reshape(x.shape)
    if cfg.num_shared_experts:
        with scope("moe_shared"):
            y = add_shared_experts(params, x, y, cfg)
    return y, aux
