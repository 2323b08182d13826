"""The block stack, the port of ``repro.models.transformer`` for the
encoder families without state (the M³ViT trunk).

Layers are grouped into periods (one cycle of ``cfg.block_pattern``);
parameters under ``layers`` are stacked with a leading ``n_periods`` axis,
as in the reference, and a Python loop indexes period ``p`` where the
reference runs ``lax.scan``.  A remainder of ``num_layers % period``
layers lives under ``rest``.  KV caches, decode and recurrent blocks follow
with the LM slice.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import moe as moe_lib
from repro_torch.models import layers as L
from repro_torch.ops.policy import use_policy
from repro_torch.tree import index

__all__ = ["init_params", "forward", "moe_config"]


def moe_config(cfg: ArchConfig) -> moe_lib.MoEConfig:
    spec = cfg.moe
    return moe_lib.MoEConfig(
        d_model=cfg.d_model,
        d_ff=spec.d_ff,
        num_experts=spec.num_experts,
        top_k=spec.top_k,
        num_tasks=max(spec.num_tasks, cfg.num_tasks),
        expert_kind="swiglu" if cfg.mlp_kind in ("swiglu",) else "gelu",
        num_shared_experts=spec.num_shared_experts,
        capacity_factor=spec.capacity_factor,
        group_size=spec.group_size,
        impl=spec.impl,
        renormalize=spec.renormalize,
    )


def _init_block(rng: np.random.Generator, kind: str, cfg: ArchConfig,
                dtype):
    if kind not in ("attn_mlp", "attn_moe"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    p = {"ln1": L.init_norm(cfg), "attn": L.init_attention(rng, cfg, dtype),
         "ln2": L.init_norm(cfg)}
    if kind == "attn_moe":
        p["moe"] = moe_lib.init_moe(rng, moe_config(cfg), dtype)
    else:
        p["mlp"] = L.init_mlp(rng, cfg, dtype)
    return p


def init_params(rng: np.random.Generator, cfg: ArchConfig, dtype=None):
    """Nested parameter tree with the reference's keys and stacked layout
    (values from ``rng``, not the reference's JAX keys); on the CPU."""
    dtype = dtype or cfg.activation_dtype
    n_scan = cfg.num_layers // cfg.period
    n_rest = cfg.num_layers % cfg.period
    params = {"final_norm": L.init_norm(cfg)}
    if n_scan:
        periods = [{f"b{i}": _init_block(rng, cfg.block_pattern[i], cfg,
                                         dtype)
                    for i in range(cfg.period)} for _ in range(n_scan)]
        params["layers"] = _stack(periods)
    if n_rest:
        params["rest"] = {str(i): _init_block(
            rng, cfg.block_pattern[i % cfg.period], cfg, dtype)
            for i in range(n_rest)}
    return params


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _apply_block(kind: str, params, x, cfg: ArchConfig, *, task_id,
                 counts_shape=(0,)):
    """Returns (x, aux, counts); ``counts`` is the per-expert dispatch count
    tensor (zeros for dense blocks); ``counts_shape=(0,)`` disables it."""
    aux = torch.zeros((), device=x.device)
    counts = torch.zeros(counts_shape, dtype=torch.int32, device=x.device)
    if kind not in ("attn_mlp", "attn_moe"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    h = L.apply_norm(params["ln1"], x, cfg)
    x = x + L.apply_attention(params["attn"], h, cfg,
                              causal=cfg.family != "vit-moe")
    h = L.apply_norm(params["ln2"], x, cfg)
    if kind == "attn_moe":
        if counts_shape != (0,):
            y, aux, counts = moe_lib.apply_moe(
                params["moe"], moe_config(cfg), h, task_id=task_id,
                return_stats=True)
        else:
            y, aux = moe_lib.apply_moe(params["moe"], moe_config(cfg), h,
                                       task_id=task_id)
    else:
        y = L.apply_mlp(params["mlp"], h, cfg)
    return x + y, aux, counts


def forward(params, inputs, cfg: ArchConfig, *, task_id=0,
            return_expert_counts: bool = False):
    """inputs: embeddings (B, S, d); params: the nested tree.

    Returns (features, None, aux_loss) — the reference's (logits, state,
    aux) with no state — plus the per-expert dispatch counts summed over
    the MoE layers when ``return_expert_counts``.  ``cfg.policy`` (when
    set) is scoped around the whole pass.
    """
    with use_policy(cfg.policy):
        return _forward(params, inputs, cfg, task_id=task_id,
                        return_expert_counts=return_expert_counts)


def _forward(params, inputs, cfg: ArchConfig, *, task_id=0,
             return_expert_counts: bool = False):
    if cfg.rope != "none" or cfg.vocab_size:
        raise NotImplementedError("positional encodings and LM heads come "
                                  "with the LM slice of the port")
    x = L.embed_inputs(inputs, cfg)
    n_scan = cfg.num_layers // cfg.period
    counts_shape = (0,)
    if return_expert_counts and cfg.moe is not None:
        mc = moe_config(cfg)
        task_vec = moe_lib._is_task_vector(task_id)
        counts_shape = ((mc.num_tasks, mc.num_experts) if task_vec
                        else (mc.num_experts,))
    aux_total = torch.zeros((), device=x.device)
    counts_total = torch.zeros(counts_shape, dtype=torch.int32,
                               device=x.device)
    blocks = []
    for p in range(n_scan):
        period = index(params["layers"], p)
        blocks += [(cfg.block_pattern[i], period[f"b{i}"])
                   for i in range(cfg.period)]
    rest = params.get("rest", {})
    blocks += [(cfg.block_pattern[i % cfg.period], rest[str(i)])
               for i in range(len(rest))]
    for kind, bparams in blocks:
        x, aux, cnt = _apply_block(kind, bparams, x, cfg, task_id=task_id,
                                   counts_shape=counts_shape)
        aux_total = aux_total + aux
        counts_total = counts_total + cnt
    x = L.apply_norm(params["final_norm"], x, cfg)
    if return_expert_counts:
        return x, None, aux_total, counts_total
    return x, None, aux_total
