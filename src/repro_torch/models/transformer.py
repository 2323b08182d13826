"""The block stack, the port of ``repro.models.transformer`` for the
families without recurrent state: the M³ViT trunk and dense / MoE decoder
LMs (attention blocks, windowed local attention).

Layers are grouped into periods (one cycle of ``cfg.block_pattern``);
parameters and decode states under ``layers`` are stacked with a leading
``n_periods`` axis, as in the reference, and a Python loop indexes period
``p`` where the reference runs ``lax.scan``.  A remainder of
``num_layers % period`` layers lives under ``rest`` (keyed "0", "1", … as
in the dotted-name trees).  The same :func:`forward` serves a full pass,
prefill into a state and one-token decode; KV caches are written in place.
The recurrent blocks (mLSTM, sLSTM, RG-LRU) follow with their slice.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import moe as moe_lib
from repro_torch.models import layers as L
from repro_torch.ops.policy import use_policy
from repro_torch.tree import index

__all__ = ["init_params", "forward", "init_state", "moe_config"]

_ATTN_KINDS = ("attn_mlp", "attn_moe", "attn_local_mlp")


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


def _check_kind(kind: str) -> None:
    if kind not in _ATTN_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  "(recurrent blocks come with their slice)")


def _init_block(rng: np.random.Generator, kind: str, cfg: ArchConfig,
                dtype):
    _check_kind(kind)
    p = {"ln1": L.init_norm(cfg), "attn": L.init_attention(rng, cfg, dtype),
         "ln2": L.init_norm(cfg)}
    if kind == "attn_moe":
        p["moe"] = moe_lib.init_moe(rng, moe_config(cfg), dtype)
    else:
        p["mlp"] = L.init_mlp(rng, cfg, dtype)
    return p


def _init_block_state(kind: str, cfg: ArchConfig, batch: int, max_len: int,
                      dtype, device):
    _check_kind(kind)
    if kind == "attn_local_mlp":
        # ring cache: windowed attention only reads the last `window`
        # positions, so the cache holds `window` slots (token t at t % window)
        max_len = min(max_len, cfg.window or max_len)
    return L.init_attn_cache(cfg, batch, max_len, dtype, device)


def init_params(rng: np.random.Generator, cfg: ArchConfig, dtype=None):
    """Nested parameter tree with the reference's keys and stacked layout
    (values from ``rng``, not the reference's JAX keys); on the CPU."""
    dtype = dtype or cfg.activation_dtype
    n_scan = cfg.num_layers // cfg.period
    n_rest = cfg.num_layers % cfg.period
    params = {"embed": L.init_embed(rng, cfg, dtype),
              "final_norm": L.init_norm(cfg),
              "head": L.init_lm_head(rng, cfg, dtype)}
    if n_scan:
        periods = [{f"b{i}": _init_block(rng, cfg.block_pattern[i], cfg,
                                         dtype)
                    for i in range(cfg.period)} for _ in range(n_scan)]
        params["layers"] = _stack(periods)
    if n_rest:
        params["rest"] = {str(i): _init_block(
            rng, cfg.block_pattern[i % cfg.period], cfg, dtype)
            for i in range(n_rest)}
    return {k: v for k, v in params.items() if v != {}}


def init_state(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """Decode/prefill state: KV caches stacked over the periods under
    ``layers``, per layer under ``rest``."""
    dtype = dtype or cfg.activation_dtype
    n_scan = cfg.num_layers // cfg.period
    n_rest = cfg.num_layers % cfg.period
    state = {}
    if n_scan:
        state["layers"] = _stack([
            {f"b{i}": _init_block_state(cfg.block_pattern[i], cfg, batch,
                                        max_len, dtype, device)
             for i in range(cfg.period)} for _ in range(n_scan)])
    if n_rest:
        state["rest"] = {str(i): _init_block_state(
            cfg.block_pattern[i % cfg.period], cfg, batch, max_len, dtype,
            device) for i in range(n_rest)}
    return state


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _apply_block(kind: str, params, x, cfg: ArchConfig, *, pos, state,
                 cache_index, task_id, counts_shape=(0,)):
    """Returns (x, aux, counts); ``state`` (the block's KV cache, or None)
    is updated in place.  ``counts`` is the per-expert dispatch count
    tensor (zeros for dense blocks); ``counts_shape=(0,)`` disables it."""
    _check_kind(kind)
    aux = torch.zeros((), device=x.device)
    counts = torch.zeros(counts_shape, dtype=torch.int32, device=x.device)
    window = cfg.window if kind == "attn_local_mlp" else None
    h = L.apply_norm(params["ln1"], x, cfg)
    a, _ = L.apply_attention(params["attn"], h, cfg, pos=pos,
                             causal=cfg.family != "vit-moe", window=window,
                             cache=state, cache_index=cache_index)
    x = x + a
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


def forward(params, inputs, cfg: ArchConfig, *, pos=None, state=None,
            cache_index=None, decode=False, task_id=0, return_state=None,
            logits_mode: str = "all", return_expert_counts: bool = False):
    """inputs: tokens (B, S) int or embeddings (B, S, d); params: the
    nested tree.

    Returns (logits, state, aux_loss): float32 logits (the trunk's features
    when ``vocab_size == 0``), the state when one was passed (prefill /
    decode, its caches written in place) or ``return_state`` forces it.
    ``logits_mode="last"`` applies the LM head to the final position only.
    ``cache_index`` is an int or a (B,) tensor (continuous batching: each
    slot at its own position).  Attention blocks decode whenever a state,
    a cache index and one token are given; ``decode=True`` states that this
    is such a step and raises if it is not.  ``return_expert_counts``
    appends the per-expert dispatch counts summed over the MoE layers.
    ``cfg.policy`` (when set) is scoped around the whole pass.
    """
    if decode and (state is None or cache_index is None
                   or inputs.shape[1] != 1):
        raise ValueError("decode=True is a one-token step: it needs a state, "
                         f"a cache_index and S == 1 (got S={inputs.shape[1]})")
    with use_policy(cfg.policy):
        return _forward(params, inputs, cfg, pos=pos, state=state,
                        cache_index=cache_index, task_id=task_id,
                        return_state=return_state, logits_mode=logits_mode,
                        return_expert_counts=return_expert_counts)


def _positions(b, s, cache_index, device):
    off = 0 if cache_index is None else cache_index
    pos = torch.arange(s, device=device)[None, :]
    if isinstance(off, torch.Tensor):
        off = off.to(device)
        pos = pos + (off[:, None] if off.dim() == 1 else off)
    else:
        pos = pos + int(off)
    return pos.expand(b, s)


def _forward(params, inputs, cfg: ArchConfig, *, pos=None, state=None,
             cache_index=None, task_id=0, return_state=None,
             logits_mode: str = "all", return_expert_counts: bool = False):
    embed = params.get("embed", {})
    x = L.embed_inputs(embed, inputs, cfg)
    b, s = x.shape[0], x.shape[1]
    if pos is None and cfg.rope in ("rope", "mrope"):
        pos = _positions(b, s, cache_index, x.device)
    x = L.position_encode(x, cfg, offset=0 if cache_index is None
                          else cache_index)
    want_state = state is not None if return_state is None else return_state
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
    blocks = []   # (kind, params, cache or None)
    for p in range(n_scan):
        pparams = index(params["layers"], p)
        pstate = index(state["layers"], p) if state is not None else None
        blocks += [(cfg.block_pattern[i], pparams[f"b{i}"],
                    pstate[f"b{i}"] if pstate is not None else None)
                   for i in range(cfg.period)]
    rest = params.get("rest", {})
    for i in range(len(rest)):
        st = state["rest"][str(i)] if state is not None else None
        blocks.append((cfg.block_pattern[i % cfg.period], rest[str(i)], st))
    for kind, bparams, bstate in blocks:
        x, aux, cnt = _apply_block(kind, bparams, x, cfg, pos=pos,
                                   state=bstate, cache_index=cache_index,
                                   task_id=task_id,
                                   counts_shape=counts_shape)
        aux_total = aux_total + aux
        counts_total = counts_total + cnt
    x = L.apply_norm(params["final_norm"], x, cfg)
    if logits_mode == "last":
        x = x[:, -1:]
    logits = L.apply_lm_head(params.get("head", {}), embed, x, cfg)
    out_state = (state if state is not None else {}) if want_state else None
    if return_expert_counts:
        return logits, out_state, aux_total, counts_total
    return logits, out_state, aux_total
