"""The block stack, the port of ``repro.models.transformer``: the M³ViT
trunk, dense / MoE decoder LMs (attention blocks, windowed local
attention) and the recurrent families (mLSTM, sLSTM, RG-LRU blocks).

Layers are grouped into periods (one cycle of ``cfg.block_pattern``);
parameters and decode states under ``layers`` are stacked with a leading
``n_periods`` axis, as in the reference, and a Python loop indexes period
``p`` where the reference runs ``lax.scan``.  A remainder of
``num_layers % period`` layers lives under ``rest`` (keyed "0", "1", … as
in the dotted-name trees).  The same :func:`forward` serves a full pass,
prefill into a state and one-token decode; KV caches and recurrent states
are written in place.
"""

from __future__ import annotations

import re

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import moe as moe_lib
from repro_torch.dist.sharding import (P, _axes, axis_sizes, constrain,
                                      model_spec, param_sharding_rules,
                                      shard_leaf)
from repro_torch.dist.spmd import axis_size, gather_param
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as XL
from repro_torch.ops.policy import use_policy
from repro_torch.roofline.scope import scope
from repro_torch.tree import flatten, index

__all__ = ["init_params", "forward", "init_state", "moe_config",
           "model_blocks", "leaf_block", "computed_shape",
           "cache_kv_heads", "state_blocks"]

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


def _init_block(rng, kind: str, cfg: ArchConfig, dtype):
    if kind == "mlstm":
        return {"ln": L.init_norm(cfg), "mlstm": XL.init_mlstm(rng, cfg,
                                                                dtype)}
    if kind == "slstm":
        return {"ln": L.init_norm(cfg), "slstm": XL.init_slstm(rng, cfg,
                                                                dtype)}
    if kind == "rglru_mlp":
        return {"ln1": L.init_norm(cfg),
                "rglru": RG.init_rglru(rng, cfg, dtype),
                "ln2": L.init_norm(cfg), "mlp": L.init_mlp(rng, cfg, dtype)}
    if kind not in _ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind}")
    p = {"ln1": L.init_norm(cfg), "attn": L.init_attention(rng, cfg, dtype),
         "ln2": L.init_norm(cfg)}
    if kind == "attn_moe":
        p["moe"] = moe_lib.init_moe(rng, moe_config(cfg), dtype)
    else:
        p["mlp"] = L.init_mlp(rng, cfg, dtype)
    return p


def _init_block_state(kind: str, cfg: ArchConfig, batch: int, max_len: int,
                      dtype, device, kv_heads=None, lru_width=None,
                      xlstm_heads=None):
    if kind == "mlstm":
        return XL.init_mlstm_state(cfg, batch, device, xlstm_heads)
    if kind == "slstm":
        return XL.init_slstm_state(cfg, batch, device, xlstm_heads)
    if kind == "rglru_mlp":
        return RG.init_rglru_state(cfg, batch, device, lru_width)
    if kind not in _ATTN_KINDS:
        raise ValueError(kind)
    if kind == "attn_local_mlp":
        # ring cache: windowed attention only reads the last `window`
        # positions, so the cache holds `window` slots (token t at t % window)
        max_len = min(max_len, cfg.window or max_len)
    return L.init_attn_cache(cfg, batch, max_len, dtype, device, kv_heads)


def _kept(tree, prefix: str, keep):
    """``tree`` with ``keep(dotted name, leaf)`` applied to every leaf."""
    if keep is None:
        return tree
    if isinstance(tree, dict):
        return {k: _kept(v, f"{prefix}{k}.", keep) for k, v in tree.items()}
    return keep(prefix[:-1], tree)


def init_params(rng, cfg: ArchConfig, dtype=None, keep=None):
    """Nested parameter tree with the reference's keys and stacked layout
    (values from ``rng``, not the reference's JAX keys): a NumPy generator
    draws on the CPU, a ``torch.Generator`` on its device.  ``keep(dotted
    name, leaf)``, where given, takes each leaf as it is drawn (a layer's
    leaf without its period dim) and returns what the tree holds — a
    rank's block — so the whole model never exists at once; the draws
    consume ``rng`` in the same order either way."""
    dtype = dtype or cfg.activation_dtype
    n_scan = cfg.num_layers // cfg.period
    n_rest = cfg.num_layers % cfg.period
    params = {"embed": _kept(L.init_embed(rng, cfg, dtype), "embed.", keep),
              "final_norm": L.init_norm(cfg),
              "head": _kept(L.init_lm_head(rng, cfg, dtype), "head.", keep)}
    if n_scan:
        stacked = None
        for p in range(n_scan):
            period = _kept({f"b{i}": _init_block(rng, cfg.block_pattern[i],
                                                 cfg, dtype)
                            for i in range(cfg.period)}, "layers.", keep)
            if stacked is None:
                stacked = _empty_stack(period, n_scan)
            _put(stacked, period, p)
        params["layers"] = stacked
    if n_rest:
        params["rest"] = {str(i): _kept(_init_block(
            rng, cfg.block_pattern[i % cfg.period], cfg, dtype),
            f"rest.{i}.", keep) for i in range(n_rest)}
    return {k: v for k, v in params.items() if v != {}}


def init_state(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device=None, params=None, gather=None):
    """Decode/prefill state: KV caches and recurrent states stacked over
    the periods under ``layers``, per layer under ``rest``.  ``params``:
    the flat leaves a rank holds, whose blocks the state follows
    (:func:`state_blocks`, through ``gather`` where the forward gathers
    them; default: the whole model's)."""
    dtype = dtype or cfg.activation_dtype
    blocks = state_blocks(params, cfg, gather) if params is not None \
        else {}
    n_scan = cfg.num_layers // cfg.period
    n_rest = cfg.num_layers % cfg.period
    state = {}
    if n_scan:
        state["layers"] = _stack([
            {f"b{i}": _init_block_state(cfg.block_pattern[i], cfg, batch,
                                        max_len, dtype, device, **blocks)
             for i in range(cfg.period)} for _ in range(n_scan)])
    if n_rest:
        state["rest"] = {str(i): _init_block_state(
            cfg.block_pattern[i % cfg.period], cfg, batch, max_len, dtype,
            device, **blocks) for i in range(n_rest)}
    return state


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _empty_stack(tree, n: int):
    """An uninitialised stack of ``n`` trees shaped like ``tree``."""
    if isinstance(tree, dict):
        return {k: _empty_stack(v, n) for k, v in tree.items()}
    return tree.new_empty((n,) + tuple(tree.shape))


def _put(stacked, tree, p: int) -> None:
    """Copy ``tree`` into entry ``p`` of ``stacked`` (the entries then
    equal ``torch.stack``'s)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put(stacked[k], v, p)
        return
    stacked[p].copy_(tree)


_XLSTM = re.compile(r"(mlstm|slstm)/")
_RGLRU = re.compile(r"rglru/")
_ATTN_Q = re.compile(r"attn/(wq|bq|wo)$")
_ATTN_KV = re.compile(r"attn/(wk|wv|bk|bv)$")
_EXPERTS = re.compile(r"moe/(wg|wu|wd|w1|w2|b1|b2)$")


def model_blocks(cfg: ArchConfig, rules) -> dict:
    """{dotted name: spec of the whole (stacked) shape} of every leaf a
    rank computes on its block of over ``model`` under ``rules``
    (``dist.sharding.model_spec``), in serving (``serve/engine.py:
    local_params`` narrows them; the data axes stay whole there) and in
    training (``train/step.py:layout_for`` keeps them local over
    ``model`` and gathers them over the batch axes alone).  These are the
    leaves the reference's table splits over ``model``: attention (per
    :func:`layers.attention_layout`), the dense MLP, the shared experts,
    ``embed/tokens`` and ``head/w``, the RG-LRU mixers' leaves (per
    :func:`rglru.split_over`: ``w_up``/``w_up2``/``conv`` by columns,
    ``gates`` by heads, ``lam`` by channels, ``w_down`` by rows), the
    xLSTM mixers' leaves (per :func:`xlstm.split_over`: the mLSTM's
    ``w_up``/``w_gates``/``w_qkv``/``conv`` by columns — ``w_qkv`` in the
    table's contiguous block, gathered after the product — and ``w_down``
    by rows; the sLSTM's ``w_gates`` by columns and ``r_gates`` by heads,
    its ``w_up``/``w_up2``/``w_down`` only where the axis divides their
    ``4d/3``, as the trimmed table has it) and the expert stacks of an
    ``ep_local`` MoE (this rank's experts).  Left whole on every rank: an
    xLSTM mixer whose heads do not divide the axis, its ``w_if``,
    ``b_if``, ``b_gates`` and ``gn_scale`` (read by each rank for its
    heads: ``models/xlstm.py`` sums their gradients over ``model``), an
    RG-LRU mixer whose width or gate heads do not divide the axis, an
    attention layer whose heads do not, k/v where the KV heads do not
    (``layers.apply_attention`` sums their gradient over ``model``), and
    the expert stacks of the other MoE impls (every rank routes to every
    expert).  Empty without rules or where ``model`` has one rank."""
    tp = _model_size(rules)
    if tp == 1:
        return {}
    q_split, kv_split = L.attention_layout(cfg, tp)
    lru_split = RG.split_over(cfg, tp)
    xlstm_split = XL.split_over(cfg, tp)
    ep_local = cfg.moe is not None and cfg.moe.impl == "ep_local"
    shapes = flatten(init_params(torch.device("meta"), cfg))
    out = {}
    for name, sh in param_sharding_rules(shapes, rules).items():
        spec = model_spec(sh.spec)
        path = name.replace(".", "/")
        if "model" not in spec:
            continue
        if _XLSTM.search(path) and not xlstm_split:
            continue
        if _RGLRU.search(path) and not lru_split:
            continue
        if _ATTN_Q.search(path) and not q_split:
            continue
        if _ATTN_KV.search(path) and not kv_split:
            continue
        if _EXPERTS.search(path) and not ep_local:
            continue
        out[name] = spec
    return out


def _model_size(rules) -> int:
    """The ranks of ``model`` under ``rules`` (1 without a mesh)."""
    if rules is None or rules.mesh is None:
        return 1
    return axis_size(rules.mesh, "model")


def leaf_block(t, spec, mesh):
    """This rank's block of ``t`` (a whole leaf, or a layer's leaf without
    its period dim) under the stacked leaf's ``spec``, a tensor of its
    own."""
    return shard_leaf(t, P(*spec[len(spec) - t.dim():]), mesh)


def computed_shape(name: str, t, gather=None) -> tuple:
    """The shape a forward computes leaf ``name`` at: ``t``'s as held,
    times the axes ``gather`` (an FSDP layout: ``serve.engine.
    fsdp_gathers``) gathers it over, read from the leaf's spec, never
    from a dimension the data axes have also cut."""
    shape = list(t.shape)
    if gather is not None and name in gather.params:
        sizes, keep = axis_sizes(gather.mesh), gather.keep[name]
        for dim, entry in enumerate(gather.params[name]):
            for a in _axes(entry):
                if a not in keep:
                    shape[dim] *= sizes[a]
    return tuple(shape)


def cache_kv_heads(params: dict, cfg: ArchConfig, gather=None):
    """The KV heads a cache holds for the flat ``params`` a rank holds
    (computed at :func:`computed_shape` under ``gather``): its block
    where its attention computes on a block of the KV heads
    (tensor-parallel serving: the ``"cache"`` rule's head-sharded
    alternative), else None (all of them)."""
    for name, w in params.items():
        if name.endswith("attn.wk"):
            heads = computed_shape(name, w, gather)[-1] // cfg.hd
            return heads if heads != cfg.num_kv_heads else None
    return None


def state_blocks(params: dict, cfg: ArchConfig, gather=None) -> dict:
    """The blocks of a decode state for the flat ``params`` a rank holds
    (computed at :func:`computed_shape` under ``gather``): ``kv_heads``,
    its KV heads (:func:`cache_kv_heads`), ``lru_width``, its RG-LRU
    channels where its mixers compute on a block of ``rglru.w_up``'s
    columns, and ``xlstm_heads``, its mLSTM and sLSTM heads where its
    mixers compute on a block of them (``slstm.r_gates``' heads,
    ``mlstm.w_down``'s rows over the head width) under tensor
    parallelism; each None where the rank computes on them all."""
    width = heads = None
    for name, w in params.items():
        shape = computed_shape(name, w, gather)
        if name.endswith("rglru.w_up") and width is None:
            if shape[-1] != (cfg.lru_width or cfg.d_model):
                width = shape[-1]
        elif name.endswith("slstm.r_gates"):
            heads = shape[-3]
        elif name.endswith("mlstm.w_down"):
            heads = shape[-2] * cfg.num_heads // (2 * cfg.d_model)
    if heads == cfg.num_heads:
        heads = None
    return {"kv_heads": cache_kv_heads(params, cfg, gather),
            "lru_width": width, "xlstm_heads": heads}


def _gathered(tree, prefix: str, gather, lead: int):
    """``tree`` (the nested leaves under dotted ``prefix``) with each leaf
    ``gather`` holds as a block gathered to the shape the forward computes
    with (``dist.spmd.gather_param`` over the axes its layout does not
    keep; ``lead``: the stacked period dims indexed off the leaf), as
    tensors of their own, recorded as ``"fsdp gather"`` under the
    ``fsdp_gather`` scope.  ``tree`` as it is without ``gather``."""
    if gather is None:
        return tree
    if isinstance(tree, dict):
        return {k: _gathered(v, f"{prefix}{k}.", gather, lead)
                for k, v in tree.items()}
    name = prefix[:-1]
    spec = gather.params.get(name)
    if spec is None:
        return tree
    with torch.no_grad(), scope("fsdp_gather"):
        return gather_param(tree, P(*spec[lead:]), gather.mesh,
                            gather.keep[name], "fsdp gather")


def _apply_block(kind: str, params, x, cfg: ArchConfig, *, pos, state,
                 cache_index, decode, task_id, counts_shape=(0,)):
    """Returns (x, aux, counts); ``state`` (the block's KV cache or
    recurrent state, or None) is updated in place.  A recurrent block takes
    its one-step path when ``decode`` and S == 1, as the reference's does.
    ``counts`` is the per-expert dispatch count tensor (zeros for dense
    blocks); ``counts_shape=(0,)`` disables it."""
    aux = torch.zeros((), device=x.device)
    counts = torch.zeros(counts_shape, dtype=torch.int32, device=x.device)
    if kind in ("mlstm", "slstm"):
        apply = XL.apply_mlstm if kind == "mlstm" else XL.apply_slstm
        h = L.apply_norm(params["ln"], x, cfg)
        y, _ = apply(params[kind], h, cfg, state, decode)
        return constrain(x + y, "btd"), aux, counts
    if kind == "rglru_mlp":
        h = L.apply_norm(params["ln1"], x, cfg)
        y, _ = RG.apply_rglru(params["rglru"], h, cfg, state, decode)
        x = constrain(x + y, "btd")
        h = L.apply_norm(params["ln2"], x, cfg)
        return constrain(x + L.apply_mlp(params["mlp"], h, cfg), "btd"), \
            aux, counts
    if kind not in _ATTN_KINDS:
        raise ValueError(kind)
    window = cfg.window if kind == "attn_local_mlp" else None
    h = L.apply_norm(params["ln1"], x, cfg)
    a, _ = L.apply_attention(params["attn"], h, cfg, pos=pos,
                             causal=cfg.family != "vit-moe", window=window,
                             cache=state, cache_index=cache_index)
    x = constrain(x + a, "btd")
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
    return constrain(x + y, "btd"), aux, counts


def forward(params, inputs, cfg: ArchConfig, *, pos=None, state=None,
            cache_index=None, decode=False, task_id=0, return_state=None,
            logits_mode="all", return_expert_counts: bool = False,
            gather_logits: bool = True, gather=None):
    """inputs: tokens (B, S) int or embeddings (B, S, d); params: the
    nested tree.

    Returns (logits, state, aux_loss): float32 logits (the trunk's features
    when ``vocab_size == 0``), the state when one was passed (prefill /
    decode, its caches written in place) or ``return_state`` forces it.
    ``logits_mode="last"`` applies the LM head to the final position only,
    an int ``i`` to position ``i`` only (the last real token of a padded
    prompt; the same logits as row ``i`` of ``"all"``).
    ``cache_index`` is an int or a (B,) tensor (continuous batching: each
    slot at its own position).  Attention blocks decode whenever a state,
    a cache index and one token are given; ``decode=True`` states that this
    is such a step (and takes the recurrent blocks' one-step path) and
    raises if it is not.  ``return_expert_counts``
    appends the per-expert dispatch counts summed over the MoE layers.
    ``gather_logits=False``: a rank holding a block of the vocabulary
    returns its block of the logits (the vocab-parallel loss), not the
    whole.  ``gather`` (serving under FSDP rules: ``serve.engine.
    fsdp_gathers``' layout of the leaves a rank holds as blocks of the
    table's layout) gathers one layer's leaves just before the layer runs
    and drops them when it returns, ``embed`` before the lookup and the
    head (or the tied table, again) before the logits: at most one
    layer's gathered leaves exist at a time.  ``cfg.policy`` (when set)
    is scoped around the whole pass.
    """
    if decode and (state is None or cache_index is None
                   or inputs.shape[1] != 1):
        raise ValueError("decode=True is a one-token step: it needs a state, "
                         f"a cache_index and S == 1 (got S={inputs.shape[1]})")
    with use_policy(cfg.policy):
        return _forward(params, inputs, cfg, pos=pos, state=state,
                        cache_index=cache_index, decode=decode,
                        task_id=task_id,
                        return_state=return_state, logits_mode=logits_mode,
                        return_expert_counts=return_expert_counts,
                        gather_logits=gather_logits, gather=gather)


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
             cache_index=None, decode=False, task_id=0, return_state=None,
             logits_mode="all", return_expert_counts: bool = False,
             gather_logits: bool = True, gather=None):
    embed = params.get("embed", {})
    x = L.embed_inputs(_gathered(embed, "embed.", gather, 0), inputs, cfg)
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
    blocks = []   # (kind, params, cache or None, dotted prefix, lead dims)
    for p in range(n_scan):
        pparams = index(params["layers"], p)
        pstate = index(state["layers"], p) if state is not None else None
        blocks += [(cfg.block_pattern[i], pparams[f"b{i}"],
                    pstate[f"b{i}"] if pstate is not None else None,
                    f"layers.b{i}.", 1)
                   for i in range(cfg.period)]
    rest = params.get("rest", {})
    for i in range(len(rest)):
        st = state["rest"][str(i)] if state is not None else None
        blocks.append((cfg.block_pattern[i % cfg.period], rest[str(i)], st,
                       f"rest.{i}.", 0))
    for kind, held, bstate, prefix, lead in blocks:
        bparams = _gathered(held, prefix, gather, lead)
        x, aux, cnt = _apply_block(kind, bparams, x, cfg, pos=pos,
                                   state=bstate, cache_index=cache_index,
                                   decode=decode, task_id=task_id,
                                   counts_shape=counts_shape)
        del bparams     # before the next layer's gather: one at a time
        aux_total = aux_total + aux
        counts_total = counts_total + cnt
    x = L.apply_norm(params["final_norm"], x, cfg)
    if logits_mode == "last":
        x = x[:, -1:]
    elif not isinstance(logits_mode, str):
        x = x[:, int(logits_mode):int(logits_mode) + 1]
    head = _gathered(params.get("head", {}), "head.", gather, 0)
    if cfg.tie_embeddings:
        embed = _gathered(embed, "embed.", gather, 0)
    logits = L.apply_lm_head(head, embed, x, cfg, gather=gather_logits)
    out_state = (state if state is not None else {}) if want_state else None
    if return_expert_counts:
        return logits, out_state, aux_total, counts_total
    return logits, out_state, aux_total
