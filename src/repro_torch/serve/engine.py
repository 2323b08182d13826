"""Batched LM serving: prefill, then decode over KV caches and recurrent
state — the port of ``repro.serve.engine`` (``ServeConfig``,
``ServingEngine``, ``feedback_inputs``, ``state_batch_axes``) for
single-device serving of the attention and recurrent families.

A static batch of prompts is prefilled (in one pass, or in fixed-size
chunks) into per-layer KV caches and recurrent states (mLSTM C/n/m,
sLSTM cells, RG-LRU h, their conv windows) on the card, then decoded token
by token with greedy or temperature sampling; per-request EOS stops a row
early.  The state is written in place between steps.
``ServeConfig.prefix_cache`` is read by the scheduler's ``LMBackend``
only; the static engine ignores it, as the reference's does.  ``ServeConfig.kv_quant="int8"`` stores the
caches as int8 rows with a float32 scale per (token, head); pair it with
``policy_named("eager_int8")`` (or an ``attention_decode="eager_int8"``
override) so the int8 decode impl is a dispatch hit.
``ServeConfig.async_paging`` belongs to the vision backend; the LM engine
ignores it, as the reference's does.

Mesh serving (``rules``, a ``dist.sharding.ShardingRules`` over a
``DeviceMesh``; one process a rank, every rank calling ``generate`` with
the same prompts): each rank holds its weights where the rules place
them (:func:`place_params`, the reference's namesake).  Every rank
computes on its block over ``model`` of each leaf the reference's table
splits there — attention's heads, the MLP's and the shared experts'
hidden columns, its block of the vocabulary in ``embed/tokens`` and
``head/w``, an RG-LRU mixer's block of its width, an xLSTM mixer's heads,
an ``ep_local`` MoE layer's experts — so the dense blocks and the
recurrent mixers run tensor-parallel (``models/layers.py``,
``models/rglru.py``, ``models/xlstm.py``); on the rest whole: an xLSTM
mixer whose heads do not divide the axis, attention whose heads do not
divide the axis, k/v where the KV heads do not, the expert stacks of the
other MoE impls.  Under ``fsdp=False`` a rank holds exactly those
tensors (:func:`local_params`).  Under FSDP rules (``fsdp=True``, the
default, or ``"moe_only"``) it holds every leaf at its block of the
table's layout, over the data axes too (the reference's placement), and
the forward gathers each layer's leaves just before the layer runs
(:func:`fsdp_gathers`, ``models.transformer.forward(gather=)``: over the
data axes, and over ``model`` for a leaf computed whole), so at rest a
rank holds only its blocks; packed (QTensor) groups stay whole under
either.  ``models.model.init_params(rules=)`` draws a rank's blocks
without ever holding the whole model.
The decode state and the prompts are batch-sharded over the data axes,
a KV cache holds this rank's KV heads where the ``"cache"`` rule splits
them, an RG-LRU state this rank's channels and an mLSTM or sLSTM state
this rank's heads where its mixers split (:func:`shard_state`,
:func:`shard_batch`): each rank
prefills and decodes its own rows, and one all-gather a step brings
every row's token back, so the host loop (EOS, the output) sees the whole
batch.  The head's logits are gathered whole over ``model`` before
sampling, and temperature sampling draws the whole batch's noise from
the one generator and keeps its rows, so a mesh samples from the logits
no mesh gives (bit for bit where ``model`` has one rank; a row-parallel
sum's other order elsewhere).

Embedding-input frontends (``embed_input="embeddings"``: MusicGen's
EnCodec frames, Qwen2-VL's patches) are stubs, as in the reference: a
prompt is (B, S0, d) embeddings, and each sampled token is fed back as its
row of a fixed pseudo-embedding table (``feedback_inputs``).  The
reference draws that table with ``jax.random.normal(PRNGKey(0xE0BED))``
times 0.02; the port imports no JAX, so :func:`_stub_embed_table` draws
its own from seeded host ``torch.Generator`` objects (other values; the
same table on the CPU and on the card).  An engine (and the scheduler's
``LMBackend``) takes a table as ``stub_table``, and copies it (or its own
draw) to the device once for its lifetime;
``repro_torch.bridge.stub_table_from_jax`` carries the reference's table
across for it, as ``params_from_jax`` carries weights, so the two engines
feed back the same rows.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import spmd
from repro_torch.dist.sharding import (TrainLayout, _axes, axis_sizes,
                                      local_slice, shard_leaf, use_rules)
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.ops.policy import ComputePolicy
from repro_torch.train.step import layout_for, make_serve_step
from repro_torch.tree import flatten

__all__ = ["ServeConfig", "ServingEngine", "is_recurrent", "feedback_inputs",
           "state_batch_axes", "serve_overrides", "stub_feedback_table",
           "local_params", "place_params", "fsdp_gathers", "shard_state",
           "shard_batch"]

_RECURRENT = ("mlstm", "slstm", "rglru_mlp")
_STUB_SEED = 0xE0BED
_STUB_ROWS = 8192      # table rows a generator draws (float32), then cast


def is_recurrent(cfg: ArchConfig) -> bool:
    """True when the arch carries recurrent state (no KV cache semantics)."""
    return any(k in _RECURRENT for k in cfg.block_pattern)


def _stub_embed_table(vocab: int, d: int, dtype: str) -> torch.Tensor:
    """The (max(vocab, 2), d) host pseudo-embedding table of a stub
    frontend: N(0, 1)·0.02 in float32, cast to ``dtype``; rows
    [8192·c, 8192·(c + 1)) from a CPU ``torch.Generator`` seeded with
    0xE0BED + c, the blocks drawn in parallel threads (Qwen2-VL's table
    holds 1.25 G values)."""
    dt = getattr(torch, dtype)
    rows = max(vocab, 2)

    def draw(c):
        n = min(_STUB_ROWS, rows - c * _STUB_ROWS)
        gen = torch.Generator().manual_seed(_STUB_SEED + c)
        return (torch.randn((n, d), generator=gen) * 0.02).to(dt)

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return torch.cat(list(pool.map(draw, range(-(-rows // _STUB_ROWS)))))


def stub_feedback_table(cfg: ArchConfig, device, table=None):
    """The device copy of a stub frontend's table that a decode loop keeps
    for its lifetime: ``table`` (a host table, e.g. the reference's from
    ``bridge.stub_table_from_jax``) or :func:`_stub_embed_table`'s draw;
    None for a token-input arch."""
    if cfg.embed_input == "tokens":
        return None
    if table is None:
        table = _stub_embed_table(cfg.vocab_size, cfg.d_model, cfg.dtype)
    return table.to(device=device, dtype=getattr(torch, cfg.dtype))


def feedback_inputs(cfg: ArchConfig, tok, table=None):
    """Next-step model input from sampled (B,) token ids.

    Token-input archs feed the ids as a (B, 1) column; stub frontends
    (``embed_input="embeddings"``) feed each id's row of ``table``, the
    device copy of the pseudo-embedding table that the decode loop keeps
    (:func:`stub_feedback_table`), as (B, 1, d)."""
    if cfg.embed_input == "tokens":
        return tok[:, None]
    if table is None:
        raise ValueError(
            f"{cfg.name}: embedding inputs feed back rows of the stub "
            "table; pass the decode loop's device copy (ServingEngine."
            "fb_table, LMBackend.fb_table, stub_feedback_table)")
    return table.index_select(0, tok.reshape(-1).long())[:, None]


def state_batch_axes(cfg: ArchConfig, max_len: int) -> list[int]:
    """Per-leaf batch-axis indices of the decode state, in
    ``repro_torch.tree.flatten`` order, discovered structurally: the state
    is built on the meta device at batch 1 and 2, and the axis whose size
    changed is the batch axis (1 under the stacked ``layers``, 0 under
    ``rest``).  An int8 cache's ``k_scale``/``v_scale`` leaves get theirs
    the same way."""
    s1 = flatten(M.init_state(cfg, 1, max_len, device="meta"))
    s2 = flatten(M.init_state(cfg, 2, max_len, device="meta"))
    axes = []
    for name, a in s1.items():
        diffs = [i for i, (x, y) in enumerate(zip(a.shape, s2[name].shape))
                 if x != y]
        if len(diffs) != 1:
            raise ValueError(f"ambiguous batch axis of {name}: "
                             f"{tuple(a.shape)}")
        axes.append(diffs[0])
    return axes


def _packed_groups(params: dict) -> set:
    """The groups holding a packed leaf (QTensor: the table replicates
    it), which stay whole, their biases with them."""
    return {k.rsplit(".", 1)[0] for k, v in params.items()
            if not isinstance(v, torch.Tensor)}


def _blocks_of(params: dict, cfg: ArchConfig, rules, specs: dict) -> dict:
    """``params`` with each leaf ``specs`` names (its spec on the whole
    shape) cut to this rank's block, a tensor of its own (so the whole
    one can be freed), the rest as given.  A leaf already at its block
    (``model.init_params(rules=)``) is kept as it is; packed groups stay
    whole; a leaf at any other shape raises."""
    if not specs:
        return params
    shapes = M.param_specs(cfg)
    packed = _packed_groups(params)
    out = dict(params)
    for k, spec in specs.items():
        v = params.get(k)
        if not isinstance(v, torch.Tensor) or k.rsplit(".", 1)[0] in packed:
            continue
        whole = tuple(shapes[k].shape)
        block = tuple(s.stop - s.start
                      for s in local_slice(whole, spec, rules.mesh))
        if tuple(v.shape) == block:
            continue
        if tuple(v.shape) != whole:
            raise ValueError(f"{k}: {tuple(v.shape)} is neither the whole "
                             f"leaf {whole} nor this rank's block {block}")
        out[k] = shard_leaf(v, spec, rules.mesh)
    return out


def local_params(params: dict, cfg: ArchConfig, rules) -> dict:
    """The tensors each rank's kernels compute with: this rank's block
    over ``model`` of every leaf ``transformer.model_blocks`` names, the
    rest as given (:func:`_blocks_of`).  No-op without rules or where
    ``model`` has one rank."""
    return _blocks_of(params, cfg, rules, T.model_blocks(cfg, rules))


def _fsdp(rules) -> bool:
    """Whether ``rules`` place serving's weights by FSDP (over a mesh,
    ``fsdp=True`` or ``"moe_only"``)."""
    return rules is not None and rules.mesh is not None \
        and rules.fsdp is not False


def place_params(params: dict, cfg: ArchConfig, rules) -> dict:
    """Serving's weights where ``rules`` place them, the reference's
    namesake.  No rules, or ``fsdp=False``: :func:`local_params`' tensors.
    Under FSDP rules: every leaf at this rank's block of the table's spec
    (``train.step.layout_for``, training's layout), over the data axes
    and ``model`` — a leaf a rank computes whole over ``model`` too, as
    the reference places it; the forward gathers them
    (:func:`fsdp_gathers`).  As :func:`_blocks_of`: blocks kept, packed
    groups whole, any other shape raises."""
    if not _fsdp(rules):
        return local_params(params, cfg, rules)
    return _blocks_of(params, cfg, rules, layout_for(cfg, rules).params)


def fsdp_gathers(params: dict, cfg: ArchConfig, rules):
    """The layout the forward gathers :func:`place_params`' leaves by
    (``models.transformer.forward(gather=)``): each leaf held as a block
    it computes whole over some axis of more than one rank, with its
    spec and the axes it stays local over (``keep``: ``model`` for a
    leaf ``transformer.model_blocks`` names, and every axis of one
    rank).  None without FSDP rules or where nothing is gathered (a mesh
    of one): the forward then runs on the leaves as held."""
    if not _fsdp(rules):
        return None
    layout = layout_for(cfg, rules)
    ones = tuple(a for a, n in axis_sizes(rules.mesh).items() if n == 1)
    packed = _packed_groups(params)
    specs, keep = {}, {}
    for k, v in params.items():
        if not isinstance(v, torch.Tensor) or k.rsplit(".", 1)[0] in packed:
            continue
        kept = layout.keep.get(k, ()) + ones
        if any(a not in kept for e in layout.params[k] for a in _axes(e)):
            specs[k], keep[k] = layout.params[k], kept
    return TrainLayout(rules, specs, keep) if specs else None


def shard_state(state, cfg: ArchConfig, rules, axes: list[int],
                blocks=None):
    """This rank's part of a whole decode state (KV caches, recurrent
    cells): each leaf's batch axis (``axes``, from
    :func:`state_batch_axes`) cut over the mesh's batch axes, as the
    trimmed spec cuts it (a batch the axes do not divide stays whole), and
    over ``model`` to the blocks of ``blocks``
    (``transformer.state_blocks`` of this rank's parameters), each leaf
    by its block's kind in ``cfg.block_pattern``: an attention block's KV
    cache to its ``kv_heads`` (the axis after the batch axis), an RG-LRU
    state's ``h`` and ``conv`` to its ``lru_width`` channels (the last
    axis), an mLSTM state's ``C``, ``n`` and ``m`` and an sLSTM state's
    ``c``, ``n``, ``h`` and ``m`` to its ``xlstm_heads`` (the axis after
    the batch axis) and the mLSTM's ``conv`` to those heads' channels (the
    last axis).  No-op without rules."""
    if rules is None or rules.mesh is None:
        return state
    from repro_torch.tree import flatten, unflatten

    blocks = blocks or {}
    kv_heads, width, heads = (blocks.get(k) for k in (
        "kv_heads", "lru_width", "xlstm_heads"))
    rank = spmd.axis_index(rules.mesh, "model")
    out = {}
    for (name, leaf), ax in zip(flatten(state).items(), axes):
        rows = spmd.batch_rows(leaf.shape[ax], rules)
        part = leaf.narrow(ax, rows.start, rows.stop - rows.start)
        group, block, leaf_name = name.split(".")
        kind = cfg.block_pattern[int(block.lstrip("b")) % cfg.period]
        if kind == "rglru_mlp":
            if width is not None:
                part = part.narrow(-1, rank * width, width)
        elif kind in ("mlstm", "slstm"):
            if heads is not None and leaf_name == "conv":
                ch = part.shape[-1] // cfg.num_heads * heads
                part = part.narrow(-1, rank * ch, ch)
            elif heads is not None:
                part = part.narrow(ax + 1, rank * heads, heads)
        elif kv_heads is not None:                  # a KV cache
            part = part.narrow(ax + 1, rank * kv_heads, kv_heads)
        out[name] = part.clone()
    return unflatten(out)


def shard_batch(x, rules):
    """This rank's rows of a batch-leading tensor (prompts, token
    feedback).  No-op without rules."""
    if rules is None or rules.mesh is None:
        return x
    return x[spmd.batch_rows(x.shape[0], rules)]


@dataclass(frozen=True)
class ServeConfig:
    max_len: int = 2048
    temperature: float = 0.0       # 0 => greedy
    eos_id: int = -1               # -1 => never stop early
    seed: int = 0                  # seeds the sampling generator
    prefill_chunk: int = 0         # >0: chunked prefill
    # compute policy for every serving step; None keeps the arch config's
    policy: Optional[ComputePolicy] = None
    # KV-cache storage override ("none" | "int8"); None keeps the arch
    # config's kv_quant
    kv_quant: Optional[str] = None
    async_paging: bool = False         # the vision backend's; LMs ignore it
    # shared prompt-prefix cache (scheduler LM backend): >0 attaches a
    # radix trie of up to that many cached prompt prefill states; ignored
    # by the static ServingEngine
    prefix_cache: int = 0
    prefix_min: int = 8                # min matched tokens worth reusing


def serve_overrides(cfg: ArchConfig, scfg: ServeConfig) -> ArchConfig:
    """The arch config with the serve-level overrides applied: the compute
    policy and the KV-cache storage (the reference's
    ``_policy_override``)."""
    over = {}
    if scfg.policy is not None:
        over["policy"] = scfg.policy
    if scfg.kv_quant is not None:
        over["kv_quant"] = scfg.kv_quant
    return replace(cfg, **over) if over else cfg


class ServingEngine:
    """``generate(prompts, max_new_tokens)`` over ``params`` (the flat
    dotted-name dict) on ``device`` (default: the card).  A stub frontend
    feeds back rows of ``stub_table`` (a host table; default: the port's
    own draw), copied to the device once."""

    def __init__(self, cfg: ArchConfig, params, scfg: ServeConfig,
                 rules=None, *, device="cuda", stub_table=None):
        self.device = resolve_device(device)
        self.cfg, self.scfg = serve_overrides(cfg, scfg), scfg
        self.rules = rules
        self.params = place_params(
            {k: v.to(self.device) for k, v in params.items()}, self.cfg,
            rules)
        self.gathers = fsdp_gathers(self.params, self.cfg, rules)
        self._steps: dict[int, tuple] = {}
        # a stub frontend's feedback table, on the device once
        self.fb_table = stub_feedback_table(self.cfg, self.device,
                                            stub_table)

    def feedback(self, tok):
        """``feedback_inputs`` over the engine's device table."""
        return feedback_inputs(self.cfg, tok, table=self.fb_table)

    def new_state(self, batch: int):
        """A zeroed decode state of ``batch`` rows at ``max_len``: this
        rank's KV heads, RG-LRU channels and xLSTM heads under tensor
        parallelism."""
        return M.init_state(self.cfg, batch, self.scfg.max_len,
                            device=self.device, params=self.params,
                            gather=self.gathers)

    def steps(self, task_id: int = 0):
        """(prefill, decode) of ``train.step.make_serve_step``, per task."""
        if task_id not in self._steps:
            self._steps[task_id] = make_serve_step(
                self.cfg, task_id=task_id, gather=self.gathers)
        return self._steps[task_id]

    def _sample(self, logits, generator):
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)    # the first maximum
        # Gumbel-max, the algorithm of jax.random.categorical; on a mesh
        # the whole batch's noise is drawn and this rank's rows kept
        u = torch.rand((self._batch,) + tuple(logits.shape[1:]),
                       generator=generator, device=logits.device)
        u = shard_batch(u, self.rules)
        u = u.clamp_min(torch.finfo(u.dtype).tiny)
        return torch.argmax(logits / self.scfg.temperature
                            - torch.log(-torch.log(u)), dim=-1)

    def _prefill(self, prompts, state, task_id):
        cfg, chunk = self.cfg, self.scfg.prefill_chunk
        b, s0 = prompts.shape[:2]
        windowed = any("attn_local" in k for k in cfg.block_pattern)
        if not (chunk and not windowed and s0 > chunk):
            prefill, _ = self.steps(task_id)
            return prefill(self.params, prompts, state)
        # fixed-size chunks; a short final chunk is padded, its pad rows
        # land at positions >= s0, past every later cache_len (the first
        # decode overwrites position s0), and the logits are read at the
        # last real position.  A recurrent state is a running reduction
        # that zero padding would pollute: its final chunk runs at its own
        # length.
        n_full, rem = divmod(s0, chunk)
        if rem == 0:
            n_mid, last = n_full - 1, chunk - 1
            final = prompts[:, n_mid * chunk:]
        elif is_recurrent(cfg):
            n_mid, last = n_full, rem - 1
            final = prompts[:, n_mid * chunk:]
        else:
            tail = prompts[:, n_full * chunk:]
            final = torch.cat([tail, tail.new_zeros(
                (b, chunk - rem) + tuple(tail.shape[2:]))], 1)
            n_mid, last = n_full, rem - 1
        for i in range(n_mid):
            M.forward(self.params, prompts[:, i * chunk:(i + 1) * chunk],
                      cfg, state=state, cache_index=i * chunk,
                      task_id=task_id, return_state=True, logits_mode="last",
                      gather=self.gathers)
        logits, state, _ = M.forward(self.params, final, cfg, state=state,
                                     cache_index=n_mid * chunk,
                                     task_id=task_id, return_state=True,
                                     logits_mode=last, gather=self.gathers)
        return logits[:, 0], state

    def generate(self, prompts, max_new_tokens: int, task_id: int = 0,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """prompts: (B, S0) int token ids, or (B, S0, d) embeddings for a
        stub frontend (NumPy or tensor).  Returns
        (B, max_new_tokens) int32 NumPy tokens; after a row emits
        ``eos_id`` it holds ``eos_id``.  Temperature sampling draws from
        ``generator`` (default: a new one on the device seeded with
        ``ServeConfig.seed``)."""
        cfg, scfg = self.cfg, self.scfg
        prompts = torch.as_tensor(prompts, device=self.device)
        if cfg.embed_input == "tokens":
            prompts = prompts.long()
        b, s0 = prompts.shape[:2]
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(scfg.seed)
        out = np.zeros((b, max_new_tokens), np.int32)
        done = np.zeros((b,), bool)
        self._batch = b
        rows = spmd.batch_rows(b, self.rules) if self.rules is not None \
            else slice(0, b)
        with torch.inference_mode(), use_rules(self.rules), \
                spmd.batch_split(self.rules, b):
            state = self.new_state(rows.stop - rows.start)
            logits, state = self._prefill(shard_batch(prompts, self.rules),
                                          state, task_id)
            _, decode = self.steps(task_id)
            tok = self._sample(logits, generator)
            for i in range(max_new_tokens):
                every = tok if self.rules is None else spmd.gather_batch(
                    tok, self.rules, b, "engine tokens")
                host = every.cpu().numpy()
                out[:, i] = np.where(done, scfg.eos_id, host)
                if scfg.eos_id >= 0:
                    done |= host == scfg.eos_id
                    if done.all():
                        break
                logits, state = decode(self.params, self.feedback(tok),
                                       state, s0 + i)
                tok = self._sample(logits, generator)
        return out
