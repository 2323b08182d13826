"""Step builders, the port of ``repro.train.step``: the training step and
the serving steps, for any arch the port runs.

PyTorch runs eagerly, so the steps are plain functions where the reference
returns jitted ones.  ``make_train_step`` returns
``step(params, opt_state, batch) -> (params, opt_state, metrics)``:

  * loss = ``models.model.lm_loss`` (+ the MoE aux loss), or the
    ``loss_fn(params, micro) -> (loss, aux)`` given — M³ViT passes its
    multitask loss;
  * gradient accumulation over ``accum_steps`` microbatches (a Python loop
    where the reference scans), the sum in float32;
  * AdamW (``optim.adamw``);
  * the NaN guard: a non-finite loss leaves params and optimizer state
    bit-identical, by a ``torch.where`` on the card's own ``isfinite`` —
    no host read, so the step never waits for the card.

Its forward, backward and optimizer run under the profiler labels
``train_step.forward`` / ``.backward`` / ``.optimizer``
(``train/profile.py`` reads them).

The step never writes its inputs (the reference donates them; eager
PyTorch has nothing to donate): it returns new parameter and state tensors
and computes them on tensors of its own.  The loss runs with gradients on
whatever the caller's grad mode is, on detached copies of the parameters,
so the caller's tensors need no ``requires_grad``.

With ``rules`` over a mesh the step is explicit SPMD, one call a rank,
and computes what one device computes on the whole batch:

  * the parameters and AdamW state are this rank's blocks under the
    rules' specs (:func:`layout_for`; ``TrainLayout.shard_params`` /
    ``shard_opt_state`` cut them), the batch this rank's rows
    (``data.shard_for``);
  * each parameter is gathered over the axes of its spec before the
    forward (``dist.spmd.gather_param``) but ``model`` for the leaves a
    rank computes on its block of (``TrainLayout.keep``, from
    ``transformer.model_blocks``: the dense blocks' heads, hidden
    columns and vocabulary, an RG-LRU mixer's channels, an xLSTM mixer's
    heads, an ``ep_local`` expert stack's experts), so
    a split leaf is gathered over the batch axes alone (FSDP) and never
    whole;
  * the forward and backward are tensor-parallel over ``model``: the
    layers read the split from the blocks' widths
    (``models/layers.py``, ``models/rglru.py``, ``models/xlstm.py``),
    each column block's input through the
    Megatron ``f`` (``spmd.model_input``) and each row block's float32
    partials through the ``g`` (``spmd.model_sum``); the head gives this
    rank's block of the vocabulary and the loss is vocab-parallel
    (``models.model.lm_loss``); the loss runs under
    ``dist.spmd.batch_split``, where each rank's loss is its share of the
    global loss (``models.model.lm_loss``, ``vit.multitask_loss``) and
    the same on every rank of ``model``;
  * the microbatch loop sums the gradients of the gathered blocks in
    float32 on the rank and reduces them to the stored blocks once a
    step (``dist.spmd.reduce_param_grad``: a reduce-scatter over the
    batch axes a parameter is sharded on, an all-reduce over those it is
    replicated on; over ``model`` nothing for a split leaf, this rank's
    block for a whole leaf, whose gradient the ranks computed alike or
    summed in the backward (the whole k/v of an attention whose q heads
    split: ``models/layers.py``)).  The reference instead pins its
    accumulator to the parameter sharding, which costs a reduce-scatter
    a microbatch; the sum is the same;
  * AdamW all-reduces the global norm's and the factored moments'
    statistics (``optim.adamw``); the loss is all-reduced before the NaN
    guard, so every rank keeps or skips the same step.

``make_serve_step`` returns the prefill and decode steps of the serving
engine; the state's KV caches are written in place, where the reference
donates them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.roofline.op_cost import repeat

__all__ = ["TrainConfig", "make_train_step", "loss_and_grads",
           "layout_for", "make_serve_step"]


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = field(default_factory=OptConfig)
    accum_steps: int = 1          # microbatch count (grad accumulation)
    aux_weight: float = 0.01      # MoE load-balance loss weight
    task_id: int = 0


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """(B, ...) leaves -> n microbatches of (B/n, ...)."""
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n)]


def loss_and_grads(loss_fn: Callable, params: dict, batch):
    """(loss, {name: gradient}) of ``loss_fn(params, batch) -> (loss,
    aux)``, the reference's ``jax.value_and_grad``: gradients in each
    parameter's dtype, zeros for a parameter the loss does not reach.  The
    forward and backward run under the profiler labels
    ``train_step.forward`` / ``train_step.backward``."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        with torch.profiler.record_function("train_step.forward"):
            loss, _ = loss_fn(leaves, batch)
        with torch.profiler.record_function("train_step.backward"):
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(params.items(), grads)}


def layout_for(cfg: ArchConfig, rules):
    """The :class:`~repro_torch.dist.sharding.TrainLayout` of ``cfg``'s
    parameters under ``rules`` (None without a mesh): the specs of their
    whole shapes, the M³ViT family's from ``vit.param_specs``; the
    leaves kept local over ``model`` are those a serving rank narrows
    (``transformer.model_blocks``).  The rule table (the reference's)
    has no rule for M³ViT's patch embedding and task heads, since the
    reference never trains its vision model over a mesh; they are
    replicated here."""
    if rules is None or rules.mesh is None:
        return None
    from repro_torch.dist.sharding import P, TrainLayout
    from repro_torch.models import transformer as T

    extra = ()
    if cfg.family == "vit-moe":
        from repro_torch.models import vit
        shapes = vit.param_specs(cfg)
        extra = ((r"^(patch|heads)/", P()),)
    else:
        shapes = M.param_specs(cfg)
    return TrainLayout.build(shapes, rules, extra=extra,
                             blocks=T.model_blocks(cfg, rules))


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, rules=None,
                    loss_fn: Optional[Callable] = None):
    """The training step.  ``loss_fn(params, micro) -> (loss, aux)``
    defaults to the LM loss; M³ViT passes its multitask loss instead.
    ``rules`` (``dist.sharding.ShardingRules``) over a mesh: the step runs
    on this rank's blocks and rows (see the module's docstring).  The
    step carries ``layout`` (``layout_for``'s) and ``grads(params,
    batch) -> (loss, gradients)``, the part before the optimizer."""
    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import use_rules

    loss_fn = loss_fn or (lambda p, mb: M.lm_loss(
        p, mb, cfg, aux_weight=tcfg.aux_weight, task_id=tcfg.task_id))
    layout = layout_for(cfg, rules)
    mesh = None if layout is None else layout.mesh
    batch_axes = () if layout is None else rules.batch_axes
    shards = 1
    for a in batch_axes:
        shards *= spmd.axis_size(mesh, a)

    def split_loss(p, mb):
        rows = next(iter(mb.values())).shape[0]
        with spmd.batch_split(rules, rows * shards):
            return loss_fn(p, mb)

    def grads_of(params, batch):
        f = loss_fn if layout is None else split_loss
        if tcfg.accum_steps == 1:
            return loss_and_grads(f, params, batch)
        gsum = {k: torch.zeros(v.shape, dtype=torch.float32,
                               device=v.device)
                for k, v in params.items()}
        lsum = None
        micro = _split_microbatches(batch, tcfg.accum_steps)
        # the dry-run on meta counts one microbatch accum_steps times
        with repeat(len(micro), next(iter(params.values())).device) as rep:
            for mb in micro[:rep.steps]:
                loss, g = loss_and_grads(f, params, mb)
                for k in gsum:
                    gsum[k] += g[k]
                lsum = loss.float() if lsum is None else lsum + loss
        return lsum / tcfg.accum_steps, {k: v / tcfg.accum_steps
                                         for k, v in gsum.items()}

    def grads(params, batch):
        """(the global loss, each parameter's gradient): this rank's
        blocks' under ``rules``, whose forward and backward run on the
        leaves gathered over the batch axes (over ``model`` too for a
        leaf not in ``layout.keep``)."""
        with use_rules(rules):
            if layout is None:
                return grads_of(params, batch)
            with torch.no_grad():
                full = {k: spmd.gather_param(
                    v, layout.params[k], mesh, layout.keep.get(k, ()))
                    for k, v in params.items()}
            loss, g = grads_of(full, batch)
            del full
            # once a step: the blocks' gradients, and the global loss
            g = {k: spmd.reduce_param_grad(
                v, layout.params[k], mesh, layout.keep.get(k, ()))
                for k, v in g.items()}
            for a in batch_axes:
                loss = spmd.all_reduce(loss, mesh, a, "train loss")
            return loss, g

    def step(params, opt_state, batch):
        loss, grads_ = grads(params, batch)
        with use_rules(rules):
            with torch.profiler.record_function("train_step.optimizer"):
                new_params, new_opt, om = adamw_update(
                    params, grads_, opt_state, tcfg.opt,
                    specs=None if layout is None else layout.params,
                    mesh=mesh)
                del grads_
                ok = torch.isfinite(loss)
                for k in new_params:
                    new_params[k] = torch.where(ok, new_params[k],
                                                params[k])
                new_opt["step"] = torch.where(ok, new_opt["step"],
                                              opt_state["step"])
                for k, s in new_opt["ema"].items():
                    for leaf in s:
                        s[leaf] = torch.where(ok, s[leaf],
                                              opt_state["ema"][k][leaf])
        metrics = {"loss": loss, **om, "skipped": (~ok).to(torch.int32)}
        return new_params, new_opt, metrics

    step.layout = layout
    step.grads = grads
    return step


def make_serve_step(cfg: ArchConfig, task_id: int = 0, gather=None):
    """Returns (prefill, decode):

    prefill(params, tokens, state)        -> (logits_last, state)
    decode(params, token, state, index)   -> (logits, state)

    logits are float32 (B, vocab); ``index`` is an int or a (B,) tensor.
    ``gather``: the FSDP layout of the leaves ``params`` holds as blocks
    (``serve.engine.fsdp_gathers``), each layer's gathered just before it
    runs (``models.transformer.forward``).
    """

    def prefill(params, inputs, state):
        logits, state, _ = M.forward(
            params, inputs, cfg, state=state, cache_index=0,
            task_id=task_id, return_state=True, logits_mode="last",
            gather=gather)
        return logits[:, -1], state

    def decode(params, inputs, state, cache_index):
        logits, state, _ = M.forward(
            params, inputs, cfg, state=state, cache_index=cache_index,
            decode=True, task_id=task_id, return_state=True, gather=gather)
        return logits[:, -1], state

    return prefill, decode
