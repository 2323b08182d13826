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
so the caller's tensors need no ``requires_grad``.  Sharding rules come
with the distribution slice.

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
           "make_serve_step"]


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


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                    loss_fn: Optional[Callable] = None):
    """The training step.  ``loss_fn(params, micro) -> (loss, aux)``
    defaults to the LM loss; M³ViT passes its multitask loss instead."""
    loss_fn = loss_fn or (lambda p, mb: M.lm_loss(
        p, mb, cfg, aux_weight=tcfg.aux_weight, task_id=tcfg.task_id))

    def step(params, opt_state, batch):
        if tcfg.accum_steps > 1:
            gsum = {k: torch.zeros(v.shape, dtype=torch.float32,
                                   device=v.device)
                    for k, v in params.items()}
            lsum = None
            micro = _split_microbatches(batch, tcfg.accum_steps)
            # the dry-run on meta counts one microbatch accum_steps times
            with repeat(len(micro), next(iter(params.values())).device) \
                    as rep:
                for mb in micro[:rep.steps]:
                    loss, g = loss_and_grads(loss_fn, params, mb)
                    for k in gsum:
                        gsum[k] += g[k]
                    lsum = loss.float() if lsum is None else lsum + loss
            grads = {k: v / tcfg.accum_steps for k, v in gsum.items()}
            loss = lsum / tcfg.accum_steps
        else:
            loss, grads = loss_and_grads(loss_fn, params, batch)
        with torch.profiler.record_function("train_step.optimizer"):
            new_params, new_opt, om = adamw_update(params, grads, opt_state,
                                                   tcfg.opt)
            del grads
            ok = torch.isfinite(loss)
            for k in new_params:
                new_params[k] = torch.where(ok, new_params[k], params[k])
            new_opt["step"] = torch.where(ok, new_opt["step"],
                                          opt_state["step"])
            for k, s in new_opt["ema"].items():
                for leaf in s:
                    s[leaf] = torch.where(ok, s[leaf],
                                          opt_state["ema"][k][leaf])
        metrics = {"loss": loss, **om, "skipped": (~ok).to(torch.int32)}
        return new_params, new_opt, metrics

    return step


def make_serve_step(cfg: ArchConfig, task_id: int = 0):
    """Returns (prefill, decode):

    prefill(params, tokens, state)        -> (logits_last, state)
    decode(params, token, state, index)   -> (logits, state)

    logits are float32 (B, vocab); ``index`` is an int or a (B,) tensor.
    """

    def prefill(params, inputs, state):
        logits, state, _ = M.forward(
            params, inputs, cfg, state=state, cache_index=0,
            task_id=task_id, return_state=True, logits_mode="last")
        return logits[:, -1], state

    def decode(params, inputs, state, cache_index):
        logits, state, _ = M.forward(
            params, inputs, cfg, state=state, cache_index=cache_index,
            decode=True, task_id=task_id, return_state=True)
        return logits[:, -1], state

    return prefill, decode
