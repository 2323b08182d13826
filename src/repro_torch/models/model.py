"""Model facade for the decoder LMs: ``init_params``, ``forward``,
``init_state``, ``lm_loss`` and ``input_specs`` (the port of
``repro.models.model``), with ``param_specs``, the shape-only parameter
build the dry-run (``launch/dryrun.py``) runs on ``meta``.

Parameters are the flat dotted-name dict (``bridge.params_from_jax`` or
:func:`init_params`), with the reference's key paths: ``embed.tokens``,
``final_norm.scale``, ``layers.b0.attn.wq`` (stacked over periods), and
``head.w`` when the embeddings are not tied.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, Shape
from repro_torch.dist.sharding import param_sharding_rules
from repro_torch.models import transformer as T
from repro_torch.roofline.scope import scope
from repro_torch.tree import flatten, unflatten

__all__ = ["init_params", "forward", "init_state", "lm_loss",
           "cross_entropy", "input_specs", "param_specs"]


def init_params(seed: int, cfg: ArchConfig, dtype=None, device="cuda",
                draw_on_device: bool = False, rules=None):
    """Random parameters from ``seed`` with the reference's shapes, scales
    and dtypes (norm scales float32), as a flat dotted-name dict on
    ``device``.  They are drawn by NumPy on the host, or with
    ``draw_on_device`` by a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (other values; RecurrentGemma-9B's 9.6 B parameters would
    take minutes of NumPy on the host).

    With ``rules`` over a mesh, each leaf is cut to the block a serving
    rank holds as it is drawn, a layer at a time, and the rest freed: the
    whole model never exists (DeepSeek-67B over four cards).  Under
    ``fsdp=False`` that is ``serve.engine.local_params``' layout (this
    rank's block over ``model`` of each leaf ``transformer.model_blocks``
    names, where the axis is larger than one); under FSDP rules
    (``fsdp=True`` or ``"moe_only"``) ``serve.engine.place_params``' (every
    leaf at this rank's block of the table's spec, over the data axes and
    ``model``).  Every value is drawn in the one-device order, so a
    rank's block equals the same block of the one-device draw from
    ``seed``, bit for bit (an RG-LRU layer's ``lam`` too: its whole
    width's uniform draw, then the block)."""
    dev = resolve_device(device)
    if draw_on_device:
        rng = torch.Generator(device=dev)
        rng.manual_seed(seed)
    else:
        rng = np.random.default_rng(seed)
    keep = None
    if rules is not None and rules.mesh is not None and rules.fsdp:
        blocks = {k: v.spec for k, v in param_sharding_rules(
            param_specs(cfg, dtype), rules).items()}
    else:
        blocks = T.model_blocks(cfg, rules)
    if blocks:
        def keep(name, leaf):
            spec = blocks.get(name)
            if spec is None:
                return leaf
            return T.leaf_block(leaf.to(dev), spec, rules.mesh)
    tree = T.init_params(rng, cfg, dtype, keep=keep)
    return {k: v.to(dev) for k, v in flatten(tree).items()}


def forward(params, inputs, cfg: ArchConfig, **kw):
    """``transformer.forward`` on the flat dotted-name dict: returns
    (float32 logits, state, aux_loss); see there for the keywords."""
    return T.forward(unflatten(params), inputs, cfg, **kw)


def init_state(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device="cuda", params=None, gather=None):
    """Zeroed KV caches and initial recurrent states (the reference's
    −1e30 stabilizers) for ``batch`` sequences of up to ``max_len`` tokens
    on ``device``; ``params``: the flat leaves a rank holds under tensor
    parallelism (computed at their gathered shapes under ``gather``, the
    FSDP layout), whose KV heads, RG-LRU channels and xLSTM heads the
    state holds (``transformer.state_blocks``; default all)."""
    return T.init_state(cfg, batch, max_len, dtype,
                        device=resolve_device(device), params=params,
                        gather=gather)


def lm_loss(params, batch, cfg: ArchConfig, aux_weight: float = 0.01,
            task_id=0):
    """Next-token cross-entropy, the reference's: batch {"inputs" (B, S)
    tokens or (B, S, d) embeddings, "labels" (B, S) int, -100 masked}.

    The float32 logits' max is subtracted as a constant (no gradient), the
    label logit is taken by a mask-reduce over the vocabulary (the
    reference's shard-friendly form; the same value as a gather), and the
    mean runs over the unmasked positions.  Returns
    (loss + aux_weight·aux, {"ce", "aux"}).

    On a rank's rows of a split batch (``dist.spmd.batch_split``, as the
    train step runs it over a mesh) the loss is this rank's share of the
    whole batch's: its masked sum over the unmasked count summed over the
    ranks, and the aux loss (the whole batch's) over the number of
    shards.  The shares add up to the one-device loss, so the ranks'
    summed gradients are its gradient, whatever each rank's mask.

    A rank holding a block of the vocabulary (tensor-parallel training)
    never gathers the logits: the head gives its columns, the max is an
    all-reduce-max over ``model`` (no gradient), and the sum of exps and
    the label logit (the mask-reduce on the rank's columns, offset by its
    block's first id) are its partial sums added over ``model``
    (``spmd.model_sum``) — the reference's "tiny (B, S) cross-shard
    reduce".  Every ``model`` rank then holds the same loss."""
    from repro_torch.dist import spmd

    logits, _, aux = T.forward(unflatten(params), batch["inputs"], cfg,
                               task_id=task_id, gather_logits=False)
    with scope("loss"):
        loss = cross_entropy(logits, batch["labels"], cfg)
        shards = spmd.batch_shards()
        if shards > 1:
            aux = aux / shards
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def cross_entropy(logits, labels, cfg: ArchConfig):
    """:func:`lm_loss`'s cross-entropy of ``logits`` (B, S, V), or of a
    rank's block of the vocabulary (B, S, V / tp) under the rules of its
    mesh, against ``labels`` (B, S); the mean over the unmasked positions
    (of the whole batch inside ``dist.spmd.batch_split``)."""
    from repro_torch.dist import spmd

    lf = logits.float()
    v = lf.shape[-1]
    ids = torch.arange(v, device=lf.device)
    if v == cfg.vocab_size:
        shifted = lf - lf.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(shifted).sum(dim=-1))
    else:            # this rank's block of the vocabulary
        shifted = lf - spmd.model_max(lf.amax(dim=-1, keepdim=True),
                                      "loss max")
        lse = torch.log(spmd.model_sum(torch.exp(shifted).sum(dim=-1),
                                       "loss sum-exp"))
        ids = ids + spmd.model_rank() * v
    onehot = ids == labels.clamp_min(0)[..., None]
    label_logit = torch.where(onehot, shifted, 0.0).sum(dim=-1)
    if v != cfg.vocab_size:
        label_logit = spmd.model_sum(label_logit, "loss label logit")
    mask = labels >= 0
    count = spmd.batch_total(mask.sum(), "loss token count")
    return ((lse - label_logit) * mask).sum() / torch.clamp_min(count, 1)


def param_specs(cfg: ArchConfig, dtype=None, device="meta") -> dict:
    """The parameters' shapes and dtypes, as :func:`init_params` builds
    them, on ``meta``: no values are drawn and no memory is taken (the
    counterpart of the reference's ``jax.eval_shape`` of ``init_params``).
    ``init_params`` draws its values with generators on a real device."""
    meta = torch.device(device)
    tree = T.init_params(meta, cfg, dtype)
    return {k: v.to(meta) for k, v in flatten(tree).items()}


def input_specs(cfg: ArchConfig, shape: Shape, dtype=None,
                device="meta") -> dict:
    """Meta tensors for the cell's step inputs (the reference's
    ``ShapeDtypeStruct`` stand-ins): train {"inputs", "labels"}; prefill
    {"inputs"}; decode {"inputs" (one token), "state" (the caches and
    recurrent states of ``seq_len`` positions), "cache_index" (a scalar)}.
    Inputs are (B, S) int32 tokens, or (B, S, d) embeddings for the stub
    frontends."""
    dtype = dtype or cfg.activation_dtype
    dev = torch.device(device)
    b, s = shape.global_batch, shape.seq_len

    def inputs(length):
        if cfg.embed_input == "tokens":
            return torch.empty((b, length), dtype=torch.int32, device=dev)
        return torch.empty((b, length, cfg.d_model), dtype=dtype,
                           device=dev)

    if shape.kind == "train":
        return {"inputs": inputs(s),
                "labels": torch.empty((b, s), dtype=torch.int32,
                                      device=dev)}
    if shape.kind == "prefill":
        return {"inputs": inputs(s)}
    return {"inputs": inputs(1),
            "state": T.init_state(cfg, b, s, dtype, device=dev),
            "cache_index": torch.empty((), dtype=torch.int32, device=dev)}
