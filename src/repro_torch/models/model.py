"""Model facade for the decoder LMs: ``init_params``, ``forward`` and
``init_state`` (the port of the serving part of ``repro.models.model``;
``lm_loss`` and ``input_specs`` follow with the training slice).

Parameters are the flat dotted-name dict (``bridge.params_from_jax`` or
:func:`init_params`), with the reference's key paths: ``embed.tokens``,
``final_norm.scale``, ``layers.b0.attn.wq`` (stacked over periods), and
``head.w`` when the embeddings are not tied.
"""

from __future__ import annotations

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.tree import flatten, unflatten

__all__ = ["init_params", "forward", "init_state"]


def init_params(seed: int, cfg: ArchConfig, dtype=None, device="cuda"):
    """Random parameters from ``seed`` with the reference's shapes, scales
    and dtypes (norm scales float32), as a flat dotted-name dict on
    ``device``."""
    dev = resolve_device(device)
    tree = T.init_params(np.random.default_rng(seed), cfg, dtype)
    return {k: v.to(dev) for k, v in flatten(tree).items()}


def forward(params, inputs, cfg: ArchConfig, **kw):
    """``transformer.forward`` on the flat dotted-name dict: returns
    (float32 logits, state, aux_loss); see there for the keywords."""
    return T.forward(unflatten(params), inputs, cfg, **kw)


def init_state(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """Zeroed KV caches for ``batch`` sequences of up to ``max_len`` tokens
    on ``device``."""
    return T.init_state(cfg, batch, max_len, dtype,
                        device=resolve_device(device))
