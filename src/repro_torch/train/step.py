"""Serving steps, the port of ``repro.train.step.make_serve_step`` (kept at
the reference's location; the training step follows with its slice).

PyTorch runs eagerly, so the steps are plain functions where the reference
returns jitted ones; the state's KV caches are written in place, where the
reference donates them.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M

__all__ = ["make_serve_step"]


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
