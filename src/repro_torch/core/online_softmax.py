"""Softmax via the single-pass statistics (Edge-MoE §IV-B) — the part of
``repro.core.online_softmax`` that routing uses.  The streaming statistics
(``online_max_sum``, ``merge_stats``) follow with the slices that need them.
"""

from __future__ import annotations

import torch

__all__ = ["softmax"]


def softmax(x: torch.Tensor, dim: int = -1, where=None) -> torch.Tensor:
    """``exp(x - max) / max(sum, tiny)``; ``where`` masks elements out of
    the distribution (they receive probability 0)."""
    if where is not None:
        x = torch.where(where, x, float("-inf"))
    b = torch.amax(x, dim=dim, keepdim=True)
    s = torch.sum(torch.exp(x - b), dim=dim, keepdim=True)
    out = torch.exp(x - b) / torch.clamp_min(s, torch.finfo(x.dtype).tiny)
    if where is not None:
        out = torch.where(where, out, 0.0)
    return out
