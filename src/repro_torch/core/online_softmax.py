"""Single-pass softmax with dynamic bias (Edge-MoE §IV-B, Algorithm 1), the
port of ``repro.core.online_softmax``.

The paper computes softmax in one pass by carrying a running bias
``b = max(x_1..x_j)`` and a running denominator ``s = sum exp(x - b)``,
rescaled by ``exp(b_old - b_new)`` whenever a new maximum arrives; "Pass 3"
(``exp(x_i - b) / s``) is fused into the consumer of the scores.

  * ``online_max_sum``         — Algorithm 1 verbatim, one element at a time
                                 (the oracle; O(N) sequential).
  * ``online_max_sum_blocked`` — the block-parallel form the attention
                                 kernels use: chunks of the sequence, carries
                                 combined by the associative merge.
  * ``merge_stats``            — the associative combine of two (m, s)
                                 pairs (also a sequence-parallel merge).
  * ``softmax``                — the full softmax from the one-pass
                                 statistics, whole or ``block`` at a time.

Every form stays finite where ``exp(x)`` alone would overflow (the bias
cancels exactly, Eq. 3 of the paper).
"""

from __future__ import annotations

import torch

__all__ = ["online_max_sum", "online_max_sum_blocked", "merge_stats",
           "softmax"]


def online_max_sum(x: torch.Tensor, dim: int = -1):
    """Algorithm 1: one sequential pass computing (b, s), ``b = max(x)``
    and ``s = sum(exp(x - b))`` along ``dim``, element by element."""
    x = torch.movedim(x, dim, 0)
    b = torch.full(x.shape[1:], float("-inf"), dtype=x.dtype,
                   device=x.device)
    s = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    for xj in x:
        # if x_j > b:  s <- s * exp(b - x_j) + 1 ; b <- x_j
        # else:        s <- s + exp(x_j - b)
        s = torch.where(xj > b, s * torch.exp(b - xj) + 1.0,
                        s + torch.exp(xj - b))
        b = torch.maximum(b, xj)
    return b, s


def _exp_shift(m, m_new):
    """``exp(m - m_new)`` with an empty side (m = -inf) giving 0."""
    return torch.exp(torch.where(torch.isneginf(m), float("-inf"),
                                 m - m_new))


def merge_stats(m_a, s_a, m_b, s_b):
    """Associative merge of two one-pass carries (m = max, s = sum
    exp(x - m)) over disjoint sets: each sum rescaled onto the joint max.
    Where both sides are empty the sum stays 0."""
    m = torch.maximum(m_a, m_b)
    return m, s_a * _exp_shift(m_a, m) + s_b * _exp_shift(m_b, m)


def online_max_sum_blocked(x: torch.Tensor, dim: int = -1,
                           block: int = 128):
    """Blocked one-pass (b, s): the sequence in chunks of ``block``, the
    carries merged chunk by chunk.  A ragged tail is padded with -inf,
    which contributes exp(-inf) = 0 (the kernels' masked tail)."""
    x = torch.movedim(x, dim, 0)
    n = x.shape[0]
    nblocks = -(-n // block)
    pad = nblocks * block - n
    if pad:
        x = torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]),
                                     float("-inf"), dtype=x.dtype,
                                     device=x.device)])
    m = torch.full(x.shape[1:], float("-inf"), dtype=x.dtype,
                   device=x.device)
    s = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    for xblk in x.reshape((nblocks, block) + tuple(x.shape[1:])):
        m_blk = xblk.amax(dim=0)
        s_blk = torch.exp(xblk - m_blk).sum(dim=0)
        # a fully padded block: m_blk = -inf, s_blk = 0 (a no-op merge)
        s_blk = torch.where(torch.isneginf(m_blk), 0.0, s_blk)
        m, s = merge_stats(m, s, m_blk, s_blk)
    return m, s


def softmax(x: torch.Tensor, dim: int = -1, where=None,
            block: int | None = None) -> torch.Tensor:
    """``exp(x - b) / max(s, tiny)`` from the one-pass statistics (b, s),
    whole or ``block`` at a time; ``where`` masks elements out of the
    distribution (they receive probability 0)."""
    if where is not None:
        x = torch.where(where, x, float("-inf"))
    if block is None:
        b = torch.amax(x, dim=dim, keepdim=True)
        s = torch.sum(torch.exp(x - b), dim=dim, keepdim=True)
    else:
        b, s = online_max_sum_blocked(x, dim=dim, block=block)
        b, s = b.unsqueeze(dim), s.unsqueeze(dim)
    out = torch.exp(x - b) / torch.clamp_min(s, torch.finfo(x.dtype).tiny)
    if where is not None:
        out = torch.where(where, out, 0.0)
    return out
