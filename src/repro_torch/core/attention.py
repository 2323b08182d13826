"""Self-attention (Edge-MoE §IV-A + §IV-B), the port of the encoder part of
``repro.core.attention``.

  * ``naive_attention``   — materializes the N×N score matrix (the paper's
                            "without reordering" baseline).
  * ``blocked_attention`` — streams K/V in blocks with (m, l, acc) carries.
  * ``attention``         — the policy-dispatched op (``eager`` naive /
                            ``blocked`` / ``cuda`` kernel / ``ref``).
  * ``decode_attention_xla`` — one-token decode against a KV cache, the
                            ``eager`` impl of ``attention_decode``.
  * ``decode_attention``  — the policy-dispatched decode op (``eager`` /
                            ``cuda`` / ``cuda_fused`` / ``ref``).

GQA (kv heads broadcast over query-head groups), causal masking, sliding
windows and ``q_offset`` as in the reference.
"""

from __future__ import annotations

import math

import torch

__all__ = ["naive_attention", "blocked_attention", "attention",
           "decode_attention_xla", "decode_attention", "allowed_keys",
           "scale_in_dtype", "NEG_INF"]

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked rows NaN-free


def scale_in_dtype(q, scale):
    """``q * scale`` in q's dtype with the scale rounded to that dtype first
    (JAX's weakly typed scalar): the exact product of two bf16 values,
    rounded once.  The rounding of the scale happens on the host, so no
    tensor is copied to the card."""
    return q * float(torch.tensor(scale, dtype=q.dtype))


def allowed_keys(qpos, kpos, causal, window):
    """(Sq, Sk) bool: whether the key at ``kpos[j]`` is visible to the query
    at ``qpos[i]`` (causal: ``kpos <= qpos``; window: ``kpos > qpos −
    window``).  The one mask rule of every attention path in the port."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def _mask_bias(sq, skv, q_offset, causal, window, dtype, device):
    """(sq, skv) additive mask bias; query i sits at i + q_offset."""
    if not causal and window is None:
        return None
    ok = allowed_keys(torch.arange(sq, device=device) + q_offset,
                      torch.arange(skv, device=device), causal, window)
    return torch.where(ok, 0.0, NEG_INF).to(dtype)


def _broadcast_kv(k, v, num_q_heads):
    hkv = k.shape[1]
    if hkv == num_q_heads:
        return k, v
    group = num_q_heads // hkv
    return (k.repeat_interleave(group, dim=1),
            v.repeat_interleave(group, dim=1))


def naive_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    scale=None):
    """O(N²) score matrix; softmax statistics in float32.
    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    b, hq, sq, d = q.shape
    k, v = _broadcast_kv(k, v, hq)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    bias = _mask_bias(sq, k.shape[2], q_offset, causal, window,
                      scores.dtype, q.device)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def blocked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      scale=None, block_k: int = 64):
    """Streaming attention: K/V consumed block by block, Q resident; the
    single-pass softmax carry rescales the accumulator (§IV-A/B)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    skv = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    nblk = -(-skv // block_k)
    pad = nblk * block_k - skv
    if pad:
        padk = torch.zeros(k.shape[:2] + (pad, d), dtype=k.dtype,
                           device=k.device)
        k = torch.cat([k, padk], dim=2)
        v = torch.cat([v, padk.to(v.dtype)], dim=2)
    qpos = torch.arange(sq, device=q.device) + q_offset
    # GQA as a grouped contraction over native kv heads (no repeat)
    qf = (q * scale).reshape(b, hkv, g, sq, d).float()
    m = torch.full((b, hkv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
    for start in range(0, nblk * block_k, block_k):
        kblk = k[:, :, start:start + block_k].float()
        vblk = v[:, :, start:start + block_k]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kblk)
        kpos = start + torch.arange(block_k, device=q.device)
        ok = (kpos[None, :] < skv) & allowed_keys(qpos, kpos, causal, window)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(vblk.dtype).float(), vblk.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-37)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)


def attention(q, k, v, *, causal=True, window=None, q_offset=0, scale=None):
    """Policy-dispatched attention (op ``"attention"``)."""
    from repro_torch.ops.registry import dispatch

    return dispatch("attention", q, k, v, causal=causal, window=window,
                    q_offset=q_offset, scale=scale)


def decode_attention_xla(q, k_cache, v_cache, cache_len, *, window=None,
                         scale=None):
    """One-token decode: q (B, Hq, 1, D) vs cache (B, Hkv, Smax, D).

    ``cache_len`` (B,) int32 — the number of valid entries per sequence;
    the new token's own K/V are already written at ``cache_len − 1``.  GQA
    as a grouped contraction over the native kv heads (no repeat of the
    cache), q scaled in its dtype, float32 scores masked to −1e30, the
    probabilities rounded to the cache's dtype before the PV product — the
    reference's arithmetic."""
    b, hq, one, d = q.shape
    hkv, smax = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    # the reference multiplies by a weakly typed scalar: in q's dtype
    qg = scale_in_dtype(q, scale).reshape(b, hkv, g * one, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_cache.float())
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1)
    cl = cl.expand(b)[:, None, None, None]
    kpos = torch.arange(smax, device=q.device)[None, None, None, :]
    ok = kpos < cl
    if window is not None:
        ok = ok & (kpos > cl - 1 - window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, hq, one, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None,
                     scale=None):
    """Policy-dispatched single-token decode (op ``"attention_decode"``).
    ``cuda`` runs the flash kernel over the live prefix and needs one
    length for every sequence; ``cuda_fused`` reads per-slot lengths on
    the card."""
    from repro_torch.ops.registry import dispatch

    return dispatch("attention_decode", q, k_cache, v_cache, cache_len,
                    window=window, scale=scale)
