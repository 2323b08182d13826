"""Model building blocks, the port of ``repro.models.layers``: norms,
positions (RoPE, sinusoidal), the MLP, attention with KV caches, token
embeddings and the LM head.

Every projection goes through the unified linear op and attention through
the ``attention`` / ``decode_attention`` dispatchers; which implementation
serves each op is the ambient compute policy's choice.  KV caches are
updated in place: where the reference returns a new cache array, the port
writes the new rows into the cache tensors it was given and returns them.
M-RoPE and the int8 KV cache follow with later slices and raise here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.attention import attention, decode_attention
from repro_torch.core.moe import normal
from repro_torch.core.unified_linear import unified_linear

_MROPE_LATER = "M-RoPE comes with the vision-language slice of the port"
_KV_INT8_LATER = "the int8 KV cache comes with the packed-formats slice " \
                 "of the port (quant/qtensor.py)"
_HEAD_ROWS = 16384   # tied-head table rows widened to float32 per product

# ---------------------------------------------------------------- norms


def init_norm(cfg: ArchConfig, d=None):
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32)
    return p


def apply_norm(params, x, cfg: ArchConfig, eps=1e-6):
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] \
            + params["bias"]
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------- positions


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, pos, theta: float):
    """x: (B, H, S, hd); pos: (B, S) int.  Rotates the (first, second)
    halves by float32 angles ``pos · freqs``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = pos[:, None, :, None].float() * freqs           # (B,1,S,hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sincos_positions(seq_len: int, d: int, offset=0, device=None):
    """Classic sinusoidal embedding, added to inputs.  ``offset`` is a
    scalar or a (B,) vector (each slot at its own position) — returns
    (S, d) or (B, S, d) float32."""
    offset = torch.as_tensor(offset, dtype=torch.float32, device=device)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    if offset.dim() == 1:
        pos = pos[None, :] + offset[:, None]
    else:
        pos = pos + offset
    freqs = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                            device=device) / d))
    ang = pos[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def position_encode(x, cfg: ArchConfig, offset=0):
    if cfg.rope == "sincos":
        return x + sincos_positions(x.shape[-2], cfg.d_model, offset,
                                    x.device).to(x.dtype)
    return x


# ---------------------------------------------------------------- mlp


def init_mlp(rng: np.random.Generator, cfg: ArchConfig, dtype):
    d, f = cfg.d_model, cfg.d_ff
    s, sf = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {"wg": normal(rng, (d, f), s, dtype),
                "wu": normal(rng, (d, f), s, dtype),
                "wd": normal(rng, (f, d), sf, dtype)}
    return {"w1": normal(rng, (d, f), s, dtype),     # the paper's ViT MLP
            "b1": torch.zeros((f,), dtype=torch.float32),
            "w2": normal(rng, (f, d), sf, dtype),
            "b2": torch.zeros((d,), dtype=torch.float32)}


def apply_mlp(params, x, cfg: ArchConfig):
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = "silu" if cfg.mlp_kind == "swiglu" else "gelu"
        g = unified_linear(x, params["wg"], activation=act)
        u = unified_linear(x, params["wu"])
        return unified_linear((g * u).to(x.dtype), params["wd"])
    h = unified_linear(x, params["w1"], params["b1"], activation="gelu")
    return unified_linear(h, params["w2"], params["b2"])


# ---------------------------------------------------------------- attention


def init_attention(rng: np.random.Generator, cfg: ArchConfig, dtype):
    d, hd = cfg.d_model, cfg.hd
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(hq * hd)
    p = {"wq": normal(rng, (d, hq * hd), s, dtype),
         "wk": normal(rng, (d, hkv * hd), s, dtype),
         "wv": normal(rng, (d, hkv * hd), s, dtype),
         "wo": normal(rng, (hq * hd, d), so, dtype)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), dtype=torch.float32)
        p["bk"] = torch.zeros((hkv * hd,), dtype=torch.float32)
        p["bv"] = torch.zeros((hkv * hd,), dtype=torch.float32)
    return p


def _split_heads(x, n_heads, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, hd).transpose(1, 2)


def _upd_cache(c, new, slot):
    """Write ``new`` (B, H, s, hd) into cache ``c`` (B, H, Smax, hd) in
    place at position ``slot`` — an int, or a (B,) tensor when each
    sequence writes its one decode row at its own slot (continuous
    batching).  The start is clamped so the rows fit, as
    ``dynamic_update_slice`` clamps it."""
    s, smax = new.shape[2], c.shape[2]
    if isinstance(slot, torch.Tensor) and slot.dim() == 1:
        if s != 1:
            raise NotImplementedError("prefill at per-sequence offsets "
                                      "comes with the scheduler slice")
        start = slot.to(c.device).long().clamp(0, smax - 1)
        c[torch.arange(c.shape[0], device=c.device), :, start] = new[:, :, 0]
        return c
    start = min(max(int(slot), 0), smax - s)
    c[:, :, start:start + s] = new
    return c


def _kv_write(cache, k, v, slot):
    """Write fp K/V rows into the cache in place."""
    _upd_cache(cache["k"], k, slot)
    _upd_cache(cache["v"], v, slot)
    return cache


def _kv_full(cache):
    """Dense K/V views of an fp cache (what chunked prefill attends to)."""
    return cache["k"], cache["v"]


def _cache_len(ci, b, device):
    """``ci + 1`` broadcast to a (B,) int32 tensor on ``device``."""
    if isinstance(ci, torch.Tensor):
        return (ci.to(device=device, dtype=torch.int32) + 1).reshape(
            -1).expand(b).contiguous()
    return torch.full((b,), int(ci) + 1, dtype=torch.int32, device=device)


def apply_attention(params, x, cfg: ArchConfig, *, pos=None, causal=True,
                    window=None, cache=None, cache_index=None):
    """x: (B, S, d).  Training/prefill when ``cache`` is None or being
    filled; decode (S == 1) when ``cache_index`` is given.

    Returns (y, cache).  cache = {"k": (B, Hkv, Smax, hd), "v": ...},
    updated in place.  ``cache_index`` is an int (every sequence at one
    position) or a (B,) tensor (each at its own); a layer with a window and
    a cache of at most ``window`` slots keeps a ring (token t at slot
    t % Smax)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _split_heads(unified_linear(x, params["wq"], params.get("bq")),
                     hq, hd)
    k = _split_heads(unified_linear(x, params["wk"], params.get("bk")),
                     hkv, hd)
    v = _split_heads(unified_linear(x, params["wv"], params.get("bv")),
                     hkv, hd)
    if cfg.rope == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    elif cfg.rope == "mrope":
        raise NotImplementedError(_MROPE_LATER)

    if cache is not None and "k_scale" in cache:
        raise NotImplementedError(_KV_INT8_LATER)
    smax = cache["k"].shape[2] if cache is not None else None
    ring = cache is not None and window is not None and smax <= window
    if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 0:
        cache_index = int(cache_index)
    if cache is not None and cache_index is not None and s == 1:
        # decode: write the new token, attend over the cache
        ci = cache_index
        slot = ci % smax if ring else ci
        _kv_write(cache, k, v, slot)
        cache_len = _cache_len(ci, b, x.device)
        if ring:
            # every live slot lies inside the window by construction
            o = decode_attention(q, cache["k"], cache["v"],
                                 torch.clamp_max(cache_len, smax))
        else:
            o = decode_attention(q, cache["k"], cache["v"], cache_len,
                                 window=window)
    elif cache is not None and not ring and cache_index is not None:
        # (chunked) prefill: write the chunk at its absolute offset and
        # attend against everything cached so far; causal masking by
        # absolute position covers the first chunk and continuations
        if isinstance(cache_index, torch.Tensor):
            raise NotImplementedError("prefill at per-sequence offsets "
                                      "comes with the scheduler slice")
        _kv_write(cache, k, v, cache_index)
        kc, vc = _kv_full(cache)
        o = attention(q, kc, vc, causal=causal, window=window,
                      q_offset=cache_index)
    else:
        o = attention(q, k, v, causal=causal, window=window)
        if cache is not None:
            if ring and s > smax:
                # keep the last smax tokens, rotated so token t sits at
                # slot t % smax
                shift = (s - smax) % smax
                _kv_write(cache, torch.roll(k[:, :, -smax:], shift, dims=2),
                          torch.roll(v[:, :, -smax:], shift, dims=2), 0)
            else:
                _kv_write(cache, k, v, 0)
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return unified_linear(o, params["wo"]), cache


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                    device=None):
    if cfg.kv_quant == "int8":
        raise NotImplementedError(_KV_INT8_LATER)
    if cfg.kv_quant != "none":
        raise ValueError(f"unknown kv_quant {cfg.kv_quant!r} "
                         "(expected none | int8)")
    shape = (batch, cfg.num_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------- embeddings


def init_embed(rng: np.random.Generator, cfg: ArchConfig, dtype):
    p = {}
    if cfg.embed_input == "tokens":
        p["tokens"] = normal(rng, (cfg.vocab_size, cfg.d_model), 0.02, dtype)
    return p


def embed_inputs(params, inputs, cfg: ArchConfig):
    """tokens (B, S) int -> (B, S, d); embeddings pass through in the
    activation dtype (the vit-moe trunk, stub frontends)."""
    if cfg.embed_input == "tokens":
        return params["tokens"][inputs.long()]
    return inputs.to(cfg.activation_dtype)


def init_lm_head(rng: np.random.Generator, cfg: ArchConfig, dtype):
    if cfg.tie_embeddings or cfg.vocab_size == 0:
        return {}
    return {"w": normal(rng, (cfg.d_model, cfg.vocab_size),
                        1.0 / math.sqrt(cfg.d_model), dtype)}


def apply_lm_head(head_params, embed_params, x, cfg: ArchConfig):
    """float32 logits.  The tied head is ``x @ tokens.T`` with float32
    products and sums and no rounding of the logits to the activation
    dtype (the reference's ``preferred_element_type=f32``): a plain float32
    product, taken over ``_HEAD_ROWS`` table rows at a time so the widened
    copy of the table never exists whole."""
    if cfg.vocab_size == 0:
        return x  # feature trunk (M3ViT): task heads applied by the caller
    if cfg.tie_embeddings:
        xf, table = x.float(), embed_params["tokens"]
        return torch.cat([torch.matmul(xf, table[i:i + _HEAD_ROWS].float().T)
                          for i in range(0, table.shape[0], _HEAD_ROWS)], -1)
    logits = unified_linear(x, head_params["w"],
                            preferred_dtype=torch.float32)
    return logits.float()
