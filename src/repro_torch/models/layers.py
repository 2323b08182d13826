"""Model building blocks, the port of the encoder path of
``repro.models.layers``: norms, the MLP, and attention without a KV cache.

Every projection goes through the unified linear op and attention through
the ``attention`` dispatcher; which implementation serves each op is the
ambient compute policy's choice.  Rotary embeddings, KV caches and the LM
head follow with the LM slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.attention import attention
from repro_torch.core.moe import normal
from repro_torch.core.unified_linear import unified_linear

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


def apply_attention(params, x, cfg: ArchConfig, *, causal=True,
                    window=None):
    """x: (B, S, d) -> (B, S, d), training/prefill form (no cache)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _split_heads(unified_linear(x, params["wq"], params.get("bq")),
                     hq, hd)
    k = _split_heads(unified_linear(x, params["wk"], params.get("bk")),
                     hkv, hd)
    v = _split_heads(unified_linear(x, params["wv"], params.get("bv")),
                     hkv, hd)
    o = attention(q, k, v, causal=causal, window=window)
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return unified_linear(o, params["wo"])


# ---------------------------------------------------------------- embeddings


def embed_inputs(inputs, cfg: ArchConfig):
    """Embeddings pass through in the activation dtype (the vit-moe trunk;
    token embeddings come with the LM slice)."""
    if cfg.embed_input != "embeddings":
        raise NotImplementedError("token embeddings come with the LM slice")
    return inputs.to(cfg.activation_dtype)
