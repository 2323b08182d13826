"""Model building blocks, the port of ``repro.models.layers``: norms,
positions (RoPE, sinusoidal), the MLP, attention with KV caches, token
embeddings and the LM head.

Every projection goes through the unified linear op and attention through
the ``attention`` / ``decode_attention`` dispatchers; which implementation
serves each op is the ambient compute policy's choice.  KV caches are
updated in place: where the reference returns a new cache array, the port
writes the new rows into the cache tensors it was given and returns them.
An int8 KV cache (``cfg.kv_quant="int8"``) holds int8 rows and a float32
scale per (token, head); decode hands it to ``attention_decode`` as
``QTensor`` views, which the ``eager_int8`` impl serves.  M-RoPE
(Qwen2-VL) rotates sections of the frequency slots by three position
streams; a (B, S) position is broadcast to all three, as the reference
does.

Tensor parallelism (serving and training over a mesh whose ``model``
axis is larger than one): a block computes on whatever blocks of its
weights the rank holds (``models/transformer.py:model_blocks``; training
gathers them over the batch axes alone), and reads the split from their
widths against the config, never from the rules alone (weights whole on
every rank run the whole path).  Attention takes its
heads from its column blocks of ``wq``/``wk``/``wv`` (k/v whole on every
rank where the KV heads do not divide the axis, each rank attending with
its q heads' one KV head, so its gradient of ``wk``/``wv`` is a part the
ranks sum: the whole k/v pass through the ``f`` below), the MLP and the
shared experts their columns of ``wg``/``wu``/``w1``; the row blocks of
``wo``, ``wd``/``w2`` give float32 partial sums, added over ``model``
before the one rounding (the bias after the sum).  The embedding looks
up this rank's rows of the vocabulary and adds the ranks' rows; the
head gives this rank's columns of the logits, gathered whole before
sampling (training's loss reads the block, vocab-parallel).  A column block's input passes through the
Megatron ``f`` (``spmd.model_input``: its gradient summed over the ranks)
and a row block's partials through the ``g`` (``spmd.model_sum``: its
gradient passed through), so the backward of every rank ends with the
one gradient of the replicated activations.  A column block sums over
K in the whole weight's order (``unified_linear(order_n=)``), so its
columns get the bits the whole product gives them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.attention import attention, decode_attention
from repro_torch.core.moe import normal
from repro_torch.core.unified_linear import unified_linear
from repro_torch.dist import spmd
from repro_torch.dist.sharding import constrain
from repro_torch.quant.qtensor import (QTensor, dequantize, dtype_name,
                                       quantize_kv)
from repro_torch.roofline.scope import scope

_PER_SEQ_PREFILL = ("a multi-row prefill at per-sequence offsets is not "
                    "supported: the scheduler admits each prompt alone, at "
                    "one scalar offset")
_HEAD_ROWS = 16384   # tied-head table rows widened to float32 per product
# On the card the library picks a reduction's (and a product's) split from
# the number of rows, so a row's bits would depend on how many rows share
# the call: a norm reduces over at least _NORM_ROWS rows (short calls are
# padded with zero rows) and the tied head multiplies _HEAD_M rows at a
# time (padded the same way).  A decode row then gets the same bits in a
# batch of 1 or 8, and a prompt's rows alone or in a batch.
_NORM_ROWS = 16
_HEAD_M = 8

# --------------------------------------------------------- tensor parallel


def attention_layout(cfg: ArchConfig, tp: int) -> tuple[bool, bool]:
    """(q heads split, KV heads split) of an attention layer over a
    ``model`` axis of ``tp``, as the reference's trims resolve it: q heads
    split where ``num_heads`` divides the axis, KV heads where
    ``num_kv_heads`` does too (the ``"cache"`` rule's head-sharded
    alternative), else k/v stay whole on every rank, which then needs each
    rank's q heads to lie in one GQA group (MQA always does).  Otherwise
    the layer stays whole (M³ViT's three heads)."""
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if tp == 1 or hq % tp:
        return False, False
    if hkv % tp == 0:
        return True, True
    return (hq // hkv) % (hq // tp) == 0, False


def _kv_group(t, lo: int):
    """KV head ``lo`` of a (B, Hkv, S, hd) tensor or a ``QTensor`` over
    one (the one head a rank's q heads read where k/v stay whole)."""
    if isinstance(t, QTensor):
        return QTensor(t.q.narrow(1, lo, 1), t.scale.narrow(1, lo, 1),
                       dtype=t.dtype)
    return t.narrow(1, lo, 1)


# ---------------------------------------------------------------- norms


def init_norm(cfg: ArchConfig, d=None):
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32)
    return p


def _pad_rows(x2, rows: int):
    """x2 (M, N) with zero rows appended up to ``rows``."""
    return torch.nn.functional.pad(x2, (0, 0, 0, rows - x2.shape[0]))


def _row_mean(v):
    """Mean over the last dim, keepdim, in an order that does not depend on
    the number of rows (``_NORM_ROWS``)."""
    m = v.numel() // v.shape[-1]
    if v.device.type != "cuda" or m >= _NORM_ROWS:
        return v.mean(-1, keepdim=True)
    return _pad_rows(v.reshape(m, -1), _NORM_ROWS).mean(
        -1, keepdim=True)[:m].reshape(*v.shape[:-1], 1)


@scope("norm")
def apply_norm(params, x, cfg: ArchConfig, eps=1e-6):
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = _row_mean(xf)
        var = _row_mean((xf - mu) ** 2)
        y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] \
            + params["bias"]
    else:  # rmsnorm
        ms = _row_mean(xf * xf)
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


MROPE_SECTIONS = (0.25, 0.375, 0.375)  # temporal / height / width fractions


def apply_mrope(x, pos3, theta: float):
    """M-RoPE (Qwen2-VL): the hd/2 frequency slots split into (t, h, w)
    sections of ``int(half·0.25)``, ``int(half·0.375)`` and the rest, each
    rotated by its own position stream.  x: (B, H, S, hd); pos3:
    (3, B, S) int.  Float32 angles and rotation, as :func:`apply_rope`."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(hd, theta, x.device)                  # (half,)
    n_t = int(half * MROPE_SECTIONS[0])
    n_h = int(half * MROPE_SECTIONS[1])
    sec = torch.cat([torch.zeros(n_t, dtype=torch.long),
                     torch.ones(n_h, dtype=torch.long),
                     torch.full((half - n_t - n_h,), 2, dtype=torch.long)])
    pos_sel = pos3[sec.to(pos3.device)].float()              # (half, B, S)
    angles = pos_sel.permute(1, 2, 0) * freqs                # (B, S, half)
    cos = torch.cos(angles)[:, None]                         # (B,1,S,half)
    sin = torch.sin(angles)[:, None]
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


@scope("mlp")
def apply_mlp(params, x, cfg: ArchConfig):
    down = params["wd"] if "wd" in params else params["w2"]
    if down.shape[0] != cfg.d_ff:
        return _apply_mlp_split(params, x, cfg)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = "silu" if cfg.mlp_kind == "swiglu" else "gelu"
        g = unified_linear(x, params["wg"], activation=act)
        u = unified_linear(x, params["wu"])
        h = constrain((g * u).to(x.dtype), "btf")
        return unified_linear(h, params["wd"])
    h = unified_linear(x, params["w1"], params["b1"], activation="gelu")
    h = constrain(h, "btf")
    return unified_linear(h, params["w2"], params["b2"])


def _apply_mlp_split(params, x, cfg: ArchConfig):
    """The MLP on this rank's columns of the hidden layer: column blocks
    of ``wg``/``wu``/``w1`` (and ``b1``) with their epilogue per shard, a
    row block of ``wd``/``w2`` giving float32 partials, one all-reduce,
    then ``b2`` and the one rounding."""
    x = spmd.model_input(x, "mlp input")
    f = cfg.d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = "silu" if cfg.mlp_kind == "swiglu" else "gelu"
        g = unified_linear(x, params["wg"], activation=act, order_n=f)
        u = unified_linear(x, params["wu"], order_n=f)
        h = constrain((g * u).to(x.dtype), "btf")
        y = unified_linear(h, params["wd"], out_dtype=torch.float32)
        return spmd.model_sum(y, "mlp_down all-reduce").to(x.dtype)
    h = unified_linear(x, params["w1"], params["b1"], activation="gelu",
                       order_n=f)
    h = constrain(h, "btf")
    y = unified_linear(h, params["w2"], out_dtype=torch.float32)
    y = spmd.model_sum(y, "mlp_down all-reduce") + params["b2"].float()
    return y.to(x.dtype)


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
            raise NotImplementedError(_PER_SEQ_PREFILL)
        start = slot.to(c.device).long().clamp(0, smax - 1)
        c[torch.arange(c.shape[0], device=c.device), :, start] = new[:, :, 0]
        return c
    start = min(max(int(slot), 0), smax - s)
    c[:, :, start:start + s] = new
    return c


def _kv_write(cache, k, v, slot, kvq: bool):
    """Write fp K/V rows into the cache in place, quantized per (token,
    head) when the cache is int8 (``kvq``)."""
    rows = {"k": k, "v": v}
    if kvq:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    for name, new in rows.items():
        cache[name] = constrain(_upd_cache(cache[name], new, slot), "cache")
    return cache


def _kv_read(cache, kvq: bool, dtype):
    """The cache's K/V as ``attention_decode`` takes them: ``QTensor``
    views of an int8 cache (logical dtype ``dtype``), else the tensors."""
    if kvq:
        return (QTensor(cache["k"], cache["k_scale"], dtype=dtype_name(dtype)),
                QTensor(cache["v"], cache["v_scale"], dtype=dtype_name(dtype)))
    return cache["k"], cache["v"]


def _kv_full(cache, kvq: bool, dtype):
    """Dense K/V of a cache (dequantized when int8) — what chunked prefill
    attends to; the cache itself stays packed."""
    k, v = _kv_read(cache, kvq, dtype)
    return (dequantize(k), dequantize(v)) if kvq else (k, v)


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

    Returns (y, cache).  cache = {"k": (B, Hkv, Smax, hd), "v": ...} (int8
    with ``k_scale``/``v_scale`` (B, Hkv, Smax, 1) when quantized), updated
    in place.  ``cache_index`` is an int (every sequence at one
    position) or a (B,) tensor (each at its own); a layer with a window and
    a cache of at most ``window`` slots keeps a ring (token t at slot
    t % Smax)."""
    b, s, _ = x.shape
    hd = cfg.hd
    # this rank's heads: its column blocks of wq / wk / wv (all of them
    # where the layer is whole)
    hq, hkv = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
    split = hq != cfg.num_heads
    group = None    # the one KV head this rank's q heads read (k/v whole)
    if split:
        x = spmd.model_input(x, "attn input")
        if hkv == cfg.num_kv_heads:
            # k/v whole on every rank, each reading them for its q heads
            # alone: the ranks' gradients of wk/wv are parts of the whole
            # one, summed over model by the f
            params = dict(params)
            for name in ("wk", "wv", "bk", "bv"):
                if name in params:
                    params[name] = spmd.model_input(params[name], "attn kv")
            if hkv > 1:
                group = spmd.model_rank() * hq // (cfg.num_heads // hkv)

    def read(t):
        """The KV heads this rank's q heads attend to."""
        return t if group is None else _kv_group(t, group)

    def project(w, bias, heads, whole):
        order = whole * hd if heads != whole else None
        return _split_heads(unified_linear(x, w, bias, order_n=order),
                            heads, hd)

    with scope("attn_qkv"):
        q = constrain(project(params["wq"], params.get("bq"), hq,
                              cfg.num_heads), "bhsd")
        k = constrain(project(params["wk"], params.get("bk"), hkv,
                              cfg.num_kv_heads), "bkvsd")
        v = constrain(project(params["wv"], params.get("bv"), hkv,
                              cfg.num_kv_heads), "bkvsd")
    with scope("rope"):
        if cfg.rope == "rope":
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        elif cfg.rope == "mrope":
            pos3 = pos if pos.dim() == 3 else pos.expand(
                (3,) + tuple(pos.shape))
            q = apply_mrope(q, pos3, cfg.rope_theta)
            k = apply_mrope(k, pos3, cfg.rope_theta)

    kvq = cache is not None and "k_scale" in cache
    smax = cache["k"].shape[2] if cache is not None else None
    ring = cache is not None and window is not None and smax <= window
    if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 0:
        cache_index = int(cache_index)
    if cache is not None and cache_index is not None and s == 1:
        # decode: write the new token, attend over the cache
        ci = cache_index
        slot = ci % smax if ring else ci
        _kv_write(cache, k, v, slot, kvq)
        kr, vr = map(read, _kv_read(cache, kvq, k.dtype))
        cache_len = _cache_len(ci, b, x.device)
        if ring:
            # every live slot lies inside the window by construction
            o = decode_attention(q, kr, vr, torch.clamp_max(cache_len, smax))
        else:
            o = decode_attention(q, kr, vr, cache_len, window=window)
    elif cache is not None and not ring and cache_index is not None:
        # (chunked) prefill: write the chunk at its absolute offset and
        # attend against everything cached so far; causal masking by
        # absolute position covers the first chunk and continuations
        if isinstance(cache_index, torch.Tensor):
            raise NotImplementedError(_PER_SEQ_PREFILL)
        _kv_write(cache, k, v, cache_index, kvq)
        kc, vc = map(read, _kv_full(cache, kvq, k.dtype))
        o = attention(q, kc, vc, causal=causal, window=window,
                      q_offset=cache_index)
    else:
        o = attention(q, read(k), read(v), causal=causal, window=window)
        if cache is not None:
            if ring and s > smax:
                # keep the last smax tokens, rotated so token t sits at
                # slot t % smax
                shift = (s - smax) % smax
                _kv_write(cache, torch.roll(k[:, :, -smax:], shift, dims=2),
                          torch.roll(v[:, :, -smax:], shift, dims=2), 0, kvq)
            else:
                _kv_write(cache, k, v, 0, kvq)
    o = constrain(o, "bhsd")
    with scope("attn_out"):
        o = o.transpose(1, 2).reshape(b, s, hq * hd)
        if split:
            # a row block of wo: float32 partials, added over the ranks,
            # then the one rounding
            y = unified_linear(o, params["wo"], out_dtype=torch.float32)
            y = spmd.model_sum(y, "attn_out all-reduce").to(x.dtype)
            return constrain(y, "btd"), cache
        return constrain(unified_linear(o, params["wo"]), "btd"), cache


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                    device=None, kv_heads: int | None = None):
    """A zeroed KV cache of ``kv_heads`` heads (default: all of the
    config's; a rank's block where the ``"cache"`` rule splits them)."""
    heads = kv_heads or cfg.num_kv_heads
    shape = (batch, heads, max_len, cfg.hd)
    if cfg.kv_quant == "int8":
        sshape = (batch, heads, max_len, 1)
        return {"k": constrain(torch.zeros(shape, dtype=torch.int8,
                                           device=device), "cache"),
                "v": constrain(torch.zeros(shape, dtype=torch.int8,
                                           device=device), "cache"),
                "k_scale": constrain(torch.zeros(sshape, dtype=torch.float32,
                                                 device=device), "cache"),
                "v_scale": constrain(torch.zeros(sshape, dtype=torch.float32,
                                                 device=device), "cache")}
    if cfg.kv_quant != "none":
        raise ValueError(f"unknown kv_quant {cfg.kv_quant!r} "
                         "(expected none | int8)")
    return {"k": constrain(torch.zeros(shape, dtype=dtype, device=device),
                           "cache"),
            "v": constrain(torch.zeros(shape, dtype=dtype, device=device),
                           "cache")}


# ---------------------------------------------------------------- embeddings


def init_embed(rng: np.random.Generator, cfg: ArchConfig, dtype):
    p = {}
    if cfg.embed_input == "tokens":
        p["tokens"] = normal(rng, (cfg.vocab_size, cfg.d_model), 0.02, dtype)
    return p


@scope("embed")
def embed_inputs(params, inputs, cfg: ArchConfig):
    """tokens (B, S) int -> (B, S, d); embeddings pass through in the
    activation dtype (the vit-moe trunk, stub frontends)."""
    if cfg.embed_input == "tokens":
        # embedding(), not indexing: the same rows (a negative id wraps as
        # an index does), and a backward that sums a repeated token's
        # gradients in a fixed order on the card
        ids = inputs.long()
        ids = torch.where(ids < 0, ids + cfg.vocab_size, ids)
        table = params["tokens"]
        if table.shape[0] != cfg.vocab_size:
            return constrain(_embed_split(ids, table), "btd")
        return constrain(torch.nn.functional.embedding(ids, table), "btd")
    return constrain(inputs.to(cfg.activation_dtype), "btd")


def _embed_split(ids, table):
    """Vocab-parallel lookup: this rank's rows of the table (its block of
    the vocabulary), −0.0 for the ids other ranks hold, added over
    ``model`` in float32.  Exact: each id's row comes from one rank and
    −0.0 leaves any value (+0.0 too) as it is."""
    rows = table.shape[0]
    local = ids - spmd.model_rank() * rows
    mine = (local >= 0) & (local < rows)
    got = torch.nn.functional.embedding(local.clamp(0, rows - 1), table)
    got = torch.where(mine[..., None], got.float(), -0.0)
    return spmd.model_sum(got, "embed all-reduce").to(table.dtype)


def init_lm_head(rng: np.random.Generator, cfg: ArchConfig, dtype):
    if cfg.tie_embeddings or cfg.vocab_size == 0:
        return {}
    return {"w": normal(rng, (cfg.d_model, cfg.vocab_size),
                        1.0 / math.sqrt(cfg.d_model), dtype)}


@scope("lm_head")
def apply_lm_head(head_params, embed_params, x, cfg: ArchConfig,
                  gather: bool = True):
    """float32 logits.  The tied head is ``x @ tokens.T`` with float32
    products and sums and no rounding of the logits to the activation
    dtype (the reference's ``preferred_element_type=f32``): a plain float32
    product, taken over ``_HEAD_ROWS`` table rows at a time so the widened
    copy of the table never exists whole, and on the card over ``_HEAD_M``
    rows of x at a time.  A rank holding a block of the vocabulary gives
    its columns, gathered whole over ``model`` unless ``gather`` is False
    (training's vocab-parallel loss, ``models/model.py:lm_loss``)."""
    if cfg.vocab_size == 0:
        return x  # feature trunk (M3ViT): task heads applied by the caller
    w = embed_params["tokens"] if cfg.tie_embeddings else head_params["w"]
    if (w.shape[0] if cfg.tie_embeddings else w.shape[-1]) \
            != cfg.vocab_size:
        # this rank's vocabulary block, the whole logits gathered over
        # model before sampling
        block = _lm_head(w, spmd.model_input(x, "lm_head input"), cfg)
        if not gather:
            return constrain(block, "btv")
        return constrain(spmd.model_gather(block, "logits all-gather"),
                         "btv")
    return constrain(_lm_head(w, x, cfg), "btv")


def _lm_head(w, x, cfg: ArchConfig):
    """float32 logits of the vocabulary ``w`` holds (all of it, or a
    rank's block): the tied table ``(V, d)`` or ``head/w`` ``(d, V)``."""
    if cfg.tie_embeddings:
        table = w
        x2 = x.float().reshape(-1, x.shape[-1])
        m = x2.shape[0]
        blocks = [x2]
        if x2.device.type == "cuda" and m != _HEAD_M:
            blocks = list(_pad_rows(x2, -(-m // _HEAD_M) * _HEAD_M).split(
                _HEAD_M))

        def product(t):
            parts = [xb @ t for xb in blocks]
            return parts[0] if len(parts) == 1 else torch.cat(parts)

        out = torch.cat([product(table[i:i + _HEAD_ROWS].float().T)
                         for i in range(0, table.shape[0], _HEAD_ROWS)], -1)
        return out[:m].reshape(*x.shape[:-1], -1)
    order = cfg.vocab_size if w.shape[-1] != cfg.vocab_size else None
    return unified_linear(x, w, preferred_dtype=torch.float32,
                          order_n=order).float()
