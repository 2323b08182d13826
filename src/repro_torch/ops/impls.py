"""Registered implementations for the ops on the M³ViT path — the port of
the corresponding part of ``repro.ops.impls``.

Imported lazily by ``registry.dispatch``.  Each impl follows the registry
contract ``fn(policy, *args, **kwargs)``; an impl registered with
``dims`` (blocked attention) also takes its resolved tile blocks as
``tiles=`` (``ops/schedules.py``).  Impl names: ``eager`` (plain
PyTorch, the reference's ``xla``), ``blocked``, ``lut``, ``cuda`` (the
Hopper kernels, the reference's ``pallas``), ``cuda_fused`` (the fused
kernels, the reference's ``pallas_fused``), ``ref``, and for packed
weights ``eager_int8`` (QTensor weights and int8 KV caches, the
reference's ``xla_int8``) and ``eager_factored`` (FactoredTensor weights,
the reference's ``xla_factored``).  Capability predicates return the
reference's reason strings, with the port's impl names: every
floating-point and kernel impl rejects a packed operand, so it reaches
the packed impl as a recorded fallback, never a crash.

Training: the ``cuda`` impls of ``linear``, ``attention``, ``activation``
and ``moe_grouped_gemm`` run their kernels inside ``torch.autograd``
Functions with a backward (``kernels/*.py``).  Every impl with no backward
refuses, by its capability predicate, an operand that requires grad while
gradients are enabled, and says why: ``moe_ffn``/``cuda_fused``, the decode
kernels of ``attention_decode``, and the packed impls for a packed weight
(a QTensor's scale or a FactoredTensor's factors).  On the card a refused
kernel impl then raises (``DispatchError``) instead of running a plain
version in the kernel's place.

The packed impls are plain PyTorch, as the reference's are plain XLA (no
Pallas kernel): they upcast to the policy's accumulation dtype and
multiply there.  Their expert products run one expert at a time
(``factor.factored.per_expert_products``), so a product's shape never
depends on how many experts share the call and a paged wave gives the
all-resident bits; the int8/int4 linear multiplies in fixed 64-row
products on the card, so a row's bits do not depend on how many rows share
the call (a prompt prefilled whole or in chunks gives the same tokens).
"""

from __future__ import annotations

import torch

from repro_torch.core import gelu as gelu_lib
from repro_torch.factor.factored import (factored_linear, factored_moe_gemm,
                                         is_factored, per_expert_products)
from repro_torch.kernels import decode_fused as kdf
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import gelu_lut as kgl
from repro_torch.kernels import moe_fused as kmf
from repro_torch.kernels import moe_gemm as kmg
from repro_torch.kernels import ref as kref
from repro_torch.kernels import unified_linear as kul
from repro_torch.ops import apply_activation
from repro_torch.ops.registry import register
from repro_torch.quant.qtensor import dequantize, is_qtensor
from repro_torch.roofline.op_cost import Part, register_cost
from repro_torch.roofline.scope import scope

__all__ = ["apply_activation"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: rows of one float32 product of the packed linear impl on the card.  The
#: library picks a product's algorithm from its row count, so a row's bits
#: would depend on how many rows share the call (a prompt prefilled whole
#: or in chunks, a frame alone or in a batch); products of exactly this
#: many rows, the last zero-padded, give a row the same bits at any M
_PACKED_ROWS = 64


def _packed(x) -> bool:
    return is_qtensor(x) or is_factored(x)


def _floating(*tensors) -> bool:
    return all(not _packed(t) and t.is_floating_point() for t in tensors)


def _reject_packed(*operands):
    """Reason string when any operand is packed — the floating-point and
    kernel impls send QTensors to ``eager_int8`` and FactoredTensors to
    ``eager_factored`` loudly (a recorded fallback), never crash on or
    silently expand them (the reference's ``_reject_qtensor``)."""
    if any(is_qtensor(a) for a in operands):
        return "operand is quantized (QTensor) — served by the eager_int8 " \
               "impl"
    if any(is_factored(a) for a in operands):
        return "operand is factored (FactoredTensor) — served by the " \
               "eager_factored impl"
    return None


def _requires_grad(x) -> bool:
    if is_qtensor(x):
        return x.q.requires_grad or x.scale.requires_grad
    if is_factored(x):
        return any(_requires_grad(t) for t in (x.basis, x.u, x.v))
    return isinstance(x, torch.Tensor) and x.requires_grad


def _no_backward(what, *operands):
    """Reason string when gradients are on and an operand requires one:
    ``what`` (an impl with no backward) would cut the gradient."""
    if torch.is_grad_enabled() and any(_requires_grad(a) for a in operands):
        return f"an operand requires grad and {what} has no backward"
    return None


def _kernel_dtype(*tensors):
    """Reason string when a kernel cannot take the operands' dtype."""
    for t in tensors:
        if t.dtype not in _KERNEL_DTYPES:
            return f"dtype {t.dtype}: the kernel takes float32 or bfloat16"
    return None


# ------------------------------------------------------------------ costs
#
# Each op's analytic cost (``roofline/op_cost.py``): the same whatever impl
# serves the op, with the FLOPs as the reference's HLO counts its plain
# (``xla``) path — products 2·M·N·K, elementwise ops one an element, a
# transcendental also tallied apart — and bytes as each operand read once
# and each output written once.


def _stored_bytes(t) -> int:
    """Bytes a (possibly packed) operand occupies."""
    if t is None:
        return 0
    if is_qtensor(t):
        return _stored_bytes(t.q) + _stored_bytes(t.scale)
    if is_factored(t):
        return sum(_stored_bytes(f) for f in (t.basis, t.u, t.v))
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return 0


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


#: (flops, transcendentals) an element of each activation's exact form:
#: relu = max; gelu = x·0.5·(1 + erf(x/√2)); silu = x·logistic(x)
_ACT_FLOPS = {"relu": (1, 0), "gelu": (5, 1), "silu": (2, 1),
              None: (0, 0), "none": (0, 0), "identity": (0, 0)}


def _act_parts(kind, n, where=None):
    f, tr = _ACT_FLOPS[kind]
    return [Part(f * n, 0.0, tr * n, where, "activation")] if f else []


# ================================================================ activation


_EXACT = {
    "relu": torch.relu,
    "gelu": gelu_lib.exact_gelu,
    "silu": gelu_lib.exact_silu,
}


def _act_eager(policy, x, *, kind):
    return _EXACT[kind](x)


def _act_lut_requires(policy, x, *, kind):
    if kind not in ("gelu", "silu"):
        return f"no LUT correction table for {kind!r} (gelu/silu only)"
    return None


def _act_lut(policy, x, *, kind):
    return gelu_lib.lut_activation(x, kind=kind,
                                   step_log2=policy.lut_step_log2,
                                   rng=policy.lut_range)


def _act_cuda_requires(policy, x, *, kind):
    if kind not in ("gelu", "silu"):
        return f"no LUT correction table for {kind!r} (gelu/silu only)"
    if not _floating(x):
        return f"non-float input dtype {x.dtype}"
    return _kernel_dtype(x)


def _act_cuda(policy, x, *, kind):
    return kgl.lut_activation(x, kind, step_log2=policy.lut_step_log2,
                              lut_range=policy.lut_range)


register("activation", "eager", _act_eager,
         doc="exact erf-GELU / sigmoid-SiLU / ReLU, any dtype")
register("activation", "lut", _act_lut, requires=_act_lut_requires,
         default=True,
         doc="ReLU − δ(|x|) half-table (§IV-C); gelu/silu only")
register("activation", "cuda", _act_cuda, requires=_act_cuda_requires,
         kernel=True,
         doc="LUT kernel, shared-memory table; gelu/silu, f32/bf16")


def _act_cost(x, *, kind):
    n = x.numel()
    f, tr = _ACT_FLOPS[kind]
    return [Part(f * n, 2.0 * n * x.element_size(), tr * n)]


register_cost("activation", _act_cost)


# ================================================================= attention


def _attn_eager(policy, q, k, v, **kw):
    from repro_torch.core import attention as A

    return A.naive_attention(q, k, v, **kw)


def _attn_dims(q, k, v, **kw):
    return {"sq": q.shape[2], "skv": k.shape[2], "d": q.shape[3]}


def _attn_blocked(policy, q, k, v, *, tiles, **kw):
    from repro_torch.core import attention as A

    return A.blocked_attention(q, k, v, block_k=tiles.get("block_k", 64),
                               **kw)


def _attn_cuda_requires(policy, q, k, v, *, causal=True, window=None,
                        q_offset=0, scale=None):
    if not _floating(q, k, v):
        return f"non-float dtypes {q.dtype}/{k.dtype}"
    if q.shape[1] % k.shape[1] != 0:
        return f"Hq={q.shape[1]} not a multiple of Hkv={k.shape[1]}"
    if q.shape[-1] > kfa.MAX_D:
        return f"head_dim {q.shape[-1]} > {kfa.MAX_D}"
    if q.dtype != k.dtype or q.dtype != v.dtype:
        return f"mixed dtypes {q.dtype}/{k.dtype}/{v.dtype}"
    return _kernel_dtype(q)


def _attn_cuda(policy, q, k, v, *, causal=True, window=None, q_offset=0,
               scale=None):
    return kfa.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=int(q_offset), scale=scale)


def _attn_ref(policy, q, k, v, **kw):
    return kref.ref_attention(q, k, v, **kw)


register("attention", "blocked", _attn_blocked, default=True,
         dims=_attn_dims,
         doc="streaming K/V blocks + online-softmax carry (§IV-A/B)")
register("attention", "eager", _attn_eager,
         doc="materialized N×N scores (paper baseline), any mask")
register("attention", "cuda", _attn_cuda, requires=_attn_cuda_requires,
         kernel=True,
         doc="tiled flash kernel; f32/bf16, GQA-divisible heads, head_dim <= "
             "256")
register("attention", "ref", _attn_ref,
         doc="oracle: the kernel's plain version (f32 softmax, −1e30 "
             "masking)")


#: elementwise ops a score element of the plain attention costs, as the
#: reference's HLO counts them: the softmax statistics (max, subtract,
#: exp, sum) in ``attn_scores``, the normalizing divide in ``attn_pv``; a
#: causal or windowed mask adds its bias and its select
_SOFTMAX_STATS, _MASK_OPS, _NORMALIZE = 4, 2, 1


def _attn_cost(q, k, v, *, causal=True, window=None, q_offset=0,
               scale=None):
    b, hq, sq, d = q.shape
    skv, dv = k.shape[2], v.shape[-1]
    pairs = b * hq * sq * skv
    per = _SOFTMAX_STATS + (_MASK_OPS if causal or window is not None
                            else 0)
    out_bytes = b * hq * sq * dv * q.element_size()
    return [Part(2.0 * pairs * d + per * pairs + b * hq * sq * d,
                 _stored_bytes(q) + _stored_bytes(k), pairs,
                 "attn_scores"),
            Part(2.0 * pairs * dv + _NORMALIZE * pairs,
                 _stored_bytes(v) + out_bytes, 0.0, "attn_pv")]


register_cost("attention", _attn_cost)


# ========================================================== attention_decode


def _decode_eager(policy, q, k_cache, v_cache, cache_len, *, window=None,
                  scale=None):
    from repro_torch.core import attention as A

    return A.decode_attention_xla(q, k_cache, v_cache, cache_len,
                                  window=window, scale=scale)


def _decode_fp_requires(policy, q, k_cache, v_cache, cache_len, *,
                        window=None, scale=None):
    return _reject_packed(q, k_cache, v_cache)


def _decode_kernel_requires(policy, q, k_cache, v_cache, cache_len, *,
                            window=None, scale=None):
    why = _reject_packed(q, k_cache, v_cache) or _no_backward(
        "the decode kernel (decode is serving only)", q, k_cache, v_cache)
    if why:
        return why
    if not _floating(q, k_cache, v_cache):
        return f"non-float dtypes {q.dtype}/{k_cache.dtype}"
    if q.shape[1] % k_cache.shape[1] != 0:
        return f"Hq={q.shape[1]} not a multiple of Hkv={k_cache.shape[1]}"
    if q.shape[-1] > kdf.MAX_D:
        return f"head_dim {q.shape[-1]} > {kdf.MAX_D}"
    if q.dtype != k_cache.dtype or q.dtype != v_cache.dtype:
        return f"mixed dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}"
    return _kernel_dtype(q)


def _decode_cuda_requires(policy, q, k_cache, v_cache, cache_len, *,
                          window=None, scale=None):
    why = _decode_kernel_requires(policy, q, k_cache, v_cache, cache_len)
    if why:
        return why
    # a host read of the (B,) lengths; the reference's other reason,
    # "cache_len is traced", has no counterpart in eager PyTorch
    lengths = torch.as_tensor(cache_len).reshape(-1)
    if lengths.device.type == "meta":
        return "cache lengths on the meta device (a shape-only run) cannot " \
               "be read on the host"
    if lengths.numel() > 1 and not bool((lengths == lengths[0]).all()):
        return "per-sequence cache lengths differ (continuous batching " \
               "mixes decode positions)"
    return None


def _decode_cuda(policy, q, k_cache, v_cache, cache_len, *, window=None,
                 scale=None):
    # uniform length L: the decode step is the flash kernel over the first
    # L cache rows with the causal frontier at L − 1 (the new token's K/V
    # are already written at L − 1).  Non-uniform lengths are rejected,
    # and with operands on the card a rejected kernel impl raises: under
    # policy_named("cuda") continuous batching on the card raises here —
    # it asks for attention_decode="cuda_fused", which reads per-slot
    # lengths at run time.
    length = int(torch.as_tensor(cache_len).reshape(-1)[0])
    return kfa.flash_attention(q, k_cache[:, :, :length],
                               v_cache[:, :, :length], causal=True,
                               window=window, q_offset=length - 1,
                               scale=scale)


def _decode_fused(policy, q, k_cache, v_cache, cache_len, *, window=None,
                  scale=None):
    # single-pass kernel: per-slot cache lengths are read on the card at
    # run time, so non-uniform decode positions (continuous batching) stay
    # on the kernel
    return kdf.fused_decode_attention(q, k_cache, v_cache, cache_len,
                                      window=window, scale=scale)


def _decode_ref(policy, q, k_cache, v_cache, cache_len, *, window=None,
                scale=None):
    return kref.ref_decode_attention(q, k_cache, v_cache, cache_len,
                                     window=window, scale=scale)


def _decode_int8_requires(policy, q, k_cache, v_cache, cache_len, *,
                          window=None, scale=None):
    if not (is_qtensor(k_cache) and is_qtensor(v_cache)):
        return "KV cache is not quantized (enable kv_quant='int8' to " \
               "build int8 caches)"
    if k_cache.bits != 8 or v_cache.bits != 8:
        return f"int{k_cache.bits} KV cache (int8 only)"
    why = _no_backward("eager_int8 (frozen packed caches)", k_cache, v_cache)
    if why:
        return why
    if not _floating(q):
        return f"non-float query dtype {q.dtype}"
    return None


def _decode_int8(policy, q, k_cache, v_cache, cache_len, *, window=None,
                 scale=None):
    # the per-(token, head) scales broadcast against the int8 payload:
    # dequantized on read, the attention arithmetic in q's dtype as the
    # eager impl's
    from repro_torch.core import attention as A

    return A.decode_attention_xla(q, dequantize(k_cache, q.dtype),
                                  dequantize(v_cache, q.dtype), cache_len,
                                  window=window, scale=scale)


register("attention_decode", "eager", _decode_eager, default=True,
         requires=_decode_fp_requires,
         doc="grouped GQA einsum over the whole cache, masked past cache_len")
register("attention_decode", "cuda", _decode_cuda,
         requires=_decode_cuda_requires, kernel=True,
         doc="the flash kernel over the live prefix; uniform cache_len only")
register("attention_decode", "cuda_fused", _decode_fused,
         requires=_decode_kernel_requires, kernel=True,
         doc="single-pass decode kernel, per-slot cache_len read at run "
             "time; f32/bf16, GQA-divisible heads, head_dim <= 256")
register("attention_decode", "ref", _decode_ref,
         requires=_decode_fp_requires,
         doc="oracle: the fused kernel's plain version")
register("attention_decode", "eager_int8", _decode_int8,
         requires=_decode_int8_requires,
         doc="int8 KV cache with per-(token, head) scales, dequantized on "
             "read; vector per-slot cache_len")


def _decode_cost(q, k_cache, v_cache, cache_len, *, window=None,
                 scale=None):
    # over the whole cache, as the reference's plain decode computes it:
    # q scaled, scores, the length mask (compare, select; the window adds
    # a compare and an ``and``), the softmax, the PV product
    b, hq, one, d = q.shape
    smax = k_cache.shape[2]
    pairs = b * hq * one * smax
    per = 2 + (2 if window is not None else 0) + 5
    nbytes = (_stored_bytes(q) + _stored_bytes(k_cache)
              + _stored_bytes(v_cache) + _stored_bytes(
                  cache_len if isinstance(cache_len, torch.Tensor) else None)
              + b * hq * one * v_cache.shape[-1] * q.element_size())
    return [Part(4.0 * pairs * d + per * pairs + b * hq * one * d, nbytes,
                 pairs, "attn_decode")]


register_cost("attention_decode", _decode_cost)


# ==================================================================== linear


def _accum_dtype(policy, preferred):
    return preferred if preferred is not None \
        else getattr(torch, policy.accum_dtype)


def _linear_fp_requires(policy, x, w, b=None, *, activation=None,
                        preferred_dtype=None, out_dtype=None, order_n=None):
    return _reject_packed(x, w)


def _linear_eager(policy, x, w, b=None, *, activation=None,
                  preferred_dtype=None, out_dtype=None, order_n=None):
    acc = _accum_dtype(policy, preferred_dtype)
    y = torch.matmul(x.to(acc), w.to(acc))
    if b is not None:
        y = y + (b.to(acc) if policy.bias_f32 else b.to(y.dtype))
    y = apply_activation(y, activation)
    return y.to(out_dtype or x.dtype)


def _linear_cuda_requires(policy, x, w, b=None, *, activation=None,
                          preferred_dtype=None, out_dtype=None, order_n=None):
    why = _reject_packed(x, w)
    if why:
        return why
    if not _floating(x, w):
        return f"non-float dtypes {x.dtype}/{w.dtype}"
    if activation not in (None, "none", "relu", "gelu", "silu"):
        return f"kernel epilogue has no {activation!r} fusion"
    if x.shape[-1] != w.shape[0]:
        return f"contraction mismatch {x.shape[-1]} vs {w.shape[0]}"
    if x.dtype != w.dtype:
        return f"mixed dtypes {x.dtype}/{w.dtype}"
    if out_dtype not in (None, x.dtype, torch.float32):
        return f"the kernel writes {x.dtype} or float32, not {out_dtype}"
    return _kernel_dtype(x)


def _linear_cuda(policy, x, w, b=None, *, activation=None,
                 preferred_dtype=None, out_dtype=None, order_n=None):
    # like the reference's _linear_pallas: float32 accumulation and bias in
    # the kernel, preferred_dtype ignored, output in x.dtype (float32 where
    # out_dtype asks: a row shard's partial sums)
    use_lut = policy.lut_activations and activation in ("gelu", "silu")
    return kul.unified_linear(
        x, w, None if b is None else b.float(), activation=activation,
        use_lut=use_lut, step_log2=policy.lut_step_log2,
        lut_range=policy.lut_range, out_dtype=out_dtype, order_n=order_n)


def _linear_ref_requires(policy, x, w, b=None, *, activation=None,
                         preferred_dtype=None, out_dtype=None, order_n=None):
    if out_dtype not in (None, x.dtype):
        return f"the oracle rounds to {x.dtype}, not {out_dtype}"
    return _reject_packed(x, w)


def _linear_ref(policy, x, w, b=None, *, activation=None,
                preferred_dtype=None, out_dtype=None, order_n=None):
    use_lut = policy.lut_activations and activation in ("gelu", "silu")
    return kref.ref_linear(x, w, b, activation=activation, use_lut=use_lut,
                           step_log2=policy.lut_step_log2,
                           lut_range=policy.lut_range)


def _fixed_rows_matmul(x, w):
    """``x @ w`` for x (..., K); on the card in products of exactly
    ``_PACKED_ROWS`` rows."""
    if x.device.type != "cuda":
        return torch.matmul(x, w)
    x2 = x.reshape(-1, x.shape[-1])
    m = x2.shape[0]
    pad = -m % _PACKED_ROWS
    if pad:
        x2 = torch.cat([x2, x2.new_zeros((pad, x2.shape[1]))])
    y = torch.cat([c @ w for c in x2.split(_PACKED_ROWS)])
    return y[:m].reshape(*x.shape[:-1], w.shape[-1])


def _bias_act(policy, y, x, b, activation, acc, out_dtype=None):
    """The fp impls' epilogue: widened bias, policy-dispatched activation,
    the result in x's dtype (or ``out_dtype``)."""
    if b is not None:
        y = y + (b.to(acc) if policy.bias_f32 else b.to(y.dtype))
    return apply_activation(y, activation).to(out_dtype or x.dtype)


def _linear_int8_requires(policy, x, w, b=None, *, activation=None,
                          preferred_dtype=None, out_dtype=None, order_n=None):
    if is_factored(w):
        return "weight is factored (FactoredTensor) — served by the " \
               "eager_factored impl"
    if not is_qtensor(w):
        return "weight is not quantized (run quant.quantize_tree first)"
    if is_qtensor(x):
        return "activations are quantized (weights-only impl)"
    why = _no_backward("eager_int8 (frozen packed weights)", w)
    if why:
        return why
    if not _floating(x):
        return f"non-float input dtype {x.dtype}"
    if x.shape[-1] != w.shape[-2]:
        return f"contraction mismatch {x.shape[-1]} vs {w.shape[-2]}"
    return None


def _linear_int8(policy, x, w, b=None, *, activation=None,
                 preferred_dtype=None, out_dtype=None, order_n=None):
    # int8 per-channel: the scale is constant along K, so (x @ q) * scale
    # is the epilogue form; grouped int4 scales vary along K, so the
    # weight dequantizes before the product
    acc = _accum_dtype(policy, preferred_dtype)
    if w.bits == 8:
        y = _fixed_rows_matmul(x.to(acc), w.q.to(acc)) * w.scale.to(acc)
    else:
        y = _fixed_rows_matmul(x.to(acc), dequantize(w, acc))
    return _bias_act(policy, y, x, b, activation, acc, out_dtype)


def _linear_factored_requires(policy, x, w, b=None, *, activation=None,
                              preferred_dtype=None, out_dtype=None,
                              order_n=None):
    if not is_factored(w):
        return "weight is not factored (run factor.factorize_tree first)"
    if w.experts is not None:
        return "factored weight carries a per-expert axis (serve it " \
               "through moe_grouped_gemm)"
    if _packed(x):
        return "activations are packed (weights-only impl)"
    why = _no_backward("eager_factored (frozen packed weights)", w)
    if why:
        return why
    if not _floating(x):
        return f"non-float input dtype {x.dtype}"
    if x.shape[-1] != w.shape[-2]:
        return f"contraction mismatch {x.shape[-1]} vs {w.shape[-2]}"
    return None


def _linear_factored(policy, x, w, b=None, *, activation=None,
                     preferred_dtype=None, out_dtype=None, order_n=None):
    # shared basis product + low-rank / butterfly delta correction
    acc = _accum_dtype(policy, preferred_dtype)
    return _bias_act(policy, factored_linear(x, w, acc), x, b, activation,
                     acc, out_dtype)


register("linear", "eager", _linear_eager, default=True,
         requires=_linear_fp_requires,
         doc="torch.matmul, policy accum dtype + widened f32 bias, "
             "policy-dispatched activation epilogue")
register("linear", "cuda", _linear_cuda, requires=_linear_cuda_requires,
         kernel=True,
         doc="tiled GEMM kernel, fused bias+(LUT) activation epilogue; "
             "f32/bf16, relu/gelu/silu/none epilogues")
register("linear", "ref", _linear_ref, requires=_linear_ref_requires,
         doc="oracle (f32 accumulation)")
register("linear", "eager_int8", _linear_int8,
         requires=_linear_int8_requires,
         doc="QTensor weights: int8 per-channel dequant epilogue / int4 "
             "grouped dequant-then-product; fp activations")
register("linear", "eager_factored", _linear_factored,
         requires=_linear_factored_requires,
         doc="FactoredTensor weights (no expert axis): basis product + "
             "low-rank / butterfly delta correction; fp activations")


def _linear_cost(x, w, b=None, *, activation=None, preferred_dtype=None,
                 out_dtype=None, order_n=None):
    kdim, n = w.shape[-2], w.shape[-1]
    m = _numel(x.shape) // kdim
    out_size = x.element_size() if out_dtype is None \
        else torch.empty((), dtype=out_dtype).element_size()
    nbytes = (_stored_bytes(x) + _stored_bytes(w) + _stored_bytes(b)
              + m * n * out_size)
    parts = [Part(2.0 * m * n * kdim, nbytes)]
    if b is not None:
        parts.append(Part(m * n, op="linear.bias"))
    return parts + _act_parts(activation, m * n)


register_cost("linear", _linear_cost)


# ========================================================== moe_grouped_gemm


def _mask_queue_tails(y, group_sizes):
    """Zero output rows at index >= group_sizes[..., e]."""
    if group_sizes is None:
        return y
    c = y.shape[-2]
    keep = torch.arange(c, device=y.device)[:, None] \
        < group_sizes[..., None, None]
    return torch.where(keep, y, torch.zeros((), dtype=y.dtype,
                                            device=y.device))


def _moe_fp_requires(policy, buf, w, group_sizes=None):
    return _reject_packed(buf, w)


def _moe_eager(policy, buf, w, group_sizes=None):
    # dense sweep: empty experts are still computed (masked afterwards)
    acc = getattr(torch, policy.accum_dtype)
    y = torch.einsum("...ecd,edf->...ecf", buf.to(acc), w.to(acc))
    return _mask_queue_tails(y, group_sizes)


def _moe_cuda_requires(policy, buf, w, group_sizes=None):
    why = _reject_packed(buf, w)
    if why:
        return why
    if group_sizes is None:
        return "group_sizes unavailable (dense/onehot dispatch carries no " \
               "per-expert queue lengths)"
    if not _floating(buf, w):
        return f"non-float dtypes {buf.dtype}/{w.dtype}"
    if buf.dtype != w.dtype:
        return f"mixed dtypes {buf.dtype}/{w.dtype}"
    return _kernel_dtype(buf)


def _moe_cuda(policy, buf, w, group_sizes=None):
    return kmg.moe_gemm(buf, w, group_sizes).float()


def _moe_ref(policy, buf, w, group_sizes=None):
    return kref.ref_moe_gemm(buf, w, group_sizes).float()


def _moe_int8_requires(policy, buf, w, group_sizes=None):
    if is_factored(w):
        return "expert weights are factored (FactoredTensor) — served by " \
               "the eager_factored impl"
    if not is_qtensor(w):
        return "expert weights are not quantized (run quant.quantize_tree " \
               "first)"
    if is_qtensor(buf):
        return "expert queue buffers are quantized (weights-only impl)"
    why = _no_backward("eager_int8 (frozen packed weights)", w)
    if why:
        return why
    if not _floating(buf):
        return f"non-float buffer dtype {buf.dtype}"
    return None


def _moe_int8(policy, buf, w, group_sizes=None):
    # one product per expert, (queue rows, d) x (d, f): int8 with the
    # expert's per-channel scale as the epilogue, int4 dequantized first
    acc = getattr(torch, policy.accum_dtype)
    xb = buf.to(acc)
    if w.bits == 8:
        y = per_expert_products(
            xb, lambda e, r: (r @ w.q[e].to(acc)) * w.scale[e].to(acc))
    else:
        wf = dequantize(w, acc)
        y = per_expert_products(xb, lambda e, r: r @ wf[e])
    return _mask_queue_tails(y, group_sizes)


def _moe_factored_requires(policy, buf, w, group_sizes=None):
    if not is_factored(w):
        return "expert weights are not factored (run " \
               "factor.factorize_tree first)"
    if w.experts is None:
        return "factored weight has no expert axis (serve it through " \
               "linear)"
    if _packed(buf):
        return "expert queue buffers are packed (weights-only impl)"
    why = _no_backward("eager_factored (frozen packed weights)", w)
    if why:
        return why
    if not _floating(buf):
        return f"non-float buffer dtype {buf.dtype}"
    if buf.shape[-3] != w.shape[0]:
        return f"expert-count mismatch {buf.shape[-3]} vs {w.shape[0]}"
    return None


def _moe_factored(policy, buf, w, group_sizes=None):
    # per expert: the shared basis product + the expert's delta correction
    y = factored_moe_gemm(buf, w, getattr(torch, policy.accum_dtype))
    return _mask_queue_tails(y, group_sizes)


register("moe_grouped_gemm", "eager", _moe_eager, default=True,
         requires=_moe_fp_requires,
         doc="dense ecd,edf einsum (f32 accum); computes empty experts")
register("moe_grouped_gemm", "cuda", _moe_cuda, requires=_moe_cuda_requires,
         kernel=True,
         doc="grouped GEMM kernel, all routing groups in one launch, "
             "empty-queue skip; needs group_sizes, f32/bf16")
register("moe_grouped_gemm", "ref", _moe_ref, requires=_moe_fp_requires,
         doc="einsum oracle with queue-tail zeroing")
register("moe_grouped_gemm", "eager_int8", _moe_int8,
         requires=_moe_int8_requires,
         doc="QTensor expert weights: int8 per-channel dequant epilogue / "
             "int4 grouped dequant-then-product, one product per expert; fp "
             "queue buffers")
register("moe_grouped_gemm", "eager_factored", _moe_factored,
         requires=_moe_factored_requires,
         doc="FactoredTensor expert weights: per expert, the shared basis "
             "product + the low-rank / butterfly delta correction "
             "(optionally int8/int4 delta factors); fp queue buffers")


def _moe_gemm_cost(buf, w, group_sizes=None):
    # every expert over its whole capacity C (the dense einsum's count)
    e, c, d = buf.shape[-3:]
    f = w.shape[-1]
    rows = _numel(buf.shape[:-1])
    nbytes = (_stored_bytes(buf) + _stored_bytes(w) + rows * f * 4
              + _stored_bytes(group_sizes))
    parts = [Part(2.0 * rows * d * f, nbytes)]
    if group_sizes is not None:   # the queue-tail mask's select
        parts.append(Part(rows * f, op="moe_grouped_gemm.mask"))
    return parts


register_cost("moe_grouped_gemm", _moe_gemm_cost)


# ================================================================== moe_ffn


def _moe_ffn_eager(policy, x, params, routing, group_sizes, *, cfg,
                   capacity):
    # the staged pipeline: dispatch into (G, E, C, d) queues, the expert
    # MLPs (each projection re-dispatches moe_grouped_gemm), combine
    from repro_torch.core import moe as moe_lib
    from repro_torch.core import routing as R

    with scope("moe_dispatch"):
        buf = R.dispatch(x, routing, cfg.num_experts, capacity)
    with scope("moe_ffn"):
        out = moe_lib._expert_ffn(params, cfg, buf, group_sizes)
    with scope("moe_combine"):
        return R.combine(out, routing).to(x.dtype)


def _moe_ffn_ref_requires(policy, x, params, routing, group_sizes, *, cfg,
                          capacity):
    return _reject_packed(x, *params.values())


def _moe_ffn_ref(policy, x, params, routing, group_sizes, *, cfg,
                 capacity):
    return kref.ref_moe_ffn(x, params, routing, cfg=cfg)


def _moe_ffn_fused_requires(policy, x, params, routing, group_sizes, *,
                            cfg, capacity):
    # the reference's reasons for what the port has (its mesh reason has
    # no operands here yet), then the kernel's limits
    if cfg.impl == "onehot":
        return "onehot (GSPMD) dispatch requested — the fused kernel " \
               "replaces the gather path only"
    why = _no_backward("the fused kernel (train through the staged moe_ffn)",
                       x, *params.values())
    if why:
        return why
    if any(is_qtensor(p) for p in params.values()):
        return "expert weights are quantized (QTensor) — staged path " \
               "serves them via the eager_int8 grouped GEMM"
    if any(is_factored(p) for p in params.values()):
        return "expert weights are factored (FactoredTensor) — staged " \
               "path serves them via the eager_factored grouped GEMM"
    if not _floating(x):
        return f"non-float activation dtype {x.dtype}"
    why = _kernel_dtype(x)
    if why:
        return why
    mats = [params[k] for k in ("wg", "wu", "wd", "w1", "w2") if k in params]
    if any(w.dtype != x.dtype for w in mats):
        return f"mixed dtypes {x.dtype}/{mats[0].dtype}"
    if x.shape[-1] > kmf.MAX_D:
        return f"d_model {x.shape[-1]} > {kmf.MAX_D}"
    if cfg.top_k > kmf.MAX_K:
        return f"top_k {cfg.top_k} > {kmf.MAX_K}"
    return None


def _moe_ffn_fused(policy, x, params, routing, group_sizes, *, cfg,
                   capacity):
    return kmf.fused_moe_ffn(
        x, params, routing.expert, routing.gate, routing.position,
        routing.valid, group_sizes, kind=cfg.expert_kind, capacity=capacity,
        use_lut=policy.lut_activations, step_log2=policy.lut_step_log2,
        lut_range=policy.lut_range)


register("moe_ffn", "eager", _moe_ffn_eager, default=True,
         doc="staged dispatch → grouped GEMMs → combine (materializes the "
             "(G, E, C, d) buffer; inner GEMMs re-dispatch moe_grouped_gemm, "
             "so packed expert weights are served here, by eager_int8 / "
             "eager_factored)")
register("moe_ffn", "cuda_fused", _moe_ffn_fused,
         requires=_moe_ffn_fused_requires, kernel=True,
         doc="megakernel: gather by token index + expert MLP + ordered "
             "combine in one pass over every routing group, metaqueue skip, "
             "no dispatch buffer")
register("moe_ffn", "ref", _moe_ffn_ref, requires=_moe_ffn_ref_requires,
         doc="token-level dense oracle: every expert on every token, exact "
             "activations, gate-weighted sum")


def _moe_ffn_cost(x, params, routing, group_sizes, *, cfg, capacity):
    """The staged layer (dispatch, the expert MLP over E × C rows per
    group, combine), as the reference's plain ``moe_ffn`` computes it;
    ``onehot`` adds its dispatch and combine einsums."""
    d = x.shape[-1]
    t = x.shape[-2]
    groups = _numel(x.shape[:-2])
    e, k, c = cfg.num_experts, cfg.top_k, capacity
    act = x.element_size()
    mats = [params[n] for n in ("wg", "wu", "wd", "w1", "w2") if n in params]
    f = mats[0].shape[-1]
    slots = groups * t * k
    rows = groups * e * c                        # queue rows, all groups
    idx_bytes = sum(_stored_bytes(a) for a in (routing.expert, routing.gate,
                                               routing.position,
                                               routing.valid))
    dispatch_flops = slots
    combine_flops = 2.0 * slots * d + slots
    if cfg.impl == "onehot":
        dispatch_flops = (slots * (e + 2 * c) + 2.0 * slots * e * c
                          + 2.0 * groups * t * e * c * d)
        combine_flops = (slots * (e + 3 * c) + 2.0 * slots * e * c
                         + 2.0 * groups * t * e * c * d)
    n_proj = len(mats)
    gemm = 2.0 * rows * d * f * n_proj
    if cfg.expert_kind == "swiglu":
        epilogue = 2 * rows * f + rows * d + rows * f   # masks, act · up
        act_part = _act_parts("silu", rows * f, "moe_ffn")
    else:
        epilogue = rows * f + rows * d + rows * f + rows * d  # masks, biases
        act_part = _act_parts("gelu", rows * f, "moe_ffn")
    w_bytes = sum(_stored_bytes(params[n]) for n in params)
    return [
        Part(dispatch_flops, _stored_bytes(x) + idx_bytes + rows * d * act,
             0.0, "moe_dispatch"),
        Part(gemm, w_bytes + rows * d * act * n_proj
             + rows * (f * (n_proj - 1) + d) * 4, 0.0, "moe_ffn",
             "moe_grouped_gemm"),
        Part(epilogue, 0.0, 0.0, "moe_ffn", "moe_ffn.epilogue"),
        *act_part,
        Part(combine_flops, rows * d * act + groups * t * d * act
             + idx_bytes, 0.0, "moe_combine"),
    ]


register_cost("moe_ffn", _moe_ffn_cost)
