"""Registered implementations for the ops on the M³ViT path — the port of
the corresponding part of ``repro.ops.impls``.

Imported lazily by ``registry.dispatch``.  Each impl follows the registry
contract ``fn(policy, *args, **kwargs)``.  Impl names: ``eager`` (plain
PyTorch, the reference's ``xla``), ``blocked``, ``lut``, ``cuda`` (the
Hopper kernels, the reference's ``pallas``), ``cuda_fused`` (the fused
kernels, the reference's ``pallas_fused``), ``ref``.  Capability
predicates return the reference's reason strings.  The packed-weight
(QTensor / FactoredTensor) impls follow with the slice that ports them.
"""

from __future__ import annotations

import torch

from repro_torch.core import gelu as gelu_lib
from repro_torch.kernels import decode_fused as kdf
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import gelu_lut as kgl
from repro_torch.kernels import moe_fused as kmf
from repro_torch.kernels import moe_gemm as kmg
from repro_torch.kernels import ref as kref
from repro_torch.kernels import unified_linear as kul
from repro_torch.ops import apply_activation
from repro_torch.ops.registry import register

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _floating(*tensors) -> bool:
    return all(t.is_floating_point() for t in tensors)


def _kernel_dtype(*tensors):
    """Reason string when a kernel cannot take the operands' dtype."""
    for t in tensors:
        if t.dtype not in _KERNEL_DTYPES:
            return f"dtype {t.dtype}: the kernel takes float32 or bfloat16"
    return None


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


# exact erf-GELU / sigmoid-SiLU / ReLU, any dtype
register("activation", "eager", _act_eager)
# ReLU − δ(|x|) half-table (§IV-C); gelu/silu only
register("activation", "lut", _act_lut, requires=_act_lut_requires,
         default=True)
# LUT kernel, shared-memory table; gelu/silu, f32/bf16
register("activation", "cuda", _act_cuda, requires=_act_cuda_requires,
         kernel=True)


# ================================================================= attention


def _attn_eager(policy, q, k, v, **kw):
    from repro_torch.core import attention as A

    return A.naive_attention(q, k, v, **kw)


def _attn_blocked(policy, q, k, v, **kw):
    from repro_torch.core import attention as A

    return A.blocked_attention(q, k, v, block_k=64, **kw)


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


# streaming K/V blocks + online-softmax carry (§IV-A/B)
register("attention", "blocked", _attn_blocked, default=True)
# materialized N×N scores (paper baseline), any mask
register("attention", "eager", _attn_eager)
# tiled flash kernel; f32/bf16, GQA-divisible heads, head_dim <= 128
register("attention", "cuda", _attn_cuda, requires=_attn_cuda_requires,
         kernel=True)
# oracle: the kernel's plain version (f32 softmax, −1e30 masking)
register("attention", "ref", _attn_ref)


# ========================================================== attention_decode


def _decode_eager(policy, q, k_cache, v_cache, cache_len, *, window=None,
                  scale=None):
    from repro_torch.core import attention as A

    return A.decode_attention_xla(q, k_cache, v_cache, cache_len,
                                  window=window, scale=scale)


def _decode_kernel_requires(policy, q, k_cache, v_cache, cache_len, *,
                            window=None, scale=None):
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


# grouped GQA einsum over the whole cache, masked past cache_len
register("attention_decode", "eager", _decode_eager, default=True)
# the flash kernel over the live prefix; uniform cache_len only
register("attention_decode", "cuda", _decode_cuda,
         requires=_decode_cuda_requires, kernel=True)
# single-pass decode kernel, per-slot cache_len read at run time; f32/bf16,
# GQA-divisible heads, head_dim <= 128
register("attention_decode", "cuda_fused", _decode_fused,
         requires=_decode_kernel_requires, kernel=True)
# oracle: the fused kernel's plain version
register("attention_decode", "ref", _decode_ref)


# ==================================================================== linear


def _accum_dtype(policy, preferred):
    return preferred if preferred is not None \
        else getattr(torch, policy.accum_dtype)


def _linear_eager(policy, x, w, b=None, *, activation=None,
                  preferred_dtype=None):
    acc = _accum_dtype(policy, preferred_dtype)
    y = torch.matmul(x.to(acc), w.to(acc))
    if b is not None:
        y = y + (b.to(acc) if policy.bias_f32 else b.to(y.dtype))
    y = apply_activation(y, activation)
    return y.to(x.dtype)


def _linear_cuda_requires(policy, x, w, b=None, *, activation=None,
                          preferred_dtype=None):
    if not _floating(x, w):
        return f"non-float dtypes {x.dtype}/{w.dtype}"
    if activation not in (None, "none", "relu", "gelu", "silu"):
        return f"kernel epilogue has no {activation!r} fusion"
    if x.shape[-1] != w.shape[0]:
        return f"contraction mismatch {x.shape[-1]} vs {w.shape[0]}"
    if x.dtype != w.dtype:
        return f"mixed dtypes {x.dtype}/{w.dtype}"
    return _kernel_dtype(x)


def _linear_cuda(policy, x, w, b=None, *, activation=None,
                 preferred_dtype=None):
    # like the reference's _linear_pallas: float32 accumulation and bias in
    # the kernel, preferred_dtype ignored, output in x.dtype
    use_lut = policy.lut_activations and activation in ("gelu", "silu")
    return kul.unified_linear(
        x, w, None if b is None else b.float(), activation=activation,
        use_lut=use_lut, step_log2=policy.lut_step_log2,
        lut_range=policy.lut_range)


def _linear_ref(policy, x, w, b=None, *, activation=None,
                preferred_dtype=None):
    use_lut = policy.lut_activations and activation in ("gelu", "silu")
    return kref.ref_linear(x, w, b, activation=activation, use_lut=use_lut,
                           step_log2=policy.lut_step_log2,
                           lut_range=policy.lut_range)


# torch.matmul, policy accum dtype + widened f32 bias, policy-dispatched
# activation epilogue
register("linear", "eager", _linear_eager, default=True)
# tiled GEMM kernel, fused bias+(LUT) activation epilogue; f32/bf16,
# relu/gelu/silu/none epilogues
register("linear", "cuda", _linear_cuda, requires=_linear_cuda_requires,
         kernel=True)
# oracle (f32 accumulation)
register("linear", "ref", _linear_ref)


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


def _moe_eager(policy, buf, w, group_sizes=None):
    # dense sweep: empty experts are still computed (masked afterwards)
    acc = getattr(torch, policy.accum_dtype)
    y = torch.einsum("...ecd,edf->...ecf", buf.to(acc), w.to(acc))
    return _mask_queue_tails(y, group_sizes)


def _moe_cuda_requires(policy, buf, w, group_sizes=None):
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


# dense ecd,edf einsum (f32 accum); computes empty experts
register("moe_grouped_gemm", "eager", _moe_eager, default=True)
# grouped GEMM kernel, all routing groups in one launch, empty-queue skip;
# needs group_sizes, f32/bf16
register("moe_grouped_gemm", "cuda", _moe_cuda, requires=_moe_cuda_requires,
         kernel=True)
# einsum oracle with queue-tail zeroing
register("moe_grouped_gemm", "ref", _moe_ref)


# ================================================================== moe_ffn


def _moe_ffn_eager(policy, x, params, routing, group_sizes, *, cfg,
                   capacity):
    # the staged pipeline: dispatch into (G, E, C, d) queues, the expert
    # MLPs (each projection re-dispatches moe_grouped_gemm), combine
    from repro_torch.core import moe as moe_lib
    from repro_torch.core import routing as R

    buf = R.dispatch(x, routing, cfg.num_experts, capacity)
    out = moe_lib._expert_ffn(params, cfg, buf, group_sizes)
    return R.combine(out, routing).to(x.dtype)


def _moe_ffn_ref(policy, x, params, routing, group_sizes, *, cfg,
                 capacity):
    return kref.ref_moe_ffn(x, params, routing, cfg=cfg)


def _moe_ffn_fused_requires(policy, x, params, routing, group_sizes, *,
                            cfg, capacity):
    # the reference's reasons for what the port has (its packed-weight and
    # mesh reasons have no operands here yet), then the kernel's limits
    if cfg.impl == "onehot":
        return "onehot (GSPMD) dispatch requested — the fused kernel " \
               "replaces the gather path only"
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


# staged dispatch → grouped GEMMs → combine (materializes the (G, E, C, d)
# buffer; inner GEMMs re-dispatch moe_grouped_gemm)
register("moe_ffn", "eager", _moe_ffn_eager, default=True)
# megakernel: gather by token index + expert MLP + ordered combine in one
# pass over every routing group, metaqueue skip, no dispatch buffer
register("moe_ffn", "cuda_fused", _moe_ffn_fused,
         requires=_moe_ffn_fused_requires, kernel=True)
# token-level dense oracle: every expert on every token, exact activations,
# gate-weighted sum
register("moe_ffn", "ref", _moe_ffn_ref)
