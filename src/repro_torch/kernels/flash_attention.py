"""flash_attention: tiled attention with an online-softmax carry
(Edge-MoE §IV-A + §IV-B).

Replaces the Pallas kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_kernel`` / ``flash_attention_call``, reached through
``kernels/ops.py:flash_attention``).  CUDA source:
``csrc/flash_attention.cu``.

What bounds it on the H100: at the paths' shapes (M3ViT: B·3 heads, S =
128; the Llama-3.2-1B prefill: B·32 heads over 128 visible keys; head_dim
64) a head is 4 MFLOP over 64 KB of bf16 q/k/v/o, so the bytes set the
least time, and what a launch costs in practice is latency.  Two variants,
chosen by :func:`repro_torch.kernels.attn_plan.plan_attention` from the
dtype and head_dim (``csrc/flash_attention.cu`` has the design notes):

* ``tc`` — bf16, head_dim a multiple of 16 up to 128: 64 query rows a
  block, ``Q·Kᵀ`` and ``P·V`` on the tensor cores (wgmma; P as a bf16
  hi/lo pair, which keeps the bf16 tolerance where a single bf16 P does
  not), K/V tiles of 64 keys through a TMA ring, the online softmax in
  registers.  q, k and v are read through tensor maps built from their
  strides: the transposed views ``_split_heads`` hands over need no copy.
* ``simt`` — float32, or a head_dim the ``tc`` kernel does not take: 8
  query rows a block on the float32 FMA pipes (the first kernel).

The public :func:`flash_attention` runs :func:`flash_attention_plain` for
CPU tensors and launches a kernel for CUDA tensors, or raises;
``flash_attention.launches`` counts every launch, ``flash_attention.variants``
each variant's.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.attention import NEG_INF, allowed_keys
from repro_torch.kernels import attn_plan, build
from repro_torch.kernels.attn_plan import MAX_D

__all__ = ["flash_attention", "flash_attention_plain", "plan_for", "MAX_D"]


def flash_attention_plain(q, k, v, *, causal=True, window=None, q_offset=0,
                          scale=None):
    """The kernel's arithmetic in plain PyTorch: q scaled in float32, masked
    scores at -1e30 with probability 0, float32 softmax statistics, and
    ``acc / max(l, 1e-37)`` (fully masked rows give zeros)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    group = hq // hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float() * scale, kf.transpose(-1, -2))
    ok = allowed_keys(torch.arange(sq, device=q.device) + q_offset,
                      torch.arange(skv, device=q.device), causal, window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(ok, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vf) / torch.clamp_min(l, 1e-37)
    return out.to(q.dtype)


_SIMT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_TC_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
    + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                       ctypes.c_void_p]


def plan_for(q) -> attn_plan.AttnPlan:
    """The plan the wrapper follows for a CUDA launch with this q."""
    b, hq, sq, d = q.shape
    return attn_plan.plan_attention(b, hq, sq, d, q.dtype)


def _launch(q, k, v, causal, window, q_offset, scale):
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected q (B,Hq,Sq,D), k=v (B,Hkv,Skv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError("q and k/v disagree on batch or head_dim")
    if hq % hkv != 0:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if not 0 < d <= MAX_D:
        raise ValueError(f"head_dim {d} outside 1..{MAX_D}")
    if window is not None and window < 0:
        raise ValueError("window must be non-negative")
    if b * hq > 65535:
        raise ValueError("B * Hq exceeds the grid's y limit")
    if not (k.device == v.device == q.device):
        raise ValueError("operands lie on different devices")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    plan = plan_for(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    window = -1 if window is None else int(window)
    if plan.variant == "tc":
        # the 4-D tensor maps read strided views as they lie
        q, k, v = (t if attn_plan.tma_view_ok(t) else t.contiguous()
                   for t in (q, k, v))
        strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
        fn = build.function("flash_attention_tc_launch", _TC_ARGS)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 b, hq, hkv, sq, skv, d, *strides, int(q_offset),
                 int(bool(causal)), window, float(scale), stream)
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        fn = build.function("flash_attention_launch", _SIMT_ARGS)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 b, hq, hkv, sq, skv, d, int(q_offset), int(bool(causal)),
                 window, float(scale), build.DTYPE_CODES[q.dtype], stream)
    build.check(f"flash_attention ({plan.variant})", err)
    flash_attention.launches += 1
    flash_attention.variants[plan.variant] += 1
    return o


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    scale=None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window, q_offset, scale)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


flash_attention.launches = 0
flash_attention.variants = {"tc": 0, "simt": 0}
