"""decode_fused: single-pass decode attention with per-sequence cache
lengths read at run time (Edge-MoE §IV-B's "Pass 3" consumed in-kernel).

Replaces the Pallas kernel ``src/repro/kernels/decode_fused.py``
(``fused_decode_kernel`` / ``fused_decode_call``, reached through
``kernels/ops.py:fused_decode_attention`` and the
``attention_decode``/``pallas_fused`` impl).  CUDA source:
``csrc/decode_fused.cu``.

What bounds it on the H100: one query row per head against the live K/V
prefix is ~4·head_dim FLOPs per key and head over 4·head_dim bytes (bf16
K and V), far below the card's operations-per-byte line, so the bytes of
the live prefixes set the least time; in practice latency and parallelism
do.  Its design (``csrc/decode_fused.cu`` has the notes): the Smax cache
slots are split into key ranges of 64 fixed at launch
(:func:`repro_torch.kernels.attn_plan.plan_decode`: 8 splits at Smax 512,
so B·Hkv·8 blocks), each block serving the query heads of one GQA group
(the LM's 4), so a K/V row is read once per group.  Each block reads
``cache_len[b]`` on the card — no host sync, and one launch serves any mix
of lengths (continuous batching) — and a split past the live prefix or
wholly behind the window frontier loads nothing.  K/V tiles of 32 keys
arrive by 16-byte ``cp.async`` into a 2-stage ring; the dot products and
the P·V sums are float32.  Each split stores its float32 (m, l, acc)
partial and takes a ticket; the last block of a (b, kv head) merges the
splits in ascending order and writes the output, in the same launch and
without float atomics, so two launches on the same inputs are
bit-identical.

The public :func:`fused_decode_attention` runs
:func:`fused_decode_attention_plain` for CPU tensors and launches the
kernel for CUDA tensors, or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.attention import NEG_INF, scale_in_dtype
from repro_torch.kernels import attn_plan, build
from repro_torch.kernels.attn_plan import MAX_D

__all__ = ["fused_decode_attention", "fused_decode_attention_plain",
           "plan_for", "MAX_D"]

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float] \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def plan_for(q, k_cache) -> attn_plan.DecodePlan:
    """The plan the wrapper follows for a CUDA launch on these operands."""
    b, hq = q.shape[:2]
    _, hkv, smax, _ = k_cache.shape
    return attn_plan.plan_decode(b, hq, hkv, smax)


def _lengths(cache_len, b, device):
    """cache_len (scalar or (B,)) as a (B,) int32 tensor on ``device``."""
    cl = torch.as_tensor(cache_len, device=device).to(torch.int32)
    return cl.reshape(-1).expand(b).contiguous()


def fused_decode_attention_plain(q, k_cache, v_cache, cache_len, *,
                                 window=None, scale=None):
    """The kernel's arithmetic in plain PyTorch: q scaled in its dtype, then
    float32 scores over the query's GQA kv head, keys at or past
    ``cache_len[b]`` (and at or behind ``cache_len − 1 − window``) at
    −1e30 with probability 0, float32 softmax statistics and
    ``acc / max(l, 1e-37)`` — a slot with ``cache_len == 0`` gives zeros.
    q: (B, Hq, 1, D); k/v_cache: (B, Hkv, Smax, D) -> (B, Hq, 1, D)."""
    b, hq, one, d = q.shape
    hkv, smax = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = scale_in_dtype(q, scale).float().reshape(b, hkv, group * one, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float())
    cl = _lengths(cache_len, b, q.device)[:, None, None, None]
    kpos = torch.arange(smax, device=q.device)[None, None, None, :]
    ok = kpos < cl
    if window is not None:
        ok = ok & (kpos > cl - 1 - window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(ok, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float()) \
        / torch.clamp_min(l, 1e-37)
    return out.reshape(b, hq, one, d).to(q.dtype)


def _launch(q, k, v, cl, window, scale):
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"decode_fused kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if q.dim() != 4 or q.shape[2] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,Hq,1,D), k=v (B,Hkv,Smax,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    _, hkv, smax, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError("q and the caches disagree on batch or head_dim")
    if hq % hkv != 0:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if not 0 < d <= MAX_D:
        raise ValueError(f"head_dim {d} outside 1..{MAX_D}")
    if window is not None and window < 0:
        raise ValueError("window must be non-negative")
    if b * hkv > 65535:
        raise ValueError("B * Hkv exceeds the grid's y limit")
    if not (k.device == v.device == cl.device == q.device):
        raise ValueError("operands lie on different devices")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    scale_t = float(torch.tensor(scale, dtype=q.dtype))
    plan = plan_for(q, k)
    # 16-byte cp.async rows need D * itemsize and the bases 16-byte aligned
    vec = (d * q.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (k, v))
    partials = torch.empty(plan.blocks * plan.heads * (d + 2),
                           dtype=torch.float32, device=q.device)
    tickets = build.tickets("decode_fused", q.device,
                            plan.grid[1] * plan.grid[2])
    fn = build.function("decode_fused_launch", _ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cl.data_ptr(),
             o.data_ptr(), partials.data_ptr(), tickets.data_ptr(), b, hq,
             hkv, smax, d, -1 if window is None else int(window), scale_t,
             plan.split, plan.splits, int(vec), build.DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("decode_fused", err)
    fused_decode_attention.launches += 1
    return o


def fused_decode_attention(q, k_cache, v_cache, cache_len, *, window=None,
                           scale=None):
    """q: (B, Hq, 1, D); k/v_cache: (B, Hkv, Smax, D); cache_len: a scalar
    or (B,) int — per-slot live lengths, read by the kernel at run time
    (for CUDA tensors it should already lie on the card).  Returns
    (B, Hq, 1, D) in ``q.dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type in build.PLAIN_DEVICES:
        return fused_decode_attention_plain(q, k_cache, v_cache, cache_len,
                                            window=window, scale=scale)
    if q.device.type == "cuda":
        return _launch(q.contiguous(), k_cache.contiguous(),
                       v_cache.contiguous(),
                       _lengths(cache_len, q.shape[0], q.device), window,
                       scale)
    raise ValueError(f"fused_decode_attention runs on cuda, cpu or meta, not "
                     f"{q.device}")


fused_decode_attention.launches = 0
