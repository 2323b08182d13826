"""flash_attention: tiled attention with an online-softmax carry
(Edge-MoE §IV-A + §IV-B).

Replaces the Pallas kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_kernel`` / ``flash_attention_call``, reached through
``kernels/ops.py:flash_attention``).  CUDA source:
``csrc/flash_attention.cu``.

What bounds it on the H100: at M3ViT's shapes (B·3 heads, S = 128,
head_dim 64) one head is 4 MFLOP over 64 KB of bf16 q/k/v/o, so the bytes
set the least time; a launch is short, and this kernel's time is set by
the float32 pipes and by latency.  Its design: one block per (b, h, 8
query rows), one warp per query row, K/V tiles of 32 keys staged once in
shared memory and reused by all 8 rows (the paper's resident-Q reuse), the
(m, l, acc) carry in registers, fully masked K tiles skipped, and head_dim
kept at its true size (the TPU wrapper padded 64 to 128; here the ragged
edge is masked in the kernel).

The public :func:`flash_attention` runs :func:`flash_attention_plain` for
CPU tensors and launches the kernel for CUDA tensors, or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.attention import NEG_INF, allowed_keys
from repro_torch.kernels import build

__all__ = ["flash_attention", "flash_attention_plain", "MAX_D"]

MAX_D = 128          # csrc/flash_attention.cu:kMaxD


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


def _launch(q, k, v, causal, window, q_offset, scale):
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
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
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = build.function("flash_attention_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             b, hq, hkv, sq, skv, d, int(q_offset), int(bool(causal)),
             -1 if window is None else int(window), float(scale),
             build.DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention", err)
    flash_attention.launches += 1
    return o


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    scale=None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    if q.device.type == "cuda":
        return _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                       causal, window, q_offset, scale)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


flash_attention.launches = 0
