"""moe_gemm: the expert-by-expert grouped GEMM (Edge-MoE §IV-D),
``out[g, e] = buf[g, e] @ w[e]``.

Replaces the Pallas kernel ``src/repro/kernels/moe_gemm.py``
(``moe_gemm_kernel`` / ``moe_gemm_call``, reached through
``kernels/ops.py:moe_gemm``).  CUDA source: ``csrc/moe_gemm.cu`` on the
mainloop of ``csrc/gemm_sm90.cuh``.

What bounds it on the H100: a MoE layer at B = 8 is 8 routing groups × 16
experts × ≤ 68 queued tokens against 192×768 weights — 128 small GEMMs
whose work depends on the queue lengths; the bytes (live rows, each used
expert's weights once, the whole output written) set the least time.  The
design: one launch covers every (group, expert) queue; for bf16 each block
runs the tensor-core mainloop with 64 or 128 columns of the expert's F as
wgmma's M side and the queue (n = 72 covers C = 68) as its n side, fed by
TMA from a 3-D map over (G·E, C, D) that zero-fills past C; blocks walk
the experts slowest, so one expert's blocks across the groups run together
and find its weights in L2.  A block reads its queue length first and, for
an empty expert or a tile past the queue, writes zeros and returns without
reading the expert's weights (the paper's metaqueue skip); rows at or past
the queue length are stored as exact zeros, whatever the queue tails hold;
the output is stored in ``buf.dtype``, as the Pallas kernel does.  float32
operands and bf16 rows not 16-byte aligned take the first SIMT kernel (a
dispatch on dtype and shape, :func:`repro_torch.kernels.gemm_plan.plan_moe`,
counted apart in ``moe_gemm.variants["simt"]``).

The public :func:`moe_gemm` runs :func:`moe_gemm_plain` for CPU tensors and
launches a kernel for CUDA tensors, or raises.  It takes ``buf`` as
(G, E, C, D) with sizes (G, E), or (E, C, D) with sizes (E,).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, gemm_plan

__all__ = ["moe_gemm", "moe_gemm_plain"]


def moe_gemm_plain(buf, w, group_sizes=None):
    """float32 products and accumulation, rows at or past the queue length
    zeroed, cast to ``buf.dtype``.  buf (..., E, C, D), sizes (..., E) or
    None (no rows zeroed)."""
    out = torch.einsum("...ecd,edf->...ecf", buf.float(), w.float())
    if group_sizes is not None:
        keep = torch.arange(buf.shape[-2], device=buf.device)[:, None] \
            < group_sizes[..., None, None]
        out = torch.where(keep, out, 0.0)
    return out.to(buf.dtype)


def plan_for(buf, w, out=None) -> gemm_plan.GemmPlan:
    """The plan the wrapper follows for a CUDA launch on these operands
    (buf (G, E, C, D), w (E, D, F))."""
    g, e, c, d = buf.shape
    ptrs = [buf.data_ptr(), w.data_ptr()] + ([out.data_ptr()]
                                             if out is not None else [])
    return gemm_plan.plan_moe(g * e, c, d, w.shape[2], buf.dtype,
                              all(p % 16 == 0 for p in ptrs))


def _launch(buf, w, group_sizes):
    if buf.dtype not in build.DTYPE_CODES or w.dtype != buf.dtype:
        raise TypeError(f"moe_gemm kernel takes float32 or bfloat16 buf and "
                        f"w of one dtype, got {buf.dtype}/{w.dtype}")
    if group_sizes.dtype != torch.int32:
        raise TypeError("group_sizes must be int32")
    if not (buf.is_contiguous() and w.is_contiguous()
            and group_sizes.is_contiguous()):
        raise ValueError("moe_gemm kernel needs contiguous operands")
    g, e, c, d = buf.shape
    if w.dim() != 3 or w.shape[0] != e or w.shape[1] != d:
        raise ValueError(f"expert weights {tuple(w.shape)} do not match "
                         f"buf {tuple(buf.shape)}")
    if group_sizes.shape != (g, e):
        raise ValueError(f"group_sizes {tuple(group_sizes.shape)} != "
                         f"{(g, e)}")
    if not (w.device == buf.device == group_sizes.device):
        raise ValueError("operands lie on different devices")
    if g * e > 65535:
        raise ValueError("G * E exceeds the grid's z limit")
    f = w.shape[2]
    out = torch.empty((g, e, c, f), dtype=buf.dtype, device=buf.device)
    if out.numel() == 0:
        return out
    if d == 0:
        raise ValueError("moe_gemm kernel needs D > 0")
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    plan = plan_for(buf, w, out)
    if plan.variant == "simt":
        fn = build.function("moe_gemm_launch", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        err = fn(buf.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                 out.data_ptr(), g * e, e, c, d, f,
                 build.DTYPE_CODES[buf.dtype], stream)
    else:
        fn = build.function("moe_gemm_tc_launch", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        err = fn(buf.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                 out.data_ptr(), g, e, c, d, f, plan.bt, plan.nwg,
                 plan.stages, stream)
    build.check(f"moe_gemm ({plan.variant})", err)
    moe_gemm.variants[plan.variant] += 1
    moe_gemm.launches += 1
    return out


def moe_gemm(buf, w, group_sizes):
    """buf (G, E, C, D) or (E, C, D); w (E, D, F); group_sizes (G, E) or
    (E,) int -> (G, E, C, F) or (E, C, F) in ``buf.dtype``."""
    folded = buf.dim() == 4
    if not folded:
        buf, group_sizes = buf[None], group_sizes[None]
    if buf.device.type == "cpu":
        out = moe_gemm_plain(buf, w, group_sizes)
    elif buf.device.type == "cuda":
        out = _launch(buf.contiguous(), w.contiguous(),
                      group_sizes.to(torch.int32).contiguous())
    else:
        raise ValueError(f"moe_gemm runs on cuda or cpu, not {buf.device}")
    return out if folded else out[0]


moe_gemm.launches = 0
moe_gemm.variants = {"tc": 0, "simt": 0}
