"""unified_linear: ``y = act(x @ w + b)`` as one kernel (Edge-MoE §IV-E).

Replaces the Pallas kernel ``src/repro/kernels/unified_linear.py``
(``unified_linear_kernel`` / ``unified_linear_call``, reached through
``kernels/ops.py:unified_linear``).  CUDA source: ``csrc/unified_linear.cu``
on the mainloop of ``csrc/gemm_sm90.cuh``.

What bounds it on the H100, and what the design does about it (the plan
comes from :mod:`repro_torch.kernels.gemm_plan`):

* Llama-3.2-1B decode (M = 8): the weights' bytes, 1.95 GB a step against
  3.35 TB/s.  The bf16 kernel computes ``yᵀ = wᵀ·xᵀ`` on the tensor cores
  (64 rows of N as wgmma's M side, the 8 tokens as its n side), fed by TMA
  through a multi-stage mbarrier ring, with K split so about two blocks per
  SM stream weights; the last block of each tile sums the splits' float32
  partials in ascending split order (``tc_splitk``: deterministic, no
  float atomics, one epilogue on the full sum).
* Prefill and M3ViT (M = 1024): operations, on the bf16 tensor cores, in
  128 × 128 tiles over two consumer warpgroups, or down to 64 × 16 tiles
  where N or K is small, so the grid covers the SMs; K is never split over
  blocks there.
* A row's bits do not depend on M: every variant sums K in the ranges and
  promotion groups :func:`gemm_plan.sum_order` takes from N, K and the SM
  count, each range from zero, the ranges added in ascending order.
* float32 operands and bf16 rows not 16-byte aligned (e.g. K = 33) take
  the first SIMT kernel (64 × 64 tiles on the FMA pipes): a dispatch on
  dtype and shape, counted apart in ``unified_linear.variants["simt"]``.

Every variant fuses the float32 bias and the activation (none, relu,
erf-GELU, SiLU or the LUT correction) before its single store, so the
activation costs no extra pass over memory.

The public :func:`unified_linear` flattens leading dims into M (what
``kernels/ops.py`` did) and, like the reference's ``_linear_pallas``,
returns ``x.dtype``.  For a CPU tensor it runs :func:`unified_linear_plain`;
for a CUDA tensor it launches a kernel or raises.  ``unified_linear.launches``
counts every launch, ``unified_linear.variants`` each variant's.

With gradients enabled and an operand that requires one, the same forward
runs inside :class:`UnifiedLinearFn`, whose backward is written out in
PyTorch: ``dx = g·wᵀ``, ``dw = xᵀ·g``, ``db = Σ g`` in float32, where ``g``
is the incoming gradient times the activation's derivative at the float32
pre-activation.  The fused kernel never stores the pre-activation, so the
backward recomputes it as a float32 product (``x·w + b``, what
:func:`unified_linear_plain` forms before its epilogue); the forward stays
the one fused launch, so a training forward has the serving bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.gelu import (activation_grad, device_table,
                                   exact_gelu, exact_silu, lut_correction,
                                   widen)
from repro_torch.kernels import build, gemm_plan

__all__ = ["unified_linear", "unified_linear_plain", "UnifiedLinearFn",
           "ACTIVATIONS"]

#: csrc/unified_linear.cu:Activation
ACTIVATIONS = {None: 0, "none": 0, "relu": 1, "gelu": 2, "silu": 3}


def _epilogue(y, activation, use_lut, table, step_log2):
    if activation in (None, "none"):
        return y
    if activation == "relu":
        return torch.clamp_min(y, 0.0)
    if use_lut:
        return lut_correction(y, table, step_log2)
    if activation == "gelu":
        return exact_gelu(y)
    if activation == "silu":
        return exact_silu(y)
    raise ValueError(activation)


def unified_linear_plain(x, w, b=None, *, activation=None, use_lut=False,
                         step_log2=-8, lut_range=8.0, out_dtype=None):
    """The kernel's arithmetic in plain PyTorch: float32 products and
    accumulation, float32 bias, the epilogue, one cast to ``x.dtype`` (or
    to ``out_dtype``)."""
    y = torch.matmul(widen(x), widen(w))
    if b is not None:
        y = y + widen(b)
    table = None
    if use_lut and activation in ("gelu", "silu"):
        table = device_table(activation, step_log2, lut_range, x.device)
    return _epilogue(y, activation, use_lut, table, step_log2).to(
        out_dtype or x.dtype)


_TC_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p] + [ctypes.c_int] * 13 \
    + [ctypes.c_void_p] * 3
_SIMT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p] + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x2, w, y=None, order_n=None) -> gemm_plan.GemmPlan:
    """The plan the wrapper follows for a CUDA launch on these operands
    (``order_n``: see :func:`unified_linear`)."""
    m, k = x2.shape
    n = w.shape[1]
    ptrs = [x2.data_ptr(), w.data_ptr()] + ([y.data_ptr()] if y is not None
                                            else [])
    return gemm_plan.plan_linear(m, n, k, x2.dtype,
                                 _sm_count(x2.device.index),
                                 all(p % 16 == 0 for p in ptrs), order_n)


def _launch(x2, w, b, activation, use_lut, step_log2, lut_range,
            out_dtype=None, order_n=None):
    if x2.dtype not in build.DTYPE_CODES or w.dtype != x2.dtype:
        raise TypeError(f"unified_linear kernel takes float32 or bfloat16 "
                        f"x and w of one dtype, got {x2.dtype}/{w.dtype}")
    if not (x2.is_contiguous() and w.is_contiguous()):
        raise ValueError("unified_linear kernel needs contiguous x and w")
    m, k = x2.shape
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"contraction mismatch {tuple(x2.shape)} @ "
                         f"{tuple(w.shape)}")
    n = w.shape[1]
    if w.device != x2.device:
        raise ValueError("x and w lie on different devices")
    if b is not None and (b.dtype != torch.float32 or b.shape != (n,)
                          or b.device != x2.device or not b.is_contiguous()):
        raise ValueError("bias must be a contiguous float32 (N,) tensor on "
                         "the same device")
    if activation not in ACTIVATIONS:
        raise ValueError(f"kernel epilogue has no {activation!r} fusion")
    if out_dtype not in (None, x2.dtype, torch.float32):
        raise TypeError(f"unified_linear kernel writes {x2.dtype} or "
                        f"float32, not {out_dtype}")
    y = torch.empty((m, n), dtype=out_dtype or x2.dtype, device=x2.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        raise ValueError("unified_linear kernel needs K > 0")
    lut = bool(use_lut and activation in ("gelu", "silu"))
    table = device_table(activation, step_log2, lut_range, x2.device) \
        if lut else None
    common = (x2.data_ptr(), w.data_ptr(),
              None if b is None else b.data_ptr(),
              None if table is None else table.data_ptr(),
              0 if table is None else table.shape[0], int(step_log2),
              y.data_ptr(), m, n, k, ACTIVATIONS[activation], int(lut))
    out_f32 = int(y.dtype == torch.float32)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    plan = plan_for(x2, w, y, order_n)
    if plan.variant == "simt":
        fn = build.function("unified_linear_launch", _SIMT_ARGS)
        err = fn(*common, build.DTYPE_CODES[x2.dtype], out_f32, stream)
    else:
        partials = tickets = None
        if plan.splits > 1:
            partials = torch.empty(plan.blocks * plan.bt // 2 * plan.nwg
                                   * 128, dtype=torch.float32,
                                   device=x2.device)
            tickets = build.tickets("unified_linear", x2.device, plan.tiles)
        fn = build.function("unified_linear_tc_launch", _TC_ARGS)
        err = fn(*common, plan.bt, plan.nwg, plan.splits, plan.stages,
                 plan.ranges, plan.promote, int(plan.fold), out_f32,
                 None if partials is None else partials.data_ptr(),
                 None if tickets is None else tickets.data_ptr(), stream)
    build.check(f"unified_linear ({plan.variant})", err)
    unified_linear.launches += 1
    unified_linear.variants[plan.variant] += 1
    return y


def _forward(x2, w, b, activation, use_lut, step_log2, lut_range,
             out_dtype=None, order_n=None):
    if x2.device.type in build.PLAIN_DEVICES:
        return unified_linear_plain(x2, w, b, activation=activation,
                                    use_lut=use_lut, step_log2=step_log2,
                                    lut_range=lut_range, out_dtype=out_dtype)
    if x2.device.type == "cuda":
        return _launch(x2.contiguous(), w.contiguous(), b, activation,
                       use_lut, step_log2, lut_range, out_dtype, order_n)
    raise ValueError(f"unified_linear runs on cuda, cpu or meta, "
                     f"not {x2.device}")


class UnifiedLinearFn(torch.autograd.Function):
    """The kernel (or, on the CPU, its plain version) forward; the
    backward in PyTorch, float32 throughout, each gradient in its
    operand's dtype."""

    @staticmethod
    def forward(ctx, x2, w, b, activation, use_lut, step_log2, lut_range,
                out_dtype=None, order_n=None):
        ctx.save_for_backward(x2, w, b)
        ctx.act = (activation, use_lut)
        return _forward(x2, w, b, activation, use_lut, step_log2, lut_range,
                        out_dtype, order_n)

    @staticmethod
    def backward(ctx, dy):
        # a profiler label: the backward's device time per kernel
        with torch.profiler.record_function("unified_linear.backward"):
            return UnifiedLinearFn._backward(ctx, dy)

    @staticmethod
    def _backward(ctx, dy):
        x2, w, b = ctx.saved_tensors
        activation, use_lut = ctx.act
        g = widen(dy)
        if activation not in (None, "none"):
            pre = torch.matmul(widen(x2), widen(w))
            if b is not None:
                pre = pre + widen(b)
            g = g * activation_grad(pre, activation, use_lut)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, widen(w).T).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(widen(x2).T, g).to(w.dtype)
        if b is not None and ctx.needs_input_grad[2]:
            db = g.sum(0).to(b.dtype)
        return dx, dw, db, None, None, None, None, None, None


def unified_linear(x, w, b=None, *, activation=None, use_lut=False,
                   step_log2=-8, lut_range=8.0, out_dtype=None,
                   order_n=None):
    """x: (..., K); w: (K, N); b: (N,) float32 or None -> (..., N) in
    ``x.dtype`` (or float32 with ``out_dtype=torch.float32``: a row
    shard's partial sums).  Leading dims are flattened into M.
    ``order_n``: w is a block of columns of a (K, order_n) weight, and the
    launch sums over K in that weight's order (``gemm_plan.sum_order``),
    so each column gets the bits the whole product gives it."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    args = (x2, w, b, activation, use_lut, step_log2, lut_range, out_dtype,
            order_n)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2, w, b)):
        y = UnifiedLinearFn.apply(*args)
    else:
        y = _forward(*args)
    return y.reshape(*lead, w.shape[1])


unified_linear.launches = 0
unified_linear.variants = {"tc": 0, "tc_splitk": 0, "simt": 0}
