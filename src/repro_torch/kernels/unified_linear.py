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
  where N or K is small, so the grid covers the SMs (K is split only where
  even those leave SMs idle).
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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.gelu import (device_table, exact_gelu, exact_silu,
                                   lut_correction)
from repro_torch.kernels import build, gemm_plan

__all__ = ["unified_linear", "unified_linear_plain", "ACTIVATIONS"]

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
                         step_log2=-8, lut_range=8.0):
    """The kernel's arithmetic in plain PyTorch: float32 products and
    accumulation, float32 bias, the epilogue, one cast to ``x.dtype``."""
    y = torch.matmul(x.float(), w.float())
    if b is not None:
        y = y + b.float()
    table = None
    if use_lut and activation in ("gelu", "silu"):
        table = device_table(activation, step_log2, lut_range, x.device)
    return _epilogue(y, activation, use_lut, table, step_log2).to(x.dtype)


_TC_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p] + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p] * 3
_SIMT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p] + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x2, w, y=None) -> gemm_plan.GemmPlan:
    """The plan the wrapper follows for a CUDA launch on these operands."""
    m, k = x2.shape
    n = w.shape[1]
    ptrs = [x2.data_ptr(), w.data_ptr()] + ([y.data_ptr()] if y is not None
                                            else [])
    return gemm_plan.plan_linear(m, n, k, x2.dtype,
                                 _sm_count(x2.device.index),
                                 all(p % 16 == 0 for p in ptrs))


def _launch(x2, w, b, activation, use_lut, step_log2, lut_range):
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
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
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
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    plan = plan_for(x2, w, y)
    if plan.variant == "simt":
        fn = build.function("unified_linear_launch", _SIMT_ARGS)
        err = fn(*common, build.DTYPE_CODES[x2.dtype], stream)
    else:
        partials = tickets = None
        if plan.splits > 1:
            partials = torch.empty(plan.blocks * plan.bt // 2 * plan.nwg
                                   * 128, dtype=torch.float32,
                                   device=x2.device)
            tickets = build.tickets("unified_linear", x2.device, plan.tiles)
        fn = build.function("unified_linear_tc_launch", _TC_ARGS)
        err = fn(*common, plan.bt, plan.nwg, plan.splits, plan.stages,
                 None if partials is None else partials.data_ptr(),
                 None if tickets is None else tickets.data_ptr(), stream)
    build.check(f"unified_linear ({plan.variant})", err)
    unified_linear.launches += 1
    unified_linear.variants[plan.variant] += 1
    return y


def unified_linear(x, w, b=None, *, activation=None, use_lut=False,
                   step_log2=-8, lut_range=8.0):
    """x: (..., K); w: (K, N); b: (N,) float32 or None -> (..., N) in
    ``x.dtype``.  Leading dims are flattened into M."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = unified_linear_plain(x2, w, b, activation=activation,
                                 use_lut=use_lut, step_log2=step_log2,
                                 lut_range=lut_range)
    elif x.device.type == "cuda":
        y = _launch(x2.contiguous(), w.contiguous(), b, activation, use_lut,
                    step_log2, lut_range)
    else:
        raise ValueError(f"unified_linear runs on cuda or cpu, not "
                         f"{x.device}")
    return y.reshape(*lead, w.shape[1])


unified_linear.launches = 0
unified_linear.variants = {"tc": 0, "tc_splitk": 0, "simt": 0}
