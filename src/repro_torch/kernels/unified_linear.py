"""unified_linear: ``y = act(x @ w + b)`` as one kernel (Edge-MoE §IV-E).

Replaces the Pallas kernel ``src/repro/kernels/unified_linear.py``
(``unified_linear_kernel`` / ``unified_linear_call``, reached through
``kernels/ops.py:unified_linear``).  CUDA source: ``csrc/unified_linear.cu``.

What bounds it on the H100: at the M3ViT shapes (M = 128·B tokens, K and N
between 192 and 4864; 0.08–1.9 GFLOP and 0.5–12 MB per call at B = 8) the
bytes set the least time (a few µs at 3.35 TB/s, against the 989 TFLOP/s
bf16 tensor-core peak).  This first kernel runs on the float32 FMA pipes,
so its time is set by operation issue and load latency, far above that
bound (``PERF.md``).  Its design: one
block per 64×64 output tile with a float32 accumulator, operands widened as
they are staged through shared memory (no TPU padding: ragged edges load as
zeros), and the bias + activation epilogue fused before the single store —
the activation costs no extra pass over memory.  wgmma/TMA come later.

The public :func:`unified_linear` flattens leading dims into M (what
``kernels/ops.py`` did) and, like the reference's ``_linear_pallas``,
returns ``x.dtype``.  For a CPU tensor it runs :func:`unified_linear_plain`;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.gelu import (device_table, exact_gelu, exact_silu,
                                   lut_correction)
from repro_torch.kernels import build

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
    fn = build.function("unified_linear_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    err = fn(x2.data_ptr(), w.data_ptr(),
             None if b is None else b.data_ptr(),
             None if table is None else table.data_ptr(),
             0 if table is None else table.shape[0], int(step_log2),
             y.data_ptr(), m, n, k, ACTIVATIONS[activation], int(lut),
             build.DTYPE_CODES[x2.dtype],
             torch.cuda.current_stream(x2.device).cuda_stream)
    build.check("unified_linear", err)
    unified_linear.launches += 1
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
