"""gelu_lut: the §IV-C LUT activation ``ReLU(x) − δ(|x|)`` as an elementwise
kernel.

Replaces the Pallas kernel ``src/repro/kernels/gelu_lut.py``
(``lut_activation_kernel`` / ``lut_activation_call``, reached through
``kernels/ops.py:lut_activation``).  CUDA source: ``csrc/gelu_lut.cu``.

What bounds it on the H100: a handful of operations per element against
4 bytes read and 4 written (float32), so it is bound by bytes.  Its design:
a grid-stride loop over the flat tensor with the 8 KB half-table copied to
shared memory once per block, the index rounded half to even in float32
(``__float2int_rn``) after "in range" is decided in float, and the
reference's non-finite rule; no 128-lane padding of the input (the TPU
wrapper's) is made.

The public :func:`lut_activation` runs the plain version
(``core.gelu.lut_activation``) for CPU tensors and launches the kernel for
CUDA tensors, or raises.  With gradients enabled and an input that requires
one, the same forward runs inside :class:`LutActivationFn`, whose backward
multiplies the incoming gradient by ``core.gelu.lut_grad`` (ReLU's
derivative through ``maximum``, 0.5 at exactly 0; the reference's rule for
non-finite inputs) in float32.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.gelu import device_table, lut_grad, widen
from repro_torch.core.gelu import lut_activation as lut_activation_plain
from repro_torch.kernels import build

__all__ = ["lut_activation", "lut_activation_plain", "LutActivationFn"]


def _launch(x, kind, step_log2, lut_range):
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"gelu_lut kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gelu_lut kernel needs a contiguous input")
    table = device_table(kind, step_log2, lut_range, x.device)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = build.function("lut_activation_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(x.data_ptr(), y.data_ptr(), x.numel(), table.data_ptr(),
             table.shape[0], int(step_log2), build.DTYPE_CODES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("gelu_lut", err)
    lut_activation.launches += 1
    return y


def lut_activation(x, kind="gelu", *, step_log2=-8, lut_range=8.0):
    """Elementwise ``ReLU(x) − δ(|x|)`` in float32, returned in ``x.dtype``
    (``kind`` is ``"gelu"`` or ``"silu"``)."""
    if kind not in ("gelu", "silu"):
        raise ValueError(f"no LUT correction table for {kind!r}")
    if torch.is_grad_enabled() and x.requires_grad:
        return LutActivationFn.apply(x, kind, step_log2, lut_range)
    return _forward(x, kind, step_log2, lut_range)


def _forward(x, kind, step_log2, lut_range):
    if x.device.type in build.PLAIN_DEVICES:
        return lut_activation_plain(x, kind, step_log2=step_log2,
                                    rng=lut_range)
    if x.device.type == "cuda":
        return _launch(x.contiguous(), kind, step_log2, lut_range)
    raise ValueError(f"lut_activation runs on cuda, cpu or meta, "
                     f"not {x.device}")


class LutActivationFn(torch.autograd.Function):
    """The kernel (or, on the CPU, its plain version) forward; backward
    ``dy · lut_grad(x)`` in float32, in ``x.dtype``."""

    @staticmethod
    def forward(ctx, x, kind, step_log2, lut_range):
        ctx.save_for_backward(x)
        return _forward(x, kind, step_log2, lut_range)

    @staticmethod
    def backward(ctx, dy):
        # a profiler label: the backward's device time per kernel
        with torch.profiler.record_function("gelu_lut.backward"):
            return LutActivationFn._backward(ctx, dy)

    @staticmethod
    def _backward(ctx, dy):
        x, = ctx.saved_tensors
        return (widen(dy) * lut_grad(widen(x))).to(x.dtype), None, None, \
            None


lut_activation.launches = 0
