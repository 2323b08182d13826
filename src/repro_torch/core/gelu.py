"""LUT activation approximation (Edge-MoE §IV-C), the port of
``repro.core.gelu``.

``GELU(x) ~= ReLU(x) - delta(|x|)`` with ``delta`` tabulated on the x >= 0
half at a power-of-two step and truncated where GELU rounds to ReLU.  The
table is built in float64 NumPy and cast to float32 exactly as the
reference does, so both sides hold the same bits.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = [
    "exact_gelu",
    "exact_silu",
    "lut_correction",
    "lut_activation",
    "device_table",
    "LUT_STEP_LOG2",
    "LUT_RANGE",
]

LUT_STEP_LOG2 = -8
LUT_RANGE = 8.0

_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    """Reference GELU, Eq. (1): x * 0.5 * (1 + erf(x / sqrt(2))).

    The reference divides by a float32 NumPy scalar, which promotes bf16/f16
    inputs to float32; the same promotion happens here."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    return xf * 0.5 * (1.0 + torch.erf(xf / _SQRT2_F32))


def exact_silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _delta_table_f64(kind: str, step_log2: int, rng: float) -> np.ndarray:
    """The correction table in float64 NumPy (same construction as the
    reference's ``_delta_table_f64``)."""
    step = 2.0**step_log2
    n = int(rng / step)
    xs = np.arange(n, dtype=np.float64) * step
    if kind == "gelu":
        base = xs * 0.5 * (1.0 + np.vectorize(math.erf)(xs / math.sqrt(2.0)))
    elif kind == "silu":
        base = xs / (1.0 + np.exp(-xs))
    else:
        raise ValueError(f"unknown LUT activation kind: {kind}")
    delta = np.maximum(xs, 0.0) - base
    if not ((delta >= 0.0).all() and (delta < 1.0).all()):
        raise ValueError("LUT correction outside [0, 1)")
    return delta


@functools.lru_cache(maxsize=None)
def _cached_table(kind: str, step_log2: int, rng: float) -> np.ndarray:
    return _delta_table_f64(kind, step_log2, rng).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_table_cached(kind: str, step_log2: int, rng: float,
                         device: str) -> torch.Tensor:
    return torch.from_numpy(_cached_table(kind, step_log2, rng)).to(device)


def device_table(kind: str, step_log2: int, rng: float,
                 device) -> torch.Tensor:
    """The float32 half-table as a tensor on ``device`` (cached per device:
    a kernel launch then costs no host-to-device copy)."""
    return _device_table_cached(kind, int(step_log2), float(rng),
                                str(torch.device(device)))


def lut_correction(y: torch.Tensor, table: torch.Tensor,
                   step_log2: int) -> torch.Tensor:
    """ReLU(y) − δ(|y|), with the reference's clamped index, half-to-even
    rounding (``torch.round``, as ``jnp.round``) and non-finite rule:
    non-finite y return ``y * 0.5 * (1 + sign(y))``.  ``y`` and ``table``
    are float32."""
    n = table.shape[0]
    scale = 2.0 ** (-step_log2)
    ay = y.abs()
    finite = torch.isfinite(y)
    # in range decided in float, before any int cast
    in_range = finite & (ay * scale < n)
    r = torch.where(in_range, torch.round(ay * scale), 0.0)
    idx = r.to(torch.int64).clamp_(0, n - 1)
    delta = torch.where(in_range, table[idx], 0.0)
    out = torch.clamp_min(y, 0.0) - delta
    return torch.where(finite, out, y * 0.5 * (1.0 + torch.sign(y)))


def lut_activation(x: torch.Tensor, kind: str = "gelu", table=None,
                   step_log2: int = LUT_STEP_LOG2,
                   rng: float = LUT_RANGE) -> torch.Tensor:
    """ReLU(x) − δ(|x|) with δ from the LUT (paper Eq. 4), computed in
    float32 and returned in ``x.dtype``."""
    if table is None:
        table = device_table(kind, step_log2, rng, x.device)
    y = lut_correction(x.float(), table.float(), step_log2)
    return y.to(x.dtype)
