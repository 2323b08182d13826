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
    "lut_gelu",
    "lut_silu",
    "get_activation",
    "build_delta_table",
    "device_table",
    "lut_grad",
    "activation_grad",
    "widen",
    "LUT_STEP_LOG2",
    "LUT_RANGE",
]

LUT_STEP_LOG2 = -8
LUT_RANGE = 8.0

_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype the kernels' plain versions and backward compute
    in: float32, or float64 for a float64 ``x`` (so a float64
    ``gradcheck`` sees float64 arithmetic)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


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


def build_delta_table(kind: str = "gelu", step_log2: int = LUT_STEP_LOG2,
                      rng: float = LUT_RANGE, dtype=torch.float32,
                      device="cpu") -> torch.Tensor:
    """The half-table of δ(x) for x in [0, rng) at step 2^step_log2: entry
    i holds δ(i · 2^step_log2); δ is even, so negative x reuse it (the
    paper stores only x >= 0).  Values lie in [0, 1)."""
    return torch.from_numpy(_delta_table_f64(kind, step_log2, rng)).to(
        device=device, dtype=dtype)


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
    # maximum, not clamp_min: the same values, and at y == 0 the gradient
    # 0.5 that the reference's jnp.maximum gives (clamp_min gives 1)
    out = torch.maximum(y, y.new_zeros(())) - delta
    # torch.sign(NaN) is 0 where jnp.sign gives NaN: the same NaN out, but
    # a NaN gradient only with jnp's sign
    sign = torch.where(torch.isnan(y), y, torch.sign(y))
    return torch.where(finite, out, y * 0.5 * (1.0 + sign))


def lut_grad(y: torch.Tensor) -> torch.Tensor:
    """d lut_correction / dy for float32 y, as ``jax.grad`` of the
    reference's gives it: the table's gather carries no gradient, so a
    finite y has ReLU's derivative through ``jnp.maximum`` (1 above 0, 0.5
    at 0, 0 below); a non-finite y has ``0.5 * (1 + sign(y))`` (1 at +inf,
    0 at -inf, NaN at NaN)."""
    one, zero = y.new_ones(()), y.new_zeros(())
    finite = torch.where(y > 0, one, torch.where(y == 0, 0.5 * one, zero))
    other = torch.where(torch.isnan(y), y, torch.where(y > 0, one, zero))
    return torch.where(torch.isfinite(y), finite, other)


_INV_SQRT_2PI = float(1.0 / math.sqrt(2.0 * math.pi))


def activation_grad(y: torch.Tensor, kind: str,
                    use_lut: bool = False) -> torch.Tensor:
    """The derivative of a fused epilogue's activation at the float32
    pre-activation ``y``: the LUT's (:func:`lut_grad`) for gelu/silu under
    LUT activations; otherwise the analytic derivative of
    :func:`exact_gelu` / :func:`exact_silu`, and ReLU's as ``jax.nn.relu``
    has it (0 at 0: the reference's training policy runs a relu epilogue
    as its ``xla`` activation)."""
    if kind == "relu":
        return (y > 0).to(y.dtype)
    if use_lut and kind in ("gelu", "silu"):
        return lut_grad(y)
    if kind == "gelu":
        return 0.5 * (1.0 + torch.erf(y / _SQRT2_F32)) \
            + y * torch.exp(-0.5 * y * y) * _INV_SQRT_2PI
    if kind == "silu":
        s = torch.sigmoid(y)
        return s * (1.0 + y * (1.0 - s))
    raise ValueError(f"no derivative for activation {kind!r}")


def lut_activation(x: torch.Tensor, kind: str = "gelu", table=None,
                   step_log2: int = LUT_STEP_LOG2,
                   rng: float = LUT_RANGE) -> torch.Tensor:
    """ReLU(x) − δ(|x|) with δ from the LUT (paper Eq. 4), computed in
    float32 and returned in ``x.dtype``."""
    if table is None:
        table = device_table(kind, step_log2, rng, x.device)
    y = lut_correction(widen(x), table.float(), step_log2)
    return y.to(x.dtype)


def lut_gelu(x, **kw):
    return lut_activation(x, kind="gelu", **kw)


def lut_silu(x, **kw):
    return lut_activation(x, kind="silu", **kw)


def get_activation(name: str, use_lut: bool = False):
    """Explicit exact-vs-LUT selection.  Model code goes through the
    policy-dispatched ``repro_torch.ops.apply_activation`` (op
    ``"activation"``); this pins one form, for oracles and tests."""
    if name in (None, "none", "identity"):
        return lambda x: x
    if name == "relu":
        return torch.relu
    if name == "gelu":
        return lut_gelu if use_lut else exact_gelu
    if name == "silu":
        return lut_silu if use_lut else exact_silu
    raise ValueError(f"unknown activation: {name}")
