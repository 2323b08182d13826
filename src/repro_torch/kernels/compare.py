"""Tolerances for holding a kernel (or the JAX reference) against a plain
version, stated once and used by the tests and by ``chip_smoke.py``.

* float32: ``|got − want| <= 1e-5 + 1e-5·|want|`` — float32 sums taken in
  another order.
* bfloat16: ``|got − want| <=`` one bf16 ulp of ``max(|got|, |want|)``
  plus the float32 tolerance — both round a float32 result to bf16, and
  the two float32 results may differ by the float32 tolerance (which
  matters only near zero, where a sum of O(1) terms cancels).
* A LUT epilogue adds one case: where the float32 pre-activation lies
  within ``1e-5·(1 + |pre|)`` of a half-step of the table index, two
  summation orders can round the index to neighbouring entries, so there
  the difference may also include the largest step between adjacent table
  entries.
"""

from __future__ import annotations

import torch

from repro_torch.core.gelu import device_table

__all__ = ["bf16_ulp", "kernel_tolerance", "within_tolerance",
           "max_abs_err", "cosine"]


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at |x| (float32 tensor)."""
    ax = x.abs().float().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(ax)) - 7)


def kernel_tolerance(got: torch.Tensor, want: torch.Tensor, dtype, *,
                     lut_pre: torch.Tensor | None = None, kind="gelu",
                     step_log2=-8, lut_range=8.0) -> torch.Tensor:
    """Per-element allowed |got − want| under the rules above."""
    g, w = got.float(), want.float()
    tol = 1e-5 + 1e-5 * w.abs()
    if dtype == torch.bfloat16:
        tol = tol + bf16_ulp(torch.maximum(g.abs(), w.abs()))
    elif dtype != torch.float32:
        raise TypeError(f"no stated tolerance for {dtype}")
    if lut_pre is not None:
        pre = lut_pre.float()
        t = pre.abs() * 2.0 ** (-step_log2)
        near = (t - torch.floor(t) - 0.5).abs() \
            < 1e-5 * (1.0 + pre.abs()) * 2.0 ** (-step_log2)
        table = device_table(kind, step_log2, lut_range, got.device)
        jump = float((table[1:] - table[:-1]).abs().max())
        tol = torch.where(near, tol + jump, tol)
    return tol


def within_tolerance(got: torch.Tensor, want: torch.Tensor, dtype,
                     **kw) -> bool:
    """True when every element is within :func:`kernel_tolerance` and the
    non-finite values (NaN, ±inf) sit at the same places."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        return False
    if max_abs_err(g, w) == float("inf"):
        return False
    fin = torch.isfinite(g) & torch.isfinite(w)
    tol = kernel_tolerance(g, w, dtype, **kw)
    return bool(((g - w).abs() <= tol)[fin].all())


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over finite positions; a NaN or inf in one and not
    at the same place in the other counts as inf."""
    g, w = got.float(), want.float()
    same_nonfinite = (~torch.isfinite(g)) & (~torch.isfinite(w)) & (
        (torch.isnan(g) & torch.isnan(w)) | (g == w))
    if ((~torch.isfinite(g) | ~torch.isfinite(w)) & ~same_nonfinite).any():
        return float("inf")
    d = torch.where(same_nonfinite, 0.0, (g - w).abs())
    return float(d.max()) if d.numel() else 0.0


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-300))
