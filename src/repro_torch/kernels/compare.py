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
  entries.  Where such a hidden unit feeds a later product (the fused
  MoE's ``h @ w2``), :func:`moe_lut_allowance` carries that step through
  the product to the output.
"""

from __future__ import annotations

import torch

from repro_torch.core.gelu import device_table

__all__ = ["bf16_ulp", "kernel_tolerance", "within_tolerance",
           "max_abs_err", "cosine", "moe_lut_allowance"]


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at |x| (float32 tensor)."""
    ax = x.abs().float().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(ax)) - 7)


def _near_half_step(pre: torch.Tensor, step_log2: int) -> torch.Tensor:
    """Where a float32 pre-activation lies close enough to a half-step
    of the table index for two summation orders to round it apart."""
    pre = pre.float()
    t = pre.abs() * 2.0 ** (-step_log2)
    return (t - torch.floor(t) - 0.5).abs() \
        < 1e-5 * (1.0 + pre.abs()) * 2.0 ** (-step_log2)


def _table_jump(kind, step_log2, lut_range, device) -> float:
    """The largest step between adjacent entries of the half-table."""
    table = device_table(kind, step_log2, lut_range, device)
    return float((table[1:] - table[:-1]).abs().max())


def kernel_tolerance(got: torch.Tensor, want: torch.Tensor, dtype, *,
                     lut_pre: torch.Tensor | None = None, kind="gelu",
                     step_log2=-8, lut_range=8.0,
                     extra: torch.Tensor | None = None) -> torch.Tensor:
    """Per-element allowed |got − want| under the rules above
    (``extra``, e.g. :func:`moe_lut_allowance`, is added as it is)."""
    g, w = got.float(), want.float()
    tol = 1e-5 + 1e-5 * w.abs()
    if dtype == torch.bfloat16:
        tol = tol + bf16_ulp(torch.maximum(g.abs(), w.abs()))
    elif dtype != torch.float32:
        raise TypeError(f"no stated tolerance for {dtype}")
    if lut_pre is not None:
        near = _near_half_step(lut_pre, step_log2)
        tol = torch.where(near, tol + _table_jump(kind, step_log2, lut_range,
                                                  got.device), tol)
    if extra is not None:
        tol = tol + extra
    return tol


def moe_lut_allowance(x, params, expert, gate, valid, *, kind,
                      step_log2=-8, lut_range=8.0) -> torch.Tensor:
    """The LUT rule carried through the fused MoE layer: (G, T, d)
    float32 allowance on its output.  Every hidden unit of a token's valid
    slot whose float32 pre-activation lies on an index half-step may take
    the neighbouring table entry (one table step, times the SwiGLU up
    projection), and the down projection carries that step to the output
    scaled by |gate| · |w_out[f, :]|.  x: (G, T, d); routing (G, T, k)."""
    xf = x.float()
    if kind == "swiglu":
        pre = torch.einsum("gtd,edf->gtef", xf, params["wg"].float())
        mult = torch.einsum("gtd,edf->gtef", xf, params["wu"].float()).abs()
        w_out = params["wd"].float().abs()
    else:
        pre = torch.einsum("gtd,edf->gtef", xf, params["w1"].float()) \
            + params["b1"].float()
        mult = 1.0
        w_out = params["w2"].float().abs()
    jump = _table_jump("silu" if kind == "swiglu" else "gelu", step_log2,
                       lut_range, x.device)
    flips = _near_half_step(pre, step_log2).float() * jump * mult
    weight = torch.zeros(flips.shape[:3], device=x.device)    # (G, T, E)
    weight.scatter_add_(-1, expert.long(),
                        (gate.float() * valid.float()).abs())
    return torch.einsum("gtef,efd->gtd", flips * weight[..., None], w_out)


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
