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
           "max_abs_err", "cosine", "moe_lut_allowance", "TRAIN_LOSS_RTOL",
           "GRAD_COSINE_ALL", "GRAD_COSINE_LEAF", "GRAD_LEAF_FLOOR",
           "GRAD_FLOAT32_MARGIN", "grad_agreement", "training_agrees",
           "SERVE_COSINE", "SERVE_NOISE_RATIO", "serving_agrees"]

#: Training through the kernels against the default policy (the
#: reference's training policy) on the same parameters and batch
#: (:func:`training_agrees`): the loss within TRAIN_LOSS_RTOL relative;
#: the cosine of each gradient leaf whose norm exceeds GRAD_LEAF_FLOOR ×
#: the largest leaf norm at least GRAD_COSINE_LEAF; and the cosine of all
#: leaves together at least GRAD_COSINE_ALL — or, where bf16 rounding
#: alone puts the default policy's own gradients further than that from
#: the same model's float32 gradients (the exact ones, up to float32
#: rounding), the kernels' gradients no further from the float32 ones than
#: the default policy's, less GRAD_FLOAT32_MARGIN.  Both policies compute
#: the same functions (the kernels' backward is their derivative) in bf16
#: with other sums, other roundings of the softmax weights and LUT indices
#: that can round apart at a half-step: two bf16 estimates of one
#: gradient, which agree in direction, not bit for bit.  On the CPU at
#: Llama-3.2-1B's smoke size (4 layers, 4 × 128 tokens) the reference's
#: own two plain attention impls (blocked, naive) give gradients at cosine
#: 0.9984 of each other, and each bf16 policy's sit at 0.9981 of the
#: float32 ones: the all-leaves target of 0.999 lies below that noise
#: there, while M³ViT meets it (0.99999).
TRAIN_LOSS_RTOL = 0.01
GRAD_COSINE_ALL = 0.999
GRAD_COSINE_LEAF = 0.99
GRAD_LEAF_FLOOR = 1e-3
GRAD_FLOAT32_MARGIN = 1e-3
#: Serving through the kernels against the plain policy on the card, the
#: same weights and teacher-forced tokens (:func:`serving_agrees`): the
#: logits of every step at cosine >= SERVE_COSINE — or, where bf16
#: rounding alone puts the plain policy's logits further than that from
#: the same model's float32 logits, the kernels' distance from the float32
#: logits (1 − cosine) at every step at most SERVE_NOISE_RATIO times the
#: plain policy's, plus GRAD_FLOAT32_MARGIN.  Two bf16 policies sum in
#: other orders, and a stack that amplifies bf16 roundings scatters two
#: correct bf16 runs about the float32 result: on the CPU at xLSTM-350M's
#: smoke size the reference's and the port's bf16 logits sit 0.00573 and
#: 0.00667 from the reference's float32 ones (16 % apart); on the H100 at
#: full size xLSTM's plain bf16 logits sit 0.038 from float32 and the
#: kernels' 0.040, RecurrentGemma-9B's 0.00138 and 0.00135, while each
#: kernel launch holds its plain version to one bf16 ulp (``chip_smoke.py``
#: phase 5).  The ratio was set after that first reading of xLSTM at full
#: size, where the plain policy itself sits at cosine 0.962 of float32.
SERVE_COSINE = 0.999
SERVE_NOISE_RATIO = 1.25


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


def grad_agreement(got: dict, want: dict) -> tuple[float, str, float]:
    """(cosine over every leaf together, the worst leaf among those whose
    norm in ``want`` exceeds ``GRAD_LEAF_FLOOR`` × the largest, its
    cosine) for two {name: gradient} dicts."""
    names = sorted(want)
    norms = {k: float(want[k].double().norm()) for k in names}
    floor = GRAD_LEAF_FLOOR * max(norms.values())
    whole = cosine(torch.cat([got[k].double().flatten() for k in names]),
                   torch.cat([want[k].double().flatten() for k in names]))
    worst = min((cosine(got[k], want[k]), k) for k in names
                if norms[k] > floor)
    return whole, worst[1], worst[0]


def training_agrees(loss_k: float, loss_d: float, grads_k: dict,
                    grads_d: dict, grads_f32: dict | None = None):
    """(ok, readings): the kernels' loss and gradients (``_k``) against
    the default policy's (``_d``) under the training bounds above;
    ``grads_f32``, the same model's float32 gradients under the default
    policy, is needed only where the all-leaves cosine falls short of
    GRAD_COSINE_ALL."""
    whole, leaf, worst = grad_agreement(grads_k, grads_d)
    r = {"loss_rel": abs(loss_k - loss_d) / abs(loss_d), "cosine": whole,
         "worst_leaf": leaf, "worst_leaf_cosine": worst}
    if grads_f32 is not None:
        r["cosine_f32_kernels"] = grad_agreement(grads_k, grads_f32)[0]
        r["cosine_f32_default"] = grad_agreement(grads_d, grads_f32)[0]
    whole_ok = whole >= GRAD_COSINE_ALL or (
        grads_f32 is not None and r["cosine_f32_kernels"]
        >= r["cosine_f32_default"] - GRAD_FLOAT32_MARGIN)
    ok = (r["loss_rel"] <= TRAIN_LOSS_RTOL and worst >= GRAD_COSINE_LEAF
          and whole_ok)
    return ok, r


def serving_agrees(kernel_plain: list, kernel_f32: list | None = None,
                   plain_f32: list | None = None) -> bool:
    """The serving rule above, from per-step cosines: kernels against the
    plain policy, and (when the first falls short) each against the
    float32 logits."""
    if min(kernel_plain) >= SERVE_COSINE:
        return True
    if kernel_f32 is None or plain_f32 is None:
        return False
    return all(1.0 - k <= SERVE_NOISE_RATIO * (1.0 - p) + GRAD_FLOAT32_MARGIN
               for k, p in zip(kernel_f32, plain_f32))
