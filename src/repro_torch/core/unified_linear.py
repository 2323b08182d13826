"""Unified linear layer (Edge-MoE §IV-E), the port of
``repro.core.unified_linear``.

Every linear layer goes through one op, ``"linear"``, whose implementation
(``eager`` matmul, ``cuda`` tiled-GEMM kernel with a fused bias + LUT
epilogue, ``ref``) the ambient compute policy names.  The sparse gather
(``token_index``) and the weighted accumulate (``accum_out``) stay here as
stages around whichever GEMM runs.  ``sparse_linear`` is the paper's
sparse-input mode and ``Linear`` a module over the same op.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["unified_linear", "sparse_linear", "Linear"]


def unified_linear(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None, *, activation=None,
                   token_index: torch.Tensor | None = None,
                   accum_out: torch.Tensor | None = None,
                   accum_weight: torch.Tensor | None = None,
                   preferred_dtype=None, out_dtype=None,
                   order_n: int | None = None) -> torch.Tensor:
    """y = act(x @ w + b), with optional sparse gather / weighted accumulate.

    x: (..., T, in_dim); w: (in_dim, out_dim); b: (out_dim,) float32.
    ``token_index`` (T',) gathers rows of x before the GEMM; with
    ``accum_out`` the result, scaled by ``accum_weight`` per row, is added
    onto that buffer (at ``token_index`` when given), out of place.
    ``preferred_dtype`` overrides the policy's accumulation dtype.
    The tensor-parallel blocks (``models/layers.py``) pass two more:
    ``out_dtype=torch.float32`` keeps a row shard's partial sums unrounded
    until they are added over the ranks, and ``order_n`` (the whole
    weight's width) sums a column shard in the whole product's order.
    """
    from repro_torch.ops.registry import dispatch

    if token_index is not None:
        x = torch.index_select(x, -2, token_index)
    extra = {}
    if out_dtype is not None:
        extra["out_dtype"] = out_dtype
    if order_n is not None:
        extra["order_n"] = order_n
    y = dispatch("linear", x, w, b, activation=activation,
                 preferred_dtype=preferred_dtype, **extra)
    if accum_out is None:
        return y
    scaled = y if accum_weight is None \
        else y * accum_weight[..., None].to(y.dtype)
    scaled = scaled.to(accum_out.dtype)
    if token_index is not None:
        return accum_out.index_add(-2, token_index, scaled)
    return accum_out + scaled


def sparse_linear(x, w, b, token_index, **kw):
    """The paper's sparse-input mode: rows ``token_index`` of x through
    the unified linear op."""
    return unified_linear(x, w, b, token_index=token_index, **kw)


class Linear(torch.nn.Module):
    """A linear layer through the unified op (dispatched by the ambient
    policy): weight (in_dim, out_dim) in ``dtype``, the widened float32
    bias.  ``Linear.init`` and ``Linear.apply`` are the reference's
    parameter helpers, on a flat {"w", "b"} dict."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = True,
                 dtype=torch.bfloat16, seed: int = 0, scale=None,
                 device="cuda", **kw):
        super().__init__()
        from repro_torch import resolve_device

        p = self.init(np.random.default_rng(seed), in_dim, out_dim,
                      bias=bias, dtype=dtype, scale=scale)
        dev = resolve_device(device)
        self.w = torch.nn.Parameter(p["w"].to(dev))
        self.b = None if "b" not in p else torch.nn.Parameter(p["b"].to(dev))
        self.kw = kw

    @staticmethod
    def init(rng, in_dim, out_dim, *, bias=True, dtype=torch.bfloat16,
             scale=None):
        """{"w": N(0, 1)·scale (default 1/√in_dim) in ``dtype``, "b":
        float32 zeros}, drawn by a NumPy generator."""
        scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
        w = rng.standard_normal((in_dim, out_dim), dtype=np.float32) \
            * np.float32(scale)
        p = {"w": torch.from_numpy(w).to(dtype)}
        if bias:
            p["b"] = torch.zeros((out_dim,), dtype=torch.float32)
        return p

    @staticmethod
    def apply(params, x, **kw):
        return unified_linear(x, params["w"], params.get("b"), **kw)

    def forward(self, x, **kw):
        return unified_linear(x, self.w, self.b, **{**self.kw, **kw})
