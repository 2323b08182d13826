"""Unified linear layer (Edge-MoE §IV-E), the port of
``repro.core.unified_linear``.

Every linear layer goes through one op, ``"linear"``, whose implementation
(``eager`` matmul, ``cuda`` tiled-GEMM kernel with a fused bias + LUT
epilogue, ``ref``) the ambient compute policy names.  The sparse gather
(``token_index``) and the weighted accumulate (``accum_out``) stay here as
stages around whichever GEMM runs.
"""

from __future__ import annotations

import torch

__all__ = ["unified_linear"]


def unified_linear(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None, *, activation=None,
                   token_index: torch.Tensor | None = None,
                   accum_out: torch.Tensor | None = None,
                   accum_weight: torch.Tensor | None = None,
                   preferred_dtype=None) -> torch.Tensor:
    """y = act(x @ w + b), with optional sparse gather / weighted accumulate.

    x: (..., T, in_dim); w: (in_dim, out_dim); b: (out_dim,) float32.
    ``token_index`` (T',) gathers rows of x before the GEMM; with
    ``accum_out`` the result, scaled by ``accum_weight`` per row, is added
    onto that buffer (at ``token_index`` when given), out of place.
    ``preferred_dtype`` overrides the policy's accumulation dtype.
    """
    from repro_torch.ops.registry import dispatch

    if token_index is not None:
        x = torch.index_select(x, -2, token_index)
    y = dispatch("linear", x, w, b, activation=activation,
                 preferred_dtype=preferred_dtype)
    if accum_out is None:
        return y
    scaled = y if accum_weight is None \
        else y * accum_weight[..., None].to(y.dtype)
    scaled = scaled.to(accum_out.dtype)
    if token_index is not None:
        return accum_out.index_add(-2, token_index, scaled)
    return accum_out + scaled
