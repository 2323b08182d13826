"""Plain-PyTorch oracles, the port of ``repro.kernels.ref``: the
mathematical specification of each kernel (no blocking).

A kernel's oracle is its module's plain version, the function its wrapper
runs for CPU tensors and ``chip_smoke.py`` holds the kernel against; the
names below give those functions the reference's names, so each function
has one definition.  ``ref_moe_ffn`` has no kernel and is defined here."""

from __future__ import annotations

import torch

from repro_torch.core.gelu import exact_gelu, exact_silu
from repro_torch.kernels.decode_fused import \
    fused_decode_attention_plain as ref_decode_attention
from repro_torch.kernels.flash_attention import \
    flash_attention_plain as ref_attention
from repro_torch.kernels.gelu_lut import \
    lut_activation_plain as ref_lut_activation
from repro_torch.kernels.moe_gemm import moe_gemm_plain as ref_moe_gemm
from repro_torch.kernels.unified_linear import \
    unified_linear_plain as ref_linear

__all__ = [
    "ref_attention",
    "ref_decode_attention",
    "ref_linear",
    "ref_lut_activation",
    "ref_moe_gemm",
    "ref_moe_ffn",
]


def ref_moe_ffn(x, params, routing, *, cfg):
    """Token-level dense oracle for the routed expert layer: every expert on
    every token with exact activations, combined with the routing gates.
    x: (..., T, d); routing fields (..., T, k)."""
    xf = x.float()
    if cfg.expert_kind == "swiglu":
        g = torch.einsum("...td,edf->...etf", xf, params["wg"].float())
        u = torch.einsum("...td,edf->...etf", xf, params["wu"].float())
        y_all = torch.einsum("...etf,efd->...etd", exact_silu(g) * u,
                             params["wd"].float())
    else:
        h = torch.einsum("...td,edf->...etf", xf, params["w1"].float())
        h = exact_gelu(h + params["b1"].float()[:, None, :])
        y_all = torch.einsum("...etf,efd->...etd", h, params["w2"].float())
        y_all = y_all + params["b2"].float()[:, None, :]
    wgt = torch.where(routing.valid, routing.gate, 0.0).float()
    per_token = y_all.movedim(-3, -2)                     # (..., T, E, d)
    idx = routing.expert.long()[..., None].expand(
        *routing.expert.shape, per_token.shape[-1])
    picked = torch.gather(per_token, -2, idx)             # (..., T, k, d)
    return (picked * wgt[..., None]).sum(dim=-2).to(x.dtype)
