"""Analytic HBM traffic of the MoE expert layer: staged vs fused megakernel.

The staged ``moe_ffn`` path (dispatch → grouped GEMMs → combine) round-trips
the ``(E, C, d)`` dispatch buffer and every ``(E, C, f)`` hidden through HBM
— written at dispatch, re-read per projection, re-written per projection
output.  The fused megakernel gathers tokens from the resident activation
block, keeps every intermediate in VMEM, and writes only the combined
``(T, d)`` output: the modeled traffic it pays is activations once, weights
once *per active expert*, and the two small ``(E, C)`` index/gate arrays.

Dtype awareness is load-bearing: parameters stream at their storage width
(bf16 = 2 B), while materialized GEMM outputs are f32 accumulators (4 B) —
modeling everything at one width under- or over-states the staged path's
cast traffic and the fused path's advantage.

These are *models*, built the same way as
:func:`repro_torch.roofline.analysis.flash_kernel_bytes`: count each array
read/written by each stage exactly once per touch.  The port of
``repro.roofline.moe_traffic``, the same arithmetic with dtype widths from
``torch.dtype.itemsize``; in the port "VMEM" reads as the kernel's shared
memory and registers.
"""

from __future__ import annotations

import torch

__all__ = ["staged_moe_bytes", "fused_moe_bytes", "moe_traffic_report"]

_F32 = 4  # materialized GEMM outputs / biases are float32 accumulators


def _bytes(dtype) -> int:
    """Width of ``dtype``: a ``torch.dtype`` or its name ("bfloat16")."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return dtype.itemsize


def staged_moe_bytes(*, tokens: int, d_model: int, d_ff: int,
                     num_experts: int, capacity: int, kind: str = "gelu",
                     param_dtype="bfloat16", act_dtype="bfloat16") -> dict:
    """Modeled HBM bytes of the staged path for one routed group.

    Counts every stage of the seed pipeline: dispatch (x read, buffer
    write), each ``moe_grouped_gemm`` (buffer read, weights read, f32
    output write), activation/bias epilogues (read accumulators, write the
    cast hidden), and the combine (read expert outputs, write y).  The
    dense einsum touches ALL ``num_experts`` experts' weights — empty
    queues included (the metaqueue skip belongs to the kernels).
    """
    ab, pb = _bytes(act_dtype), _bytes(param_dtype)
    t, d, f, e, c = tokens, d_model, d_ff, num_experts, capacity
    ecd, ecf = e * c * d, e * c * f
    items = {
        "x_read": t * d * ab,
        "dispatch_buffer_write": ecd * ab,
    }
    if kind == "swiglu":
        items.update({
            "gemm_reads_buffer": 2 * ecd * ab,          # wg and wu GEMMs
            "weights_read": 3 * e * d * f * pb,          # wg, wu, wd (all E)
            "gemm_hidden_writes": 2 * ecf * _F32,        # g, u f32 outputs
            "act_mul_reads": 2 * ecf * _F32,
            "act_mul_write": ecf * ab,                   # h cast to act dtype
            "down_gemm_read": ecf * ab,
            "down_gemm_write": ecd * _F32,
            "cast_out": ecd * (_F32 + ab),               # f32 → act dtype
        })
    else:
        items.update({
            "gemm1_read_buffer": ecd * ab,
            "weights_read": 2 * e * d * f * pb,          # w1, w2 (all E)
            "bias_read": e * (f + d) * _F32,
            "gemm1_write": ecf * _F32,
            "act_read": ecf * _F32,
            "act_write": ecf * ab,
            "gemm2_read": ecf * ab,
            "gemm2_write": ecd * _F32,
            "bias2_epilogue": ecd * (_F32 + ab),         # read f32, write cast
        })
    items["combine_read"] = ecd * ab
    items["y_write"] = t * d * ab
    return {"total": sum(items.values()), "items": items}


def fused_moe_bytes(*, tokens: int, d_model: int, d_ff: int,
                    num_experts: int, capacity: int,
                    active_experts: int | None = None, kind: str = "gelu",
                    param_dtype="bfloat16", act_dtype="bfloat16",
                    lut_entries: int = 2048) -> dict:
    """Modeled HBM bytes of the fused megakernel for one routed group.

    The ``(E, C, d)`` buffer and every hidden stay in VMEM: HBM sees the
    activations once (resident across the expert sweep), each *active*
    expert's weights once (empty queues are skipped before their tiles are
    pulled — pass ``active_experts`` from measured ``group_sizes``; defaults
    to all experts, the worst case), the combined f32 output once, and the
    (E, C) int32 token-index / f32 gate arrays the wrapper stages.
    """
    ab, pb = _bytes(act_dtype), _bytes(param_dtype)
    t, d, f, e, c = tokens, d_model, d_ff, num_experts, capacity
    act = e if active_experts is None else active_experts
    n_w = 3 if kind == "swiglu" else 2
    items = {
        "x_read": t * d * ab,
        "weights_read": act * n_w * d * f * pb,
        "out_write": t * d * _F32,                       # f32 combine buffer
        "queue_index_arrays": e * c * (4 + 4),           # tok_idx + gates
        "lut_table": lut_entries * _F32,
    }
    if kind == "gelu":
        items["bias_read"] = act * (f + d) * _F32
    return {"total": sum(items.values()), "items": items}


def moe_traffic_report(*, tokens: int, d_model: int, d_ff: int,
                       num_experts: int, capacity: int,
                       active_experts: int | None = None,
                       kind: str = "gelu", param_dtype="bfloat16",
                       act_dtype="bfloat16") -> dict:
    """Staged vs fused side by side, with the headline ratio."""
    staged = staged_moe_bytes(
        tokens=tokens, d_model=d_model, d_ff=d_ff, num_experts=num_experts,
        capacity=capacity, kind=kind, param_dtype=param_dtype,
        act_dtype=act_dtype)
    fused = fused_moe_bytes(
        tokens=tokens, d_model=d_model, d_ff=d_ff, num_experts=num_experts,
        capacity=capacity, active_experts=active_experts, kind=kind,
        param_dtype=param_dtype, act_dtype=act_dtype)
    return {
        "staged_bytes": staged["total"],
        "fused_bytes": fused["total"],
        "ratio_staged_over_fused": staged["total"] / fused["total"],
        "staged_items": staged["items"],
        "fused_items": fused["items"],
    }
