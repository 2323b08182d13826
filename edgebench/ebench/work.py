"""Frozen counts of the work the model needs: FLOPs for the model FLOPs
utilisation, and FLOPs and bytes per kernel launch for the rooflines.

A kernel's bound is max(FLOPs / peak FLOP/s, bytes / peak bytes/s) per
launch, summed over the launches.  Bytes count each input read once and
each output written once (bf16 activations and weights, float32 biases);
rows are the rows the inputs need (a routed MoE layer's top-k rows, not
its capacity; a prompt's real tokens, not its padding; a decode step's
live lanes at their own cache lengths).  These functions are the
benchmark's, apart from the program, so a program change cannot move
them.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1]
                    / "peaks.json").read_text())


def peaks(kind: str):
    """(FLOP/s, bytes/s) of the named card, None where it is not in the
    table."""
    p = PEAKS.get(kind)
    return None if p is None else (p["bf16_flops_per_s"],
                                   p["hbm_bytes_per_s"])


class Bound:
    """Summed roofline seconds of a set of launches on one card."""

    def __init__(self, peak):
        self.flops_s, self.bytes_s = peak
        self.seconds = 0.0
        self.flops = 0.0
        self.bytes = 0.0

    def add(self, flops: float, nbytes: float, times: float = 1.0):
        self.flops += flops * times
        self.bytes += nbytes * times
        self.seconds += max(flops / self.flops_s,
                            nbytes / self.bytes_s) * times


def linear(bound: Bound, m, k, n, bias=False, out_bytes=2, times=1.0):
    """One ``unified_linear`` launch: (m, k) bf16 by (k, n) bf16."""
    if m <= 0:
        return
    bound.add(2.0 * m * k * n,
              m * k * 2 + k * n * 2 + (4 * n if bias else 0)
              + m * n * out_bytes, times)


# ------------------------------------------------------------------ M³ViT


def vit_tokens(cfg: dict) -> int:
    return (cfg["image_h"] // cfg["patch"]) * (cfg["image_w"] // cfg["patch"])


def vit_head_width(cfg: dict, task: int) -> int:
    p2 = cfg["patch"] ** 2
    return p2 * cfg["num_seg_classes"] if cfg["tasks"][task] == "semseg" \
        else p2


def vit_frame_flops(cfg: dict, task: int) -> float:
    """Model FLOPs of one frame and one task: the products of the patch
    embedding, attention, the dense MLPs, the gate, the top-k expert rows
    and the head."""
    t, d, f = vit_tokens(cfg), cfg["d_model"], cfg["d_ff"]
    k, fe, e = cfg["top_k"], cfg["expert_d_ff"], cfg["num_experts"]
    fl = 2.0 * t * cfg["patch"] ** 2 * 3 * d
    for layer in range(cfg["num_layers"]):
        kind = cfg["block_pattern"][layer % len(cfg["block_pattern"])]
        fl += 2.0 * t * d * 4 * d + 4.0 * t * t * d
        fl += (2.0 * t * d * e + 4.0 * t * k * d * fe) if kind == "attn_moe" \
            else 4.0 * t * d * f
    return fl + 2.0 * t * d * vit_head_width(cfg, task)


def vit_batch_kernels(cfg: dict, batch: int, task: int, bounds: dict,
                      peak) -> None:
    """Add one ``infer`` call at ``batch`` frames to the bounds of
    ``unified_linear`` and ``moe_ffn`` (the routed expert FFN)."""
    ul = bounds.setdefault("unified_linear", Bound(peak))
    mf = bounds.setdefault("moe_ffn", Bound(peak))
    m = batch * vit_tokens(cfg)
    d, f, fe = cfg["d_model"], cfg["d_ff"], cfg["expert_d_ff"]
    e, k = cfg["num_experts"], cfg["top_k"]
    linear(ul, m, cfg["patch"] ** 2 * 3, d, bias=True)
    for layer in range(cfg["num_layers"]):
        kind = cfg["block_pattern"][layer % len(cfg["block_pattern"])]
        linear(ul, m, d, d, times=4)
        if kind == "attn_moe":
            rows = m * k
            mf.add(4.0 * rows * d * fe,
                   m * d * 2 + e * 2 * d * fe * 2 + e * (fe + d) * 4
                   + rows * 8 + m * d * 2)
        else:
            linear(ul, m, d, f, bias=True)
            linear(ul, m, f, d, bias=True)
    linear(ul, m, d, vit_head_width(cfg, task), bias=True, out_bytes=4)


# --------------------------------------------------------------- decoders


def lm_dims(cfg: dict):
    d, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    return (d, hq, cfg["num_key_value_heads"], d // hq,
            cfg["intermediate_size"], cfg["vocab_size"],
            cfg["num_hidden_layers"])


def lm_linear_params(cfg: dict) -> int:
    """Weights of one layer's products."""
    d, hq, hkv, hd, f, _, _ = lm_dims(cfg)
    return d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * f


def lm_prefill_flops(cfg: dict, s0: int) -> float:
    """Model FLOPs of a prompt of ``s0`` real tokens and its first token's
    logits (causal attention counts each query's own prefix)."""
    d, hq, _, hd, _, v, n = lm_dims(cfg)
    per_layer = 2.0 * s0 * lm_linear_params(cfg) \
        + 4.0 * hq * hd * s0 * (s0 + 1) / 2
    return n * per_layer + 2.0 * d * v


def lm_decode_flops(cfg: dict, lengths) -> float:
    """Model FLOPs of one decode step of the live lanes, each attending
    over its ``length`` cached positions (the new one included)."""
    d, hq, _, hd, _, v, n = lm_dims(cfg)
    lanes = len(lengths)
    return n * (2.0 * lanes * lm_linear_params(cfg)
                + 4.0 * hq * hd * sum(lengths)) + 2.0 * lanes * d * v


def _lm_linears(cfg, ul: Bound, m: int, head_rows: int):
    d, hq, hkv, hd, f, v, n = lm_dims(cfg)
    for _ in range(n):
        linear(ul, m, d, hq * hd)
        linear(ul, m, d, hkv * hd, times=2)
        linear(ul, m, hq * hd, d)
        linear(ul, m, d, f, times=2)
        linear(ul, m, f, d)
    linear(ul, head_rows, d, v, out_bytes=4)


def lm_prefill_kernels(cfg: dict, s0: int, bounds: dict, peak) -> None:
    """One batch-1 admission of ``s0`` real tokens: ``unified_linear``
    (the head on the last real row)."""
    _lm_linears(cfg, bounds.setdefault("unified_linear", Bound(peak)), s0, 1)


def lm_decode_kernels(cfg: dict, lengths, bounds: dict, peak) -> None:
    """One decode step of the live lanes: ``unified_linear`` and
    ``decode_attention`` (each lane's K and V rows read once a layer)."""
    _, hq, hkv, hd, _, _, n = lm_dims(cfg)
    lanes = len(lengths)
    _lm_linears(cfg, bounds.setdefault("unified_linear", Bound(peak)),
                lanes, lanes)
    da = bounds.setdefault("decode_attention", Bound(peak))
    da.add(4.0 * hq * hd * sum(lengths),
           sum(lengths) * hkv * hd * 2 * 2 + lanes * hq * hd * 2 * 2, n)
