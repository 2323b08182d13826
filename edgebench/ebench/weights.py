"""Seeded weights in the port's parameter names, drawn on the device.

Each family lists its leaves (name, shape, dtype, kind) from the
configuration file's sizes; :func:`draw` fills one flat buffer per dtype
with N(0, 1) from a ``torch.Generator`` seeded with ``--seed`` on the
device (float32 draws of 2**28 values cast into it, a few dozen calls in
all), views it leaf by leaf and scales
each view by its kind: matrices by 1/sqrt(fan-in), norm scales to
1 + 0.1·N, biases and positions to 0.02·N.  The same seed gives the same
weights; the program and the plain reference are handed this one dict.
"""

from __future__ import annotations

import math

import torch

BF16, F32 = torch.bfloat16, torch.float32
CHUNK = 1 << 28


def vit_moe(cfg: dict) -> list[tuple]:
    d, f, p = cfg["d_model"], cfg["d_ff"], cfg["patch"]
    e, fe, tasks = cfg["num_experts"], cfg["expert_d_ff"], cfg["num_tasks"]
    n = cfg["num_layers"] // len(cfg["block_pattern"])
    tokens = (cfg["image_h"] // p) * (cfg["image_w"] // p)
    out = [("patch.w", (p * p * 3, d), BF16, "matrix"),
           ("patch.b", (d,), F32, "bias"),
           ("patch.pos", (tokens, d), BF16, "bias"),
           ("final_norm.scale", (d,), F32, "scale"),
           ("final_norm.bias", (d,), F32, "bias"),
           ("heads.semseg.w", (d, p * p * cfg["num_seg_classes"]), BF16,
            "matrix"),
           ("heads.semseg.b", (p * p * cfg["num_seg_classes"],), F32, "bias"),
           ("heads.depth.w", (d, p * p), BF16, "matrix"),
           ("heads.depth.b", (p * p,), F32, "bias")]
    for i, kind in enumerate(cfg["block_pattern"]):
        b = f"layers.b{i}."
        for ln in ("ln1", "ln2"):
            out += [(b + ln + ".scale", (n, d), F32, "scale"),
                    (b + ln + ".bias", (n, d), F32, "bias")]
        out += [(b + f"attn.{w}", (n, d, d), BF16, "matrix")
                for w in ("wq", "wk", "wv", "wo")]
        if kind == "attn_moe":
            out += [(b + "moe.gate", (n, tasks, d, e), F32, "matrix"),
                    (b + "moe.w1", (n, e, d, fe), BF16, "matrix"),
                    (b + "moe.b1", (n, e, fe), F32, "bias"),
                    (b + "moe.w2", (n, e, fe, d), BF16, "matrix"),
                    (b + "moe.b2", (n, e, d), F32, "bias")]
        else:
            out += [(b + "mlp.w1", (n, d, f), BF16, "matrix"),
                    (b + "mlp.b1", (n, f), F32, "bias"),
                    (b + "mlp.w2", (n, f, d), BF16, "matrix"),
                    (b + "mlp.b2", (n, d), F32, "bias")]
    return out


def dense_lm(cfg: dict) -> list[tuple]:
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, n = d // hq, cfg["num_hidden_layers"]
    b = "layers.b0."
    return [("embed.tokens", (v, d), BF16, "embed"),
            ("final_norm.scale", (d,), F32, "scale"),
            ("head.w", (d, v), BF16, "matrix"),
            (b + "ln1.scale", (n, d), F32, "scale"),
            (b + "attn.wq", (n, d, hq * hd), BF16, "matrix"),
            (b + "attn.wk", (n, d, hkv * hd), BF16, "matrix"),
            (b + "attn.wv", (n, d, hkv * hd), BF16, "matrix"),
            (b + "attn.wo", (n, hq * hd, d), BF16, "matrix"),
            (b + "ln2.scale", (n, d), F32, "scale"),
            (b + "mlp.wg", (n, d, f), BF16, "matrix"),
            (b + "mlp.wu", (n, d, f), BF16, "matrix"),
            (b + "mlp.wd", (n, f, d), BF16, "matrix")]


FAMILIES = {"vit_moe": vit_moe, "dense_lm": dense_lm}


def specs(cfg: dict) -> list[tuple]:
    return FAMILIES[cfg["family"]](cfg)


def draw(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The configuration's weights from ``seed`` on ``device``."""
    leaves = specs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    out = {}
    for dtype in (BF16, F32):
        mine = [s for s in leaves if s[2] == dtype]
        total = sum(math.prod(s[1]) for s in mine)
        flat = torch.empty(total, dtype=dtype, device=device)
        for i in range(0, total, CHUNK):
            n = min(CHUNK, total - i)
            flat[i:i + n].copy_(torch.randn(n, generator=gen,
                                            device=device))
        off = 0
        for name, shape, _, kind in mine:
            t = flat[off:off + math.prod(shape)].view(shape)
            off += t.numel()
            if kind == "matrix":
                t.mul_(1.0 / math.sqrt(shape[-2]))
            elif kind == "scale":
                t.mul_(0.1).add_(1.0)
            elif kind == "bias":
                t.mul_(0.02)
            out[name] = t
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out
