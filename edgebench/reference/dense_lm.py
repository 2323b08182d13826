"""Plain float32 decoder of the Llama architecture (DeepSeek-LLM,
arXiv:2401.02954; deepseek-ai/deepseek-llm-67b-base ``config.json``): the
yardstick the LM cells' served tokens are held to.

Token embedding → layers (RMSNorm; grouped-query causal attention with
rotary positions on the two halves of each head, base ``rope_theta``;
RMSNorm; SwiGLU MLP) → final RMSNorm → the untied head.  One full forward
over a prompt and its served tokens gives the logits at every position
that served one.

Plain ``torch`` only, in float32 with TF32 off, one layer's weights
widened at a time and attention a few heads at a time, so it fits beside
the bf16 weights; it reads the weights by the port's names and the sizes
from the configuration file, and imports nothing of the program.
``mode="fp8"`` is the control: every matrix product's operands rounded
to float8 e4m3 (a scale per row of the left operand and per column of
the right).
"""

from __future__ import annotations

import contextlib
import math

import torch

HEADS_AT_ONCE = 8


@contextlib.contextmanager
def exact_float32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def mm(a, b, mode):
    if mode == "fp8":
        a, b = fp8(a, -1), fp8(b, -2)
    return torch.matmul(a, b)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, cos, sin):
    """x (L, H, hd): the first and second halves rotated by the angles."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def logits_at(params, cfg: dict, tokens: torch.Tensor, rows,
              mode: str = "fp32") -> torch.Tensor:
    """float32 logits (len(rows), vocab) at positions ``rows`` of one
    sequence ``tokens`` (L,)."""
    with torch.no_grad(), exact_float32():
        return _logits_at(params, cfg, tokens, rows, mode)


def _logits_at(params, cfg, tokens, rows, mode):
    d = cfg["hidden_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps = d // hq, cfg["rms_norm_eps"]
    n = tokens.shape[0]
    dev = tokens.device
    x = params["embed.tokens"][tokens].float()
    pos = torch.arange(n, device=dev, dtype=torch.float32)
    freqs = 1.0 / (cfg["rope_theta"] ** (
        torch.arange(0, hd, 2, device=dev, dtype=torch.float32) / hd))
    ang = pos[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    future = torch.ones(n, n, dtype=torch.bool, device=dev).triu(1)
    b = "layers.b0."
    for layer in range(cfg["num_hidden_layers"]):
        def w(name):
            return params[b + name][layer].float()

        h = rmsnorm(x, w("ln1.scale"), eps)
        q = rope(mm(h, w("attn.wq"), mode).view(n, hq, hd), cos, sin)
        k = rope(mm(h, w("attn.wk"), mode).view(n, hkv, hd), cos, sin)
        v = mm(h, w("attn.wv"), mode).view(n, hkv, hd)
        o = torch.empty(n, hq, hd, device=dev)
        group = hq // hkv
        for h0 in range(0, hq, HEADS_AT_ONCE):
            hs = range(h0, min(h0 + HEADS_AT_ONCE, hq))
            qh = q[:, h0:hs.stop].transpose(0, 1)             # (c, L, hd)
            kv = [i // group for i in hs]
            kh = k[:, kv].transpose(0, 1)
            vh = v[:, kv].transpose(0, 1)
            s = mm(qh, kh.transpose(-1, -2), mode) / math.sqrt(hd)
            s = s.masked_fill(future, float("-inf"))
            o[:, h0:hs.stop] = mm(torch.softmax(s, -1), vh,
                                  mode).transpose(0, 1)
        x = x + mm(o.reshape(n, hq * hd), w("attn.wo"), mode)
        h = rmsnorm(x, w("ln2.scale"), eps)
        g = mm(h, w("mlp.wg"), mode)
        x = x + mm(g * torch.sigmoid(g) * mm(h, w("mlp.wu"), mode),
                   w("mlp.wd"), mode)
    x = rmsnorm(x[torch.as_tensor(rows, device=dev)],
                params["final_norm.scale"].float(), eps)
    return mm(x, params["head.w"].float(), mode)
