"""Plain float32 M³ViT (arXiv:2210.14793, as served by Edge-MoE,
arXiv:2305.18691): the yardstick the vision cells' answers are held to.

Patch embedding (row-major 16×16 patches, a linear map, learned
positions) → blocks (pre-norm LayerNorm; non-causal multi-head attention;
even blocks a GELU MLP, odd blocks a mixture of experts gated by the
task's own gate) → final LayerNorm → the task's linear head, unfolded to
pixels.  The MoE block routes each frame's tokens as one group: softmax of
the task's gate logits, top-k (ties to the lower index), the k weights
renormalised to sum to one, a capacity of
``max(4, ceil4(int(g·k·capacity_factor / E) + 1))`` rows per expert with
slots queued in (token, slot) order and the rest dropped; each expert is
exact-GELU MLP with biases.

Plain ``torch`` only, in float32 with TF32 off; it reads the weights by
the port's names and the sizes from the configuration file, and imports
nothing of the program.  ``mode="fp8"`` is the control: every matrix
product's operands rounded to float8 e4m3 (a scale per row of the left
operand and per column of the right), the rest as in float32.
"""

from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions, restored after."""
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
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its largest magnitude maps to 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "fp8":
        a, b = fp8(a, -1), fp8(b, -2)
    return torch.matmul(a, b)


def layernorm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def patchify(images, p):
    b, h, w, c = images.shape
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def attention(h, wq, wk, wv, wo, heads, mode):
    b, t, d = h.shape
    hd = wq.shape[1] // heads

    def split(y):
        return y.reshape(b, t, heads, hd).transpose(1, 2)

    q, k, v = split(mm(h, wq, mode)), split(mm(h, wk, mode)), \
        split(mm(h, wv, mode))
    p = torch.softmax(mm(q, k.transpose(-1, -2), mode) / math.sqrt(hd), -1)
    o = mm(p, v, mode).transpose(1, 2).reshape(b, t, heads * hd)
    return mm(o, wo, mode)


def moe(h, gate, w1, b1, w2, b2, cfg, mode):
    """The routed experts of one layer, one routing group a frame."""
    b, t, d = h.shape
    e, k = cfg["num_experts"], cfg["top_k"]
    g = cfg["group_size"]
    x = h.reshape(-1, g, d)
    probs = torch.softmax(mm(x, gate, mode), -1)            # (G, g, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weight = vals[..., :k] / vals[..., :k].sum(-1, keepdim=True)
    expert = idx[..., :k].reshape(x.shape[0], g * k)        # slot order
    cap = int(g * k * cfg["capacity_factor"] / e) + 1
    cap = max(4, -(-cap // 4) * 4)
    onehot = torch.nn.functional.one_hot(expert, e)
    before = (onehot.cumsum(1) - onehot).gather(-1, expert[..., None])[..., 0]
    keep = (before < cap).reshape(-1)
    slots = x.reshape(-1, 1, d).expand(-1, k, d).reshape(-1, d)
    flat_e = expert.reshape(-1)
    out = torch.zeros_like(slots)
    for i in range(e):
        rows = (flat_e == i) & keep
        if rows.any():
            y = gelu(mm(slots[rows], w1[i], mode) + b1[i])
            out[rows] = mm(y, w2[i], mode) + b2[i]
    w = (weight.reshape(-1) * keep)[:, None]
    return (out * w).reshape(b * t, k, d).sum(1).reshape(b, t, d)


def forward(params, cfg: dict, images: torch.Tensor, task: int,
            mode: str = "fp32") -> torch.Tensor:
    """images (B, H, W, 3) float32 -> the task's prediction in float32:
    semseg (B, H, W, classes) logits, depth (B, H, W)."""
    with torch.no_grad(), exact_float32():
        return _forward(params, cfg, images.float(), task, mode)


def _forward(params, cfg, images, task, mode):
    p, eps = cfg["patch"], cfg["norm_eps"]
    pattern = cfg["block_pattern"]

    def w(name, i=None):
        t = params[name] if i is None else params[name][i]
        return t.float()

    x = mm(patchify(images, p), w("patch.w"), mode) + w("patch.b") \
        + w("patch.pos")
    for layer in range(cfg["num_layers"]):
        j, kind = divmod(layer, len(pattern))
        kind = pattern[kind]
        pre = f"layers.b{layer % len(pattern)}."
        h = layernorm(x, w(pre + "ln1.scale", j), w(pre + "ln1.bias", j),
                      eps)
        x = x + attention(h, *(w(pre + f"attn.{n}", j)
                               for n in ("wq", "wk", "wv", "wo")),
                          cfg["num_heads"], mode)
        h = layernorm(x, w(pre + "ln2.scale", j), w(pre + "ln2.bias", j),
                      eps)
        if kind == "attn_moe":
            x = x + moe(h, w(pre + "moe.gate", j)[task],
                        *(w(pre + f"moe.{n}", j)
                          for n in ("w1", "b1", "w2", "b2")), cfg, mode)
        else:
            x = x + mm(gelu(mm(h, w(pre + "mlp.w1", j), mode)
                            + w(pre + "mlp.b1", j)),
                       w(pre + "mlp.w2", j), mode) + w(pre + "mlp.b2", j)
    x = layernorm(x, w("final_norm.scale"), w("final_norm.bias"), eps)
    name = cfg["tasks"][task]
    y = mm(x, w(f"heads.{name}.w"), mode) + w(f"heads.{name}.b")
    b = y.shape[0]
    nh, nw = cfg["image_h"] // p, cfg["image_w"] // p
    if name == "semseg":
        c = cfg["num_seg_classes"]
        y = y.reshape(b, nh, nw, p, p, c).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(b, cfg["image_h"], cfg["image_w"], c)
    y = y.reshape(b, nh, nw, p, p).permute(0, 1, 3, 2, 4)
    return y.reshape(b, cfg["image_h"], cfg["image_w"])
