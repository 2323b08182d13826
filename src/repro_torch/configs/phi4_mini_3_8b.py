"""Phi-4-mini (3.8B) — dense decoder, RoPE + SwiGLU + GQA.

[arXiv:2412.08905; hf]  32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064.
"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="phi4_mini_3_8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    mlp_kind="swiglu",
    norm="rmsnorm",
    rope="rope",
    sub_quadratic=False,
)

SMOKE_CONFIG = reduced(CONFIG)
