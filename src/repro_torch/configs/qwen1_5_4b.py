"""Qwen1.5-4B — dense decoder with QKV bias.

[hf:Qwen/Qwen1.5-0.5B family; hf]  40L d_model=2560 20H (GQA kv=20 = MHA)
d_ff=6912 vocab=151936.  QKV bias (the Qwen signature), SwiGLU, RMSNorm, RoPE.
"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="qwen1_5_4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    mlp_kind="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope="rope",
    sub_quadratic=False,
)

SMOKE_CONFIG = reduced(CONFIG)
