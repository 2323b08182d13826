"""DeepSeek-67B — llama-architecture dense decoder.

[arXiv:2401.02954; hf]  95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400.  RoPE, SwiGLU, RMSNorm.
"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="deepseek_67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    mlp_kind="swiglu",
    norm="rmsnorm",
    rope="rope",
    sub_quadratic=False,
)

SMOKE_CONFIG = reduced(CONFIG)
