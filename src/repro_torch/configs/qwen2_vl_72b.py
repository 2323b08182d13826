"""Qwen2-VL-72B — VLM backbone with M-RoPE.

[arXiv:2409.12191; hf]  80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064.  The vision frontend (dynamic-resolution patch encoder) is a
STUB — the model takes precomputed patch/text embeddings (B, S, d).
M-RoPE (multimodal RoPE: head_dim split into temporal/height/width sections)
is implemented in the backbone; with the stub the three position streams are
text-style equal, but the rotation math follows the sectioned layout.
"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="qwen2_vl_72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    mlp_kind="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope="mrope",
    rope_theta=1000000.0,
    embed_input="embeddings",
    sub_quadratic=False,
)

SMOKE_CONFIG = reduced(CONFIG)
