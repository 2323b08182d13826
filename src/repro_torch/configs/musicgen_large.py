"""MusicGen-Large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]  48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192
vocab=2048.  Audio modality: the EnCodec frontend is a STUB — the model takes
precomputed frame embeddings (B, S, d); the LM head predicts codebook
tokens (vocab 2048).  MusicGen uses LayerNorm + GELU MLP + sinusoidal
positions (no RoPE), so this arch exercises the paper's LUT-GELU directly.
"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="musicgen_large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp_kind="gelu",
    norm="layernorm",
    rope="sincos",
    embed_input="embeddings",
    sub_quadratic=False,
)

SMOKE_CONFIG = reduced(CONFIG)
