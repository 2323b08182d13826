"""Llama-3.2-1B — small llama3 dense decoder, as in
``repro.configs.llama3_2_1b``.

Hugging Face card ``meta-llama/Llama-3.2-1B``: 16 layers, d_model 2048, 32
query heads of 64 (GQA, 8 kv heads), SwiGLU d_ff 8192, vocab 128256, RoPE
(theta 500k), RMSNorm, tied embeddings.  No weights ship with the port: the
model is initialized from a seed.
"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="llama3_2_1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    mlp_kind="swiglu",
    norm="rmsnorm",
    rope="rope",
    rope_theta=500000.0,
    tie_embeddings=True,
    sub_quadratic=False,
)

SMOKE_CONFIG = reduced(CONFIG)
