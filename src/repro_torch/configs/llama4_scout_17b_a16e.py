"""Llama-4-Scout-17B-16E — MoE decoder, 16 experts top-1 + 1 shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  48L d_model=5120 40H
(GQA kv=8) d_ff=8192 (per expert) vocab=202048.  Every layer is MoE
(Scout interleave step 1).  top-1 routing + one always-on shared expert
(~17B active of ~109B total).  This arch exercises the paper's
expert-by-expert reordering (technique #5) at LM scale.
"""

from repro_torch.configs.base import ArchConfig, MoESpec, reduced

CONFIG = ArchConfig(
    name="llama4_scout_17b_a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("attn_moe",),
    mlp_kind="swiglu",
    norm="rmsnorm",
    rope="rope",
    rope_theta=500000.0,
    moe=MoESpec(num_experts=16, top_k=1, d_ff=8192, num_shared_experts=1,
                renormalize=False),
    sub_quadratic=False,
)

SMOKE_CONFIG = reduced(CONFIG)
