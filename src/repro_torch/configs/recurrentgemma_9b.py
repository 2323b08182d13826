"""RecurrentGemma-9B — RG-LRU recurrent blocks + local attention, 2:1, as in
``repro.configs.recurrentgemma_9b``.

arXiv:2402.19427 (Griffin): 38 layers, d_model 4096, 16 heads of 256 over
one kv head (MQA), GeGLU d_ff 12288, vocab 256000; the pattern (recurrent,
recurrent, local attention) cycled, local attention over a 2048-token
window; RMSNorm; an untied head.  No weights ship with the port: the model
is initialized from a seed.
"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="recurrentgemma_9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru_mlp", "rglru_mlp", "attn_local_mlp"),
    mlp_kind="geglu",
    norm="rmsnorm",
    rope="rope",
    window=2048,
    lru_width=4096,
    sub_quadratic=True,
)

SMOKE_CONFIG = reduced(CONFIG, num_layers=6)
