"""M³ViT — the paper's own model, as in ``repro.configs.m3vit``.

12 blocks, hidden 192, MLP 768, 3 heads.  Even blocks are dense ViT blocks,
odd blocks are MoE blocks (16 experts, top-4, per-task gating; 2 tasks:
semantic segmentation + depth on Cityscapes 128×256, patch 16 → 128 tokens).
Encoder-only (non-causal), GELU, LayerNorm.
"""

from repro_torch.configs.base import ArchConfig, MoESpec, reduced

CONFIG = ArchConfig(
    name="m3vit",
    family="vit-moe",
    num_layers=12,
    d_model=192,
    num_heads=3,
    num_kv_heads=3,
    d_ff=768,
    vocab_size=0,                      # dense prediction heads, no LM head
    block_pattern=("attn_mlp", "attn_moe"),
    mlp_kind="gelu",
    norm="layernorm",
    rope="none",
    embed_input="embeddings",          # patch embedding handled in models/vit.py
    moe=MoESpec(num_experts=16, top_k=4, d_ff=768, num_tasks=2,
                capacity_factor=2.0, impl="grouped", group_size=128),
    num_tasks=2,
)

SMOKE_CONFIG = reduced(CONFIG, vocab_size=0)  # trunk has task heads, no LM head

# Cityscapes-as-in-paper geometry
IMAGE_H, IMAGE_W, PATCH = 128, 256, 16
NUM_PATCHES = (IMAGE_H // PATCH) * (IMAGE_W // PATCH)  # 128 tokens
NUM_SEG_CLASSES = 19
TASKS = ("semseg", "depth")
