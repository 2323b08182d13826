"""Kimi-K2 — trillion-parameter MoE decoder (paper-table config), as in
``repro.configs.kimi_k2_1t_a32b``.

[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8) d_ff=2048
(per routed expert) vocab=163840; MoE 384 experts top-8 + 1 shared expert.
head_dim = 7168/64 = 112 as implied by the assigned dims (the public model
uses MLA; the assigned table says GQA kv=8, which we follow).

~1.04T total params, ~32B active/token.  The port serves only its
``SMOKE_CONFIG`` (on the CPU, with ``num_tasks=2``: the mixed-task
scheduler's per-slot gating and router-usage export); the full config is
never run on one card.
"""

from repro_torch.configs.base import ArchConfig, MoESpec, reduced

CONFIG = ArchConfig(
    name="kimi_k2_1t_a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    block_pattern=("attn_moe",),
    mlp_kind="swiglu",
    norm="rmsnorm",
    rope="rope",
    rope_theta=50000.0,
    # grouped (sort-based) dispatch: at E=384 the one-hot (T,E,C) dispatch
    # tensor is O(T²·k·cf)-per-group and infeasible; the grouped path is
    # also the paper-faithful expert-by-expert schedule (§IV-D).
    moe=MoESpec(num_experts=384, top_k=8, d_ff=2048, num_shared_experts=1,
                impl="grouped"),
    sub_quadratic=False,
)

SMOKE_CONFIG = reduced(CONFIG)
