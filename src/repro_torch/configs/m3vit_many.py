"""M³ViT-many — a many-expert multi-tenant stress variant of ``m3vit``.

Same trunk as the paper's M³ViT (12 blocks, hidden 192, MLP 768, 3 heads,
alternating dense/MoE blocks) but the MoE blocks carry **256 experts** over
**8 tasks** — the multi-tenant edge scenario the factored-expert subsystem
(``repro_torch.factor``) targets: per-task routing touches a small, largely
disjoint slice of a huge expert pool, so dense residency is hopeless (256
experts would need 16× M³ViT's expert bytes) while a shared basis + tiny
per-expert deltas keeps the whole pool a few waves away at a fraction of
the budget.  Not in ``ARCH_NAMES`` (it is a serving/benchmark config, not
an assigned-pool arch) — reach it via ``configs.get("m3vit_many")``.
"""

from dataclasses import replace

from repro_torch.configs.m3vit import CONFIG as _M3VIT
from repro_torch.configs.base import reduced

NUM_EXPERTS = 256
NUM_TASKS = 8

CONFIG = replace(
    _M3VIT,
    name="m3vit_many",
    moe=replace(_M3VIT.moe, num_experts=NUM_EXPERTS, top_k=4,
                num_tasks=NUM_TASKS),
    num_tasks=NUM_TASKS,
)

# reduced() caps num_experts at 8 — the many-expert pool IS the point here,
# so the smoke config re-asserts it (smaller d_model/d_ff keep it fast; the
# 256-expert pool stays, it is what the factor benchmarks exercise)
SMOKE_CONFIG = replace(
    reduced(CONFIG, vocab_size=0),
    moe=replace(reduced(CONFIG).moe, num_experts=NUM_EXPERTS,
                d_ff=256, group_size=256),
    num_tasks=NUM_TASKS,
)

TASKS = tuple(f"tenant{i}" for i in range(NUM_TASKS))
