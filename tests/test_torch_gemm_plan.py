"""The tile planner of the port's two GEMM kernels and of the fused MoE
layer (``repro_torch.kernels.gemm_plan``): which variant each shape takes,
how K is split, how many blocks a launch gives the card, and which queue
rows each ``moe_fused`` tile reads.  Plain Python, so every decision the
wrappers make on the card is checked here on the CPU.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import gemm_plan as gp
from repro_torch.kernels import launch_counts, variant_counts
from repro_torch.kernels import moe_fused as kmf
from repro_torch.kernels import moe_gemm as kmg
from repro_torch.kernels import unified_linear as kul

SMS = 132          # H100 SXM
BF16, F32 = torch.bfloat16, torch.float32

# (M, K, N) of every unified_linear launch on the two main paths:
# M3ViT at B = 8 (1024 tokens) and Llama-3.2-1B at decode (M = 8) and
# prefill (8 x 128 tokens)
M3VIT = {"patch_embed": (1024, 768, 192), "qkvo": (1024, 192, 192),
         "mlp_up": (1024, 192, 768), "mlp_down": (1024, 768, 192),
         "semseg_head": (1024, 192, 4864), "depth_head": (1024, 192, 256)}
LM = {"q_o": (2048, 2048), "k_v": (2048, 512), "gate_up": (2048, 8192),
      "down": (8192, 2048)}
MAIN_LINEAR = dict(M3VIT)
for _m, _phase in ((8, "decode"), (1024, "prefill")):
    MAIN_LINEAR.update({f"lm_{_phase}_{name}": (_m, k, n)
                        for name, (k, n) in LM.items()})
# (queues, C, D, F): moe_gemm at G = 8 routing groups x 16 experts
MAIN_MOE = {"w1": (128, 68, 192, 768), "w2": (128, 68, 768, 192)}


def _covers(plan, m, n):
    assert plan.grid[0] * gp.WG_ROWS * plan.nwg >= n
    assert plan.grid[1] * plan.bt >= m


def _fits(plan):
    assert plan.bt in gp.TOKEN_TILES and plan.nwg in (1, 2)
    assert 1 <= plan.stages <= gp.MAX_STAGES
    ring = plan.stages * gp._stage_bytes(plan.bt, plan.nwg)
    assert ring <= gp.SMEM_BUDGET < 227 * 1024


@pytest.mark.parametrize("case", list(MAIN_LINEAR))
def test_main_path_linear_takes_the_tensor_cores(case):
    m, k, n = MAIN_LINEAR[case]
    plan = gp.plan_linear(m, n, k, BF16, SMS)
    assert plan.variant in ("tc", "tc_splitk"), plan.reason
    _covers(plan, m, n)
    _fits(plan)
    assert plan.grid[2] == plan.splits
    assert (plan.variant == "tc_splitk") == (plan.splits > 1)


@pytest.mark.parametrize("case", list(MAIN_MOE))
def test_main_path_moe_takes_the_tensor_cores(case):
    queues, c, d, f = MAIN_MOE[case]
    plan = gp.plan_moe(queues, c, d, f, BF16)
    assert plan.variant == "tc", plan.reason
    # one tile of n = 72 covers the 68 queue slots
    assert plan.bt == 72 and plan.grid[1] == 1 and plan.grid[2] == queues
    _covers(plan, c, f)
    _fits(plan)


@pytest.mark.parametrize("case", list(M3VIT))
def test_m3vit_grids_cover_the_sms(case):
    """At the M3ViT widths (N = 192..4864, M = 1024) every launch gives the
    card at least one block per SM, from smaller tiles rather than split K
    (the float32 partials' round trip lost on the chip at every one)."""
    m, k, n = M3VIT[case]
    plan = gp.plan_linear(m, n, k, BF16, SMS)
    assert plan.blocks >= SMS and plan.splits == 1


# every linear shape (K, N) of the two models: M³ViT's (qkv, o, the MLP,
# the patch embed and the two heads) and Llama-3.2-1B's projections
MODEL_KN = {"m3vit_patch_embed": (768, 192), "m3vit_qkv": (192, 576),
            "m3vit_o": (192, 192), "m3vit_mlp_up": (192, 768),
            "m3vit_mlp_down": (768, 192), "m3vit_semseg_head": (192, 4864),
            "m3vit_depth_head": (192, 256),
            **{f"lm_{name}": kn for name, kn in LM.items()}}


@pytest.mark.parametrize("case", list(MODEL_KN))
def test_large_m_plans_never_split_k(case):
    """At M = 128·b, b = 1..16 (one to sixteen M³ViT frames, or LM prefill
    rows), K is never split and the ring depth's promotion group
    ``min(stages, 4)`` (``csrc/gemm_sm90.cuh``) is the same at every b: a
    row's sum runs over K in the same order whatever the batch."""
    k, n = MODEL_KN[case]
    plans = [gp.plan_linear(128 * b, n, k, BF16, SMS) for b in range(1, 17)]
    assert all(p.splits == 1 and p.variant == "tc" for p in plans), \
        [p.reason for p in plans]
    assert len({min(p.stages, 4) for p in plans}) == 1


# (bt, nwg, splits, stages) at M = 1, 8, 16, 72 and 1024, as the planner
# chose them before K splits at M > 72 were dropped: decode and the
# batch-8 / prefill plans do not change
KEPT_PLANS = {
    "m3vit_patch_embed": [(8, 1, 12, 1), (8, 1, 12, 1), (16, 1, 12, 1),
                          (72, 1, 12, 1), (16, 1, 1, 6)],
    "m3vit_qkv": [(8, 1, 3, 1), (8, 1, 3, 1), (16, 1, 3, 1), (72, 1, 3, 1),
                  (32, 1, 1, 3)],
    "m3vit_o": [(8, 1, 3, 1), (8, 1, 3, 1), (16, 1, 3, 1), (72, 1, 3, 1),
                (16, 1, 1, 3)],
    "m3vit_mlp_up": [(8, 1, 3, 1), (8, 1, 3, 1), (16, 1, 3, 1),
                     (72, 1, 3, 1), (32, 1, 1, 3)],
    "m3vit_mlp_down": [(8, 1, 12, 1), (8, 1, 12, 1), (16, 1, 12, 1),
                       (72, 1, 12, 1), (16, 1, 1, 6)],
    "m3vit_semseg_head": [(8, 1, 2, 2), (8, 1, 2, 2), (16, 1, 2, 2),
                          (72, 1, 2, 2), (128, 2, 1, 3)],
    "m3vit_depth_head": [(8, 1, 3, 1), (8, 1, 3, 1), (16, 1, 3, 1),
                         (72, 1, 3, 1), (16, 1, 1, 3)],
    "lm_q_o": [(8, 1, 8, 4), (8, 1, 8, 4), (16, 1, 8, 4), (72, 1, 8, 4),
               (128, 2, 1, 6)],
    "lm_k_v": [(8, 1, 17, 2), (8, 1, 17, 2), (16, 1, 17, 2), (72, 1, 17, 2),
               (64, 1, 1, 6)],
    "lm_gate_up": [(8, 1, 3, 6), (8, 1, 3, 6), (16, 1, 3, 6), (72, 1, 3, 6),
                   (128, 2, 1, 6)],
    "lm_down": [(8, 1, 9, 6), (8, 1, 9, 6), (16, 1, 9, 6), (72, 1, 9, 6),
                (128, 2, 1, 6)],
}


def test_small_m_and_batch_8_plans_are_unchanged():
    for case, want in KEPT_PLANS.items():
        k, n = MODEL_KN[case]
        for m, (bt, nwg, splits, stages) in zip((1, 8, 16, 72, 1024), want):
            plan = gp.plan_linear(m, n, k, BF16, SMS)
            assert (plan.bt, plan.nwg, plan.splits, plan.stages) \
                == (bt, nwg, splits, stages), (case, m, plan)
            assert plan.grid == (-(-n // (64 * nwg)), -(-m // bt), splits)


@pytest.mark.parametrize("case", [c for c in MAIN_LINEAR
                                  if c.startswith("lm_prefill")])
def test_prefill_grids_fill_a_wave(case):
    """The Llama-3.2-1B prefill GEMMs (M = 1024): 128 x 128 tiles over two
    warpgroups wherever they make 7/8 of a wave, never a split."""
    m, k, n = MAIN_LINEAR[case]
    plan = gp.plan_linear(m, n, k, BF16, SMS)
    assert plan.splits == 1 and plan.blocks >= SMS * 7 / 8
    if n * m // (128 * 128) >= SMS * 7 / 8:
        assert (plan.nwg, plan.bt) == (2, 128)


@pytest.mark.parametrize("case", [c for c in MAIN_LINEAR
                                  if MAIN_LINEAR[c][0] == 8])
@pytest.mark.parametrize("sms", [SMS, 114])
def test_decode_streams_weights_on_every_sm(case, sms):
    """M = 8: one 8-token tile, the wgmma n side, and K split so that at
    least one block per SM (about two) streams weights."""
    m, k, n = MAIN_LINEAR[case]
    plan = gp.plan_linear(m, n, k, BF16, sms)
    assert plan.variant == "tc_splitk"
    assert plan.bt == 8 and plan.grid[1] == 1
    assert plan.blocks >= sms
    kt = -(-k // gp.TILE_K)
    assert plan.splits <= kt       # every split owns at least one k-tile


# (K, splits), splits never finer than one k-tile, as the planner keeps them
K_SPLITS = [(k, s) for k in (16, 64, 200, 2048, 2056, 8192, 8200)
            for s in (1, 2, 3, 9, 32) if s <= -(-k // gp.TILE_K)]


@pytest.mark.parametrize("k, splits", K_SPLITS)
def test_k_splits_cover_k_once_in_order(k, splits):
    ranges = gp.k_ranges(k, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0                 # contiguous, ascending
    for a, b in ranges:
        assert a < b                    # none empty
        assert a % gp.WGMMA_K == 0 and a % gp.TILE_K == 0
    covered = np.zeros(k, int)
    for a, b in ranges:
        covered[a:b] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("m", [1, 8, 16, 17, 33, 64, 65, 72])
def test_small_m_token_tile_is_the_least_that_holds_m(m):
    plan = gp.plan_linear(m, 2048, 2048, BF16, SMS)
    assert plan.bt == min(t for t in gp.TOKEN_TILES if t >= m)
    assert plan.grid[1] == 1


@pytest.mark.parametrize("m, k, n", [(77, 33, 129), (8, 2048, 2047),
                                     (8, 2047, 2048), (70, 33, 200)])
def test_unaligned_bf16_rows_take_the_simt_route(m, k, n):
    plan = gp.plan_linear(m, n, k, BF16, SMS)
    assert plan.variant == "simt" and "16 bytes" in plan.reason


def test_unaligned_base_takes_the_simt_route():
    assert gp.plan_linear(8, 2048, 2048, BF16, SMS,
                          aligned=False).variant == "simt"
    assert gp.plan_moe(16, 68, 192, 768, BF16, aligned=False).variant \
        == "simt"


@pytest.mark.parametrize("shape", list(MAIN_LINEAR.values())
                         + [(1000, 190, 770), (77, 33, 129)],
                         ids=list(MAIN_LINEAR) + ["ragged", "ragged_small"])
def test_every_float32_linear_takes_the_simt_route(shape):
    m, k, n = shape
    plan = gp.plan_linear(m, n, k, F32, SMS)
    assert plan.variant == "simt" and "TF32" in plan.reason


@pytest.mark.parametrize("shape", list(MAIN_MOE.values())
                         + [(15, 13, 37, 29), (15, 13, 40, 72)],
                         ids=list(MAIN_MOE) + ["ragged", "ragged_aligned"])
def test_every_float32_moe_takes_the_simt_route(shape):
    assert gp.plan_moe(*shape, F32).variant == "simt"


def test_ragged_aligned_moe_takes_the_tensor_cores():
    """C = 13 rides one 16-row tile; D = 40 and F = 72 leave partial
    k- and F-tiles that the tensor map zero-fills."""
    plan = gp.plan_moe(15, 13, 40, 72, BF16)
    assert plan.variant == "tc" and plan.bt == 16 and plan.nwg == 1
    assert plan.grid == (2, 1, 15)
    assert gp.plan_moe(15, 13, 37, 29, BF16).variant == "simt"


def test_wide_queue_moe_tiles_the_queue():
    plan = gp.plan_moe(4, 300, 192, 256, BF16)
    assert plan.bt == 128 and plan.grid[1] == math.ceil(300 / 128)


def test_cpu_tensors_move_no_variant_counter(rng):
    before_l, before_v = launch_counts(), variant_counts()
    x = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
    kul.unified_linear(x.to(BF16), x.T.contiguous().to(BF16))
    kmg.moe_gemm(x[None].to(BF16), x.T.contiguous()[None].to(BF16),
                 torch.tensor([5], dtype=torch.int32))
    w = torch.from_numpy(rng.normal(size=(2, 64, 16)).astype(np.float32))
    expert = torch.tensor([[[0], [1], [0]]], dtype=torch.int32)
    kmf.fused_moe_ffn(x[None, :3].to(BF16),
                      {"wg": w.to(BF16), "wu": w.to(BF16),
                       "wd": w.transpose(1, 2).contiguous().to(BF16)},
                      expert, torch.ones((1, 3, 1)),
                      torch.tensor([[[0], [0], [1]]]),
                      torch.ones((1, 3, 1), dtype=torch.bool),
                      torch.tensor([[2, 1]], dtype=torch.int32),
                      kind="swiglu", capacity=2)
    assert launch_counts() == before_l and variant_counts() == before_v
    assert set(variant_counts()) == {"unified_linear", "moe_gemm",
                                     "flash_attention", "moe_fused"}


# ------------------------------------------------------------ moe_fused

# M3ViT's MoE layer at B = 8: 8 routing groups, 16 experts, capacity 68,
# d 192, f 768, the GELU half-table of 2048 entries (step 2^-8, range 8)
M3VIT_FUSED = (8, 16, 68, 192, 768)
GELU_TABLE = 2048


def test_m3vit_moe_fused_takes_the_tensor_cores():
    plan = gp.plan_moe_fused(*M3VIT_FUSED, BF16, "gelu", SMS, GELU_TABLE)
    assert plan.variant == "tc", plan.reason
    # 64-row tiles of the 8 x 68 capacity bound, one d-slice of 192, f
    # whole (144 blocks of the capacity bound for 132 SMs), the expert
    # slowest
    assert plan.grid == (math.ceil(8 * 68 / 64), 1, 16) and plan.ny == 3
    assert "F whole" in plan.reason
    assert plan.stages == gp.FUSED_MAX_STAGES
    assert plan.smem == gp.fused_smem_bytes(192, 3, "gelu", plan.stages,
                                            GELU_TABLE)
    assert plan.smem <= gp.FUSED_SMEM_LIMIT
    # exact activations need no table; the plan is the same
    exact = gp.plan_moe_fused(*M3VIT_FUSED, BF16, "gelu", SMS)
    assert exact.variant == "tc" and exact.grid == plan.grid


@pytest.mark.parametrize("d,f,aligned", [(192, 768, True), (36, 64, True),
                                         (192, 60, True), (192, 768, False)],
                         ids=["m3vit_float32", "d36", "f60", "base"])
def test_float32_and_unaligned_moe_fused_take_the_simt_route(d, f, aligned):
    """float32 (wgmma would take it only as TF32), and bf16 whose rows of d
    or f are not a multiple of 16 bytes or whose base is not 16-byte
    aligned (cp.async and TMA cannot address them)."""
    assert gp.plan_moe_fused(8, 16, 68, 192, 768, F32, "gelu", SMS,
                             GELU_TABLE).variant == "simt"
    if (d, f, aligned) != (192, 768, True):
        plan = gp.plan_moe_fused(8, 16, 68, d, f, BF16, "gelu", SMS,
                                 GELU_TABLE, aligned)
        assert plan.variant == "simt", plan.reason


@pytest.mark.parametrize("kind,d,variant,stages,slices", [
    ("gelu", 768, "tc", 1, 4), ("swiglu", 192, "tc", 2, 1),
    ("swiglu", 768, "simt", 0, 0), ("gelu", 256, "tc", 3, 2),
    ("gelu", 40, "tc", 4, 1)])
def test_moe_fused_shared_memory_sets_the_ring_and_the_route(
        kind, d, variant, stages, slices):
    """d = 768 leaves room for one ring stage beside the x tile; SwiGLU's
    two first-product matrices fit two stages at d = 192 and none at 768.
    d-slices of 192 columns where d's atoms allow, else 128 or 64."""
    plan = gp.plan_moe_fused(8, 16, 68, d, 768, BF16, kind, SMS, GELU_TABLE)
    assert plan.variant == variant, plan.reason
    if variant == "tc":
        assert plan.stages == stages
        n = plan.grid[1]
        assert n == slices and n * 64 * plan.ny >= d > (n - 1) * 64 * plan.ny
        assert plan.blocks == 9 * slices * 16
        assert plan.smem <= gp.FUSED_SMEM_LIMIT


@pytest.mark.parametrize("g,f", [(1, 768), (4, 768), (8, 768), (16, 768),
                                 (4, 192), (4, 256)])
def test_moe_fused_never_splits_f(g, f):
    """f whole in every block at every number of routing groups, even where
    the capacity-bound grid leaves SMs idle (M³ViT below batch 8): a row's
    sum over f runs in one block in the same order whatever the batch, so
    the grid's middle axis holds only d-slices and the plan's ring is the
    same at every g."""
    plan = gp.plan_moe_fused(g, 16, 68, 192, f, BF16, "gelu", SMS)
    assert plan.variant == "tc" and "F whole" in plan.reason
    assert plan.grid == (-(-g * 68 // gp.FUSED_ROWS), 1, 16)
    assert plan.stages == gp.plan_moe_fused(8, 16, 68, 192, f, BF16, "gelu",
                                            SMS).stages


def _skewed_sizes():
    g, e, c = 8, 16, 68
    rng = np.random.default_rng(3)
    one = np.zeros((g, e), int)
    one[:, 5] = c                       # every token's slot to one expert
    empty = rng.integers(0, c + 1, (g, e))
    empty[:, 0] = 0                     # one expert with no row anywhere
    return {"all_to_one_expert": one, "one_empty_expert": empty,
            "every_queue_at_capacity": np.full((g, e), c),
            "random_with_out_of_range": rng.integers(-3, c + 9, (g, e)),
            "single_group": rng.integers(0, c + 1, (1, e))}


@pytest.mark.parametrize("case", list(_skewed_sizes()))
def test_fused_tiles_cover_every_live_row_exactly_once(case):
    sizes = _skewed_sizes()[case]
    c = 68
    g_num, e_num = sizes.shape
    live = np.clip(sizes, 0, c)
    tiles = gp.fused_tile_rows(sizes.tolist(), c)
    grid_tiles = gp.plan_moe_fused(g_num, e_num, c, 192, 768, BF16, "gelu",
                                   SMS).grid[0]
    for e in range(e_num):
        total = int(live[:, e].sum())
        ran = sorted(t for (ee, t) in tiles if ee == e)
        # the tiles that run are the first ceil(total / 64) of the grid's;
        # the rest (all of them for an empty expert) return at once
        assert ran == list(range(-(-total // gp.FUSED_ROWS)))
        assert len(ran) <= grid_tiles
        rows = [row for t in ran for row in tiles[(e, t)]]
        got = [row for row in rows if row is not None]
        want = [(g, q) for g in range(g_num) for q in range(live[g, e])]
        assert got == want          # each live row once, groups in order
        # dead rows only at the end of the expert's last tile
        assert rows[len(got):] == [None] * (len(rows) - len(got))
        assert len(rows) - len(got) < gp.FUSED_ROWS
    if case == "all_to_one_expert":
        assert len([k for k in tiles if k[0] == 5]) == grid_tiles
        spans = {len({r[0] for r in rows if r}) for rows in tiles.values()}
        assert max(spans) == 2      # a tile reads rows of two groups
