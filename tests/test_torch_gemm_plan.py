"""The tile planner of the port's two GEMM kernels
(``repro_torch.kernels.gemm_plan``): which variant each shape takes, how K
is split, and how many blocks a launch gives the card.  Plain Python, so
every decision the wrappers make on the card is checked here on the CPU.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import gemm_plan as gp
from repro_torch.kernels import launch_counts, variant_counts
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
    assert launch_counts() == before_l and variant_counts() == before_v
    assert set(variant_counts()) == {"unified_linear", "moe_gemm",
                                     "flash_attention"}
