"""The plans of the port's two attention kernels
(``repro_torch.kernels.attn_plan``): which ``flash_attention`` variant each
shape takes, which strided views its tensor maps read as they lie, and how
``decode_fused`` splits the cache.  Plain Python, so every decision the
wrappers make on the card is checked here on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import attn_plan as ap
from repro_torch.kernels import decode_fused as kdf
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import launch_counts, variant_counts

BF16, F32 = torch.bfloat16, torch.float32

# q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), causal: every flash_attention
# launch of the main paths — M3ViT at B = 8, the Llama-3.2-1B prefill of
# 8 x 128 tokens against the whole 512-slot cache
MAIN_ATTENTION = {
    "m3vit": ((8, 3, 128, 64), (8, 3, 128, 64), False),
    "lm_prefill": ((8, 32, 128, 64), (8, 8, 512, 64), True),
}


@pytest.mark.parametrize("case", list(MAIN_ATTENTION))
def test_main_path_attention_takes_the_tensor_cores(case):
    (b, hq, sq, d), (_, hkv, skv, _), _ = MAIN_ATTENTION[case]
    plan = ap.plan_attention(b, hq, sq, d, BF16)
    assert plan.variant == "tc", plan.reason
    assert plan.rows == ap.TC_ROWS and plan.atoms == 1
    assert plan.grid == (-(-sq // ap.TC_ROWS), b * hq)
    assert plan.grid[0] * plan.rows >= sq


@pytest.mark.parametrize("case", list(MAIN_ATTENTION))
def test_float32_attention_takes_the_simt_route(case):
    (b, hq, sq, d), _, _ = MAIN_ATTENTION[case]
    plan = ap.plan_attention(b, hq, sq, d, F32)
    assert plan.variant == "simt" and "TF32" in plan.reason
    assert plan.grid == (-(-sq // ap.SIMT_ROWS), b * hq)


@pytest.mark.parametrize("d, variant, atoms", [
    (16, "tc", 1), (48, "tc", 1), (64, "tc", 1), (80, "tc", 2),
    (128, "tc", 2), (40, "simt", 0), (8, "simt", 0), (72, "simt", 0),
    (127, "simt", 0)])
def test_head_dim_routes_the_variant(d, variant, atoms):
    plan = ap.plan_attention(2, 6, 77, d, BF16)
    assert plan.variant == variant and plan.atoms == atoms
    if variant == "tc":
        assert plan.atoms * 64 >= d


def test_decode_route_on_tc():
    """Sq = 1 over a live prefix (the ``attention_decode``/``cuda`` route):
    one 64-row tile, its first row real."""
    plan = ap.plan_attention(8, 32, 1, 64, BF16)
    assert plan.variant == "tc" and plan.grid == (1, 256)


def _bshd_view(b, s, h, d, dtype=BF16):
    """q/k/v as ``models/layers.py:_split_heads`` hands them over."""
    return torch.zeros((b, s, h, d), dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("shape", [(8, 128, 3, 64), (8, 128, 32, 64),
                                   (2, 77, 6, 48), (1, 1, 8, 64)])
def test_split_heads_views_are_read_as_they_lie(shape):
    t = _bshd_view(*shape)
    assert not t.is_contiguous() or shape[1] == 1
    assert ap.tma_view_ok(t)


def test_cache_prefix_views_are_read_as_they_lie():
    cache = torch.zeros((8, 8, 512, 64), dtype=BF16)
    assert ap.tma_view_ok(cache)
    assert ap.tma_view_ok(cache[:, :, :150])


@pytest.mark.parametrize("make", [
    lambda: torch.zeros((2, 3, 10, 64), dtype=BF16).transpose(2, 3)[..., :10],
    lambda: _bshd_view(2, 10, 3, 4),              # 8-byte head stride
    lambda: torch.zeros((2, 3, 10, 65), dtype=BF16)[..., :64],  # 130 B rows
    lambda: torch.zeros((1, 2, 10, 64), dtype=BF16).expand(3, 2, 10, 64),
], ids=["d_strided", "narrow_heads", "odd_pitch", "expanded"])
def test_views_the_maps_cannot_describe_are_copied(make):
    assert not ap.tma_view_ok(make())


@pytest.mark.parametrize("smax, splits", [(512, 8), (70, 2), (1, 1),
                                          (64, 1), (65, 2), (128, 2)])
def test_decode_splits_cover_every_key_once(smax, splits):
    plan = ap.plan_decode(8, 32, 8, smax)
    assert plan.splits == splits and plan.split == ap.DECODE_SPLIT
    assert plan.grid == (splits, 64, 1) and plan.heads == 4
    ranges = ap.split_ranges(smax, plan.split)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == smax
    covered = np.zeros(smax, int)
    for lo, hi in ranges:
        assert 0 < hi - lo <= plan.split
        assert (hi - lo) <= 2 * ap.DECODE_TILE
        covered[lo:hi] += 1
    assert (covered == 1).all()


def test_decode_main_path_grid():
    """Llama-3.2-1B decode at B = 8, Smax 512: 8 splits x 64 (b, kv head)
    pairs = 512 blocks of one GQA group of 4 heads each."""
    plan = ap.plan_decode(8, 32, 8, 512)
    assert plan.blocks == 512 and plan.heads == 4


@pytest.mark.parametrize("hq, hkv, heads, chunks", [(6, 2, 3, 1),
                                                    (24, 2, 8, 2),
                                                    (8, 8, 1, 1)])
def test_decode_large_groups_take_head_chunks(hq, hkv, heads, chunks):
    plan = ap.plan_decode(2, hq, hkv, 130)
    assert plan.heads == heads and plan.grid[2] == chunks
    assert plan.heads * plan.grid[2] >= hq // hkv


def test_cpu_tensors_move_no_attention_counter(rng):
    before_l, before_v = launch_counts(), variant_counts()
    q = torch.from_numpy(rng.normal(size=(1, 4, 8, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 2, 8, 16)).astype(np.float32))
    kfa.flash_attention(q.to(BF16), k.to(BF16), k.to(BF16))
    kdf.fused_decode_attention(q[:, :, :1], k, k, 5)
    assert launch_counts() == before_l and variant_counts() == before_v
    assert set(kfa.flash_attention.variants) == {"tc", "simt"}
