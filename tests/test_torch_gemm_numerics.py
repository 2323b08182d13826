"""The order of work of ``unified_linear``'s two tensor-core variants on the
card, modelled in float32 PyTorch on the CPU (the pattern of
``test_torch_attention_numerics.py``), at the plans
``kernels/gemm_plan.py`` gives every Llama-3.2-1B and M³ViT projection.

A promotion group (``promote`` consecutive k-tiles of 64) is one register
tile of the tensor core's own accumulation; the model takes it as the
exact product sum of its bf16 operands rounded once to float32 (the
tensor core's rounding inside a group is the card's, but it is the same
function of the same operands in both variants, which is all the model
has to show).  ``csrc/gemm_sm90.cuh:Mainloop::consume``:

* split-K (``tc_splitk``, M <= 72): block s sums K range s from zero,
  group by group; the tile's last block adds the partials in ascending
  split order;
* whole K (``tc``, M > 72): one block sums every range, each from zero,
  and adds the ranges' sums in ascending order (a third register tile when
  a range spans several groups, ``fold``).

Both models give every row the same bits at M = 1 … 1024; the order the
whole-K kernel had before (promotion groups running across the ranges'
boundaries) does not, and the model is held to the Pallas kernel in
interpret mode under ``kernels/compare.py``'s float32 tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jk
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels import gemm_plan as gp
from repro_torch.kernels.compare import within_tolerance
from test_torch_threads import one_torch_thread  # noqa: F401

SMS = 132
BF16 = torch.bfloat16
# (K, N) of every projection of the two models' main paths
SHAPES = {"m3vit_patch_embed": (768, 192), "m3vit_qkvo": (192, 192),
          "m3vit_mlp_up": (192, 768), "m3vit_mlp_down": (768, 192),
          "m3vit_semseg_head": (192, 4864), "m3vit_depth_head": (192, 256),
          "lm_q_o": (2048, 2048), "lm_k_v": (2048, 512),
          "lm_gate_up": (2048, 8192), "lm_down": (8192, 2048)}
MS = (1, 8, 16, 64, 70, 72, 80, 128, 1024)


def _group(x, w, k0, k1):
    """One promotion group: the exact sum of the bf16 products of k-tiles
    [k0, k1), rounded once to float32."""
    lo, hi = k0 * gp.TILE_K, min(k1 * gp.TILE_K, x.shape[1])
    return (x[:, lo:hi].double() @ w[lo:hi].double()).float()


def _range_sum(x, w, kt0, kt1, promote):
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    for g0 in range(kt0, kt1, promote):
        acc = acc + _group(x, w, g0, min(g0 + promote, kt1))
    return acc


def _ranges(k, ranges):
    kt = -(-k // gp.TILE_K)
    return [(r * kt // ranges, (r + 1) * kt // ranges)
            for r in range(ranges)]


def splitk_model(x, w, plan):
    """Block s sums range s; the last block adds the partials in order."""
    parts = [_range_sum(x, w, a, b, plan.promote)
             for a, b in _ranges(x.shape[1], plan.splits)]
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def whole_k_model(x, w, plan):
    """One block: each range from zero, the sums added in ascending
    order (``fold``: a running total beside the range's sum; without it
    every range is one group, so acc += group is the same sum)."""
    total = None
    for a, b in _ranges(x.shape[1], plan.ranges):
        r = _range_sum(x, w, a, b, plan.promote)
        total = r if total is None else total + r
    return total


def old_whole_k_model(x, w, plan):
    """The whole-K order before the repair: groups of min(stages, 4)
    k-tiles from K's start, across the ranges' boundaries."""
    kt = -(-x.shape[1] // gp.TILE_K)
    return _range_sum(x, w, 0, kt, min(plan.stages, gp.PROMOTE))


def model(x, w, plan):
    return (splitk_model if plan.splits > 1 else whole_k_model)(x, w, plan)


def _operands(k, n, rows, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(rows, k))).to(BF16)
    w = torch.from_numpy(rng.normal(size=(k, n)) / np.sqrt(k)).to(BF16)
    return x, w


@pytest.mark.parametrize("case", list(SHAPES))
def test_a_row_gets_the_same_bits_at_every_m(case):
    """Rows 0..3 computed as the first rows of a launch of M rows, at every
    M, by the variant and plan the card takes there: bit-identical."""
    k, n = SHAPES[case]
    x, w = _operands(k, min(n, 256), 4, 0)
    rows = {}
    for m in MS:
        plan = gp.plan_linear(m, n, k, BF16, SMS)
        assert plan.variant == ("tc_splitk" if m <= gp.SMALL_M
                                and plan.ranges > 1 else "tc")
        rows[m] = model(x, w, plan)
    for m in MS[1:]:
        assert torch.equal(rows[m], rows[MS[0]]), (case, m)


def test_the_old_whole_k_order_depended_on_m():
    """Before the repair the whole-K kernel promoted every min(stages, 4)
    k-tiles across K, so a row computed at M > 72 differed from the same
    row at M <= 72 wherever a range boundary fell inside a group: every
    M³ViT projection (ranges of one to two k-tiles) and Llama's k/v,
    gate/up and down projections."""
    differ = []
    for case, (k, n) in SHAPES.items():
        x, w = _operands(k, min(n, 256), 16, 1)
        small = gp.plan_linear(16, n, k, BF16, SMS)
        large = gp.plan_linear(1024, n, k, BF16, SMS)
        if not torch.equal(model(x, w, small),
                           old_whole_k_model(x, w, large)):
            differ.append(case)
    assert set(differ) == set(SHAPES) - {"lm_q_o"}, differ


@pytest.mark.parametrize("case", ["m3vit_mlp_down", "lm_k_v", "lm_down"])
@pytest.mark.parametrize("m", [16, 80])
def test_the_model_is_within_tolerance_of_the_pallas_kernel(case, m):
    """The modelled float32 sum before the bf16 store, held to the Pallas
    kernel's (interpret mode) output under the bf16 tolerance."""
    k, n = SHAPES[case]
    n = min(n, 256)
    rng = np.random.default_rng(2)
    xj = jnp.asarray(rng.normal(size=(m, k)), jnp.bfloat16)
    wj = jnp.asarray(rng.normal(size=(k, n)) / np.sqrt(k), jnp.bfloat16)
    want = tensor_from_numpy(np.asarray(
        jk.unified_linear(xj, wj, interpret=True).astype(jnp.float32)))
    x = tensor_from_numpy(np.asarray(xj.astype(jnp.float32))).to(BF16)
    w = tensor_from_numpy(np.asarray(wj.astype(jnp.float32))).to(BF16)
    got = model(x, w, gp.plan_linear(m, SHAPES[case][1], k, BF16, SMS))
    assert within_tolerance(got.to(BF16), want.to(BF16), BF16)
