"""Tile plans for the two GEMM kernels, ``unified_linear`` and ``moe_gemm``,
and for the fused MoE layer, ``moe_fused`` (:func:`plan_moe_fused`).

Both run one bf16 tensor-core mainloop (``csrc/gemm_sm90.cuh``) that
computes ``yᵀ = wᵀ·xᵀ``: a block owns ``64·nwg`` rows of the weights' N
(``nwg`` consumer warpgroups, wgmma's 64-row M side each) against ``bt``
tokens (wgmma's n side), over a contiguous range of 64-wide k-tiles fed by
TMA through a ring of ``stages`` shared-memory stages.  This module picks
that shape from (M, N, K) and the card's SM count, in plain Python, so the
CPU tests reach every decision the wrappers make on the card.

Routing (a dispatch on dtype and shape, never a fallback on failure):

* ``"tc"`` — bf16 on the tensor cores, one block per output tile;
* ``"tc_splitk"`` — the same with K split over ``splits`` blocks per tile,
  whose float32 partials the tile's last block sums in ascending split
  order (``unified_linear`` only);
* ``"simt"`` — the float32 FMA kernel (``common.cuh:gemm_tile``) for
  float32 operands (wgmma would take them only as TF32) and for bf16 rows
  whose pitch or base is not a multiple of 16 bytes (TMA cannot address
  them), e.g. K = 33.

Tile choice:

* M <= 72 (decode; M3ViT never gets here): ``bt`` is the least of
  8, 16, 32, 64, 72 that holds M, one warpgroup, and K is split until about
  two blocks per SM stream weights (at least one per SM, and no split
  shorter than four k-tiles beyond that) — a decode step's GEMMs are bound
  by their weight bytes, and a grid of N/64 blocks leaves most SMs idle.
* M > 72: the largest of 128×128, 128×64, 64×128, 64×64, 64×32, 64×16
  (rows of N × tokens; 128 rows only where N is a multiple of 128) whose
  grid reaches two waves of the SMs when K is at most four k-tiles, else
  7/8 of a wave; K is never split over blocks, even where 64×16 tiles
  leave SMs idle (M³ViT at one to seven frames).  Split-K also lost to
  smaller tiles at every M = 1024 shape of the main paths on the chip.

The order of a row's sum (:func:`sum_order`) depends on N, K and the SM
count, never on M, so a row gets the same bits whatever the number of
rows it is computed with (a prompt prefilled alone, in a batch, or a
chunk at a time; a frame alone or in a batch).  K is cut into ``ranges``
ranges of whole k-tiles, the split count the M <= 72 rule above gives;
each range is summed from zero in promotion groups of ``promote`` k-tiles
(``csrc/gemm_sm90.cuh``: at most four, the tensor core's own accumulation
spanning at most 256 products), and the ranges' sums are added in
ascending order.  A split-K block sums one range and the tile's last
block adds the partials; a whole-K block sums the ranges one after
another.  Where a range spans more than one promotion group, the
whole-K block keeps the running total in a third register tile
(``fold``), for which the block's producer warpgroup gives the consumers
its registers (``csrc/unified_linear.cu``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

__all__ = ["GemmPlan", "plan_linear", "plan_moe", "k_ranges", "sum_order",
           "TILE_K",
           "WGMMA_K", "TOKEN_TILES", "SMEM_BUDGET", "FusedPlan",
           "plan_moe_fused", "fused_smem_bytes", "fused_tile_rows",
           "FUSED_ROWS"]

TILE_K = 64            # k-tile: one 128-byte swizzle row of bf16
WGMMA_K = 16           # wgmma's k per instruction
WG_ROWS = 64           # wgmma's M side
TOKEN_TILES = (8, 16, 32, 64, 72, 128)   # the n sides the library holds
SMALL_M = 72           # M at or below this: one token tile, split-K
MAX_STAGES = 6
SMEM_BUDGET = 196 * 1024   # ring bytes a block may take (of 227 KB)
SPLITK_BLOCKS_PER_SM = 2   # small-M split target
MIN_SPLIT_KT = 4           # small M: k-tiles a split keeps, where it can
SHORT_K_TILES = 4          # large M: K this short aims at two waves
PROMOTE = 4                # k-tiles a promotion group spans at most
# large M: (tokens, warpgroups) tiles, largest first
LARGE_M_TILES = ((128, 2), (64, 2), (128, 1), (64, 1), (32, 1), (16, 1))


@dataclass(frozen=True)
class GemmPlan:
    variant: str            # "tc", "tc_splitk" or "simt"
    reason: str             # why this variant (the routing rule that chose it)
    bt: int = 0             # tokens per tile (wgmma n)
    nwg: int = 0            # consumer warpgroups: 64·nwg rows of N a tile
    splits: int = 1         # K splits per tile (1 or ``ranges``)
    stages: int = 0         # shared-memory ring depth
    grid: tuple = ()        # (N tiles, token tiles, splits or queues)
    ranges: int = 1         # K ranges, summed in ascending order
    promote: int = 0        # k-tiles a promotion group spans
    fold: bool = False      # whole K, ranges of several groups: 3rd tile

    @property
    def blocks(self) -> int:
        return math.prod(self.grid) if self.grid else 0

    @property
    def tiles(self) -> int:
        return self.grid[0] * self.grid[1] if self.grid else 0


def k_ranges(k: int, splits: int) -> list[tuple[int, int]]:
    """The K range of each split, in split order: contiguous whole k-tiles
    (``csrc/gemm_sm90.cuh:split_range``), the last ending at K."""
    kt = -(-k // TILE_K)
    bounds = [s * kt // splits for s in range(splits + 1)]
    return [(bounds[s] * TILE_K, min(bounds[s + 1] * TILE_K, k))
            for s in range(splits)]


def _stage_bytes(bt: int, nwg: int) -> int:
    return nwg * WG_ROWS * TILE_K * 2 + bt * TILE_K * 2


def _stages(bt: int, nwg: int, kt_per_block: int) -> int:
    """Ring depth: up to MAX_STAGES within the budget, no deeper than the
    block's k-tiles."""
    return max(1, min(MAX_STAGES, kt_per_block,
                      SMEM_BUDGET // _stage_bytes(bt, nwg)))


@functools.lru_cache(maxsize=4096)
def sum_order(n: int, k: int, sms: int) -> tuple[int, int]:
    """(ranges, promote): the K ranges and the promotion group of every
    ``unified_linear`` tensor-core launch with these N and K, at any M.
    The ranges are the split-K count of a small-M launch: about two blocks
    per SM streaming weights, at least one per SM, no range shorter than
    four k-tiles beyond that; the group is the longest range, up to four
    k-tiles (a split-K block's ring, up to six stages, is never shallower
    than it)."""
    kt = -(-k // TILE_K)
    tiles = -(-n // WG_ROWS)
    ranges = min(kt, max(-(-sms // tiles),
                         min(-(-SPLITK_BLOCKS_PER_SM * sms // tiles),
                             kt // MIN_SPLIT_KT)))
    return ranges, min(PROMOTE, -(-kt // ranges))


def _aligned(*sizes_and_ptrs: int) -> bool:
    return all(v % 16 == 0 for v in sizes_and_ptrs)


def _simt(reason: str) -> GemmPlan:
    return GemmPlan("simt", reason)


@functools.lru_cache(maxsize=4096)
def plan_linear(m: int, n: int, k: int, dtype: torch.dtype, sms: int,
                aligned: bool = True, order_n: int | None = None) -> GemmPlan:
    """The plan for ``y (m, n) = x (m, k) @ w (k, n)``; ``aligned``: x, w
    and y start on 16-byte boundaries.  ``order_n``: w is a column block
    of a (k, order_n) weight (a tensor-parallel shard), and the K ranges
    and promotion group are that weight's, so a column's sum runs in the
    order the whole product gives it."""
    if dtype != torch.bfloat16:
        return _simt(f"{dtype} operands: wgmma takes float32 only as TF32")
    if not (aligned and _aligned(2 * k, 2 * n)):
        return _simt("a bf16 row pitch or base not a multiple of 16 bytes "
                     "(TMA cannot address it)")
    kt = -(-k // TILE_K)
    ranges, promote = sum_order(order_n or n, k, sms)
    if m <= SMALL_M:
        bt, nwg = min(t for t in TOKEN_TILES if t >= m), 1
        splits, fold = ranges, False
        reason = (f"M={m} <= {SMALL_M}: one {bt}-token tile, K split to "
                  f"about {SPLITK_BLOCKS_PER_SM} blocks per SM")
    else:
        # the largest tile whose grid reaches the target without a split:
        # two waves where K is short (a block's mainloop is a few k-tiles,
        # so more blocks hide the fill and the epilogue), else 7/8 of a wave
        fold = ranges > 1 and -(-kt // ranges) > promote
        target = sms * 2 if kt <= SHORT_K_TILES else sms * 7 / 8
        shapes = [s for s in LARGE_M_TILES
                  if s[1] == 1 or n % (WG_ROWS * 2) == 0]
        for bt, nwg in shapes:
            tiles = -(-n // (WG_ROWS * nwg)) * -(-m // bt)
            if tiles >= target:
                break
        splits = 1      # the order of a row's sum must not depend on M
        reason = (f"M={m} > {SMALL_M}: {WG_ROWS * nwg} x {bt} tiles, "
                  f"K whole in {ranges} range(s)"
                  f"{' folded' if fold else ''}, for {sms} SMs")
    grid = (-(-n // (WG_ROWS * nwg)), -(-m // bt), splits)
    stages = _stages(bt, nwg, -(-kt // splits))
    assert stages >= promote, (m, n, k, stages, promote)
    return GemmPlan("tc_splitk" if splits > 1 else "tc", reason, bt, nwg,
                    splits, stages, grid, ranges, promote, fold)


@functools.lru_cache(maxsize=1024)
def plan_moe(queues: int, c: int, d: int, f: int, dtype: torch.dtype,
             aligned: bool = True) -> GemmPlan:
    """The plan for ``queues`` GEMMs ``(c, d) @ (d, f)`` (``moe_gemm``):
    one token tile covers a whole queue where c <= 72, no split (the
    queues give the grid its width)."""
    if dtype != torch.bfloat16:
        return _simt(f"{dtype} operands: wgmma takes float32 only as TF32")
    if not (aligned and _aligned(2 * d, 2 * f)):
        return _simt("a bf16 row pitch or base not a multiple of 16 bytes "
                     "(TMA cannot address it)")
    bt = min((t for t in TOKEN_TILES if t >= c), default=TOKEN_TILES[-1])
    nwg = 2 if f % (WG_ROWS * 2) == 0 else 1
    grid = (-(-f // (WG_ROWS * nwg)), -(-c // bt), queues)
    stages = _stages(bt, nwg, -(-d // TILE_K))
    return GemmPlan("tc", f"{bt}-row queue tiles against {WG_ROWS * nwg} "
                    f"columns of F", bt, nwg, 1, stages, grid,
                    promote=min(stages, PROMOTE))


# ------------------------------------------------------------ moe_fused

FUSED_ROWS = 64        # packed queue rows a tc block owns: wgmma's M side
FUSED_CHUNK = 64       # hidden units a ring stage carries
FUSED_WGS = 2          # consumer warpgroups, taking the chunks in turn
FUSED_MAX_NY = 3       # 64-column atoms of y a warpgroup holds: 96 floats
FUSED_MAX_STAGES = 4
FUSED_ATOM = 64 * 128  # one 64-row box of 128-byte rows
# dynamic shared memory a tc block may take: the card's 227 KB per block
# less the 1 KB of static row tables (csrc/moe_fused.cu)
FUSED_SMEM_LIMIT = 227 * 1024 - 1024


@dataclass(frozen=True)
class FusedPlan:
    variant: str            # "tc" or "simt"
    reason: str             # why this variant (the routing rule that chose it)
    ny: int = 0             # 64-column atoms of y a warpgroup holds
    stages: int = 0         # shared-memory ring depth (chunks of F)
    smem: int = 0           # dynamic shared memory of one block, bytes
    grid: tuple = ()        # (row tiles an expert, d-slices, experts)

    @property
    def blocks(self) -> int:
        return math.prod(self.grid) if self.grid else 0


def fused_smem_bytes(d: int, ny: int, kind: str, stages: int,
                     table: int) -> int:
    """``csrc/moe_fused.cu:tc_smem_bytes``: 1 KB of alignment slack, the x
    tile, the ring (or the epilogue's float32 y tile that reuses it), the
    LUT half-table of ``table`` entries, the barriers."""
    ka = -(-d // 64)
    stage = ((2 if kind == "swiglu" else 1) * ka + ny) * FUSED_ATOM
    ring = max(stages * stage, FUSED_ROWS * (64 * ny + 4) * 4)
    return 1024 + ka * FUSED_ATOM + ring + (table + 1) // 2 * 8 + 16 * stages


@functools.lru_cache(maxsize=1024)
def plan_moe_fused(g: int, e: int, c: int, d: int, f: int,
                   dtype: torch.dtype, kind: str, sms: int, table: int = 0,
                   aligned: bool = True) -> FusedPlan:
    """The variant, y atoms, ring depth and grid of one ``moe_fused``
    launch: ``g`` routing groups, ``e`` experts of capacity ``c``, width
    ``d``, hidden ``f``, a LUT half-table of ``table`` entries (0: exact
    activations); ``aligned``: x and the weights start on 16-byte
    boundaries.

    ``tc`` packs each expert's live queue rows of every group into 64-row
    tiles; the grid is the capacity bound, ⌈g·c/64⌉ tiles an expert, and
    the tiles past an expert's live rows return at once.  A warpgroup holds
    y for a d-slice of 64·ny columns, ny the largest of 3, 2, 1 that
    divides d's 64-column atoms (so no slice reads a box wholly past d;
    d = 192: one slice), and the ring is as deep as shared memory allows,
    up to 4 chunks of F.  F is never split over blocks: a row's sum over F
    then runs in one block in the same order at every number of routing
    groups, so a frame's output does not depend on its batch (a split in
    two gained ≈ 4 µs a launch below batch 8 on the H100, PERF.md)."""
    if dtype != torch.bfloat16:
        return FusedPlan("simt", f"{dtype} operands: wgmma takes float32 "
                         f"only as TF32")
    if not (aligned and _aligned(2 * d, 2 * f)):
        return FusedPlan("simt", "a bf16 row pitch or base not a multiple "
                         "of 16 bytes (cp.async and TMA cannot address it)")
    atoms = -(-d // 64)
    ny = max(n for n in range(FUSED_MAX_NY, 0, -1) if atoms % n == 0)
    fits = [s for s in range(1, FUSED_MAX_STAGES + 1)
            if fused_smem_bytes(d, ny, kind, s, table) <= FUSED_SMEM_LIMIT]
    if not fits:
        return FusedPlan("simt", f"the x tile and one ring stage at d={d} "
                         f"({kind}) exceed a block's shared memory")
    stages = fits[-1]
    grid = (-(-g * c // FUSED_ROWS), atoms // ny, e)
    return FusedPlan(
        "tc", f"{FUSED_ROWS}-row tiles of packed queue rows, {64 * ny}-column "
        f"d-slices, F whole, {stages}-stage ring; a grid of "
        f"{math.prod(grid)} blocks (capacity bound) for {sms} SMs", ny,
        stages, fused_smem_bytes(d, ny, kind, stages, table), grid)


def fused_tile_rows(sizes, capacity: int) -> dict:
    """The tile assignment of the ``tc`` kernel, as its blocks compute it
    (``csrc/moe_fused.cu:moe_fused_tc_kernel``): for ``sizes`` (G, E) of
    queue lengths, {(expert, tile): [(group, queue row) or None for a dead
    row, one per tile row]} for every tile that runs; tiles at or past an
    expert's live rows return at once and are left out."""
    sizes = [[min(max(int(s), 0), capacity) for s in row] for row in sizes]
    g_num = len(sizes)
    e_num = len(sizes[0]) if sizes else 0
    out = {}
    for e in range(e_num):
        total = sum(sizes[g][e] for g in range(g_num))
        for tile in range(-(-g_num * capacity // FUSED_ROWS)):
            p0 = tile * FUSED_ROWS
            if p0 >= total:
                continue
            rows = []
            for p in range(p0, p0 + FUSED_ROWS):
                if p >= total:
                    rows.append(None)
                    continue
                before, g = 0, 0
                while p >= before + sizes[g][e]:
                    before += sizes[g][e]
                    g += 1
                rows.append((g, p - before))
            out[(e, tile)] = rows
    return out
