"""Plans for the two attention kernels, ``flash_attention`` and
``decode_fused``, in plain Python, so the CPU tests reach every decision the
wrappers make on the card (as :mod:`repro_torch.kernels.gemm_plan` does for
the GEMMs).

``flash_attention`` (:func:`plan_attention`) routes by dtype and shape,
never as a fallback on failure:

* ``"tc"`` — bf16 with ``D % 16 == 0`` and ``D <= 256``: one block per
  (b, q head, 64 query rows), one consumer warpgroup (wgmma for ``Q·Kᵀ`` and
  ``P·V``) and one producer warp streaming K/V tiles of 64 keys through a
  2-stage TMA ring; D is padded in shared memory to 64-wide atoms (1 for
  D <= 64, 2 for D <= 128, else 4: RecurrentGemma's head_dim 256, whose
  P·V runs one atom a round).
* ``"simt"`` — float32 (wgmma would take it only as TF32), or D not a
  multiple of 16 (the first kernel: 8 query rows a block on the FMA pipes).

The ``tc`` kernel reads q, k and v through 4-D tensor maps built from their
strides, so a transposed ``(B, S, H, D)`` view needs no copy when
:func:`tma_view_ok` holds; otherwise the wrapper makes the tensor
contiguous first.

``decode_fused`` (:func:`plan_decode`) splits the ``Smax`` cache slots into
``ceil(Smax / 64)`` splits of 64 keys (two 32-key tiles each), fixed at
launch; every key lies in exactly one split (:func:`split_ranges`).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

__all__ = ["AttnPlan", "DecodePlan", "plan_attention", "plan_decode",
           "split_ranges", "tma_view_ok", "TC_ROWS", "TC_KEYS",
           "DECODE_SPLIT", "DECODE_TILE", "MAX_D"]

MAX_D = 256           # both kernels: head_dim limit
TC_ROWS = 64          # query rows a tc block: wgmma's M side
TC_KEYS = 64          # keys a K/V tile
WGMMA_K = 16          # head dims a wgmma step
SIMT_ROWS = 8         # query rows a simt block
DECODE_SPLIT = 64     # keys a decode split: two tiles
DECODE_TILE = 32      # keys a decode tile: one per lane
DECODE_HEADS = 8      # query heads a decode block, one warp each


@dataclass(frozen=True)
class AttnPlan:
    variant: str          # "tc" or "simt"
    reason: str           # the routing rule that chose it
    rows: int             # query rows a block
    atoms: int = 0        # tc: 64-wide head-dim atoms in shared memory
    grid: tuple = ()      # (query tiles, B * Hq)

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)


@dataclass(frozen=True)
class DecodePlan:
    split: int            # keys a split
    splits: int           # splits over Smax
    heads: int            # query heads a block (warps)
    grid: tuple           # (splits, B * Hkv, head chunks)

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)


@functools.lru_cache(maxsize=1024)
def plan_attention(b: int, hq: int, sq: int, d: int,
                   dtype: torch.dtype) -> AttnPlan:
    """The plan for q (b, hq, sq, d) in ``dtype`` (k and v share it)."""
    if dtype != torch.bfloat16:
        return AttnPlan("simt", f"{dtype} operands: wgmma takes float32 "
                        f"only as TF32", SIMT_ROWS,
                        grid=(-(-sq // SIMT_ROWS), b * hq))
    if d % WGMMA_K or d > MAX_D:
        return AttnPlan("simt", f"head_dim {d} not a multiple of "
                        f"{WGMMA_K} up to {MAX_D}", SIMT_ROWS,
                        grid=(-(-sq // SIMT_ROWS), b * hq))
    atoms = 1 if d <= 64 else 2 if d <= 128 else 4
    return AttnPlan("tc", f"bf16, head_dim {d}: {TC_ROWS} query rows a "
                    f"block, {atoms} head-dim atom(s)", TC_ROWS, atoms,
                    grid=(-(-sq // TC_ROWS), b * hq))


def tma_view_ok(t: torch.Tensor) -> bool:
    """Whether a (B, H, S, D) bf16 tensor can be read through the tc
    kernel's 4-D tensor map as it lies: D contiguous, a 16-byte aligned
    base, and every other stride a multiple of 16 bytes."""
    if t.dim() != 4 or t.stride(3) != 1:
        return False
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) > 0 and (t.stride(i) * size) % 16 == 0
        for i in range(3))


def split_ranges(smax: int, split: int = DECODE_SPLIT) -> list[tuple]:
    """The key range [lo, hi) of each decode split, in split order."""
    return [(lo, min(lo + split, smax)) for lo in range(0, smax, split)]


@functools.lru_cache(maxsize=1024)
def plan_decode(b: int, hq: int, hkv: int, smax: int) -> DecodePlan:
    """The plan for q (b, hq, 1, D) against caches (b, hkv, smax, D)."""
    group = hq // hkv
    heads = min(group, DECODE_HEADS)
    splits = max(1, -(-smax // DECODE_SPLIT))
    return DecodePlan(DECODE_SPLIT, splits, heads,
                      (splits, b * hkv, -(-group // heads)))
