"""Architecture configuration for the PyTorch port.

The frozen dataclasses of ``repro.configs.base`` with the fields the ported
families read (the same names, defaults and ``reduced`` smoke shrink; the
recurrent fields come with the slice that ports those blocks).
``activation_dtype`` maps the ``dtype`` string to a ``torch.dtype``.  Only
the configs this port serves are present as modules (``m3vit``,
``llama3_2_1b``); ``get`` raises for the others.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional

import torch

from repro_torch.ops.policy import ComputePolicy

__all__ = ["ArchConfig", "MoESpec", "get", "reduced"]


@dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    num_tasks: int = 1
    impl: str = "onehot"           # "grouped" (paper-faithful) | "onehot"
    group_size: int = 4096
    renormalize: bool = True       # renormalize top-k gates to sum to 1


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm | vit-moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads
    block_pattern: tuple = ("attn_mlp",)
    mlp_kind: str = "swiglu"       # swiglu | gelu | geglu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qkv_bias: bool = False
    rope: str = "rope"             # rope | mrope | sincos | none
    rope_theta: float = 10000.0
    window: Optional[int] = None   # sliding window for attn_local blocks
    embed_input: str = "tokens"    # tokens | embeddings
    tie_embeddings: bool = False
    moe: Optional[MoESpec] = None
    # None = the ambient repro_torch.ops policy; a ComputePolicy here is
    # scoped around the model's forward pass
    dtype: str = "bfloat16"
    policy: Optional[ComputePolicy] = None
    # KV-cache storage: "none" keeps activation-dtype caches; "int8" comes
    # with the packed-formats slice of the port and raises until then
    kv_quant: str = "none"
    remat: bool = True             # kept for parity; inference ignores it
    num_tasks: int = 1
    sub_quadratic: bool = False    # True => long_500k cell is runnable

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def activation_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % self.period]


def get(name: str, smoke: bool = False) -> ArchConfig:
    name = name.replace("-", "_").replace(".", "_")
    try:
        mod = importlib.import_module(f"repro_torch.configs.{name}")
    except ModuleNotFoundError as e:
        raise ValueError(f"config {name!r} is not ported yet "
                         "(the port serves m3vit, llama3_2_1b)") from e
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Shrink a config for smoke testing while keeping the family structure
    (the same shrink as the reference's ``reduced``)."""
    base = dict(
        num_layers=min(cfg.num_layers, 2 * cfg.period),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        window=min(cfg.window, 16) if cfg.window else None,
        remat=False,
    )
    if cfg.moe is not None:
        base["moe"] = replace(cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
                              d_ff=64, group_size=256, capacity_factor=2.0)
    base.update(overrides)
    return replace(cfg, **base)
