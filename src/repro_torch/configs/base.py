"""Architecture configuration for the PyTorch port.

The frozen dataclasses of ``repro.configs.base`` with the fields the ported
families read (the same names, defaults and ``reduced`` smoke shrink,
the recurrent families' ``lru_width``, ``conv_width`` and ``mlstm_chunk``
included).  ``activation_dtype`` maps the ``dtype`` string to a
``torch.dtype``.  Every configuration of the reference is a module here
(``CONFIG`` and ``SMOKE_CONFIG``), and the reference's tables come with
them: the assigned input shapes (``Shape``, ``SHAPES``), the assigned
architectures (``ARCH_NAMES``, ``list_archs``), their dry-run cells
(``cells``) and the analytical parameter counts
(``ArchConfig.param_count``, ``active_param_count``), term for term.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional

import torch

from repro_torch.ops.policy import ComputePolicy

__all__ = ["ArchConfig", "MoESpec", "Shape", "SHAPES", "ARCH_NAMES", "get",
           "list_archs", "cells", "reduced"]


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
    # ssm/hybrid extras
    lru_width: int = 0             # 0 => d_model
    conv_width: int = 4
    mlstm_chunk: int = 256
    # None = the ambient repro_torch.ops policy; a ComputePolicy here is
    # scoped around the model's forward pass
    dtype: str = "bfloat16"
    policy: Optional[ComputePolicy] = None
    # KV-cache storage: "none" keeps activation-dtype caches; "int8" holds
    # int8 rows + a float32 scale per (token, head)
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

    def param_count(self) -> int:
        """Analytical parameter count (embedding + blocks), for 6ND — the
        reference's arithmetic, term for term (its mLSTM and sLSTM terms
        included)."""
        d, hd = self.d_model, self.hd
        n = 0
        if self.embed_input == "tokens":
            n += self.vocab_size * d
        n += self.vocab_size * d if not self.tie_embeddings else 0  # lm head
        for layer in range(self.num_layers):
            kind = self.block_kind(layer)
            if "attn" in kind:
                n += d * hd * (self.num_heads + 2 * self.num_kv_heads)
                n += self.num_heads * hd * d
                if self.qkv_bias:
                    n += hd * (self.num_heads + 2 * self.num_kv_heads)
            if kind in ("mlstm", "slstm"):
                pf = 2.0 if kind == "mlstm" else 4.0 / 3.0
                dh = int(d * pf)
                if kind == "mlstm":
                    n += d * 2 * dh + dh * 3 * dh // 1 + 2 * dh + dh * d
                else:
                    n += 4 * d * d + 4 * d * d // self.num_heads \
                        + int(d * pf) * d * 2
            if kind == "rglru_mlp":
                w = self.lru_width or d
                n += 2 * d * w + w * d + 3 * w  # in-proj x2, out-proj, gates
            if kind.endswith("_mlp") or kind == "attn_local_mlp":
                mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                n += mult * d * self.d_ff
            if kind == "attn_moe":
                m = self.moe
                mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                n += m.num_experts * mult * d * m.d_ff + d * m.num_experts
                n += m.num_shared_experts * 3 * d * m.d_ff
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only the top-k experts)."""
        if self.moe is None:
            return self.param_count()
        d, m = self.d_model, self.moe
        mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        n_moe_layers = sum(1 for layer in range(self.num_layers)
                           if self.block_kind(layer) == "attn_moe")
        inactive = (m.num_experts - m.top_k) * mult * d * m.d_ff \
            * n_moe_layers
        return self.param_count() - inactive


@dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}

ARCH_NAMES = [
    "musicgen_large",
    "llama3_2_1b",
    "qwen1_5_4b",
    "deepseek_67b",
    "phi4_mini_3_8b",
    "qwen2_vl_72b",
    "xlstm_350m",
    "recurrentgemma_9b",
    "llama4_scout_17b_a16e",
    "kimi_k2_1t_a32b",
    "m3vit",  # the paper's own model
]


def get(name: str, smoke: bool = False) -> ArchConfig:
    """``CONFIG`` (or ``SMOKE_CONFIG``) of the named module; an unknown
    name raises ``ValueError``."""
    name = name.replace("-", "_").replace(".", "_")
    try:
        mod = importlib.import_module(f"repro_torch.configs.{name}")
    except ModuleNotFoundError as e:
        raise ValueError(f"unknown config {name!r} (known: "
                         f"{', '.join(ARCH_NAMES)}, m3vit_many)") from e
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def list_archs() -> list[str]:
    return list(ARCH_NAMES)


def cells(include_skipped: bool = False):
    """All assigned (arch, shape, runnable) dry-run cells; long_500k only
    for sub-quadratic archs unless ``include_skipped``."""
    out = []
    for a in ARCH_NAMES:
        if a == "m3vit":
            continue  # the paper's model, benchmarked on its own
        cfg = get(a)
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            runnable = s != "long_500k" or cfg.sub_quadratic
            if runnable or include_skipped:
                out.append((a, s, runnable))
    return out


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
        lru_width=64 if cfg.lru_width or cfg.family in ("hybrid",) else 0,
        window=min(cfg.window, 16) if cfg.window else None,
        mlstm_chunk=8,
        remat=False,
    )
    if cfg.moe is not None:
        base["moe"] = replace(cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
                              d_ff=64, group_size=256, capacity_factor=2.0)
    base.update(overrides)
    return replace(cfg, **base)
