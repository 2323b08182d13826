from repro_torch.configs.base import (
    ARCH_NAMES,
    SHAPES,
    ArchConfig,
    MoESpec,
    Shape,
    cells,
    get,
    list_archs,
    reduced,
)

__all__ = [
    "ARCH_NAMES",
    "SHAPES",
    "ArchConfig",
    "MoESpec",
    "Shape",
    "cells",
    "get",
    "list_archs",
    "reduced",
]
