"""``repro_torch.roofline`` — the port's roofline: scope markers
(``scope``), the cost counter over what runs (``op_cost``), the report
read against the H100's constants (``analysis``), the MoE traffic models
(``moe_traffic``) and the tables (``report``).

The names load on first use, so the model code can import
``repro_torch.roofline.scope`` without pulling in the rest.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "RooflineReport": "analysis",
    "analyze_step": "analysis",
    "model_flops": "analysis",
    "flash_kernel_bytes": "analysis",
    "kernel_adjusted_terms": "analysis",
    "OpCost": "op_cost",
    "CostCounter": "op_cost",
    "count_cost": "op_cost",
    "staged_moe_bytes": "moe_traffic",
    "fused_moe_bytes": "moe_traffic",
    "moe_traffic_report": "moe_traffic",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
