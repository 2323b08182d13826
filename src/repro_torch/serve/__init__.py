"""Serving (the port of ``repro.serve``): the LM serving engine, the
continuous-batching scheduler with its LM backend and SLO tiers, the
M³ViT server and its scheduler backend, expert paging, placement and the
copy-stream transfer engine.  Over a mesh the experts page through
``serve.expert_cache.ShardedExpertCache``."""

from repro_torch.serve.engine import ServeConfig, ServingEngine
from repro_torch.serve.expert_cache import ExpertCache, ExpertUsage, PagedMoE
from repro_torch.serve.placement import (ElasticPolicy, PlacementPlan,
                                         PlacementPolicy, get_policy)
from repro_torch.serve.scheduler import LMBackend, Request, Scheduler
from repro_torch.serve.slo import (RadixPrefixCache, SLOPolicy, SlotParker,
                                   TierSpec, TraceConfig, TraceGenerator)
from repro_torch.serve.transfer import (FakeTransferEngine, TransferEngine,
                                        TransferTimeout)
from repro_torch.serve.vision import M3ViTServer, VisionBackend

__all__ = [
    "ServeConfig", "ServingEngine",
    "ExpertCache", "ExpertUsage", "PagedMoE",
    "PlacementPlan", "PlacementPolicy", "ElasticPolicy", "get_policy",
    "LMBackend", "Request", "Scheduler",
    "RadixPrefixCache", "SLOPolicy", "SlotParker", "TierSpec",
    "TraceConfig", "TraceGenerator",
    "FakeTransferEngine", "TransferEngine", "TransferTimeout",
    "M3ViTServer", "VisionBackend",
]
