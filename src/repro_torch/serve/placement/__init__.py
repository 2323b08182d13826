from repro_torch.serve.placement.elastic import ElasticPolicy
from repro_torch.serve.placement.plan import PlacementPlan
from repro_torch.serve.placement.policy import (BudgetPolicy, LRUPolicy,
                                          PlacementPolicy, StaticPolicy,
                                          budget_slots, fraction_slots,
                                          get_policy)

__all__ = [
    "PlacementPlan", "PlacementPolicy",
    "StaticPolicy", "LRUPolicy", "BudgetPolicy", "ElasticPolicy",
    "get_policy", "budget_slots", "fraction_slots",
]
