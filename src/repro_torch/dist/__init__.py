"""Distribution: the sharding rule table (``dist.sharding``, the port of
``repro.dist.sharding``) and explicit SPMD over a ``DeviceMesh``
(``dist.spmd``: local shards and the recorded collectives between them).

The int8 error-feedback gradient collectives of ``repro.dist.compress``
come with training over a mesh (``ROADMAP.md`` queue 1 item 6b)."""

from repro_torch.dist.sharding import (NamedSharding, P, ShardingRules,
                                       batch_sharding, constrain,
                                       current_rules, ep_dispatch_sharding,
                                       opt_state_shardings,
                                       param_sharding_rules, use_rules)

__all__ = ["NamedSharding", "P", "ShardingRules", "batch_sharding",
           "constrain", "current_rules", "ep_dispatch_sharding",
           "opt_state_shardings", "param_sharding_rules", "use_rules"]
