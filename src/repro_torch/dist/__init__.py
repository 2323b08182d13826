"""Distribution: the sharding rule table (``dist.sharding``, the port of
``repro.dist.sharding``), explicit SPMD over a ``DeviceMesh``
(``dist.spmd``: local shards and the recorded collectives between them,
the differentiable parameter gather of training over a mesh, and the
device-free mesh of the dry-run), and the int8 error-feedback gradient
collectives (``dist.compress``, the port of ``repro.dist.compress``).
The reference's ``dist/_compat.py`` is a JAX-version shim for
``jax.shard_map`` and has no counterpart."""

from repro_torch.dist.sharding import (NamedSharding, P, ShardingRules,
                                       batch_sharding, constrain,
                                       current_rules, ep_dispatch_sharding,
                                       opt_state_shardings,
                                       param_sharding_rules, use_rules)

__all__ = ["NamedSharding", "P", "ShardingRules", "batch_sharding",
           "constrain", "current_rules", "ep_dispatch_sharding",
           "opt_state_shardings", "param_sharding_rules", "use_rules"]
