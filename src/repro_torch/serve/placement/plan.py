"""PlacementPlan: the one source of truth for expert → shard residency,
a copy of ``repro.serve.placement.plan`` (NumPy only; the port keeps its
own copy and imports nothing of the JAX package).

  * ``replicas[e]`` — the tuple of shards holding expert ``e``, primary
    first.  The static plan is a single-shard tuple per expert (the
    contiguous modulo partition); an elastic plan may list several shards
    (hot-expert replication) or move an expert off its static home
    (cold-expert migration).
  * ``generation`` — a monotonically increasing swap counter.  Plans are
    immutable; a rebalance builds a NEW plan via :meth:`evolve` (which
    bumps the generation) and installs it between forwards, so no wave
    ever observes a half-applied plan.

On one device every plan has one shard; plans over several shards wait
for the port's sharded expert cache.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PlacementPlan"]


class PlacementPlan:
    """Immutable expert → replica-set map with a generation counter."""

    __slots__ = ("num_experts", "num_shards", "generation", "replicas")

    def __init__(self, num_experts: int, num_shards: int,
                 replicas, generation: int = 0):
        num_experts = int(num_experts)
        num_shards = int(num_shards)
        if num_experts < 1 or num_shards < 1:
            raise ValueError("need >=1 expert and >=1 shard")
        replicas = tuple(tuple(int(s) for s in r) for r in replicas)
        if len(replicas) != num_experts:
            raise ValueError(
                f"plan lists {len(replicas)} experts, expected {num_experts}")
        for e, r in enumerate(replicas):
            if not r:
                raise ValueError(f"expert {e} has no shard")
            if len(set(r)) != len(r):
                raise ValueError(f"expert {e} lists a shard twice: {r}")
            for s in r:
                if not 0 <= s < num_shards:
                    raise ValueError(
                        f"expert {e} on shard {s} outside [0, {num_shards})")
        object.__setattr__(self, "num_experts", num_experts)
        object.__setattr__(self, "num_shards", num_shards)
        object.__setattr__(self, "generation", int(generation))
        object.__setattr__(self, "replicas", replicas)

    def __setattr__(self, name, value):  # immutability is the swap contract
        raise AttributeError("PlacementPlan is immutable — use evolve()")

    # ------------------------------------------------------------ queries

    def owner(self, expert: int) -> int:
        """Primary shard of ``expert`` (the static map for static plans)."""
        return self.replicas[int(expert)][0]

    def shards_of(self, expert: int) -> tuple[int, ...]:
        """All shards holding ``expert``, primary first."""
        return self.replicas[int(expert)]

    @property
    def max_replicas(self) -> int:
        return max(len(r) for r in self.replicas)

    def shard_expert_counts(self) -> np.ndarray:
        """(num_shards,) int64: experts (incl. replicas) each shard holds."""
        out = np.zeros(self.num_shards, np.int64)
        for r in self.replicas:
            for s in r:
                out[s] += 1
        return out

    # -------------------------------------------------------- construction

    @classmethod
    def static(cls, num_experts: int, num_shards: int) -> "PlacementPlan":
        """The static partition: shard ``s`` of ``m`` owns the
        contiguous block ``[s*E/m, (s+1)*E/m)`` — ``owner(e) = e // (E/m)``."""
        if num_experts % num_shards:
            raise ValueError(
                f"E={num_experts} does not divide {num_shards} shards")
        e_local = num_experts // num_shards
        return cls(num_experts, num_shards,
                   tuple((e // e_local,) for e in range(num_experts)))

    def evolve(self, replicas) -> "PlacementPlan":
        """New plan with the given replica map and a bumped generation."""
        return PlacementPlan(self.num_experts, self.num_shards,
                             replicas, generation=self.generation + 1)

    # ---------------------------------------------------------- comparison

    def same_layout(self, other: "PlacementPlan") -> bool:
        """Layout equality, ignoring generation (rebalance no-op check)."""
        return (self.num_experts == other.num_experts
                and self.num_shards == other.num_shards
                and self.replicas == other.replicas)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"PlacementPlan(E={self.num_experts}, m={self.num_shards}, "
                f"gen={self.generation}, max_replicas={self.max_replicas})")
