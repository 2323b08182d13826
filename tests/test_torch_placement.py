"""The port's placement subsystem (``repro_torch.serve.placement``, a NumPy
copy of ``repro.serve.placement``) against the reference on the same
inputs: static plans, validation, evolve, the policy registry, slot sizing
by fraction and by byte budget, victim and prefetch ranking,
``ExpertUsage.hot`` and the elastic policy's ``update`` as a host function.
Every result is held equal to the reference's (integers and tuples
exactly; the elastic policy's float EMA arithmetic is the same NumPy)."""

from collections import OrderedDict

import numpy as np
import pytest

from repro.serve import expert_cache as JEC
from repro.serve import placement as JP
from repro_torch.serve import expert_cache as TEC
from repro_torch.serve import placement as TP


def _layout(plan):
    return (plan.num_experts, plan.num_shards, plan.generation,
            plan.replicas, plan.max_replicas,
            plan.shard_expert_counts().tolist())


@pytest.mark.parametrize("e,m", [(8, 1), (8, 2), (8, 4), (16, 4), (16, 1)])
def test_static_plan_equals_reference(e, m):
    want, got = JP.PlacementPlan.static(e, m), TP.PlacementPlan.static(e, m)
    assert _layout(got) == _layout(want)
    assert [got.owner(i) for i in range(e)] == [want.owner(i)
                                                for i in range(e)]


BAD_PLANS = {
    "not_divisible": lambda P: P.PlacementPlan.static(8, 3),
    "too_few_experts": lambda P: P.PlacementPlan(3, 2, ((0,), (1,))),
    "no_shard": lambda P: P.PlacementPlan(2, 2, ((0,), ())),
    "shard_twice": lambda P: P.PlacementPlan(2, 2, ((0,), (1, 1))),
    "shard_outside": lambda P: P.PlacementPlan(2, 2, ((0,), (2,))),
}


@pytest.mark.parametrize("case", list(BAD_PLANS))
def test_plan_validation_matches_reference(case):
    with pytest.raises(ValueError) as want:
        BAD_PLANS[case](JP)
    with pytest.raises(ValueError) as got:
        BAD_PLANS[case](TP)
    assert str(got.value) == str(want.value)


def test_plan_immutable_and_evolve_match_reference():
    for P in (JP, TP):
        with pytest.raises(AttributeError, match="immutable"):
            P.PlacementPlan.static(4, 2).generation = 7
    replicas = ((0, 1), (0,), (1,), (1,))
    want = JP.PlacementPlan.static(4, 2).evolve(replicas)
    got = TP.PlacementPlan.static(4, 2).evolve(replicas)
    assert _layout(got) == _layout(want)
    assert got.evolve(got.replicas).same_layout(got)
    assert not got.same_layout(TP.PlacementPlan.static(4, 2))


@pytest.mark.parametrize("name", ["static", "lru", "budget", "elastic", None])
def test_policy_registry_matches_reference(name):
    want, got = JP.get_policy(name), TP.get_policy(name)
    assert type(got).__name__ == type(want).__name__
    assert (got.name, got.rebalance_every, got.budget_bytes) \
        == (want.name, want.rebalance_every, want.budget_bytes)
    assert got.table_width(4) == want.table_width(4)
    inst = TP.ElasticPolicy(rebalance_every=2)
    assert TP.get_policy(inst) is inst
    with pytest.raises(ValueError, match="unknown placement policy"):
        TP.get_policy("round-robin")


# (budget bytes or None, per-expert bytes, pinned bytes, experts per
#  shard, resident fraction, floor)
SIZINGS = [(1000, 100, 0, 8, 0.5, 1), (1000, 100, 400, 8, 0.5, 1),
           (300, 100, 400, 8, 0.5, 2), (None, 100, 0, 8, 0.5, 1),
           (None, 100, 0, 8, 0.1, 1), (None, 100, 0, 8, 0.0, 2),
           (None, 593664, 0, 16, 0.5, 4), (4 * 593664, 593664, 0, 16, 1.0, 4),
           (4 * 593664 - 1, 593664, 0, 16, 1.0, 4)]


@pytest.mark.parametrize("case", SIZINGS)
def test_slot_sizing_matches_reference(case):
    budget, per, pinned, eps, frac, floor = case
    kw = dict(per_expert_bytes=per, pinned_bytes=pinned,
              experts_per_shard=eps, resident_fraction=frac, floor=floor)
    for name in ("static", "lru", "elastic", "budget"):
        if name == "budget" and budget is None:
            for P in (JP, TP):
                with pytest.raises(ValueError, match="needs a byte budget"):
                    P.get_policy(name).slots(**kw)
            continue
        got = TP.get_policy(name, budget_bytes=budget).slots(**kw)
        assert got == JP.get_policy(name, budget_bytes=budget).slots(**kw)
    if budget is not None:
        assert TP.budget_slots(budget, per, pinned, floor) \
            == JP.budget_slots(budget, per, pinned, floor)
    assert TP.fraction_slots(frac, eps, floor) \
        == JP.fraction_slots(frac, eps, floor)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_usage_hot_and_ranking_match_reference(seed):
    """Integer counts with many ties (the deterministic id tie-break),
    two tasks, several updates."""
    rng = np.random.default_rng(seed)
    ju, tu = JEC.ExpertUsage(8, num_tasks=2, decay=0.5), \
        TEC.ExpertUsage(8, num_tasks=2, decay=0.5)
    for _ in range(3):
        task = int(rng.integers(0, 2))
        counts = rng.integers(0, 3, 8)
        ju.update(counts, task_id=task)
        tu.update(counts, task_id=task)
    np.testing.assert_array_equal(tu.ema, ju.ema)
    for k in (1, 3, 8):
        for task in (None, 0, 1):
            assert tu.hot(k, task) == ju.hot(k, task)
            assert TP.get_policy("elastic").prefetch_ranking(tu, k, task) \
                == JP.get_policy("elastic").prefetch_ranking(ju, k, task)
    assert tu.task_overlap() == ju.task_overlap()


@pytest.mark.parametrize("pinned", [set(), {3}, {3, 1}])
def test_victim_matches_reference(pinned):
    lru = OrderedDict([(3, 0), (1, 1), (5, 2)])
    for name in ("static", "lru", "elastic"):
        assert TP.get_policy(name).victim(lru, pinned) \
            == JP.get_policy(name).victim(lru, pinned)


# (experts, shards, EMA row, replicate factor, slots per shard)
ELASTIC = {
    "spread_hot_block": (8, 4, [40, 30, 0, 0, 0, 0, 0, 0], 100.0, 2),
    "replicate_dominant": (8, 4, [97, 1, 1, 1, 0, 0, 0, 0], 2.0, 2),
    "single_shard": (8, 1, [9] * 8, 4.0, 8),
    "no_evidence": (8, 4, [0] * 8, 4.0, 2),
    "bank_capacity": (8, 2, [8, 7, 6, 5, 4, 3, 2, 1], 100.0, 4),
}


@pytest.mark.parametrize("case", list(ELASTIC))
def test_elastic_update_matches_reference(case):
    e, m, row, factor, slots = ELASTIC[case]
    proposals = []
    for P, EC in ((JP, JEC), (TP, TEC)):
        usage = EC.ExpertUsage(e, num_tasks=1, decay=0.0)
        usage.update(row)
        pol = P.ElasticPolicy(replicate_factor=factor)
        new = pol.update(P.PlacementPlan.static(e, m), usage, np.zeros(m),
                         slots_per_shard=slots)
        proposals.append(None if new is None else _layout(new))
    assert proposals[1] == proposals[0]
