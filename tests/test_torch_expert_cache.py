"""Expert paging in the port (``repro_torch.serve.expert_cache``) against
the reference (``repro.serve.expert_cache``) and against the port's own
all-resident MoE layer, on the CPU.

* ``ExpertCache``: the same call sequence on both caches (demand paging,
  evictions, prefetch with truncation, drop, the async paths under
  adversarial ``FakeTransferEngine`` schedules) gives equal counters
  (``hits``, ``misses``, ``evictions``, ``bytes_paged``,
  ``prefetch_truncated``, the dropped ids), the same ``remap`` and
  bit-equal slot contents; pinned leaves, the oversized working set and
  the ``-1`` remap sentinel behave as the reference's.
* ``PagedMoE`` is bit-exact with the port's ``apply_moe`` (the staged
  path) at resident fraction 0.25 / 0.5 / 1.0, GELU and SwiGLU experts,
  both tasks, under the ``eager``, ``blocked`` and ``cuda`` policies (the
  kernels' plain versions on the CPU); also with shared experts, 23
  tokens in groups of 16, a route to evicted experts, and asynchronous
  paging under adversarial schedules.  Against the reference's
  ``PagedMoE`` at float32: outputs within ``rtol = atol = 1e-5`` (float32
  sums in another order, as ``tests/test_torch_core.py``) and the cache
  counters equal.
* ``M3ViTServer`` on ``SMOKE_CONFIG`` at ``resident_fraction=0.5``:
  against the reference server (float32, exact activations: outputs
  within 1e-4 × the output's max magnitude, the bound of
  ``tests/test_torch_m3vit.py``; counters equal), paged == all-resident
  bit for bit, and results of two calls stay distinct after a third.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs import m3vit as JM
from repro.core import moe as JMOE
from repro.models import vit as jvit
from repro.serve import expert_cache as JEC
from repro.serve import transfer as JT
from repro.serve import vision as JV
from repro_torch import ops
from repro_torch.bridge import params_from_jax
from repro_torch.configs import m3vit as TM
from repro_torch.core import moe as TMOE
from repro_torch.serve import expert_cache as TEC
from repro_torch.serve import transfer as TT
from repro_torch.serve.vision import M3ViTServer
from test_torch_threads import one_torch_thread  # noqa: F401


def _host(e=6, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((e, 4, 4)).astype(np.float32),
            "b": rng.standard_normal((e, 3)).astype(np.float32)}


def _counters(cache):
    s = cache.stats()
    keys = ("hits", "misses", "evictions", "bytes_paged",
            "prefetch_truncated", "prefetch_dropped", "max_resident",
            "resident_fraction", "paged_expert_bytes", "pinned_bytes",
            "async_prefetches", "inflight_joins", "async_cancelled",
            "inflight")
    return {k: s[k] for k in keys if k in s}, cache.remap().tolist(), \
        sorted(cache.resident), sorted(cache.inflight)


def _slots_agree(tcache, host):
    remap = tcache.remap()
    for e in range(len(remap)):
        if remap[e] >= 0 and e not in tcache.inflight:
            for n, w in host.items():
                np.testing.assert_array_equal(
                    tcache.slots[n][remap[e]].numpy(), w[e])


# call sequences, each a list of (method, args), run on both caches
SEQUENCES = {
    "demand_and_eviction": [("ensure", [0, 1, 2]), ("ensure", [1, 3]),
                            ("ensure", [4, 5, 0]), ("ensure", [0])],
    "prefetch_then_hit": [("prefetch", [0, 1, 2]), ("ensure", [0, 1, 2]),
                          ("ensure", [2, 5])],
    "prefetch_truncated": [("prefetch", [5, 0, 1, 2, 4]),
                           ("prefetch", [0, 1, 5, 3, 2]),
                           ("ensure", [3, 4])],
    "drop_is_not_eviction": [("ensure", [0, 1, 2]), ("drop", 1),
                             ("drop", 7), ("ensure", [0, 2]),
                             ("ensure", [4, 5])],
    "prefetch_async_without_engine": [("prefetch_async", [3, 4]),
                                      ("ensure", [3, 4, 5])],
}


@pytest.mark.parametrize("case", list(SEQUENCES))
def test_cache_counters_match_reference(case):
    host = _host()
    want = JEC.ExpertCache(host, max_resident=3)
    got = TEC.ExpertCache(host, max_resident=3, device="cpu")
    for method, arg in SEQUENCES[case]:
        assert getattr(got, method)(arg) == getattr(want, method)(arg)
        assert _counters(got) == _counters(want)
        _slots_agree(got, host)
    got.reset_stats()
    want.reset_stats()
    assert _counters(got) == _counters(want)


def test_pinned_leaves_live_on_device_untouched():
    basis = np.arange(16, dtype=np.float32).reshape(4, 4)
    host = _host()
    want = JEC.ExpertCache(host, max_resident=2, pinned={"w.basis": basis})
    got = TEC.ExpertCache(host, max_resident=2, pinned={"w.basis": basis},
                          device="cpu")
    for ids in ([0, 5], [3, 2]):       # evictions never touch pinned
        got.ensure(ids)
        want.ensure(ids)
    np.testing.assert_array_equal(got.pinned["w.basis"].numpy(), basis)
    assert _counters(got) == _counters(want)
    assert got.stats()["pinned_bytes"] == 64
    with pytest.raises(ValueError, match="pinned and paged"):
        TEC.ExpertCache(host, max_resident=2, pinned={"w": basis},
                        device="cpu")


def test_host_store_is_built_once_and_slots_are_stacked():
    host = {"w": torch.from_numpy(_host()["w"]).to(torch.bfloat16)}
    cache = TEC.ExpertCache(host, max_resident=2, device="cpu")
    assert cache.slots["w"].shape == (2, 4, 4)
    assert cache.slots["w"].dtype == torch.bfloat16
    assert not cache.host["w"].is_pinned()      # pinned only for a card
    cache.ensure([4])
    assert torch.equal(cache.slots["w"][cache.remap()[4]], host["w"][4])


def test_ensure_rejects_oversized_working_set():
    for cache in (JEC.ExpertCache(_host(), max_resident=2),
                  TEC.ExpertCache(_host(), max_resident=2, device="cpu")):
        with pytest.raises(ValueError, match="page in waves"):
            cache.ensure([0, 1, 2])


def test_remap_sentinel_for_nonresident():
    cache = TEC.ExpertCache(_host(), max_resident=2, device="cpu")
    cache.ensure([4, 1])
    remap = cache.remap()
    assert remap[4] >= 0 and remap[1] >= 0
    assert all(remap[e] == -1 for e in (0, 2, 3, 5))
    cache.ensure([5, 1])               # 5 evicts the LRU (4)
    remap = cache.remap()
    assert remap[4] == -1 and remap[5] >= 0
    table, counts = cache.replica_table()
    assert table.shape == (6, 1)
    np.testing.assert_array_equal(table[:, 0], remap)
    np.testing.assert_array_equal(counts, remap >= 0)


def _fake_pair(**kw):
    return JT.FakeTransferEngine(**kw), TT.FakeTransferEngine(device="cpu",
                                                              **kw)


# async scripts on a 3-slot cache (1 slot for "inflight_eviction"):
# (engine kwargs, [(method, args) or ("advance", dt)])
ASYNC = {
    "misprediction_demand_fallback": (
        dict(latency_s=1.0),
        [("prefetch_async", [3, 4, 5]), ("ensure", [0, 1, 2])]),
    "lands_after_the_wave_needs_it": (
        dict(latency_s=4.0),
        [("prefetch_async", [2]), ("advance", 1.0), ("ensure", [2])]),
    "inflight_eviction_never_clobbers": (
        dict(latency_s=5.0),
        [("prefetch_async", [0]), ("ensure", [1]), ("advance", 50.0),
         ("ensure", [0])]),
    "sibling_copies_overlap": (
        dict(latency_s=2.0), [("ensure", [0, 1, 2])]),
    "fence_all": (
        dict(latency_s=1.0), [("prefetch_async", [0, 1, 2]),
                              ("fence_all", None)]),
    "staggered_schedule": (
        dict(schedule={("cache", e): 0.5 * e for e in range(6)},
             wave_s=1.0),
        [("prefetch_async", [5, 4]), ("advance", 1.0), ("ensure", [4, 0]),
         ("prefetch_async", [1, 2, 3]), ("ensure", [3, 2, 1]),
         ("drop", 2), ("ensure", [5])]),
}


@pytest.mark.parametrize("case", list(ASYNC))
def test_async_cache_paths_match_reference(case):
    kw, script = ASYNC[case]
    slots = 1 if case == "inflight_eviction_never_clobbers" else 3
    host = _host()
    jeng, teng = _fake_pair(**kw)
    want = JEC.ExpertCache(host, max_resident=slots, transfer_engine=jeng)
    got = TEC.ExpertCache(host, max_resident=slots, transfer_engine=teng,
                          device="cpu")
    for method, arg in script:
        if method == "advance":
            jeng.advance(arg)
            teng.advance(arg)
            continue
        call = (lambda c: getattr(c, method)()) if arg is None \
            else (lambda c: getattr(c, method)(arg))
        assert call(got) == call(want)
        assert _counters(got) == _counters(want)
        assert teng.stats.as_dict() == jeng.stats.as_dict()
        _slots_agree(got, host)


def test_hung_transfer_raises_instead_of_deadlock():
    eng = TT.FakeTransferEngine(schedule={("cache", 0): None},
                                timeout_s=5.0, device="cpu")
    cache = TEC.ExpertCache(_host(), max_resident=2, transfer_engine=eng,
                            device="cpu")
    with pytest.raises(TT.TransferTimeout, match="cache"):
        cache.ensure([0])


# ------------------------------------------------------------- PagedMoE


def _moe_cfgs(**kw):
    base = dict(d_model=32, d_ff=64, num_experts=8, top_k=2, num_tasks=2,
                capacity_factor=2.0, group_size=64, impl="grouped",
                expert_kind="gelu")
    base.update(kw)
    return JMOE.MoEConfig(**base), TMOE.MoEConfig(**base)


@functools.lru_cache(maxsize=None)
def _moe_setup(dtype="float32", shape=(2, 50), seed=0, **kw):
    jcfg, tcfg = _moe_cfgs(**kw)
    jp = dict(JMOE.init_moe(jax.random.PRNGKey(seed), jcfg,
                            dtype=getattr(jnp, dtype)))
    x = (jax.random.normal(jax.random.PRNGKey(seed + 1),
                           shape + (jcfg.d_model,)) * 0.5).astype(
                               getattr(jnp, dtype))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    tx = params_from_jax({"x": jax.device_get(x)}, device="cpu")["x"]
    return jcfg, tcfg, jp, x, tp, tx


def _resident(tp, tcfg, tx, task, policy):
    with ops.use_policy(ops.policy_named(policy)):
        return TMOE.apply_moe(tp, tcfg, tx, task_id=task)


def _paged(paged, tx, task, policy):
    with ops.use_policy(ops.policy_named(policy)):
        return paged(tx, task_id=task)


@pytest.mark.parametrize("policy", ["eager", "blocked", "cuda"])
@pytest.mark.parametrize("frac", [0.25, 0.5, 1.0])
@pytest.mark.parametrize("kind", ["gelu", "swiglu"])
def test_paged_equals_resident(kind, frac, policy):
    _, tcfg, _, _, tp, tx = _moe_setup(dtype="bfloat16", expert_kind=kind)
    paged = TEC.PagedMoE(tp, tcfg, resident_fraction=frac, device="cpu")
    for task in (0, 1):
        ref, aux_ref = _resident(tp, tcfg, tx, task, policy)
        y, aux = _paged(paged, tx, task, policy)
        assert torch.equal(y, ref)
        assert float(aux) == pytest.approx(float(aux_ref), rel=1e-6)
    assert paged.cache.max_resident == max(2, int(np.ceil(frac * 8)))
    assert len(paged.cache.resident) <= paged.cache.max_resident


def test_paged_with_shared_experts():
    _, tcfg, _, _, tp, tx = _moe_setup(dtype="bfloat16",
                                       expert_kind="swiglu",
                                       num_shared_experts=1)
    ref, _ = _resident(tp, tcfg, tx, 1, "cuda")
    y, _ = _paged(TEC.PagedMoE(tp, tcfg, resident_fraction=0.5,
                               device="cpu"), tx, 1, "cuda")
    assert torch.equal(y, ref)


def test_paged_nondivisible_token_count():
    """23 tokens in groups of 16: the group padding mirrors apply_moe."""
    _, tcfg, _, _, tp, tx = _moe_setup(dtype="bfloat16", shape=(1, 23),
                                       group_size=16)
    ref, _ = _resident(tp, tcfg, tx, 0, "cuda")
    y, _ = _paged(TEC.PagedMoE(tp, tcfg, resident_fraction=0.5,
                               device="cpu"), tx, 0, "cuda")
    assert torch.equal(y, ref)


def _task_split_bias(tp, tcfg):
    """Disjoint per-task working sets: task 0 -> experts 0..3, task 1 ->
    4..7 (the reference tests' gate_bias hook)."""
    bias = np.full((2, tcfg.num_experts), -30.0, np.float32)
    bias[0, :4] = 0.0
    bias[1, 4:] = 0.0
    return dict(tp, gate_bias=torch.from_numpy(bias)), bias


def test_route_to_evicted_expert_stays_exact():
    _, tcfg, _, _, tp, tx = _moe_setup()
    tp, _ = _task_split_bias(tp, tcfg)
    paged = TEC.PagedMoE(tp, tcfg, resident_fraction=0.25, device="cpu")
    _paged(paged, tx, 0, "eager")       # resident ⊂ {0..3}
    _paged(paged, tx, 1, "eager")       # evicts them: resident ⊂ {4..7}
    remap = paged.cache.remap()
    assert all(remap[e] == -1 for e in range(4))
    ref, _ = _resident(tp, tcfg, tx, 0, "eager")
    y, _ = _paged(paged, tx, 0, "eager")
    assert torch.equal(y, ref)


@pytest.mark.parametrize("frac", [0.25, 0.5])
@pytest.mark.parametrize("kind", ["gelu", "swiglu"])
def test_paged_matches_reference_paged(kind, frac):
    """float32, exact activations, the same sequence of forwards and
    prefetches on both: outputs within 1e-5, cache counters and usage
    EMA equal, the same waves."""
    jcfg, tcfg, jp, x, tp, tx = _moe_setup(expert_kind=kind)
    jpaged = JEC.PagedMoE(jp, jcfg, resident_fraction=frac)
    tpaged = TEC.PagedMoE(tp, tcfg, resident_fraction=frac, device="cpu")
    for task in (0, 1, 0, 1):
        tpaged.prefetch(task)
        jpaged.prefetch(task)
        with jops.use_policy(jops.policy_named("xla")):
            yj, auxj = jpaged(x, task_id=task)
        yt, auxt = _paged(tpaged, tx, task, "eager")
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                                   atol=1e-5)
        assert float(auxt) == pytest.approx(float(auxj), rel=1e-5, abs=1e-6)
        assert _counters(tpaged.cache) == _counters(jpaged.cache)
        assert tpaged.last_timeline == jpaged.last_timeline
        np.testing.assert_array_equal(tpaged.usage.totals,
                                      jpaged.usage.totals)
        assert tpaged.predict(task) == jpaged.predict(task)


_PAIR = None


def _paged_pair():
    """One sync and one async PagedMoE over the same params, built once:
    the schedules below run against carried-over cache state."""
    global _PAIR
    if _PAIR is None:
        _, tcfg, _, _, tp, tx = _moe_setup()
        eng = TT.FakeTransferEngine(timeout_s=1e9, device="cpu")
        sync = TEC.PagedMoE(tp, tcfg, resident_fraction=0.25, device="cpu")
        async_ = TEC.PagedMoE(tp, tcfg, resident_fraction=0.25,
                              transfer_engine=eng, device="cpu")
        _PAIR = (tcfg, tp, tx, sync, async_, eng)
    return _PAIR


# per-expert latencies (cycled over the experts) and the wave's worth of
# virtual time: instant, staggered, all slow, one hot link, and the rest
SCHEDULES = [([0.0], 0.0), ([0.5 * e for e in range(8)], 1.0),
             ([20.0], 1.0), ([0.0, 5.0, 0.1], 0.3), ([3.0, 0.0], 2.5),
             ([1.0, 2.0, 4.0, 0.5], 0.0)]


@pytest.mark.parametrize("i", range(len(SCHEDULES)))
def test_async_bit_identical_to_sync(i):
    """Whatever lands when, async output == sync output == all-resident,
    bit for bit; cache state carries over between schedules."""
    tcfg, tp, tx, sync, async_, eng = _paged_pair()
    latencies, wave_s = SCHEDULES[i]
    eng.schedule = {("cache", e): latencies[e % len(latencies)]
                    for e in range(tcfg.num_experts)}
    eng.wave_s = wave_s
    for task in (0, 1):
        ys, _ = _paged(sync, tx, task, "eager")
        ya, _ = _paged(async_, tx, task, "eager")
        ref, _ = _resident(tp, tcfg, tx, task, "eager")
        assert torch.equal(ya, ys) and torch.equal(ys, ref)
    assert async_.cache.inflight == []


def test_async_prefetch_hides_copies_as_the_reference():
    """Accurate lookahead: every copy of the forward was submitted ahead,
    so the stall is zero and the counters equal the reference's."""
    jcfg, tcfg, jp, x, tp, tx = _moe_setup()
    tp, bias = _task_split_bias(tp, tcfg)
    jp = dict(jp, gate_bias=jnp.asarray(bias))
    jeng, teng = _fake_pair(latency_s=1.0, timeout_s=1e9)
    jpaged = JEC.PagedMoE(jp, jcfg, resident_fraction=0.5,
                          transfer_engine=jeng)
    tpaged = TEC.PagedMoE(tp, tcfg, resident_fraction=0.5,
                          transfer_engine=teng, device="cpu")
    for task in (0, 1):
        with jops.use_policy(jops.policy_named("xla")):
            jpaged(x, task_id=task)
        _paged(tpaged, tx, task, "eager")
    for p, eng in ((jpaged, jeng), (tpaged, teng)):
        p.cache.reset_stats()
        eng.reset_stats()
        p.prefetch(0)
        eng.advance(2.0)
    with jops.use_policy(jops.policy_named("xla")):
        jpaged(x, task_id=0)
    y, _ = _paged(tpaged, tx, 0, "eager")
    assert torch.equal(y, _resident(tp, tcfg, tx, 0, "eager")[0])
    assert _counters(tpaged.cache) == _counters(jpaged.cache)
    assert teng.stats.as_dict() == jeng.stats.as_dict()
    assert teng.stats.stall_s == 0.0 and tpaged.cache.hits == 4


def test_paged_refuses_what_later_slices_port():
    """A mesh (queue 1 item 6a, ported) pages expert-parallel: at a mesh
    of one, one shard, bit for bit with one device and the resident layer
    (``tests/test_torch_dist.py`` holds 2 and 4 shards); a mesh with no
    ``model`` axis is refused.  Packed leaves (item 3, ported) page as
    their packed tensors; ``onehot`` (the reference pages it) pages
    through the same gather as ``grouped``, bit for bit, and equals the
    resident layer."""
    from types import SimpleNamespace

    from _torch_mesh import mesh_of_one

    _, tcfg, _, _, tp, tx = _moe_setup()
    with pytest.raises(ValueError, match="no 'model' axis"):
        TEC.PagedMoE(tp, tcfg, device="cpu", mesh=SimpleNamespace(
            shape={"data": 1}, axis_names=("data",)))
    ep = TEC.PagedMoE(tp, tcfg, resident_fraction=0.5, mesh=mesh_of_one(),
                      device="cpu")
    assert isinstance(ep.cache, TEC.ShardedExpertCache)
    for task in (0, 1):
        y, aux = _paged(ep, tx, task, "eager")
        ref, aux_ref = _resident(tp, tcfg, tx, task, "eager")
        assert torch.equal(y, ref) and torch.equal(aux, aux_ref)
    st = ep.cache.stats()
    assert st["num_shards"] == 1 and st["shard_load_imbalance"] == 1.0
    from repro_torch.quant import quantize_tree

    packed = TEC.PagedMoE(quantize_tree(tp), tcfg, device="cpu")
    assert packed.cache.names == ("w1.q", "w1.scale", "b1", "w2.q",
                                  "w2.scale", "b2")
    ocfg = replace(tcfg, impl="onehot")
    onehot = TEC.PagedMoE(tp, ocfg, resident_fraction=0.25, device="cpu")
    grouped = TEC.PagedMoE(tp, tcfg, resident_fraction=0.25, device="cpu")
    for task in (0, 1):
        y, _ = _paged(onehot, tx, task, "eager")
        assert torch.equal(y, _paged(grouped, tx, task, "eager")[0])
        assert torch.equal(y, _resident(tp, ocfg, tx, task, "eager")[0])


# ---------------------------------------------------------- M3ViTServer


def _images(b=2, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, TM.IMAGE_H, TM.IMAGE_W, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _servers():
    """SMOKE_CONFIG at float32 with exact activations, paged at 0.5 on
    both sides, plus the port's all-resident server."""
    jcfg = replace(JM.SMOKE_CONFIG, dtype="float32",
                   policy=jops.policy_named("xla"))
    tcfg = replace(TM.SMOKE_CONFIG, dtype="float32",
                   policy=ops.policy_named("eager"))
    jparams = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return (JV.M3ViTServer(jcfg, jparams, resident_fraction=0.5),
            M3ViTServer(tcfg, tparams, resident_fraction=0.5, device="cpu"),
            M3ViTServer(tcfg, tparams, device="cpu"))


def test_server_paged_matches_reference_server():
    jserver, tserver, _ = _servers()
    img = _images()
    jserver.reset_stats()
    tserver.reset_stats()
    for task in TM.TASKS:
        want = jserver.infer(img, task)
        got = tserver.infer(img, task)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    want_s, got_s = jserver.cache_stats(), tserver.cache_stats()
    for k in ("hits", "misses", "evictions", "bytes_paged", "hit_rate",
              "resident_fraction"):
        assert got_s[k] == want_s[k], k
    assert got_s["bytes_paged"] > 0 and got_s["resident_fraction"] == 0.5


def test_server_paged_equals_all_resident():
    _, tserver, resident = _servers()
    img = _images(3, seed=2)
    for task in TM.TASKS:
        assert np.array_equal(tserver.infer(img, task),
                              resident.infer(img, task))
    assert resident.paged == {} and len(tserver.paged) > 0


def test_server_results_stay_distinct():
    """Each call's result lives in host memory of its own: a third call
    leaves the first two as they were."""
    _, tserver, _ = _servers()
    a = tserver.infer(_images(seed=3), "semseg")
    a_copy = a.copy()
    b = tserver.infer(_images(seed=4), "semseg")
    tserver.infer(_images(seed=5), "semseg")
    assert np.array_equal(a, a_copy) and not np.array_equal(a, b)
    assert not np.shares_memory(a, b)


def test_server_refuses_what_later_slices_port():
    """Meshes (queue 1 item 6a, ported) serve: under rules or an
    ``ep_mesh`` of one the MoE layers page expert-parallel and the
    predictions equal the all-resident server's bit for bit, with
    ``shard_load`` in the stats; factored experts (item 3, ported) factor
    every MoE layer, and an unknown factor kind is refused."""
    from _torch_mesh import mesh_of_one, rules_of_one

    _, tserver, _ = _servers()
    imgs = _images()
    want = tserver.infer(imgs, "semseg")
    for kw in (dict(rules=rules_of_one(fsdp=False)),
               dict(ep_mesh=mesh_of_one())):
        mesh = M3ViTServer(tserver.cfg, tserver.params, device="cpu", **kw)
        assert mesh.paged
        np.testing.assert_array_equal(mesh.infer(imgs, "semseg"), want)
        assert mesh.cache_stats()["shard_load"][0] > 0
    from repro_torch.factor import is_factored

    server = M3ViTServer(tserver.cfg, tserver.params, device="cpu",
                         factor=("rank", 4, 8))
    moe = [lp["moe"] for lp in server.layer_params if "moe" in lp]
    assert moe and all(is_factored(m["w1"]) and is_factored(m["w2"])
                       for m in moe)
    with pytest.raises(ValueError, match="kind"):
        M3ViTServer(tserver.cfg, tserver.params, device="cpu",
                    factor=("lowrank", 4, 8))
