"""The ranks of ``tests/test_torch_dist.py``: one spawned process a rank
of a gloo world, rendezvous through a ``FileStore``, one torch thread.
Every check holds the mesh run against the same run with no mesh (or the
reference's stated tolerance), with inputs made from seeds with NumPy.
Imports torch, NumPy and the port only."""

from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import ops
from repro_torch.configs import get
from repro_torch.core import moe as M
from repro_torch.dist import spmd
from repro_torch.dist.sharding import ShardingRules, use_rules

EP_TOL = 2e-5       # ep_local vs grouped, float32 (tests/test_moe_ep.py)
VISION_TOL = 2e-3   # test_serve_dist.py::test_vision_server_sharded_matches


def _moe_cfg(kind="swiglu", **kw):
    return M.MoEConfig(d_model=32, d_ff=64, num_experts=8, top_k=2,
                       num_tasks=2, capacity_factor=kw.pop("cf", 4.0),
                       group_size=64, impl=kw.pop("impl", "grouped"),
                       expert_kind=kind, **kw)


def _x(shape, dtype=torch.float32, seed=1, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(a * np.float32(scale)).to(dtype)


def check_ep_local(mesh):
    """ep_local == grouped at float32 2e-5 (aux within 1e-5), each rank
    narrowing the full expert stacks to its own; gradients finite and
    nonzero."""
    cfg = _moe_cfg(impl="ep_local")
    params = M.init_moe(np.random.default_rng(0), cfg, dtype=torch.float32)
    x = _x((4, 32, 32))
    rules = ShardingRules.for_mesh(mesh)
    rows = spmd.batch_rows(4, rules)
    y_ref, a_ref = M.apply_moe(params, replace(cfg, impl="grouped"), x)
    with use_rules(rules):
        y, a = M.apply_moe(params, cfg, x[rows])
    torch.testing.assert_close(y, y_ref[rows], atol=EP_TOL, rtol=EP_TOL)
    assert abs(float(a) - float(a_ref)) < 1e-5, (float(a), float(a_ref))
    grad = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    with use_rules(rules):
        y, _ = M.apply_moe(grad, cfg, x[rows])
    y.sum().backward()
    for k, v in grad.items():
        assert torch.isfinite(v.grad).all(), k
    assert float(grad["wg"].grad.abs().max()) > 0
    kinds = {c["kind"] for c in ops.collective_report()}
    assert "all_reduce" in kinds


def check_split(mesh):
    """A grouped MoE on this rank's rows of a data-split batch
    (``spmd.batch_split``) == the layer on the whole batch, bit for bit:
    routing groups inside a rank, spanning ranks, and straddling a rank
    boundary; scalar and per-sequence tasks; the dispatch counts and the
    auxiliary loss the whole batch's; float32 and bf16; and the paged
    layer likewise.  Only the router's logits cross ranks, never the
    tokens."""
    from repro_torch.serve.expert_cache import PagedMoE

    if spmd.axis_size(mesh, "data") == 1:   # split the batch all ways
        mesh = spmd.init_mesh((spmd.axis_size(mesh, "model"), 1),
                              device_type="cpu")
    rules = ShardingRules.for_mesh(mesh, fsdp=False)
    shards = spmd.batch_shard(8, rules)[0]
    rows = spmd.batch_rows(8, rules)
    assert shards > 1
    dropped = 0
    # group 16: inside a rank; 256: the whole batch; 48 over 8 x 10
    # tokens: groups straddling rank boundaries, the last one padded
    for group, seq in ((16, 16), (256, 16), (48, 10)):
        for dtype in (torch.float32, torch.bfloat16):
            cfg = replace(_moe_cfg("swiglu", cf=0.5), group_size=group)
            params = M.init_moe(np.random.default_rng(0), cfg, dtype=dtype)
            x = _x((8, seq, 32), dtype, scale=0.5)
            for task in (1, torch.tensor([0, 1, 1, 0, 1, 0, 0, 1])):
                want = M.apply_moe(params, cfg, x, task, return_stats=True)
                t_loc = task if isinstance(task, int) else task[rows]
                ops.reset_dispatch_report()
                with spmd.batch_split(rules, 8):
                    got = M.apply_moe(params, cfg, x[rows], t_loc,
                                      return_stats=True)
                what = (group, dtype, task)
                assert torch.equal(got[0], want[0][rows]), what
                assert torch.equal(got[1], want[1]), what
                assert torch.equal(got[2], want[2]), what
                dropped += 8 * seq * cfg.top_k - int(want[2].sum())
                moved = {c["where"] for c in ops.collective_report()}
                if shards > 1:
                    assert "moe gate logits" in moved, moved
                assert not any("token" in w for w in moved), moved
            if dtype != torch.float32 or isinstance(task, torch.Tensor):
                continue
            want = M.apply_moe(params, cfg, x, 0)
            paged = PagedMoE(params, cfg, resident_fraction=0.5,
                             device="cpu")
            with spmd.batch_split(rules, 8):
                y, aux = paged(x[rows], task_id=0)
            assert torch.equal(y, want[0][rows]), group
            assert torch.equal(aux, want[1]), group
    assert dropped > 0          # capacity drops were exercised


def check_paged(mesh):
    """Expert-parallel PagedMoE == apply_moe bit for bit: float32, bf16,
    int8 and int4 experts, both kinds, both tasks; per-shard banks."""
    from repro_torch.quant import quantize_tree
    from repro_torch.serve.expert_cache import PagedMoE

    m = spmd.axis_size(mesh, "model")
    for kind in ("gelu", "swiglu"):
        for dtype in (torch.float32, torch.bfloat16):
            cfg = _moe_cfg(kind, cf=2.0)
            params = M.init_moe(np.random.default_rng(0), cfg, dtype=dtype)
            x = _x((2, 50, 32), dtype, scale=0.5)
            for task in (0, 1):
                ref, aref = M.apply_moe(params, cfg, x, task_id=task)
                paged = PagedMoE(params, cfg, resident_fraction=0.5,
                                 mesh=mesh, device="cpu")
                y, aux = paged(x, task_id=task)
                assert torch.equal(y, ref), (kind, dtype, task)
                assert abs(float(aux) - float(aref)) < 1e-6
                s = paged.cache.stats()
                assert s["num_shards"] == m
                assert s["max_resident"] <= cfg.num_experts // m
    cfg = _moe_cfg("swiglu", cf=2.0)
    params = M.init_moe(np.random.default_rng(0), cfg, dtype=torch.float32)
    x = _x((2, 50, 32), scale=0.5)
    for bits in (8, 4):
        q = quantize_tree(dict(params), bits=bits)
        with ops.use_policy(ops.policy_named("eager_int8")):
            ref, _ = M.apply_moe(q, cfg, x, task_id=0)
            y, _ = PagedMoE(q, cfg, resident_fraction=0.5, mesh=mesh,
                            device="cpu")(x, task_id=0)
        assert torch.equal(y, ref), bits


def check_placement(mesh):
    """The reference's sharded placement cases (``tests/test_placement.py``):
    80/20-skewed routing under the static plan bit for bit with the load
    on shard 0; elastic placement under skew, live plan swaps (migration,
    replication) bit for bit across forwards with the load spread; and a
    plan swap's page-ins tagged ``migrate`` in this rank's transfer
    ledger, fenced at the next use."""
    from repro_torch.serve.expert_cache import PagedMoE, ShardedExpertCache
    from repro_torch.serve.placement import ElasticPolicy, PlacementPlan
    from repro_torch.serve.transfer import FakeTransferEngine

    m = spmd.axis_size(mesh, "model")
    cfg = replace(_moe_cfg("swiglu", cf=2.0), num_tasks=1)
    params = M.init_moe(np.random.default_rng(0), cfg, dtype=torch.float32)
    bias = np.full((1, 8), -40.0, np.float32)
    bias[0, :2] = 0.0
    skewed = dict(params, gate_bias=torch.from_numpy(bias))
    x = _x((2, 50, 32), scale=0.5)
    ref, aref = M.apply_moe(skewed, cfg, x, task_id=0)
    paged = PagedMoE(skewed, cfg, resident_fraction=0.5, mesh=mesh,
                     placement="static", device="cpu")
    y, aux = paged(x, task_id=0)
    assert torch.equal(y, ref) and abs(float(aux) - float(aref)) < 1e-6
    s = paged.cache.stats()
    assert (s["placement"]["policy"], s["placement"]["generation"],
            s["placement"]["plan_swaps"]) == ("static", 0, 0)
    load = np.asarray(s["shard_load"])
    assert load.shape == (m,) and load[0] > 0.9 * load.sum(), load
    assert s["shard_load_imbalance"] > 0.9 * m

    cfg = replace(cfg, capacity_factor=4.0)
    params = M.init_moe(np.random.default_rng(0), cfg, dtype=torch.float32)
    bias = np.full((1, 8), -40.0, np.float32)
    bias[0, 0] = 0.0
    bias[0, 1:3] = -2.0
    params = dict(params, gate_bias=torch.from_numpy(bias))
    xs = [_x((2, 50, 32), seed=7 + i, scale=0.5) for i in range(6)]
    paged = PagedMoE(params, cfg, resident_fraction=0.5, mesh=mesh,
                     device="cpu", placement=ElasticPolicy(
                         rebalance_every=2, replicate_factor=1.2))
    for i, xi in enumerate(xs):
        y, _ = paged(xi, task_id=0)
        assert torch.equal(y, M.apply_moe(params, cfg, xi)[0]), i
    s = paged.cache.stats()
    p = s["placement"]
    assert p["policy"] == "elastic" and p["plan_swaps"] >= 1, p
    assert p["generation"] >= 1 and p["migrations"] >= 1, p
    assert p["max_replicas"] >= 2 and p["replications"] >= 1, p
    assert p["table_width"] == m
    assert s["shard_load_imbalance"] < 0.75 * m, s

    if m != 2:
        return
    rng = np.random.default_rng(0)
    host = {"w": rng.standard_normal((8, 4, 4)).astype(np.float32)}
    eng = FakeTransferEngine(latency_s=0.05, timeout_s=5.0, device="cpu")
    cache = ShardedExpertCache(host, 8, mesh, transfer_engine=eng,
                               policy=ElasticPolicy(),
                               plan=PlacementPlan.static(8, 2),
                               device="cpu")
    cache.ensure(range(8))
    assert sorted(cache.resident) == list(range(8))
    assert eng.stats.tags_dict()["demand"]["submitted"] == 4  # own shard
    reps = [(0, 1)] + [(0,) if e < 4 else (1,) for e in range(1, 8)]
    reps[7] = (0,)
    cache.set_plan(cache.plan.evolve(tuple(reps)))
    assert (cache.plan.generation, cache.migrations, cache.migration_drops,
            cache.replications) == (1, 2, 1, 1)
    tags = eng.stats.tags_dict()
    # rank 0 pages expert 7 in, rank 1 expert 0's replica: one each
    assert tags["migrate"]["submitted"] == 1 and \
        tags["migrate"]["fenced"] == 0, tags
    cache.ensure(range(8))
    assert eng.stats.tags_dict()["migrate"]["fenced"] == 1
    table, counts = cache.replica_table()
    assert counts[0] == 2 and counts[7] == 1 and (counts[1:7] == 1).all()


def _lm(arch, **over):
    from repro_torch.models import model as TM

    cfg = replace(get(arch, smoke=True), dtype="float32", **over)
    return cfg, TM.init_params(1, cfg, device="cpu")


def check_engine(mesh):
    """Greedy tokens of the mesh-sharded ServingEngine == no mesh."""
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    rules = ShardingRules.for_mesh(mesh, fsdp=False)
    for arch in ("llama3_2_1b", "kimi_k2_1t_a32b"):
        cfg, params = _lm(arch)
        prompts = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (4, 8))
        scfg = ServeConfig(max_len=32)
        ref = ServingEngine(cfg, params, scfg, device="cpu").generate(
            prompts, 6)
        out = ServingEngine(cfg, params, scfg, rules=rules,
                            device="cpu").generate(prompts, 6)
        np.testing.assert_array_equal(out, ref, err_msg=arch)
    # ep_local: each rank keeps E/|model| experts; with the batch whole on
    # every rank (no data split: the reference's shard_map routes each
    # data shard's own groups) the greedy tokens are grouped's
    ep = replace(cfg, moe=replace(cfg.moe, impl="ep_local"))
    eng = ServingEngine(ep, params, scfg, rules=rules, device="cpu")
    m = spmd.axis_size(mesh, "model")
    wd = eng.params["layers.b0.moe.wd"]
    assert wd.shape[1] == cfg.moe.num_experts // m, wd.shape
    if spmd.axis_size(mesh, "data") == 1:
        np.testing.assert_array_equal(eng.generate(prompts, 6), ref)
    # a state's leaves cut at their own batch axes, as the trimmed spec
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import shard_state, state_batch_axes
    from repro_torch.tree import flatten

    axes = state_batch_axes(cfg, 32)
    full = TM.init_state(cfg, 4, 32, device="cpu")
    for v in flatten(full).values():
        v.copy_(torch.arange(v.numel()).reshape(v.shape))
    mine = flatten(shard_state(full, cfg, rules, axes))
    rows = spmd.batch_rows(4, rules)
    for (name, v), ax in zip(flatten(full).items(), axes):
        assert torch.equal(mine[name], v.narrow(
            ax, rows.start, rows.stop - rows.start)), name


def check_scheduler(mesh):
    """Mixed-task continuous batching on the mesh: every request's greedy
    tokens == the unmeshed scheduler's.  The smoke MoE LM gets a second
    gating task, so tasks 0 and 1 gate differently (the reference's test
    sends task 1 to a one-task gate, which JAX's clamped index serves as
    task 0 and the port refuses)."""
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.scheduler import LMBackend, Request, Scheduler

    cfg, params = _lm("kimi_k2_1t_a32b", num_tasks=2)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (6, 8))

    def serve(rules):
        backend = LMBackend(cfg, params, ServeConfig(max_len=48),
                            rules=rules, device="cpu")
        sched = Scheduler(backend, total_slots=4, quantum=3,
                          num_tasks=backend.num_tasks)
        done = sched.run([Request(rid=i, task_id=i % 2, prompt=prompts[i],
                                  max_new_tokens=5 + (i % 3))
                          for i in range(6)])
        return {r.rid: list(r.tokens) for r in done}

    assert serve(ShardingRules.for_mesh(mesh, fsdp=False)) == serve(None)


def check_vision(mesh):
    """M³ViT over the mesh: the hybrid ``ep_mesh`` bit for bit with one
    device, full rules within the reference's 2e-3."""
    from repro_torch.configs import m3vit as MV
    from repro_torch.models import vit as V
    from repro_torch.serve.vision import M3ViTServer

    cfg = replace(MV.SMOKE_CONFIG, dtype="float32")
    params = V.init_params(0, cfg, device="cpu")
    imgs = _x((2, MV.IMAGE_H, MV.IMAGE_W, 3)).numpy()
    ref = M3ViTServer(cfg, params, resident_fraction=0.5, device="cpu")
    hybrid = M3ViTServer(cfg, params, resident_fraction=0.5, ep_mesh=mesh,
                         device="cpu")
    full = M3ViTServer(cfg, params, resident_fraction=0.5, device="cpu",
                       rules=ShardingRules.for_mesh(mesh, fsdp=False))
    for task in ("semseg", "depth"):
        a = ref.infer(imgs, task)
        np.testing.assert_array_equal(a, hybrid.infer(imgs, task),
                                      err_msg=f"{task} ep_mesh")
        np.testing.assert_allclose(a, full.infer(imgs, task),
                                   atol=VISION_TOL, rtol=VISION_TOL,
                                   err_msg=f"{task} full rules")
    st = full.cache_stats()
    assert len(st["shard_load"]) == spmd.axis_size(mesh, "model")


CHECKS = {"ep_local": check_ep_local, "split": check_split,
          "paged": check_paged,
          "placement": check_placement,
          "engine": check_engine, "scheduler": check_scheduler,
          "vision": check_vision}


def run(rank, world, shape, store, checks):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        mesh = spmd.init_mesh(shape, device_type="cpu")
        for name in checks:
            ops.reset_dispatch_report()
            CHECKS[name](mesh)
        dist.barrier()
    finally:
        dist.destroy_process_group()
