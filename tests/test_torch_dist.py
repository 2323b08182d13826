"""Mesh serving of the port on the CPU: gloo worlds of 2 and 4 ranks, one
spawned process a rank (``tests/_torch_dist_worker.py``), rendezvous
through a ``FileStore`` under ``tmp_path`` (never a fixed port: the suite
runs in parallel workers).  One spawn per mesh shape runs every check:

  * ``ep_local`` == ``grouped`` at float32 2e-5 with gradients finite and
    nonzero (the reference's ``tests/test_moe_ep.py``);
  * a grouped MoE on a rank's rows of a data-split batch == the layer on
    the whole batch, bit for bit (a mesh equals no mesh), routing groups
    inside, across and straddling ranks, only the router's logits moved;
  * expert-parallel ``PagedMoE`` through ``ShardedExpertCache`` ==
    ``apply_moe`` bit for bit, float32/bf16/int8/int4 (the reference's
    stated claim, ``tests/test_serve_dist.py``);
  * ``ServingEngine`` and ``Scheduler`` greedy tokens == no mesh;
  * ``M3ViTServer``: ``ep_mesh`` bit for bit, ``rules`` within the
    reference's 2e-3;
  * the reference's sharded placement cases (``tests/test_placement.py``):
    skewed static and elastic placement bit for bit, migrations tagged
    ``migrate``.

In process: the port's ``ep_local`` at a mesh of one against the
reference's ``ep_local`` at ``jax.make_mesh((1, 1))`` (a green oracle)."""

import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_worker as W
from repro.core import moe as JM
from repro.dist.sharding import ShardingRules as JRules
from repro.dist.sharding import use_rules as juse_rules
from repro_torch import ops
from repro_torch.bridge import params_from_jax
from repro_torch.core import moe as TM
from repro_torch.dist.sharding import use_rules
from test_torch_threads import one_torch_thread  # noqa: F401

ALL = ("ep_local", "split", "paged", "placement", "engine", "scheduler",
       "vision")


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_world(shape, tmp_path):
    world = shape[0] * shape[1]
    mp.start_processes(W.run, args=(world, shape,
                                    os.path.join(tmp_path, "store"), ALL),
                       nprocs=world, start_method="spawn")


@pytest.mark.parametrize("kind", ["gelu", "swiglu"])
def test_ep_local_at_a_mesh_of_one_matches_the_reference(kind):
    """The port's ``ep_local`` under rules over a (1, 1) mesh against the
    reference's at ``jax.make_mesh((1, 1))``, float32 2e-5; the port's
    one all-reduce over ``model`` is recorded."""
    from _torch_mesh import rules_of_one

    jcfg = JM.MoEConfig(d_model=32, d_ff=64, num_experts=4, top_k=2,
                        capacity_factor=4.0, group_size=64,
                        impl="ep_local", expert_kind=kind)
    jp = JM.init_moe(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(2, 32, 32)).astype(
        np.float32)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with juse_rules(JRules.for_mesh(mesh)):
        yj, aj = jax.jit(lambda p, x: JM.apply_moe(p, jcfg, x))(
            jp, jnp.asarray(x))
    tcfg = TM.MoEConfig(**{f: getattr(jcfg, f) for f in (
        "d_model", "d_ff", "num_experts", "top_k", "capacity_factor",
        "group_size", "impl", "expert_kind")})
    tp = params_from_jax(jax.device_get(dict(jp)), device="cpu")
    ops.reset_dispatch_report()
    with use_rules(rules_of_one()):
        yt, at = TM.apply_moe(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=W.EP_TOL,
                               rtol=W.EP_TOL)
    assert float(at) == pytest.approx(float(aj), rel=1e-5)
    (red,) = ops.collective_report()
    assert (red["kind"], red["axis"], red["count"]) == ("all_reduce",
                                                        "model", 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("kind", ["gelu", "swiglu"])
def test_ep_local_at_a_mesh_of_one_is_grouped_bit_for_bit(kind, dtype):
    """One expert shard: the float32 partial rounded once gives
    ``grouped``'s bits (a mesh of one equals no mesh)."""
    from _torch_mesh import rules_of_one

    cfg = W._moe_cfg(kind, impl="ep_local")
    params = TM.init_moe(np.random.default_rng(0), cfg, dtype=dtype)
    x = W._x((2, 50, 32), dtype, scale=0.5)
    for task in (0, 1):
        want = TM.apply_moe(params, replace(cfg, impl="grouped"), x,
                            task_id=task)
        with use_rules(rules_of_one()):
            got = TM.apply_moe(params, cfg, x, task_id=task)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                            want[1])


def test_sharded_reset_stats_clears_books_and_load():
    """The reference's ``tests/test_placement.py`` case at a mesh of one:
    every shard book (dropped ids too) and the load ledger reset; the
    placement history is cumulative."""
    from _torch_mesh import mesh_of_one
    from repro_torch.serve.expert_cache import ShardedExpertCache

    host = {"w": np.random.default_rng(0).standard_normal(
        (8, 4, 4)).astype(np.float32)}
    cache = ShardedExpertCache(host, 2, mesh_of_one(), device="cpu")
    cache.prefetch(range(8))
    assert cache.prefetch_truncated == 6
    cache.record_load([4, 0, 0, 0, 0, 0, 0, 0])
    assert cache.shard_load_imbalance() == 1.0
    cache.reset_stats()
    assert cache.prefetch_truncated == 0
    assert all(not b.prefetch_dropped for b in cache.books)
    assert cache.shard_load.sum() == 0.0
    assert cache.shard_load_imbalance() == 0.0


@pytest.mark.parametrize("group,seq", [(16, 16), (256, 16), (48, 10)],
                         ids=["inside", "whole", "padded"])
@pytest.mark.parametrize("task", ["scalar", "vector"])
def test_split_routing_of_one_shard_is_the_layer(group, seq, task):
    """``route_split`` with the whole batch on one shard (the split marked
    by hand: ``batch_split`` marks none at one shard) gives the unsplit
    layer's output, aux and counts bit for bit — every routing group in
    one local queue set of ``groups × capacity`` rows, the last group
    zero-padded — and records its one gather of the router's logits."""
    from _torch_mesh import rules_of_one
    from repro_torch.dist import spmd

    cfg = replace(W._moe_cfg("swiglu", cf=0.5), group_size=group)
    params = TM.init_moe(np.random.default_rng(0), cfg,
                         dtype=torch.float32)
    x = W._x((8, seq, 32), scale=0.5)
    t = 1 if task == "scalar" else torch.tensor([0, 1, 1, 0, 1, 0, 0, 1])
    want = TM.apply_moe(params, cfg, x, t, return_stats=True)
    ops.reset_dispatch_report()
    mark = spmd._SPLIT.set((rules_of_one(), 8))
    try:
        got = TM.apply_moe(params, cfg, x, t, return_stats=True)
    finally:
        spmd._SPLIT.reset(mark)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    where = {c["where"] for c in ops.collective_report()}
    assert "moe gate logits" in where
