"""Tensor-parallel serving of the port on the CPU (gloo, smoke sizes):
the dense blocks split over ``model`` as the reference's table lays them
out (``src/repro/dist/sharding.py``), and parking a lane of a bucket split
over the data axes.

In process, on a device-free mesh and ``meta`` tensors at full size: a
serving rank's block of every leaf of Llama-3.2-1B, DeepSeek-67B, M³ViT
and Llama-4-Scout (grouped and ``ep_local``) equals the block of the
reference's trimmed spec over ``model`` (the data axes stay whole in
serving), but for the documented whole leaves: the recurrent mixers, the
attention of a layer whose heads do not divide the axis (k/v alone where
only the KV heads do not), and the expert stacks of an impl that routes
to every expert on every rank.  A column block of ``unified_linear``,
summed in the whole weight's order (``order_n``), gives the whole
product's columns bit for bit, and a row block's float32 partials add up
to the whole product within the float32 tolerance.

Spawned gloo worlds at (1, 2), (1, 4), (2, 2) and (2, 1), one process a
rank (``tests/_torch_tp_worker.py``): the forward against no mesh (each
dense block within the bf16 tolerance of ``kernels/compare.py``, the
logits at cosine >= ``SERVE_COSINE``, float32 greedy tokens equal; bit
for bit at (2, 1)), the collectives by ``where``, a rank's blocks and its
KV heads, the per-rank draw against the narrowed whole draw, the
vocab-parallel embedding bit for bit, M³ViT's and MQA's layouts, and
tiered preemption over a split bucket (bit for bit with the unmeshed
scheduler at (2, 1); under tensor parallelism the same mesh's tokens
with no preemption)."""

import functools
import os
import re
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_tp_worker as W
from repro.dist import sharding as JS
from repro_torch import configs as tconfigs
from repro_torch import ops
from repro_torch.core.unified_linear import unified_linear
from repro_torch.dist.sharding import ShardingRules, _path_str
from repro_torch.dist.spmd import VirtualMesh
from repro_torch.kernels.compare import within_tolerance
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.serve.engine import local_params
from test_torch_threads import one_torch_thread  # noqa: F401

MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
ARCHS = ("llama3_2_1b", "deepseek_67b", "m3vit", "llama4_scout_17b_a16e")
MIXERS = re.compile(r"(rglru|mlstm|slstm)/")
EXPERTS = re.compile(r"moe/(wg|wu|wd|w1|w2|b1|b2)$")


@functools.lru_cache(maxsize=None)
def _shapes(arch, ep_local=False):
    cfg = tconfigs.get(arch)
    if ep_local:
        cfg = replace(cfg, moe=replace(cfg.moe, impl="ep_local"))
    return cfg, TM.param_specs(cfg)


def _reference_block(path, shape, ref_rules, sizes):
    """The block of the reference's trimmed spec over ``model`` alone."""
    spec = JS._match_param_spec(path, shape, ref_rules)
    return tuple(d // sizes["model"] if e == "model" or (
        isinstance(e, tuple) and "model" in e) else d
        for d, e in zip(shape, spec))


def _whole_here(path, cfg, tp) -> bool:
    """The documented leaves a serving rank keeps whole."""
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    q_split = hq % tp == 0 and (hkv % tp == 0 or (hq // hkv) % (hq // tp)
                                == 0)
    if MIXERS.search(path):
        return True
    if re.search(r"attn/(wq|bq|wo)$", path):
        return not q_split
    if re.search(r"attn/(wk|wv|bk|bv)$", path):
        return not (q_split and hkv % tp == 0)
    return bool(EXPERTS.search(path)) and cfg.moe.impl != "ep_local"


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,ep_local", [(a, False) for a in ARCHS]
                         + [("llama4_scout_17b_a16e", True)],
                         ids=list(ARCHS) + ["llama4_scout_ep_local"])
def test_block_shapes_are_the_reference_spec_blocks(arch, ep_local, mesh):
    cfg, shapes = _shapes(arch, ep_local)
    vmesh = VirtualMesh(MESHES[mesh], ("data", "model"))
    stub = SimpleNamespace(shape=dict(zip(("data", "model"), MESHES[mesh])),
                           axis_names=("data", "model"))
    ref_rules = JS.ShardingRules.for_mesh(stub)
    tp = MESHES[mesh][1]
    held = local_params(shapes, cfg, ShardingRules.for_mesh(vmesh))
    kept = 0
    for name, t in shapes.items():
        path = _path_str(name)
        whole = tuple(t.shape)
        got = tuple(held[name].shape)
        if _whole_here(path, cfg, tp):
            assert got == whole, (arch, path, got)
            kept += 1
        else:
            assert got == _reference_block(path, whole, ref_rules,
                                           stub.shape), (arch, path, got)
    if arch == "m3vit":
        # both blocks' wq/wk/wv/wo (3 heads) and the expert stack's four
        # leaves, each stacked over the periods
        assert kept == 2 * 4 + 4
    if arch == "deepseek_67b":
        assert kept == 0                     # every dense leaf splits


def test_attention_layouts_of_the_named_configs():
    """Split q and KV heads where both divide; k/v whole where only q
    does (each rank's q heads in one GQA group: MQA, and 8 KV heads over
    16); whole where q does not (M³ViT's 3, Qwen1.5-4B's 20 over 16)."""
    table = {
        ("llama3_2_1b", 2): (True, True), ("llama3_2_1b", 4): (True, True),
        ("llama3_2_1b", 16): (True, False),
        ("deepseek_67b", 4): (True, True), ("deepseek_67b", 16): (True, False),
        ("recurrentgemma_9b", 4): (True, False),
        ("m3vit", 2): (False, False), ("m3vit", 4): (False, False),
        ("qwen1_5_4b", 4): (True, True), ("qwen1_5_4b", 16): (False, False),
        ("llama4_scout_17b_a16e", 16): (False, False),
    }
    for (arch, tp), want in table.items():
        assert L.attention_layout(tconfigs.get(arch), tp) == want, (arch, tp)
        assert L.attention_layout(tconfigs.get(arch), 1) == (False, False)


@pytest.mark.parametrize("policy", ["eager", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_column_shards_are_the_whole_products_columns(dtype, policy):
    """``unified_linear`` on a block of columns, summed in the whole
    weight's order, gives the whole product's columns bit for bit; a row
    block's float32 partials add up to the whole product within the
    float32 tolerance (their sums run in another order)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 5, 96)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((96, 256)).astype(
        np.float32) / 10).to(dtype)
    pol = ops.policy_named(policy)
    with ops.use_policy(pol):
        whole = unified_linear(x, w, activation="silu")
        exact = unified_linear(x, w, out_dtype=torch.float32)
        for tp in (2, 4):
            n = 256 // tp
            cols = [unified_linear(x, w[:, r * n:(r + 1) * n],
                                   activation="silu", order_n=256)
                    for r in range(tp)]
            assert torch.equal(torch.cat(cols, -1), whole), tp
            k = 96 // tp
            parts = [unified_linear(x[..., r * k:(r + 1) * k],
                                    w[r * k:(r + 1) * k],
                                    out_dtype=torch.float32)
                     for r in range(tp)]
            assert all(p.dtype == torch.float32 for p in parts)
            assert within_tolerance(sum(parts), exact, torch.float32), tp


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2), (2, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tensor_parallel_world(shape, tmp_path):
    world = shape[0] * shape[1]
    mp.start_processes(W.run, args=(world, shape,
                                    os.path.join(tmp_path, "store"),
                                    list(W.CHECKS)),
                       nprocs=world, start_method="spawn")
