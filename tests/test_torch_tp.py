"""Tensor-parallel serving of the port on the CPU (gloo, smoke sizes):
the dense blocks and the recurrent mixers (RG-LRU, mLSTM, sLSTM) split
over ``model`` as the reference's table lays them out
(``src/repro/dist/sharding.py``), and parking a lane of a bucket split
over the data axes.

In process, on a device-free mesh and ``meta`` tensors at full size: a
serving rank's block of every leaf of Llama-3.2-1B, DeepSeek-67B, M³ViT,
RecurrentGemma-9B, xLSTM-350M and Llama-4-Scout (grouped and
``ep_local``) equals the
block of the reference's trimmed spec over ``model`` (the data axes stay
whole in serving), but for the documented whole leaves: an xLSTM mixer
whose heads do not divide the axis (xLSTM-350M's 4 heads split at 2 and
4, its mixers' whole leaves then those the table replicates), an RG-LRU
mixer whose width or gate heads do not divide the axis, the attention of a layer whose heads do not divide the
axis (k/v alone where only the KV heads do not), and the expert stacks
of an impl that routes to every expert on every rank.  A column block of
``unified_linear``, summed in the whole weight's order (``order_n``),
gives the whole product's columns bit for bit, and a row block's float32
partials add up to the whole product within the float32 tolerance.  The
port's RG-LRU block on each rank's block of the reference's parameters
(its row partials added by hand) against ``repro.models.rglru.
apply_rglru`` on the whole block, a prefill then three decode steps with
state, at float32 within ``RGLRU_RTOL`` of each one's magnitude; the
port's mLSTM and sLSTM blocks the same way over (1, 2) and (1, 4) gloo
worlds, their gathers and all-reduces real, against
``repro.models.xlstm`` (``_torch_tp_worker.check_xlstm_reference``).

Spawned gloo worlds at (1, 2), (1, 4), (2, 2) and (2, 1), one process a
rank (``tests/_torch_tp_worker.py``): the forward against no mesh (each
dense block within the bf16 tolerance of ``kernels/compare.py``, the
logits at cosine >= ``SERVE_COSINE``, float32 greedy tokens equal; bit
for bit at (2, 1)), the collectives by ``where``, a rank's blocks and its
KV heads, the per-rank draw against the narrowed whole draw, the
vocab-parallel embedding bit for bit, M³ViT's and MQA's layouts, and
tiered preemption over a split bucket (bit for bit with the unmeshed
scheduler at (2, 1); under tensor parallelism the same mesh's tokens
with no preemption); the smoke RecurrentGemma's ``recurrent`` check: a
rank's RG-LRU blocks and state channels, its forward and prefill state
against no mesh, tokens, draw and parked recurrent lanes; then the same
for the smoke xLSTM (its heads' blocks and state, the state bytes a rank,
the collectives by ``where``)."""

import functools
import os
import re
from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_tp_worker as W
from _torch_mesh import rules_of_one
from repro import configs as jconfigs
from repro.dist import sharding as JS
from repro.models import model as jmodel
from repro.models import rglru as JR
from repro.models import xlstm as JX
from repro.ops import policy_named as jpolicy_named
from repro.ops import use_policy as juse_policy
from repro_torch import configs as tconfigs
from repro_torch import ops
from repro_torch.bridge import params_from_jax
from repro_torch.core.unified_linear import unified_linear
from repro_torch.dist.sharding import ShardingRules, _path_str
from repro_torch.dist.spmd import VirtualMesh
from repro_torch.kernels.compare import within_tolerance
from repro_torch.dist.sharding import use_rules
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.models import rglru as TR
from repro_torch.serve.engine import local_params
from test_torch_threads import one_torch_thread  # noqa: F401

MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
ARCHS = ("llama3_2_1b", "deepseek_67b", "m3vit", "recurrentgemma_9b",
         "xlstm_350m", "llama4_scout_17b_a16e")
MIXERS = re.compile(r"(mlstm|slstm)/")
#: the port's RG-LRU on rank blocks against the reference's whole block,
#: float32, of each output's magnitude: w_down's row partials add up in
#: another order than the whole product's sum (1e-7), which the
#: recurrence carries into the next steps
RGLRU_RTOL = 1e-5
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
    """The documented leaves a serving rank keeps whole beyond those the
    trimmed table replicates."""
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    q_split = hq % tp == 0 and (hkv % tp == 0 or (hq // hkv) % (hq // tp)
                                == 0)
    if MIXERS.search(path):
        return hq % tp != 0
    if path.startswith(("layers/", "rest/")) and "/rglru/" in path:
        w = cfg.lru_width or cfg.d_model
        return not (w % tp == 0 and cfg.num_heads % tp == 0)
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
    kept = whole_mixers = 0
    for name, t in shapes.items():
        path = _path_str(name)
        whole = tuple(t.shape)
        got = tuple(held[name].shape)
        whole_mixers += bool(MIXERS.search(path)) and got == whole
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
    if arch == "recurrentgemma_9b":          # wk, wv beside split q heads
        assert kept == 2
    if arch == "xlstm_350m":
        # the 4 heads split at 2 and 4; whole are the leaves the table
        # replicates: each mLSTM's w_if, b_if and gn_scale, the sLSTM's
        # b_gates and gn_scale, and its up-projection, whose 1365 columns
        # the axis does not divide (the 7 + 1 block positions, stacked)
        assert kept == 0
        assert whole_mixers == 7 * 3 + 5


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


class _RankMesh(VirtualMesh):
    """A device-free (1, tp) mesh seen from ``model`` rank ``rank``."""

    def __init__(self, tp: int, rank: int):
        super().__init__((1, tp), ("data", "model"))
        self.rank = rank

    def get_local_rank(self, axis: str) -> int:
        return self.rank if axis == "model" else 0


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("tp", [2, 4])
def test_rglru_rank_blocks_match_the_reference(tp):
    """The smoke RecurrentGemma's first RG-LRU block (64 channels, 4
    gate heads), its parameters drawn by the reference and carried
    across (``bridge.params_from_jax``): each of ``tp`` ranks runs the
    port's ``apply_rglru`` on its blocks (``local_params`` over a (1, tp)
    mesh seen from that rank) with its channels of the state, in a world
    of one (the all-reduce then returns the rank's float32 partial); the
    partials added up and the state blocks joined equal the reference's
    ``apply_rglru`` on the whole block within ``RGLRU_RTOL``, a 13-token
    prefill from a random state, then three decode steps."""
    jcfg = replace(jconfigs.get("recurrentgemma_9b", smoke=True),
                   dtype="float32")
    cfg = replace(tconfigs.get("recurrentgemma_9b", smoke=True),
                  dtype="float32")
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(3),
                                                jcfg))
    whole = params_from_jax(jparams, device="cpu")
    jblock = {k: v[0] for k, v in jparams["layers"]["b0"]["rglru"].items()}
    prefix = "layers.b0.rglru."
    ranks = []
    for r in range(tp):
        rules = ShardingRules.for_mesh(_RankMesh(tp, r), fsdp=False)
        held = local_params(whole, cfg, rules)
        ranks.append({k[len(prefix):]: v[0] for k, v in held.items()
                      if k.startswith(prefix)})
    w = cfg.lru_width
    assert all(b["w_up"].shape[-1] == w // tp for b in ranks)
    rng = np.random.default_rng(6)
    state = TR.init_rglru_state(cfg, 2)
    jstate = {k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
              for k, v in state.items()}
    cols = [slice(r * w // tp, (r + 1) * w // tp) for r in range(tp)]
    tstates = [{k: torch.from_numpy(v[..., c].copy())
                for k, v in jstate.items()} for c in cols]
    japply = jax.jit(JR.apply_rglru, static_argnums=(2, 4))
    for s, decode in ((13, False), (1, True), (1, True), (1, True)):
        x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
        jy, jstate = japply(jblock, jnp.asarray(x), jcfg, jstate, decode)
        parts = []
        with use_rules(rules_of_one()):
            for block, st in zip(ranks, tstates):
                y, same = TR.apply_rglru(block, torch.from_numpy(x), cfg,
                                         st, decode)
                assert same is st
                parts.append(y)
        assert _rel(sum(parts), jy) <= RGLRU_RTOL, (s, _rel(sum(parts), jy))
        for k in jstate:
            joined = torch.cat([st[k] for st in tstates], -1)
            assert _rel(joined, jstate[k]) <= RGLRU_RTOL, (s, k)


def _xlstm_reference(path, d):
    """The reference's smoke xLSTM at float32 and ``d_model`` ``d``, its
    parameters carried into the port by the bridge, and the reference's
    ``apply_mlstm`` (block b0) and ``apply_slstm`` (block b7) on the whole
    block from a random state: a 13-token prefill (13 is not a multiple
    of ``mlstm_chunk`` 8), then three decode steps, under its exact
    activations (``xla``: the sLSTM's GELU LUT may take another entry at
    a half-step); written to ``path`` for
    ``_torch_tp_worker.check_xlstm_reference``."""
    jcfg = replace(jconfigs.get("xlstm_350m", smoke=True), dtype="float32",
                   d_model=d)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(4),
                                                jcfg))
    out = {f"param:{k}": v.numpy()
           for k, v in params_from_jax(jparams, device="cpu").items()}
    rng = np.random.default_rng(7)
    b, h = 2, jcfg.num_heads
    for kind, block, apply, init in (
            ("mlstm", "b0", JX.apply_mlstm, JX.init_mlstm_state),
            ("slstm", "b7", JX.apply_slstm, JX.init_slstm_state)):
        jblock = {k: v[0] for k, v in jparams["layers"][block][kind].items()}
        state = {}
        for k, v in init(jcfg, b).items():
            x = rng.standard_normal(v.shape).astype(np.float32) * 0.5
            state[k] = np.abs(x) + 0.5 if kind == "slstm" and k == "n" \
                else x
        for k, v in state.items():
            out[f"{kind}:state0:{k}"] = v
        japply = jax.jit(apply, static_argnums=(2, 4))
        for i, (s, decode) in enumerate(((13, False), (1, True), (1, True),
                                         (1, True))):
            x = rng.standard_normal((b, s, d)).astype(np.float32)
            with juse_policy(jpolicy_named("xla")):
                y, state = japply(jblock, jnp.asarray(x), jcfg, state,
                                  decode)
            out[f"{kind}:x{i}"] = x
            out[f"{kind}:y{i}"] = np.asarray(y)
            for k, v in state.items():
                out[f"{kind}:state{i + 1}:{k}"] = np.asarray(v)
    assert h % 4 == 0
    np.savez(path, **out)


@pytest.mark.parametrize("tp", [2, 4])
def test_xlstm_rank_blocks_match_the_reference(tp, tmp_path):
    """The port's ``apply_mlstm`` and ``apply_slstm`` on each rank's
    blocks (``local_params`` over a (1, tp) gloo world, one process a
    rank) against ``repro.models.xlstm``'s on the whole block, the
    parameters drawn by the reference and carried across: a 13-token
    prefill from a random state, then three decode steps under exact
    activations (``xla`` there, ``eager`` here), each output and each
    rank's block of the state within ``_torch_tp_worker.XLSTM_REF_RTOL``
    of the reference's, with the block's collectives counted; at the smoke
    ``d_model`` 64 (the sLSTM's 85-wide up-projection whole) and at 96
    (its 128 columns split, the dense MLP's way)."""
    for d in (64, 96):
        _xlstm_reference(os.path.join(tmp_path, f"xlstm_ref_{d}.npz"), d)
    check = functools.partial(W.check_xlstm_reference, workdir=tmp_path)
    mp.start_processes(W.run, args=(tp, (1, tp),
                                    os.path.join(tmp_path, "store"),
                                    [check]),
                       nprocs=tp, start_method="spawn")


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2), (2, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tensor_parallel_world(shape, tmp_path):
    world = shape[0] * shape[1]
    mp.start_processes(W.run, args=(world, shape,
                                    os.path.join(tmp_path, "store"),
                                    W.CHECKS),
                       nprocs=world, start_method="spawn")
