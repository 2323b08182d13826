"""The ranks of ``tests/test_torch_tp.py``: one spawned process a rank of
a gloo world (``tests/_torch_dist_worker.py``'s pattern), each running
the tensor-parallel serving checks at the smoke sizes against the same
work with no mesh, with inputs made from seeds with NumPy.  Imports
torch, NumPy and the port only."""

import os
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import ops
from repro_torch.configs import get
from repro_torch.dist import spmd
from repro_torch.dist.sharding import ShardingRules, use_rules
from repro_torch.kernels.compare import max_abs_err, within_tolerance
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.serve.engine import (ServeConfig, ServingEngine,
                                      local_params, shard_state,
                                      state_batch_axes)
from repro_torch.tree import flatten

#: the LM families the forward check runs: dense with a tied head, a
#: separate head, an MoE LM with a shared expert (its experts whole), an
#: MQA hybrid (k/v whole, its RG-LRU mixers split), embedding inputs
ARCHS = ("llama3_2_1b", "deepseek_67b", "kimi_k2_1t_a32b",
         "recurrentgemma_9b", "qwen2_vl_72b")


def _inputs(cfg, b=4, s=8, seed=2):
    rng = np.random.default_rng(seed)
    if cfg.embed_input == "tokens":
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    return torch.from_numpy(rng.standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)).to(cfg.activation_dtype)


def _model(arch, dtype, **over):
    cfg = replace(get(arch, smoke=True), dtype=dtype, **over)
    return cfg, M.init_params(1, cfg, device="cpu")


def _where_counts() -> dict:
    return {c["where"]: c["count"] for c in ops.collective_report()}


def _first_blocks(params, cfg):
    """The attention and (where the block has one) MLP parameters of the
    first layer."""
    from repro_torch.tree import index, unflatten

    layer = index(unflatten(params)["layers"], 0)
    for i, kind in enumerate(cfg.block_pattern):
        if kind.startswith("attn"):
            return layer[f"b{i}"]["attn"], layer[f"b{i}"].get("mlp")
    raise ValueError(cfg.name)


def check_forward(mesh):
    """Each rank holds its blocks (``local_params``) and runs under the
    rules.  In bf16, the first layer's attention and MLP on the same input
    within the bf16 tolerance of ``kernels/compare.py`` of the whole
    blocks (a row-parallel sum rounds once, like the whole one, from
    float32 sums in another order: one bf16 ulp), and the model's logits
    at cosine >= ``SERVE_COSINE`` of no mesh (those roundings compound
    over the layers); everything bit for bit where ``model`` has one
    rank.  The collectives by ``where``: two all-reduces a dense layer
    (and one more for an RG-LRU layer's mixer), one for the embedding,
    one gather of the logits.  In float32, the engine's greedy tokens
    equal no mesh's."""
    from repro_torch.kernels.compare import SERVE_COSINE, cosine
    from repro_torch.models import layers as L
    from repro_torch.models import rglru as RG

    rules = ShardingRules.for_mesh(mesh, fsdp=False)
    tp = spmd.axis_size(mesh, "model")
    for arch in ARCHS:
        cfg, params = _model(arch, "bfloat16")
        x = _inputs(cfg)
        want = M.forward(params, x, cfg)[0]
        mine = local_params(params, cfg, rules)
        ops.reset_dispatch_report()
        with torch.inference_mode(), use_rules(rules):
            got = M.forward(mine, x, cfg)[0]
        if tp == 1:
            assert torch.equal(got, want), arch
            continue
        assert cosine(got, want) >= SERVE_COSINE, (arch, cosine(got, want))
        where = _where_counts()
        layers = cfg.num_layers
        attn = sum(k.startswith("attn") for k in cfg.block_pattern) \
            * layers // cfg.period
        assert where["attn_out all-reduce"] == attn, (arch, where)
        assert where["logits all-gather"] == 1, (arch, where)
        assert where.get("embed all-reduce", 0) == \
            (cfg.embed_input == "tokens"), (arch, where)
        dense = layers - (layers // cfg.period) * sum(
            k in ("mlstm", "slstm", "attn_moe") for k in cfg.block_pattern)
        assert where.get("mlp_down all-reduce", 0) == dense, (arch, where)
        if cfg.moe is not None and cfg.moe.num_shared_experts:
            assert where["moe_shared all-reduce"] == layers, (arch, where)
        mixers = sum(cfg.block_kind(i) == "rglru_mlp" for i in range(
            layers)) if RG.split_over(cfg, tp) else 0
        assert where.get("rglru_down all-reduce", 0) == mixers, \
            (arch, where)
        h = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (2, 8, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
        pos = torch.arange(8)[None].expand(2, 8)
        (wa, wm), (ma, mm) = _first_blocks(params, cfg), \
            _first_blocks(mine, cfg)
        with torch.inference_mode(), use_rules(rules):
            pairs = [(L.apply_attention(ma, h, cfg, pos=pos)[0],
                      L.apply_attention(wa, h, cfg, pos=pos)[0])]
            if wm is not None:
                pairs.append((L.apply_mlp(mm, h, cfg),
                              L.apply_mlp(wm, h, cfg)))
        for b, (g, w) in enumerate(pairs):
            assert within_tolerance(g, w, torch.bfloat16), \
                (arch, b, max_abs_err(g, w))
    for arch in ARCHS:
        cfg, params = _model(arch, "float32")
        x = _inputs(cfg)
        scfg = ServeConfig(max_len=32)
        ref = ServingEngine(cfg, params, scfg, device="cpu").generate(x, 6)
        out = ServingEngine(cfg, params, scfg, rules=rules,
                            device="cpu").generate(x, 6)
        np.testing.assert_array_equal(out, ref, err_msg=arch)


def check_blocks(mesh):
    """A rank holds only its block over ``model`` of every leaf the table
    splits there (data axes whole), and a KV cache only its KV heads:
    ``shard_state`` of a whole state equals the engine's own rank-local
    state's shapes and holds the same rows."""
    rules = ShardingRules.for_mesh(mesh)       # FSDP on: data stays whole
    tp = spmd.axis_size(mesh, "model")
    cfg, params = _model("llama3_2_1b", "float32")
    mine = local_params(params, cfg, rules)
    cols = ("attn.wq", "mlp.wg", "mlp.wu", "head.w")
    if cfg.num_kv_heads % tp == 0:      # else k/v whole on every rank
        cols += ("attn.wk", "attn.wv")
    for name, v in params.items():
        got = tuple(mine[name].shape)
        if name.endswith(cols):
            assert got == v.shape[:-1] + (v.shape[-1] // tp,), name
        elif name.endswith(("attn.wo", "mlp.wd", "embed.tokens")):
            lead = v.shape[:-2]
            assert got == lead + (v.shape[-2] // tp, v.shape[-1]), name
        else:
            assert got == tuple(v.shape), name
    axes = state_batch_axes(cfg, 32)
    full = M.init_state(cfg, 4, 32, device="cpu")
    for v in flatten(full).values():
        v.copy_(torch.arange(v.numel()).reshape(v.shape))
    part = flatten(shard_state(full, cfg, rules, axes,
                               T.state_blocks(mine, cfg)))
    rows = spmd.batch_rows(4, rules)
    local = flatten(M.init_state(cfg, rows.stop - rows.start, 32,
                                 device="cpu", params=mine))
    heads = cfg.num_kv_heads // tp if cfg.num_kv_heads % tp == 0 \
        else cfg.num_kv_heads
    r = spmd.axis_index(mesh, "model") if heads < cfg.num_kv_heads else 0
    for (name, v), ax in zip(flatten(full).items(), axes):
        want = v.narrow(ax, rows.start, rows.stop - rows.start).narrow(
            ax + 1, r * heads, heads)
        assert torch.equal(part[name], want), name
        assert part[name].shape == local[name].shape, name


def check_draw(mesh):
    """``init_params(rules=)`` draws a rank's blocks, a layer at a time,
    equal bit for bit to the same blocks of the one-device draw from the
    same seed: NumPy on the host and a ``torch.Generator``."""
    rules = ShardingRules.for_mesh(mesh, fsdp=False)
    for arch in ("deepseek_67b", "llama3_2_1b", "kimi_k2_1t_a32b"):
        cfg = get(arch, smoke=True)
        for on_device in (False, True):
            whole = M.init_params(5, cfg, device="cpu",
                                  draw_on_device=on_device)
            want = local_params(whole, cfg, rules)
            got = M.init_params(5, cfg, device="cpu",
                                draw_on_device=on_device, rules=rules)
            assert got.keys() == want.keys(), arch
            for k in got:
                assert torch.equal(got[k], want[k]), (arch, on_device, k)
            again = local_params(got, cfg, rules)     # blocks kept as held
            assert all(again[k] is got[k] for k in got), arch


def check_embed(mesh):
    """The vocab-parallel lookup is the whole table's, bit for bit:
    negative ids wrap, rows with −0.0 and +0.0 keep their signs."""
    from repro_torch.models import layers as L

    rules = ShardingRules.for_mesh(mesh, fsdp=False)
    if spmd.axis_size(mesh, "model") == 1:
        return
    cfg, params = _model("llama3_2_1b", "bfloat16")
    table = params["embed.tokens"].clone()
    table[3, :4] = -0.0
    table[5, :4] = 0.0
    mine = local_params({"embed.tokens": table}, cfg, rules)
    ids = torch.tensor([[3, 5, -1, 0, cfg.vocab_size - 1, 77, 3, -128]])
    want = L.embed_inputs({"tokens": table}, ids, cfg)
    with use_rules(rules):
        got = L.embed_inputs({"tokens": mine["embed.tokens"]}, ids, cfg)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


def check_layouts(mesh):
    """M³ViT's three heads keep attention whole while its MLP splits
    (the server within the reference's 2e-3 of no mesh, float32); an
    MQA layer splits its q heads and keeps k/v whole; a GQA layer whose
    KV heads do not divide the axis reads each rank's one KV head."""
    from repro_torch.configs import m3vit as MV
    from repro_torch.models import vit as V
    from repro_torch.serve.vision import M3ViTServer

    rules = ShardingRules.for_mesh(mesh, fsdp=False)
    tp = spmd.axis_size(mesh, "model")
    imgs = np.random.default_rng(1).normal(
        size=(2, MV.IMAGE_H, MV.IMAGE_W, 3)).astype(np.float32)
    # the paper's three heads (whole), and the smoke config's four (split)
    for heads in (3, MV.SMOKE_CONFIG.num_heads):
        cfg = replace(MV.SMOKE_CONFIG, dtype="float32", num_heads=heads,
                      num_kv_heads=heads)
        params = V.init_params(0, cfg, device="cpu")
        server = M3ViTServer(cfg, params, rules=rules,
                             resident_fraction=0.5, device="cpu")
        p, whole = server.params, params
        split = heads % tp == 0 and tp > 1
        assert p["layers.b0.attn.wq"].shape[-1] * (tp if split else 1) \
            == whole["layers.b0.attn.wq"].shape[-1], heads
        assert p["layers.b0.mlp.w1"].shape[-1] == cfg.d_ff // tp
        assert p["layers.b0.mlp.b1"].shape[-1] == cfg.d_ff // tp
        assert p["layers.b0.mlp.b2"].shape == whole["layers.b0.mlp.b2"].shape
        ref = M3ViTServer(cfg, params, resident_fraction=0.5, device="cpu")
        for task in MV.TASKS:
            np.testing.assert_allclose(server.infer(imgs, task),
                                       ref.infer(imgs, task), atol=2e-3,
                                       rtol=2e-3, err_msg=f"{heads} {task}")
    if tp == 1:
        return
    rg, rparams = _model("recurrentgemma_9b", "float32")
    mine = local_params(rparams, rg, rules)
    (attn,) = [k for k in mine if k.endswith("attn.wq")]
    wk = attn[:-2] + "wk"
    assert mine[attn].shape[-1] * tp == rparams[attn].shape[-1]
    assert mine[wk].shape == rparams[wk].shape           # MQA: k/v whole
    # 8 q heads over 2 KV heads: at tp 4 each rank's 2 q heads read one
    # of the two whole KV heads (at tp 2 one KV head, MQA)
    gqa, gparams = _model("llama3_2_1b", "bfloat16", num_heads=8,
                          num_kv_heads=tp // 2, head_dim=16)
    mine = local_params(gparams, gqa, rules)
    assert mine["layers.b0.attn.wk"].shape == \
        gparams["layers.b0.attn.wk"].shape
    x = _inputs(gqa)
    want = M.forward(gparams, x, gqa)[0]
    with torch.inference_mode(), use_rules(rules):
        got = M.forward(mine, x, gqa)[0]
    assert within_tolerance(got, want, torch.bfloat16), \
        max_abs_err(got, want)
    gqa, gparams = _model("llama3_2_1b", "float32", num_heads=8,
                          num_kv_heads=tp // 2, head_dim=16)
    # float32 tokens, and with an int8 cache read through QTensor views
    for kv, pol in (("none", "eager"), ("int8", "eager_int8")):
        cfg = replace(gqa, kv_quant=kv)
        scfg = ServeConfig(max_len=32, policy=ops.policy_named(pol))
        np.testing.assert_array_equal(
            ServingEngine(cfg, gparams, scfg, rules=rules,
                          device="cpu").generate(x, 6),
            ServingEngine(cfg, gparams, scfg, device="cpu").generate(x, 6),
            err_msg=kv)


def _preempting(cfg, params, rules, preempt: bool):
    """Eight batch-tier requests in four slots, then interactive arrivals
    that preempt them (``preempt``), on a tick clock: {rid: tokens} and
    the scheduler."""
    from repro_torch.serve.scheduler import LMBackend, Request, Scheduler
    from repro_torch.serve.slo import SLOPolicy
    from repro_torch.serve.slo.trace import TickClock

    rng = np.random.default_rng(4)
    reqs = [Request(rid=i, task_id=0,
                    prompt=rng.integers(0, cfg.vocab_size, 6 + i % 3),
                    max_new_tokens=(12 if i < 6 else 3),
                    arrival=0.0 if i < 6 else 0.05 * (i - 5),
                    tier="batch" if i < 6 else "interactive")
            for i in range(9)]
    sched = Scheduler(LMBackend(cfg, params, ServeConfig(max_len=48),
                                rules=rules, device="cpu"),
                      total_slots=4, quantum=2, num_tasks=1,
                      clock=TickClock(), slo=SLOPolicy(
                          preemption=preempt, chunk_interleave=False))
    done = sched.run(reqs)
    return {r.rid: list(r.tokens) for r in done}, sched


def check_park(mesh):
    """Parking under a bucket split over the data axes: tiered preemption
    gives the unmeshed scheduler's tokens bit for bit (no ``model``
    split), with lanes moved between ranks where a lane comes back on
    another rank; under tensor parallelism each rank parks its own KV
    heads, and the tokens are those of the same mesh without
    preemption."""
    rules = ShardingRules.for_mesh(mesh, fsdp=False)
    cfg, params = _model("llama3_2_1b", "float32")
    ops.reset_dispatch_report()
    got, sched = _preempting(cfg, params, rules, True)
    assert sched.preemptions >= 1 and sched.metrics()["restores"] >= 1
    moved = _where_counts().get("parked lane move", 0)
    if spmd.axis_size(mesh, "model") == 1:
        want, plain = _preempting(cfg, params, None, True)
        assert got == want
        assert sched.metrics()["parked_bytes_peak"] == \
            plain.metrics()["parked_bytes_peak"]
        if spmd.axis_size(mesh, "data") > 1:
            assert moved >= 1
    else:
        want, _ = _preempting(cfg, params, rules, False)
        assert got == want


def check_packed(mesh):
    """int8 weights (``quantize_tree``): the table replicates a packed
    leaf, so a group holding one stays whole with its biases, while the
    fp embedding table still splits; the forward under ``eager_int8``
    within the float32 tolerance of no mesh and its greedy tokens
    equal."""
    from repro_torch.quant import quantize_tree

    rules = ShardingRules.for_mesh(mesh, fsdp=False)
    cfg, params = _model("llama3_2_1b", "float32")
    packed = quantize_tree(dict(params))
    mine = local_params(packed, cfg, rules)
    groups = {k.rsplit(".", 1)[0] for k, v in packed.items()
              if not isinstance(v, torch.Tensor)}
    for k, v in packed.items():
        if k.rsplit(".", 1)[0] in groups:
            assert mine[k] is v, k
    tp = spmd.axis_size(mesh, "model")
    assert mine["embed.tokens"].shape[0] == cfg.vocab_size // tp
    assert T.cache_kv_heads(mine, cfg) is None
    x = _inputs(cfg)
    with ops.use_policy(ops.policy_named("eager_int8")):
        want = M.forward(packed, x, cfg)[0]
        with torch.inference_mode(), use_rules(rules):
            got = M.forward(mine, x, cfg)[0]
    assert within_tolerance(got, want, torch.float32), max_abs_err(got, want)
    scfg = ServeConfig(max_len=32, policy=ops.policy_named("eager_int8"))
    np.testing.assert_array_equal(
        ServingEngine(cfg, packed, scfg, rules=rules,
                      device="cpu").generate(x, 6),
        ServingEngine(cfg, packed, scfg, device="cpu").generate(x, 6))


def check_recurrent(mesh):
    """The smoke RecurrentGemma at float32 (64 channels, 4 gate heads:
    its RG-LRU mixers split at 2 and 4): a rank holds its block of every
    ``rglru`` leaf and its state ``W / tp`` channels (the engine's own, and
    ``shard_state`` of a whole state); the forward within the float32
    tolerance of no mesh, and the prefill's state the narrowed whole
    state's; the engine's greedy tokens equal; the per-rank draw bit for
    bit the narrowed whole draw; tiered preemption parking recurrent
    lanes bit for bit with the unmeshed scheduler where ``model`` has one
    rank, and under tensor parallelism the same mesh's tokens without
    preemption; then the smoke xLSTM's (:func:`_check_xlstm`)."""
    rules = ShardingRules.for_mesh(mesh, fsdp=False)
    tp = spmd.axis_size(mesh, "model")
    cfg, params = _model("recurrentgemma_9b", "float32")
    w = cfg.lru_width
    mine = local_params(params, cfg, rules)
    for name, v in params.items():
        if ".rglru." not in name:
            continue
        if tp == 1:
            assert mine[name] is v, name
            continue
        leaf = name.rsplit(".", 1)[-1]
        dim = {"w_down": -2, "gates": -3}.get(leaf, -1)
        want = list(v.shape)
        want[dim] //= tp
        assert list(mine[name].shape) == want, (name, mine[name].shape)
    blocks = T.state_blocks(mine, cfg)
    width = blocks["lru_width"]
    assert width == (w // tp if tp > 1 else None), width
    engine = ServingEngine(cfg, params, ServeConfig(max_len=32),
                           rules=rules, device="cpu")
    for name, v in flatten(engine.new_state(2)).items():
        if name.endswith((".h", ".conv")):
            assert v.shape[-1] == w // tp, (name, v.shape)
    # shard_state of a whole state, against the rank's own
    axes = state_batch_axes(cfg, 32)
    full = M.init_state(cfg, 4, 32, device="cpu")
    for v in flatten(full).values():
        v.copy_(torch.arange(v.numel()).reshape(v.shape))
    part = flatten(shard_state(full, cfg, rules, axes, blocks))
    rows = spmd.batch_rows(4, rules)
    local = flatten(engine.new_state(rows.stop - rows.start))
    r = spmd.axis_index(mesh, "model")
    for (name, v), ax in zip(flatten(full).items(), axes):
        want = v.narrow(ax, rows.start, rows.stop - rows.start)
        if width is not None and name.endswith((".h", ".conv")):
            want = want.narrow(-1, r * width, width)
        assert torch.equal(part[name], want), name
        assert part[name].shape == local[name].shape, name
    # the forward and the prefill's state against no mesh, under exact
    # activations: the float32 noise of the split's sums (1e-6) can move
    # a LUT activation a table step
    x = _inputs(cfg)
    exact = replace(cfg, policy=ops.policy_named("eager"))
    whole_state = M.init_state(cfg, 4, 32, device="cpu")
    want, _, _ = M.forward(params, x, exact, state=whole_state,
                           cache_index=0)
    state = M.init_state(cfg, 4, 32, device="cpu", params=mine)
    with torch.inference_mode(), use_rules(rules):
        got, _, _ = M.forward(mine, x, exact, state=state, cache_index=0)
    assert within_tolerance(got, want, torch.float32), max_abs_err(got, want)
    ours = flatten(state)
    for name, v in flatten(whole_state).items():
        if width is not None and name.endswith((".h", ".conv")):
            v = v.narrow(-1, r * width, width)
        assert within_tolerance(ours[name], v, torch.float32), \
            (name, max_abs_err(ours[name], v))
    scfg = ServeConfig(max_len=32)
    np.testing.assert_array_equal(
        engine.generate(x, 6),
        ServingEngine(cfg, params, scfg, device="cpu").generate(x, 6))
    # the per-rank draw
    got = M.init_params(5, cfg, device="cpu", rules=rules)
    want = local_params(M.init_params(5, cfg, device="cpu"), cfg, rules)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    # parking recurrent lanes
    ops.reset_dispatch_report()
    got, sched = _preempting(cfg, params, rules, True)
    assert sched.preemptions >= 1 and sched.metrics()["restores"] >= 1
    if tp == 1:
        want, plain = _preempting(cfg, params, None, True)
        assert got == want
        assert sched.metrics()["parked_bytes_peak"] == \
            plain.metrics()["parked_bytes_peak"]
        if spmd.axis_size(mesh, "data") > 1:
            assert _where_counts().get("parked lane move", 0) >= 1
    else:
        want, _ = _preempting(cfg, params, rules, False)
        assert got == want
    _check_xlstm(mesh)


#: the smoke xLSTM's prefill over a mesh splitting its heads against no
#: mesh, float32, of each tensor's largest magnitude: the split's other
#: sum orders (1e-7) grow through eight exp-stabilised recurrences to at
#: most 9.3e-6 (the logits 6.4e-6, ``m`` of an mLSTM state 9.3e-6 at
#: 1x4), past the elementwise float32 tolerance where a logit is small
XLSTM_RTOL = 5e-5


def _rel(got, want) -> float:
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


#: the heads-split leaves of the xLSTM mixers and the dim each splits on
#: (``w_down`` by rows, ``r_gates`` by heads, the rest by columns)
XLSTM_SPLIT = {"mlstm": ("w_up", "w_gates", "w_qkv", "conv", "w_down"),
               "slstm": ("w_gates", "r_gates")}


def _check_xlstm(mesh):
    """The smoke xLSTM at float32 (4 heads: its mLSTM and sLSTM split at
    2 and 4; the sLSTM's 85-wide up-projection whole): a rank holds its
    block of every split mixer leaf and the rest whole, its state its
    ``H / tp`` heads (the mLSTM's conv their channels) — exactly
    ``1 / tp`` of the whole state's bytes — as the engine builds it and as
    ``shard_state`` cuts a whole state; the prefill's logits and state
    within ``XLSTM_RTOL`` of no mesh (exact activations), with a uc and a qkv
    all-gather and a down all-reduce a mLSTM block and an hn all-gather
    an sLSTM block; the engine's greedy tokens equal; the per-rank draw
    the narrowed whole draw; and tiered preemption parking xLSTM lanes,
    each request's tokens those of the same mesh without preemption."""
    from repro_torch.models import xlstm as XL

    rules = ShardingRules.for_mesh(mesh, fsdp=False)
    tp = spmd.axis_size(mesh, "model")
    cfg, params = _model("xlstm_350m", "float32")
    mine = local_params(params, cfg, rules)
    split = XL.split_over(cfg, tp)
    assert split == (tp > 1)
    for name, v in params.items():
        kind, leaf = name.split(".")[-2:]
        if not split or leaf not in XLSTM_SPLIT.get(kind, ()):
            if kind in XLSTM_SPLIT:
                assert mine[name] is v, name
            continue
        dim = {"w_down": -2, "r_gates": -3}.get(leaf, -1)
        want = list(v.shape)
        want[dim] //= tp
        assert list(mine[name].shape) == want, (name, mine[name].shape)
    blocks = T.state_blocks(mine, cfg)
    heads = blocks["xlstm_heads"]
    assert heads == (cfg.num_heads // tp if split else None), heads
    engine = ServingEngine(cfg, params, ServeConfig(max_len=32),
                           rules=rules, device="cpu")
    whole = flatten(M.init_state(cfg, 2, 32, device="cpu"))
    local = flatten(engine.new_state(2))
    nbytes = [sum(t.numel() * t.element_size() for t in s.values())
              for s in (local, whole)]
    assert nbytes[0] * tp == nbytes[1], nbytes
    # shard_state of a whole state, against the rank's own
    axes = state_batch_axes(cfg, 32)
    full = M.init_state(cfg, 4, 32, device="cpu")
    for v in flatten(full).values():
        v.copy_(torch.arange(v.numel()).reshape(v.shape))
    part = flatten(shard_state(full, cfg, rules, axes, blocks))
    rows = spmd.batch_rows(4, rules)
    own = flatten(engine.new_state(rows.stop - rows.start))
    r = spmd.axis_index(mesh, "model")

    def narrowed(name, v, ax):
        if heads is None:
            return v
        if name.endswith(".conv"):
            ch = v.shape[-1] // tp
            return v.narrow(-1, r * ch, ch)
        return v.narrow(ax + 1, r * heads, heads)

    for (name, v), ax in zip(flatten(full).items(), axes):
        want = narrowed(name, v.narrow(ax, rows.start,
                                       rows.stop - rows.start), ax)
        assert torch.equal(part[name], want), name
        assert part[name].shape == own[name].shape, name
    # the prefill's logits and state against no mesh, under exact
    # activations (the sLSTM's GELU: a LUT index may flip at a half-step)
    x = _inputs(cfg, s=13)
    exact = replace(cfg, policy=ops.policy_named("eager"))
    whole_state = M.init_state(cfg, 4, 32, device="cpu")
    want, _, _ = M.forward(params, x, exact, state=whole_state,
                           cache_index=0)
    state = M.init_state(cfg, 4, 32, device="cpu", params=mine)
    ops.reset_dispatch_report()
    with torch.inference_mode(), use_rules(rules):
        got, _, _ = M.forward(mine, x, exact, state=state, cache_index=0)
    assert _rel(got, want) <= XLSTM_RTOL, _rel(got, want)
    ours = flatten(state)
    for (name, v), ax in zip(flatten(whole_state).items(), axes):
        v = narrowed(name, v, ax)
        assert _rel(ours[name], v) <= XLSTM_RTOL, (name, _rel(ours[name], v))
    if split:
        where = _where_counts()
        kinds = [cfg.block_kind(i) for i in range(cfg.num_layers)]
        nm, ns = kinds.count("mlstm"), kinds.count("slstm")
        expect = {"mlstm_uc all-gather": nm, "mlstm_qkv all-gather": nm,
                  "mlstm_down all-reduce": nm, "slstm_hn all-gather": ns,
                  "embed all-reduce": 1, "logits all-gather": 1}
        assert where == expect, where
    scfg = ServeConfig(max_len=32)
    np.testing.assert_array_equal(
        engine.generate(x, 6),
        ServingEngine(cfg, params, scfg, device="cpu").generate(x, 6))
    # the per-rank draw
    got = M.init_params(5, cfg, device="cpu", rules=rules)
    want = local_params(M.init_params(5, cfg, device="cpu"), cfg, rules)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    # parking xLSTM lanes, against the same mesh without preemption
    got, sched = _preempting(cfg, params, rules, True)
    assert sched.preemptions >= 1 and sched.metrics()["restores"] >= 1
    want, _ = _preempting(cfg, params, rules, False)
    assert got == want


#: the port's xLSTM blocks on rank blocks against the reference's on the
#: whole block, float32, of each tensor's largest magnitude: XLA's sums
#: beside the port's and the split's other order (the largest reading at
#: tp 2 and 4 is 1.2e-6, where the unsplit port's is too)
XLSTM_REF_RTOL = 1e-5


def check_xlstm_reference(mesh, workdir):
    """``tests/test_torch_tp.py::test_xlstm_rank_blocks_match_the_reference``
    on this rank: the reference's runs (``xlstm_ref_<d>.npz``, the
    parent's) replayed by the port's ``apply_mlstm`` / ``apply_slstm`` on
    this rank's blocks and its heads' state, under the rules of the
    (1, tp) world and exact activations; each output (whole on every rank after the block's
    all-reduce) and the rank's block of each state within
    ``XLSTM_REF_RTOL``."""
    from repro_torch.models import xlstm as XL

    rules = ShardingRules.for_mesh(mesh, fsdp=False)
    tp = spmd.axis_size(mesh, "model")
    r = spmd.axis_index(mesh, "model")
    for d in (64, 96):
        ref = np.load(os.path.join(workdir, f"xlstm_ref_{d}.npz"))
        cfg = replace(get("xlstm_350m", smoke=True), dtype="float32",
                      d_model=d)
        whole = {k.split(":", 1)[1]: torch.from_numpy(ref[k])
                 for k in ref.files if k.startswith("param:")}
        held = local_params(whole, cfg, rules)
        heads = cfg.num_heads // tp
        split_up = (4 * d // 3) % tp == 0
        for kind, block, apply in (("mlstm", "b0", XL.apply_mlstm),
                                   ("slstm", "b7", XL.apply_slstm)):
            prefix = f"layers.{block}.{kind}."
            mine = {k[len(prefix):]: v[0] for k, v in held.items()
                    if k.startswith(prefix)}
            assert mine["r_gates" if kind == "slstm" else "w_down"].shape[
                -3 if kind == "slstm" else -2] * tp == (
                cfg.num_heads if kind == "slstm" else 2 * d)
            if kind == "slstm":
                assert (mine["w_up"].shape[-1] * tp == 4 * d // 3) \
                    == split_up, mine["w_up"].shape

            def block_of(k, v):
                """This rank's heads (the conv: their channels)."""
                if k == "conv":
                    ch = v.shape[-1] // tp
                    return v[..., r * ch:(r + 1) * ch]
                return v[:, r * heads:(r + 1) * heads]

            state = {k[len(f"{kind}:state0:"):]: torch.from_numpy(
                np.ascontiguousarray(block_of(k.rsplit(":", 1)[1],
                                              ref[k])))
                for k in ref.files if k.startswith(f"{kind}:state0:")}
            for i, decode in enumerate((False, True, True, True)):
                ops.reset_dispatch_report()
                with use_rules(rules), ops.use_policy(
                        ops.policy_named("eager")):
                    y, same = apply(mine, torch.from_numpy(
                        ref[f"{kind}:x{i}"]), cfg, state, decode)
                assert same is state
                want = torch.from_numpy(ref[f"{kind}:y{i}"])
                assert _rel(y, want) <= XLSTM_REF_RTOL, \
                    (d, kind, i, _rel(y, want))
                for k, v in state.items():
                    want = torch.from_numpy(np.ascontiguousarray(block_of(
                        k, ref[f"{kind}:state{i + 1}:{k}"])))
                    assert _rel(v, want) <= XLSTM_REF_RTOL, \
                        (d, kind, i, k, _rel(v, want))
                where = _where_counts()
                if kind == "mlstm":
                    assert where == {"mlstm_uc all-gather": 1,
                                     "mlstm_qkv all-gather": 1,
                                     "mlstm_down all-reduce": 1}, where
                else:
                    assert where == {"slstm_hn all-gather": 1} | (
                        {"slstm_down all-reduce": 1} if split_up
                        else {}), where


#: the checks ``test_tensor_parallel_world`` runs in every world
CHECKS = (check_forward, check_blocks, check_draw, check_embed,
          check_layouts, check_park, check_packed, check_recurrent)


def run(rank, world, shape, store, checks):
    """One rank of a gloo world of ``shape``: each of ``checks`` (callables
    of the mesh, e.g. ``CHECKS``) in turn."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        mesh = spmd.init_mesh(shape, device_type="cpu")
        for check in checks:
            ops.reset_dispatch_report()
            check(mesh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ FSDP serving

#: the families ``tests/test_torch_fsdp_serve.py``'s worlds serve: dense
#: with a tied head, an MoE LM with a shared expert (its expert stacks
#: split over data under ``True`` and ``"moe_only"``), the RG-LRU hybrid
#: and the xLSTM stack
FSDP_ARCHS = ("llama3_2_1b", "kimi_k2_1t_a32b", "recurrentgemma_9b",
              "xlstm_350m")
FSDP_NEW = 4            # greedy tokens a generate: 1 + FSDP_NEW forwards


def fsdp_gather_counts(cfg, rules, forwards: int) -> dict:
    """{axis: count} of the ``"fsdp gather"`` all-gathers ``forwards``
    forwards make, counted from the config and the rule table: a gather
    a forward over each axis of more than one rank that splits a leaf
    the rank computes whole over it (the data axes always; ``model``
    but for the leaves ``transformer.model_blocks`` names), once for
    each of its layers, and the tied table twice (the lookup, then the
    head)."""
    from repro_torch.dist.sharding import (_axes, axis_sizes,
                                          param_sharding_rules)

    sizes = axis_sizes(rules.mesh)
    blocks = T.model_blocks(cfg, rules)
    n_periods = cfg.num_layers // cfg.period
    out = {}
    for name, sh in param_sharding_rules(M.param_specs(cfg),
                                         rules).items():
        times = n_periods if name.startswith("layers.") else 1
        if name == "embed.tokens" and cfg.tie_embeddings:
            times = 2
        for entry in sh.spec:
            for a in _axes(entry):
                if sizes[a] > 1 and not (a == "model" and name in blocks):
                    out[a] = out.get(a, 0) + times * forwards
    return out


def table_bytes(cfg, rules) -> int:
    """A rank's bytes of the whole model at the table's blocks: each
    leaf's over the product of its spec's axes."""
    from repro_torch.dist.sharding import (_axes, axis_sizes,
                                          param_sharding_rules)

    sizes = axis_sizes(rules.mesh)
    shapes = M.param_specs(cfg)
    total = 0
    for name, sh in param_sharding_rules(shapes, rules).items():
        n = 1
        for entry in sh.spec:
            for a in _axes(entry):
                n *= sizes[a]
        t = shapes[name]
        total += t.numel() * t.element_size() // n
    return total


def _collectives() -> dict:
    return {(c["kind"], c["axis"], c["where"]): (c["count"], c["bytes"])
            for c in ops.collective_report()}


def _nbytes(params) -> int:
    return sum(v.numel() * v.element_size() for v in params.values())


def _prefill_logits(engine, rules, x):
    """This rank's rows of the prefill's last logits."""
    prefill, _ = engine.steps(0)
    rows = spmd.batch_rows(x.shape[0], rules)
    with torch.inference_mode(), use_rules(rules), \
            spmd.batch_split(rules, x.shape[0]):
        state = engine.new_state(rows.stop - rows.start)
        return prefill(engine.params, x[rows], state)[0]


def _scheduled(cfg, params, rules):
    """Every request's greedy tokens of a mixed-task scheduler: 6 prompts
    of 6..16 tokens in 4 slots (the lanes split over data), 3..5 new
    tokens each."""
    from repro_torch.serve.scheduler import LMBackend, Request, Scheduler

    rng = np.random.default_rng(6)
    backend = LMBackend(cfg, params, ServeConfig(max_len=48), rules=rules,
                        device="cpu")
    sched = Scheduler(backend, total_slots=4, quantum=3, num_tasks=1)
    done = sched.run([Request(rid=i, task_id=0, prompt=rng.integers(
        0, cfg.vocab_size, 6 + 2 * i), max_new_tokens=3 + i % 3)
        for i in range(6)])
    return {r.rid: list(r.tokens) for r in done}


def check_fsdp(mesh):
    """``tests/test_torch_fsdp_serve.py::test_fsdp_serving_world`` on this
    rank, for each of ``FSDP_ARCHS`` at its smoke config (bf16): the
    ``ServingEngine`` under ``for_mesh(mesh)`` (and, for the MoE LM,
    ``fsdp="moe_only"``) against the same mesh under ``fsdp=False`` —
    the prefill's logits and ``FSDP_NEW`` greedy tokens bit for bit, the
    ``"fsdp gather"`` all-gathers by axis as counted from the config
    (:func:`fsdp_gather_counts`) and every other collective as under
    ``fsdp=False``; the rank's held bytes exactly the table's blocks
    (:func:`table_bytes`) and at most ``fsdp=False``'s; a scheduler's
    tokens bit for bit too; ``init_params(rules=)`` bit-equal to
    ``place_params`` of the whole draw, and ``place_params`` of
    ``fsdp=False`` rules ``local_params``' tensors."""
    from repro_torch.serve.engine import place_params

    off = ShardingRules.for_mesh(mesh, fsdp=False)
    scfg = ServeConfig(max_len=32)
    for arch in FSDP_ARCHS:
        cfg, params = _model(arch, "bfloat16")
        x = _inputs(cfg)
        base = ServingEngine(cfg, params, scfg, rules=off, device="cpu")
        want_logits = _prefill_logits(base, off, x)
        ops.reset_dispatch_report()
        want = base.generate(x, FSDP_NEW)
        want_coll = _collectives()
        want_sched = _scheduled(cfg, params, off)
        again = place_params(params, cfg, off)
        local = local_params(params, cfg, off)
        assert all(torch.equal(again[k], local[k]) for k in params), arch
        for fsdp in (True, "moe_only") if cfg.moe else (True,):
            rules = ShardingRules.for_mesh(mesh, fsdp=fsdp)
            eng = ServingEngine(cfg, params, scfg, rules=rules,
                                device="cpu")
            held = _nbytes(eng.params)
            assert held == table_bytes(cfg, rules), (arch, fsdp, held)
            assert held <= _nbytes(base.params), (arch, fsdp)
            got_logits = _prefill_logits(eng, rules, x)
            assert torch.equal(got_logits, want_logits), (arch, fsdp)
            ops.reset_dispatch_report()
            got = eng.generate(x, FSDP_NEW)
            np.testing.assert_array_equal(got, want, err_msg=f"{arch}")
            coll = _collectives()
            gathers = {k[1]: v[0] for k, v in coll.items()
                       if k[2] == "fsdp gather"}
            assert all(k[0] == "all_gather" for k in coll
                       if k[2] == "fsdp gather"), coll
            assert gathers == fsdp_gather_counts(cfg, rules, 1 + FSDP_NEW), \
                (arch, fsdp, gathers)
            assert {k: v for k, v in coll.items()
                    if k[2] != "fsdp gather"} == want_coll, (arch, fsdp)
            assert _scheduled(cfg, params, rules) == want_sched, \
                (arch, fsdp)
            drawn = M.init_params(5, cfg, device="cpu", rules=rules)
            whole = place_params(M.init_params(5, cfg, device="cpu"), cfg,
                                 rules)
            assert drawn.keys() == whole.keys(), arch
            assert all(torch.equal(drawn[k], whole[k]) for k in drawn), \
                (arch, fsdp)
            del eng


def check_fsdp_reference(mesh, workdir):
    """The second check of ``tests/test_torch_fsdp_serve.py::
    test_fsdp_serving_world`` on this rank: the reference's float32
    greedy tokens with no mesh
    (``fsdp_ref_<arch>.npz``, the parent's, with the reference's weights
    carried across by the bridge and its prompts) against the port's
    ``ServingEngine`` under ``for_mesh(mesh)`` (FSDP) and exact
    activations (``eager``; the reference's ``xla``)."""
    scfg = ServeConfig(max_len=32, policy=ops.policy_named("eager"))
    rules = ShardingRules.for_mesh(mesh)
    for arch in FSDP_ARCHS:
        ref = np.load(os.path.join(workdir, f"fsdp_ref_{arch}.npz"))
        cfg = replace(get(arch, smoke=True), dtype="float32")
        params = {k.split(":", 1)[1]: torch.from_numpy(ref[k])
                  for k in ref.files if k.startswith("param:")}
        eng = ServingEngine(cfg, params, scfg, rules=rules, device="cpu")
        assert eng.gathers is not None, arch
        got = eng.generate(ref["prompts"], ref["tokens"].shape[1])
        np.testing.assert_array_equal(got, ref["tokens"], err_msg=arch)
