"""The ranks of ``tests/test_torch_dist_train.py``: one spawned process a
rank of a gloo world, rendezvous through a ``FileStore``, one torch
thread.  Every check holds training over the mesh against one process
on the whole batch: each parameter's gradient, gathered whole, within
``GRAD_RTOL`` of the one-process gradient at float32.  Where ``model``
has more than one rank the step is tensor-parallel: the leaves a rank
computes on its block of are gathered over the batch axes alone, which
every check reads off the collective record.  Inputs are made from seeds
with NumPy.  Imports torch, NumPy and the port only (the JAX reference's
gradients come in an ``.npz`` the parent test writes)."""

import os
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import ops
from repro_torch.checkpoint import restore, save
from repro_torch.configs import get
from repro_torch.data import (DataConfig, device_transform, make_stream,
                              shard_for)
from repro_torch.dist import compress as C
from repro_torch.dist import spmd
from repro_torch.dist.sharding import ShardingRules, use_rules
from repro_torch.models import model as LM
from repro_torch.models import transformer as T
from repro_torch.models import vit
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.optim.adamw import global_norm
from repro_torch.serve.engine import local_params
from repro_torch.tree import unflatten
from repro_torch.train import (LoopConfig, TrainConfig, TrainLoop,
                               make_train_step)

GRAD_RTOL = 1e-5     # mesh against one process, float32, of a leaf's max
#: the same under the LUT activations where ``model`` splits: a float32
#: pre-activation on a table-index half-step may take the neighbouring
#: entry under the split's sum order, so the bound is the LUT's
#: (``tests/test_torch_m3vit.py:LUT_BOUND``, 2.5x its largest reading)
LUT_RTOL = 5e-4
#: the xLSTM's gradients over a mesh that splits its heads, float32, of
#: a leaf's max: its exp-stabilised recurrences carry the split's other
#: sum orders (1e-7) further than the dense blocks do — the largest
#: reading at 1x2 and 2x2 is 3.2e-5 (``b_if``: 8 values, each a sum over
#: every token), while a gradient missing the ranks' sum or counted
#: ``tp`` times is off by O(1); one process's two microbatch orders
#: already differ by 2.7e-6
XLSTM_RTOL = 1e-4
JAX_RTOL = 1e-5      # the 1x2 mesh against jax.value_and_grad, float32
LOSS_RTOL = 1e-6     # the vocab-parallel loss against the gathered logits


def _f32(arch, **moe):
    cfg = replace(get(arch, smoke=True), dtype="float32")
    if moe:
        cfg = replace(cfg, moe=replace(cfg.moe, **moe))
    return cfg


def _exact(cfg):
    """``cfg`` under the ``eager`` policy's exact activations: the LUT's
    index flips at a half-step, so the float32 noise of a column block's
    product or of the ranks' summed partials (1e-6) can move a LUT output
    by 2e-4 of its magnitude (the reference's own LUT impls differ by as
    much, ``ROADMAP.md`` §3 item 4), which would hide what a
    tensor-parallel check reads."""
    return replace(cfg, policy=ops.policy_named("eager"))


def _policies(cfg, mesh) -> list:
    """(label, config, rtol) of each run of a check: where ``mesh`` splits
    ``model`` (its float32 sums then run in another order) ``cfg`` under
    exact activations (:func:`_exact`) at ``GRAD_RTOL`` and as it is, its
    LUT activations, at ``LUT_RTOL``; otherwise ``cfg`` at ``GRAD_RTOL``."""
    if spmd.axis_size(mesh, "model") == 1:
        return [("", cfg, GRAD_RTOL)]
    return [(" exact", _exact(cfg), GRAD_RTOL), (" lut", cfg, LUT_RTOL)]


def _m3vit_loss(cfg):
    """semseg + depth on one batch (the reference's test_vit loss)."""
    def loss_fn(p, b):
        l0, _ = vit.multitask_loss(p, b["image"], b["semseg"], cfg,
                                   "semseg")
        l1, _ = vit.multitask_loss(p, b["image"], b["depth"], cfg, "depth")
        return l0 + l1, None
    return loss_fn


def _lm_batch(cfg, rows=4, seq=16, seed=0, masked=False):
    b = make_stream(DataConfig(batch=rows, seq_len=seq,
                               vocab_size=cfg.vocab_size,
                               seed=seed)).batch(0)
    if masked:     # rows of the second half mostly masked, unevenly
        lab = b["labels"]
        lab[rows // 2:, 3:] = -100
        lab[rows - 1, 1:] = -100
        lab[0, ::5] = -100
    return b


def _vit_batch(rows=4, seed=0):
    return make_stream(DataConfig(batch=rows, seq_len=0, kind="m3vit",
                                  seed=seed)).batch(0)


def _params(cfg):
    if cfg.family == "vit-moe":
        return vit.init_params(0, cfg, device="cpu")
    return LM.init_params(0, cfg, device="cpu")


def _whole(tree, specs, mesh):
    with torch.no_grad():
        return {k: spmd.gather_param(v, specs[k], mesh)
                for k, v in tree.items()}


def _close(label, got, want, rtol=GRAD_RTOL):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rtol * max(scale, 1e-30), (label, err, scale)


def _collectives() -> dict:
    return {(c["kind"], c["axis"], c["where"]): c["count"]
            for c in ops.collective_report()}


def _model_gathers(label, lay, record) -> None:
    """The step gathered over ``model`` only the whole leaves (those
    outside ``lay.keep``), never a split one."""
    whole = [k for k, spec in lay.params.items()
             if k not in lay.keep and any(
                 "model" in ((e,) if isinstance(e, str) else e or ())
                 for e in spec)]
    got = record.get(("all_gather", "model", "param gather"), 0)
    assert got == len(whole), (label, got, whole)


def check_grads(mesh, label, cfg, batch, fsdp=True, accum=1,
                loss_fn=None, params=None, want=None, rtol=GRAD_RTOL):
    """The mesh step's gradients, gathered whole, and its loss against
    one process's on the whole batch (or ``want``: (loss, gradients));
    returns (layout, the step's collectives, its gradient blocks, the
    gradients it was held to)."""
    tcfg = TrainConfig(opt=OptConfig(), accum_steps=accum)
    params = _params(cfg) if params is None else params
    if want is None:
        want = make_train_step(cfg, tcfg, loss_fn=loss_fn).grads(
            params, device_transform("cpu")(batch))
    want_loss, want = want
    rules = ShardingRules.for_mesh(mesh, fsdp=fsdp)
    step = make_train_step(cfg, tcfg, rules=rules, loss_fn=loss_fn)
    lay = step.layout
    blocks = lay.shard_params(params)
    ops.reset_dispatch_report()
    loss, got = step.grads(blocks, shard_for(batch, rules, "cpu",
                                             accum_steps=accum))
    record = _collectives()
    _model_gathers(label, lay, record)
    if spmd.axis_size(mesh, "model") > 1:
        assert set(lay.keep) >= set(T.model_blocks(cfg, rules)), label
    whole = _whole(got, lay.params, mesh)
    assert set(whole) == set(want)
    _close(f"{label} loss", loss, want_loss, rtol)
    for k in want:
        _close(f"{label} {k}", whole[k], want[k], rtol)
    return lay, record, got, want


def check_dense(mesh):
    """The smoke Llama under ``fsdp`` True, False and ``"moe_only"``,
    with masks that differ by rank and with 2 microbatches; where
    ``model`` splits, under exact and LUT activations (:func:`_policies`)."""
    for how, cfg, rtol in _policies(_f32("llama3_2_1b"), mesh):
        for fsdp in (True, False, "moe_only"):
            check_grads(mesh, f"llama{how} fsdp={fsdp}", cfg, _lm_batch(cfg),
                        fsdp=fsdp, rtol=rtol)
        check_grads(mesh, f"llama{how} masks", cfg,
                    _lm_batch(cfg, masked=True), rtol=rtol)
        check_grads(mesh, f"llama{how} accum 2", cfg,
                    _lm_batch(cfg, masked=True), accum=2, rtol=rtol)


def _tp_collectives(label, cfg, record, tp) -> None:
    """A tensor-parallel step's collectives over ``model``: each layer's
    attention and MLP all-reduce in the forward and their inputs' ``f``
    in the backward, one embedding all-reduce, the head's ``f`` and the
    loss's three (B, S) reduces; no logits all-gather."""
    layers = cfg.num_layers
    expect = {"attn_out all-reduce": layers, "mlp_down all-reduce": layers,
              "attn input (backward)": layers,
              "mlp input (backward)": layers, "embed all-reduce": 1,
              "lm_head input (backward)": 1, "loss max": 1,
              "loss sum-exp": 1, "loss label logit": 1}
    got = {w: record.get(("all_reduce", "model", w)) for w in expect}
    assert got == expect, (label, tp, got)
    assert not any(w == "logits all-gather" for _, _, w in record), label


def check_tp(mesh):
    """The smoke Llama at float32 tensor-parallel, its masks differing by
    rank: the gradients against one process; every kept leaf's stored
    block, gathered over the batch axes alone, is the block serving's
    ``local_params`` narrows; the collectives as counted; the sharded
    global norm counts each block and whole leaf once.  In a world of
    four also over (1, 4), where the KV heads do not divide the axis and
    each rank reads its q heads' one KV head.  Exact activations
    (:func:`_exact`)."""
    cfg = _exact(_f32("llama3_2_1b"))
    meshes = [mesh]
    if dist.get_world_size() == 4:
        meshes.append(spmd.init_mesh((1, 4), device_type="cpu"))
    for m in meshes:
        tp = spmd.axis_size(m, "model")
        label = f"tp over {tuple(m.shape)}"
        lay, record, got, want = check_grads(m, label, cfg,
                                             _lm_batch(cfg, masked=True))
        if tp == 1:
            continue
        _tp_collectives(label, cfg, record, tp)
        whole = _params(cfg)
        narrowed = local_params(whole, cfg, lay.rules)
        blocks = lay.shard_params(whole)
        assert lay.keep, label
        with torch.no_grad():
            for k, axes in lay.keep.items():
                held = spmd.gather_param(blocks[k], lay.params[k], m, axes)
                assert torch.equal(held, narrowed[k]), (label, k)
        # the whole k/v (KV heads not dividing the axis) through the f
        kv = record.get(("all_reduce", "model", "attn kv (backward)"), 0)
        assert kv == (0 if cfg.num_kv_heads % tp == 0
                      else 2 * cfg.num_layers), (label, kv)
        norm = global_norm(got, lay.params, m)
        _close(f"{label} global norm", norm, global_norm(want))


def check_mqa(mesh):
    """One KV head: k/v whole on every rank, each rank's gradient of
    ``wk``/``wv`` a part the ``model`` ranks sum (exact activations,
    :func:`_exact`)."""
    cfg = replace(_exact(_f32("llama3_2_1b")), num_kv_heads=1)
    lay, record, *_ = check_grads(mesh, "mqa", cfg,
                                  _lm_batch(cfg, masked=True))
    if spmd.axis_size(mesh, "model") > 1:
        assert "layers.b0.attn.wk" not in lay.keep, lay.keep
        kv = record.get(("all_reduce", "model", "attn kv (backward)"), 0)
        assert kv == 2 * cfg.num_layers, kv


def check_recurrent(mesh):
    """The smoke RecurrentGemma (untied head, MQA local attention, 64
    RG-LRU channels over 4 gate heads): its MLPs, head and RG-LRU mixers
    split over ``model`` — every ``rglru`` leaf kept local, never gathered
    over ``model`` (:func:`check_grads`), its gradients against one
    process, each mixer's ``rglru_down`` all-reduce in the forward and its
    input's ``f`` in the backward — then a whole step with the factored
    second moment (the 3-D ``gates`` factored per head) and the sharded
    global norm against one process (exact activations, :func:`_exact`).
    In a world of four also over (1, 4)."""
    cfg = _exact(_f32("recurrentgemma_9b"))
    meshes = [mesh]
    if dist.get_world_size() == 4:
        meshes.append(spmd.init_mesh((1, 4), device_type="cpu"))
    for m in meshes:
        label = f"recurrent over {tuple(m.shape)}"
        lay, record, got, want = check_grads(m, label, cfg, _lm_batch(cfg))
        if spmd.axis_size(m, "model") > 1:
            assert any(".mlp." in k for k in lay.keep) \
                and "head.w" in lay.keep
            mixers = [k for k in lay.params if ".rglru." in k]
            assert mixers and all(lay.keep.get(k) == ("model",)
                                  for k in mixers), (label, lay.keep)
            assert not any(w == "logits all-gather" for _, _, w in record)
            n = sum(cfg.block_kind(i) == "rglru_mlp"
                    for i in range(cfg.num_layers))
            for at in ("rglru_down all-reduce", "rglru input (backward)"):
                assert record.get(("all_reduce", "model", at)) == n, \
                    (label, at, record)
            _close(f"{label} global norm",
                   global_norm(got, lay.params, m), global_norm(want))
        _factored_step(m, f" {label}", cfg, GRAD_RTOL)


def check_xlstm(mesh):
    """The smoke xLSTM (7 mLSTM blocks and 1 sLSTM, 4 heads; at d_model 96
    also its sLSTM's 128-wide up-projection, which ``model`` divides):
    where ``model`` divides the heads every split mixer leaf is kept
    local, never gathered over ``model`` (:func:`check_grads`), and its
    gradients — those of the whole ``w_if``, ``b_if``, ``b_gates`` and
    ``gn_scale`` each rank reads for its heads alone among them — match
    one process within ``XLSTM_RTOL``; the collectives as counted: per
    mLSTM the uc and qkv all-gathers, the down all-reduce and the ``f``
    of its input, of uc and qkv and of its three partly-read whole leaves
    in the backward, per sLSTM the hn all-gather, its input's and its two
    whole leaves' ``f`` (and the split up-projection's down all-reduce
    and input ``f``); then a whole step with the factored second moment
    (``r_gates`` factored per head) against one process.  Exact
    activations (:func:`_exact`)."""
    from repro_torch.models import xlstm as XL

    tp = spmd.axis_size(mesh, "model")
    for d in (64, 96):
        cfg = replace(_exact(_f32("xlstm_350m")), d_model=d)
        label = f"xlstm d={d} over {tuple(mesh.shape)}"
        lay, record, got, want = check_grads(mesh, label, cfg,
                                             _lm_batch(cfg),
                                             rtol=XLSTM_RTOL)
        if tp == 1:
            continue
        assert XL.split_over(cfg, tp), label
        split_up = (4 * d // 3) % tp == 0
        split = {".mlstm.": ("w_up", "w_gates", "w_qkv", "conv", "w_down"),
                 ".slstm.": ("w_gates", "r_gates") + (
                     ("w_up", "w_up2", "w_down") if split_up else ())}
        for k in lay.params:
            for kind, leaves in split.items():
                if kind in k:
                    kept = lay.keep.get(k) == ("model",)
                    assert kept == (k.rsplit(".", 1)[-1] in leaves), \
                        (label, k, lay.keep.get(k))
        kinds = [cfg.block_kind(i) for i in range(cfg.num_layers)]
        nm, ns = kinds.count("mlstm"), kinds.count("slstm")
        expect = {("all_gather", "mlstm_uc all-gather"): nm,
                  ("all_gather", "mlstm_qkv all-gather"): nm,
                  ("all_reduce", "mlstm_down all-reduce"): nm,
                  ("all_reduce", "mlstm input (backward)"): nm,
                  ("all_reduce", "mlstm_uc input (backward)"): nm,
                  ("all_reduce", "mlstm_qkv input (backward)"): nm,
                  ("all_reduce", "mlstm whole leaves (backward)"): 3 * nm,
                  ("all_gather", "slstm_hn all-gather"): ns,
                  ("all_reduce", "slstm input (backward)"): ns,
                  ("all_reduce", "slstm whole leaves (backward)"): 2 * ns,
                  ("all_reduce", "slstm_down all-reduce"):
                  ns if split_up else None,
                  ("all_reduce", "slstm_up input (backward)"):
                  ns if split_up else None}
        seen = {(kind, w): record.get((kind, "model", w))
                for kind, w in expect}
        assert seen == expect, (label, seen)
        _close(f"{label} global norm", global_norm(got, lay.params, mesh),
               global_norm(want), XLSTM_RTOL)
    _factored_step(mesh, " xlstm", _exact(_f32("xlstm_350m")), XLSTM_RTOL)


def check_vocab_loss(mesh):
    """Under tensor parallelism ``lm_loss``'s cross-entropy of the head's
    vocabulary block equals that of the logits gathered whole, within
    ``LOSS_RTOL`` in value and in each block's gradient."""
    if spmd.axis_size(mesh, "model") == 1:
        return
    for arch in ("llama3_2_1b", "recurrentgemma_9b"):   # tied, untied
        cfg = _f32(arch)
        rules = ShardingRules.for_mesh(mesh, fsdp=False)
        mine = {k: v.requires_grad_() for k, v in
                local_params(_params(cfg), cfg, rules).items()}
        batch = device_transform("cpu")(_lm_batch(cfg, masked=True))
        losses, grads = [], []
        for gather in (False, True):
            with use_rules(rules):
                logits, _, _ = T.forward(unflatten(mine), batch["inputs"],
                                         cfg, gather_logits=False)
                if gather:
                    logits = spmd.model_gather(logits, "logits all-gather")
                    assert logits.shape[-1] == cfg.vocab_size
                loss = LM.cross_entropy(logits, batch["labels"], cfg)
            losses.append(loss)
            grads.append(torch.autograd.grad(loss, list(mine.values())))
        _close(f"{arch} vocab-parallel loss", losses[0], losses[1],
               LOSS_RTOL)
        for k, a, b in zip(mine, *grads):
            _close(f"{arch} vocab-parallel loss {k}", a, b, LOSS_RTOL)


def check_jax(mesh, workdir):
    """The smoke Llama's gradients at float32 over the mesh against the
    JAX reference's ``jax.value_and_grad`` of its ``lm_loss``, on the
    parameters it drew (``jax_grads.npz``, the parent's), both under
    exact activations (the reference's ``xla`` preset, :func:`_exact`)."""
    ref = np.load(os.path.join(workdir, "jax_grads.npz"))
    cfg = _exact(_f32("llama3_2_1b"))
    pick = {kind: {k.split(":", 1)[1]: torch.from_numpy(ref[k])
                   for k in ref.files if k.startswith(kind + ":")}
            for kind in ("param", "grad")}
    check_grads(mesh, "jax", cfg, _lm_batch(cfg, masked=True),
                params=pick["param"],
                want=(torch.from_numpy(ref["loss"]), pick["grad"]),
                rtol=JAX_RTOL)


def check_factored(mesh):
    """A whole step with the factored second moment (its row and column
    means all-reduced where their dim is sharded) and the sharded global
    norm: the grad norm, the parameters and the moments, gathered whole,
    against one process.  AdamW's eps is 1, so an update is proportional
    to its gradient (at eps 1e-8 the first step is the gradient's sign,
    which a near-zero element's two sum orders may disagree on); where
    ``model`` splits, under exact and LUT activations (:func:`_policies`)."""
    for how, cfg, rtol in _policies(_f32("llama3_2_1b"), mesh):
        _factored_step(mesh, how, cfg, rtol)


def _factored_step(mesh, how, cfg, rtol):
    ocfg = OptConfig(factored=True, factored_min_size=8, eps=1.0, lr=1e-2,
                     warmup_steps=1)
    tcfg = TrainConfig(opt=ocfg)
    params = _params(cfg)
    opt = adamw_init(params, ocfg)
    assert any("vr" in s for s in opt["ema"].values())
    if cfg.lru_width:
        assert "vr" in opt["ema"]["layers.b0.rglru.gates"]
    if "slstm" in cfg.block_pattern:
        assert "vr" in opt["ema"]["layers.b7.slstm.r_gates"]
    batch = _lm_batch(cfg)
    want_p, want_o, want_m = make_train_step(cfg, tcfg)(
        params, opt, device_transform("cpu")(batch))
    rules = ShardingRules.for_mesh(mesh)
    step = make_train_step(cfg, tcfg, rules=rules)
    lay = step.layout
    got_p, got_o, got_m = step(lay.shard_params(params),
                               lay.shard_opt_state(opt),
                               shard_for(batch, rules, "cpu"))
    _close(f"factored{how} grad norm", got_m["grad_norm"],
           want_m["grad_norm"], rtol)
    for k, v in _whole(got_p, lay.params, mesh).items():
        _close(f"factored{how} {k}", v, want_p[k], rtol)
    specs = lay.tree_specs({"opt": got_o})
    for k, st in got_o["ema"].items():
        for leaf, t in st.items():
            with torch.no_grad():
                whole = spmd.gather_param(t, specs[f"opt.ema.{k}.{leaf}"],
                                          mesh)
            _close(f"factored{how} {k}.{leaf}", whole,
                   want_o["ema"][k][leaf], rtol)


def check_m3vit(mesh):
    batch = _vit_batch()
    for impl in ("grouped", "ep_local"):
        cfg = _f32("m3vit", impl=impl)
        for fsdp in ((True, "moe_only") if impl == "grouped" else (True,)):
            check_grads(mesh, f"m3vit {impl} fsdp={fsdp}", cfg, batch,
                        fsdp=fsdp, loss_fn=_m3vit_loss(cfg))


def check_spanning(mesh):
    """A MoE LM whose one routing group spans the data ranks: the gate's
    gradient comes back through the gathered logits; where ``model``
    splits, under exact and LUT activations (:func:`_policies`)."""
    for how, cfg, rtol in _policies(
            _f32("llama4_scout_17b_a16e", group_size=64), mesh):
        check_grads(mesh, f"scout spanning{how}", cfg, _lm_batch(cfg),
                    rtol=rtol)


def check_nan(mesh):
    """A NaN pixel in the last rank's rows: every rank skips the step,
    its blocks and state bit-identical."""
    cfg = _f32("m3vit")
    rules = ShardingRules.for_mesh(mesh)
    ocfg = OptConfig()
    step = make_train_step(cfg, TrainConfig(opt=ocfg), rules=rules,
                           loss_fn=_m3vit_loss(cfg))
    whole = _params(cfg)
    params = step.layout.shard_params(whole)
    opt = step.layout.shard_opt_state(adamw_init(whole, ocfg))
    bad = _vit_batch()
    bad["image"][3, 5, 7, 1] = np.nan
    p2, o2, m = step(params, opt, shard_for(bad, rules, "cpu"))
    assert int(m["skipped"]) == 1 and not np.isfinite(float(m["loss"]))
    assert all(torch.equal(p2[k], params[k]) for k in params)
    assert torch.equal(o2["step"], opt["step"])
    assert all(torch.equal(o2["ema"][k][s], opt["ema"][k][s])
               for k in opt["ema"] for s in opt["ema"][k])


def check_checkpoint(mesh, workdir):
    """A checkpoint taken over the mesh holds the whole tree and restores
    without one; one taken without a mesh restores into the blocks."""
    cfg = _f32("llama3_2_1b")
    rules = ShardingRules.for_mesh(mesh)
    ocfg = OptConfig(warmup_steps=1, total_steps=4)
    step = make_train_step(cfg, TrainConfig(opt=ocfg), rules=rules)
    lay = step.layout
    whole = _params(cfg)
    stream = make_stream(DataConfig(batch=4, seq_len=16,
                                    vocab_size=cfg.vocab_size, seed=0))
    d = os.path.join(workdir, "mesh_ckpt")
    loop = TrainLoop(LoopConfig(total_steps=2, ckpt_dir=d, ckpt_every=2),
                     step, stream, lay.shard_params(whole),
                     lay.shard_opt_state(adamw_init(whole, ocfg)),
                     log=lambda s: None, layout=lay,
                     batch_transform=lambda b: shard_for(b, rules, "cpu"))
    st = loop.run()
    assert st.step == 2 and st.nan_skip_count == 0
    mine = _whole(loop.params, lay.params, mesh)
    like = {"params": whole, "opt": adamw_init(whole, ocfg)}
    got = restore(d, 2, like)                       # no mesh
    assert all(torch.equal(got["params"][k], mine[k]) for k in mine)
    # the reverse: rank 0 writes without a mesh, every rank restores
    d2 = os.path.join(workdir, "plain_ckpt")
    if dist.get_rank() == 0:
        save(d2, 2, got)
    dist.barrier()
    blocks = restore(d2, 2, {"params": loop.params, "opt": loop.opt_state},
                     layout=lay)
    assert all(torch.equal(blocks["params"][k], loop.params[k])
               for k in loop.params)
    for k, s in loop.opt_state["ema"].items():
        for leaf, t in s.items():
            assert torch.equal(blocks["opt"]["ema"][k][leaf], t), (k, leaf)
    # two ranks: the mesh checkpoint restores at the other shape (1x2 at
    # 2x1 and the reverse), its blocks gathered whole the same leaves
    if dist.get_world_size() == 2:
        other = spmd.init_mesh(tuple(reversed(tuple(mesh.shape))),
                               device_type="cpu")
        lay2 = make_train_step(cfg, TrainConfig(opt=ocfg),
                               rules=ShardingRules.for_mesh(other)).layout
        like = {"params": lay2.shard_params(whole),
                "opt": lay2.shard_opt_state(adamw_init(whole, ocfg))}
        there = restore(d, 2, like, layout=lay2)
        back = _whole(there["params"], lay2.params, other)
        assert all(torch.equal(back[k], mine[k]) for k in mine)
    dist.barrier()


def check_launcher(mesh, workdir):
    """``launch/train.py --mesh local --device cpu`` on every rank: a
    ("data",) mesh over the world, 3 steps and a checkpoint; one process
    restores it without a mesh and trains on."""
    from repro_torch.launch import train as LT

    d = os.path.join(workdir, "launch_ckpt")
    argv = ["--arch", "llama3_2_1b", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq-len", "16", "--warmup", "1",
            "--ckpt-dir", d, "--ckpt-every", "3"]
    loop = LT.run(argv + ["--steps", "3", "--mesh", "local"])
    assert loop.layout is not None and loop.state.step == 3
    assert spmd.axis_names(loop.layout.mesh) == ("data",)
    if dist.get_rank() == 0:
        plain = LT.run(argv + ["--steps", "3", "--ckpt-dir",
                               os.path.join(workdir, "launch_plain")])
        for (s, a), (_, b) in zip(loop.state.history, plain.state.history):
            assert abs(a - b) <= 1e-2 * abs(b), (s, a, b)
        resumed = LT.run(argv + ["--steps", "5"])    # no mesh
        assert resumed.state.step == 5 and len(resumed.state.history) == 2
    dist.barrier()


def check_compress(mesh):
    """``compressed_psum`` over the data ranks and the stacked mean: the
    sum and mean of each rank's dequantized payload, its carry
    ``gf - deq`` bit for bit."""
    rows = []
    for r in range(dist.get_world_size()):
        rows.append(np.random.default_rng(r).standard_normal(
            (3, 300)).astype(np.float32))
    me = torch.from_numpy(rows[dist.get_rank()])
    err = C.init_error_state({"w": me})
    deqs = []
    for r in rows:
        q, s = C.quantize_int8(torch.from_numpy(r))
        deqs.append(C.dequantize_int8(q, s, r.shape))
    out, new_err = C.compressed_psum({"w": me}, err, mesh,
                                     axes=spmd.axis_names(mesh))
    total = deqs[0]
    for t in deqs[1:]:
        total = total + t
    torch.testing.assert_close(out["w"], total, rtol=1e-6, atol=1e-6)
    assert torch.equal(new_err["w"], me - deqs[dist.get_rank()])
    mean, _ = C.compressed_allreduce_stacked({"w": me[None]},
                                             {"w": err["w"][None]}, mesh)
    torch.testing.assert_close(mean["w"][0], total / len(rows), rtol=1e-6,
                               atol=1e-6)


CHECKS = {"dense": check_dense, "factored": check_factored,
          "m3vit": check_m3vit, "tp": check_tp, "mqa": check_mqa,
          "recurrent": check_recurrent, "xlstm": check_xlstm,
          "vocab_loss": check_vocab_loss,
          "jax": check_jax,
          "spanning": check_spanning, "nan": check_nan,
          "checkpoint": check_checkpoint, "launcher": check_launcher,
          "compress": check_compress}
NEEDS_DIR = ("checkpoint", "launcher", "jax")


def run(rank, world, shape, store, checks):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        mesh = spmd.init_mesh(shape, device_type="cpu")
        workdir = os.path.dirname(store)
        for name in checks:
            if name in NEEDS_DIR:
                CHECKS[name](mesh, workdir)
            else:
                CHECKS[name](mesh)
        dist.barrier()
    finally:
        dist.destroy_process_group()
