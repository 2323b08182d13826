"""The ranks of ``tests/test_torch_dist_train.py``: one spawned process a
rank of a gloo world, rendezvous through a ``FileStore``, one torch
thread.  Every check holds training over the mesh against one process
on the whole batch: each parameter's gradient, gathered whole, within
``GRAD_RTOL`` of the one-process gradient at float32.  Inputs are made
from seeds with NumPy.  Imports torch, NumPy and the port only."""

import os
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import restore, save
from repro_torch.configs import get
from repro_torch.data import (DataConfig, device_transform, make_stream,
                              shard_for)
from repro_torch.dist import compress as C
from repro_torch.dist import spmd
from repro_torch.dist.sharding import ShardingRules
from repro_torch.models import model as LM
from repro_torch.models import vit
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.train import (LoopConfig, TrainConfig, TrainLoop,
                               make_train_step)

GRAD_RTOL = 1e-5     # mesh against one process, float32, of a leaf's max


def _f32(arch, **moe):
    cfg = replace(get(arch, smoke=True), dtype="float32")
    if moe:
        cfg = replace(cfg, moe=replace(cfg.moe, **moe))
    return cfg


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


def check_grads(mesh, label, cfg, batch, fsdp=True, accum=1,
                loss_fn=None):
    """The mesh step's gradients, gathered whole, and its loss against
    one process's on the whole batch."""
    tcfg = TrainConfig(opt=OptConfig(), accum_steps=accum)
    params = _params(cfg)
    want_loss, want = make_train_step(cfg, tcfg, loss_fn=loss_fn).grads(
        params, device_transform("cpu")(batch))
    rules = ShardingRules.for_mesh(mesh, fsdp=fsdp)
    step = make_train_step(cfg, tcfg, rules=rules, loss_fn=loss_fn)
    lay = step.layout
    loss, got = step.grads(lay.shard_params(params),
                           shard_for(batch, rules, "cpu",
                                     accum_steps=accum))
    got = _whole(got, lay.params, mesh)
    assert set(got) == set(want)
    _close(f"{label} loss", loss, want_loss)
    for k in want:
        _close(f"{label} {k}", got[k], want[k])


def check_dense(mesh):
    cfg = _f32("llama3_2_1b")
    for fsdp in (True, False, "moe_only"):
        check_grads(mesh, f"llama fsdp={fsdp}", cfg, _lm_batch(cfg),
                    fsdp=fsdp)
    check_grads(mesh, "llama masks", cfg, _lm_batch(cfg, masked=True))
    check_grads(mesh, "llama accum 2", cfg, _lm_batch(cfg, masked=True),
                accum=2)


def check_factored(mesh):
    """A whole step with the factored second moment (its row and column
    means all-reduced where their dim is sharded) and the sharded global
    norm: the grad norm, the parameters and the moments, gathered whole,
    against one process.  AdamW's eps is 1, so an update is proportional
    to its gradient (at eps 1e-8 the first step is the gradient's sign,
    which a near-zero element's two sum orders may disagree on)."""
    cfg = _f32("llama3_2_1b")
    ocfg = OptConfig(factored=True, factored_min_size=8, eps=1.0, lr=1e-2,
                     warmup_steps=1)
    tcfg = TrainConfig(opt=ocfg)
    params = _params(cfg)
    opt = adamw_init(params, ocfg)
    assert any("vr" in s for s in opt["ema"].values())
    batch = _lm_batch(cfg)
    want_p, want_o, want_m = make_train_step(cfg, tcfg)(
        params, opt, device_transform("cpu")(batch))
    rules = ShardingRules.for_mesh(mesh)
    step = make_train_step(cfg, tcfg, rules=rules)
    lay = step.layout
    got_p, got_o, got_m = step(lay.shard_params(params),
                               lay.shard_opt_state(opt),
                               shard_for(batch, rules, "cpu"))
    _close("grad norm", got_m["grad_norm"], want_m["grad_norm"])
    for k, v in _whole(got_p, lay.params, mesh).items():
        _close(f"factored {k}", v, want_p[k])
    specs = lay.tree_specs({"opt": got_o})
    for k, st in got_o["ema"].items():
        for leaf, t in st.items():
            with torch.no_grad():
                whole = spmd.gather_param(t, specs[f"opt.ema.{k}.{leaf}"],
                                          mesh)
            _close(f"factored {k}.{leaf}", whole, want_o["ema"][k][leaf])


def check_m3vit(mesh):
    batch = _vit_batch()
    for impl in ("grouped", "ep_local"):
        cfg = _f32("m3vit", impl=impl)
        for fsdp in ((True, "moe_only") if impl == "grouped" else (True,)):
            check_grads(mesh, f"m3vit {impl} fsdp={fsdp}", cfg, batch,
                        fsdp=fsdp, loss_fn=_m3vit_loss(cfg))


def check_spanning(mesh):
    """A MoE LM whose one routing group spans the data ranks: the gate's
    gradient comes back through the gathered logits."""
    cfg = _f32("llama4_scout_17b_a16e", group_size=64)
    check_grads(mesh, "scout spanning", cfg, _lm_batch(cfg))


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
          "m3vit": check_m3vit,
          "spanning": check_spanning, "nan": check_nan,
          "checkpoint": check_checkpoint, "launcher": check_launcher,
          "compress": check_compress}
NEEDS_DIR = ("checkpoint", "launcher")


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
