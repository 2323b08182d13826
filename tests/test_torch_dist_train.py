"""Training over a mesh, on the CPU.

Spawned gloo worlds (``tests/_torch_train_worker.py``), one spawn a mesh
shape — 2×1, 1×2, 2×2 — rendezvous through a ``FileStore`` under
``tmp_path``: every parameter's gradient of the mesh step, gathered
whole, against one process's whole-batch gradient at float32 within
1e-5 of the leaf's largest, for the smoke Llama under ``fsdp`` True,
False and ``"moe_only"``, with masks that differ between ranks and with
``accum_steps=2``; a whole step with the factored second moment (its
means all-reduced where a dim is sharded) and the sharded global norm;
the smoke M³ViT under ``grouped`` (``fsdp`` True and
``"moe_only"``) and ``ep_local`` (at 1×2 an overcounting sum over
``model`` shows); a MoE LM whose one routing group spans the data ranks
(the gate's gradient through the gathered logits); a NaN on one rank
skipped by all; checkpoints across mesh and no mesh both ways, and at
two ranks across 1×2 and 2×1; ``compressed_psum`` and the stacked mean
over the ranks; and at 2×1 ``launch/train.py --mesh local --device
cpu``.  Where ``model`` has two ranks (1×2, 2×2) every check runs the
tensor-parallel step, which never gathers a split leaf over ``model``
(each check reads the collective record); ``tp`` adds the collectives
as counted, the stored blocks against serving's ``local_params`` and the
global norm, and at 2×2 a (1, 4) mesh whose KV heads do not divide the
axis; ``mqa`` one KV head whose whole ``wk``/``wv`` gradients the model
ranks sum; ``recurrent`` the smoke RecurrentGemma (MLPs, head and RG-LRU
mixers split, each mixer's leaves kept local over ``model`` and its
collectives counted; a factored step with its 3-D gates and the sharded
global norm); at 1×2 and 2×2 ``xlstm`` the smoke xLSTM with its mLSTM
and sLSTM heads split (at d_model 96 its sLSTM up-projection too), the
gradients of every leaf — the whole ``w_if``, ``b_if``, ``b_gates`` and
``gn_scale`` each rank reads in part among them — within
``_torch_train_worker.XLSTM_RTOL``, the split leaves kept local, the
collectives counted, a factored step; ``vocab_loss`` the vocab-parallel
loss against the gathered logits within 1e-6; at 1×2 ``jax`` the gradients against the
reference's ``jax.value_and_grad`` of its ``lm_loss``.

In process: the step under rules at a world of one bit for bit against
no rules, and against the reference's ``make_train_step`` with rules (on
a (1, 1) mesh of ``Auto`` axes: jax 0.9.0's default ``Explicit`` axes
refuse the reference's ``with_sharding_constraint``); ``gather_param``'s
backward; the device-free mesh; the production meshes; the launcher
outside ``torchrun``."""

import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_train_worker as W
from repro import configs as jconfigs
from repro.dist.sharding import ShardingRules as JRules
from repro.models import model as JM
from repro.ops import policy_named as jpolicy_named
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro_torch import ops
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get
from repro_torch.data import DataConfig, device_transform, make_stream, \
    shard_for
from repro_torch.dist import spmd
from repro_torch.dist.sharding import P, ShardingRules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as TM
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.train import TrainConfig, make_train_step
from test_torch_threads import one_torch_thread  # noqa: F401

TRAIN = ("dense", "factored", "m3vit", "spanning", "nan", "checkpoint",
         "compress", "tp", "mqa", "recurrent", "vocab_loss")


@pytest.mark.parametrize("shape,checks", [
    ((2, 1), TRAIN + ("launcher",)), ((1, 2), TRAIN + ("jax", "xlstm")),
    ((2, 2), TRAIN + ("xlstm",))], ids=["2x1", "1x2", "2x2"])
def test_mesh_training_world(shape, checks, tmp_path):
    world = shape[0] * shape[1]
    if "jax" in checks:
        _jax_reference(os.path.join(tmp_path, "jax_grads.npz"))
    mp.start_processes(W.run, args=(world, shape,
                                    os.path.join(tmp_path, "store"), checks),
                       nprocs=world, start_method="spawn")


def _jax_reference(path):
    """The reference's ``jax.value_and_grad`` of its ``lm_loss`` on the
    smoke Llama at float32 under its exact activations (``xla``) and the
    worker's masked batch, with the
    parameters it drew carried into the port by the bridge: the ranks'
    ``jax`` check reads them (``param:``/``grad:`` + the port's names,
    ``loss``) and holds the tensor-parallel step at 1×2 to them within
    ``_torch_train_worker.JAX_RTOL``, the loss bound of
    ``test_step_under_rules_matches_the_reference``."""
    jcfg = replace(jconfigs.get("llama3_2_1b", smoke=True), dtype="float32",
                   policy=jpolicy_named("xla"))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    batch = W._lm_batch(W._f32("llama3_2_1b"), masked=True)
    loss, grads = jax.value_and_grad(lambda p: JM.lm_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)[0])(jp)
    out = {"loss": np.asarray(loss)}
    for kind, tree in (("param", jp), ("grad", grads)):
        for k, v in params_from_jax(jax.device_get(tree),
                                    device="cpu").items():
            out[f"{kind}:{k}"] = v.numpy()
    np.savez(path, **out)


def _lm_setup(accum=1, factored=False):
    cfg = get("llama3_2_1b", smoke=True)
    ocfg = OptConfig(factored=factored, factored_min_size=8)
    tcfg = TrainConfig(opt=ocfg, accum_steps=accum)
    params = TM.init_params(0, cfg, device="cpu")
    stream = make_stream(DataConfig(batch=4, seq_len=16,
                                    vocab_size=cfg.vocab_size, seed=0))
    return cfg, tcfg, params, adamw_init(params, ocfg), stream


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("factored", [False, True])
def test_world_of_one_is_no_mesh_bit_for_bit(accum, factored):
    """Rules over a (1, 1) mesh: blocks are the whole leaves and every
    collective moves nothing, so two steps give no mesh's bits (params,
    state, loss, grad norm); each collective is recorded."""
    from _torch_mesh import rules_of_one

    cfg, tcfg, params, opt, stream = _lm_setup(accum, factored)
    rules = rules_of_one()
    plain = make_train_step(cfg, tcfg)
    meshed = make_train_step(cfg, tcfg, rules=rules)
    lay = meshed.layout
    a = (params, opt)
    b = (lay.shard_params(params), lay.shard_opt_state(opt))
    ops.reset_dispatch_report()
    for i in range(2):
        *a, ma = plain(*a, device_transform("cpu")(stream.batch(i)))
        *b, mb = meshed(*b, shard_for(stream.batch(i), rules, "cpu",
                                      accum_steps=accum))
        for k in ("loss", "grad_norm", "skipped"):
            assert torch.equal(ma[k], mb[k]), (i, k)
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    assert all(torch.equal(a[1]["ema"][k][s], b[1]["ema"][k][s])
               for k in a[1]["ema"] for s in a[1]["ema"][k])
    kinds = {(c["kind"], c["where"]) for c in ops.collective_report()}
    assert ("all_gather", "param gather") in kinds
    assert ("all_reduce", "adamw global norm") in kinds
    assert ("all_reduce", "train loss") in kinds


def test_step_under_rules_matches_the_reference():
    """The port's step under rules at a world of one against the
    reference's ``make_train_step(rules=)`` on a (1, 1) mesh with
    ``Auto`` axes, float32, three steps (``test_torch_train.py``'s
    bounds)."""
    from _torch_mesh import rules_of_one

    jcfg = replace(jconfigs.get("llama3_2_1b", smoke=True), dtype="float32")
    tcfg = replace(get("llama3_2_1b", smoke=True), dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    okw = dict(lr=1e-3, warmup_steps=3, total_steps=60)
    js = jadamw_init(jp, JOptConfig(**okw))
    ts = adamw_init(tp, OptConfig(**okw))
    auto = (jax.sharding.AxisType.Auto,) * 2
    jrules = JRules.for_mesh(jax.make_mesh((1, 1), ("data", "model"),
                                           axis_types=auto))
    jstep = jmake_train_step(jcfg, JTrainConfig(opt=JOptConfig(**okw)),
                             rules=jrules, donate=False)
    rules = rules_of_one()
    tstep = make_train_step(tcfg, TrainConfig(opt=OptConfig(**okw)),
                            rules=rules)
    tp = tstep.layout.shard_params(tp)
    ts = tstep.layout.shard_opt_state(ts)
    stream = make_stream(DataConfig(batch=4, seq_len=32,
                                    vocab_size=tcfg.vocab_size))
    for i in range(3):
        b = stream.batch(i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, shard_for(b, rules, "cpu"))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5), i
    want = params_from_jax(jax.device_get(jp), device="cpu")
    diffs = []
    for k, w in want.items():
        d = (tp[k].float() - w.float()).abs()
        assert bool((d <= 6 * okw["lr"]).all()), (k, float(d.max()))
        diffs.append(d.flatten())
    assert float(torch.cat(diffs).mean()) < 1e-5


def test_gather_param_backward_is_reduce_param_grad():
    """On a (1, 1) mesh autograd through ``gather_param`` gives
    ``reduce_param_grad``; on the 16×16 device-free mesh the gather and
    the reduction keep the spec's block shapes."""
    from _torch_mesh import mesh_of_one

    t = torch.randn(4, 6, requires_grad=True)
    g = torch.randn(4, 6)
    out = spmd.gather_param(t, P("data", "model"), mesh_of_one())
    out.backward(g)
    assert torch.equal(t.grad, spmd.reduce_param_grad(
        g, P("data", "model"), mesh_of_one()))
    mesh = make_production_mesh()
    block = torch.empty((2, 3), device="meta", requires_grad=True)
    whole = spmd.gather_param(block, P("data", "model"), mesh)
    assert whole.shape == (32, 48) and whole.device.type == "meta"
    whole.sum().backward()
    assert block.grad.shape == (2, 3)
    kept = spmd.gather_param(block.detach(), P("model", "data"), mesh,
                             keep=("model",))
    assert kept.shape == (2, 48)
    assert spmd.reduce_param_grad(torch.empty((32, 48), device="meta"),
                                  P(None, "model"), mesh).shape == (32, 3)


def test_device_free_mesh_refuses_real_tensors():
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.shape == (2, 16, 16)
    assert spmd.axis_names(mesh) == ("pod", "data", "model")
    assert make_production_mesh().shape == (16, 16)
    ops.reset_dispatch_report()
    out = spmd.all_reduce(torch.empty(3, device="meta"), mesh, "pod", "x")
    assert out.shape == (3,) and out.device.type == "meta"
    (rec,) = ops.collective_report()
    assert (rec["kind"], rec["axis"], rec["bytes"]) == ("all_reduce", "pod",
                                                        12)
    for fn in (lambda t: spmd.all_reduce(t, mesh, "data", "x"),
               lambda t: spmd.all_gather(t, mesh, "model", "x"),
               lambda t: spmd.reduce_scatter(t, mesh, "data", "x"),
               lambda t: spmd.gather_param(t, P("data"), mesh)):
        with pytest.raises(ValueError, match="meta tensors only"):
            fn(torch.zeros(32))
    with pytest.raises(ValueError, match="no process group"):
        mesh.get_group("data")


def test_shard_for_takes_each_microbatch_rows():
    """Under accumulation a rank takes its rows of each microbatch (the
    2×16×16 mesh's rank 0: 1 of 32 shards); a batch that does not divide
    raises."""
    rules = ShardingRules.for_mesh(make_production_mesh(multi_pod=True))
    batch = {"x": np.arange(128, dtype=np.int32)[:, None]}
    got = shard_for(batch, rules, "cpu", accum_steps=2)["x"][:, 0]
    assert got.tolist() == [0, 1, 64, 65]
    assert shard_for(batch, rules, "cpu")["x"][:, 0].tolist() == [0, 1, 2,
                                                                  3]
    with pytest.raises(ValueError, match="does not divide"):
        shard_for({"x": np.zeros((48, 1))}, rules, "cpu")


def test_launcher_outside_torchrun_is_one_device(tmp_path, capsys,
                                                 monkeypatch):
    """``--mesh local`` in one process with no group and no torchrun
    trains as the reference does on one device, and says so."""
    import torch.distributed as dist

    from repro_torch.launch import train as LT

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    loop = LT.run(["--arch", "llama3_2_1b", "--smoke", "--device", "cpu",
                   "--batch", "2", "--seq-len", "16", "--steps", "2",
                   "--mesh", "local"])
    assert loop.layout is None and loop.state.step == 2
    assert "outside torchrun: one process" in capsys.readouterr().out


@pytest.mark.parametrize("arch,tp,whole_kv", [
    ("llama3_2_1b", 16, ("wk", "wv")), ("llama3_2_1b", 8, ()),
    ("recurrentgemma_9b", 2, ("wk", "wv")), ("m3vit", 2, ()),
    ("deepseek_67b", 4, ()), ("llama4_scout_17b_a16e", 16, ())],
    ids=["llama-16", "llama-8", "rgemma-2", "m3vit-2", "deepseek-4",
         "scout-16"])
def test_layout_keeps_the_model_blocks(arch, tp, whole_kv):
    """The train layout at full size on a device-free (256 / tp, tp)
    mesh: ``keep`` holds every leaf ``transformer.model_blocks`` names
    (what a serving rank narrows), each gathered over ``data`` alone to
    its block over ``model``, and every other leaf is gathered whole;
    beside split q heads, k/v are whole where the KV heads do not divide
    the axis (Llama's 8 at 16, RecurrentGemma's one); an attention whose
    heads do not divide it (M³ViT's 3 at 2, Scout's 40 at 16) is whole."""
    from repro_torch.dist.sharding import local_slice, model_spec
    from repro_torch.models import vit
    from repro_torch.models.transformer import model_blocks
    from repro_torch.train.step import layout_for

    cfg = get(arch)
    mesh = spmd.VirtualMesh((256 // tp, tp), ("data", "model"))
    rules = ShardingRules.for_mesh(mesh)
    lay = layout_for(cfg, rules)
    blocks = model_blocks(cfg, rules)
    assert blocks and set(blocks) <= set(lay.keep)
    attn = {k.rsplit(".", 1)[1] for k in lay.params if ".attn." in k}
    kept = {k.rsplit(".", 1)[1] for k in lay.keep if ".attn." in k}
    assert sorted(attn - kept if kept else ()) == sorted(whole_kv)
    if arch == "m3vit":       # attention whole, the MLPs split
        assert not any(".attn." in k for k in lay.keep)
        assert any(".mlp.w1" in k for k in lay.keep)
    shapes = vit.param_specs(cfg) if arch == "m3vit" else TM.param_specs(cfg)
    stored = lay.shard_params(shapes)
    for k, t in stored.items():
        got = spmd.gather_param(t, lay.params[k], mesh, lay.keep.get(k, ()))
        want = tuple(shapes[k].shape)
        if k in lay.keep:
            want = tuple(s.stop - s.start for s in local_slice(
                want, model_spec(lay.params[k]), mesh))
        assert tuple(got.shape) == want, k


def test_max_all_reduce_carries_no_gradient():
    """``all_reduce(op="max")`` (the vocab-parallel loss's shift): no
    gradient at a world of one, a ``meta`` result recorded on the
    device-free mesh, the value as it is over one rank."""
    from _torch_mesh import mesh_of_one

    t = torch.randn(3, 4, requires_grad=True)
    out = spmd.all_reduce(t, mesh_of_one(), "model", "x", op="max")
    assert not out.requires_grad and torch.equal(out, t.detach())
    ops.reset_dispatch_report()
    mesh = make_production_mesh()
    got = spmd.all_reduce(torch.empty(5, device="meta", requires_grad=True),
                          mesh, "model", "loss max", op="max")
    assert got.shape == (5,) and not got.requires_grad
    (rec,) = ops.collective_report()
    assert (rec["kind"], rec["axis"], rec["where"]) == ("all_reduce",
                                                        "model", "loss max")


@pytest.mark.parametrize("tp,summed", [(4, 2), (2, 0)],
                         ids=["kv-whole", "kv-split"])
def test_whole_kv_gradient_sums_over_model(tp, summed):
    """Where the q heads split over ``model`` and the KV heads do not (the
    smoke Llama's 2 KV heads at 4), every rank holds ``wk``/``wv`` whole
    and its gradient covers only its q heads' KV head:
    ``apply_attention`` passes them through the Megatron ``f``, one
    all-reduce over ``model`` each in the backward, so the gathered
    leaf's backward (``reduce_param_grad``) takes the summed gradient as
    it is.  Where the KV heads split, none.  On the device-free mesh."""
    from repro_torch.dist.sharding import use_rules
    from repro_torch.models import layers as L

    cfg = get("llama3_2_1b", smoke=True)
    rules = ShardingRules.for_mesh(spmd.VirtualMesh((1, tp),
                                                    ("data", "model")))
    q_split, kv_split = L.attention_layout(cfg, tp)
    assert q_split and kv_split == (not summed)
    d, hd = cfg.d_model, cfg.hd
    hq = cfg.num_heads // tp
    hkv = cfg.num_kv_heads // tp if kv_split else cfg.num_kv_heads
    meta = dict(device="meta", requires_grad=True)
    params = {"wq": torch.empty(d, hq * hd, **meta),
              "wk": torch.empty(d, hkv * hd, **meta),
              "wv": torch.empty(d, hkv * hd, **meta),
              "wo": torch.empty(hq * hd, d, **meta)}
    x = torch.empty(2, 8, d, **meta)
    pos = torch.zeros(2, 8, dtype=torch.long, device="meta")
    ops.reset_dispatch_report()
    with use_rules(rules):
        y, _ = L.apply_attention(params, x, cfg, pos=pos)
        grads = torch.autograd.grad(y.sum(), [x, *params.values()])
    assert [tuple(g.shape) for g in grads[1:]] == [
        tuple(p.shape) for p in params.values()]
    got = sum(c["count"] for c in ops.collective_report()
              if (c["kind"], c["axis"], c["where"])
              == ("all_reduce", "model", "attn kv (backward)"))
    assert got == summed
