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
skipped by all; checkpoints across mesh and no mesh both ways;
``compressed_psum`` and the stacked mean over the ranks; and at 2×1
``launch/train.py --mesh local --device cpu``.

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
         "compress")


@pytest.mark.parametrize("shape,checks", [
    ((2, 1), TRAIN + ("launcher",)), ((1, 2), TRAIN), ((2, 2), TRAIN)],
    ids=["2x1", "1x2", "2x2"])
def test_mesh_training_world(shape, checks, tmp_path):
    world = shape[0] * shape[1]
    mp.start_processes(W.run, args=(world, shape,
                                    os.path.join(tmp_path, "store"), checks),
                       nprocs=world, start_method="spawn")


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
