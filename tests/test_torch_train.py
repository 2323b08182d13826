"""The port's training slice against the JAX reference, on the CPU: data
streams, AdamW, the M³ViT multitask loss and its gradients, the LM train
step, the training loop and checkpoints.

Tolerances, each stated where it is used:

* streams: bit-equal (a batch is a pure function of (seed, step));
* AdamW: float32 leaves within ``rtol = 1e-5, atol = 1e-6`` of the
  reference after 4 steps (XLA fuses the float32 update and may round one
  ulp apart), bf16 momentum within one bf16 ulp plus that;
* M³ViT ``multitask_loss`` (semseg + depth) and its gradients under the
  default policy (the reference's training policy), ``SMOKE_CONFIG``:
  float32 — loss within 1e-6 relative, cosine >= 0.999999 over all leaves
  and >= 0.99999 per leaf; bf16 — loss within 1e-4 relative, cosine >=
  0.9999 over all leaves and >= 0.999 per leaf (readings on this CPU:
  float32 0.9999999997 / 0.999999994, bf16 0.99999 / 0.99988); the
  load-balance aux term alone within 10× the loss's bound (bf16 reading
  2.3e-4: it counts routed slots, and a bf16 top-k can flip);
* the LM train step on ``llama3_2_1b`` ``SMOKE_CONFIG``, 3 steps: the loss
  within 1e-5 relative (float32) or 1e-4 (bf16) at every step; after 3
  steps every parameter within 6·lr (an element whose gradient is near 0
  may take Adam's normalised step, of size lr, with the other sign at each
  step) plus one bf16 ulp of the parameter for bf16, and the mean
  difference below 1e-5 (float32) or 1e-4 (bf16, where a one-ulp rounding
  apart is 2.4e-4 at a magnitude of 0.05; reading 5.0e-5);
* the loop: the reference's own bounds (resume ``rel=1e-6``, here also
  bit-identical; accumulation loss ``rel=1e-5`` and params ``2e-3``);
* checkpoints: bit-exact in both directions.
"""

import json
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.configs import m3vit as JMC
from repro.data import DataConfig as JDataConfig
from repro.data import make_stream as jmake_stream
from repro.models import model as JM
from repro.models import vit as jvit
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro.quant import quantize as jquantize
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro_torch import checkpoint as ckpt
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs import llama3_2_1b as TL
from repro_torch.configs import m3vit as TMC
from repro_torch.data import (DataConfig, device_transform, make_stream,
                              prefetch)
from repro_torch.kernels import compare
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TMOD
from repro_torch.models import vit
from repro_torch.optim import (OptConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm)
from repro_torch.quant import QTensor, quantize
from repro_torch.train import (LoopConfig, TrainConfig, TrainLoop,
                               make_train_step)
from repro_torch.tree import flatten
from test_torch_threads import one_torch_thread  # noqa: F401

# ---------------------------------------------------------------- data

STREAMS = {
    "tokens": dict(batch=4, seq_len=32, vocab_size=1000),
    "embeddings": dict(batch=2, seq_len=8, vocab_size=0, d_model=16),
    "m3vit": dict(batch=2, seq_len=0, kind="m3vit"),
}


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (7, 1000),
                                       (3, 2 ** 20 + 1)])
@pytest.mark.parametrize("kind", list(STREAMS))
def test_stream_bit_equal_to_reference(kind, seed, step):
    want = jmake_stream(JDataConfig(seed=seed, **STREAMS[kind])).batch(step)
    got = make_stream(DataConfig(seed=seed, **STREAMS[kind])).batch(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_ordered_offset_and_transformed():
    s = make_stream(DataConfig(batch=2, seq_len=8, vocab_size=100))
    it = prefetch(s, n=2, start_step=5, transform=device_transform("cpu"))
    got = [next(it) for _ in range(4)]
    assert [step for step, _ in got] == [5, 6, 7, 8]
    for step, b in got:
        assert isinstance(b["inputs"], torch.Tensor)
        np.testing.assert_array_equal(b["inputs"].numpy(),
                                      s.batch(step)["inputs"])


def test_device_transform_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_transform("cuda")


# ---------------------------------------------------------------- AdamW

OPT_PARAMS = {"mlp.w1": (130, 140), "mlp.b1": (140,), "ln.scale": (140,),
              "attn.bq": (12,), "patch.pos": (6, 8), "heads.semseg.b": (5,),
              "experts.w": (3, 130, 128)}

OPT_CASES = {
    "full_v": dict(),
    "factored_v": dict(factored=True),
    "bf16_momentum": dict(momentum_dtype="bfloat16"),
    "clipping": dict(clip_norm=0.01),
    "no_clip_weight_decay": dict(clip_norm=1e9, weight_decay=0.5),
    "schedule_past_total": dict(warmup_steps=1, total_steps=3),
}


def _opt_problem(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in OPT_PARAMS.items()}
    grads = [{k: (rng.normal(size=s) * 3).astype(np.float32)
              for k, s in OPT_PARAMS.items()} for _ in range(4)]
    return params, grads


def _nested(flat):
    """{dotted: array} -> the reference's nested dict of jnp arrays."""
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_adamw_matches_reference(case):
    kw = dict(dict(lr=1e-2, warmup_steps=2, total_steps=10,
                   factored_min_size=128), **OPT_CASES[case])
    params, grads = _opt_problem()
    jp = _nested(params)
    js = jadamw_init(jp, JOptConfig(**kw))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = adamw_init(tp, OptConfig(**kw))
    for g in grads:
        jp, js, jm = jadamw_update(jp, _nested(g), js, JOptConfig(**kw))
        tp, ts, tm = adamw_update(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
            OptConfig(**kw))
    want = {k: tensor_from_numpy(np.asarray(v))
            for k, v in flatten(jax.device_get(
                {"params": jp, "opt": js})).items()}
    got = flatten({"params": tp, "opt": ts})
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype == torch.bfloat16:
            assert compare.within_tolerance(g, w, torch.bfloat16), k
        elif g.is_floating_point():
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(g, w), k
    for name in ("lr", "grad_norm"):
        assert float(tm[name]) == pytest.approx(float(jm[name]), rel=1e-6)
    if kw.get("factored"):
        assert "vr" in ts["ema"]["mlp.w1"] and "v" in ts["ema"]["ln.scale"]


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 550, 1000, 2000])
def test_cosine_schedule_matches_reference(step):
    kw = dict(lr=1e-3, warmup_steps=100, total_steps=1000, min_lr_frac=0.1)
    assert float(cosine_schedule(OptConfig(**kw), step)) == \
        float(jcosine(JOptConfig(**kw), step))


def test_no_decay_names_match_reference():
    """Zero gradients, weight decay 1: decayed leaves move, norm scales,
    biases and positions do not — the same leaves as the reference's."""
    params, _ = _opt_problem(1)
    kw = dict(lr=0.1, weight_decay=1.0, warmup_steps=0, total_steps=10,
              min_lr_frac=1.0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    new, _, _ = adamw_update(tp, {k: torch.zeros_like(v)
                                  for k, v in tp.items()},
                             adamw_init(tp, OptConfig(**kw)), OptConfig(**kw))
    jp = _nested(params)
    jnew, _, _ = jadamw_update(jp, jax.tree.map(jnp.zeros_like, jp),
                               jadamw_init(jp, JOptConfig(**kw)),
                               JOptConfig(**kw))
    jflat = flatten(jax.device_get(jnew))
    moved = {k for k in tp if not torch.equal(new[k], tp[k])}
    jmoved = {k for k in tp if not np.array_equal(jflat[k], params[k])}
    assert moved == jmoved == {"mlp.w1", "heads.semseg.b", "experts.w"}


# the reference's tests/test_optim.py, ported as cases


def _quad(n=64, seed=0):
    rng = np.random.default_rng(seed)
    target = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    params = {"w": torch.zeros((n, n)), "scale": torch.ones((n,))}
    return params, (lambda p: torch.mean((p["w"] - target) ** 2))


def _run(params, loss, cfg, steps=200):
    state = adamw_init(params, cfg)
    for _ in range(steps):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = torch.autograd.grad(loss(leaves), list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(params.items(), grads)}
        params, state, _ = adamw_update(params, grads, state, cfg)
    return params, float(loss(params))


OPTIM_CONVERGENCE = {
    "quadratic": (dict(), 64, 0.01),
    "factored": (dict(factored=True, factored_min_size=32), 64, 0.05),
    "bf16_momentum": (dict(momentum_dtype="bfloat16"), 32, 0.05),
}


@pytest.mark.parametrize("case", list(OPTIM_CONVERGENCE))
def test_optim_converges(case):
    extra, n, frac = OPTIM_CONVERGENCE[case]
    params, loss = _quad(n)
    cfg = OptConfig(lr=0.05, weight_decay=0.0, warmup_steps=10,
                    total_steps=200, **extra)
    _, final = _run(params, loss, cfg)
    assert final < frac * float(loss(params))
    if case == "bf16_momentum":
        assert adamw_init(params, cfg)["ema"]["w"]["m"].dtype == \
            torch.bfloat16


def test_optim_factored_state_is_small():
    st = adamw_init({"w": torch.zeros((512, 256))}, OptConfig(factored=True))
    ema = st["ema"]["w"]
    assert "v" not in ema
    assert ema["vr"].shape == (512,) and ema["vc"].shape == (256,)


def test_optim_clip_bounds_update():
    params = {"w": torch.zeros((8,))}
    cfg = OptConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0,
                    warmup_steps=0, total_steps=10, min_lr_frac=1.0)
    p2, _, m = adamw_update(params, {"w": torch.full((8,), 1e6)},
                            adamw_init(params, cfg), cfg)
    assert float(m["grad_norm"]) > 1e6
    assert torch.isfinite(p2["w"]).all() and float(p2["w"].abs().max()) < 10


def test_optim_global_norm():
    assert float(global_norm({"a": torch.tensor([3.0]),
                              "b": torch.tensor([4.0])})) == \
        pytest.approx(5.0)


# -------------------------------------------------- M3ViT multitask loss

M3VIT_BOUNDS = {"float32": (1e-6, 0.999999, 0.99999),
                "bfloat16": (1e-4, 0.9999, 0.999)}


@pytest.mark.parametrize("dtype", list(M3VIT_BOUNDS))
def test_m3vit_multitask_loss_and_grads_match_jax(dtype):
    jcfg = replace(JMC.SMOKE_CONFIG, dtype=dtype)
    tcfg = replace(TMC.SMOKE_CONFIG, dtype=dtype)
    jp = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    b = make_stream(DataConfig(batch=2, seq_len=0, kind="m3vit")).batch(0)

    def jloss(p):
        img = jnp.asarray(b["image"])
        l0, (s0, a0) = jvit.multitask_loss(p, img, jnp.asarray(b["semseg"]),
                                           jcfg, "semseg")
        l1, (s1, a1) = jvit.multitask_loss(p, img, jnp.asarray(b["depth"]),
                                           jcfg, "depth")
        return l0 + l1, (s0, s1, a0, a1)

    (jv, jparts), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    jg = params_from_jax(jax.device_get(jg), device="cpu")
    leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
    img = torch.from_numpy(b["image"])
    l0, (s0, a0) = vit.multitask_loss(leaves, img,
                                      torch.from_numpy(b["semseg"]), tcfg,
                                      "semseg")
    l1, (s1, a1) = vit.multitask_loss(leaves, img,
                                      torch.from_numpy(b["depth"]), tcfg,
                                      "depth")
    grads = dict(zip(leaves, torch.autograd.grad(l0 + l1,
                                                 list(leaves.values()))))
    rtol, cos_all, cos_leaf = M3VIT_BOUNDS[dtype]
    for name, got, want in zip(("total", "semseg", "depth", "aux semseg",
                                "aux depth"), (l0 + l1, s0, s1, a0, a1),
                               (jv, *jparts)):
        # the aux loss counts routed slots: in bf16 one token's top-k may
        # flip, moving an expert's share by 1/(T·k)
        tol = 10 * rtol if name.startswith("aux") else rtol
        assert float(got) == pytest.approx(float(want), rel=tol), name
    whole, leaf, worst = compare.grad_agreement(grads, jg)
    assert whole >= cos_all and worst >= cos_leaf, (whole, leaf, worst)
    for k, g in grads.items():
        assert g.dtype == tp[k].dtype, k


# -------------------------------------------------- LM train step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_train_step_matches_reference(dtype):
    jcfg = replace(jconfigs.get("llama3_2_1b", smoke=True), dtype=dtype)
    tcfg = replace(TL.SMOKE_CONFIG, dtype=dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    okw = dict(lr=1e-3, warmup_steps=3, total_steps=60)
    js = jadamw_init(jp, JOptConfig(**okw))
    ts = adamw_init(tp, OptConfig(**okw))
    jstep = jmake_train_step(jcfg, JTrainConfig(opt=JOptConfig(**okw)),
                             donate=False)
    tstep = make_train_step(tcfg, TrainConfig(opt=OptConfig(**okw)))
    stream = make_stream(DataConfig(batch=4, seq_len=32,
                                    vocab_size=tcfg.vocab_size))
    rtol = 1e-5 if dtype == "float32" else 1e-4
    for i in range(3):
        b = stream.batch(i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=rtol), i
        assert int(tm["skipped"]) == 0
    want = params_from_jax(jax.device_get(jp), device="cpu")
    diffs = []
    for k, w in want.items():
        g = tp[k]
        assert g.dtype == w.dtype, k
        bound = 6 * okw["lr"]
        if g.dtype == torch.bfloat16:
            bound = bound + compare.bf16_ulp(w.float())
        d = (g.float() - w.float()).abs()
        assert bool((d <= bound).all()), (k, float(d.max()))
        diffs.append(d.flatten())
    assert float(torch.cat(diffs).mean()) < \
        (1e-5 if dtype == "float32" else 1e-4)


# -------------------------------------------------- the loop


def build(tmp=None, total=20, seed=0, accum=1):
    cfg = TL.SMOKE_CONFIG
    params = TMOD.init_params(seed, cfg, device="cpu")
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=3,
                                     total_steps=60), accum_steps=accum)
    stream = make_stream(DataConfig(batch=4, seq_len=32,
                                    vocab_size=cfg.vocab_size, seed=0))
    return TrainLoop(
        LoopConfig(total_steps=total, ckpt_dir=str(tmp) if tmp else None,
                   ckpt_every=10, log_every=1000),
        make_train_step(cfg, tcfg), stream, params,
        adamw_init(params, tcfg.opt), log=lambda s: None,
        batch_transform=device_transform("cpu"))


def test_loop_loss_decreases():
    st = build(total=25).run()
    first = np.mean([l for _, l in st.history[:5]])
    last = np.mean([l for _, l in st.history[-5:]])
    assert last < first


def test_loop_resume_is_bit_identical(tmp_path):
    """Crash at step 10, restore into junk params, continue to 20 ==
    the uninterrupted run."""
    a = build(tmp_path / "a", total=20)
    st_a = a.run()
    build(tmp_path / "b", total=10).run()        # "crash" after step 10
    b2 = build(tmp_path / "b", total=20, seed=99)
    assert b2.try_restore()
    assert b2.state.step == 10
    st_b = b2.run()
    tail_a, tail_b = dict(st_a.history[10:]), dict(st_b.history)
    assert set(tail_b) == set(tail_a)
    for s in tail_b:
        assert tail_b[s] == pytest.approx(tail_a[s], rel=1e-6), s
        assert tail_b[s] == tail_a[s], s
    for k in a.params:
        assert torch.equal(a.params[k], b2.params[k]), k


def _poisoned_step(cfg, tcfg):
    def poisoned_loss(p, mb):
        loss, aux = TMOD.lm_loss(p, mb, cfg)
        bad = mb["inputs"][0, 0] == -1                 # poison marker
        return torch.where(bad, torch.tensor(float("nan")), loss), aux

    return make_train_step(cfg, tcfg, loss_fn=poisoned_loss)


def test_nan_update_skipped_in_step():
    cfg = TL.SMOKE_CONFIG
    params = TMOD.init_params(0, cfg, device="cpu")
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=3,
                                     total_steps=60))
    opt_state = adamw_init(params, tcfg.opt)
    step = _poisoned_step(cfg, tcfg)
    stream = make_stream(DataConfig(batch=4, seq_len=16,
                                    vocab_size=cfg.vocab_size, seed=0))
    batch = {k: torch.from_numpy(v) for k, v in stream.batch(0).items()}
    bad = dict(batch, inputs=batch["inputs"].clone())
    bad["inputs"][0, 0] = -1
    before = flatten({"p": params, "o": opt_state})
    p2, o2, m2 = step(params, opt_state, bad)
    assert not np.isfinite(float(m2["loss"]))
    assert int(m2["skipped"]) == 1
    after = flatten({"p": p2, "o": o2})
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    p3, o3, m3 = step(params, opt_state, batch)      # a clean batch updates
    assert int(m3["skipped"]) == 0
    assert max(float((params[k].float() - p3[k].float()).abs().max())
               for k in params) > 0
    assert int(o3["step"]) == 1 and int(o2["step"]) == 0


def test_loop_counts_skips():
    loop = build(total=4)
    real_step = loop.train_step
    calls = {"n": 0}

    def poisoned(params, opt_state, batch):
        p, o, m = real_step(params, opt_state, batch)
        calls["n"] += 1
        if calls["n"] == 2:
            m = dict(m, loss=torch.tensor(float("nan")),
                     skipped=torch.tensor(1))
        return p, o, m

    loop.train_step = poisoned
    st = loop.run()
    assert st.nan_skip_count == 1
    assert len(st.history) == 3                  # poisoned step not recorded


def test_loop_straggler_hook():
    import time

    loop = build(total=16)
    events = []
    loop.on_straggler = lambda step, dt: events.append(step)
    real_step = loop.train_step
    calls = {"n": 0}

    def slow(params, opt_state, batch):
        calls["n"] += 1
        out = real_step(params, opt_state, batch)
        if calls["n"] == 14:
            time.sleep(max(0.3, loop.state.ema_step_time * 5))
        return out

    loop.train_step = slow
    st = loop.run()
    assert st.straggler_count >= 1
    assert 13 in events


def test_grad_accum_equals_single():
    cfg = TL.SMOKE_CONFIG
    params = TMOD.init_params(0, cfg, device="cpu")
    ocfg = OptConfig(lr=1e-3, warmup_steps=3, total_steps=60)
    opt_state = adamw_init(params, ocfg)
    stream = make_stream(DataConfig(batch=8, seq_len=16,
                                    vocab_size=cfg.vocab_size, seed=0))
    batch = {k: torch.from_numpy(v) for k, v in stream.batch(0).items()}
    p1, _, m1 = make_train_step(cfg, TrainConfig(opt=ocfg))(
        params, opt_state, batch)
    p4, _, m4 = make_train_step(cfg, TrainConfig(opt=ocfg, accum_steps=4))(
        params, opt_state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    assert max(float((p1[k].float() - p4[k].float()).abs().max())
               for k in params) < 2e-3               # bf16 param grid


def test_m3vit_both_tasks_learn_through_the_loop():
    """M³ViT trains through make_train_step + TrainLoop with the multitask
    loss (semseg + depth on one batch), as the reference's test_vit trains
    it, under the kernel policy (plain versions on the CPU)."""
    from repro_torch import ops

    cfg = replace(TMC.SMOKE_CONFIG, policy=ops.policy_named("cuda"))
    params = vit.init_params(0, cfg, device="cpu")
    tcfg = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=2,
                                     total_steps=40, weight_decay=0.0))
    parts = []

    def loss_fn(p, b):
        l0, (s0, _) = vit.multitask_loss(p, b["image"], b["semseg"], cfg,
                                         "semseg")
        l1, (s1, _) = vit.multitask_loss(p, b["image"], b["depth"], cfg,
                                         "depth")
        parts.append((float(s0), float(s1)))
        return l0 + l1, None

    stream = make_stream(DataConfig(batch=2, seq_len=0, kind="m3vit"))
    loop = TrainLoop(LoopConfig(total_steps=12, log_every=1000),
                     make_train_step(cfg, tcfg, loss_fn=loss_fn),
                     _cycled(stream, 3), params, adamw_init(params, tcfg.opt),
                     log=lambda s: None,
                     batch_transform=device_transform("cpu"))
    st = loop.run()
    assert st.history[-1][1] < st.history[0][1]
    assert parts[-1][0] < parts[0][0] and parts[-1][1] < parts[0][1]


class _cycled:
    """The stream's first ``n`` batches in turn (the reference test's
    ``stream.batch(i % 3)``)."""

    def __init__(self, stream, n):
        self.stream, self.n = stream, n

    def batch(self, step):
        return self.stream.batch(step % self.n)


# -------------------------------------------------- checkpoints


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 16), generator=g)
                       .to(torch.bfloat16),
                       "b": torch.zeros((16,))},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "nested": [torch.arange(4), torch.ones((2, 2))]}}


def test_checkpoint_roundtrip_bitexact(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 10, t)
    r = ckpt.restore(str(tmp_path), 10, _tree(seed=1))
    for (ka, a), (kb, b) in zip(flatten(t).items(), flatten(r).items()):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka


def test_checkpoint_latest_and_atomicity(tmp_path):
    assert ckpt.latest_step(str(tmp_path)) is None
    os.makedirs(tmp_path / "tmp.5")
    (tmp_path / "tmp.5" / "junk.npy").write_bytes(b"xx")
    assert ckpt.latest_step(str(tmp_path)) is None
    for s in (5, 20, 10):
        ckpt.save(str(tmp_path), s, _tree())
    assert ckpt.latest_step(str(tmp_path)) == 20
    assert not (tmp_path / "tmp.5").exists()


def test_checkpoint_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 1, {"w": torch.zeros((8,))})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), 1, {"w": torch.zeros((4,)),
                                        "extra": torch.zeros((2,))})


def test_checkpoint_manager_async_and_retention(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(seed=s))
    mgr.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4] and mgr.latest() == 4
    r = ckpt.restore(str(tmp_path), 4, _tree())
    assert torch.equal(r["params"]["w"], _tree(seed=4)["params"]["w"])


def _jax_tree():
    k = jax.random.PRNGKey(3)
    return {"params": {"w": jax.random.normal(k, (8, 16), jnp.bfloat16),
                       "b": jnp.zeros((16,), jnp.float32),
                       "q8": jquantize(jax.random.normal(k, (24, 16)), 8),
                       "q4": jquantize(jax.random.normal(k, (33, 8)), 4,
                                       group_size=8)},
            "opt": {"step": jnp.int32(7)}}


def _port_like(jt):
    """The port's tree of the same structure, other values."""
    p = jt["params"]
    return {"params": {
        "w": torch.zeros((8, 16), dtype=torch.bfloat16),
        "b": torch.ones((16,)),
        "q8": QTensor(torch.zeros(p["q8"].q.shape, dtype=torch.int8),
                      torch.zeros(p["q8"].scale.shape), bits=8,
                      dtype=p["q8"].dtype, rows=p["q8"].rows),
        "q4": QTensor(torch.zeros(p["q4"].q.shape, dtype=torch.uint8),
                      torch.zeros(p["q4"].scale.shape), bits=4,
                      dtype=p["q4"].dtype, rows=p["q4"].rows)},
        "opt": {"step": torch.tensor(0, dtype=torch.int32)}}


def test_checkpoint_from_reference_restores_in_port(tmp_path):
    jt = _jax_tree()
    jckpt.save(str(tmp_path), 3, jt)
    r = ckpt.restore(str(tmp_path), 3, _port_like(jt))
    p, jp = r["params"], jt["params"]
    assert r["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["w"].float().numpy(),
                                  np.asarray(jp["w"], np.float32))
    np.testing.assert_array_equal(p["b"].numpy(), np.asarray(jp["b"]))
    for name in ("q8", "q4"):
        assert isinstance(p[name], QTensor)
        assert (p[name].bits, p[name].rows) == (jp[name].bits, jp[name].rows)
        np.testing.assert_array_equal(p[name].q.numpy(),
                                      np.asarray(jp[name].q))
        np.testing.assert_array_equal(p[name].scale.numpy(),
                                      np.asarray(jp[name].scale))
    assert int(r["opt"]["step"]) == 7
    # the bridge reads the same checkpoint leaf by leaf
    flat = params_from_jax(str(tmp_path / "step_3"), device="cpu")
    assert {"params.q8.q", "params.q8.scale", "params.w"} <= set(flat)
    assert torch.equal(flat["params.w"], p["w"])


def test_checkpoint_from_port_restores_in_reference(tmp_path):
    t = {"params": {"w": torch.randn((8, 16)).to(torch.bfloat16),
                    "b": torch.arange(16, dtype=torch.float32),
                    "q8": quantize(torch.randn((24, 16)), 8),
                    "q4": quantize(torch.randn((33, 8)), 4, group_size=8)},
         "opt": {"step": torch.tensor(11, dtype=torch.int32)}}
    ckpt.save(str(tmp_path), 2, t)
    with open(tmp_path / "step_2" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["params.w"]["dtype"] == "bfloat16"
    assert leaves["params.q8.q"]["dtype"] == "int8"
    r = jckpt.restore(str(tmp_path), 2, _jax_tree())
    p = t["params"]
    np.testing.assert_array_equal(np.asarray(r["params"]["w"], np.float32),
                                  p["w"].float().numpy())
    assert r["params"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(r["params"]["b"]),
                                  p["b"].numpy())
    for name in ("q8", "q4"):
        np.testing.assert_array_equal(np.asarray(r["params"][name].q),
                                      p[name].q.numpy())
        np.testing.assert_array_equal(np.asarray(r["params"][name].scale),
                                      p[name].scale.numpy())
    assert int(r["opt"]["step"]) == 11


def test_reference_train_state_restores_into_port_loop(tmp_path):
    """The reference's {"params", "opt"} after a step, saved by the
    reference, restores into the port's parameter dict and AdamW state
    (the dotted names of both trees agree)."""
    jcfg = jconfigs.get("llama3_2_1b", smoke=True)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    ocfg = dict(lr=1e-3, warmup_steps=3, total_steps=60)
    js = jadamw_init(jp, JOptConfig(**ocfg))
    b = jmake_stream(JDataConfig(batch=2, seq_len=16,
                                 vocab_size=jcfg.vocab_size)).batch(0)
    jp, js, _ = jmake_train_step(jcfg, JTrainConfig(opt=JOptConfig(**ocfg)),
                                 donate=False)(
        jp, js, {k: jnp.asarray(v) for k, v in b.items()})
    jckpt.save(str(tmp_path), 1, {"params": jp, "opt": js})
    loop = build(tmp_path, total=2, seed=5)
    assert loop.try_restore() and loop.state.step == 1
    want = params_from_jax(jax.device_get(jp), device="cpu")
    for k, v in want.items():
        assert torch.equal(loop.params[k], v), k
    wopt = flatten(jax.device_get(js))
    got = flatten(loop.opt_state)
    assert set(got) == set(wopt)
    for k, v in wopt.items():
        assert torch.equal(got[k], tensor_from_numpy(np.asarray(v))), k
    loop.run()                                     # and trains on
    assert loop.state.step == 2


def test_launch_train_cpu_resumes(tmp_path, capsys):
    argv = ["--arch", "llama3_2_1b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq-len", "16", "--warmup", "1",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    assert launch_train.main(argv + ["--steps", "3"]) == 0
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert launch_train.main(argv + ["--steps", "5"]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint step=3" in out and "over 5 steps" in out
    # --mesh local: over the world's group where one is running (a world
    # of one here), else one device with no rules, as the reference
    import torch.distributed as dist

    assert launch_train.main(argv + ["--steps", "5", "--mesh",
                                     "local"]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint step=5" in out
    assert ("mesh=data:1" if dist.is_initialized()
            else "outside torchrun: one process") in out
