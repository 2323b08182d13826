"""Recurrent serving in the port — xLSTM-350M and RecurrentGemma-9B
``SMOKE_CONFIG`` through ``ServingEngine``, the ``Scheduler``'s
``LMBackend`` and ``SlotParker`` — against the JAX reference, on the CPU.

* The reference's recurrent serving oracles, run on the port with the
  reference's parameters (``bridge``) and keys, in the configs' bf16
  (decode against teacher forcing in float32, where no logits tie):
  ``tests/test_serve.py``'s generation of both families, decode equal to
  teacher forcing, chunked prefill (divisible and with an exact remainder
  chunk) equal to one-shot; ``tests/test_scheduler.py``'s recurrent arch
  through the scheduler with no prompt padding;
  ``tests/test_slo_serve.py``'s bit-exact preempt/restore of recurrent
  state; ``tests/test_prefix_cache.py``'s refusal of a prefix cache.
* Beside the reference, at float32: the engine's greedy tokens equal the
  JAX engine's on the same prompts under the exact presets and the kernel
  presets (RecurrentGemma's prompts past its 16-token smoke window, so the
  ring cache takes the rolled write); the scheduler's tokens, finishing
  order, times and counters, with preemption, equal the JAX scheduler's
  on a tick clock; ``compress="int8"`` parking packs the same leaves
  (last axis >= 8) as the reference's parker, byte for byte; the
  structural batch axes of every state leaf are the reference's.
* The ``SMOKE_CONFIG``s and ``CONFIG``s equal the reference's field by
  field.
"""

import functools
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import ops as jops
from repro.models import model as jmodel
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro.serve.engine import state_batch_axes as jstate_batch_axes
from repro.serve.slo.preempt import SlotParker as JSlotParker
from repro_torch import configs as tconfigs
from repro_torch import ops
from repro_torch.bridge import params_from_jax
from repro_torch.models import model as tmodel
from repro_torch.serve import (LMBackend, Request, Scheduler, ServeConfig,
                               ServingEngine)
from repro_torch.serve.engine import state_batch_axes
from repro_torch.serve.slo import SlotParker, SLOPolicy, TickClock
from test_torch_scheduler import assert_same_schedule, run_both
from test_torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("xlstm_350m", "recurrentgemma_9b")
PRESETS = {  # name: (JAX policy, port policy)
    "exact": (jops.policy_named("xla"), ops.policy_named("eager")),
    "kernels": (jops.policy_named("pallas").with_impls(
        attention_decode="pallas_fused"),
        ops.policy_named("cuda").with_impls(attention_decode="cuda_fused")),
}


@functools.lru_cache(maxsize=None)
def _model(arch, key=0, dtype=None):
    """(JAX cfg, port cfg, JAX params as NumPy, port params) from
    ``PRNGKey(key)`` in ``dtype`` (default: the config's, bf16)."""
    over = {} if dtype is None else dict(dtype=dtype)
    jcfg = replace(jconfigs.get(arch, smoke=True), **over)
    tcfg = replace(tconfigs.get(arch, smoke=True), **over)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(key),
                                                jcfg))
    return jcfg, tcfg, jparams, params_from_jax(jparams, device="cpu")


def _randint(key, shape, vocab):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(key), shape, 0,
                                         vocab), np.int32)


def _engine(tcfg, tparams, **scfg):
    return ServingEngine(tcfg, tparams, ServeConfig(**scfg), device="cpu")


# ------------------------------------------------- the reference's oracles


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_all_families(arch):
    _, tcfg, _, tparams = _model(arch, key=1)
    out = _engine(tcfg, tparams, max_len=64).generate(
        _randint(2, (2, 8), tcfg.vocab_size), 6)
    assert out.shape == (2, 6) and out.dtype == np.int32
    assert (out >= 0).all() and (out < tcfg.vocab_size).all()


def test_recurrent_decode_matches_teacher_forcing():
    """Greedy decode (the one-step recurrences, the ring cache's decode)
    == the full-sequence forward at each step.  In float32: the bf16
    head rounds the logits to a 2^-7 grid, where this prompt's step-1
    teacher-forced logits hold an exact tie (tokens 15 and 118 at
    2.203125) that the decode path's other sum order breaks the other way;
    the reference's bf16 run happens to break it alike."""
    _, tcfg, _, tparams = _model("recurrentgemma_9b", dtype="float32")
    seq = _randint(4, (1, 5), tcfg.vocab_size)
    out = _engine(tcfg, tparams, max_len=32).generate(seq, 3)
    for i in range(3):
        with torch.inference_mode():
            logits, _, _ = tmodel.forward(tparams,
                                          torch.from_numpy(seq).long(), tcfg)
        nxt = logits[:, -1].argmax(-1).numpy()
        assert (nxt == out[:, i]).all(), f"divergence at step {i}"
        seq = np.concatenate([seq, nxt[:, None].astype(np.int32)], axis=1)


@pytest.mark.parametrize("s0", [16, 13], ids=["divisible", "remainder"])
def test_chunked_prefill_recurrent_family(s0):
    """Chunked prefill carries the recurrent state (xLSTM, chunks of 4);
    at 13 tokens the final chunk runs at its own length, unpadded."""
    _, tcfg, _, tparams = _model("xlstm_350m")
    prompts = _randint(9, (1, s0), tcfg.vocab_size)
    one = _engine(tcfg, tparams, max_len=64)
    chk = _engine(tcfg, tparams, max_len=64, prefill_chunk=4)
    np.testing.assert_array_equal(one.generate(prompts, 4),
                                  chk.generate(prompts, 4))


def test_recurrent_arch_through_scheduler():
    """Recurrent states ride the slot machinery; prompt padding is off."""
    _, tcfg, _, tparams = _model("xlstm_350m")
    prompts = _randint(17, (2, 6), tcfg.vocab_size)
    ref = _engine(tcfg, tparams, max_len=64).generate(prompts, 4)
    backend = LMBackend(tcfg, tparams, ServeConfig(max_len=64),
                        device="cpu")
    assert backend.prompt_pad == 0
    done = Scheduler(backend, total_slots=2, quantum=2, num_tasks=1).run(
        [Request(rid=i, task_id=0, prompt=prompts[i], max_new_tokens=4)
         for i in range(2)])
    for r in done:
        assert r.tokens == list(ref[r.rid]), r.rid


def test_preempt_restore_token_identical_recurrent():
    """One slot, a long batch request, an interactive arrival mid-decode:
    the batch request's recurrent state is parked and restored bit for
    bit, and both token streams equal the static engine's."""
    _, tcfg, _, tparams = _model("xlstm_350m")
    prompts = _randint(11, (2, 8), tcfg.vocab_size)
    ref = _engine(tcfg, tparams, max_len=64).generate(prompts, 24)
    sched = Scheduler(LMBackend(tcfg, tparams, ServeConfig(max_len=64),
                                device="cpu"),
                      total_slots=1, quantum=4, num_tasks=1,
                      clock=TickClock(),
                      slo=SLOPolicy(preemption=True, chunk_interleave=False,
                                    park_compress="none"))
    done = {r.rid: r for r in sched.run([
        Request(rid=0, task_id=0, prompt=prompts[0], max_new_tokens=24,
                arrival=0.0, tier="batch"),
        Request(rid=1, task_id=0, prompt=prompts[1], max_new_tokens=4,
                arrival=0.25, tier="interactive")])}
    assert done[0].tokens == list(ref[0][:24])
    assert done[1].tokens == list(ref[1][:4])
    assert done[0].preemptions >= 1
    assert sched.preemptions >= 1 and sched.restores >= 1


def test_recurrent_arch_gets_no_prefix_cache():
    """A running reduction has no truncation property: no prefix cache,
    and serving still works end to end."""
    _, tcfg, _, tparams = _model("xlstm_350m")
    backend = LMBackend(tcfg, tparams, ServeConfig(max_len=64,
                                                   prefix_cache=8),
                        device="cpu")
    assert backend.prefix is None
    done = Scheduler(backend, total_slots=1, num_tasks=1).run(
        [Request(rid=0, task_id=0,
                 prompt=_randint(1, (1, 8), tcfg.vocab_size)[0],
                 max_new_tokens=4)])
    assert len(done) == 1 and len(done[0].tokens) == 4


# ------------------------------------------------- beside the reference


@pytest.mark.parametrize("preset", list(PRESETS))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_the_references(arch, preset):
    """float32, 2 prompts of 21 tokens (past RecurrentGemma's 16-token
    smoke window: the ring cache's rolled write, then its decode), 6
    greedy tokens, both engines under the named presets."""
    jcfg, tcfg, jparams, tparams = _model(arch, dtype="float32")
    jpol, tpol = PRESETS[preset]
    prompts = _randint(3, (2, 21), tcfg.vocab_size)
    want = np.asarray(JServingEngine(jcfg, jparams, JServeConfig(
        max_len=32, policy=jpol)).generate(jnp.asarray(prompts), 6))
    got = _engine(tcfg, tparams, max_len=32, policy=tpol).generate(prompts,
                                                                   6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_matches_the_references_schedule(arch):
    """float32 on a tick clock, 2 slots, 4 requests of 5..12 tokens with an
    interactive arrival that preempts a batch-tier slot: every request's
    tokens equal the static engine's, and the finishing order, times,
    preemptions, restores and counters equal the JAX scheduler's."""
    _, tcfg, _, tparams = _model(arch, dtype="float32")
    rng = np.random.default_rng(4)
    specs = [dict(rid=i, task_id=0, prompt=rng.integers(
        0, tcfg.vocab_size, n).astype(np.int32), max_new_tokens=m,
        arrival=a, tier=t)
        for i, (n, m, a, t) in enumerate([(12, 10, 0.0, "batch"),
                                          (5, 8, 0.0, "batch"),
                                          (9, 4, 0.2, "interactive"),
                                          (7, 6, 0.3, "batch")])]
    js, ts, jb, tb = run_both(
        arch, dict(max_len=64), specs, total_slots=2, quantum=2,
        num_tasks=1, clock=True,
        slo=SLOPolicy(preemption=True, chunk_interleave=False))
    assert tb.prompt_pad == jb.prompt_pad == 0
    assert ts.metrics()["preemptions"] >= 1
    eng = _engine(tcfg, tparams, max_len=64,
                  policy=tb.cfg.policy)
    for r in ts.finished:
        alone = eng.generate(np.asarray(r.prompt)[None], r.max_new_tokens)
        assert r.tokens == list(alone[0]), r.rid
    assert_same_schedule(js, ts)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_layout_and_int8_parking_are_the_references(arch):
    """The batch axis of every state leaf, and ``compress="int8"``: the
    port's parker packs exactly the reference's leaves (floating, last
    axis >= 8: mLSTM C/n, the sLSTM cells, RG-LRU h, the conv windows,
    the KV rows; not mLSTM's (B, H) stabilizer at 4 heads) — the parked
    bytes are equal, and unpacked leaves come back bit for bit."""
    jcfg, tcfg, _, _ = _model(arch)
    axes, jaxes = state_batch_axes(tcfg, 32), jstate_batch_axes(jcfg, 32)
    assert sorted(axes) == sorted(jaxes) and len(axes) == len(jaxes)
    jstate = jmodel.init_state(jcfg, 2, 32)
    jparked = JSlotParker(jaxes, jax.tree.leaves(jstate), "int8").park(
        jstate, 1)
    tstate = tmodel.init_state(tcfg, 2, 32, device="cpu")
    for leaf in tstate_leaves(tstate):
        leaf.copy_(torch.randn(leaf.shape).to(leaf.dtype))
    parker = SlotParker(axes, "int8")
    parked = parker.park(tstate, 1)
    assert parked.nbytes == jparked.nbytes
    packed = sum(isinstance(p, tuple) for p in parked.leaves)
    assert packed == sum(isinstance(p, tuple) for p in jparked.leaves) > 0
    before = [t.clone() for t in tstate_leaves(tstate)]
    parker.restore(tstate, parked, 0)
    for p, b, a, ax in zip(parked.leaves, before, tstate_leaves(tstate),
                           axes):
        if not isinstance(p, tuple):
            assert torch.equal(a.narrow(ax, 0, 1), b.narrow(ax, 1, 1))


def tstate_leaves(state):
    from repro_torch.tree import flatten

    return list(flatten(state).values())


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_references(arch):
    jmod = __import__(f"repro.configs.{arch}", fromlist=["CONFIG"])
    tmod = __import__(f"repro_torch.configs.{arch}", fromlist=["CONFIG"])
    for name in ("CONFIG", "SMOKE_CONFIG"):
        want, got = getattr(jmod, name), getattr(tmod, name)
        for f in fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), \
                (name, f.name)
    assert tconfigs.get(arch) is tmod.CONFIG
    assert tconfigs.get(arch, smoke=True) is tmod.SMOKE_CONFIG
