"""The port's continuous-batching scheduler (``repro_torch.serve.scheduler``)
against the JAX reference's (``repro.serve.scheduler``), on the CPU.

Both schedulers get the same requests (NumPy prompts) and the same
parameters (``bridge.params_from_jax``), at float32 — where
``test_torch_lm.py`` holds the port's greedy tokens equal to the JAX
engine's — under the port's kernel policy (``cuda`` with
``attention_decode="cuda_fused"``, each kernel module running its plain
version on the CPU) and the reference's default.  Per request the tokens
must be equal, and under a ``TickClock`` (every clock read one tick) the
host's decisions too: the order requests finish in, every admission,
first-token and finish time, and the metrics' counters.

The reference's own oracles (``tests/test_scheduler.py``) are ported
beside them: results identical to the static engine, mixed-task batches
with router-usage export (Kimi-K2 ``SMOKE_CONFIG`` with two tasks), slot
recycling on EOS, fairness, metrics, open-loop arrivals and padded
prefill.  Recurrent archs are served (``test_torch_recurrent_serve.py``
holds them against the reference).
"""

import functools
from dataclasses import replace

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.serve import LMBackend as JLMBackend
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeConfig as JServeConfig
from repro.serve.slo import TickClock as JTickClock
from repro_torch import ops
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get
from repro_torch.serve import (LMBackend, Request, Scheduler, ServeConfig,
                               ServingEngine)
from repro_torch.serve.engine import state_batch_axes
from repro_torch.serve.slo import TickClock
from repro_torch.tree import flatten
from test_torch_threads import one_torch_thread  # noqa: F401

POLICY = ops.policy_named("cuda").with_impls(attention_decode="cuda_fused")


@functools.lru_cache(maxsize=None)
def _model(arch="llama3_2_1b", num_tasks=None):
    """(JAX cfg, port cfg, JAX params, port params) at float32."""
    jcfg = replace(jconfigs.get(arch, smoke=True), dtype="float32")
    tcfg = replace(get(arch, smoke=True), dtype="float32")
    if num_tasks is not None:
        jcfg = replace(jcfg, moe=replace(jcfg.moe, num_tasks=num_tasks))
        tcfg = replace(tcfg, moe=replace(tcfg.moe, num_tasks=num_tasks))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.device_get(jparams),
                                                device="cpu")


def _prompts(vocab, n, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (n, s)).astype(
        np.int32)


def backend(tcfg, tparams, scfg, **kw):
    return LMBackend(tcfg, tparams, replace(scfg, policy=POLICY),
                     device="cpu", **kw)


def engine(tcfg, tparams, scfg):
    return ServingEngine(tcfg, tparams, replace(scfg, policy=POLICY),
                         device="cpu")


def requests(cls, specs):
    """The same request list for either package: dicts of Request
    fields (prompts as NumPy arrays)."""
    return [cls(**{k: (v.copy() if isinstance(v, np.ndarray) else v)
                   for k, v in spec.items()}) for spec in specs]


def run_both(arch, scfg, specs, gate_tasks=None, prompt_pad=16,
             **sched_kw):
    """Serve ``specs`` through the JAX and the port scheduler (the MoE
    gate over ``gate_tasks`` tasks): returns (JAX scheduler, port
    scheduler, JAX backend, port backend)."""
    jcfg, tcfg, jparams, tparams = _model(arch, gate_tasks)
    jb = JLMBackend(jcfg, jparams, JServeConfig(**scfg),
                    prompt_pad=prompt_pad)
    tb = backend(tcfg, tparams, ServeConfig(**scfg), prompt_pad=prompt_pad)
    clock = sched_kw.pop("clock", None)
    js = JScheduler(jb, clock=JTickClock() if clock else None, **sched_kw)
    ts = Scheduler(tb, clock=TickClock() if clock else None, **sched_kw)
    js.run(requests(JRequest, specs))
    ts.run(requests(Request, specs))
    return js, ts, jb, tb


def assert_same_schedule(js, ts):
    """Tokens per request, the finishing order and (tick clock) every time
    and counter the host decided."""
    assert [r.rid for r in ts.finished] == [r.rid for r in js.finished]
    for j, t in zip(js.finished, ts.finished):
        assert t.tokens == [int(v) for v in j.tokens], t.rid
        for name in ("t_admit", "t_first", "t_done", "preemptions",
                     "prefix_hit_tokens"):
            assert getattr(t, name) == getattr(j, name), (t.rid, name)
    jm, tm = js.metrics(), ts.metrics()
    for key in ("requests", "tokens", "per_task", "tiers", "preemptions",
                "restores", "parked_now", "parked_bytes_peak",
                "slot_utilization", "prefix_cache", "prefill_chunks",
                "slo_attainment", "ttft_p50_s", "ttft_p99_s",
                "latency_p50_s", "latency_p99_s"):
        assert tm.get(key) == jm.get(key), key


def test_state_batch_axes_are_the_references():
    """The splice axes, discovered structurally on the meta device: the
    batch axis of every KV-cache leaf under the stacked ``layers`` is 1."""
    _, tcfg, _, _ = _model()
    from repro.serve.engine import state_batch_axes as jaxes

    jcfg = _model()[0]
    assert state_batch_axes(tcfg, 64) == [1] * (2 * tcfg.period)
    assert sorted(state_batch_axes(tcfg, 64)) == sorted(jaxes(jcfg, 64))


def test_results_identical_to_static_engine_and_reference():
    """Greedy tokens from the scheduler == the static engine's rows ==
    the JAX scheduler's, with the same finishing order and times."""
    jcfg, tcfg, _, tparams = _model()
    prompts = _prompts(tcfg.vocab_size, 4, 8, 3)
    ref = engine(tcfg, tparams, ServeConfig(max_len=64)).generate(prompts, 6)
    specs = [dict(rid=i, task_id=0, prompt=prompts[i], max_new_tokens=6)
             for i in range(4)]
    js, ts, _, tb = run_both("llama3_2_1b", dict(max_len=64), specs,
                             total_slots=4, quantum=3, num_tasks=1,
                             clock=True)
    assert len(ts.finished) == 4
    for r in ts.finished:
        assert r.tokens == list(ref[r.rid]), r.rid
    assert_same_schedule(js, ts)
    bucket = ts.buckets[None]
    # one host read a decode step, one an admission
    assert bucket.host_syncs == bucket.steps + 4


def test_mixed_task_results_identical_per_task():
    """A mixed-task decode batch (per-slot gating, Kimi-K2 SMOKE_CONFIG
    with two tasks) reproduces each task's static generation, the JAX
    scheduler's tokens and its router-usage totals."""
    _, tcfg, _, tparams = _model("kimi_k2_1t_a32b", 2)
    prompts = _prompts(tcfg.vocab_size, 4, 8, 5)
    eng = engine(tcfg, tparams, ServeConfig(max_len=64))
    refs = {t: eng.generate(prompts, 5, task_id=t) for t in (0, 1)}
    specs = [dict(rid=i, task_id=i % 2, prompt=prompts[i], max_new_tokens=5)
             for i in range(4)]
    js, ts, jb, tb = run_both("kimi_k2_1t_a32b", dict(max_len=64), specs,
                              gate_tasks=2, num_tasks=2, total_slots=4,
                              quantum=3, clock=True)
    for r in ts.finished:
        assert r.tokens == list(refs[r.task_id][r.rid]), (r.rid, r.task_id)
    assert_same_schedule(js, ts)
    assert tb.usage is not None
    assert (tb.usage.totals.sum(axis=1) > 0).all()
    np.testing.assert_array_equal(tb.usage.totals, jb.usage.totals)
    assert ts.metrics()["expert_usage_task_overlap"] == pytest.approx(
        js.metrics()["expert_usage_task_overlap"])


def test_slot_recycling_on_eos():
    """A request hitting its EOS frees its slot immediately and a queued
    request takes it over — more requests than slots all complete."""
    _, tcfg, _, tparams = _model()
    prompts = _prompts(tcfg.vocab_size, 2, 6, 7)
    first = engine(tcfg, tparams, ServeConfig(max_len=64)).generate(
        prompts, 1)[0, 0]
    specs = [dict(rid=i, task_id=0, prompt=prompts[i % 2], max_new_tokens=8)
             for i in range(5)]
    js, ts, _, _ = run_both("llama3_2_1b",
                            dict(max_len=64, eos_id=int(first)), specs,
                            total_slots=2, quantum=2, num_tasks=1,
                            clock=True)
    assert len(ts.finished) == 5
    by_rid = {r.rid: r for r in ts.finished}
    assert by_rid[0].tokens == [int(first)]
    assert all(len(r.tokens) <= r.max_new_tokens for r in ts.finished)
    assert_same_schedule(js, ts)


def test_mixed_task_fairness_no_starvation():
    """A hot task flooding the queue cannot starve a small task."""
    _, tcfg, _, _ = _model("kimi_k2_1t_a32b", 2)
    prompts = _prompts(tcfg.vocab_size, 4, 8, 9)
    specs = [dict(rid=i, task_id=0, prompt=prompts[i % 4], max_new_tokens=8)
             for i in range(10)]
    specs += [dict(rid=100 + i, task_id=1, prompt=prompts[i],
                   max_new_tokens=4) for i in range(2)]
    js, ts, _, _ = run_both("kimi_k2_1t_a32b", dict(max_len=64), specs,
                            gate_tasks=2, num_tasks=2, total_slots=2,
                            quantum=2, clock=True)
    order = [r.rid for r in ts.finished]
    small_pos = max(order.index(100), order.index(101))
    assert small_pos < len(order) - 4, order
    assert_same_schedule(js, ts)


def test_variable_length_requests_and_metrics():
    _, tcfg, _, tparams = _model()
    prompts = _prompts(tcfg.vocab_size, 6, 5, 11)
    sched = Scheduler(backend(tcfg, tparams, ServeConfig(max_len=64)),
                      total_slots=3, quantum=4, num_tasks=1)
    done = sched.run([Request(rid=i, task_id=0, prompt=prompts[i],
                              max_new_tokens=2 + i) for i in range(6)])
    assert sorted(len(r.tokens) for r in done) == [2, 3, 4, 5, 6, 7]
    m = sched.metrics()
    assert m["requests"] == 6 and m["tokens"] == sum(range(2, 8))
    assert m["tok_per_s"] > 0 and m["latency_p99_s"] >= m["latency_p50_s"]
    assert 0 < m["slot_utilization"] <= 1


def test_open_loop_arrivals_respected():
    """A request is never admitted before its arrival time (wall clock)."""
    _, tcfg, _, tparams = _model()
    prompts = _prompts(tcfg.vocab_size, 2, 5, 13)
    sched = Scheduler(backend(tcfg, tparams, ServeConfig(max_len=64)),
                      total_slots=2, quantum=2, num_tasks=1)
    done = sched.run([
        Request(rid=0, task_id=0, prompt=prompts[0], max_new_tokens=3,
                arrival=0.0),
        Request(rid=1, task_id=0, prompt=prompts[1], max_new_tokens=3,
                arrival=0.15)])
    late = next(r for r in done if r.rid == 1)
    assert late.t_admit is not None and late.t_admit >= 0.15


@pytest.mark.parametrize("pad", [8, 16])
def test_varied_prompt_lengths_padded_prefill(pad):
    """Prompts of 5 and 11 tokens padded to a multiple of ``prompt_pad``
    give the unpadded engine's tokens, and the reference's."""
    _, tcfg, _, tparams = _model()
    scfg = ServeConfig(max_len=64)
    outs = {}
    for s0 in (5, 11):
        p = _prompts(tcfg.vocab_size, 1, s0, s0)
        outs[s0] = (p, engine(tcfg, tparams, scfg).generate(p, 4))
    specs = [dict(rid=s0, task_id=0, prompt=outs[s0][0][0],
                  max_new_tokens=4) for s0 in outs]
    js, ts, _, _ = run_both("llama3_2_1b", dict(max_len=64), specs,
                            prompt_pad=pad, total_slots=2, quantum=2,
                            num_tasks=1, clock=True)
    for r in ts.finished:
        assert r.tokens == list(outs[r.rid][1][0]), r.rid
    assert_same_schedule(js, ts)


def test_task_skew_80_20_bounded_ttft_gap():
    """An 80/20 task mix cannot starve the minority task (tick clock), and
    every time the host decided equals the reference's."""
    _, tcfg, _, _ = _model("kimi_k2_1t_a32b", 2)
    prompts = _prompts(tcfg.vocab_size, 4, 8, 21)
    specs = [dict(rid=i, task_id=0, prompt=prompts[i % 4], max_new_tokens=6)
             for i in range(16)]
    specs += [dict(rid=100 + i, task_id=1, prompt=prompts[i],
                   max_new_tokens=6) for i in range(4)]
    js, ts, _, _ = run_both("kimi_k2_1t_a32b", dict(max_len=64), specs,
                            gate_tasks=2, num_tasks=2, total_slots=2,
                            quantum=2, clock=True)
    done = ts.finished
    assert len(done) == 20
    worst = {t: max(r.ttft for r in done if r.task_id == t) for t in (0, 1)}
    assert worst[1] <= 0.8 * worst[0], worst
    assert ts.metrics()["per_task"] == {0: 16, 1: 4}
    assert_same_schedule(js, ts)


@pytest.mark.parametrize("over", [
    dict(cfg=dict(block_pattern=("mlstm",))),
    dict(cfg=dict(embed_input="embeddings")),
    dict(scfg=dict(kv_quant="int8")), dict(rules="of_one"),
    dict(scfg=dict(temperature=1.0))],
    ids=["recurrent", "embeddings", "kv_int8", "mesh", "temperature"])
def test_later_items_raise(over):
    """A mesh (queue 1 item 6a, ported) serves: at a mesh of one every
    request gets the unmeshed scheduler's tokens and schedule
    (``tests/test_torch_dist.py`` holds 2×2); the scheduler decodes
    greedily.  Embedding prompts (item 5b, ported;
    ``test_torch_frontends.py`` holds them to the reference) are served
    padded, without the prefix cache, each request with the static
    engine's tokens.  An int8 KV cache
    (item 3, ported) is served: every request gets the static int8-cache
    engine's tokens and the JAX scheduler's schedule.  A recurrent arch
    (item 5a, ported; ``test_torch_recurrent_serve.py`` holds it against
    the reference) is served unpadded, without a prefix cache, each
    request with the static engine's tokens."""
    _, tcfg, _, tparams = _model()
    cfg = replace(tcfg, **over.get("cfg", {}))
    scfg = ServeConfig(max_len=64, **over.get("scfg", {}))
    if cfg.block_pattern == ("mlstm",):
        from repro_torch.models import model as tmodel

        params = tmodel.init_params(0, cfg, device="cpu")
        b = LMBackend(cfg, params, replace(scfg, prefix_cache=4),
                      device="cpu")
        assert b.prompt_pad == 0 and b.prefix is None and b.recurrent
        prompts = _prompts(cfg.vocab_size, 3, 7, 5)
        ref = ServingEngine(cfg, params, scfg, device="cpu").generate(
            prompts, 5)
        done = Scheduler(b, total_slots=2, quantum=2, num_tasks=1).run(
            [Request(rid=i, task_id=0, prompt=prompts[i], max_new_tokens=5)
             for i in range(3)])
        for r in done:
            assert r.tokens == list(ref[r.rid]), r.rid
        return
    if cfg.embed_input == "embeddings":
        b = LMBackend(cfg, tparams, replace(scfg, prefix_cache=4),
                      device="cpu")
        emb = np.random.default_rng(4).standard_normal(
            (3, 7, cfg.d_model)).astype(np.float32)
        ref = ServingEngine(cfg, tparams, scfg, device="cpu").generate(
            emb, 5)
        done = Scheduler(b, total_slots=2, quantum=2, num_tasks=1).run(
            [Request(rid=i, task_id=0, prompt=emb[i], max_new_tokens=5)
             for i in range(3)])
        assert b.prompt_pad == 16 and b.prefix.stats()["entries"] == 0
        for r in done:
            assert r.tokens == list(ref[r.rid]), r.rid
        return
    if "kv_quant" in over.get("scfg", {}):
        prompts = _prompts(tcfg.vocab_size, 3, 8, 5)
        specs = [dict(rid=i, task_id=0, prompt=prompts[i],
                      max_new_tokens=4 + 2 * i) for i in range(3)]
        js, ts, _, tb = run_both("llama3_2_1b", dict(max_len=64,
                                                     kv_quant="int8"),
                                 specs, total_slots=2, quantum=2,
                                 num_tasks=1, clock=True)
        assert any(k.endswith("k_scale") for k in flatten(
            tb.new_state(1)))
        ref = engine(tcfg, tparams, scfg).generate(prompts, 8)
        for r in ts.finished:
            assert r.tokens == list(ref[r.rid][:r.max_new_tokens])
        assert_same_schedule(js, ts)
        return
    if "temperature" in over.get("scfg", {}):
        with pytest.raises(ValueError, match="greedily"):
            LMBackend(cfg, tparams, scfg, device="cpu")
        return
    from _torch_mesh import rules_of_one

    prompts = _prompts(tcfg.vocab_size, 3, 8, 5)
    runs = []
    for rules in (None, rules_of_one(fsdp=False)):
        sched = Scheduler(LMBackend(cfg, tparams, scfg, rules=rules,
                                    device="cpu"),
                          total_slots=2, quantum=2, num_tasks=1)
        done = sched.run([Request(rid=i, task_id=0, prompt=prompts[i],
                                  max_new_tokens=4 + i) for i in range(3)])
        runs.append(sorted((r.rid, r.tokens) for r in done))
    assert runs[0] == runs[1]


def test_plain_cuda_decode_refuses_mixed_positions_on_the_card(monkeypatch):
    """Under plain ``cuda`` the decode impl takes uniform cache lengths
    only: with the operands on the card (the device rule faked) the first
    decode step of slots at mixed positions raises instead of falling back
    to a plain version (the launcher's default policy takes
    ``attention_decode="cuda_fused"`` for this reason)."""
    from repro_torch.ops import DispatchError, registry

    _, tcfg, _, tparams = _model()
    sched = Scheduler(LMBackend(tcfg, tparams, ServeConfig(
        max_len=64, policy=ops.policy_named("cuda")), device="cpu"),
        total_slots=2, quantum=2, num_tasks=1)
    monkeypatch.setattr(registry, "_mode", lambda args: "cuda")
    with pytest.raises(DispatchError, match="per-sequence cache lengths"):
        sched.run([Request(rid=i, task_id=0, prompt=_prompts(
            tcfg.vocab_size, 1, s0, s0)[0], max_new_tokens=3)
            for i, s0 in enumerate((5, 11))])
